// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_bhsd (body `_kernel`).  It computes softmax(q k^T / sqrt(D))
// v with causal, sliding-window and k-padding masks, all by position with
// q_offset; GQA reads kv head h / group, so K/V are never repeated.
//
// Layout: q/out (B, H, Sq, D) and k/v (B, KV, Sk, D), addressed through the
// batch, head and sequence strides the caller passes (the last dimension is
// contiguous), so the model's (B, S, H, D) layout needs no transpose copy.
// f32 or bf16 inputs, f32 arithmetic and accumulation.
//
// Design.  One CTA of 128 threads per (b * H + h, tile of 64 query rows).
// Two threads share a query row: each holds the whole scaled row in registers,
// scores every other key of a 32-key tile and owns every other output column,
// and the pair combines row max and row sum with one shuffle.  K/V tiles are
// staged through shared memory in f32 with padded rows; each thread issues its
// loads of the next tile before waiting on the current one's readers.  The
// CTA skips key tiles that lie wholly in the causal future (every row of a
// causal prefill has key 0 valid, so skipping is exact) and, with a window,
// those wholly before it.  NEG_INF stays finite (-1e30) and l is floored at 1e-30, as in
// the TPU kernel.
//
// Bound.  Prefill is compute-bound: 4 * D FLOPs per valid (query, key) pair
// per head over the bf16 tensor-core peak (989 TFLOP/s on an H100 SXM).  This
// first version multiplies on the CUDA cores in f32, not on the tensor cores,
// so it runs well above that bound; wgmma tiles are a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 2 * BQ;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // in elements: batch, head, sequence
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Strides sq_, Strides sk_, Strides sv_, Strides so_,
    int H, int KV, int Sq, int Sk, int causal, int window, int q_offset,
    float scale) {
  constexpr int DP = D + 1;        // padded shared-memory row
  constexpr int HALF = D / 2;
  constexpr int KH = BK / 2;
  constexpr int PER = BK * D / THREADS;  // tile elements per thread
  static_assert(BK * D % THREADS == 0, "tile must split evenly");
  __shared__ float k_s[BK * DP];
  __shared__ float v_s[BK * DP];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh - b * H;
  const int kvh = hh / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 1;          // query row within the tile
  const int half = tid & 1;        // which keys / output columns it owns
  const int row = q0 + r;
  const int q_pos = q_offset + row;

  float qr[D];
  {
    const T* qp = q + b * sq_.b + hh * sq_.h + (long long)min(row, Sq - 1) * sq_.s;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(qp[d]) * scale;
  }
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  // key range this CTA can see
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_offset + q0 + BQ);
  if (window) k_lo = max(0, q_offset + q0 - window + 1);
  k_lo = (k_lo / BK) * BK;

  const T* kb = k + b * sk_.b + kvh * sk_.h;
  const T* vb = v + b * sv_.b + kvh * sv_.h;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    // issue all of this thread's tile loads before any use of their values
    // (raw in registers, converted at the shared store), so their memory
    // latencies overlap instead of adding up
    T kx[PER], vx[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * THREADS;
      const int key = k0 + i / D;
      kx[e] = from_f32<T>(0.f);
      vx[e] = from_f32<T>(0.f);
      if (key < Sk) {
        kx[e] = kb[(long long)key * sk_.s + i % D];
        vx[e] = vb[(long long)key * sv_.s + i % D];
      }
    }
    __syncthreads();               // previous tile fully consumed
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * THREADS;
      k_s[(i / D) * DP + i % D] = to_f32(kx[e]);
      v_s[(i / D) * DP + i % D] = to_f32(vx[e]);
    }
    __syncthreads();

    float s[KH];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int kk = 2 * j + half;
      const int key = k0 + kk;
      const float* kr = k_s + kk * DP;
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
      bool ok = key < Sk;
      if (causal) ok = ok && key <= q_pos;
      if (window) ok = ok && key > q_pos - window;
      s[j] = ok ? a : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      s[j] = expf(s[j] - m_new);
      ls += s[j];
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = l * corr + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const float p_mine = s[j];                                   // key 2j+half
      const float p_other = __shfl_xor_sync(0xffffffffu, s[j], 1);  // key 2j+1-half
      const float* v_mine = v_s + (2 * j + half) * DP + half;
      const float* v_other = v_s + (2 * j + 1 - half) * DP + half;
#pragma unroll
      for (int i = 0; i < HALF; ++i)
        acc[i] = fmaf(p_mine, v_mine[2 * i], fmaf(p_other, v_other[2 * i], acc[i]));
    }
  }

  if (row < Sq) {
    T* op = out + b * so_.b + hh * so_.h + (long long)row * so_.s;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < HALF; ++i) op[2 * i + half] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             const long long* st, int B, int H, int KV, int Sq, int Sk,
             int causal, int window, int q_offset, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, sv, so, H, KV,
      Sq, Sk, causal, window, q_offset, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* st, int B, int H, int KV, int Sq, int Sk, int D,
           int causal, int window, int q_offset, cudaStream_t stream) {
  if (D == 64)  // qwen2-0.5b's head dim; instantiate other widths here
    return launch_d<T, 64>(q, k, v, out, st, B, H, KV, Sq, Sk, causal, window,
                           q_offset, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, out.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_bhsd(const void* q, const void* k, const void* v,
                                    void* out, const long long* strides, int B,
                                    int H, int KV, int Sq, int Sk, int D,
                                    int causal, int window, int q_offset,
                                    int dtype, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, strides, B, H, KV, Sq, Sk, D, causal,
                         window, q_offset, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, strides, B, H, KV, Sq, Sk, D,
                                 causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
