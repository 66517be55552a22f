// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention_decode (body `_kernel`).  It computes single-token GQA
// attention straight off a paged KV pool: row b attends to the token indices
// t <= positions[b], and token t lives at (tables[b, t / pt], t % pt).
//
// Layout: q (B, KV, G, hd); k/v pools (P, pt, KV, hd); tables (B, maxp) int32;
// positions (B,) int32 -> out (B, KV, G, hd).  f32 or bf16, f32 arithmetic.
//
// Design.  One CTA per (b, kv-head).  The CTA reads its own page ids from
// `tables` (no gather, no contiguous copy), walks tokens 0..pos in tiles of
// 32 (a tile may span several small pages), stages each K/V tile once in
// shared memory and serves all G query rows of the head from it, with an f32
// online softmax (m, l, acc) across tiles.  Each thread issues its 16 loads
// of a tile before using any of their values, so their latencies overlap.  Pages wholly past pos are never
// read.  NEG_INF stays finite (-1e30) and l is floored at 1e-30, as in the
// TPU kernel: -inf would turn exp(s - m) into NaN.
//
// Bound.  Decode reads every valid K/V byte once: (pos+1) * 2 * hd * itemsize
// per (b, kv-head), over HBM bandwidth (3.35 TB/s on an H100 SXM).  Known
// limit: B * KV CTAs (16 at max_batch 8 for qwen2-0.5b) is far under the 132
// SMs, so one CTA's serial walk over the context sets the time; splitting the
// context across CTAs (split-KV) is a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 32;       // tokens per tile: one per lane in the softmax
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ positions, T* __restrict__ out, int KV, int G,
    int P, int pt, int maxp, float scale) {
  constexpr int HDP = HD + 1;             // padded row: conflict-free columns
  constexpr int PER = TILE * HD / THREADS;  // tile elements per thread
  static_assert(TILE * HD % THREADS == 0, "tile must split evenly");
  extern __shared__ float smem[];
  float* q_s = smem;                      // (G, HD) scaled query rows
  float* acc_s = q_s + G * HD;            // (G, HD) running numerators
  float* k_s = acc_s + G * HD;            // (TILE, HDP)
  float* v_s = k_s + TILE * HDP;          // (TILE, HDP)
  float* p_s = v_s + TILE * HDP;          // (G, TILE) scores, then probs
  float* m_s = p_s + G * TILE;            // (G,) running max
  float* l_s = m_s + G;                   // (G,) running denominator
  float* c_s = l_s + G;                   // (G,) this tile's correction

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // tokens 0..pos are valid; the table row addresses at most maxp * pt
  const int n_tok = min(positions[b] + 1, maxp * pt);
  const size_t head = ((size_t)b * KV + h) * G * HD;
  for (int i = tid; i < G * HD; i += THREADS) {
    q_s[i] = to_f32(q[head + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int* row = tables + (size_t)b * maxp;
  for (int t0 = 0; t0 < n_tok; t0 += TILE) {
    // issue all of this thread's loads before any use of their values (raw
    // in registers, converted at the shared store), so their memory
    // latencies overlap instead of adding up
    T kx[PER], vx[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * THREADS;
      const int j = t0 + i / HD;
      kx[e] = from_f32<T>(0.f);
      vx[e] = from_f32<T>(0.f);
      if (j < n_tok) {
        // clamp like JAX's gather: the engine keeps every id in range
        const int page = min(max(row[j / pt], 0), P - 1);
        const size_t off = (((size_t)page * pt + (j % pt)) * KV + h) * HD + i % HD;
        kx[e] = k_pages[off];
        vx[e] = v_pages[off];
      }
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * THREADS;
      k_s[(i / HD) * HDP + i % HD] = to_f32(kx[e]);
      v_s[(i / HD) * HDP + i % HD] = to_f32(vx[e]);
    }
    __syncthreads();

    // scores: each warp takes one query row, lane = token
    for (int i = tid; i < G * TILE; i += THREADS) {
      const int g = i / TILE;
      const int t = i - g * TILE;
      float s = NEG_INF;
      if (t0 + t < n_tok) {
        const float* qr = q_s + g * HD;
        const float* kr = k_s + t * HDP;
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) a = fmaf(qr[d], kr[d], a);
        s = a;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per query row, lane = token
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s = p_s[g * TILE + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float tile_sum = warp_sum(p);
      p_s[g * TILE + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + tile_sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * HD; i += THREADS) {
      const int g = i / HD;
      const int d = i - g * HD;
      const float* pr = p_s + g * TILE;
      float a = acc_s[i] * c_s[g];
#pragma unroll
      for (int t = 0; t < TILE; ++t) a = fmaf(pr[t], v_s[t * HDP + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD;
    out[head + i] = from_f32<T>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* positions, void* out, int B, int KV,
           int G, int P, int pt, int maxp, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)G * HD + 2 * (size_t)TILE * (HD + 1) +
                       (size_t)G * TILE + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)HD);
  paged_decode_kernel<T, HD><<<dim3(B, KV), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), KV, G, P, pt,
      maxp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd must be 64.  Returns the cudaError_t
// of the launch.
extern "C" int paged_attention_decode(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* positions, void* out, int B,
                                      int KV, int G, int hd, int P, int pt,
                                      int maxp, int dtype, void* stream) {
  if (B == 0) return 0;
  // qwen2-0.5b's head dim; instantiate other widths here
  if (hd != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 64>(q, k_pages, v_pages, tables, positions, out, B,
                             KV, G, P, pt, maxp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64>(q, k_pages, v_pages, tables, positions,
                                     out, B, KV, G, P, pt, maxp, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
