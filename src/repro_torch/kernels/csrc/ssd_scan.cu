// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan_kernel
// (body `_kernel`).  Inputs: x (B, S, H, P) f32, already scaled by dt;
// dta (B, S, H) f32 log-decays (dt * A, A < 0); B and C (B, S, G, N) in f32
// or bf16.  Outputs: y (B, S, H, P) f32 without the D skip, and the final
// state h (B, H, P, N) f32.  Per chunk of Q tokens, with cum the running sum
// of dta inside the chunk:
//   y_i  = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) x_j + exp(cum_i) C_i h
//   h   <- exp(cum_last) h + sum_j exp(cum_last - cum_j) x_j B_j^T
// The algorithm is exact for any chunk length, so the kernel picks its own
// (Q = 64) whatever chunk the caller's plain version uses.
//
// Design.  The TPU kernel walks the chunks as a sequential grid axis and
// carries the (H, P, N) state in VMEM scratch.  Blocks on Hopper run in no
// order, so each CTA owns one (batch row, head, slice of PB = 16 rows of the
// head dim) and loops over the chunks itself, carrying its (PB, N) slice of
// the state in shared memory.  Rows of the state over P are independent, so
// the split is exact; it gives B * H * P / PB CTAs (96 at B=1 for
// mamba2-130m) instead of B * H (24) on 132 SMs, at the price of each CTA
// recomputing its chunk's C B^T tile (the largest term here).  A chunk's B,
// C and x are staged in shared memory as f32 (bf16 is converted at the
// store); the loads of the next chunk are issued before the current chunk's
// arithmetic, so their latency overlaps it.  The causal mask is applied
// before the exponential: cum_i - cum_j > 0 above the diagonal, and
// exp overflowing to inf would turn inf * 0 into NaN.  A ragged last chunk
// reads zeros for x, dta, B and C, which leave the state unchanged.
//
// Bound.  Operations: per chunk and group the causal half of C B^T
// (Q(Q+1)/2 * N multiply-adds), per head the causal half of the intra term
// (Q(Q+1)/2 * P), the inter term and the state update (Q * N * P each), all in
// f32 on the CUDA cores (67 TFLOP/s on an H100 SXM); the bytes (x, y, B, C,
// dta and h read or written once) take a fraction of that time.  This first
// version runs on the CUDA cores with shared-memory operands; wgmma and TMA
// are a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;          // tokens per chunk
constexpr int N = 128;         // state size
constexpr int P = 64;          // head dim
constexpr int PB = 16;         // head-dim rows of the state per CTA
constexpr int THREADS = 256;
constexpr int NS = N + 4;      // padded shared row of B, C and h (floats)
constexpr int QS = Q + 1;      // padded shared row of the score tile
constexpr int QPL = Q / 32;    // chunk positions per lane in the scan
static_assert(Q == 64 && PB == 16 && THREADS == 256,
              "thread mappings below assume these sizes");

// shared-memory layout, in floats
constexpr int OFF_C = 0;
constexpr int OFF_B = OFF_C + Q * NS;
constexpr int OFF_X = OFF_B + Q * NS;
constexpr int OFF_S = OFF_X + Q * PB;
constexpr int OFF_H = OFF_S + Q * QS;
constexpr int OFF_CUM = OFF_H + PB * NS;
constexpr int OFF_EIN = OFF_CUM + Q;
constexpr int OFF_DOUT = OFF_EIN + Q;
constexpr int OFF_DTA = OFF_DOUT + Q;
constexpr int OFF_TOT = OFF_DTA + Q;
constexpr int SMEM_FLOATS = OFF_TOT + 4;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ void to_f32x(const uint4& raw, float* out, float) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}
__device__ __forceinline__ void to_f32x(const uint4& raw, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One chunk's inputs, held in registers between its loads and its shared
// stores: B and C as raw 16-byte vectors, this CTA's x slice, and dta.
template <typename T>
struct ChunkRegs {
  static constexpr int VEC = 16 / sizeof(T);             // elements per vector
  static constexpr int ROW_VECS = N / VEC;
  static constexpr int PER = Q * ROW_VECS / THREADS;     // vectors per thread
  uint4 b[PER], c[PER];
  float4 x;
  float dta;
};

template <typename T>
__device__ __forceinline__ void load_chunk(ChunkRegs<T>& r, const T* __restrict__ bm,
                                           const T* __restrict__ cm,
                                           const float* __restrict__ x,
                                           const float* __restrict__ dta, int bi,
                                           int t0, int S, int H, int G, int hh,
                                           int g, int p0, int tid) {
  using R = ChunkRegs<T>;
#pragma unroll
  for (int e = 0; e < R::PER; ++e) {
    const int v = tid + e * THREADS;
    const int t = t0 + v / R::ROW_VECS;
    const int col = (v % R::ROW_VECS) * R::VEC;
    r.b[e] = make_uint4(0, 0, 0, 0);
    r.c[e] = make_uint4(0, 0, 0, 0);
    if (t < S) {
      const long long off = ((long long)(bi * S + t) * G + g) * N + col;
      r.b[e] = *reinterpret_cast<const uint4*>(bm + off);
      r.c[e] = *reinterpret_cast<const uint4*>(cm + off);
    }
  }
  {
    const int t = t0 + tid / (PB / 4);
    r.x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < S)
      r.x = *reinterpret_cast<const float4*>(
          x + ((long long)(bi * S + t) * H + hh) * P + p0 + (tid % (PB / 4)) * 4);
  }
  r.dta = 0.f;
  if (tid < Q && t0 + tid < S) r.dta = dta[(long long)(bi * S + t0 + tid) * H + hh];
}

template <typename T>
__device__ __forceinline__ void store_chunk(const ChunkRegs<T>& r, float* smem, int tid) {
  using R = ChunkRegs<T>;
#pragma unroll
  for (int e = 0; e < R::PER; ++e) {
    const int v = tid + e * THREADS;
    const int row = v / R::ROW_VECS;
    const int col = (v % R::ROW_VECS) * R::VEC;
    float fb[R::VEC], fc[R::VEC];
    to_f32x(r.b[e], fb, T());
    to_f32x(r.c[e], fc, T());
#pragma unroll
    for (int k = 0; k < R::VEC; k += 4) {
      *reinterpret_cast<float4*>(smem + OFF_B + row * NS + col + k) =
          make_float4(fb[k], fb[k + 1], fb[k + 2], fb[k + 3]);
      *reinterpret_cast<float4*>(smem + OFF_C + row * NS + col + k) =
          make_float4(fc[k], fc[k + 1], fc[k + 2], fc[k + 3]);
    }
  }
  *reinterpret_cast<float4*>(smem + OFF_X + (tid / (PB / 4)) * PB + (tid % (PB / 4)) * 4) = r.x;
  if (tid < Q) smem[OFF_DTA + tid] = r.dta;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dta,
    const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ y,
    float* __restrict__ h_out, int S, int H, int G) {
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem + OFF_C;
  float* b_s = smem + OFF_B;
  float* x_s = smem + OFF_X;
  float* s_s = smem + OFF_S;
  float* h_s = smem + OFF_H;
  float* cum_s = smem + OFF_CUM;
  float* ein_s = smem + OFF_EIN;
  float* dout_s = smem + OFF_DOUT;
  float* dta_s = smem + OFF_DTA;

  const int p0 = blockIdx.x * PB;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = hh / (H / G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = (S + Q - 1) / Q;

  for (int i = tid; i < PB * NS; i += THREADS) h_s[i] = 0.f;

  ChunkRegs<T> regs;
  load_chunk(regs, bm, cm, x, dta, bi, 0, S, H, G, hh, g, p0, tid);

  // thread roles: score tile rows ti + 16a, cols tj + 16b; output rows
  // ib + 16a at head-dim column p; state rows sp, sp + 8 at columns 4 * nq..
  const int ti = tid / 16, tj = tid % 16;
  const int ib = tid / PB, p = tid % PB;
  const int nq = tid % 32, sp = tid / 32;
  float4 st0 = make_float4(0.f, 0.f, 0.f, 0.f), st1 = st0;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();                       // the previous chunk's readers are done
    store_chunk(regs, smem, tid);
    __syncthreads();
    if (c + 1 < n_chunks)                  // in flight during this chunk's math
      load_chunk(regs, bm, cm, x, dta, bi, t0 + Q, S, H, G, hh, g, p0, tid);

    // cumulative decay: each lane of warp 0 scans QPL consecutive positions
    if (warp == 0) {
      float v[QPL];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < QPL; ++k) {
        run += dta_s[lane * QPL + k];
        v[k] = run;
      }
      float inc = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) excl = 0.f;
      const float last = __shfl_sync(0xffffffffu, inc, 31);
#pragma unroll
      for (int k = 0; k < QPL; ++k) {
        const float cv = excl + v[k];
        const int i = lane * QPL + k;
        cum_s[i] = cv;
        ein_s[i] = expf(cv);
        dout_s[i] = expf(last - cv);
      }
      if (lane == 0) smem[OFF_TOT] = expf(last);
    }

    // C B^T for this CTA's 4 x 4 tile of the chunk's Q x Q scores
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = *reinterpret_cast<const float4*>(c_s + (ti + 16 * a) * NS + n);
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = *reinterpret_cast<const float4*>(b_s + (tj + 16 * b) * NS + n);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = dot4(cv[a], bv[b], acc[a][b]);
    }
    __syncthreads();                       // cum_s ready
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + 16 * a;
      const float ci = cum_s[i];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tj + 16 * b;
        // mask first: exp(cum_i - cum_j) overflows above the diagonal
        s_s[i * QS + j] = (j <= i) ? acc[a][b] * expf(ci - cum_s[j]) : 0.f;
      }
    }
    __syncthreads();                       // scores ready

    // y rows ib + 16a, column p: intra-chunk term, then the incoming state's
    float yi[4] = {0.f, 0.f, 0.f, 0.f};
    const int j_end = ib + 16 * 3;         // scores past the diagonal are 0
    for (int j = 0; j <= j_end; ++j) {
      const float xv = x_s[j * PB + p];
#pragma unroll
      for (int a = 0; a < 4; ++a) yi[a] = fmaf(s_s[(ib + 16 * a) * QS + j], xv, yi[a]);
    }
    float yo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(h_s + p * NS + n);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        yo[a] = dot4(*reinterpret_cast<const float4*>(c_s + (ib + 16 * a) * NS + n), hv, yo[a]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ib + 16 * a;
      if (t0 + i < S)
        y[((long long)(bi * S + t0 + i) * H + hh) * P + p0 + p] = yi[a] + ein_s[i] * yo[a];
    }

    // state update for rows sp, sp + 8, columns 4 nq .. 4 nq + 3
    float4 u0 = make_float4(0.f, 0.f, 0.f, 0.f), u1 = u0;
    for (int j = 0; j < Q; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(b_s + j * NS + 4 * nq);
      const float w = dout_s[j];
      const float x0 = x_s[j * PB + sp] * w;
      const float x1 = x_s[j * PB + sp + 8] * w;
      u0.x = fmaf(x0, bv.x, u0.x); u0.y = fmaf(x0, bv.y, u0.y);
      u0.z = fmaf(x0, bv.z, u0.z); u0.w = fmaf(x0, bv.w, u0.w);
      u1.x = fmaf(x1, bv.x, u1.x); u1.y = fmaf(x1, bv.y, u1.y);
      u1.z = fmaf(x1, bv.z, u1.z); u1.w = fmaf(x1, bv.w, u1.w);
    }
    __syncthreads();                       // every reader of h_s is done
    const float et = smem[OFF_TOT];
    float4* h0p = reinterpret_cast<float4*>(h_s + sp * NS + 4 * nq);
    float4* h1p = reinterpret_cast<float4*>(h_s + (sp + 8) * NS + 4 * nq);
    st0 = *h0p;
    st1 = *h1p;
    st0 = make_float4(fmaf(et, st0.x, u0.x), fmaf(et, st0.y, u0.y),
                      fmaf(et, st0.z, u0.z), fmaf(et, st0.w, u0.w));
    st1 = make_float4(fmaf(et, st1.x, u1.x), fmaf(et, st1.y, u1.y),
                      fmaf(et, st1.z, u1.z), fmaf(et, st1.w, u1.w));
    *h0p = st0;
    *h1p = st1;
  }

  float* hp = h_out + (((long long)bi * H + hh) * P + p0) * N;
  *reinterpret_cast<float4*>(hp + sp * N + 4 * nq) = st0;
  *reinterpret_cast<float4*>(hp + (sp + 8) * N + 4 * nq) = st1;
}

template <typename T>
int launch(const float* x, const float* dta, const void* bm, const void* cm,
           float* y, float* h, int B, int S, int H, int G, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(P / PB, H, B);
  ssd_scan_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      x, dta, static_cast<const T*>(bm), static_cast<const T*>(cm), y, h, S, H, G);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,S,H,P) f32 dt-scaled, dta (B,S,H) f32, b/c (B,S,G,N) of `dtype`
// (0 = float32, 1 = bfloat16), all contiguous; y (B,S,H,P) and h (B,H,P,N)
// f32.  Only P = 64 and N = 128 are instantiated.  Returns the cudaError_t
// of the launch.
extern "C" int ssd_scan(const void* x, const void* dta, const void* b,
                        const void* c, void* y, void* h, int B, int S, int H,
                        int G, int P_, int N_, int dtype, void* stream) {
  if (P_ != P || N_ != N || G <= 0 || H % G) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  if (S == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dta);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  if (dtype == 0) return launch<float>(xf, df, b, c, yf, hf, B, S, H, G, s);
  if (dtype == 1) return launch<__nv_bfloat16>(xf, df, b, c, yf, hf, B, S, H, G, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssd_scan_smem_bytes() { return SMEM_BYTES; }

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
