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
// Design: the state-space-duality decomposition (Dao & Gu, 2024,
// arXiv:2405.21060, section 6) in three launches, so that only the short
// state recurrence runs over the chunks in order.  The TPU kernel walks the
// chunks as a sequential grid axis and carries the (H, P, N) state in VMEM;
// blocks on Hopper run in no order, so the carry gets its own launch.
//   1. ssd_chunk_kernel, grid (chunks, H + G, B).  CTA (c, h < H) scans the
//      chunk's dta of head h (cum, written to scratch) and computes the
//      chunk's own state s_c = sum_j exp(cum_last - cum_j) x_j B_j^T (P x N)
//      from a zero start, into scratch.  CTA (c, H + g) computes the causal
//      tiles of C B^T (Q x Q) of group g once for all its heads, into
//      scratch.  Every chunk runs at once.
//   2. ssd_pass_kernel, grid (P N / 1024, H, B): per element of the state,
//      h_c = exp(cum_last,c) h_{c-1} + s_c over the chunks in order,
//      overwriting s_c with the state that enters chunk c, and writing the
//      final state.  Elementwise, one chunk a step (8 steps at S = 512).
//   3. ssd_out_kernel, grid (chunks, H, B): y = (C B^T o L) x
//      + exp(cum) C h_in, with L[i, j] = exp(cum_i - cum_j) for j <= i.
//      The causal mask is applied before the exponential: cum_i - cum_j > 0
//      above the diagonal, and exp overflowing to inf would turn inf * 0
//      into NaN.
// A ragged last chunk reads zeros for x, dta, B and C, which leave the state
// unchanged; its rows past S are not written.
//
// Numerics.  Every product runs on the tensor cores as mma.sync m16n8k8 TF32
// with f32 accumulation.  An f32 operand is split into a TF32 high part and
// a TF32 remainder, and a product takes three passes (hi hi + hi lo + lo hi;
// the dropped lo lo term is 2^-22 of it), so the result keeps f32 accuracy.
// A bf16 value is exact in TF32: with bf16 B and C, C B^T takes one pass,
// and each product with x, the decays or h takes two.
//
// Shared memory: operands are staged as f32 rows padded so that every
// fragment load of a warp hits 32 distinct banks (rows of 136 floats where
// the fragment walks rows with the lane's low bits, of 132 or 68 where it
// walks columns); the C B^T CTAs reuse the state CTAs' 136-float rows and
// take two-way conflicts, one CTA per chunk.  f32 inputs arrive by 16-byte
// cp.async copies, bf16 ones through registers, converted at the store.
//
// Bound.  Operations: per token, C B^T per group (G N multiply-adds) and per
// head the intra term (P), the incoming state's term (P N) and the state
// update (P N), at chunk length 1 where the count is least; in f32 at 67
// TFLOP/s on an H100 SXM.  The datapath used is split TF32: three passes at
// 494.7 TFLOP/s.  Bytes: x, y, dta, B, C and h read or written once, over
// 3.35 TB/s; the scratch (chunk states, C B^T, cum) stays mostly in the 50 MB
// L2 between the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int Q = 64;          // tokens per chunk
constexpr int N = 128;         // state size
constexpr int P = 64;          // head dim
constexpr int THREADS = 256;   // eight warps
constexpr int RS = N + 8;      // chunk kernel: B rows; C rows or x rows beside
constexpr int XS = P + 8;      // x rows: fragment (row t, column g) at bank 8t + g
constexpr int CS = N + 4;      // output kernel: C rows, fragment (row g, column t) at 4g + t
constexpr int HS = N + 4;      // rows h[p][.] of the incoming state
constexpr int MS = Q + 4;      // rows of the masked, decayed C B^T
constexpr int PASS_BLOCKS = P * N / (4 * THREADS);  // pass: one float4 a thread

// chunk kernel: B (Q x RS), then C (Q x RS) or x (Q x XS) and the decays (Q)
constexpr int CHUNK_SMEM = 2 * Q * RS * 4;
// output kernel: C, h_in, x, masked C B^T, cum
constexpr int OFF_H = Q * CS;
constexpr int OFF_X = OFF_H + P * HS;
constexpr int OFF_M = OFF_X + Q * XS;
constexpr int OFF_CUM = OFF_M + Q * MS;
constexpr int OUT_SMEM = (OFF_CUM + Q) * 4;
static_assert(Q * XS + Q <= Q * RS, "x rows and decays fit beside the B rows");

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ROWS x COLS of a row-major global block (row stride gs elements) into
// shared f32 rows of stride ss; rows from `valid` on are zero-filled
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(float* dst, int ss, const float* src, long long gs,
                                      int valid, int tid) {
  constexpr int VECS = COLS / 4;
  static_assert(ROWS * VECS % THREADS == 0, "tile split");
#pragma unroll
  for (int e = 0; e < ROWS * VECS / THREADS; ++e) {
    const int i = tid + e * THREADS, r = i / VECS, c = (i % VECS) * 4;
    const bool ok = r < valid;
    cp16(dst + r * ss + c, src + (ok ? r * gs + c : 0), ok);
  }
}

template <int ROWS, int COLS>
__device__ __forceinline__ void stage(float* dst, int ss, const __nv_bfloat16* src,
                                      long long gs, int valid, int tid) {
  constexpr int VECS = COLS / 8;
  constexpr int PER = ROWS * VECS / THREADS;
  static_assert(ROWS * VECS % THREADS == 0, "tile split");
  uint4 raw[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {   // every load in flight before any store
    const int i = tid + e * THREADS, r = i / VECS, c = (i % VECS) * 8;
    raw[e] = r < valid ? *reinterpret_cast<const uint4*>(src + r * gs + c)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = tid + e * THREADS, r = i / VECS, c = (i % VECS) * 8;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[e]);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    *reinterpret_cast<float4*>(dst + r * ss + c) = make_float4(f0.x, f0.y, f1.x, f1.y);
    *reinterpret_cast<float4*>(dst + r * ss + c + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

// ---- split TF32 on the tensor cores ----------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b, m16n8k8; a: (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// b: (row t, col g), (t + 4, g); d: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
// with g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment: high parts and, unless the values are exact in TF32, the
// remainders
struct FragA {
  uint32_t hi[4], lo[4];
};

template <bool EXACT>
__device__ __forceinline__ void frag_a(FragA& f, float a0, float a1, float a2, float a3) {
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (EXACT) f.hi[i] = __float_as_uint(v[i]);
    else split(v[i], f.hi[i], f.lo[i]);
  }
}

// d += a b in split TF32: hi hi + hi lo + lo hi, skipping the passes whose
// remainder is exactly 0
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0, float b1) {
  uint32_t h0, h1;
  if constexpr (B_EXACT) {
    h0 = __float_as_uint(b0);
    h1 = __float_as_uint(b1);
  } else {
    uint32_t l0, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    mma8(d, a.hi, l0, l1);
  }
  if constexpr (!A_EXACT) mma8(d, a.lo, h0, h1);
  mma8(d, a.hi, h0, h1);
}

// ---- 1. chunk states and C B^T ---------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dta, const T* __restrict__ bm,
    const T* __restrict__ cm, float* __restrict__ states, float* __restrict__ cb,
    float* __restrict__ cum, int S, int H, int G) {
  constexpr bool EXACT = !std::is_same<T, float>::value;  // bf16: exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;                      // (Q, RS): the chunk's B rows
  float* r_s = smem + Q * RS;             // (Q, RS): C rows, or x rows and decays
  const int c = blockIdx.x, role = blockIdx.y, bi = blockIdx.z, nc = gridDim.x;
  const int t0 = c * Q, valid = min(Q, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mt = warp & 3, nh = warp >> 2;  // this warp's 16-row band, column half

  if (role >= H) {  // C B^T of group role - H: rows i, columns j, causal tiles
    const int g = role - H;
    const long long row0 = ((long long)bi * S + t0) * G + g;
    stage<Q, N>(b_s, RS, bm + row0 * N, (long long)G * N, valid, tid);
    stage<Q, N>(r_s, RS, cm + row0 * N, (long long)G * N, valid, tid);
    cp_wait_all();
    __syncthreads();
    const int i0 = 16 * mt;
    float acc[4][4] = {};
#pragma unroll 4
    for (int n0 = 0; n0 < N; n0 += 8) {
      FragA a;
      const float* cr = r_s + (i0 + gq) * RS + n0 + tq;
      frag_a<EXACT>(a, cr[0], cr[8 * RS], cr[4], cr[8 * RS + 4]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j0 = 32 * nh + 8 * nt;
        if (j0 > i0 + 15) continue;       // wholly above the diagonal
        const float* br = b_s + (j0 + gq) * RS + n0 + tq;
        mma3<EXACT, EXACT>(acc[nt], a, br[0], br[4]);
      }
    }
    float* o = cb + (((long long)bi * nc + c) * G + g) * Q * Q;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j0 = 32 * nh + 8 * nt;
      if (j0 > i0 + 15) continue;
      *reinterpret_cast<float2*>(o + (i0 + gq) * Q + j0 + 2 * tq) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(o + (i0 + gq + 8) * Q + j0 + 2 * tq) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
    return;
  }

  // the chunk's own state for head h: s (P x N) = sum_j (x_j w_j)^T B_j
  const int h = role, g = h / (H / G);
  float* x_s = r_s;                       // (Q, XS)
  float* w_s = r_s + Q * XS;              // (Q): exp(cum_last - cum_j)
  stage<Q, P>(x_s, XS, x + (((long long)bi * S + t0) * H + h) * P, (long long)H * P,
              valid, tid);
  stage<Q, N>(b_s, RS, bm + (((long long)bi * S + t0) * G + g) * N, (long long)G * N,
              valid, tid);
  if (warp == 0) {  // cum over the chunk: lane owns positions 2 lane, 2 lane + 1
    const int j = 2 * lane;
    const float* dp = dta + ((long long)bi * S + t0 + j) * H + h;
    const float d0 = j < valid ? dp[0] : 0.f;
    const float d1 = j + 1 < valid ? dp[H] : 0.f;
    float inc = d0 + d1;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) excl = 0.f;
    const float c0 = excl + d0, c1 = c0 + d1;
    const float last = __shfl_sync(0xffffffffu, c1, 31);  // the pass reads the same
    *reinterpret_cast<float2*>(cum + (((long long)bi * nc + c) * H + h) * Q + j) =
        make_float2(c0, c1);
    w_s[j] = expf(last - c0);
    w_s[j + 1] = expf(last - c1);
  }
  cp_wait_all();
  __syncthreads();
  const int p0 = 16 * mt;
  float acc[8][4] = {};
#pragma unroll 2
  for (int j0 = 0; j0 < Q; j0 += 8) {
    const float w0 = w_s[j0 + tq], w1 = w_s[j0 + tq + 4];
    const float* xr = x_s + (j0 + tq) * XS + p0 + gq;
    FragA a;
    frag_a<false>(a, xr[0] * w0, xr[8] * w0, xr[4 * XS] * w1, xr[4 * XS + 8] * w1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* br = b_s + (j0 + tq) * RS + 64 * nh + 8 * nt + gq;
      mma3<false, EXACT>(acc[nt], a, br[0], br[4 * RS]);
    }
  }
  float* o = states + (((long long)bi * nc + c) * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 64 * nh + 8 * nt + 2 * tq;
    *reinterpret_cast<float2*>(o + (p0 + gq) * N + n) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(o + (p0 + gq + 8) * N + n) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- 2. the state recurrence over the chunks ---------------------------------

__global__ void __launch_bounds__(THREADS) ssd_pass_kernel(
    float* __restrict__ states, const float* __restrict__ cum, float* __restrict__ h_out,
    int nc, int H) {
  const int h = blockIdx.y, bi = blockIdx.z;
  const int e = 4 * (blockIdx.x * THREADS + threadIdx.x);
  const long long step = (long long)H * P * N;       // one chunk further
  float* sp = states + ((long long)bi * nc * H + h) * P * N + e;
  const float* last = cum + ((long long)bi * nc * H + h) * Q + Q - 1;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 next = __ldcg(reinterpret_cast<const float4*>(sp));
  for (int c = 0; c < nc; ++c) {
    const float4 s = next;
    if (c + 1 < nc) next = __ldcg(reinterpret_cast<const float4*>(sp + (c + 1) * step));
    const float a = expf(last[(long long)c * H * Q]);
    *reinterpret_cast<float4*>(sp + c * step) = hv;  // the state entering chunk c
    hv = make_float4(fmaf(a, hv.x, s.x), fmaf(a, hv.y, s.y), fmaf(a, hv.z, s.z),
                     fmaf(a, hv.w, s.w));
  }
  *reinterpret_cast<float4*>(h_out + ((long long)bi * H + h) * P * N + e) = hv;
}

// ---- 3. the outputs ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_out_kernel(
    const float* __restrict__ x, const T* __restrict__ cm, const float* __restrict__ states,
    const float* __restrict__ cb, const float* __restrict__ cum, float* __restrict__ y,
    int S, int H, int G) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  constexpr int PER = Q * Q / THREADS;
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;                      // (Q, CS)
  float* h_s = smem + OFF_H;              // (P, HS): h_in[p][n]
  float* x_s = smem + OFF_X;              // (Q, XS)
  float* m_s = smem + OFF_M;              // (Q, MS)
  float* cum_s = smem + OFF_CUM;          // (Q)
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z, nc = gridDim.x;
  const int g = h / (H / G);
  const int t0 = c * Q, valid = min(Q, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mt = warp & 3, nh = warp >> 2;
  const long long ch = ((long long)bi * nc + c) * H + h;

  stage<Q, N>(c_s, CS, cm + (((long long)bi * S + t0) * G + g) * N, (long long)G * N,
              valid, tid);
  stage<P, N>(h_s, HS, states + ch * P * N, N, P, tid);
  stage<Q, P>(x_s, XS, x + (((long long)bi * S + t0) * H + h) * P, (long long)H * P,
              valid, tid);
  const float* cbp = cb + (((long long)bi * nc + c) * G + g) * Q * Q;
  float cv[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {   // only the causal half was written
    const int i = (tid + e * THREADS) / Q, j = (tid + e * THREADS) % Q;
    cv[e] = j <= i ? cbp[i * Q + j] : 0.f;
  }
  if (tid < Q) cum_s[tid] = cum[ch * Q + tid];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < PER; ++e) {   // mask before the exponential
    const int i = (tid + e * THREADS) / Q, j = (tid + e * THREADS) % Q;
    m_s[i * MS + j] = j <= i ? cv[e] * expf(cum_s[i] - cum_s[j]) : 0.f;
  }
  cp_wait_all();
  __syncthreads();

  // rows i (16 mt ..), columns p (32 nh ..): first exp(cum_i) C_i h_in ...
  const int i0 = 16 * mt;
  float acc[4][4] = {};
#pragma unroll 4
  for (int n0 = 0; n0 < N; n0 += 8) {
    const float* cr = c_s + (i0 + gq) * CS + n0 + tq;
    FragA a;
    frag_a<EXACT>(a, cr[0], cr[8 * CS], cr[4], cr[8 * CS + 4]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* hr = h_s + (32 * nh + 8 * nt + gq) * HS + n0 + tq;
      mma3<EXACT, false>(acc[nt], a, hr[0], hr[4]);
    }
  }
  const float e0 = expf(cum_s[i0 + gq]), e1 = expf(cum_s[i0 + gq + 8]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    acc[nt][0] *= e0;
    acc[nt][1] *= e0;
    acc[nt][2] *= e1;
    acc[nt][3] *= e1;
  }
  // ... then (C B^T o L) x over the keys up to the band's last row
  for (int j0 = 0; j0 < i0 + 16; j0 += 8) {
    const float* mr = m_s + (i0 + gq) * MS + j0 + tq;
    FragA a;
    frag_a<false>(a, mr[0], mr[8 * MS], mr[4], mr[8 * MS + 4]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* xr = x_s + (j0 + tq) * XS + 32 * nh + 8 * nt + gq;
      mma3<false, false>(acc[nt], a, xr[0], xr[4 * XS]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int p = 32 * nh + 8 * nt + 2 * tq;
    const int i = i0 + gq;
    if (i < valid)
      *reinterpret_cast<float2*>(y + (((long long)bi * S + t0 + i) * H + h) * P + p) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (i + 8 < valid)
      *reinterpret_cast<float2*>(y + (((long long)bi * S + t0 + i + 8) * H + h) * P + p) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <typename T>
int launch(const float* x, const float* dta, const void* bm, const void* cm, float* y,
           float* h, float* states, float* cb, float* cum, int B, int S, int H, int G,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, CHUNK_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_out_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, OUT_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int nc = (S + Q - 1) / Q;
  const T* b = static_cast<const T*>(bm);
  const T* c = static_cast<const T*>(cm);
  ssd_chunk_kernel<T><<<dim3(nc, H + G, B), THREADS, CHUNK_SMEM, stream>>>(
      x, dta, b, c, states, cb, cum, S, H, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_pass_kernel<<<dim3(PASS_BLOCKS, H, B), THREADS, 0, stream>>>(states, cum, h, nc, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_out_kernel<T><<<dim3(nc, H, B), THREADS, OUT_SMEM, stream>>>(x, c, states, cb, cum,
                                                                   y, S, H, G);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,S,H,P) f32 dt-scaled, dta (B,S,H) f32, b/c (B,S,G,N) of `dtype`
// (0 = float32, 1 = bfloat16), all contiguous; y (B,S,H,P) and h (B,H,P,N)
// f32.  Scratch, f32, nc = ceil(S / 64): states (B,nc,H,P,N), cb
// (B,nc,G,64,64), cum (B,nc,H,64).  Only P = 64 and N = 128 are
// instantiated.  Three launches on `stream`; returns the first cudaError_t.
extern "C" int ssd_scan(const void* x, const void* dta, const void* b, const void* c,
                        void* y, void* h, void* states, void* cb, void* cum, int B,
                        int S, int H, int G, int P_, int N_, int dtype, void* stream) {
  if (P_ != P || N_ != N || G <= 0 || H % G) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  if (S == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dta);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  float* sf = static_cast<float*>(states);
  float* cbf = static_cast<float*>(cb);
  float* cumf = static_cast<float*>(cum);
  if (dtype == 0)
    return launch<float>(xf, df, b, c, yf, hf, sf, cbf, cumf, B, S, H, G, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xf, df, b, c, yf, hf, sf, cbf, cumf, B, S, H, G, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per CTA of launch 0 (chunk states and C B^T), 1 (the
// state pass) or 2 (the outputs); -1 for any other.
extern "C" int ssd_scan_smem_bytes(int launch) {
  if (launch == 0) return CHUNK_SMEM;
  if (launch == 1) return 0;
  if (launch == 2) return OUT_SMEM;
  return -1;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
