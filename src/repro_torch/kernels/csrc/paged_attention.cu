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
// Head dims.  Every hd that is a multiple of 8 from 8 to 256 runs, on the
// smallest instance of width HD in {64, 128, 256} with hd <= HD; the true hd
// comes at run time and every global offset (q, pools, out, the partials)
// steps by it.  Columns hd .. HD - 1 of the staged K, V and q rows are zero
// (16-byte copies of source size 0, q rows filled with 0), so they add
// nothing to the scores or to P V; the stores skip them, and the scale is
// 1 / sqrt(hd) of the true hd.  The <64> and <128> instances run 128
// threads, HD = 256 runs 256 (one thread per output column).  An hd equal
// to its instance's width runs the instance built for it (PAD false), where
// the size is a compile-time constant, so the registered configs' head dims
// keep the code they ran before the padded ones existed.
//
// Design: split-KV in one launch.  The grid is (B, KV, n_split), n_split =
// ceil(maxp * pt / CHUNK), all from host-known shapes: positions are read
// only on the card, so a decode step never waits on the host.  CTA (b, h, s)
// owns tokens s * CHUNK .. s * CHUNK + CHUNK - 1.  It reads their page ids
// from `tables` (no gather, no contiguous copy; ids clamped into the pool
// like JAX's gather), stages the chunk's K and V once in shared memory with
// 16-byte cp.async copies (tokens past pos zero-filled), and serves all G
// query rows of the kv head from them: scores with one thread per (token,
// row group: THREADS / 64 rows a pass), an f32 softmax per row (one warp a
// row, exp2 with the scale folded in), then P V with THREADS / HD threads per
// column, each over every (THREADS / HD)-th row.  It writes its partial (acc,
// m, l) in f32 to a scratch buffer.  A CTA whose chunk starts past pos writes
// the empty partial m = NEG_INF, l = 0 and leaves.  Each CTA
// then bumps an int32 counter of its (b, h); the one that brings it to
// n_split is the last (the threadfence-reduction pattern), combines the
// ceil((pos + 1) / CHUNK) partials that hold tokens, out = sum_s acc_s
// 2^(m_s - M) / sum_s l_s 2^(m_s - M) with M the max over the splits (chunk 0
// always holds token 0, so M is finite; the empties' weight would be exactly
// 0), writes out and resets the counter to 0 for the next launch.  The
// counters are state between launches, so launches that may overlap (two
// streams, two captured graphs) must never share them: the launcher keeps a
// buffer per stream and gives every captured launch one of its own.  NEG_INF
// stays finite (-1e30) and l is floored at 1e-30, as in the TPU kernel.
//
// Bound.  Decode reads every valid K/V byte once: (pos+1) * 2 * hd * itemsize
// per (b, kv-head), over HBM bandwidth (3.35 TB/s on an H100 SXM).  At the
// serving sizes (a few hundred tokens, B <= 8) that is well under a
// microsecond, so the time is one chunk's latency (page ids, then the K/V
// copies, then three short compute phases) plus the last CTA's combine,
// not bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int CHUNK = 64;      // tokens per CTA
constexpr float LOG2E = 1.4426950408889634f;

// threads per CTA of the instance of width HD: a multiple of CHUNK (token j of
// the scores is tid % CHUNK) and of HD (column d of P V is tid % HD)
#define PAGED_THREADS(HD) ((HD) > 128 ? (HD) : 128)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = __bfloat1622float2(h[i]);
    f[2 * i] = y.x;
    f[2 * i + 1] = y.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// a K/V row in shared memory: hd values and 16 bytes of padding, so the 8
// threads of a 16-byte-load phase read 8 rows from 8 distinct bank groups
template <typename T, int HD>
__host__ __device__ constexpr int row_elems() { return HD + 16 / (int)sizeof(T); }

template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes(int G) {
  return 2 * (size_t)CHUNK * row_elems<T, HD>() * sizeof(T)  // K, V chunk
         + sizeof(float) * ((size_t)G * HD                   // scaled q rows
                            + (size_t)G * CHUNK              // scores, then probs
                            + 2 * (size_t)G);                // m, l per row
}

// HD: the instance's width; hd <= HD: the true head dim, columns past it zero
// (PAD false: hd == HD, known at compile time)
template <typename T, int HD, bool PAD>
__global__ void __launch_bounds__(PAGED_THREADS(HD)) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ positions, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ counters, int KV, int G, int hd_,
    int P, int pt, int maxp, int n_split, float scale_log2) {
  constexpr int THREADS = PAGED_THREADS(HD);
  const int hd = PAD ? hd_ : HD;
  static_assert((HD == 64 || HD == 128 || HD == 256) && THREADS % CHUNK == 0 &&
                    THREADS % HD == 0,
                "thread mapping: tid % 64 is a token, tid % HD a column");
  constexpr int NG = THREADS / CHUNK;     // score rows a thread group takes at once
  constexpr int TPC = THREADS / HD;       // threads per output column
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte copy
  constexpr int RC = HD / VEC;            // copies per row
  constexpr int HDP = row_elems<T, HD>();
  extern __shared__ __align__(16) uint8_t smem[];
  T* k_s = reinterpret_cast<T*>(smem);                // (CHUNK, HDP)
  T* v_s = k_s + CHUNK * HDP;                         // (CHUNK, HDP)
  float* q_s = reinterpret_cast<float*>(v_s + CHUNK * HDP);  // (G, HD)
  float* p_s = q_s + G * HD;                          // (G, CHUNK)
  float* m_s = p_s + G * CHUNK;                       // (G,)
  float* l_s = m_s + G;                               // (G,)
  __shared__ int is_last;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = b * KV + h;
  const int rc = hd / VEC;                            // copies that hold the true hd
  const size_t stride = (size_t)G * (hd + 2);         // one partial: acc, m, l
  float* mine = part + ((size_t)bh * n_split + split) * stride;

  // tokens 0..pos are valid; the table row addresses at most maxp * pt
  const int n_tok = min(positions[b] + 1, maxp * pt);
  const int t0 = split * CHUNK;
  const size_t head = (size_t)bh * G * hd;
  if (t0 < n_tok) {
    const int* row = tables + (size_t)b * maxp;
#pragma unroll
    for (int i = tid; i < CHUNK * RC; i += THREADS) {
      const int r = i / RC, c = i % RC, t = t0 + r;
      const bool ok = t < n_tok && c < rc;
      // clamp like JAX's gather: the engine keeps every id in range
      const int page = ok ? min(max(row[t / pt], 0), P - 1) : 0;
      const size_t off =
          (((size_t)page * pt + (ok ? t % pt : 0)) * KV + h) * hd + (ok ? c * VEC : 0);
      cp16(k_s + r * HDP + c * VEC, k_pages + off, ok);
      cp16(v_s + r * HDP + c * VEC, v_pages + off, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int i = tid; i < G * HD; i += THREADS) {
      const int g = i / HD, d = i % HD;
      q_s[i] = d < hd ? to_f32(q[head + g * hd + d]) * scale_log2 : 0.f;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // scores: thread -> token j, rows g0, g0 + NG, ... (4 NG rows per pass)
    const int j = tid & (CHUNK - 1);
    const int g0 = tid / CHUNK;
    const bool valid = t0 + j < n_tok;
    for (int gb = 0; gb < G; gb += 4 * NG) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        float kf[VEC];
        unpack(k_s + j * HDP + c * VEC, kf);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int g = gb + g0 + NG * u;
          if (g < G) {
            const float* qr = q_s + g * HD + c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) a[u] = fmaf(qr[e], kf[e], a[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = gb + g0 + NG * u;
        if (g < G) p_s[g * CHUNK + j] = valid ? a[u] : NEG_INF;
      }
    }
    __syncthreads();

    // softmax over the chunk: one warp per row, two tokens per lane; token t0
    // is valid, so the max is finite and masked tokens get p = 0
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s0 = p_s[g * CHUNK + lane], s1 = p_s[g * CHUNK + lane + 32];
      const float mx = warp_max(fmaxf(s0, s1));
      const float p0 = exp2f(s0 - mx), p1 = exp2f(s1 - mx);
      const float sum = warp_sum(p0 + p1);
      p_s[g * CHUNK + lane] = p0;
      p_s[g * CHUNK + lane + 32] = p1;
      if (lane == 0) {
        mine[G * hd + g] = mx;
        mine[G * hd + G + g] = sum;
      }
    }
    __syncthreads();

    // acc = P V: thread -> column d, rows gd, gd + TPC, ... (four per pass)
    const int d = tid % HD;
    const int gd = tid / HD;
    for (int gb = 0; gb < G && d < hd; gb += 4 * TPC) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int t = 0; t < CHUNK; ++t) {
        const float vf = to_f32(v_s[t * HDP + d]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int g = gb + gd + TPC * u;
          if (g < G) a[u] = fmaf(p_s[g * CHUNK + t], vf, a[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = gb + gd + TPC * u;
        if (g < G && d < hd) mine[g * hd + d] = a[u];
      }
    }
  } else {
    for (int g = tid; g < G; g += THREADS) {  // the empty partial
      mine[G * hd + g] = NEG_INF;
      mine[G * hd + G + g] = 0.f;
    }
  }

  // the last CTA of (b, h) to finish combines
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + bh, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = part + (size_t)bh * n_split * stride;
  const int n_used = (n_tok + CHUNK - 1) / CHUNK;   // the partials that hold tokens
  for (int g = warp; g < G; g += THREADS / 32) {
    float mx = NEG_INF;
    for (int s = lane; s < n_used; s += 32) mx = fmaxf(mx, __ldcg(parts + s * stride + G * hd + g));
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < n_used; s += 32)
      sum += __ldcg(parts + s * stride + G * hd + G + g) *
             exp2f(__ldcg(parts + s * stride + G * hd + g) - mx);
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = 1.f / fmaxf(sum, 1e-30f);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd;
    float a = 0.f;
    for (int s = 0; s < n_used; ++s)
      a = fmaf(__ldcg(parts + s * stride + i),
               exp2f(__ldcg(parts + s * stride + G * hd + g) - m_s[g]), a);
    out[head + i] = from_f32<T>(a * l_s[g]);
  }
  if (tid == 0) counters[bh] = 0;                   // ready for the next launch
}

template <typename T, int HD, bool PAD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* positions, void* out, void* part,
           void* counters, int B, int KV, int G, int hd, int P, int pt, int maxp,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T, HD, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_split = (maxp * pt + CHUNK - 1) / CHUNK;
  const float scale_log2 = LOG2E / sqrtf((float)hd);
  paged_split_kernel<T, HD, PAD><<<dim3(B, KV, n_split), PAGED_THREADS(HD), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), KV, G, hd, P, pt,
      maxp, n_split, scale_log2);
  return (int)cudaGetLastError();
}

// The instance that runs head dim hd: the smallest width of 64, 128 and 256
// that holds it, or 0 where none does (hd not a multiple of 8 from 8 to 256).
int instance(int hd) {
  if (hd < 8 || hd > 256 || hd % 8) return 0;
  return hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

}  // namespace

// part: n_split * B * KV * G * (hd + 2) floats of scratch, n_split =
// ceil(maxp * pt / 64); counters: B * KV int32, all 0 before the launch and
// left at 0 after it, owned by this launch's stream (or captured graph) alone.
// dtype: 0 = float32, 1 = bfloat16; hd: a multiple of 8 from 8 to 256, run on
// instance(hd).  Returns the cudaError_t of the launch.
extern "C" int paged_attention_decode(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* positions, void* out,
                                      void* part, void* counters, int B, int KV,
                                      int G, int hd, int P, int pt, int maxp,
                                      int dtype, void* stream) {
  if (B == 0) return 0;
  if (maxp <= 0 || pt <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = instance(hd);
#define PAGED_LAUNCH(T, D)                                                          \
  (hd == D ? launch<T, D, false>(q, k_pages, v_pages, tables, positions, out, part, \
                                 counters, B, KV, G, hd, P, pt, maxp, s)            \
           : launch<T, D, true>(q, k_pages, v_pages, tables, positions, out, part,  \
                                counters, B, KV, G, hd, P, pt, maxp, s))
  if (dtype == 0 && W == 64) return PAGED_LAUNCH(float, 64);   // qwen2-0.5b
  if (dtype == 1 && W == 64) return PAGED_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 0 && W == 128) return PAGED_LAUNCH(float, 128);  // phi4-mini-3.8b
  if (dtype == 1 && W == 128) return PAGED_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 0 && W == 256) return PAGED_LAUNCH(float, 256);
  if (dtype == 1 && W == 256) return PAGED_LAUNCH(__nv_bfloat16, 256);
#undef PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per CTA of the instance that runs head dim hd, for G
// query rows per kv head, or -1 where none does.
extern "C" int paged_attention_smem_bytes(int G, int hd, int dtype) {
  const int W = instance(hd);
  if (dtype == 0 && W == 64) return (int)smem_bytes<float, 64>(G);
  if (dtype == 1 && W == 64) return (int)smem_bytes<__nv_bfloat16, 64>(G);
  if (dtype == 0 && W == 128) return (int)smem_bytes<float, 128>(G);
  if (dtype == 1 && W == 128) return (int)smem_bytes<__nv_bfloat16, 128>(G);
  if (dtype == 0 && W == 256) return (int)smem_bytes<float, 256>(G);
  if (dtype == 1 && W == 256) return (int)smem_bytes<__nv_bfloat16, 256>(G);
  return -1;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
