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
// Three designs, chosen by dtype and head dim (no fallback between them):
//
// bf16, D = 64, 128 and 256: the tensor cores (flash_fwd_tc_kernel).  One CTA is
// one warpgroup (128 threads) that owns 64 query rows.  Q (64 x D) sits in
// shared memory for the CTA's life; K/V tiles of 64 keys arrive through a
// two-stage ring by 16-byte cp.async copies from the strided views, rows past
// Sk zero-filled (source size 0).  Every tile is stored in the canonical
// 128-byte-swizzle layout of wgmma: a 128-byte row holds 64 bf16 of one
// key (or query), its 16-byte chunk c at c ^ (row % 8), 8 rows to a 1 KB
// atom; D = 128 and 256 keep two and four such 64-column blocks one after
// another.
// S = Q K^T is wgmma m64n64k16 with both operands in shared memory, K-major
// (D / 16 steps).  The scores are scaled in f32 (scale * log2 e, for exp2),
// masked by position, and run through the online softmax in f32 (finite
// NEG_INF = -1e30; l floored at 1e-30), each row's max shared by the quad of
// threads that holds it.  P is rounded to bf16 in registers, where the m64
// accumulator fragment is already the register-A fragment of the next
// product, and O += P V is wgmma m64n64k16 with P from registers and V from
// shared memory as the MN-major B operand (transposed), D / 64 products per 16
// keys.  O stays in f32 registers: 32 a thread at D = 64, 64 at D = 128, 128
// at D = 256.
// Query tiles run heaviest first (the causal tail), key tiles wholly in the
// causal future or before the window are skipped, and only tiles that cross
// a mask edge pay for masking.  Shared memory: Q, two K and two V tiles of
// 64 x D bf16 and 1 KB to align the atoms: 41 KB at D = 64, 81 KB at D = 128,
// 161 KB at D = 256.
//
// f32, D = 64: flash_fwd_kernel.  The CUDA cores in f32 (wgmma on f32 would
// be TF32, about 3 digits).  One CTA of 128 threads per (b * H + h, tile of
// 64 query rows).  Two threads share a query row: each holds the whole scaled
// row in registers, scores every other key of a 32-key tile and owns every
// other output column, and the pair combines row max and row sum with one
// shuffle.  K/V tiles are staged through shared memory in f32 with padded
// rows; each thread issues its loads of the next tile before waiting on the
// current one's readers.
//
// f32, D = 128 and 256: flash_fwd_wide_kernel.  The D = 64 design would hold
// qr[D] and acc[D / 2], 192 registers at D = 128 and beyond the 255-register
// limit at D = 256.  TPR = 8 threads split a query row instead: thread j of a
// row owns the float4 columns j, j + 8, ..., so it holds D / 8 floats of the
// scaled q row and D / 8 of the output.  Each key's partial dot products are
// summed across the 8 threads with three xor-shuffles.  32 rows per CTA of
// 256 threads; 32-key K/V tiles in dynamic shared memory as unpadded f32 rows
// (32 KB at D = 128, 64 KB at D = 256).
//
// Bound.  Prefill is compute-bound at the serving lengths: 4 * D FLOPs per
// valid (query, key) pair per head over the bf16 tensor-core peak (989
// TFLOP/s on an H100 SXM), or over the f32 CUDA-core peak (67 TFLOP/s) for
// the f32 designs; a short prompt is bound by its bytes.  The bf16 design
// reaches the tensor cores but not yet their peak: one warpgroup per CTA
// issues its loads, products and softmax in turn, with only the next tile's
// copies overlapping them (no producer warp, no second consumer warpgroup).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 2 * BQ;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---- wide heads: TPR threads share a query row --------------------------

constexpr int TPR = 8;                    // threads per query row
constexpr int W_BQ = 32;                  // query rows per CTA
constexpr int W_BK = 32;                  // keys per tile
constexpr int W_THREADS = TPR * W_BQ;

template <int D>
constexpr int wide_smem_bytes() { return 2 * W_BK * D * 4; }  // K and V tiles, f32

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes of T as floats into dst[0 .. 16 / sizeof(T))
__device__ __forceinline__ void store_vec(float4* dst, const uint4& raw, float) {
  dst[0] = *reinterpret_cast<const float4*>(&raw);
}

template <typename T, int D>
__global__ void __launch_bounds__(W_THREADS) flash_fwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Strides sq_, Strides sk_, Strides sv_, Strides so_,
    int H, int KV, int Sq, int Sk, int causal, int window, int q_offset,
    float scale) {
  constexpr int D4 = D / 4;                 // float4 columns of a row
  constexpr int M = D4 / TPR;               // float4 columns per thread
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int ROW_VECS = D / VEC;
  constexpr int PER = W_BK * ROW_VECS / W_THREADS;  // loads per thread per tile
  static_assert(D4 % TPR == 0 && (W_BK * ROW_VECS) % W_THREADS == 0, "tile split");
  extern __shared__ float4 smem4[];
  float4* k_s = smem4;                      // [W_BK][D4]
  float4* v_s = smem4 + W_BK * D4;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh - b * H;
  const int kvh = hh / (H / KV);
  const int q0 = blockIdx.x * W_BQ;
  const int tid = threadIdx.x;
  const int j = tid % TPR;                  // owns float4 columns j + TPR * m
  const int row = q0 + tid / TPR;
  const int q_pos = q_offset + row;

  float4 qr[M], acc[M];
  {
    const T* qp = q + b * sq_.b + hh * sq_.h + (long long)min(row, Sq - 1) * sq_.s;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float4 x = load4(qp + 4 * (j + TPR * m));
      qr[m] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float m_run = NEG_INF, l = 0.f;

  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_offset + q0 + W_BQ);
  if (window) k_lo = max(0, q_offset + q0 - window + 1);
  k_lo = (k_lo / W_BK) * W_BK;

  const T* kb = k + b * sk_.b + kvh * sk_.h;
  const T* vb = v + b * sv_.b + kvh * sv_.h;
  uint4 kx[PER], vx[PER];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * W_THREADS;
      const int key = k0 + i / ROW_VECS;
      const int col = (i % ROW_VECS) * VEC;
      kx[e] = make_uint4(0u, 0u, 0u, 0u);
      vx[e] = make_uint4(0u, 0u, 0u, 0u);
      if (key < Sk) {
        kx[e] = *reinterpret_cast<const uint4*>(kb + (long long)key * sk_.s + col);
        vx[e] = *reinterpret_cast<const uint4*>(vb + (long long)key * sv_.s + col);
      }
    }
  };
  if (k_lo < k_hi) load_tile(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += W_BK) {
    __syncthreads();                        // previous tile fully consumed
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * W_THREADS;
      const int f4 = (i / ROW_VECS) * D4 + (i % ROW_VECS) * (VEC / 4);
      store_vec(k_s + f4, kx[e], T());
      store_vec(v_s + f4, vx[e], T());
    }
    __syncthreads();
    if (k0 + W_BK < k_hi) load_tile(k0 + W_BK);  // in flight during this tile

    float s[W_BK];
    float mt = NEG_INF;
#pragma unroll
    for (int kk = 0; kk < W_BK; ++kk) {
      const float4* kr = k_s + kk * D4 + j;
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 kv4 = kr[TPR * m];
        a = fmaf(qr[m].x, kv4.x, a);
        a = fmaf(qr[m].y, kv4.y, a);
        a = fmaf(qr[m].z, kv4.z, a);
        a = fmaf(qr[m].w, kv4.w, a);
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      const int key = k0 + kk;
      bool ok = key < Sk;
      if (causal) ok = ok && key <= q_pos;
      if (window) ok = ok && key > q_pos - window;
      s[kk] = ok ? a : NEG_INF;
      mt = fmaxf(mt, s[kk]);
    }
    const float m_new = fmaxf(m_run, mt);
    const float corr = expf(m_run - m_new);
    float ls = 0.f;
#pragma unroll
    for (int kk = 0; kk < W_BK; ++kk) {
      s[kk] = expf(s[kk] - m_new);
      ls += s[kk];
    }
    l = l * corr + ls;
    m_run = m_new;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      acc[m].x *= corr; acc[m].y *= corr; acc[m].z *= corr; acc[m].w *= corr;
    }
#pragma unroll
    for (int kk = 0; kk < W_BK; ++kk) {
      const float p = s[kk];
      const float4* vr = v_s + kk * D4 + j;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 v4 = vr[TPR * m];
        acc[m].x = fmaf(p, v4.x, acc[m].x);
        acc[m].y = fmaf(p, v4.y, acc[m].y);
        acc[m].z = fmaf(p, v4.z, acc[m].z);
        acc[m].w = fmaf(p, v4.w, acc[m].w);
      }
    }
  }

  if (row < Sq) {
    T* op = out + b * so_.b + hh * so_.h + (long long)row * so_.s;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = 4 * (j + TPR * m);
      op[c] = from_f32<T>(acc[m].x * inv);
      op[c + 1] = from_f32<T>(acc[m].y * inv);
      op[c + 2] = from_f32<T>(acc[m].z * inv);
      op[c + 3] = from_f32<T>(acc[m].w * inv);
    }
  }
}

template <typename T, int D>
int launch_wide(const void* q, const void* k, const void* v, void* out,
                const long long* st, int B, int H, int KV, int Sq, int Sk,
                int causal, int window, int q_offset, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wide_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wide_smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((Sq + W_BQ - 1) / W_BQ, B * H);
  flash_fwd_wide_kernel<T, D><<<grid, W_THREADS, wide_smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, sv, so, H, KV,
      Sq, Sk, causal, window, q_offset, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores: wgmma m64n64k16 ---------------------------

namespace tc {

constexpr int BQ = 64;        // query rows per CTA: one warpgroup's m64
constexpr int BC = 64;        // keys per tile
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;     // K/V ring
constexpr int BLOCK = 64 * 128;  // one 64-row x 128-byte swizzled block
constexpr int ALIGN = 1024;   // a swizzle atom: 8 rows x 128 B

template <int D>
__host__ __device__ constexpr int tile_bytes() { return 64 * D * 2; }  // 64 rows of D bf16
template <int D>
__host__ __device__ constexpr int smem_bytes() { return (1 + 2 * STAGES) * tile_bytes<D>() + ALIGN; }

// byte offset of 16-byte chunk c of row r in a 64-row tile: 64-column blocks
// one after another, each in the 128-byte-swizzle layout
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * BLOCK + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of wgmma's registers across it
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B: A (64 x 16) and B (16 x 64) from shared memory, both K-major
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d += A B: A (64 x 16) from registers, B (16 x 64) from shared memory,
// MN-major (transposed)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Thread t of the warpgroup holds accumulator rows r = 16 (t / 32) + (t % 32) / 4
// and r + 8; register 4j + e holds row r + 8 (e / 2), column 8j + 2 (t % 4) + e % 2.
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    Strides sq_, Strides sk_, Strides sv_, Strides so_, int H, int KV, int Sq,
    int Sk, int causal, int window, int q_offset, float scale_log2) {
  constexpr int CH = D / 8;          // 16-byte chunks of a row
  constexpr int NB = D / 64;         // 64-column blocks
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t q_s = base;         // then per stage s: K at 1 + 2s, V at 2 + 2s tiles

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh - b * H;
  const int kvh = hh / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_offset + q0 + BQ);
  if (window) k_lo = max(0, q_offset + q0 - window + 1);
  k_lo = (k_lo / BC) * BC;
  const int n_tiles = k_lo < k_hi ? (k_hi - k_lo + BC - 1) / BC : 0;

  const __nv_bfloat16* qb = q + b * sq_.b + hh * sq_.h;
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, row = q0 + r;
    cp16(q_s + swz(r, c), qb + (long long)min(row, Sq - 1) * sq_.s + c * 8, row < Sq);
  }
  const __nv_bfloat16* kb = k + b * sk_.b + kvh * sk_.h;
  const __nv_bfloat16* vb = v + b * sv_.b + kvh * sv_.h;
  auto load_kv = [&](int t) {
    const uint32_t ks = base + TILE * (1 + 2 * (t & 1));
    const int k0 = k_lo + t * BC;
#pragma unroll 4
    for (int i = tid; i < BC * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, key = k0 + r;
      const long long kc = min(key, Sk - 1);
      cp16(ks + swz(r, c), kb + kc * sk_.s + c * 8, key < Sk);
      cp16(ks + TILE + swz(r, c), vb + kc * sv_.s + c * 8, key < Sk);
    }
  };
  if (n_tiles > 0) load_kv(0);
  cp_commit();

  float o[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows r, r + 8
  const int r = warp * 16 + (lane >> 2);
  const int qp0 = q_offset + q0 + r, qp1 = qp0 + 8;
  const int cq = 2 * (lane & 3);

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_commit();
    cp_wait1();                                    // Q and tile t have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t ks = base + TILE * (1 + 2 * (t & 1));
    const uint32_t vs = ks + TILE;
    const int k0 = k_lo + t * BC;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BLOCK + (kk & 3) * 32;
      mma_ss(s, desc(q_s + off, 16, 1024), desc(ks + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    pin(s);

    const bool edge = k0 + BC > Sk || (causal && k0 + BC - 1 > q_offset + q0) ||
                      (window && k0 <= q_offset + q0 + BQ - 1 - window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qp = (i & 2) ? qp1 : qp0;
        bool ok = key < Sk;
        if (causal) ok = ok && key <= qp;
        if (window) ok = ok && key > qp - window;
        x = ok ? x : NEG_INF;
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - ((i & 2) ? mn1 : mn0));
      s[i] = p;
      if (i & 2) ls1 += p; else ls0 += p;
    }
    l0 = l0 * c0 + ls0;                            // this thread's columns only
    l1 = l1 * c1 + ls1;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] *= (i & 2) ? c1 : c0;
    // P as bf16 A fragments, one per 16 keys: the accumulator pairs in order
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);

#pragma unroll
    for (int n = 0; n < NB; ++n) pin(o[n]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NB; ++n)
        mma_rs(o[n], a[kk], desc(vs + n * BLOCK + kk * 2048, BLOCK, 1024));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int n = 0; n < NB; ++n) pin(o[n]);
    __syncthreads();                               // stage t & 1 free for tile t + 2
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + b * so_.b + hh * so_.h;
  const int row0 = q0 + r, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * n + 8 * j + cq;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * so_.s + col) =
            __floats2bfloat162_rn(o[n][4 * j] * inv0, o[n][4 * j + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * so_.s + col) =
            __floats2bfloat162_rn(o[n][4 * j + 2] * inv1, o[n][4 * j + 3] * inv1);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* st, int B, int H, int KV, int Sq, int Sk, int causal,
           int window, int q_offset, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_tc_kernel<D><<<grid, THREADS, smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq,
      sk, sv, so, H, KV, Sq, Sk, causal, window, q_offset,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace tc


}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, out.
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); D: 64, 128
// or 256.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_bhsd(const void* q, const void* k, const void* v,
                                    void* out, const long long* strides, int B,
                                    int H, int KV, int Sq, int Sk, int D,
                                    int causal, int window, int q_offset,
                                    int dtype, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  if (dtype == 0 && D == 64)  // qwen2-0.5b's head dim
    return launch_d<float, 64>(q, k, v, out, st, B, H, KV, Sq, Sk, causal,
                               window, q_offset, s);
  if (dtype == 0 && D == 128)  // phi4-mini-3.8b's head dim
    return launch_wide<float, 128>(q, k, v, out, st, B, H, KV, Sq, Sk, causal,
                                   window, q_offset, s);
  if (dtype == 0 && D == 256)  // recurrentgemma-9b's head dim
    return launch_wide<float, 256>(q, k, v, out, st, B, H, KV, Sq, Sk, causal,
                                   window, q_offset, s);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, out, st, B, H, KV, Sq, Sk, causal, window,
                          q_offset, s);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, out, st, B, H, KV, Sq, Sk, causal, window,
                           q_offset, s);
  if (dtype == 1 && D == 256)
    return tc::launch<256>(q, k, v, out, st, B, H, KV, Sq, Sk, causal, window,
                           q_offset, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory per CTA of the instance for head dim D and dtype (static for
// f32 at D = 64, dynamic otherwise), or -1 where none is instantiated.
extern "C" int flash_attention_smem_bytes(int D, int dtype) {
  if (dtype == 0 && D == 64) return 2 * BK * (64 + 1) * 4;
  if (dtype == 0 && D == 128) return wide_smem_bytes<128>();
  if (dtype == 0 && D == 256) return wide_smem_bytes<256>();
  if (dtype == 1 && D == 64) return tc::smem_bytes<64>();
  if (dtype == 1 && D == 128) return tc::smem_bytes<128>();
  if (dtype == 1 && D == 256) return tc::smem_bytes<256>();
  return -1;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
