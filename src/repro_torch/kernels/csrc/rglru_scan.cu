// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py::
// rglru_scan_kernel (body `_kernel`).  Inputs: a, b (B, S, L) f32 and an
// optional h0 (B, L) f32.  Output: y (B, S, L) f32 with
//   y_0 = a_0 h0 + b_0,   y_t = a_t y_{t-1} + b_t,
// which is what the TPU kernel computes after folding a_0 h0 into b_0.  Any
// S and L: no padding is visible to the caller.
//
// Bound.  Bytes: a and b read once and y written once, 12 B S L bytes over
// 3.35 TB/s on an H100 SXM (0.0075 ms at B=1, S=512, L=4096).  The FMAs
// (2 B S L operations) are negligible, so the design's one aim is to keep
// enough bytes in flight to stream at memory rate.
//
// Why S is split.  The TPU kernel walks blocks of 256 steps as a sequential
// grid axis with the carry in scratch.  On this card the channels give the
// only free parallelism, and L is fixed by the model: one thread per (row,
// channel) is 4096 threads at B = 1, L = 4096, one warp per SM.  By Little's
// law 3.35 TB/s at ~0.8 us of DRAM latency needs ~2.7 MB in flight, ~20 KB
// per SM; one warp keeping 16 steps of a and b in flight per lane holds
// 4 KB.  So S is split across the warps of a CTA, in one pass with no global
// scratch:
//
// - A CTA owns one row and 32 neighbouring channels (one per lane), so every
//   load and store of a time step is one coalesced 128-byte line.  Its WARPS
//   warps walk the sequence in super-chunks of WARPS * SEG steps; warp w
//   owns steps [w SEG, (w + 1) SEG) of each.
// - Phase 1: each lane holds its SEG steps of a and b in registers and folds
//   them from a zero state into the segment's aggregate (P = prod a,
//   Y = the segment's last h), written to shared memory.
// - Phase 2: after one __syncthreads, every warp folds all WARPS aggregates,
//   in order, onto the CTA's running carry (h0 or 0 at the start), taking
//   its own incoming state when it reaches its segment; the full fold is the
//   next super-chunk's carry.  Every warp does the same FMAs in the same
//   order, so the carries agree bit for bit.  The aggregates are
//   double-buffered by super-chunk parity, so one barrier per super-chunk
//   suffices: a warp can overwrite a buffer only after the next barrier,
//   which every warp reaches after reading it.
// - Phase 3: each lane re-walks its SEG registers from its true incoming
//   state, h = fma(a, h, b), and streams y out.
// - The next super-chunk's loads are issued before this one's phases, into
//   a second set of registers: 4 SEG = 64 data registers a thread.
//
// Geometry: 16 warps of 16 steps, super-chunks of 256 steps.  In flight per
// SM: 512 threads x 32 floats x 4 B = 64 KB from the prefetch alone, about
// 3x what Little's law asks.  At 114 registers a thread (ptxas, no spills)
// the CTA of 512 threads takes 58 K of the SM's 65,536 registers: one CTA
// per SM, 128 CTAs on 132 SMs at B = 1.  On the H100 it was 2-9% faster
// than 8 warps of 32 steps (180 registers) at every measured shape, and
// level with 8 warps of 16 steps (112 registers) except at S = 512 (6%
// faster) and S = 37 (10% slower; PERF.md, the RG-LRU findings).
//
// Steps past S are the identity (a = 1, b = 0) in the aggregates and are
// not stored; a segment wholly past S skips its loads and both walks; lanes
// past L load and store nothing but keep to the barriers.
//
// Sum order: segment aggregates from zero, a sequential fold of the
// aggregates, then a sequential re-walk from the true carry -- between the
// plain version's two-level block scan and a fully sequential walk, equal
// to either up to rounding.  kernels/ref.py::ref_rglru_segmented repeats it
// in plain PyTorch.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;                 // channels per CTA: one per lane
constexpr int WARPS = 16;                 // segments per super-chunk
constexpr int SEG = 16;                   // steps per segment (and per warp)
constexpr int SUPER = WARPS * SEG;        // steps per super-chunk
constexpr int THREADS = WARPS * LANES;
// (P, Y) per (parity, warp, lane); kernels/rglru_scan.py::smem_blocks
constexpr int SMEM_BYTES = 2 * WARPS * LANES * 2 * (int)sizeof(float);

// SEG steps from t0 for one lane: the identity past S or past L.  A segment
// wholly past S (t0 is the same for the whole warp) issues no instruction
// per step, so idle warps of a short sequence cost next to nothing.
__device__ __forceinline__ void load_segment(const float* ap, const float* bp, int t0,
                                             int S, int L, bool live, float (&ra)[SEG],
                                             float (&rb)[SEG]) {
  if (t0 >= S) {
#pragma unroll
    for (int u = 0; u < SEG; ++u) {
      ra[u] = 1.f;
      rb[u] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < SEG; ++u) {
    const int t = t0 + u;
    const bool in = live && t < S;
    ra[u] = in ? __ldcs(ap + (long long)t * L) : 1.f;
    rb[u] = in ? __ldcs(bp + (long long)t * L) : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 1) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ y, int S, int L) {
  __shared__ float2 agg[2][WARPS][LANES];
  const int lane = threadIdx.x % LANES;
  const int warp = threadIdx.x / LANES;
  const int l = blockIdx.x * LANES + lane;
  const bool live = l < L;
  const long long row = blockIdx.y;
  const long long base = row * S * L + l;
  const float* ap = a + base;
  const float* bp = b + base;
  float* yp = y + base;
  float carry = (h0 != nullptr && live) ? h0[row * L + l] : 0.f;

  float ca[SEG], cb[SEG], na[SEG], nb[SEG];
  load_segment(ap, bp, warp * SEG, S, L, live, ca, cb);
  for (int k = 0, t0 = warp * SEG; k * SUPER < S; ++k, t0 += SUPER) {
    // the next super-chunk's loads go out before this one's arithmetic
    // (past S they are the identity and touch no memory)
    load_segment(ap, bp, t0 + SUPER, S, L, live, na, nb);

    // phase 1: the segment's aggregate from a zero state (the identity for
    // a segment wholly past S)
    const bool busy = t0 < S;
    float p = 1.f, h = 0.f;
    if (busy) {
      p = ca[0];
      h = cb[0];
#pragma unroll
      for (int u = 1; u < SEG; ++u) {
        h = fmaf(ca[u], h, cb[u]);
        p *= ca[u];
      }
    }
    agg[k & 1][warp][lane] = make_float2(p, h);
    __syncthreads();

    // phase 2: fold the super-chunk's aggregates onto the carry in order
    float h_in = carry;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      if (j == warp) h_in = carry;
      const float2 g = agg[k & 1][j][lane];
      carry = fmaf(g.x, carry, g.y);
    }

    // phase 3: re-walk the segment from its true incoming state
    if (busy) {
      h = h_in;
#pragma unroll
      for (int u = 0; u < SEG; ++u) {
        const int t = t0 + u;
        h = fmaf(ca[u], h, cb[u]);
        if (live && t < S) __stcs(yp + (long long)t * L, h);
      }
    }
#pragma unroll
    for (int u = 0; u < SEG; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

}  // namespace

// a, b, y (B, S, L) f32 contiguous; h0 (B, L) f32 contiguous or null.
// Returns the cudaError_t of the launch.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0, void* y,
                          int B, int S, int L, void* stream) {
  if (B == 0 || S == 0 || L == 0) return 0;
  if (B < 0 || S < 0 || L < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + LANES - 1) / LANES, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y), S, L);
  return (int)cudaGetLastError();
}

// Static shared memory per CTA.
extern "C" int rglru_scan_smem_bytes() { return SMEM_BYTES; }

extern "C" const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
