// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py::
// rglru_scan_kernel (body `_kernel`).  Inputs: a, b (B, S, L) f32 and an
// optional h0 (B, L) f32.  Output: y (B, S, L) f32 with
//   y_0 = a_0 h0 + b_0,   y_t = a_t y_{t-1} + b_t,
// which is what the TPU kernel computes after folding a_0 h0 into b_0.  Any
// S: no padding is visible to the caller.
//
// Design.  The TPU kernel walks blocks of 256 steps as a sequential grid axis,
// runs a log-depth associative scan inside each block in VMEM and carries h
// in scratch.  On this card the recurrence has no reuse to exploit: every
// element of a and b is read once and every y written once.  So each thread
// owns one (row, channel) and walks S sequentially with h in a register;
// a warp covers 32 neighbouring channels, so every load and store of a time
// step is one coalesced 128-byte line.  One warp per CTA spreads a row of
// L = 4096 channels over 128 CTAs, about one per SM at B = 1.  The recurrence
// itself is one FMA per step, so the thread's time is the memory latency:
// the loads of the next U steps are started before the current U steps are
// computed (double-buffered registers), which keeps 2U steps of a and b in
// flight per thread and overlaps their latencies.  Loads and stores stream
// (evict-first): nothing is read twice.
//
// Occupancy limit.  There is one thread per (row, channel): 4096 threads at
// B = 1, L = 4096, one warp on each of 128 SMs.  That cannot fill the card's
// memory pipeline, so the kernel sits above its bound until S is split across
// CTAs (a per-chunk scan, then a carry fix-up pass), which is later work.
//
// Bound.  Bytes: a and b read once and y written once, 12 B S L bytes over
// 3.35 TB/s on an H100 SXM (0.0075 ms at B=1, S=512, L=4096).  The FMAs
// (2 B S L operations) are negligible.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;   // channels per CTA: one warp
constexpr int U = 16;         // steps per register group

__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ y, int S, int L) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  const long long row = blockIdx.y;
  const float* ap = a + row * S * L + l;
  const float* bp = b + row * S * L + l;
  float* yp = y + row * S * L + l;
  float h = h0 ? h0[row * L + l] : 0.f;

  float ca[U], cb[U], na[U], nb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    ca[u] = u < S ? __ldcs(ap + (long long)u * L) : 0.f;
    cb[u] = u < S ? __ldcs(bp + (long long)u * L) : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += U) {
    // the next group's loads go out before this group's arithmetic
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + U + u;
      na[u] = t < S ? __ldcs(ap + (long long)t * L) : 0.f;
      nb[u] = t < S ? __ldcs(bp + (long long)t * L) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        h = fmaf(ca[u], h, cb[u]);
        __stcs(yp + (long long)t * L, h);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
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
  const dim3 grid((L + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y), S, L);
  return (int)cudaGetLastError();
}

extern "C" const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
