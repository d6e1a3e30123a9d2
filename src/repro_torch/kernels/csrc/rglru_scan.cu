// RG-LRU linear recurrence for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (`rglru_scan`, body `_kernel`): h_t = exp(log_a_t) * h_{t-1} + b_t along
// S for [B, S, W] inputs, h_0 = 0, width lanes independent.
//
// What bounds it on the H100: bytes. Each element is read twice (log_a, b)
// and written once, 12 bytes for three flops, so the floor is 12*B*S*W bytes
// over the memory rate.
//
// Design: one thread per (batch, width lane) keeps its state in a register
// and walks S; the TPU's sequential time-block axis becomes that loop.
// Neighbouring threads take neighbouring W, so every load and store of a
// warp is one coalesced 128-byte line. The loop loads 16 steps of log_a and
// b before it computes them, so each thread keeps 32 loads in flight; with
// only B*W threads (4096 at B = 1) that in-flight depth, not the memory
// rate, is what limits it. A chunked two-pass scan that also splits S is
// later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int W, long lanes) {
  const long lane = (long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const long base = (lane / W) * (long)S * W + lane % W;
  float state = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float la[kUnroll], bb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long off = base + (long)(t + u) * W;
      la[u] = log_a[off];
      bb[u] = b[off];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = expf(la[u]) * state + bb[u];
      h[base + (long)(t + u) * W] = state;
    }
  }
  for (; t < S; ++t) {
    const long off = base + (long)t * W;
    state = expf(log_a[off]) * state + b[off];
    h[off] = state;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rglru_scan(const void* log_a, const void* b, void* h,
                                int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long lanes = (long)B * W;
  const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W, lanes);
  return (int)cudaGetLastError();
}
