// RG-LRU linear recurrence for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (`rglru_scan`, body `_kernel`): h_t = exp(log_a_t) * h_{t-1} + b_t along
// S for [B, S, W] inputs, width lanes independent. h_0 is zero, as in the
// Pallas kernel, or the caller's incoming state [B, W], which the Pallas
// path folds in outside the kernel with a cumsum.
//
// What bounds it on the H100: bytes. The least the card must move is each
// element of log_a and b read once and of h written once, 12 bytes for
// three flops, so the floor is 12*B*S*W bytes over the memory rate. A scan
// that keeps one thread per width lane has only B*W threads (4096 at
// B = 1), too few loads in flight to reach that rate.
//
// Design: S is cut into chunks, so that B*W*chunks threads fill the card.
// Three launches on one stream:
//   1. chunk_summary: each (batch, chunk, lane) runs the recurrence over its
//      chunk from zero and keeps two numbers: the chunk's decay (the product
//      of exp(log_a_t)) and its final state. Reads log_a and b, 8 bytes per
//      element; writes only the summaries.
//   2. chunk_carry: each (batch, lane) walks the chunks in order from h_0
//      and writes the state that enters each chunk.
//   3. chunk_scan: each (batch, chunk, lane) runs the recurrence over its
//      chunk again, now from the state that enters it, and writes h.
//      Reads log_a and b and writes h, 12 bytes per element.
// So 20 bytes move per element against the 12 of the floor; every h_t is
// the sequential recurrence over its own chunk from a carried state. With
// one chunk the first two launches are skipped. Neighbouring threads take
// neighbouring W, so every load and store of a warp is one coalesced line.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// Lanes of the launch: index i -> (batch, chunk, lane w).
struct Lane {
  long b, c, w;
  __device__ Lane(long i, int n_chunks, int W)
      : b(i / ((long)n_chunks * W)), c((i / W) % n_chunks), w(i % W) {}
};

__global__ void __launch_bounds__(kThreads)
chunk_summary(const float* __restrict__ log_a, const float* __restrict__ b,
              float* __restrict__ decay, float* __restrict__ last, int S, int W,
              int chunk, int n_chunks, long lanes) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= lanes) return;
  const Lane l(i, n_chunks, W);
  const int t0 = (int)l.c * chunk;
  const int n = min(chunk, S - t0);
  const long base = (l.b * S + t0) * (long)W + l.w;
  float prod = 1.f, state = 0.f;
  int t = 0;
  for (; t + kUnroll <= n; t += kUnroll) {
    float la[kUnroll], bb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      la[u] = log_a[base + (long)(t + u) * W];
      bb[u] = b[base + (long)(t + u) * W];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float a = expf(la[u]);
      prod *= a;
      state = a * state + bb[u];
    }
  }
  for (; t < n; ++t) {
    const float a = expf(log_a[base + (long)t * W]);
    prod *= a;
    state = a * state + b[base + (long)t * W];
  }
  decay[i] = prod;
  last[i] = state;
}

// carry[b, c, w]: the state entering chunk c; summaries are [B, chunks, W].
__global__ void __launch_bounds__(kThreads)
chunk_carry(const float* __restrict__ decay, const float* __restrict__ last,
            const float* __restrict__ h0, float* __restrict__ carry, int W,
            int n_chunks, long lanes) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= lanes) return;
  const long base = (i / W) * (long)n_chunks * W + i % W;
  float state = h0 ? h0[i] : 0.f;
  int c = 0;
  for (; c + kUnroll <= n_chunks; c += kUnroll) {
    float d[kUnroll], h[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      d[u] = decay[base + (long)(c + u) * W];
      h[u] = last[base + (long)(c + u) * W];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry[base + (long)(c + u) * W] = state;
      state = d[u] * state + h[u];
    }
  }
  for (; c < n_chunks; ++c) {
    carry[base + (long)c * W] = state;
    state = decay[base + (long)c * W] * state + last[base + (long)c * W];
  }
}

// start: the state entering each chunk ([B, chunks, W]), or, with one
// chunk, h0 ([B, W]) or null for zeros.
__global__ void __launch_bounds__(kThreads)
chunk_scan(const float* __restrict__ log_a, const float* __restrict__ b,
           const float* __restrict__ start, float* __restrict__ h, int S, int W,
           int chunk, int n_chunks, long lanes) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= lanes) return;
  const Lane l(i, n_chunks, W);
  const int t0 = (int)l.c * chunk;
  const int n = min(chunk, S - t0);
  const long base = (l.b * S + t0) * (long)W + l.w;
  float state = start ? start[i] : 0.f;
  int t = 0;
  for (; t + kUnroll <= n; t += kUnroll) {
    float la[kUnroll], bb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      la[u] = log_a[base + (long)(t + u) * W];
      bb[u] = b[base + (long)(t + u) * W];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = expf(la[u]) * state + bb[u];
      h[base + (long)(t + u) * W] = state;
    }
  }
  for (; t < n; ++t) {
    const long off = base + (long)t * W;
    state = expf(log_a[off]) * state + b[off];
    h[off] = state;
  }
}

unsigned blocks_for(long lanes) { return (unsigned)((lanes + kThreads - 1) / kThreads); }

}  // namespace

// h0: [B, W] fp32 or null (zeros). scratch: 3 * B * n_chunks * W floats
// when n_chunks > 1 (decay, last state, carry), else unused. chunk *
// n_chunks must cover S with the last chunk non-empty. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int repro_rglru_scan(const void* log_a, const void* b, const void* h0,
                                void* h, void* scratch, int B, int S, int W,
                                int chunk, int n_chunks, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || chunk <= 0 || n_chunks <= 0 ||
      (long)chunk * (n_chunks - 1) >= S || (long)chunk * n_chunks < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* bb = static_cast<const float*>(b);
  const float* init = static_cast<const float*>(h0);
  float* out = static_cast<float*>(h);
  const long lanes = (long)B * n_chunks * W;
  if (n_chunks == 1) {
    chunk_scan<<<blocks_for(lanes), kThreads, 0, s>>>(la, bb, init, out, S, W, chunk, 1, lanes);
    return (int)cudaGetLastError();
  }
  float* decay = static_cast<float*>(scratch);
  float* last = decay + lanes;
  float* carry = last + lanes;
  chunk_summary<<<blocks_for(lanes), kThreads, 0, s>>>(la, bb, decay, last, S, W, chunk,
                                                       n_chunks, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)B * W;
  chunk_carry<<<blocks_for(rows), kThreads, 0, s>>>(decay, last, init, carry, W, n_chunks, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_scan<<<blocks_for(lanes), kThreads, 0, s>>>(la, bb, carry, out, S, W, chunk, n_chunks,
                                                    lanes);
  return (int)cudaGetLastError();
}
