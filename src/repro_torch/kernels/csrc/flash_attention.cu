// Forward flash attention for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`): attention with an online softmax over
// kv tiles, fp32 running max / sum / accumulator, scale hd**-0.5, optional
// softcap*tanh(s/softcap), GQA/MQA (kv head = h // (nq/nkv)) and the
// position-based mask (kv_pos < 0 empty; causal q_pos - kv_pos >= 0; window
// rel < window). Output in q's dtype.
//
// What bounds it on the H100: at prefill (Sq in the thousands, Skv 2048,
// hd 256) the work is 4*Sq*Skv*hd*nq operations, so the kernel is bound by
// arithmetic; at decode (Sq = 1) it is bound by the bytes of the K/V cache.
//
// Design: one block of 4 warps per (batch, q head, q tile); the TPU's
// sequential kv grid axis becomes a loop inside the block. Tiles of 32 keys
// are copied to shared memory in their input type with cp.async, two stages
// deep, so the next tile is in flight while the current one is computed;
// rows past Skv are zero-filled by the copy itself. Two paths share that
// pipeline:
//
// * bf16 with 64 query rows or more (prefill): tensor cores. Each warp owns
//   16 query rows; mma.sync m16n8k16 (bf16 in, fp32 accumulate) computes
//   the 16 x 32 score tile from ldmatrix fragments of the query and key
//   tiles, the online softmax runs on the accumulator fragments (row max
//   and sum over the 4 threads of a row group), and the probabilities,
//   rounded to bf16, are used in registers as the A operand of P.V, with V
//   fragments from transposing ldmatrix. Tiles are bf16 with rows padded by
//   16 bytes so every ldmatrix phase hits 32 distinct banks.
// * fp32, and bf16 with fewer rows (decode): CUDA cores. Each lane owns
//   one key of the tile and computes its dot product with R query rows
//   (query rows fp32 in shared memory, read as float4 broadcasts; key rows
//   padded by 16 bytes so the 16-byte loads of a quarter warp hit 32
//   distinct banks); the softmax reduces across the warp with shuffles; in
//   P.V each lane owns hd/32 output dimensions of the warp's R rows, kept
//   in registers. R = 8 rows per warp for long query blocks, R = 1 for short
//   ones, so a one-row decode query does not pay for 32. A decode call has
//   only B x nq blocks, each with one busy warp: a split of the kv range
//   across blocks is later work, as are wgmma and TMA.
//
// Shared memory exceeds 48 KB at hd >= 128, so every launch raises the
// dynamic shared-memory limit first, and the launch error is returned.
//
// Masked scores are the finite value -1e30 and the running max starts
// there, exactly as in the Pallas kernel: a query row with no valid slot
// then averages V uniformly over the Skv real slots (slots past Skv get
// -inf and weigh nothing).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 32;  // one key per lane in the score phase
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte chunk (4 fp32 or 8 bf16 values) as floats; p is 16-byte aligned.
__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// 16-byte asynchronous copy to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory layout: the query tile in fp32, two stages of K and V tiles
// in the input type (K rows padded by 16 bytes), and one [R][kBlockK]
// probability tile per warp. Every part starts 16-byte aligned.
template <typename T, int HD, int R>
struct Tile {
  static constexpr int kEPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  static constexpr int kCPR = HD / kEPC;            // chunks per row
  static constexpr int kQStride = HD + 4;           // floats
  static constexpr int kKStride = HD + kEPC;        // elements of T
  static constexpr int kVStride = HD;               // elements of T
  static constexpr int kBlockQ = kWarps * R;
  static constexpr size_t kQBytes = sizeof(float) * kBlockQ * kQStride;
  static constexpr size_t kKBytes = sizeof(T) * kBlockK * kKStride;  // one stage
  static constexpr size_t kVBytes = sizeof(T) * kBlockK * kVStride;  // one stage
  static constexpr size_t kPBytes = sizeof(float) * kWarps * R * kBlockK;
  static constexpr size_t kBytes = kQBytes + 2 * (kKBytes + kVBytes) + kPBytes;
};

// Start copying kv tile [t0, t0 + kBlockK) into one stage (rows KSTR and
// VSTR elements apart), and commit it; rows past Skv are zero-filled.
template <typename T, int HD, int KSTR, int VSTR>
__device__ __forceinline__ void issue_tile(T* kd, T* vd, const T* kb, const T* vb,
                                           int t0, int Skv, long kv_step, int tid) {
  constexpr int kEPC = 16 / (int)sizeof(T);
  constexpr int kCPR = HD / kEPC;
  constexpr int kChunks = kBlockK * kCPR;
#pragma unroll
  for (int j = 0; j < (kChunks + kThreads - 1) / kThreads; ++j) {
    const int i = j * kThreads + tid;
    if (kChunks % kThreads == 0 || i < kChunks) {
      const int c = i / kCPR, e = (i % kCPR) * kEPC, t = t0 + c;
      const bool in = t < Skv;
      const long off = (in ? (long)t * kv_step : 0) + e;
      cp_async16(kd + c * KSTR + e, kb + off, in);
      cp_async16(vd + c * VSTR + e, vb + off, in);
    }
  }
  cp_async_commit();
}

template <typename T, int HD, int R>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, T* __restrict__ out, int Sq,
                 int Skv, int nq, int nkv, int causal, int window,
                 float softcap, float scale) {
  using L = Tile<T, HD, R>;
  constexpr int QS = L::kQStride;
  constexpr int KS = L::kKStride;
  constexpr int VS = L::kVStride;
  constexpr int BQ = L::kBlockQ;
  constexpr int EPC = L::kEPC;
  constexpr int CPR = L::kCPR;
  constexpr int DJ = HD / 32;  // output dims per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + L::kQBytes);
  T* Vs = reinterpret_cast<T*>(smem + L::kQBytes + 2 * L::kKBytes);
  float* Ps = reinterpret_cast<float*>(smem + L::kQBytes + 2 * (L::kKBytes + L::kVBytes));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (nq / nkv);
  const long q_step = (long)nq * HD;    // between consecutive query positions
  const long kv_step = (long)nkv * HD;  // between consecutive kv slots
  const T* qb = q + ((long)b * Sq * nq + h) * HD;
  const T* kb = k + ((long)b * Skv * nkv + kh) * HD;
  const T* vb = v + ((long)b * Skv * nkv + kh) * HD;
  const int n_tiles = (Skv + kBlockK - 1) / kBlockK;

  issue_tile<T, HD, KS, VS>(Ks, Vs, kb, vb, 0, Skv, kv_step, tid);

  // Query tile, scaled, in fp32; rows past Sq are zeros.
  constexpr int kQChunks = BQ * CPR;
#pragma unroll
  for (int j = 0; j < (kQChunks + kThreads - 1) / kThreads; ++j) {
    const int i = j * kThreads + tid;
    if (kQChunks % kThreads == 0 || i < kQChunks) {
      const int r = i / CPR, e = (i % CPR) * EPC, s = q0 + r;
      float f[EPC];
      if (s < Sq) {
        load_chunk(qb + s * q_step + e, f);
      } else {
#pragma unroll
        for (int u = 0; u < EPC; ++u) f[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < EPC; u += 4)
        *reinterpret_cast<float4*>(Qs + r * QS + e + u) =
            make_float4(f[u] * scale, f[u + 1] * scale, f[u + 2] * scale, f[u + 3] * scale);
    }
  }

  const int row0 = warp * R;
  const bool active = q0 + row0 < Sq;  // warp-uniform
  int qp[R];
  float m[R], l[R], acc[R][DJ];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = q0 + row0 + r;
    qp[r] = s < Sq ? q_pos[(long)b * Sq + s] : -(1 << 30);
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  }
  float* Pw = Ps + warp * R * kBlockK;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles)
      issue_tile<T, HD, KS, VS>(Ks + (st ^ 1) * kBlockK * KS, Vs + (st ^ 1) * kBlockK * VS,
                           kb, vb, (it + 1) * kBlockK, Skv, kv_step, tid);
    else
      cp_async_commit();  // an empty group keeps "all but the newest" meaning tile `it`
    cp_async_wait_one();
    __syncthreads();  // tile `it` (and the query tile) visible to every warp
    if (active) {
      const T* Kt = Ks + st * kBlockK * KS;
      const T* Vt = Vs + st * kBlockK * VS;

      // Score phase: lane owns key it * kBlockK + lane.
      const int t = it * kBlockK + lane;
      const bool in_range = t < Skv;
      const int kp = in_range ? kv_pos[(long)b * Skv + t] : -1;
      float sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = 0.f;
      const T* krow = Kt + lane * KS;
#pragma unroll 2
      for (int d = 0; d < HD; d += EPC) {
        float kf[EPC];
        load_chunk(krow + d, kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int u = 0; u < EPC; u += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(Qs + (row0 + r) * QS + d + u);
            sc[r] += qq.x * kf[u] + qq.y * kf[u + 1] + qq.z * kf[u + 2] + qq.w * kf[u + 3];
          }
        }
      }

      // Online softmax over this tile.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = sc[r];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        bool valid = kp >= 0;
        if (causal) {
          const int rel = qp[r] - kp;
          valid = valid && rel >= 0;
          if (window > 0) valid = valid && rel < window;
        }
        s = valid ? s : kNeg;
        if (!in_range) s = -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(s));
        const float p = expf(s - m_new);
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] *= alpha;
        Pw[r * kBlockK + lane] = p;
      }
      __syncwarp();

      // P.V phase: lane owns dims lane + 32 * j.
#pragma unroll 4
      for (int c = 0; c < kBlockK; ++c) {
        float p[R];
#pragma unroll
        for (int r = 0; r < R; ++r) p[r] = Pw[r * kBlockK + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float vv = to_float(Vt[c * VS + lane + 32 * j]);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][j] += p[r] * vv;
        }
      }
      __syncwarp();
    }
    __syncthreads();  // stage `st` is refilled by the next iteration's copy
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = q0 + row0 + r;
    if (s < Sq) {
      const float denom = fmaxf(l[r], 1e-30f);
      T* orow = out + ((long)b * Sq + s) * q_step + (long)h * HD;
#pragma unroll
      for (int j = 0; j < DJ; ++j) orow[lane + 32 * j] = from_float<T>(acc[r][j] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 inputs, query blocks of 64 rows and more.
// ---------------------------------------------------------------------------
constexpr int kMmaRows = 16;                   // query rows per warp (mma M)
constexpr int kMmaBlockQ = kWarps * kMmaRows;  // 64

// bf16 tiles with rows padded by 16 bytes, so the eight 16-byte rows an
// ldmatrix phase reads fall in 32 distinct banks.
template <int HD>
struct MmaTile {
  static constexpr int kStride = HD + 8;  // bf16 elements
  static constexpr size_t kQBytes = 2 * (size_t)kMmaBlockQ * kStride;
  static constexpr size_t kKVBytes = 2 * (size_t)kBlockK * kStride;  // K or V, one stage
  static constexpr size_t kBytes = kQBytes + 4 * kKVBytes;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Same contract as flash_fwd_kernel. Each warp owns 16 query rows; with
// g = lane / 4 and c = lane % 4 a thread holds rows g and g + 8 of the
// warp's score tile (keys 8 n + 2 c and + 1 of n-tile n) and the same
// rows of the output (dims 8 n + 2 c and + 1). The score fragments become
// the A operand of P.V in registers.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos,
                     __nv_bfloat16* __restrict__ out, int Sq, int Skv, int nq,
                     int nkv, int causal, int window, float softcap,
                     float scale) {
  using L = MmaTile<HD>;
  constexpr int S = L::kStride;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int NT = HD / 8;   // output n-tiles of 8 dims
  constexpr int KSTEPS = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes + 2 * L::kKVBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int q0 = blockIdx.x * kMmaBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (nq / nkv);
  const long q_step = (long)nq * HD;
  const long kv_step = (long)nkv * HD;
  const __nv_bfloat16* qb = q + ((long)b * Sq * nq + h) * HD;
  const __nv_bfloat16* kb = k + ((long)b * Skv * nkv + kh) * HD;
  const __nv_bfloat16* vb = v + ((long)b * Skv * nkv + kh) * HD;
  const int n_tiles = (Skv + kBlockK - 1) / kBlockK;

  // The query tile joins the first kv tile's copy group; rows past Sq are zeros.
  constexpr int kQChunks = kMmaBlockQ * CPR;
#pragma unroll
  for (int j = 0; j < (kQChunks + kThreads - 1) / kThreads; ++j) {
    const int i = j * kThreads + tid;
    if (kQChunks % kThreads == 0 || i < kQChunks) {
      const int r = i / CPR, e = (i % CPR) * 8, s = q0 + r;
      const bool in = s < Sq;
      cp_async16(Qs + r * S + e, qb + (in ? s * q_step : 0) + e, in);
    }
  }
  issue_tile<__nv_bfloat16, HD, S, S>(Ks, Vs, kb, vb, 0, Skv, kv_step, tid);

  const int row0 = q0 + warp * kMmaRows + g;  // rows row0 and row0 + 8
  const bool active = q0 + warp * kMmaRows < Sq;
  const int qp0 = row0 < Sq ? q_pos[(long)b * Sq + row0] : -(1 << 30);
  const int qp1 = row0 + 8 < Sq ? q_pos[(long)b * Sq + row0 + 8] : -(1 << 30);
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's share
  const __nv_bfloat16* Qw = Qs + warp * kMmaRows * S;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles)
      issue_tile<__nv_bfloat16, HD, S, S>(Ks + (st ^ 1) * kBlockK * S, Vs + (st ^ 1) * kBlockK * S,
                                          kb, vb, (it + 1) * kBlockK, Skv, kv_step, tid);
    else
      cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (active) {
      const __nv_bfloat16* Kt = Ks + st * kBlockK * S;
      const __nv_bfloat16* Vt = Vs + st * kBlockK * S;

      // Scores: 16 rows x 32 keys, four n-tiles of 8 keys.
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        unsigned a[4];
        ldsm_x4(Qw + (lane & 15) * S + ks * 16 + (lane >> 4) * 8, a);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bk[4];
          ldsm_x4(Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + ks * 16 +
                      ((lane >> 3) & 1) * 8,
                  bk);
          mma_bf16(sc[2 * np], a, bk[0], bk[1]);
          mma_bf16(sc[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // Scale, cap and mask; online softmax per row.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = it * kBlockK + n * 8 + 2 * c4 + e;
          const bool in_range = t < Skv;
          const int kp = in_range ? kv_pos[(long)b * Skv + t] : -1;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float s = sc[n][2 * half + e] * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            bool valid = kp >= 0;
            if (causal) {
              const int rel = (half ? qp1 : qp0) - kp;
              valid = valid && rel >= 0;
              if (window > 0) valid = valid && rel < window;
            }
            s = valid ? s : kNeg;
            if (!in_range) s = -INFINITY;
            sc[n][2 * half + e] = s;
          }
          mx0 = fmaxf(mx0, sc[n][e]);
          mx1 = fmaxf(mx1, sc[n][2 + e]);
        }
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sc[n][0] = expf(sc[n][0] - mn0);
        sc[n][1] = expf(sc[n][1] - mn0);
        sc[n][2] = expf(sc[n][2] - mn1);
        sc[n][3] = expf(sc[n][3] - mn1);
        ls0 += sc[n][0] + sc[n][1];
        ls1 += sc[n][2] + sc[n][3];
      }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }

      // O += P V: P (16 x 32) in two k-steps of 16 keys, straight from the
      // score fragments; V fragments by transposing ldmatrix.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                                pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                                pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                                pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bv[4];
          ldsm_x4_trans(Vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + np * 16 +
                            (lane >> 4) * 8,
                        bv);
          mma_bf16(o[2 * np], pa, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // stage `st` is refilled by the next iteration's copy
  }

  if (!active) return;
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row0 + 8 * half;
    if (s < Sq) {
      const float dn = half ? d1 : d0;
      __nv_bfloat16* orow = out + ((long)b * Sq + s) * q_step + (long)h * HD + 2 * c4;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<unsigned*>(orow + 8 * n) =
            pack_bf16(o[n][2 * half] / dn, o[n][2 * half + 1] / dn);
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* q_pos, const int* kv_pos, void* out, int B,
                       int Sq, int Skv, int nq, int nkv, int causal, int window,
                       float softcap, cudaStream_t stream) {
  using L = MmaTile<HD>;
  auto kern = flash_fwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kMmaBlockQ - 1) / kMmaBlockQ, nq, B);
  kern<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, kv_pos,
      static_cast<__nv_bfloat16*>(out), Sq, Skv, nq, nkv, causal, window, softcap,
      (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

template <typename T, int HD, int R>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int Sq, int Skv, int nq, int nkv, int causal, int window,
                   float softcap, cudaStream_t stream) {
  using L = Tile<T, HD, R>;
  auto kern = flash_fwd_kernel<T, HD, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + L::kBlockQ - 1) / L::kBlockQ, nq, B);
  kern<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), Sq, Skv,
      nq, nkv, causal, window, softcap, (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out, int B,
                        int Sq, int Skv, int nq, int nkv, int causal,
                        int window, float softcap, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (Sq >= kMmaBlockQ)
      return launch_mma<HD>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, nq, nkv,
                            causal, window, softcap, stream);
  }
  if (Sq >= kWarps * 8)
    return launch<T, HD, 8>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, nq, nkv,
                            causal, window, softcap, stream);
  return launch<T, HD, 1>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, nq, nkv,
                          causal, window, softcap, stream);
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const int* q_pos, const int* kv_pos, void* out, int B,
                      int Sq, int Skv, int nq, int nkv, int causal, int window,
                      float softcap, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_rows<T, 32>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, nq,
                                nkv, causal, window, softcap, stream);
    case 64:
      return launch_rows<T, 64>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, nq,
                                nkv, causal, window, softcap, stream);
    case 128:
      return launch_rows<T, 128>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, nq,
                                 nkv, causal, window, softcap, stream);
    case 256:
      return launch_rows<T, 256>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, nq,
                                 nkv, causal, window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means none, softcap <= 0
// means none. q, k, v and out must be 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* q_pos,
                                         const void* kv_pos, void* out,
                                         int dtype, int B, int Sq, int Skv,
                                         int nq, int nkv, int hd, int causal,
                                         int window, float softcap,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || nkv <= 0 || nq % nkv != 0)
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, q, k, v, qp, kp, out, B, Sq, Skv, nq, nkv,
                                 causal, window, softcap, s);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, qp, kp, out, B, Sq, Skv,
                                         nq, nkv, causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
