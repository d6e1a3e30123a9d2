// Forward flash attention for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`): attention with an online softmax over
// kv tiles, fp32 running max / sum / accumulator, scale hd**-0.5, optional
// softcap*tanh(s/softcap), GQA/MQA (kv head = h // (nq/nkv)) and the
// position-based mask (kv_pos < 0 empty; causal q_pos - kv_pos >= 0; window
// rel < window). Output in q's dtype.
//
// Masked scores are the finite value -1e30 and the running max starts
// there, exactly as in the Pallas kernel, so a query row with no valid slot
// averages V uniformly over the Skv real slots (slots past Skv get -inf and
// weigh nothing). Which of three paths runs is decided by dtype and shape:
//
// * Decode, Sq < 64 (fp32 and bf16): bound by the bytes of the K/V cache,
//   so by how many of them are in flight: the card's 3.35 TB/s at a
//   memory latency near a microsecond needs tens of KB in flight on every
//   SM. A block takes one (batch, kv head, kv split): its rows are the g =
//   nq/nkv query heads of the kv group times the Sq positions (16 rows per
//   block in bf16, one mma.sync m16n8k16 M tile, padding rows where g = 1
//   cost no bytes; 8 in fp32, on CUDA cores), so each K/V byte is read once
//   per batch. The kv range's 64-key tiles are dealt evenly to as many
//   splits as keep every block of the grid resident at once (the wrapper's
//   plan, from the card's occupancy of this kernel). In bf16 each of the
//   block's 4 warps walks its own K/V subtiles of the split with its own
//   online softmax, through a ring of cp.async stages (K, V and the keys'
//   positions in one group; rows unpadded, 16-byte chunks XOR-swizzled for
//   ldmatrix), DecodeRing's subtiles deep: at hd 64, subtiles of 64 keys
//   (16 KB) three deep, so 128 KB are in flight on an SM that holds one
//   block (measured against 1- and 2-warp blocks of more splits and
//   against 16- and 32-key subtiles on the H100: faster); at hd 256, 16
//   keys (16 KB) two deep. The block merges its warps and writes the
//   split's partial (max, sum, accumulator) in fp32 to scratch, and a
//   second kernel merges the splits by the log-sum-exp rule; a plan of one
//   split writes the output from the first kernel, one launch.
// * Prefill in bf16, Sq >= 64, hd 64/128/256: bound by tensor-core
//   operations. Warp-specialised: two consumer warpgroups of 64 query rows
//   each run wgmma (bf16 in, fp32 accumulate) for S = Q.K^T from shared
//   memory, the online softmax on the accumulator fragments, and P.V with P
//   in registers as operand A; a producer warp keeps a ring of K/V tiles in
//   flight with TMA (128-byte swizzle) and mbarriers, and reuses a K stage
//   as soon as its scores are used, a V stage once P.V is done. Each block
//   first lists the kv tiles whose mask is not empty for its rows, from its
//   own q_pos range and each tile's kv_pos range (a conservative test, as
//   positions are arbitrary ring-buffer slots; only 41% of recurrentgemma's
//   2500 x 2048 serving rectangle is valid), and runs only those. A skipped
//   tile adds exactly 0 to every row that has a valid key; a row that has
//   none anywhere takes the mean of V over the Skv slots, which a small
//   kernel computes first. Two launches per call. Two designs:
//   - hd 128/256 (tiles of 64 keys): registers bound it (the O accumulator
//     alone is 128 a thread at hd 256, moved from the producer with
//     setmaxnreg), so each warpgroup runs its scores, softmax and P.V in
//     turn, masking every live tile, and the two warpgroups overlap each
//     other. Each block reads the positions of every kv tile to list them.
//   - hd 64: the products are a quarter of hd 256's per score while the
//     softmax (exponentials, the mask) is not, so the softmax would starve
//     the tensor cores. Tiles of 128 keys (S is m64n128k16, 64 registers; O
//     32): each warpgroup issues the scores of tile i + 1 before the P.V of
//     tile i, and computes the softmax of tile i + 1 while the tensor cores
//     run that P.V; the two warpgroups issue their products in turns (named
//     barriers), so one's softmax runs while the other's products do.
//     Scores stay in the log2 domain (scale x log2(e) folded into one FMA
//     before exp2). The first kernel sums V over 8 key ranges (on 8x the
//     blocks; a row with no valid slot adds the 8 partial means in order)
//     and writes, per 64 kv slots, a summary of their positions (lowest,
//     highest, every slot held), so a block classifies its tiles
//     (`tile_class`) from Skv / 64 summaries, not Skv positions: dead
//     (skipped), full (every (row, key) pair valid: only scaled) or partial
//     (masked from its keys' positions, which a producer warp stages in
//     shared memory). Tiles of 192 keys measured slower. A causal prefix prompt masks
//     only the diagonal tile of each block. A head's blocks are issued
//     together, longest first (measured faster than longest first over
//     every head).
// * Everything else (fp32 with Sq >= 64; bf16 at hd 32): CUDA cores, one
//   block of 4 warps per (batch, q head, 32 query rows), kv tiles of 32
//   keys copied with cp.async two stages deep; each lane owns one key in
//   the score phase and hd/32 output dims in P.V. One launch per call. fp32
//   stays off the tensor cores: its 1e-5 contract cannot afford a bf16 P.
//
// Shared memory exceeds 48 KB at hd >= 128, so every launch raises the
// dynamic shared-memory limit first, and the launch error is returned.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 32;  // one key per lane in the CUDA-core score phase
constexpr float kNeg = -1e30f;
constexpr int kDecodeMaxSq = 64;  // shorter query blocks take the decode path

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; valid = false writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
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

// Max and sum over the 4 threads of an mma row group (lanes 4g .. 4g+3).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The score of one (query, key) pair after softcap and mask: s is already
// scaled; kp is the key's kv_pos; a key outside the range the caller walks
// (past Skv, or in another split) gets -inf.
__device__ __forceinline__ float masked_score(float s, int qp, int kp, bool in_range,
                                              int causal, int window, float softcap) {
  if (softcap > 0.f) s = softcap * tanhf(s / softcap);
  bool valid = kp >= 0;
  if (causal) {
    const int rel = qp - kp;
    valid = valid && rel >= 0;
    if (window > 0) valid = valid && rel < window;
  }
  s = valid ? s : kNeg;
  return in_range ? s : -INFINITY;
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

// ---------------------------------------------------------------------------
// CUDA-core path: fp32 with Sq >= 64, and bf16 at hd 32.
// ---------------------------------------------------------------------------
constexpr int kRows = 8;  // query rows per warp

// Shared-memory layout: the query tile in fp32, two stages of K and V tiles
// in the input type (K rows padded by 16 bytes), and one [kRows][kBlockK]
// probability tile per warp. Every part starts 16-byte aligned.
template <typename T, int HD>
struct Tile {
  static constexpr int kEPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  static constexpr int kCPR = HD / kEPC;            // chunks per row
  static constexpr int kQStride = HD + 4;           // floats
  static constexpr int kKStride = HD + kEPC;        // elements of T
  static constexpr int kVStride = HD;               // elements of T
  static constexpr int kBlockQ = kWarps * kRows;
  static constexpr size_t kQBytes = sizeof(float) * kBlockQ * kQStride;
  static constexpr size_t kKBytes = sizeof(T) * kBlockK * kKStride;  // one stage
  static constexpr size_t kVBytes = sizeof(T) * kBlockK * kVStride;  // one stage
  static constexpr size_t kPBytes = sizeof(float) * kWarps * kRows * kBlockK;
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, T* __restrict__ out, int Sq,
                 int Skv, int nq, int nkv, int causal, int window,
                 float softcap, float scale) {
  using L = Tile<T, HD>;
  constexpr int R = kRows;
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
        const float s = masked_score(sc[r], qp[r], kp, in_range, causal, window, softcap);
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
// Decode path: Sq < 64, split-KV, the kv group's query heads packed as rows.
// ---------------------------------------------------------------------------
constexpr int kSplitKeys = 64;  // a split covers whole tiles of this many keys
constexpr int kMaxSplits = 256;

// bf16: the keys of one warp's K/V subtile, and the subtiles a warp keeps in
// its ring (one computed, the rest in flight), by head dim.
template <int HD>
struct DecodeRing {
  static constexpr int kKeys = HD == 64 ? 64 : 16;
  static constexpr int kStages = HD == 256 ? 2 : 3;
};

// Row r of a (batch, kv head) is query position r / g, head kh * g + r % g.
template <typename T, int HD>
struct DecodeTile {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowsPerBlock = kMma ? 16 : 8;   // one mma M tile in bf16
  static constexpr int kWarpKeys = kMma ? DecodeRing<HD>::kKeys : 32;  // a warp's keys at a time
  static constexpr int kStages = DecodeRing<HD>::kStages;
  static constexpr int kQStride = kMma ? HD + 8 : HD + 4;  // bf16 elements / floats
  static constexpr size_t kQBytes =
      (kMma ? 2 : 4) * (size_t)kRowsPerBlock * kQStride;
  // bf16, one ring stage: the K and V subtiles (swizzled, unpadded) and the
  // keys' positions
  static constexpr size_t kKVBytes = 2 * (size_t)kWarpKeys * HD;
  static constexpr size_t kStageBytes = 2 * kKVBytes + 4 * (size_t)kWarpKeys;
  // per warp: bf16 its ring; fp32 a probability tile
  static constexpr size_t kWarpBytes =
      kMma ? kStages * kStageBytes : 4 * (size_t)kRowsPerBlock * kWarpKeys;
  // the warps' partials, merged at the end: acc [warp][row][HD], (m, l)
  // [warp][row], and each row's sum
  static constexpr size_t kMergeBytes =
      4 * ((size_t)kWarps * kRowsPerBlock * (HD + 2) + kRowsPerBlock);
  static constexpr size_t kWorkBytes =
      kWarps * kWarpBytes > kMergeBytes ? kWarps * kWarpBytes : kMergeBytes;
  static constexpr size_t kBytes = kQBytes + kWorkBytes;
};

// Element offset of 16-byte chunk c of row r in a [rows][HD] bf16 subtile
// stored without padding: the chunk index is XORed with the row's low bits,
// so the 8 rows an ldmatrix phase reads fall in 8 different bank groups.
template <int HD>
__device__ __forceinline__ int swizzled(int r, int c) {
  constexpr int kMask = (HD / 8 < 8 ? HD / 8 : 8) - 1;
  return r * HD + ((c ^ (r & kMask)) << 3);
}

// 4-byte asynchronous copy to shared memory; valid = false writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a warp's kv subtile [t0, t0 + WK) (bf16 K and V, swizzled, and the
// keys' positions) into one ring stage and commit it as one group; keys at
// or past `end` are zero-filled.
template <int HD, int WK>
__device__ __forceinline__ void issue_warp_tile(unsigned char* stage, const __nv_bfloat16* kb,
                                                const __nv_bfloat16* vb, const int* pb, int t0,
                                                int end, long kv_step, int lane) {
  constexpr int kCPR = HD / 8;
  __nv_bfloat16* kd = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* vd = kd + WK * HD;
  int* pd = reinterpret_cast<int*>(vd + WK * HD);
#pragma unroll
  for (int i = lane; i < WK * kCPR; i += 32) {
    const int c = i / kCPR, e = i % kCPR, t = t0 + c;
    const bool in = t < end;
    const long off = (in ? (long)t * kv_step : 0) + e * 8;
    cp_async16(kd + swizzled<HD>(c, e), kb + off, in);
    cp_async16(vd + swizzled<HD>(c, e), vb + off, in);
  }
#pragma unroll
  for (int j = lane; j < WK; j += 32)
    cp_async4(pd + j, pb + (t0 + j < end ? t0 + j : 0), t0 + j < end);
  cp_async_commit();
}

// Grid (splits, nkv * row tiles, B). The kv range's kSplitKeys-key tiles are
// dealt to the splits evenly: split i takes tiles [i * tiles / splits,
// (i + 1) * tiles / splits). Writes, for each row of the block and this
// split, the partial (m, l) to part_ml[2 * p] and the unnormalised
// accumulator to part_acc[p * HD], p = ((b * nkv + kh) * rows + row) *
// splits + split; with one split, the normalised output to out instead.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    T* __restrict__ out, int Sq, int Skv, int nq, int nkv, int causal, int window,
                    float softcap, float scale) {
  using L = DecodeTile<T, HD>;
  constexpr int RB = L::kRowsPerBlock;
  constexpr int WK = L::kWarpKeys;
  constexpr int QS = L::kQStride;
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int CPR = HD / EPC;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* work = smem + L::kQBytes;
  float* merge_acc = reinterpret_cast<float*>(work);            // [warp][row][HD]
  float* merge_ml = merge_acc + kWarps * RB * HD;                // [warp][row][2]
  float* row_sum = merge_ml + kWarps * RB * 2;                   // [row]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = nq / nkv, rows = g * Sq, row_tiles = (rows + RB - 1) / RB;
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int kh = blockIdx.y / row_tiles, row0 = (blockIdx.y % row_tiles) * RB;
  const int b = blockIdx.z;
  const int tiles = (Skv + kSplitKeys - 1) / kSplitKeys;
  const int k0 = (int)((long)split * tiles / n_splits) * kSplitKeys;
  const int k1 = min(Skv, (int)((long)(split + 1) * tiles / n_splits) * kSplitKeys);
  const long kv_step = (long)nkv * HD;
  const T* kb = k + ((long)b * Skv * nkv + kh) * HD;
  const T* vb = v + ((long)b * Skv * nkv + kh) * HD;
  const int* pb = kv_pos + (long)b * Skv;
  auto q_row = [&](int rr) {  // the query row of block row rr < rows
    return q + (((long)b * Sq + rr / g) * nq + (long)kh * g + rr % g) * HD;
  };
  auto row_pos = [&](int rr) {
    return rr < rows ? q_pos[(long)b * Sq + rr / g] : -(1 << 30);
  };

  // Query rows of the block (rows past `rows` are zeros).
  for (int i = tid; i < RB * CPR; i += kThreads) {
    const int r = i / CPR, e = (i % CPR) * EPC, rr = row0 + r;
    if constexpr (L::kMma) {
      cp_async16(reinterpret_cast<T*>(smem) + r * QS + e, rr < rows ? q_row(rr) + e : q, rr < rows);
    } else {
      float f[EPC];
      if (rr < rows) {
        load_chunk(q_row(rr) + e, f);
      } else {
#pragma unroll
        for (int u = 0; u < EPC; ++u) f[u] = 0.f;
      }
      float* dst = reinterpret_cast<float*>(smem) + r * QS + e;
      *reinterpret_cast<float4*>(dst) =
          make_float4(f[0] * scale, f[1] * scale, f[2] * scale, f[3] * scale);
    }
  }

  if constexpr (L::kMma) {
    // bf16: each warp walks its subtiles of WK keys of the split (every
    // kWarps-th), with a ring of kStages subtiles per warp: kStages - 1 in
    // flight while it computes on one. Each subtile is one cp.async group,
    // K, V and positions together.
    constexpr int ST = L::kStages;
    constexpr int STEP = kWarps * WK;
    constexpr int NT = HD / 8;   // output n-tiles of 8 dims
    constexpr int NK = WK / 8;   // score n-tiles of 8 keys
    cp_async_commit();           // the query rows: the oldest group
    unsigned char* ring = work + warp * L::kWarpBytes;
    const int first = k0 + warp * WK;
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {
      if (first + s * STEP < k1)
        issue_warp_tile<HD, WK>(ring + s * L::kStageBytes, kb, vb, pb, first + s * STEP, k1,
                                kv_step, lane);
      else
        cp_async_commit();
    }
    cp_async_wait<ST - 1>();     // the query rows have landed
    __syncthreads();

    const __nv_bfloat16* Qs = reinterpret_cast<const __nv_bfloat16*>(smem);
    const int gq = lane >> 2, c4 = lane & 3;
    const int qp0 = row_pos(row0 + gq), qp1 = row_pos(row0 + gq + 8);
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's share

    int st = 0;
    for (int t0 = first; t0 < k1; t0 += STEP) {
      // refill the stage the previous subtile freed with the one ST - 1 ahead
      const int ahead = t0 + (ST - 1) * STEP;
      const int refill = st == 0 ? ST - 1 : st - 1;
      if (ahead < k1)
        issue_warp_tile<HD, WK>(ring + refill * L::kStageBytes, kb, vb, pb, ahead, k1, kv_step,
                                lane);
      else
        cp_async_commit();
      cp_async_wait<ST - 1>();   // this subtile has landed
      __syncwarp();
      const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(ring + st * L::kStageBytes);
      const __nv_bfloat16* Vt = Kt + WK * HD;
      const int* Pt = reinterpret_cast<const int*>(Vt + WK * HD);

      // Scores: 16 rows x WK keys, n-tiles of 8 keys.
      float sc[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        unsigned a[4];
        ldsm_x4(Qs + (lane & 15) * QS + ks * 16 + (lane >> 4) * 8, a);
#pragma unroll
        for (int j = 0; j < WK / 16; ++j) {
          unsigned bk[4];
          ldsm_x4(Kt + swizzled<HD>(16 * j + (lane & 7) + ((lane >> 4) << 3),
                                    2 * ks + ((lane >> 3) & 1)),
                  bk);
          mma_bf16(sc[2 * j], a, bk[0], bk[1]);
          mma_bf16(sc[2 * j + 1], a, bk[2], bk[3]);
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int2 kp = *reinterpret_cast<const int2*>(Pt + n * 8 + 2 * c4);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in_range = t0 + n * 8 + 2 * c4 + e < k1;
          const int kpe = e ? kp.y : kp.x;
          sc[n][e] = masked_score(sc[n][e] * scale, qp0, kpe, in_range, causal, window, softcap);
          sc[n][2 + e] =
              masked_score(sc[n][2 + e] * scale, qp1, kpe, in_range, causal, window, softcap);
          mx0 = fmaxf(mx0, sc[n][e]);
          mx1 = fmaxf(mx1, sc[n][2 + e]);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
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
      // O += P V, one k-step of 16 keys at a time.
#pragma unroll
      for (int j = 0; j < WK / 16; ++j) {
        const unsigned pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                                pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                                pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                                pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bv[4];
          ldsm_x4_trans(Vt + swizzled<HD>(16 * j + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          2 * np + (lane >> 4)),
                        bv);
          mma_bf16(o[2 * np], pa, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
      __syncwarp();  // the stage is refilled by the next subtile's copy
      st = st == ST - 1 ? 0 : st + 1;
    }
    cp_async_wait<0>();  // no copy may still write the ring: it is the merge area
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    __syncthreads();  // every warp is done with its subtiles: the merge area is free
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* a0 = merge_acc + (warp * RB + gq) * HD + n * 8 + 2 * c4;
      a0[0] = o[n][0];
      a0[1] = o[n][1];
      a0[8 * HD] = o[n][2];
      a0[8 * HD + 1] = o[n][3];
    }
    if (c4 == 0) {
      merge_ml[2 * (warp * RB + gq)] = m0;
      merge_ml[2 * (warp * RB + gq) + 1] = l0;
      merge_ml[2 * (warp * RB + gq + 8)] = m1;
      merge_ml[2 * (warp * RB + gq + 8) + 1] = l1;
    }
  } else {
    __syncthreads();  // the query rows are in
    // fp32: each warp takes subtiles of 32 keys, one key per lane, with K
    // and V read from global memory (L1 and L2 keep the rows the lanes share).
    constexpr int DJ = HD / 32;
    const float* Qs = reinterpret_cast<const float*>(smem);
    float* Pw = reinterpret_cast<float*>(work) + warp * RB * WK;
    int qp[RB];
    float m[RB], l[RB], acc[RB][DJ];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      qp[r] = row_pos(row0 + r);
      m[r] = kNeg;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
    }
    for (int t0 = k0 + warp * WK; t0 < k1; t0 += kWarps * WK) {
      const int t = t0 + lane;
      const bool in_range = t < k1;
      const int kp = in_range ? pb[t] : -1;
      float sc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) sc[r] = 0.f;
      if (in_range) {
        const T* krow = kb + (long)t * kv_step;
#pragma unroll 2
        for (int d = 0; d < HD; d += 4) {
          float kf[4];
          load_chunk(krow + d, kf);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float4 qq = *reinterpret_cast<const float4*>(Qs + r * QS + d);
            sc[r] += qq.x * kf[0] + qq.y * kf[1] + qq.z * kf[2] + qq.w * kf[3];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float s = masked_score(sc[r], qp[r], kp, in_range, causal, window, softcap);
        const float m_new = fmaxf(m[r], warp_max(s));
        const float p = expf(s - m_new);
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] *= alpha;
        Pw[r * WK + lane] = p;
      }
      __syncwarp();
      const int n = min(WK, k1 - t0);
      for (int c = 0; c < n; ++c) {
        const T* vrow = vb + (long)(t0 + c) * kv_step;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float vv = to_float(vrow[lane + 32 * j]);
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r][j] += Pw[r * WK + c] * vv;
        }
      }
      __syncwarp();
    }
    __syncthreads();  // the merge area overlaps the probability tiles
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) merge_acc[(warp * RB + r) * HD + lane + 32 * j] = acc[r][j];
      if (lane == 0) {
        merge_ml[2 * (warp * RB + r)] = m[r];
        merge_ml[2 * (warp * RB + r) + 1] = l[r];
      }
    }
  }
  __syncthreads();

  // Merge the warps' partials (a warp that saw no key has l = 0, acc = 0)
  // and write the split's partial. One thread per row turns each warp's
  // (m, l) into its weight in place.
  const long p0 = (((long)b * nkv + kh) * rows + row0) * n_splits + split;
  if (tid < RB && row0 + tid < rows) {
    float M = kNeg, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, merge_ml[2 * (w * RB + tid)]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      float* ml = merge_ml + 2 * (w * RB + tid);
      ml[0] = expf(ml[0] - M);
      sum += ml[1] * ml[0];
    }
    if (n_splits == 1) {
      row_sum[tid] = sum;
    } else {
      part_ml[2 * (p0 + (long)tid * n_splits)] = M;
      part_ml[2 * (p0 + (long)tid * n_splits) + 1] = sum;
    }
  }
  __syncthreads();
  for (int i = tid; i < RB * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, rr = row0 + r;
    if (rr >= rows) break;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += merge_acc[(w * RB + r) * HD + d] * merge_ml[2 * (w * RB + r)];
    if (n_splits == 1)
      out[(((long)b * Sq + rr / g) * nq + (long)kh * g + rr % g) * HD + d] =
          from_float<T>(a / fmaxf(row_sum[r], 1e-30f));
    else
      part_acc[(p0 + (long)r * n_splits) * HD + d] = a;
  }
}

// Block-wide max or sum over blockDim.x (a multiple of 32, at most 1024)
// threads; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = kMax ? warp_max(x) : warp_sum(x);
  const int warp = threadIdx.x >> 5, n = blockDim.x >> 5;
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < n; ++w) x = kMax ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Grid (rows, nkv, B), hd threads: merge the splits' partials of one row by
// the log-sum-exp rule and write the output. The splits' weights go to
// shared memory first, so the accumulator loads are independent.
template <typename T>
__global__ void flash_combine_kernel(const float* __restrict__ part_ml,
                                     const float* __restrict__ part_acc, T* __restrict__ out,
                                     int Sq, int nq, int nkv, int hd, int n_splits) {
  __shared__ float weight[kMaxSplits];
  __shared__ float red[32];
  const int g = nq / nkv, rows = g * Sq;
  const int rr = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const long p0 = (((long)b * nkv + kh) * rows + rr) * n_splits;
  float M = kNeg;
  for (int s = d; s < n_splits; s += blockDim.x) M = fmaxf(M, part_ml[2 * (p0 + s)]);
  M = block_reduce<true>(M, red);
  float sum = 0.f;
  for (int s = d; s < n_splits; s += blockDim.x) {
    weight[s] = expf(part_ml[2 * (p0 + s)] - M);
    sum += part_ml[2 * (p0 + s) + 1] * weight[s];
  }
  sum = block_reduce<false>(sum, red);  // its barriers also publish `weight`
  float a = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < n_splits; ++sp) {
    a += part_acc[(p0 + sp) * hd + d] * weight[sp];
  }
  out[(((long)b * Sq + rr / g) * nq + (long)kh * g + rr % g) * hd + d] =
      from_float<T>(a / fmaxf(sum, 1e-30f));
}

// ---------------------------------------------------------------------------
// Prefill path: bf16, Sq >= 64, hd 64/128/256. wgmma fed by TMA.
// ---------------------------------------------------------------------------
constexpr int kPfRows = 64;                          // query rows per consumer warpgroup
constexpr int kPfConsumers = 2;                      // consumer warpgroups
constexpr int kPfBlockQ = kPfRows * kPfConsumers;    // query rows per block
constexpr int kPfKeys = 64;                          // keys per kv tile
constexpr int kPfThreads = (kPfConsumers + 1) * 128; // + one producer warpgroup
constexpr int kAtomBytes = 64 * 128;  // 64 rows of one 128-byte-swizzled column block
constexpr int kMaxSmem = 232448;

// Shared memory, from a 1024-aligned base: Q (per consumer, hd/64 column
// blocks of 64 rows x 64 dims), K and V stages (hd/64 column blocks of 64
// keys each), the mbarriers, three ints (q_pos min, max, live tile count)
// and the list of live tiles.
template <int HD>
struct PfTile {
  static constexpr int kCB = HD / 64;
  static constexpr int kStages = HD == 256 ? 2 : 4;
  static constexpr int kQBytes = kPfConsumers * kCB * kAtomBytes;
  static constexpr int kKVBytes = kCB * kAtomBytes;  // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kBars = 1 + 4 * kStages;  // full q; full and empty k and v per stage
  static constexpr int kMiscOff = kBarOff + 8 * kBars;
  static constexpr int kListOff = kMiscOff + 16;
  static size_t bytes(int n_tiles) { return 1024 + kListOff + 4 * (size_t)n_tiles; }
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses to wgmma's registers across it.
__device__ __forceinline__ void reg_fence(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16 from shared memory) * B (16 x 64 from
// shared memory, K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16 bf16 in registers) * B (16 x 64 from
// shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

constexpr int kSumKeys = 64;  // kv slots one position summary covers

// Grid (B, nkv * hd / 32 * MSPLIT + summaries) of 512 threads, summaries
// 0 or 1. Block (b, y < nkv * hd / 32 * MSPLIT): mean_v[b, kh, split, 32
// dims] = the sum of V[b, t, kh, :] / Skv over split's share of the Skv
// slots; summed over the MSPLIT splits (in order, by the reader), the mean
// of V that a query row with no valid slot returns. Block (b, nkv * hd /
// 32 * MSPLIT): for each group of kSumKeys slots of batch row b,
// summary[b][group] = (the lowest position held, INT_MAX if none; the
// highest, INT_MIN if none; 1 if every slot of the group is below Skv and
// holds a position, else 0), so that a prefill block classifies its kv
// tiles from ceil(Skv / kSumKeys) summaries instead of Skv positions.
template <int MSPLIT>
__global__ void __launch_bounds__(512)
prefill_prep_kernel(const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_pos,
                    float* __restrict__ mean_v, int* __restrict__ summary, int Skv, int nkv,
                    int hd) {
  constexpr int msplit = MSPLIT;
  __shared__ float part[16][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, b = blockIdx.x;
  const int dblocks = hd / 32;
  if ((int)blockIdx.y < nkv * dblocks * msplit) {
    const int kh = blockIdx.y / (dblocks * msplit), rem = blockIdx.y % (dblocks * msplit);
    const int d = rem / msplit * 32 + lane, sp = rem % msplit;
    const int t0 = (int)((long)sp * Skv / msplit), t1 = (int)((long)(sp + 1) * Skv / msplit);
    const long step = (long)nkv * hd;
    const __nv_bfloat16* vb = v + ((long)b * Skv * nkv + kh) * hd + d;
    float s = 0.f;
#pragma unroll 8
    for (int t = t0 + warp; t < t1; t += 16) s += __bfloat162float(vb[t * step]);
    part[warp][lane] = s;
    __syncthreads();
    if (warp == 0) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < 16; ++w) total += part[w][lane];
      mean_v[(((long)b * nkv + kh) * msplit + sp) * hd + d] = total / (float)Skv;
    }
    return;
  }
  const int groups = (Skv + kSumKeys - 1) / kSumKeys;
  const int* pb = kv_pos + (long)b * Skv;
  for (int gi = warp; gi < groups; gi += 16) {
    int lo = INT_MAX, hi = INT_MIN;
    bool all = true;
#pragma unroll
    for (int j = lane; j < kSumKeys; j += 32) {
      const int t = gi * kSumKeys + j;
      const int kp = t < Skv ? pb[t] : -1;
      all = all && kp >= 0;
      if (kp >= 0) {
        lo = min(lo, kp);
        hi = max(hi, kp);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) {
      int* out = summary + 3 * ((long)b * groups + gi);
      out[0] = lo;
      out[1] = hi;
      out[2] = all;
    }
  }
}

// The class of a kv tile for a block of query rows: 0 dead (no (row, key)
// pair of the block can be valid), 1 partial, 2 full (every pair is
// valid), from the tile's slot summaries (lo and hi, the lowest and
// highest position held; all, every slot below Skv holds one and no block
// row is past Sq) and the block's q_pos range. Conservative both ways, as
// positions are arbitrary ring-buffer slots: causally, a tile is dead when
// every position is past the block's last query position or at least
// `window` behind its first, and full when every position is at most the
// block's first and within the window of its last.
__device__ __forceinline__ int tile_class(int lo, int hi, bool all, long long qmin,
                                          long long qmax, int causal, int window) {
  bool live = lo <= hi, full = all;
  if (causal) {
    live = live && qmax >= lo;
    full = full && qmin >= hi;
    if (window > 0) {
      live = live && hi > qmin - window;
      full = full && qmax - lo < window;
    }
  }
  return live ? (full ? 2 : 1) : 0;
}

// Every thread of an hd-64 prefill block: list the block's live kv tiles (of
// `groups` kSumKeys-slot summaries each), in order, as 2 t + 1 for a
// partial tile t and 2 t for a full one, from the block's q_pos range (into
// misc[0..1]) and the summaries; returns their count (misc[2]). list holds
// ceil(Skv / (kSumKeys groups)) ints.
__device__ __forceinline__ int list_live_tiles(int* list, int* misc,
                                               const int* __restrict__ q_pos,
                                               const int* __restrict__ summary, int b, int q0,
                                               int Sq, int Skv, int causal, int window,
                                               int groups) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_groups = (Skv + kSumKeys - 1) / kSumKeys;
  const int n_tiles = (n_groups + groups - 1) / groups;
  if (tid == 0) {
    misc[0] = INT_MAX;
    misc[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < kPfBlockQ && q0 + tid < Sq) {
    const int qp = q_pos[(long)b * Sq + q0 + tid];
    atomicMin(&misc[0], qp);
    atomicMax(&misc[1], qp);
  }
  __syncthreads();
  const long long qmin = misc[0], qmax = misc[1];
  const int* sb = summary + 3L * b * n_groups;
  for (int t = tid; t < n_tiles; t += blockDim.x) {
    int lo = INT_MAX, hi = INT_MIN;
    bool all = q0 + kPfBlockQ <= Sq;
    for (int j = 0; j < groups; ++j) {
      const int gi = t * groups + j;
      if (gi < n_groups) {
        lo = min(lo, sb[3 * gi]);
        hi = max(hi, sb[3 * gi + 1]);
        all = all && sb[3 * gi + 2];
      } else {
        all = false;
      }
    }
    list[t] = tile_class(lo, hi, all, qmin, qmax, causal, window);
  }
  __syncthreads();
  if (warp == 0) {  // compact into the list of live tiles, in order
    int n = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int c = base + lane < n_tiles ? list[base + lane] : 0;
      const unsigned mask = __ballot_sync(0xffffffffu, c != 0);
      __syncwarp();
      if (c) list[n + __popc(mask & ((1u << lane) - 1u))] = 2 * (base + lane) + (c == 1);
      n += __popc(mask);
      __syncwarp();
    }
    if (lane == 0) misc[2] = n;
  }
  __syncthreads();
  return misc[2];
}

// Grid (query blocks of 128 rows, nq, B), kPfThreads threads. Warpgroups 0
// and 1 consume, warpgroup 2 produces (one thread issues every TMA copy).
// Consumer warpgroup c, warp w owns query rows q0 + 64c + 16w + (0..15);
// with g = lane / 4 and c4 = lane % 4 a thread holds rows g and g + 8 of
// the warp's 16 and, in wgmma's accumulator layout, keys (dims) 8n + 2c4
// and + 1 of n-tile n: element 4n + {0, 1} for row g, 4n + {2, 3} for g + 8.
template <int HD>
__global__ void __launch_bounds__(kPfThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos, const float* __restrict__ mean_v,
                     __nv_bfloat16* __restrict__ out, int Sq, int Skv, int nq, int nkv,
                     int causal, int window, float softcap, float scale) {
  using L = PfTile<HD>;
  constexpr int CB = L::kCB;
  constexpr int ST = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar0 = sbase + L::kBarOff;  // barrier i at bar0 + 8 i
  auto full_k = [&](int st) { return bar0 + 8 * (1 + st); };
  auto full_v = [&](int st) { return bar0 + 8 * (1 + ST + st); };
  auto empty_k = [&](int st) { return bar0 + 8 * (1 + 2 * ST + st); };
  auto empty_v = [&](int st) { return bar0 + 8 * (1 + 3 * ST + st); };
  int* misc = reinterpret_cast<int*>(smem + L::kMiscOff);
  int* list = reinterpret_cast<int*>(smem + L::kListOff);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kPfBlockQ;  // the most kv tiles first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (nq / nkv);
  const int n_tiles = (Skv + kPfKeys - 1) / kPfKeys;

  if (tid == 0) {
    mbar_init(bar0, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), kPfConsumers * 4);  // one arrival per consumer warp
      mbar_init(empty_v(st), kPfConsumers * 4);
    }
    misc[0] = INT_MAX;
    misc[1] = INT_MIN;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < kPfBlockQ && q0 + tid < Sq) {
    const int qp = q_pos[(long)b * Sq + q0 + tid];
    atomicMin(&misc[0], qp);
    atomicMax(&misc[1], qp);
  }
  __syncthreads();
  // A kv tile is live unless no (row, key) pair of the block can be valid:
  // no slot holds a position, or, causally, every position is past the
  // block's last query position or at least `window` behind its first.
  const long long qmin = misc[0], qmax = misc[1];
  for (int t = warp; t < n_tiles; t += kPfThreads / 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int j = lane; j < kPfKeys; j += 32) {
      const int s = t * kPfKeys + j;
      const int kp = s < Skv ? kv_pos[(long)b * Skv + s] : -1;
      if (kp >= 0) {
        lo = min(lo, kp);
        hi = max(hi, kp);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    bool live = lo <= hi;
    if (causal) {
      live = live && (long long)lo <= qmax;
      if (window > 0) live = live && (long long)hi > qmin - window;
    }
    if (lane == 0) list[t] = live;
  }
  __syncthreads();
  if (warp == 0) {  // compact the flags into the list of live tiles, in order
    int n = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const bool live = base + lane < n_tiles && list[base + lane];
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      __syncwarp();
      if (live) list[n + __popc(mask & ((1u << lane) - 1u))] = base + lane;
      n += __popc(mask);
      __syncwarp();
    }
    if (lane == 0) misc[2] = n;
  }
  __syncthreads();
  const int n_live = misc[2];

  const int wg = warp >> 2;
  if (wg == kPfConsumers) {
    // Producer warpgroup: one thread keeps the ring of K/V stages full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kPfConsumers * 128) {
      mbar_expect_tx(bar0, kPfBlockQ * HD * 2);
      for (int c = 0; c < kPfConsumers; ++c)
        for (int cb = 0; cb < CB; ++cb)
          tma_load_4d(sbase + (c * CB + cb) * kAtomBytes, &tq, cb * 64, h, q0 + c * kPfRows, b,
                      bar0);
      for (int i = 0; i < n_live; ++i) {
        const int st = i % ST, ph = (i / ST) & 1;
        const int t0 = list[i] * kPfKeys;
        const uint32_t ks = sbase + L::kQBytes + st * L::kKVBytes;
        const uint32_t vs = sbase + L::kQBytes + (ST + st) * L::kKVBytes;
        mbar_wait(empty_k(st), ph ^ 1);
        mbar_expect_tx(full_k(st), kPfKeys * HD * 2);
        for (int cb = 0; cb < CB; ++cb)
          tma_load_4d(ks + cb * kAtomBytes, &tk, cb * 64, kh, t0, b, full_k(st));
        mbar_wait(empty_v(st), ph ^ 1);
        mbar_expect_tx(full_v(st), kPfKeys * HD * 2);
        for (int cb = 0; cb < CB; ++cb)
          tma_load_4d(vs + cb * kAtomBytes, &tv, cb * 64, kh, t0, b, full_v(st));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int gq = lane >> 2, c4 = lane & 3;
    const int r0 = q0 + wg * kPfRows + (warp & 3) * 16 + gq;  // rows r0 and r0 + 8
    const int qp0 = r0 < Sq ? q_pos[(long)b * Sq + r0] : -(1 << 30);
    const int qp1 = r0 + 8 < Sq ? q_pos[(long)b * Sq + r0 + 8] : -(1 << 30);
    const int* kvp = kv_pos + (long)b * Skv;
    const uint32_t qs = sbase + wg * CB * kAtomBytes;
    float o[CB][32];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
    float m0 = kNeg, m1 = kNeg, row_sum0 = 0.f, row_sum1 = 0.f;  // sums: this thread's share
    float s[32];                       // scores of the tile
    uint32_t pa[kPfKeys / 16][4];      // its P, as wgmma's A operand
    float alpha0 = 1.f, alpha1 = 1.f;  // rescale of O for the tile

    // S = Q K^T for tile i: 64 rows x 64 keys, hd / 16 steps of 16 dims.
    // Both operands K-major; a step advances 32 bytes inside a swizzled row.
    auto issue_scores = [&](int i) {
      const int st = i % ST;
      const uint32_t ks = sbase + L::kQBytes + st * L::kKVBytes;
      mbar_wait(full_k(st), (i / ST) & 1);
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kAtomBytes + (kk & 3) * 32;
        wgmma_ss(s, smem_desc(qs + off, 16, 1024), smem_desc(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // Scale, cap and mask tile i's scores; online softmax per row; P to p.
    auto softmax = [&](int i, uint32_t (&p)[kPfKeys / 16][4]) {
      const int t0 = list[i] * kPfKeys;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + n * 8 + 2 * c4 + e;
          const bool in_range = t < Skv;
          const int kp = in_range ? kvp[t] : -1;
          s[4 * n + e] =
              masked_score(s[4 * n + e] * scale, qp0, kp, in_range, causal, window, softcap);
          s[4 * n + 2 + e] =
              masked_score(s[4 * n + 2 + e] * scale, qp1, kp, in_range, causal, window, softcap);
          mx0 = fmaxf(mx0, s[4 * n + e]);
          mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      alpha0 = __expf(m0 - mn0);
      alpha1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float tile_sum0 = 0.f, tile_sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[4 * n] = __expf(s[4 * n] - mn0);
        s[4 * n + 1] = __expf(s[4 * n + 1] - mn0);
        s[4 * n + 2] = __expf(s[4 * n + 2] - mn1);
        s[4 * n + 3] = __expf(s[4 * n + 3] - mn1);
        tile_sum0 += s[4 * n] + s[4 * n + 1];
        tile_sum1 += s[4 * n + 2] + s[4 * n + 3];
      }
      row_sum0 = row_sum0 * alpha0 + tile_sum0;
      row_sum1 = row_sum1 * alpha1 + tile_sum1;
      // P as wgmma's A operand: k-step j takes keys 16j .. 16j + 15.
#pragma unroll
      for (int j = 0; j < kPfKeys / 16; ++j) {
        p[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
        p[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        p[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        p[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }
    };

    // O += P V for tile i, P in p: V is MN-major (dims contiguous); a
    // k-step of 16 keys is two 8-key groups 1024 bytes apart, a column
    // block 64 dims.
    auto issue_pv = [&](int i, uint32_t (&p)[kPfKeys / 16][4]) {
      const int st = i % ST;
      const uint32_t vs = sbase + L::kQBytes + (ST + st) * L::kKVBytes;
      mbar_wait(full_v(st), (i / ST) & 1);
      wgmma_fence();
#pragma unroll
      for (int kstep = 0; kstep < kPfKeys / 16; ++kstep) {
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
          wgmma_rs(o[cb], p[kstep], smem_desc(vs + cb * kAtomBytes + kstep * 2048, 1024, 1024));
      }
      wgmma_commit();
    };
    // A K tile is free once its scores are in, a V tile once P.V is done.
    auto release_k = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k(i % ST));
    };
    auto release_v = [&](int i) {
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) reg_fence(o[cb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v(i % ST));
    };
    // Each tile: the scores, the softmax, then P.V. The two consumer
    // warpgroups are independent, so the tensor cores can run one's
    // products while the other computes its softmax.
    mbar_wait(bar0, 0);
    for (int i = 0; i < n_live; ++i) {
      issue_scores(i);
      wgmma_wait0();
      release_k(i);
      reg_fence(s);
      softmax(i, pa);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[cb][4 * n] *= alpha0;
          o[cb][4 * n + 1] *= alpha0;
          o[cb][4 * n + 2] *= alpha1;
          o[cb][4 * n + 3] *= alpha1;
        }
      }
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) reg_fence(o[cb]);
      issue_pv(i, pa);
      wgmma_wait0();
      release_v(i);
    }

    row_sum0 = quad_sum(row_sum0);
    row_sum1 = quad_sum(row_sum1);
    const float* mv = mean_v + ((long)b * nkv + kh) * HD + 2 * c4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= Sq) continue;
      // a row that met no valid key in any tile has none anywhere: it takes
      // the mean of V over the Skv slots
      const bool none = (half ? m1 : m0) == kNeg;
      const float dn = fmaxf(half ? row_sum1 : row_sum0, 1e-30f);
      __nv_bfloat16* orow = out + (((long)b * Sq + row) * nq + h) * HD + 2 * c4;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int d = cb * 64 + n * 8;
          const float x0 = none ? mv[d] : o[cb][4 * n + 2 * half] / dn;
          const float x1 = none ? mv[d + 1] : o[cb][4 * n + 2 * half + 1] / dn;
          *reinterpret_cast<unsigned*>(orow + d) = pack_bf16(x0, x1);
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// Prefill path at hd 64: kv tiles of 128 keys, full tiles without a mask,
// each warpgroup's scores of the next tile in flight during its softmax.
// ---------------------------------------------------------------------------
constexpr int kP64Keys = 128;   // keys per kv tile
constexpr int kP64Stages = 4;   // K/V tiles in the ring
constexpr int kMeanSplits64 = 8;  // key ranges the prep kernel sums V over
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-aligned base: Q (per consumer, 64 rows x 64
// dims), the K and V stages (128 keys x 64 dims each), the positions of
// each stage's keys, the mbarriers, three ints (q_pos min, max, live tile
// count) and the list of live tiles.
struct P64Tile {
  static constexpr int kQBytes = kPfConsumers * kAtomBytes;
  static constexpr int kKVBytes = kP64Keys * 128;  // one K or V tile
  static constexpr int kPosOff = kQBytes + 2 * kP64Stages * kKVBytes;
  static constexpr int kBarOff = kPosOff + kP64Stages * kP64Keys * 4;
  static constexpr int kBars = 1 + 4 * kP64Stages;  // full q; full and empty k and v per stage
  static constexpr int kMiscOff = kBarOff + 8 * kBars;
  static constexpr int kListOff = kMiscOff + 16;
  static size_t bytes(int n_tiles) { return 1024 + kListOff + 4 * (size_t)n_tiles; }
};

// d (64 x N, fp32) (+)= A (64 x 16 from shared memory) * B (16 x N from
// shared memory, K-major), N = 128 or 192; accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss_wide(float (&d)[N / 2], uint64_t a, uint64_t b,
                                              int accumulate) {
  static_assert(N == 128 || N == 192, "wgmma_ss_wide takes N = 128 or 192");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence_n(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Grid (query blocks of 128 rows, nq, B), kPfThreads threads; a head's
// query blocks are issued together (its K/V stay in L2), longest first.
// Warpgroups 0 and 1 consume, warpgroup 2 produces: one thread issues every
// TMA copy, one warp copies the keys' positions of each partial tile into
// its stage. Consumer warpgroup c, warp w owns query rows q0 + 64c + 16w +
// (0..15); with g = lane / 4 and c4 = lane % 4 a thread holds rows g and
// g + 8 of the warp's 16 and, in wgmma's accumulator layout, keys (dims)
// 8n + 2c4 and + 1 of n-tile n: element 4n + {0, 1} for row g, 4n + {2, 3}
// for g + 8. Scores are kept in the log2 domain (scale x log2(e) folded
// in, exp2); a masked score is kNeg there as in the other paths.
__global__ void __launch_bounds__(kPfThreads, 1)
flash_prefill64_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, const float* __restrict__ mean_v,
                       const int* __restrict__ summary, __nv_bfloat16* __restrict__ out, int Sq,
                       int Skv, int nq, int nkv, int causal, int window, float softcap,
                       float scale) {
  using L = P64Tile;
  constexpr int ST = kP64Stages;
  constexpr int NK = kP64Keys;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar0 = sbase + L::kBarOff;  // barrier i at bar0 + 8 i
  auto full_k = [&](int st) { return bar0 + 8 * (1 + st); };
  auto full_v = [&](int st) { return bar0 + 8 * (1 + ST + st); };
  auto empty_k = [&](int st) { return bar0 + 8 * (1 + 2 * ST + st); };
  auto empty_v = [&](int st) { return bar0 + 8 * (1 + 3 * ST + st); };
  int* pos = reinterpret_cast<int*>(smem + L::kPosOff);  // [ST][NK]
  int* misc = reinterpret_cast<int*>(smem + L::kMiscOff);
  int* list = reinterpret_cast<int*>(smem + L::kListOff);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (nq / nkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kPfBlockQ;  // the most kv tiles first

  if (tid == 0) {
    mbar_init(bar0, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k(st), 1 + 32);  // the TMA thread and the position warp's lanes
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), kPfConsumers * 4);  // one arrival per consumer warp
      mbar_init(empty_v(st), kPfConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // dead tiles are skipped, full ones never masked (tile_class)
  const int n_live =
      list_live_tiles(list, misc, q_pos, summary, b, q0, Sq, Skv, causal, window, NK / kSumKeys);

  const int wg = warp >> 2;
  if (wg == kPfConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kPfConsumers * 128) {
      // the TMA thread keeps the ring of K/V stages full
      mbar_expect_tx(bar0, kPfBlockQ * 64 * 2);
      for (int c = 0; c < kPfConsumers; ++c)
        tma_load_4d(sbase + c * kAtomBytes, &tq, 0, h, q0 + c * kPfRows, b, bar0);
      for (int i = 0; i < n_live; ++i) {
        const int st = i % ST, ph = (i / ST) & 1;
        const int t0 = (list[i] >> 1) * NK;
        mbar_wait(empty_k(st), ph ^ 1);
        mbar_expect_tx(full_k(st), NK * 128);
        tma_load_4d(sbase + L::kQBytes + st * L::kKVBytes, &tk, 0, kh, t0, b, full_k(st));
        mbar_wait(empty_v(st), ph ^ 1);
        mbar_expect_tx(full_v(st), NK * 128);
        tma_load_4d(sbase + L::kQBytes + (ST + st) * L::kKVBytes, &tv, 0, kh, t0, b,
                    full_v(st));
      }
    } else if (warp == kPfConsumers * 4 + 1) {
      // the position warp: a partial tile's positions into its stage
      const int* pb = kv_pos + (long)b * Skv;
      for (int i = 0; i < n_live; ++i) {
        const int st = i % ST, ph = (i / ST) & 1, e = list[i];
        mbar_wait(empty_k(st), ph ^ 1);
        if (e & 1) {
          const int t0 = (e >> 1) * NK;
#pragma unroll
          for (int j = lane; j < NK; j += 32) pos[st * NK + j] = t0 + j < Skv ? pb[t0 + j] : -1;
        }
        mbar_arrive(full_k(st));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int gq = lane >> 2, c4 = lane & 3;
    const int r0 = q0 + wg * kPfRows + (warp & 3) * 16 + gq;  // rows r0 and r0 + 8
    const int qp0 = r0 < Sq ? q_pos[(long)b * Sq + r0] : -(1 << 30);
    const int qp1 = r0 + 8 < Sq ? q_pos[(long)b * Sq + r0 + 8] : -(1 << 30);
    const uint32_t qs = sbase + wg * kAtomBytes;
    const float scale_log2 = scale * kLog2e;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, row_sum0 = 0.f, row_sum1 = 0.f;  // sums: this thread's share
    float s[NK / 2];                   // scores of a tile, then its probabilities
    uint32_t pa[NK / 16][4];           // P of a tile, as wgmma's A operand
    float alpha0 = 1.f, alpha1 = 1.f;  // rescale of O for the tile

    // S = Q K^T for tile i: 64 rows x NK keys, four steps of 16 dims; both
    // operands K-major, a step advances 32 bytes inside a swizzled row.
    auto issue_scores = [&](int i) {
      const int st = i % ST;
      const uint32_t ks = sbase + L::kQBytes + st * L::kKVBytes;
      mbar_wait(full_k(st), (i / ST) & 1);
      reg_fence_n(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_wide<NK>(s, smem_desc(qs + kk * 32, 16, 1024),
                          smem_desc(ks + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
    };
    // Tile i's scores in the log2 domain, the online softmax per row, and
    // the probabilities (in s). A full tile only scales (and caps); a
    // partial one takes the mask from its keys' positions in shared memory.
    auto softmax = [&](int i) {
      const int e = list[i];
      float mx0 = -INFINITY, mx1 = -INFINITY;
      const bool plain = !(e & 1) && softcap <= 0.f;
      if (plain) {
#pragma unroll
        for (int n = 0; n < NK / 8; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        mx0 *= scale_log2;
        mx1 *= scale_log2;
      } else if (!(e & 1)) {
#pragma unroll
        for (int x = 0; x < NK / 2; ++x) s[x] = softcap * tanhf(s[x] * scale / softcap) * kLog2e;
#pragma unroll
        for (int n = 0; n < NK / 8; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
      } else {
        const int t0 = (e >> 1) * NK;
        const int* pt = pos + (i % ST) * NK;
#pragma unroll
        for (int n = 0; n < NK / 8; ++n) {
          const int2 kp = *reinterpret_cast<const int2*>(pt + 8 * n + 2 * c4);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const bool in_range = t0 + 8 * n + 2 * c4 + u < Skv;
            const int kpu = u ? kp.y : kp.x;
            float x0 = masked_score(s[4 * n + u] * scale, qp0, kpu, in_range, causal, window,
                                    softcap);
            float x1 = masked_score(s[4 * n + 2 + u] * scale, qp1, kpu, in_range, causal,
                                    window, softcap);
            s[4 * n + u] = x0 > kNeg ? x0 * kLog2e : x0;  // kNeg and -inf stay as they are
            s[4 * n + 2 + u] = x1 > kNeg ? x1 * kLog2e : x1;
            mx0 = fmaxf(mx0, s[4 * n + u]);
            mx1 = fmaxf(mx1, s[4 * n + 2 + u]);
          }
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      alpha0 = ex2(m0 - mn0);
      alpha1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float tile_sum0 = 0.f, tile_sum1 = 0.f;
      if (plain) {
#pragma unroll
        for (int n = 0; n < NK / 8; ++n) {
          s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -mn0));
          s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -mn0));
          s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -mn1));
          s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -mn1));
          tile_sum0 += s[4 * n] + s[4 * n + 1];
          tile_sum1 += s[4 * n + 2] + s[4 * n + 3];
        }
      } else {
#pragma unroll
        for (int n = 0; n < NK / 8; ++n) {
          s[4 * n] = ex2(s[4 * n] - mn0);
          s[4 * n + 1] = ex2(s[4 * n + 1] - mn0);
          s[4 * n + 2] = ex2(s[4 * n + 2] - mn1);
          s[4 * n + 3] = ex2(s[4 * n + 3] - mn1);
          tile_sum0 += s[4 * n] + s[4 * n + 1];
          tile_sum1 += s[4 * n + 2] + s[4 * n + 3];
        }
      }
      row_sum0 = fmaf(row_sum0, alpha0, tile_sum0);
      row_sum1 = fmaf(row_sum1, alpha1, tile_sum1);
    };
    // P (in s) as wgmma's A operand: k-step j takes keys 16j .. 16j + 15.
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < NK / 16; ++j) {
        pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
        pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }
    };
    // O = alpha O + P V for tile i: V is MN-major (dims contiguous); a
    // k-step of 16 keys is two 8-key groups 1024 bytes apart.
    auto issue_pv = [&](int i) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] *= alpha0;
        o[4 * n + 1] *= alpha0;
        o[4 * n + 2] *= alpha1;
        o[4 * n + 3] *= alpha1;
      }
      reg_fence_n(o);
      const int st = i % ST;
      const uint32_t vs = sbase + L::kQBytes + (ST + st) * L::kKVBytes;
      mbar_wait(full_v(st), (i / ST) & 1);
      wgmma_fence();
#pragma unroll
      for (int kstep = 0; kstep < NK / 16; ++kstep)
        wgmma_rs(o, pa[kstep], smem_desc(vs + kstep * 2048, 1024, 1024));
      wgmma_commit();
    };
    // A K stage (and its positions) is free once the tile's softmax is
    // done, a V stage once its P.V is.
    auto release_k = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k(i % ST));
    };
    auto release_v = [&](int i) {
      reg_fence_n(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v(i % ST));
    };
    // The two warpgroups issue their products in turns, so that one's
    // softmax runs while the other's products do: a warpgroup waits for its
    // turn (named barrier 1 + wg) before issuing and passes it on (the
    // other's barrier) after; warpgroup 0 goes first, and warpgroup 1 does
    // not pass its last turn, so every arrival meets a wait.
    auto turn = [&]() { named_bar_sync(1 + wg, 256); };
    auto pass = [&](bool last) {
      if (!(wg == 1 && last)) named_bar_arrive(2 - wg, 256);
    };
    // Tile i's scores are issued before the products of tile i - 1, so the
    // tensor cores run P.V of tile i - 1 while this warpgroup computes the
    // softmax of tile i.
    mbar_wait(bar0, 0);
    if (n_live > 0) {
      if (wg == 1) named_bar_arrive(1, 256);
      turn();
      issue_scores(0);
      pass(false);
      wgmma_wait0();
      reg_fence_n(s);
      softmax(0);
      release_k(0);
      pack();
      for (int i = 1; i < n_live; ++i) {
        turn();
        issue_scores(i);
        issue_pv(i - 1);
        pass(false);
        wgmma_wait1();
        reg_fence_n(s);
        softmax(i);
        release_k(i);
        wgmma_wait0();
        release_v(i - 1);
        pack();
      }
      turn();
      issue_pv(n_live - 1);
      pass(true);
      wgmma_wait0();
      release_v(n_live - 1);
    }

    row_sum0 = quad_sum(row_sum0);
    row_sum1 = quad_sum(row_sum1);
    // the mean of V: the prep kernel's kMeanSplits64 partial means, in order
    const float* mv = mean_v + ((long)b * nkv + kh) * kMeanSplits64 * 64 + 2 * c4;
    auto mean = [&](int d) {
      float x = 0.f;
#pragma unroll
      for (int sp = 0; sp < kMeanSplits64; ++sp) x += mv[sp * 64 + d];
      return x;
    };
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= Sq) continue;
      // a row that met no valid key in any tile has none anywhere: it takes
      // the mean of V over the Skv slots
      const bool none = (half ? m1 : m0) == kNeg;
      const float dn = fmaxf(half ? row_sum1 : row_sum0, 1e-30f);
      __nv_bfloat16* orow = out + (((long)b * Sq + row) * nq + h) * 64 + 2 * c4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = n * 8;
        const float x0 = none ? mean(d) : o[4 * n + 2 * half] / dn;
        const float x1 = none ? mean(d + 1) : o[4 * n + 2 * half + 1] / dn;
        *reinterpret_cast<unsigned*>(orow + d) = pack_bf16(x0, x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda.so.1 the process already loaded.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// TMA map of a [B, rows, heads, hd] bf16 tensor whose boxes are box_rows
// rows x 64 dims of one head, 128-byte swizzled; rows past `rows` read as
// zeros.
bool head_rows_map(CUtensorMap* map, const void* base, int B, int rows, int heads, int hd,
                   int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* out;
  float* scratch;
  int B, Sq, Skv, nq, nkv, causal, window, splits;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_cores(const Args& a) {
  using L = Tile<T, HD>;
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + L::kBlockQ - 1) / L::kBlockQ, a.nq, a.B);
  kern<<<grid, kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.q_pos,
      a.kv_pos, static_cast<T*>(a.out), a.Sq, a.Skv, a.nq, a.nkv, a.causal, a.window, a.softcap,
      a.scale);
  return cudaGetLastError();
}

// scratch: (m, l) of every partial, then their accumulators.
template <typename T, int HD>
cudaError_t launch_decode(const Args& a) {
  using L = DecodeTile<T, HD>;
  const int rows = a.nq / a.nkv * a.Sq;
  const int row_tiles = (rows + L::kRowsPerBlock - 1) / L::kRowsPerBlock;
  const int n_splits = a.splits;
  if (n_splits <= 0 || n_splits > kMaxSplits ||
      n_splits > (a.Skv + kSplitKeys - 1) / kSplitKeys)
    return cudaErrorInvalidValue;
  float* part_ml = a.scratch;
  float* part_acc = a.scratch + 2 * (long)a.B * a.nkv * rows * n_splits;
  auto kern = flash_decode_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_splits, a.nkv * row_tiles, a.B), kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.q_pos,
      a.kv_pos, part_ml, part_acc, static_cast<T*>(a.out), a.Sq, a.Skv, a.nq, a.nkv, a.causal,
      a.window, a.softcap, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  flash_combine_kernel<T><<<dim3(rows, a.nkv, a.B), HD, 0, a.stream>>>(
      part_ml, part_acc, static_cast<T*>(a.out), a.Sq, a.nq, a.nkv, HD, n_splits);
  return cudaGetLastError();
}

// Decode blocks of this type and head dim that one SM holds at once.
template <typename T, int HD>
cudaError_t decode_occupancy(int* blocks) {
  using L = DecodeTile<T, HD>;
  auto kern = flash_decode_kernel<T, HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kThreads, L::kBytes);
}

// scratch: mean_v [B, nkv, msplit, HD] (fp32; msplit 1 but at hd 64),
// then, at hd 64, the slot summaries [B, ceil(Skv / kSumKeys), 3] (int32).
template <int HD>
constexpr int mean_splits() {
  return HD == 64 ? kMeanSplits64 : 1;
}

template <int HD>
int* prefill_summary(const Args& a) {
  return reinterpret_cast<int*>(a.scratch + (long)a.B * a.nkv * mean_splits<HD>() * HD);
}

template <int HD>
cudaError_t launch_prep(const Args& a) {
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  constexpr int msplit = mean_splits<HD>();
  prefill_prep_kernel<msplit>
      <<<dim3(a.B, a.nkv * HD / 32 * msplit + (HD == 64 ? 1 : 0)), 512, 0, a.stream>>>(
          v, a.kv_pos, a.scratch, prefill_summary<HD>(a), a.Skv, a.nkv, HD);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_prefill(const Args& a) {
  using L = PfTile<HD>;
  const int n_tiles = (a.Skv + kPfKeys - 1) / kPfKeys;
  const size_t bytes = L::bytes(n_tiles);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!head_rows_map(&tq, a.q, a.B, a.Sq, a.nq, HD, kPfRows) ||
      !head_rows_map(&tk, a.k, a.B, a.Skv, a.nkv, HD, kPfKeys) ||
      !head_rows_map(&tv, a.v, a.B, a.Skv, a.nkv, HD, kPfKeys))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_prep<HD>(a);
  if (err != cudaSuccess) return err;
  auto kern = flash_prefill_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kPfBlockQ - 1) / kPfBlockQ, a.nq, a.B);
  kern<<<grid, kPfThreads, bytes, a.stream>>>(tq, tk, tv, a.q_pos, a.kv_pos, a.scratch,
                                              static_cast<__nv_bfloat16*>(a.out), a.Sq, a.Skv,
                                              a.nq, a.nkv, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_prefill64(const Args& a) {
  using L = P64Tile;
  const int n_tiles = (a.Skv + kP64Keys - 1) / kP64Keys;
  const size_t bytes = L::bytes(n_tiles);
  const int q_blocks = (a.Sq + kPfBlockQ - 1) / kPfBlockQ;
  if (bytes > (size_t)kMaxSmem || a.nq > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!head_rows_map(&tq, a.q, a.B, a.Sq, a.nq, 64, kPfRows) ||
      !head_rows_map(&tk, a.k, a.B, a.Skv, a.nkv, 64, kP64Keys) ||
      !head_rows_map(&tv, a.v, a.B, a.Skv, a.nkv, 64, kP64Keys))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_prep<64>(a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_prefill64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  flash_prefill64_kernel<<<dim3(q_blocks, a.nq, a.B), kPfThreads, bytes, a.stream>>>(
      tq, tk, tv, a.q_pos, a.kv_pos, a.scratch, prefill_summary<64>(a),
      static_cast<__nv_bfloat16*>(a.out), a.Sq, a.Skv, a.nq, a.nkv, a.causal, a.window, a.softcap,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_path(const Args& a) {
  if (a.Sq < kDecodeMaxSq) return launch_decode<T, HD>(a);
  if constexpr (std::is_same<T, __nv_bfloat16>::value && HD == 64) {
    return launch_prefill64(a);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && HD >= 64) {
    return launch_prefill<HD>(a);
  } else {
    return launch_cores<T, HD>(a);
  }
}

template <typename T>
cudaError_t launch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32:
      return launch_path<T, 32>(a);
    case 64:
      return launch_path<T, 64>(a);
    case 128:
      return launch_path<T, 128>(a);
    case 256:
      return launch_path<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means none, softcap <= 0
// means none. q, k, v and out must be 16-byte aligned. scratch is fp32 and
// depends on the path: for Sq < 64, (2 + hd) floats per (batch, kv head,
// row, split) with rows = nq / nkv * Sq and `splits` splits (1 <= splits
// <= min(256, ceil(Skv / 64))); for bf16 with Sq >= 64 and hd >= 64, B *
// nkv * hd floats, at hd 64 B * nkv * 8 * hd and 3 * B * ceil(Skv / 64)
// more; otherwise none.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* q_pos, const void* kv_pos, void* out,
                                         void* scratch, int dtype, int B, int Sq, int Skv,
                                         int nq, int nkv, int hd, int causal, int window,
                                         float softcap, int splits, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || nkv <= 0 || nq % nkv != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos), out,
         static_cast<float*>(scratch), B, Sq, Skv, nq, nkv, causal, window, splits,
         softcap, (float)(1.0 / sqrt((double)hd)), static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_hd<float>(hd, a);
  if (dtype == 1) return (int)launch_hd<__nv_bfloat16>(hd, a);
  return (int)cudaErrorInvalidValue;
}

// The decode blocks (dtype 0 = float32, 1 = bfloat16; hd 32, 64, 128 or
// 256) that one SM of the current device holds at once, into *blocks.
// Returns the cudaError_t (0 on success).
extern "C" int repro_flash_decode_blocks_per_sm(int dtype, int hd, int* blocks) {
  auto by_hd = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    switch (hd) {
      case 32:
        return decode_occupancy<T, 32>(blocks);
      case 64:
        return decode_occupancy<T, 64>(blocks);
      case 128:
        return decode_occupancy<T, 128>(blocks);
      case 256:
        return decode_occupancy<T, 256>(blocks);
      default:
        return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return (int)by_hd(float{});
  if (dtype == 1) return (int)by_hd(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}
