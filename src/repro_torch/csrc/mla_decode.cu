// Absorbed-query MLA attention over the compressed latent cache.
// Replaces the Pallas kernels repro/kernels/mla_decode.py
// mla_views_attend (per-row latent views, the N-step loop) and
// mla_paged_attend (latent block pools, the fused step).
//
// q_lat (B, C, H, R), q_rope (B, C, H, RD), pos (B,) int32 -> out
// (B, C, H, R).  Latents: views ckv (B, S1, R) / kr (B, S1, RD) with slot
// j = position j, or pools ckv (nb, bs, R) / kr (nb, bs, RD) routed by
// the row's block table (B, NB).  Query c of row b sees keys
// j <= pos[b] + c; score (q_lat . ckv_j + q_rope . kr_j) * scale, value
// ckv_j; softmax in f32.  The trash view slot and the trash block hold
// positions no live query sees, so position masks them.
//
// Bound: bytes at decode (each visible latent read once, ~240 flops a
// byte at H = 128), operations at prefill chunks and wide mixed steps
// (B = 2, C = 128 at deepseek-v3's widths: 22.8 GFLOP, 0.023 ms at the
// 989 TFLOP/s bf16 tensor-core rate; at the 67 TFLOP/s of f32 CUDA cores
// no kernel could beat 0.34 ms).  The (C*H, R) f32 accumulator of a row
// (256 KB at H = 128) fits no CTA, so a CTA owns a tile of query rows
// (c, head) of one batch row, row i = c*H + h at position pos[b] + i / H,
// and with nsplit > 1 one of nsplit ranges of the keys the tile sees;
// combine_splits (attend.cuh) merges the partial (m, l, acc).  Every head
// attends the same latent row, so the heads fold into the tile's rows
// (no GQA grouping) and one staged latent chunk serves them all: as the
// key of S = Q·Kᵀ (576 columns) and as the value of P·V (its first 512).
//
// bfloat16: tensor cores (mla_attend_tc).  64 rows a CTA, 8 warps = 4
// row groups of 16 rows (one m16n8k16 A tile) x 2 halves of the 512
// latent columns; each warp keeps O for its 16 rows x 256 columns in f32
// registers (128 a thread).  Q (64 x 576 bf16, 72 KB) is copied once by
// cp.async into shared memory, XOR-swizzled (16-byte chunk c of row r at
// c ^ (r & 7)), and read by ldmatrix at every k-step: beside O it would
// need 144 more registers a thread.  The latents go in 32-key chunks of
// [ckv | kr] (36 KB, bf16) through a 3-stage cp.async ring, each 16-byte
// piece routed through the block table (paged) and zero-filled past the
// CTA's last key by the copy itself.  The two warps of a row group split
// S's 36 k-steps between them, swap their partial 16 x 32 blocks through
// shared memory under a 64-thread named barrier and add them (a + b ==
// b + a exactly), so both hold the same S and run the same online
// softmax (log2 units, exp2f) with nothing else exchanged.  P goes from
// the S accumulators into the A fragments of P·V as bf16 hi + lo (one
// bf16 P errs up to 2^-8 of each term, beyond the one-ulp tolerance on
// rows that see few keys); V is read from the same stage by
// ldmatrix.trans.  The epilogue divides by l and stores O as 16-byte rows
// through the Q tile's shared memory, or writes a split's partial (m in
// natural-log units, l, acc).  196 KB of shared memory and 255
// registers: one CTA an SM, two warps a scheduler.  A chunk costs a CTA
// 1,600 m16n8k16 MMAs (72 + 128 a warp) and 384 KB of ldmatrix and swap
// traffic (~3,000 cycles at 128 bytes a cycle): mma.sync takes its
// operands from registers, so every warp loads its own Q and K
// fragments.  Splitting S rather than computing it in both warps of a
// row group cuts that traffic from 573 KB a chunk.  wgmma (B read from
// shared memory once for 64 rows) is the next step.
//
// float32: CUDA cores (mla_attend_f32); tensor cores would be TF32 and
// change the numbers against the f32 plain version.  A CTA = 16 query
// rows: 8 warps of 2 rows, each lane holding 16 accumulator columns of
// both rows in registers.  The latents are staged in 32-key chunks as
// f32 rows of R + RD = 576 (padded to 580 floats so that lanes reading
// different keys with float4 loads hit distinct banks): a lane scores
// one key against the warp's two rows, the warp runs the online softmax
// across its lanes, then every lane adds the 32 probability-weighted
// latent rows into its columns with float4 loads that feed 8 FMAs each.
#include <type_traits>

#include "attend.cuh"
#include "mma.cuh"

namespace {

constexpr int kR = 512;
constexpr int kRD = 64;
constexpr int kK = kR + kRD;          // key width
constexpr int kChunk = 32;            // keys a staged chunk (both templates;
                                      // the wrapper's _common.KEY_CHUNK)

// Token index of key position t of row b in the latent storage.
struct ViewLatents {
  int s1;
  __device__ __forceinline__ long long token(int b, int t) const {
    return (long long)b * s1 + t;
  }
};

struct PagedLatents {
  const int* bt;
  int nb_seq, bs;
  __device__ __forceinline__ long long token(int b, int t) const {
    return (long long)bt[(long long)b * nb_seq + t / bs] * bs + t % bs;
  }
};

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kLd = kK + 4;           // shared row stride, floats
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kCols = kR / 32 / 4;    // float4 column groups a lane owns
constexpr size_t kSmemBytes = (size_t)(kTileRows + kChunk) * kLd * sizeof(float);

static_assert(kLd % 4 == 0, "float4 rows");
static_assert(kTileRows == 16, "the wrapper's TILE_ROWS[float32]");

__device__ __forceinline__ void store_f4(float* dst, float a, float b,
                                         float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// Stage keys [k0, k0 + kChunk) of row b, zeros at and past k_end, into
// ks as f32 rows [ckv | kr].  Every 16-byte load is issued before the
// first store, so their latencies overlap.
template <typename T, typename Lat>
__device__ __forceinline__ void load_latents(const T* __restrict__ ckv,
                                             const T* __restrict__ kr,
                                             const Lat& lat, int b, int k0,
                                             int k_end, float* ks) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PR = kR / VEC;
  constexpr int PER_KEY = kK / VEC;
  constexpr int N = kChunk * PER_KEY / kThreads;
  static_assert(N * kThreads == kChunk * PER_KEY, "chunk tiling");
  uint4 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = idx / PER_KEY, u = idx % PER_KEY, key = k0 + t;
    if (key < k_end) {
      const long long tok = lat.token(b, key);
      const T* src = u < PR ? ckv + tok * kR + u * VEC
                            : kr + tok * kRD + (u - PR) * VEC;
      v[i] = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      v[i] = make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = idx / PER_KEY, u = idx % PER_KEY;
    float* dst = ks + t * kLd + u * VEC;
    const T* x = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      store_f4(dst + j, rt::to_f(x[j]), rt::to_f(x[j + 1]),
               rt::to_f(x[j + 2]), rt::to_f(x[j + 3]));
  }
}

template <typename Lat>
__global__ void __launch_bounds__(kThreads, 2)
mla_attend_f32(const float* __restrict__ q_lat,
               const float* __restrict__ q_rope,
               const float* __restrict__ ckv, const float* __restrict__ kr,
               const Lat lat, const int* __restrict__ pos_,
               float* __restrict__ out, float* __restrict__ part_acc,
               float* __restrict__ part_ml, int C, int H, int n_keys,
               float scale, int nsplit) {
  using T = float;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTileRows][kLd]
  float* ks = qs + kTileRows * kLd;             // [kChunk][kLd]

  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_rows = C * H;
  const int row0 = tile * kTileRows;
  const int row_end = min(row0 + kTileRows, n_rows);
  const long long qbase = (long long)b * n_rows;   // flat row of (b, 0, 0)
  const int pos = pos_[b];

  for (int i = tid; i < kTileRows * kK; i += kThreads) {
    const int r = i / kK, d = i % kK, gr = row0 + r;
    float x = 0.f;
    if (gr < n_rows)
      x = d < kR ? rt::to_f(q_lat[(qbase + gr) * kR + d])
                 : rt::to_f(q_rope[(qbase + gr) * kRD + (d - kR)]);
    qs[r * kLd + d] = x;
  }

  // keys any query of the tile sees, then this CTA's share of them
  const int c_hi = (row_end - 1) / H;
  int k_begin = 0;
  int k_end = min(pos + c_hi, n_keys - 1) + 1;
  if (nsplit > 1) {
    const int span = max(k_end, 0);
    const int per = ((span + nsplit - 1) / nsplit + kChunk - 1) / kChunk * kChunk;
    k_begin = split * per;
    k_end = min(k_end, k_begin + per);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4 * kCols];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * kCols; ++j) acc[rr][j] = 0.f;
  }
  const float* q0 = qs + (warp * kRowsPerWarp) * kLd;
  const float* q1 = q0 + kLd;

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    __syncthreads();  // previous chunk consumed (and qs written, first time)
    load_latents<T>(ckv, kr, lat, b, k0, k_end, ks);
    __syncthreads();

    // scores: lane = key, against both of the warp's rows
    const int key = k0 + lane;
    const float* kp = ks + lane * kLd;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int d = 0; d < kK; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kp + d);
      const float4 a = *reinterpret_cast<const float4*>(q0 + d);
      const float4 c = *reinterpret_cast<const float4*>(q1 + d);
      s0 = fmaf(a.x, kv.x, s0); s0 = fmaf(a.y, kv.y, s0);
      s0 = fmaf(a.z, kv.z, s0); s0 = fmaf(a.w, kv.w, s0);
      s1 = fmaf(c.x, kv.x, s1); s1 = fmaf(c.y, kv.y, s1);
      s1 = fmaf(c.z, kv.z, s1); s1 = fmaf(c.w, kv.w, s1);
    }
    const float sc[kRowsPerWarp] = {s0 * scale, s1 * scale};

    float p[kRowsPerWarp], alpha[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int gr = row0 + warp * kRowsPerWarp + rr;
      const bool ok = gr < row_end && key < k_end && key <= pos + gr / H;
      const float s = ok ? sc[rr] : -INFINITY;
      const float m_new = fmaxf(m[rr], rt::warp_max(s));
      if (m_new == -INFINITY) {       // no visible key yet (warp-uniform)
        alpha[rr] = 1.f;
        p[rr] = 0.f;
      } else {
        alpha[rr] = expf(m[rr] - m_new);
        p[rr] = ok ? expf(s - m_new) : 0.f;
        m[rr] = m_new;
      }
      l[rr] = l[rr] * alpha[rr] + rt::warp_sum(p[rr]);
#pragma unroll
      for (int j = 0; j < 4 * kCols; ++j) acc[rr][j] *= alpha[rr];
    }

    // acc += p . latent over the chunk's keys; lane owns columns
    // 4 * lane + 128 * g + (0..3)
    const int nt = min(kChunk, k_end - k0);
    for (int t = 0; t < nt; ++t) {
      const float p0 = __shfl_sync(0xffffffffu, p[0], t);
      const float p1 = __shfl_sync(0xffffffffu, p[1], t);
      const float* vrow = ks + t * kLd + 4 * lane;
#pragma unroll
      for (int g = 0; g < kCols; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(vrow + 128 * g);
        float* a0 = acc[0] + 4 * g;
        float* a1 = acc[1] + 4 * g;
        a0[0] = fmaf(p0, v.x, a0[0]); a0[1] = fmaf(p0, v.y, a0[1]);
        a0[2] = fmaf(p0, v.z, a0[2]); a0[3] = fmaf(p0, v.w, a0[3]);
        a1[0] = fmaf(p1, v.x, a1[0]); a1[1] = fmaf(p1, v.y, a1[1]);
        a1[2] = fmaf(p1, v.z, a1[2]); a1[3] = fmaf(p1, v.w, a1[3]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int gr = row0 + warp * kRowsPerWarp + rr;
    if (gr >= row_end) continue;
    const long long orow = qbase + gr;
    if (nsplit > 1) {
      const long long prow = orow * nsplit + split;
#pragma unroll
      for (int g = 0; g < kCols; ++g)
        store_f4(part_acc + prow * kR + 4 * lane + 128 * g, acc[rr][4 * g],
                 acc[rr][4 * g + 1], acc[rr][4 * g + 2], acc[rr][4 * g + 3]);
      if (lane == 0) {
        part_ml[prow * 2] = m[rr];
        part_ml[prow * 2 + 1] = l[rr];
      }
      continue;
    }
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    T* o = out + orow * kR + 4 * lane;
#pragma unroll
    for (int g = 0; g < kCols; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[128 * g + j] = rt::from_f<T>(acc[rr][4 * g + j] * inv);
  }
}

// What the shared launch needs of this template.
template <typename Lat>
struct Attend {
  static constexpr auto kernel = mla_attend_f32<Lat>;
  static constexpr int kRows = kTileRows, kThreads = f32::kThreads;
  static constexpr size_t kSmemBytes = f32::kSmemBytes;
  static constexpr float kScale = 1.0f;   // softmax in natural-log units
};

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 on tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using namespace rt;   // the tensor-core helpers of mma.cuh
using bf16 = __nv_bfloat16;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = 4;               // row groups of 16 rows
constexpr int kRows = kGroups * 16;      // query rows a CTA
constexpr int kStages = 3;               // latent chunks in the ring
constexpr int kCh = kK / 8;              // 16-byte pieces a row (72)
constexpr int kHalfSteps = kK / 16 / 2;  // k-steps of S a warp (18)
constexpr int kNT = kChunk / 8;          // n-tiles of S (4)
constexpr int kOT = kR / 2 / 8;          // n-tiles of O a warp (32)
constexpr int kSFrag = kNT * 4;          // S accumulators a thread (16)
constexpr size_t kSmemBytes =
    (size_t)(kRows + kStages * kChunk) * kK * sizeof(bf16)   // Q, ring
    + (size_t)kWarps * kSFrag * 32 * sizeof(float);          // S swap

static_assert(kWarps == 2 * kGroups, "two warps a row group");
static_assert(kRows == 64, "the wrapper's TILE_ROWS[bfloat16]");
static_assert(kK % 64 == 0, "swizzled rows");

// 64 threads of row group g (warps g and g + 4) meet at barrier 1 + g
__device__ __forceinline__ void pair_sync(int g) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + g) : "memory");
}

// Latent keys [k0, k0 + kChunk) of row b as bf16 rows [ckv | kr] into a
// swizzled stage; keys at and past k_end (> k0) are zero-filled.
template <typename Lat>
__device__ __forceinline__ void stage_latents(bf16* dst,
                                              const bf16* __restrict__ ckv,
                                              const bf16* __restrict__ kr,
                                              const Lat& lat, int b, int k0,
                                              int k_end) {
  static_assert(kChunk * kCh % kThreads == 0, "chunk tiling");
#pragma unroll
  for (int it = 0; it < kChunk * kCh / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int t = idx / kCh, c = idx % kCh, key = k0 + t;
    const bool ok = key < k_end;
    const long long tok = lat.token(b, ok ? key : k0);
    const bf16* src = c < kR / 8 ? ckv + tok * kR + c * 8
                                 : kr + tok * kRD + (c - kR / 8) * 8;
    cp_async16(smem_u32(dst + swz<kK>(t, c)), src, ok);
  }
}

template <typename Lat>
__global__ void __launch_bounds__(kThreads, 1)
mla_attend_tc(const bf16* __restrict__ q_lat, const bf16* __restrict__ q_rope,
              const bf16* __restrict__ ckv, const bf16* __restrict__ kr,
              const Lat lat, const int* __restrict__ pos_,
              bf16* __restrict__ out, float* __restrict__ part_acc,
              float* __restrict__ part_ml, int C, int H, int n_keys,
              float scale_log2, int nsplit) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [kRows][kK], then O
  bf16* ks = qs + kRows * kK;                 // [kStages][kChunk][kK]
  float* xs = reinterpret_cast<float*>(ks + kStages * kChunk * kK);

  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp % kGroups, half = warp / kGroups;
  const int n_rows = C * H;
  const int row0 = tile * kRows;
  const int row_end = min(row0 + kRows, n_rows);
  const long long qbase = (long long)b * n_rows;   // flat row of (b, 0, 0)
  const int pos = pos_[b];

  // keys any row of the tile sees, then this CTA's share of them
  const int c_lo = row0 / H, c_hi = (row_end - 1) / H;
  int k_begin = 0;
  int k_end = min(pos + c_hi, n_keys - 1) + 1;
  if (nsplit > 1) {
    const int span = max(k_end, 0);
    const int per = ((span + nsplit - 1) / nsplit + kChunk - 1) / kChunk * kChunk;
    k_begin = split * per;
    k_end = min(k_end, k_begin + per);
  }
  const int n_chunks =
      k_end > k_begin ? (k_end - k_begin + kChunk - 1) / kChunk : 0;

  // the Q tile (rows past the last zero-filled) and chunk 0, one copy
  // group; chunks 1 .. kStages - 2 one group each
#pragma unroll
  for (int it = 0; it < kRows * kCh / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / kCh, c = idx % kCh, gr = row0 + r;
    const bool ok = gr < n_rows;
    const long long qr = qbase + (ok ? gr : row0);
    const bf16* src = c < kR / 8 ? q_lat + qr * kR + c * 8
                                 : q_rope + qr * kRD + (c - kR / 8) * 8;
    cp_async16(smem_u32(qs + swz<kK>(r, c)), src, ok);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks)
      stage_latents(ks + s * kChunk * kK, ckv, kr, lat, b,
                    k_begin + s * kChunk, k_end);
    cp_async_commit();
  }

  // this thread's two rows of its group's 16: lane / 4 and lane / 4 + 8
  const int wrow = grp * 16 + (lane >> 2);
  const int qpos[2] = {pos + (row0 + wrow) / H, pos + (row0 + wrow + 8) / H};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[kOT][4];
#pragma unroll
  for (int j = 0; j < kOT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float* x_mine = xs + warp * kSFrag * 32;
  const float* x_peer = xs + (warp ^ kGroups) * kSFrag * 32;

  for (int n = 0; n < n_chunks; ++n) {
    const int k0 = k_begin + n * kChunk;
    cp_async_wait<kStages - 2>();   // chunk n (and Q) landed
    __syncthreads();                // and every warp is done with n - 1
    if (n + kStages - 1 < n_chunks)
      stage_latents(ks + ((n + kStages - 1) % kStages) * kChunk * kK, ckv,
                    kr, lat, b, k0 + (kStages - 1) * kChunk, k_end);
    cp_async_commit();
    const bf16* kst = ks + (n % kStages) * kChunk * kK;

    // this warp's half of S = Q Kᵀ: 16 rows x 32 keys over k-steps
    // [half * 18, half * 18 + 18), two a pass
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kHalfSteps / 2; ++kp) {
      const int c0 = half * 2 * kHalfSteps + 4 * kp;   // first 16-byte chunk
      uint32_t qa[4], qb[4];
      ldsm_x4(smem_u32(qs + swz<kK>(grp * 16 + (lane & 15), c0 + (lane >> 4))),
              qa);
      ldsm_x4(smem_u32(qs + swz<kK>(grp * 16 + (lane & 15),
                                    c0 + 2 + (lane >> 4))),
              qb);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t kf[4];
        ldsm_x4(smem_u32(kst + swz<kK>(j * 8 + (lane & 7), c0 + (lane >> 3))),
                kf);
        mma(s[j], qa, kf[0], kf[1]);
        mma(s[j], qb, kf[2], kf[3]);
      }
    }
    // swap halves with the other warp of the row group and add
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x_mine[(j * 4 + e) * 32 + lane] = s[j][e];
    pair_sync(grp);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += x_peer[(j * 4 + e) * 32 + lane];

    // scale (in log2 units), mask where the chunk crosses the CTA's last
    // key or a row's position
    const bool edge = k0 + kChunk > k_end || k0 + kChunk - 1 > pos + c_lo;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= k_end || key > qpos[e >> 1]) x = -INFINITY;
        }
        s[j][e] = x;
      }

    // online softmax of the thread's two rows (a quad shares a row)
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mu[r] = mx == -INFINITY ? 0.f : mx;   // no visible key yet
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mx;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kOT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mu[e >> 1]);
        l[e >> 1] += p;   // this thread's share; the quad sums at the end
        s[j][e] = p;
      }

    // O += P V over this warp's 256 columns, P from the S accumulators
    // as A fragments (hi + lo), V = the chunk's first 512 columns
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int jp = 0; jp < kOT / 2; ++jp) {
        uint32_t vf[4];
        ldsm_x4_t(smem_u32(kst + swz<kK>(16 * kk + (lane & 15),
                                         half * kOT + 2 * jp + (lane >> 4))),
                  vf);
        mma(o[2 * jp], ph, vf[0], vf[1]);
        mma(o[2 * jp], pl, vf[0], vf[1]);
        mma(o[2 * jp + 1], ph, vf[2], vf[3]);
        mma(o[2 * jp + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every copy landed, no warp reads Q any more

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if (nsplit > 1) {   // the split's partial (m, l, acc), m in natural log
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = row0 + wrow + 8 * r;
      if (gr >= row_end) continue;
      const long long prow = (qbase + gr) * nsplit + split;
      float* pa = part_acc + prow * kR + half * (kR / 2) + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < kOT; ++j)
        *reinterpret_cast<float2*>(pa + j * 8) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (half == 0 && (lane & 3) == 0) {
        part_ml[prow * 2] = m[r] * 0.6931471805599453f;
        part_ml[prow * 2 + 1] = l[r];
      }
    }
    return;
  }

  // O / l -> the group's 16 rows of the Q tile's shared memory -> device
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = wrow + 8 * r;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int j = 0; j < kOT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          qs + swz<kK>(rr, half * kOT + j) + (lane & 3) * 2) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kOT / 32; ++it) {
    const int idx = lane + it * 32;
    const int rr = grp * 16 + idx / kOT, c = half * kOT + idx % kOT;
    const int gr = row0 + rr;
    if (gr < n_rows)
      *reinterpret_cast<uint4*>(out + (qbase + gr) * kR + c * 8) =
          *reinterpret_cast<const uint4*>(qs + swz<kK>(rr, c));
  }
}

template <typename Lat>
struct Attend {
  static constexpr auto kernel = mla_attend_tc<Lat>;
  static constexpr int kRows = tc::kRows, kThreads = tc::kThreads;
  static constexpr size_t kSmemBytes = tc::kSmemBytes;
  static constexpr float kScale = 1.4426950408889634f;   // log2(e): exp2f
};

}  // namespace tc

// The template T selects (f32: CUDA cores, bf16: tensor cores), then
// with nsplit > 1 the merge of its splits.
template <typename T, typename Lat>
cudaError_t launch(const void* ql, const void* qr, const void* ckv,
                   const void* kr, const Lat& lat, const void* pos, void* out,
                   void* pacc, void* pml, int B, int C, int H, int n_keys,
                   float scale, int nsplit, cudaStream_t stream) {
  using A = std::conditional_t<std::is_same_v<T, float>, f32::Attend<Lat>,
                               tc::Attend<Lat>>;
  auto kernel = A::kernel;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)A::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  float* pa = static_cast<float*>(pacc);
  float* pm = static_cast<float*>(pml);
  const int tiles = (C * H + A::kRows - 1) / A::kRows;
  kernel<<<dim3(tiles * nsplit, B), A::kThreads, A::kSmemBytes, stream>>>(
      in(ql), in(qr), in(ckv), in(kr), lat, static_cast<const int*>(pos),
      static_cast<T*>(out), pa, pm, C, H, n_keys, scale * A::kScale, nsplit);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const int rows = B * C * H;
  rt::combine_splits<T, kR><<<(rows + rt::kWarps - 1) / rt::kWarps,
                              rt::kThreads, 0, stream>>>(
      pa, pm, static_cast<T*>(out), rows, nsplit);
  return cudaGetLastError();
}

template <typename Lat>
int by_dtype(int dtype, const void* ql, const void* qr, const void* ckv,
             const void* kr, const Lat& lat, const void* pos, void* out,
             void* pacc, void* pml, int B, int C, int H, int n_keys,
             float scale, int nsplit, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || n_keys <= 0 || nsplit < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ql, qr, ckv, kr, lat, pos, out, pacc, pml, B, C, H,
                         n_keys, scale, nsplit, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ql, qr, ckv, kr, lat, pos, out, pacc, pml,
                                 B, C, H, n_keys, scale, nsplit, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Latent views (B, S1, R) / (B, S1, RD).  dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores).  part_acc (B*C*H, nsplit, R) and
// part_ml (B*C*H, nsplit, 2) are f32 scratch, unused when nsplit == 1.
// Returns cudaGetLastError() after the launches.
extern "C" int rt_mla_decode_views(const void* q_lat, const void* q_rope,
                                   const void* ckv, const void* kr, int S1,
                                   const void* pos, void* out, void* part_acc,
                                   void* part_ml, int B, int C, int H,
                                   float scale, int nsplit, int dtype,
                                   void* stream) {
  return by_dtype(dtype, q_lat, q_rope, ckv, kr, ViewLatents{S1}, pos, out,
                  part_acc, part_ml, B, C, H, S1, scale, nsplit, stream);
}

// Latent block pools (nb, bs, R) / (nb, bs, RD), block tables (B, nb_seq)
// int32; the rest as above.
extern "C" int rt_mla_decode_paged(const void* q_lat, const void* q_rope,
                                   const void* ckv_pool, const void* kr_pool,
                                   const void* block_tables, int nb_seq,
                                   int bs, const void* pos, void* out,
                                   void* part_acc, void* part_ml, int B,
                                   int C, int H, float scale, int nsplit,
                                   int dtype, void* stream) {
  const PagedLatents lat{static_cast<const int*>(block_tables), nb_seq, bs};
  return by_dtype(dtype, q_lat, q_rope, ckv_pool, kr_pool, lat, pos, out,
                  part_acc, part_ml, B, C, H, nb_seq * bs, scale, nsplit,
                  stream);
}
