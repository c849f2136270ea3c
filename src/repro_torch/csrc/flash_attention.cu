// Flash-attention forward over full sequences (prefill), GQA, causal and
// sliding-window masks.  Replaces the Pallas kernel
// repro/kernels/flash_attention.py flash_attention_bhsd.
//
// q (B, Sq, H, HD), k/v (B, Sk, KV, HD) -> out (B, Sq, H, HD), read and
// written in that layout (no transpose, no pad of the head dim or of S:
// the ragged tails are masked).  Query position i and key position j
// both count from 0; j is visible to i when (not causal or j <= i) and
// (window == 0 or j > i - window).  Softmax in f32, online.  A query
// row that sees no key (window > 0 and i >= Sk + window - 1) gets what
// the reference's softmax over all -1e30 logits gives it: the mean of v
// over [0, Sk), summed in f32 by the CTA that owns the row, in the same
// launch.
//
// Both templates pack the Sq*G query rows that share a kv head as row
// index i*G + g (G = H/KV heads per kv head) and cut them into tiles of
// 64 rows, so one K/V chunk staged in shared memory serves all G heads
// of ~64/G query positions (the TPU grid gave each query head its own
// pass over K/V).  Keys past the last position any row of a tile sees
// (causal) or before the first (window) are never read.  Tiles launch
// heaviest first.
//
// bfloat16: tensor cores (flash_attention_tc).  At qwen2-1.5b's static
// prefill (B=8, S=448, 12/2 heads, hd 128, causal) the work is 4.9 GFLOP
// against 26 MB of q/k/v/o: 0.0050 ms at the 989 TFLOP/s bf16 rate and
// 0.0077 ms at 3.35 TB/s, so bytes bind, and the design keeps the MMA
// units fed rather than chasing their last factor.  A CTA is 4 warps,
// each owning 16 query rows: one m16n8k16 A tile.  The Q tile is copied
// to shared memory once (cp.async) and moved by ldmatrix into A
// fragments that stay in registers for the whole key loop.  K and V go
// in 64-key chunks through a 2-stage ring of shared memory, filled by
// 16-byte cp.async.cg copies into an XOR-swizzled layout (16-byte chunk
// c of row r sits at c ^ (r & 7)), so ldmatrix (K) and ldmatrix.trans
// (V) read without bank conflicts.  Chunk n+1's K is issued before the
// Q·Kᵀ of chunk n and its V before the P·V of chunk n, so each copy
// overlaps a product.  S = Q·Kᵀ is mma.sync bf16 -> f32; the scale is
// folded with log2(e) and the online softmax runs in registers (row max
// and sum across each quad by shuffles, exp2f); the mask is applied only
// on chunks that cross the causal diagonal, the window edge or Sk.  P
// goes from the S accumulators straight into the A fragments of P·V,
// as two bf16 terms (hi = bf16(p), lo = bf16(p - hi)): one bf16 P errs
// up to 2^-8 of each term, more than the one-ulp tolerance against the
// f32 plain version allows on rows that see few keys; hi + lo keeps
// about 16 bits of p for one more MMA per P·V step, on units that are
// not the bound.  O accumulates in f32 registers (64 a thread at hd
// 128); the epilogue divides by l, rounds to bf16 and stores through
// shared memory as 16-byte rows.  Shared memory at hd 128: Q 16 KB +
// 2 x (K 16 KB + V 16 KB) = 80 KB, two CTAs an SM.  At hd 256 (O alone
// 128 registers a thread) Q's fragments are read from shared memory at
// each k-step instead of held, and K/V go in 32-key chunks: Q 32 KB +
// 2 x (16 KB + 16 KB) = 96 KB, still two CTAs an SM.  At hd 120
// (h2o-danube-3) rows are 240 bytes apart, 15 16-byte copies each; the
// shared layout is hd 128's (rt::smem_hd) with the 16th chunk of every
// staged row zero-filled by the copy, so Q·Kᵀ's last k-step adds zeros;
// O is 15 n8 tiles and 120 columns are stored.
//
// float32: CUDA cores (flash_attention_f32).  Tensor cores on f32 would
// be TF32 and change the numbers against the f32 plain version, so f32
// keeps a CUDA-core design: the tile's queries sit in shared memory as
// f32; the keys go in chunks of 32 (16-byte vector loads, all issued
// before any is stored); each warp owns 8 query rows, a lane scores one
// key of the chunk against the warp's rows and accumulates HD/32 columns
// of the 8 output rows (4 at hd 256, where 8 rows of 256 columns would
// take 64 accumulators a thread and 64 rows of q 64 KB; 4 at hd 120,
// where a lane's fourth column exists for lanes 0-23 only and 8 rows
// spill); 256 threads, two CTAs an SM.  Operations bind it (67 TFLOP/s
// f32).
#include "attend.cuh"
#include "mma.cuh"

namespace {

// Column means of v over keys [0, Sk) of one (row, kv head), in f32, into
// shared memory: the output of every query row that sees no key.
template <typename T, int HD, int THREADS>
__device__ void v_mean(const T* __restrict__ vb, long long kv_stride, int Sk,
                       float* out) {
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    float s = 0.f;
    for (int j = 0; j < Sk; ++j) s += rt::to_f(vb[j * kv_stride + d]);
    out[d] = s / (float)Sk;
  }
}

// the launch order of both templates: tile index from blockIdx.x, the
// heaviest (the last, under a causal mask) for every (row, kv head) first
struct TileIndex {
  int b, kv, tile;
  __device__ TileIndex(int B, int KV, int tiles) {
    const int bkv = blockIdx.x % (B * KV);
    tile = tiles - 1 - blockIdx.x / (B * KV);
    b = bkv / KV;
    kv = bkv % KV;
  }
};

// ---------------------------------------------------------------------------
// bfloat16 on tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using namespace rt;   // the tensor-core helpers of mma.cuh
using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;   // one m16n8k16 A tile a warp

// keys a chunk, whether Q's A fragments stay in registers for the whole
// key loop (at hd 256 they are read from shared memory at each k-step: O
// alone takes 128 registers a thread), and the staged rows' width (hd
// 120 staged as 128, its last chunk zeros)
template <int HD>
struct Shape {
  static constexpr int kKeys = HD > 128 ? 32 : 64;
  static constexpr bool kQRegs = HD <= 128;
  static constexpr int kLd = smem_hd(HD);
};

template <int HD>
constexpr int smem_bytes() {   // Q, 2 x (K, V)
  return (kRows + 4 * Shape<HD>::kKeys) * Shape<HD>::kLd * (int)sizeof(bf16);
}
static_assert(2 * (smem_bytes<120>() + 120 * 4) <= 232448,
              "hd 120: two CTAs an SM, as at 128");
static_assert(2 * (smem_bytes<256>() + 256 * 4) <= 232448,
              "hd 256: two CTAs an SM");

// K/V rows [k0, k0 + KEYS) of one (row, kv head) into a swizzled stage of
// smem_hd(HD)-wide rows; keys at and past Sk and the chunks past HD (hd
// 120) are zero-filled (never read from device memory)
template <int HD, int KEYS>
__device__ __forceinline__ void load_keys(bf16* dst, const bf16* src,
                                          long long kv_stride, int k0,
                                          int Sk) {
  constexpr int LD = smem_hd(HD), CH = LD / 8, CHG = HD / 8;
  static_assert(KEYS * CH % kThreads == 0, "chunk tiling");
#pragma unroll
  for (int it = 0; it < KEYS * CH / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / CH, c = idx % CH, key = k0 + r;
    const bool in_row = CHG == CH || c < CHG;
    const bool ok = key < Sk && in_row;
    cp_async16(smem_u32(dst + swz<LD>(r, c)),
               src + (long long)(key < Sk ? key : 0) * kv_stride +
                   (in_row ? c : 0) * 8,
               ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int B,
                   int Sq, int Sk, int H, int KV, int causal, int window,
                   float scale_log2) {
  constexpr int kKeys = Shape<HD>::kKeys;
  constexpr bool kQRegs = Shape<HD>::kQRegs;
  constexpr int LD = Shape<HD>::kLd;   // staged row width
  constexpr int CH = LD / 8;       // 16-byte chunks a staged row
  constexpr int CHG = HD / 8;      // ... of them in a row in device memory
  constexpr int KSTEPS = LD / 16;  // k-steps of Q·Kᵀ
  constexpr int NT = kKeys / 8;    // n-tiles of S
  constexpr int OT = HD / 8;       // n-tiles of O (15 at hd 120)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [kRows][LD], then O
  bf16* ks = qs + kRows * LD;                 // [2][kKeys][LD]
  bf16* vs = ks + 2 * kKeys * LD;             // [2][kKeys][LD]
  __shared__ float vmean[HD];

  const int G = H / KV, n_rows = Sq * G;
  const TileIndex t(B, KV, (n_rows + kRows - 1) / kRows);
  const int b = t.b, kv = t.kv, row0 = t.tile * kRows;
  const int row_last = min(row0 + kRows, n_rows) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long kv_stride = (long long)KV * HD;   // between positions
  const bf16* kb = k + (long long)b * Sk * kv_stride + (long long)kv * HD;
  const bf16* vb = v + (long long)b * Sk * kv_stride + (long long)kv * HD;

  // keys any row of the tile sees
  const int q_lo = row0 / G, q_hi = row_last / G;
  const int k_end = causal ? min(q_hi + 1, Sk) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int n_chunks = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                       : 0;

  // the Q tile (rows past the last zero-filled), then chunk 0's K, one
  // copy group; chunk 0's V a second
#pragma unroll
  for (int it = 0; it < kRows * CH / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / CH, c = idx % CH, gr = row0 + r;
    const bool in_row = CHG == CH || c < CHG;
    const bool ok = gr < n_rows && in_row;
    const int qr = gr < n_rows ? gr : row0;
    const int qi = qr / G, head = kv * G + qr % G;
    cp_async16(smem_u32(qs + swz<LD>(r, c)),
               q + (((long long)b * Sq + qi) * H + head) * HD +
                   (in_row ? c : 0) * 8,
               ok);
  }
  if (n_chunks > 0) load_keys<HD, kKeys>(ks, kb, kv_stride, k_begin, Sk);
  cp_async_commit();
  if (n_chunks > 0) load_keys<HD, kKeys>(vs, vb, kv_stride, k_begin, Sk);
  cp_async_commit();

  // this thread's two rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int wrow = warp * 16 + (lane >> 2);
  const int pos[2] = {(row0 + wrow) / G, (row0 + wrow + 8) / G};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  cp_async_wait<1>();   // Q and K of chunk 0
  __syncthreads();
  // Q's A fragments: all KSTEPS held, or the two of one k-step pair
  uint32_t qf[kQRegs ? KSTEPS : 2][4];
  const uint32_t q_addr = smem_u32(qs + warp * 16 * LD);
  auto load_q = [&](int s, uint32_t(&f)[4]) {
    ldsm_x4(q_addr + 2 * swz<LD>(lane & 15, 2 * s + (lane >> 4)), f);
  };
  if constexpr (kQRegs) {
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) load_q(s, qf[s]);
  }

  for (int n = 0; n < n_chunks; ++n) {
    const int k0 = k_begin + n * kKeys;
    const int st = n & 1;
    const bf16* kst = ks + st * kKeys * LD;
    const bf16* vst = vs + st * kKeys * LD;
    if (n > 0) {
      cp_async_wait<1>();   // K of chunk n (its V may be in flight)
      __syncthreads();      // and every warp is done with chunk n - 1
    }
    if (n + 1 < n_chunks)
      load_keys<HD, kKeys>(ks + (st ^ 1) * kKeys * LD, kb, kv_stride,
                           k0 + kKeys, Sk);
    cp_async_commit();

    // S = Q Kᵀ: 16 rows x kKeys keys a warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < KSTEPS / 2; ++kp) {
      if constexpr (!kQRegs) {
        load_q(2 * kp, qf[0]);
        load_q(2 * kp + 1, qf[1]);
      }
      const int qa = kQRegs ? 2 * kp : 0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t kf[4];
        ldsm_x4(smem_u32(kst + swz<LD>(j * 8 + (lane & 7), 4 * kp + (lane >> 3))),
                kf);
        mma(s[j], qf[qa], kf[0], kf[1]);
        mma(s[j], qf[qa + 1], kf[2], kf[3]);
      }
    }

    // scale (in log2 units), mask where the chunk crosses an edge
    const bool edge = k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > q_lo) ||
                      (window > 0 && k0 <= q_hi - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int i = pos[e >> 1];
          if (key >= Sk || (causal && key > i) ||
              (window > 0 && key <= i - window))
            x = -INFINITY;
        }
        s[j][e] = x;
      }

    // online softmax of the thread's two rows (a quad shares a row)
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mu[r] = mx == -INFINITY ? 0.f : mx;   // no visible key yet
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mx;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mu[e >> 1]);
        l[e >> 1] += p;   // this thread's share; the quad sums at the end
        s[j][e] = p;
      }

    cp_async_wait<1>();   // V of chunk n (chunk n + 1's K may be in flight)
    __syncthreads();      // and every warp is done with chunk n - 1's V
    if (n + 1 < n_chunks)
      load_keys<HD, kKeys>(vs + (st ^ 1) * kKeys * LD, vb, kv_stride,
                           k0 + kKeys, Sk);
    cp_async_commit();

    // O += P V, P from the S accumulators as A fragments (hi + lo); at
    // hd 120 the last pair's second n-tile is the zero chunk
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int jp = 0; jp < (OT + 1) / 2; ++jp) {
        uint32_t vf[4];
        ldsm_x4_t(smem_u32(vst + swz<LD>(16 * kk + (lane & 15),
                                         2 * jp + (lane >> 4))),
                  vf);
        mma(o[2 * jp], ph, vf[0], vf[1]);
        mma(o[2 * jp], pl, vf[0], vf[1]);
        if (2 * jp + 1 < OT) {
          mma(o[2 * jp + 1], ph, vf[2], vf[3]);
          mma(o[2 * jp + 1], pl, vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int empty_from = Sk + window - 1;   // first position without a key
  if (window > 0 && q_hi >= empty_from) {   // CTA-uniform
    v_mean<bf16, HD, kThreads>(vb, kv_stride, Sk, vmean);
    __syncthreads();
  }

  // O -> the warp's own 16 rows of the Q tile's shared memory -> device
  bf16* os = qs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = wrow + 8 * r;
    const bool empty = window > 0 && pos[r] >= empty_from;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      const float x0 = empty ? vmean[col] : o[j][2 * r] * inv;
      const float x1 = empty ? vmean[col + 1] : o[j][2 * r + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(os + swz<LD>(rr, j) + (lane & 3) * 2) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int idx = lane + it * 32;
    const int rr = warp * 16 + idx / CH, c = idx % CH, gr = row0 + rr;
    if (gr < n_rows && (CHG == CH || c < CHG)) {
      const int qi = gr / G, head = kv * G + gr % G;
      *reinterpret_cast<uint4*>(out + (((long long)b * Sq + qi) * H + head) * HD +
                                c * 8) =
          *reinterpret_cast<const uint4*>(os + swz<LD>(rr, c));
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (Sq * (H / KV) + kRows - 1) / kRows;
  flash_attention_tc<HD><<<tiles * KV * B, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Sq, Sk, H, KV,
      causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;

// query rows a warp and a CTA: 8 and 64, or 4 and 32 at hd 256 (the
// accumulators stay 64 a thread and two CTAs share an SM) and at hd 120
// (8 rows spilled 32 bytes: the lane's partial fourth column costs
// registers within the 128 of two CTAs an SM)
template <int HD>
struct Rows {
  static constexpr int kPerWarp = HD > 128 || HD % 32 ? 4 : 8;
  static constexpr int kCta = kWarps * kPerWarp;
};

// Shared memory of one CTA, in floats: q (rows, HD), k (kChunk, HD + 4)
// (the +4 keeps a lane-per-key float4 read free of bank conflicts), v
// (kChunk, HD).
template <int HD>
constexpr int smem_floats() {
  return Rows<HD>::kCta * HD + kChunk * (HD + 4) + kChunk * HD;
}
static_assert(2 * smem_floats<120>() * 4 <= 232448 &&
                  2 * smem_floats<256>() * 4 <= 232448,
              "hd 120 and 256: two CTAs an SM");

// two CTAs an SM (at most 128 registers a thread): while one waits at
// its barrier for a K/V chunk from device memory, the other computes
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int B, int Sq, int Sk, int H, int KV, int causal,
                    int window, float scale) {
  constexpr int PER_LANE = rt::lane_cols<HD>();
  constexpr int KS = HD + 4;
  constexpr int kRowsPerWarp = Rows<HD>::kPerWarp;
  constexpr int kRows = Rows<HD>::kCta;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kRows][HD]
  float* ks = qs + kRows * HD;                   // [kChunk][KS]
  float* vs = ks + kChunk * KS;                  // [kChunk][HD]

  const int G = H / KV;
  const int n_rows = Sq * G;
  const TileIndex t(B, KV, (n_rows + kRows - 1) / kRows);
  const int kv = t.kv, b = t.b;
  const int row0 = t.tile * kRows;
  const int row_end = min(row0 + kRows, n_rows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, gr = row0 + r;
    float x = 0.f;
    if (gr < n_rows) {
      const int qi = gr / G, head = kv * G + gr % G;
      x = q[(((long long)b * Sq + qi) * H + head) * HD + d];
    }
    qs[i] = x;
  }

  // keys any query of the tile can see
  const int q_lo = row0 / G, q_hi = (row_end - 1) / G;
  const int k_end = causal ? min(q_hi + 1, Sk) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  // and the query positions of this warp's rows
  const int wr0 = row0 + warp * kRowsPerWarp;
  const int wq_lo = min(wr0, n_rows - 1) / G;
  const int wq_hi = min(wr0 + kRowsPerWarp - 1, n_rows - 1) / G;
  const bool warp_live = wr0 < row_end;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][PER_LANE];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) acc[rr][j] = 0.f;
  }

  constexpr int VEC = 4;
  constexpr int PER_TOKEN = HD / VEC;
  constexpr int TOTAL = kChunk * PER_TOKEN;
  // 16-byte loads a thread a chunk (at hd 120 the last pass leaves some
  // threads idle: 960 vectors over 256 threads)
  constexpr int NLOAD = (TOTAL + kThreads - 1) / kThreads;
  // loads in flight a thread, issued before their stores: every one up to
  // hd 128, groups of 4 at hd 256 (within the 128 registers of two CTAs
  // an SM)
  constexpr int GROUP = NLOAD < 4 ? NLOAD : 4;
  static_assert(PER_TOKEN * VEC == HD && NLOAD % GROUP == 0, "chunk tiling");
  const long long kv_stride = (long long)KV * HD;   // between positions
  const float* kb = k + (long long)b * Sk * kv_stride + (long long)kv * HD;
  const float* vb = v + (long long)b * Sk * kv_stride + (long long)kv * HD;

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    __syncthreads();  // previous chunk consumed (and qs written, first time)
#pragma unroll
    for (int i0 = 0; i0 < NLOAD; i0 += GROUP) {
      float4 kr[GROUP], vr[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const int idx = tid + (i0 + i) * kThreads;
        const int tok = idx / PER_TOKEN, key = k0 + tok;
        if ((TOTAL % kThreads == 0 || idx < TOTAL) && key < k_end) {
          const long long off = key * kv_stride + (idx % PER_TOKEN) * VEC;
          kr[i] = __ldg(reinterpret_cast<const float4*>(kb + off));
          vr[i] = __ldg(reinterpret_cast<const float4*>(vb + off));
        } else {
          kr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          vr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const int idx = tid + (i0 + i) * kThreads;
        if (TOTAL % kThreads != 0 && idx >= TOTAL) continue;
        const int tok = idx / PER_TOKEN, d0 = (idx % PER_TOKEN) * VEC;
        *reinterpret_cast<float4*>(ks + tok * KS + d0) = kr[i];
        *reinterpret_cast<float4*>(vs + tok * HD + d0) = vr[i];
      }
    }
    __syncthreads();
    // warp-uniform: a chunk that none of this warp's rows sees
    if (!warp_live || (causal && k0 > wq_hi) ||
        (window > 0 && k0 + kChunk - 1 <= wq_lo - window))
      continue;

    const int key = k0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(ks + lane * KS);
    const float4* q4 = reinterpret_cast<const float4*>(
        qs + warp * kRowsPerWarp * HD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qq = q4[rr * (HD / 4) + d4];   // broadcast
        s[rr] = fmaf(qq.x, kk.x, s[rr]);
        s[rr] = fmaf(qq.y, kk.y, s[rr]);
        s[rr] = fmaf(qq.z, kk.z, s[rr]);
        s[rr] = fmaf(qq.w, kk.w, s[rr]);
      }
    }

    float p[kRowsPerWarp], alpha[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int gr = wr0 + rr;
      const int qi = gr / G;
      const bool ok = gr < row_end && key < k_end &&
                      (!causal || key <= qi) &&
                      (window <= 0 || key > qi - window);
      const float sc = ok ? s[rr] * scale : -INFINITY;
      const float m_new = fmaxf(m[rr], rt::warp_max(sc));
      if (m_new == -INFINITY) {   // no visible key yet (warp-uniform)
        p[rr] = 0.f;
        alpha[rr] = 1.f;
        continue;
      }
      alpha[rr] = expf(m[rr] - m_new);
      p[rr] = ok ? expf(sc - m_new) : 0.f;
      l[rr] = l[rr] * alpha[rr] + rt::warp_sum(p[rr]);
      m[rr] = m_new;
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) acc[rr][j] *= alpha[rr];
#pragma unroll 4
    for (int tk = 0; tk < kChunk; ++tk) {
      float vv[PER_LANE];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        vv[j] = rt::lane_col<HD>(lane, j) ? vs[tk * HD + lane + 32 * j] : 0.f;
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pt = __shfl_sync(0xffffffffu, p[rr], tk);
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j)
          acc[rr][j] = fmaf(pt, vv[j], acc[rr][j]);
      }
    }
  }

  // rows without a key take the mean of v (vs is free: reuse it)
  const int empty_from = Sk + window - 1;
  if (window > 0 && q_hi >= empty_from) {   // CTA-uniform
    __syncthreads();
    v_mean<float, HD, kThreads>(vb, kv_stride, Sk, vs);
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int gr = wr0 + rr;
    if (gr >= row_end) continue;
    const int qi = gr / G, head = kv * G + gr % G;
    float* o = out + (((long long)b * Sq + qi) * H + head) * HD;
    if (window > 0 && qi >= empty_from) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (rt::lane_col<HD>(lane, j)) o[lane + 32 * j] = vs[lane + 32 * j];
      continue;
    }
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (rt::lane_col<HD>(lane, j)) o[lane + 32 * j] = acc[rr][j] * inv;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int causal,
                   int window, float scale, cudaStream_t stream) {
  const int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (Sq * (H / KV) + Rows<HD>::kCta - 1) / Rows<HD>::kCta;
  flash_attention_f32<HD><<<tiles * KV * B, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), B, Sq, Sk, H,
      KV, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int B, int Sq,
                                  int Sk, int H, int KV, int hd, int causal,
                                  int window, float scale, int dtype,
                                  void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return f32::launch<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dtype == 0 && hd == 120)
    return f32::launch<120>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dtype == 0 && hd == 128)
    return f32::launch<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dtype == 0 && hd == 256)
    return f32::launch<256>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dtype == 1 && hd == 64)
    return tc::launch<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dtype == 1 && hd == 120)
    return tc::launch<120>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dtype == 1 && hd == 128)
    return tc::launch<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dtype == 1 && hd == 256)
    return tc::launch<256>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
