// Mamba-2 SSD intra-chunk block (arXiv:2405.21060).  Replaces the Pallas
// kernel repro/kernels/ssd_chunk.py ssd_chunk_bchp.
//
// Per chunk c of length l and head h, with da = the within-chunk cumsum
// of dt * A:
//   y[i, :]   = sum_{j <= i} (C_i . B_j) exp(da_i - da_j) (x_j dt_j)[:]
//   st[n, :]  = sum_j B_j[n] exp(da_{l-1} - da_j) dt_j x_j[:]
// x (bc, l, h, p), B and C (bc, l, h, n) in float32 or bfloat16, dt and
// da (bc, l, h) float32 -> y (bc, l, h, p) in x's dtype, st (bc, h, n, p)
// float32.  Everything is summed in float32.
//
// Bound: at full width (l 256, p 64, n 128, bf16) the block moves about
// 15 MB per two chunks of 32 heads and does about 1.1 GFLOP, so the
// card's memory rate bounds it (the bf16 tensor cores would finish the
// products in a fifth of the time).  The TPU kernel holds the whole (l,
// l) score tile in VMEM; on Hopper a 256 x 256 f32 tile (256 KB) does not
// fit a block's shared memory, so each CTA owns one tile of query rows of
// one (chunk, head) and walks the key tiles j <= i, or owns a slice of
// the chunk states' rows of n and walks every key.
//
// bfloat16: tensor cores (ssd_chunk_tc<NP, PP>, n padded to NP = 64, 128 or
// 256 and p to PP = 64 or 128, the padding zero-filled). A CTA is 4 warps. The
// (chunk, head) pairs are the grid's x, so every pair's heaviest work launches
// first: its state CTAs (64 rows of n each, all l keys), then its query tiles
// from the last (64 rows, 16 a warp: one m16n8k16 A tile) down. A query tile
// copies its C rows to shared memory once and moves them by ldmatrix into A
// fragments that stay in registers (where they fit beside the y accumulators,
// NP * PP <= 128 x 64; wider tiles reload them a k-step pair at a time, which
// keeps every template free of spills); B and x come in 64-key tiles through a
// 2-stage ring of XOR-swizzled shared memory filled by 16-byte cp.async copies
// (rows that are not 16-byte aligned, n = 20 say, by 2-byte loads), the next
// tile's copy overlapping this tile's products. S = C B^T is mma.sync bf16 ->
// f32 (each product exact, the sum f32); the mask j <= i, exp(da_i - da_j) and
// dt_j are applied to S in f32 registers (dt folded in, so that x enters the
// second product as plain bf16); the weighted scores feed M x as A fragments
// of two bf16 terms (hi = bf16(m), lo = bf16(m - hi), about 16 bits of m), as
// the flash-attention template feeds P V; y accumulates in f32 registers and
// leaves through shared memory as 16-byte rows. A state CTA reads its B
// columns as ldmatrix.trans A fragments of B^T, scales each by its key's
// exp(da_{l-1} - da_j) dt_j in f32 and splits it into hi + lo, and multiplies
// x (plain bf16) into f32 registers. Shared memory at n 128, p 64: C 16 KB + 2
// x (B 16 KB + x 8 KB) + da, dt.
//
// float32: CUDA cores (ssd_chunk_f32).  Tensor cores on f32 would be TF32
// and change the numbers against the f32 plain version.  Each CTA owns
// 32 query rows (or a slice of the states' rows of n): C_i^T and B_j^T
// tiles (k-major, so a thread reads its rows as one vector) and the 32 x
// 32 masked score tile in shared memory, the (32, p) output in registers;
// scalar FMA over register tiles (2 x 2 scores, 2 x 4 outputs, 4 x 4
// states a thread), so each shared-memory vector load feeds 4-16 FMAs.
#include <cuda_runtime.h>
#include <limits.h>

#include "mma.cuh"

namespace {

constexpr int kMaxP = 128;
constexpr int kMaxN = 256;

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;
constexpr int kTile = 32;           // query rows per CTA, keys per step
constexpr int kSP = kTile + 2;      // padded stride of the k-major tiles
constexpr int kYTiles = 2;          // (2 x 4) output tiles a thread, of y
constexpr int kStTiles = 2;         // (4 x 4) output tiles a thread, of st
constexpr int kStMax = kStTiles * kThreads * 16;  // state outputs a CTA

struct Dims {
  int l, h, p, n;
  int p4;           // p rounded up to 4 (the padded tile width)
  int q_tiles;      // CTAs of query rows per (chunk, head)
  int ns;           // state rows of n per state CTA (a multiple of 4)
};

__global__ void __launch_bounds__(kThreads)
ssd_chunk_f32(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ da, const float* __restrict__ B,
              const float* __restrict__ C, float* __restrict__ y,
              float* __restrict__ st, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z, tile = blockIdx.x;
  const int l = d.l, h = d.h, p = d.p, n = d.n, p4 = d.p4;
  const int l4 = (l + 3) & ~3;
  float* s_da = smem;                   // (l,)
  float* s_dt = s_da + l4;              // (l,)
  float* work = s_dt + l4;              // 16-byte aligned tiles
  for (int i = tid; i < l; i += kThreads) {
    const long long r = ((long long)bb * l + i) * h + hh;
    s_da[i] = da[r];
    s_dt[i] = dt[r];
  }
  __syncthreads();
  // row i of the (bc, l, h, f) tensors at this chunk and head
  auto at = [&](int i, int f) {
    return (((long long)bb * l + i) * h + hh) * f;
  };

  if (tile < d.q_tiles) {
    // ---- y for query rows q0 .. q0 + kTile ----
    const int q0 = tile * kTile;
    float* s_ct = work;                  // (n, kSP): C^T of the query rows
    float* s_bt = s_ct + n * kSP;        // (n, kSP): B^T of the key rows
    float* s_x = s_bt + n * kSP;         // (kTile, p4): x * dt of the keys
    float* s_mt = s_x + kTile * p4;      // (kTile, kSP): masked scores^T
    for (int e = tid; e < kTile * n; e += kThreads) {
      const int i = e / n, k = e % n;
      s_ct[k * kSP + i] = q0 + i < l ? C[at(q0 + i, n) + k] : 0.0f;
    }
    // the (2 x 2) score tile of this thread: query rows si, si + 1 and
    // keys sj, sj + 1 of the key tile
    const int si = (tid % 16) * 2, sj = (tid / 16) * 2;
    float acc[kYTiles][8];
#pragma unroll
    for (int t = 0; t < kYTiles; ++t)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[t][k] = 0.0f;
    const int y_tiles = (kTile / 2) * (p4 / 4);
    for (int j0 = 0; j0 <= q0 && j0 < l; j0 += kTile) {
      __syncthreads();                   // the previous tile is consumed
      for (int e = tid; e < kTile * n; e += kThreads) {
        const int j = e / n, k = e % n;
        s_bt[k * kSP + j] = j0 + j < l ? B[at(j0 + j, n) + k] : 0.0f;
      }
      for (int e = tid; e < kTile * p4; e += kThreads) {
        const int j = e / p4, c = e % p4;
        s_x[e] = (j0 + j < l && c < p)
                     ? __fmul_rn(x[at(j0 + j, p) + c], s_dt[j0 + j])
                     : 0.0f;
      }
      __syncthreads();
      // masked scores: (C_i . B_j) * exp(da_i - da_j) for j <= i, else 0
      float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float2 c =
            *reinterpret_cast<const float2*>(s_ct + k * kSP + si);
        const float2 b =
            *reinterpret_cast<const float2*>(s_bt + k * kSP + sj);
        s00 = fmaf(c.x, b.x, s00);
        s01 = fmaf(c.x, b.y, s01);
        s10 = fmaf(c.y, b.x, s10);
        s11 = fmaf(c.y, b.y, s11);
      }
      const float sv[2][2] = {{s00, s01}, {s10, s11}};
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        float m[2];
#pragma unroll
        for (int di = 0; di < 2; ++di) {
          const int qi = q0 + si + di, kj = j0 + sj + dj;
          m[di] = (qi < l && kj <= qi)
                      ? __fmul_rn(sv[di][dj], expf(s_da[qi] - s_da[kj]))
                      : 0.0f;
        }
        *reinterpret_cast<float2*>(s_mt + (sj + dj) * kSP + si) =
            make_float2(m[0], m[1]);
      }
      __syncthreads();
      // y += M x_dt over the (2 x 4) output tiles of this thread
#pragma unroll
      for (int t = 0; t < kYTiles; ++t) {
        const int mt = tid + t * kThreads;
        if (mt < y_tiles) {
          const int i0 = (mt % 16) * 2, c0 = (mt / 16) * 4;
          float* a = acc[t];
#pragma unroll 8
          for (int j = 0; j < kTile; ++j) {
            const float2 m =
                *reinterpret_cast<const float2*>(s_mt + j * kSP + i0);
            const float4 v =
                *reinterpret_cast<const float4*>(s_x + j * p4 + c0);
            a[0] = fmaf(m.x, v.x, a[0]);
            a[1] = fmaf(m.x, v.y, a[1]);
            a[2] = fmaf(m.x, v.z, a[2]);
            a[3] = fmaf(m.x, v.w, a[3]);
            a[4] = fmaf(m.y, v.x, a[4]);
            a[5] = fmaf(m.y, v.y, a[5]);
            a[6] = fmaf(m.y, v.z, a[6]);
            a[7] = fmaf(m.y, v.w, a[7]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kYTiles; ++t) {
      const int mt = tid + t * kThreads;
      if (mt < y_tiles) {
        const int i0 = (mt % 16) * 2, c0 = (mt / 16) * 4;
#pragma unroll
        for (int di = 0; di < 2; ++di)
#pragma unroll
          for (int dc = 0; dc < 4; ++dc)
            if (q0 + i0 + di < l && c0 + dc < p)
              y[at(q0 + i0 + di, p) + c0 + dc] = acc[t][di * 4 + dc];
      }
    }
    return;
  }

  // ---- chunk states for rows n0 .. n0 + ns of n ----
  const int n0 = (tile - d.q_tiles) * d.ns;
  const int ns = min(d.ns, n - n0);          // real rows of this slice
  const int ns4 = (ns + 3) & ~3;
  const float da_last = s_da[l - 1];
  float* s_bd = work;                 // (kTile, ns4): B * decay-to-end * dt
  float* s_x = s_bd + kTile * d.ns;   // (kTile, p4)
  const int rgroups = ns4 / 4;
  const int st_tiles = rgroups * (p4 / 4);
  float acc[kStTiles][16];
#pragma unroll
  for (int t = 0; t < kStTiles; ++t)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[t][k] = 0.0f;
  for (int j0 = 0; j0 < l; j0 += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * ns4; e += kThreads) {
      const int j = e / ns4, r = e % ns4;
      float v = 0.0f;
      if (j0 + j < l && r < ns) {
        const float dte =
            __fmul_rn(expf(da_last - s_da[j0 + j]), s_dt[j0 + j]);
        v = __fmul_rn(B[at(j0 + j, n) + n0 + r], dte);
      }
      s_bd[e] = v;
    }
    for (int e = tid; e < kTile * p4; e += kThreads) {
      const int j = e / p4, c = e % p4;
      s_x[e] = (j0 + j < l && c < p) ? x[at(j0 + j, p) + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kStTiles; ++t) {
      const int mt = tid + t * kThreads;
      if (mt < st_tiles) {
        const int r0 = (mt % rgroups) * 4, c0 = (mt / rgroups) * 4;
        float* a = acc[t];
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          const float4 b =
              *reinterpret_cast<const float4*>(s_bd + j * ns4 + r0);
          const float4 v =
              *reinterpret_cast<const float4*>(s_x + j * p4 + c0);
          const float bv[4] = {b.x, b.y, b.z, b.w};
          const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int dr = 0; dr < 4; ++dr)
#pragma unroll
            for (int dc = 0; dc < 4; ++dc)
              a[dr * 4 + dc] = fmaf(bv[dr], xv[dc], a[dr * 4 + dc]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kStTiles; ++t) {
    const int mt = tid + t * kThreads;
    if (mt < st_tiles) {
      const int r0 = (mt % rgroups) * 4, c0 = (mt / rgroups) * 4;
#pragma unroll
      for (int dr = 0; dr < 4; ++dr)
#pragma unroll
        for (int dc = 0; dc < 4; ++dc)
          if (r0 + dr < ns && c0 + dc < p)
            st[(((long long)bb * h + hh) * n + n0 + r0 + dr) * p + c0 + dc] =
                acc[t][dr * 4 + dc];
    }
  }
}

size_t smem_bytes(const Dims& d) {
  const size_t lead = 2 * (((size_t)d.l + 3) & ~(size_t)3);   // da, dt
  const size_t y_tile = 2 * (size_t)d.n * kSP + (size_t)kTile * d.p4 +
                        (size_t)kTile * kSP;
  const size_t st_tile = (size_t)kTile * d.ns + (size_t)kTile * d.p4;
  return sizeof(float) * (lead + (y_tile > st_tile ? y_tile : st_tile));
}

int launch(const void* x, const void* dt, const void* da, const void* B,
           const void* C, void* y, void* st, int bc, const Dims& d,
           cudaStream_t s) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int st_ctas = (d.n + d.ns - 1) / d.ns;
  dim3 grid(d.q_tiles + st_ctas, d.h, bc);
  ssd_chunk_f32<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(da), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(st), d);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 on tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using namespace rt;   // the tensor-core helpers of mma.cuh
using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;   // query rows, or state rows of n, a CTA
constexpr int kKeys = 64;            // keys a tile

struct Dims {
  int l, h, p, n;
  int q_tiles;      // CTAs of kRows query rows per (chunk, head)
  int s_ctas;       // CTAs of kRows state rows of n per (chunk, head)
  int vec_x;        // x and y rows 16-byte aligned (p % 8 == 0)
  int vec_bc;       // B and C rows 16-byte aligned (n % 8 == 0)
};

// Rows [r0, r0 + kRows) and columns [c0, c0 + W) of one (chunk, head)'s
// slice of a (bc, l, h, f) tensor (src: its row 0, column 0; `stride`
// elements between rows) into a swizzled bf16 tile of W columns; rows at
// or past `rows` and columns at or past `cols` are zero.  vec: 16-byte
// cp.async copies (cols and c0 multiples of 8); else 2-byte loads, stored
// 16 bytes at a time.  kSlim: the copies unrolled by 4, not fully, so
// that their addresses leave the widest template's accumulators their
// registers (<256, 128> spilled fully unrolled; <256, 64> spilled
// unrolled by 4).
template <int W, bool kSlim = false>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int rows,
                                          int c0, int cols, bool vec) {
  constexpr int CH = W / 8;
  constexpr int N = kRows * CH / kThreads;   // 16-byte chunks a thread
  static_assert(N * kThreads == kRows * CH, "tile tiling");
  auto chunk = [&](int it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / CH, c = idx % CH, row = r0 + r, col = c0 + c * 8;
    const bf16* s = src + (long long)row * stride + col;
    if (vec) {
      const bool ok = row < rows && col < cols;
      cp_async16(smem_u32(dst + swz<W>(r, c)), ok ? s : src, ok);
    } else {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(s);
      alignas(16) unsigned short v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = row < rows && col + e < cols ? s16[e] : 0;
      *reinterpret_cast<uint4*>(dst + swz<W>(r, c)) =
          *reinterpret_cast<const uint4*>(v);
    }
  };
  if constexpr (kSlim) {
#pragma unroll 4
    for (int it = 0; it < N; ++it) chunk(it);
  } else {
#pragma unroll
    for (int it = 0; it < N; ++it) chunk(it);
  }
}

template <int NP, int PP>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ da, const bf16* __restrict__ B,
             const bf16* __restrict__ C, bf16* __restrict__ y,
             float* __restrict__ st, Dims d) {
  constexpr int NT = kKeys / 8;      // n-tiles of S
  constexpr int OT = PP / 8;         // n-tiles of y and of the states
  extern __shared__ __align__(128) unsigned char smem[];
  const int l = d.l, h = d.h, p = d.p, n = d.n;
  const int l64 = (l + kKeys - 1) / kKeys * kKeys;
  const int bb = blockIdx.x / h, hh = blockIdx.x % h, u = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // (bb, 0, hh) in the (bc, l, h) layout: key j's row is r0 + j * h
  const long long r0 = (long long)bb * l * h + hh;
  const bf16* xb = x + r0 * p;
  const bf16* Bb = B + r0 * n;
  const long long xstride = (long long)h * p, bstride = (long long)h * n;
  float* s_da = reinterpret_cast<float*>(smem);   // [l64]
  float* s_dt = s_da + l64;       // [l64]: dt, or a state CTA's weights
  bf16* tiles = reinterpret_cast<bf16*>(s_dt + l64);

  if (u < d.s_ctas) {
    // ---- chunk states for rows n0 .. n0 + kRows of n ----
    const int n0 = u * kRows;
    bf16* bs = tiles;                       // [2][kKeys][64]: B[:, n0:]
    bf16* xs = bs + 2 * kKeys * 64;         // [2][kKeys][PP]
    load_tile<64>(bs, Bb, bstride, 0, l, n0, n, d.vec_bc);
    load_tile<PP>(xs, xb, xstride, 0, l, 0, p, d.vec_x);
    cp_async_commit();
    // key j's weight exp(da_{l-1} - da_j) dt_j, zero past l
    const float da_last = da[r0 + (long long)(l - 1) * h];
    for (int j = tid; j < l64; j += kThreads) {
      const long long r = r0 + (long long)j * h;
      s_dt[j] = j < l ? __fmul_rn(expf(da_last - da[r]), dt[r]) : 0.0f;
    }
    float acc[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int n_tiles = l64 / kKeys;
    for (int t = 0; t < n_tiles; ++t) {
      const int sg = t & 1;
      cp_async_wait<0>();
      __syncthreads();        // tile t is in; every warp is done with t - 1
      if (t + 1 < n_tiles) {
        load_tile<64>(bs + (sg ^ 1) * kKeys * 64, Bb, bstride,
                      (t + 1) * kKeys, l, n0, n, d.vec_bc);
        load_tile<PP>(xs + (sg ^ 1) * kKeys * PP, xb, xstride,
                      (t + 1) * kKeys, l, 0, p, d.vec_x);
      }
      cp_async_commit();
      const bf16* bst = bs + sg * kKeys * 64;
      const bf16* xst = xs + sg * kKeys * PP;
      const float* w = s_dt + t * kKeys;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        // A = (B w)^T: this warp's 16 rows of n x 16 keys, from the
        // [key][n] tile by ldmatrix.trans; register i holds two keys
        // (k0, k0 + 1; i >= 2: k0 + 8, k0 + 9) of one row
        uint32_t a[4], ah[4], al[4];
        ldsm_x4_t(smem_u32(bst + swz<64>(16 * kk + (lane & 7) +
                                             ((lane >> 4) << 3),
                                         warp * 2 + ((lane >> 3) & 1))),
                  a);
        const int k0 = 16 * kk + (lane & 3) * 2;
        const float2 w0 = *reinterpret_cast<const float2*>(w + k0);
        const float2 w1 = *reinterpret_cast<const float2*>(w + k0 + 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 bv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&a[i]));
          const float2 wv = i < 2 ? w0 : w1;
          split2(__fmul_rn(bv.x, wv.x), __fmul_rn(bv.y, wv.y), ah[i], al[i]);
        }
#pragma unroll
        for (int jp = 0; jp < OT / 2; ++jp) {
          uint32_t vf[4];
          ldsm_x4_t(smem_u32(xst + swz<PP>(16 * kk + (lane & 15),
                                           2 * jp + (lane >> 4))),
                    vf);
          mma(acc[2 * jp], ah, vf[0], vf[1]);
          mma(acc[2 * jp], al, vf[0], vf[1]);
          mma(acc[2 * jp + 1], ah, vf[2], vf[3]);
          mma(acc[2 * jp + 1], al, vf[2], vf[3]);
        }
      }
    }
    cp_async_wait<0>();
    float* sb = st + ((long long)bb * h + hh) * n * p;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int nr = n0 + warp * 16 + (lane >> 2) + 8 * r;
      if (nr >= n) continue;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        if (col < p) sb[(long long)nr * p + col] = acc[j][2 * r];
        if (col + 1 < p) sb[(long long)nr * p + col + 1] = acc[j][2 * r + 1];
      }
    }
    return;
  }

  // ---- y for query rows q0 .. q0 + kRows: the last tile first ----
  const int q = d.q_tiles - 1 - (u - d.s_ctas);
  const int q0 = q * kRows;
  bf16* cs = tiles;                   // [kRows][NP]
  bf16* bs = cs + kRows * NP;         // [2][kKeys][NP]
  bf16* xs = bs + 2 * kKeys * NP;     // [2][kKeys][PP]
  constexpr bool kSlim = NP * PP > 128 * 128;
  load_tile<NP, kSlim>(cs, C + r0 * n, bstride, q0, l, 0, n, d.vec_bc);
  load_tile<NP, kSlim>(bs, Bb, bstride, 0, l, 0, n, d.vec_bc);
  load_tile<PP>(xs, xb, xstride, 0, l, 0, p, d.vec_x);
  cp_async_commit();
  // da and dt of keys [0, q0 + kRows) (the tile's rows among them), zero
  // past l
  for (int j = tid; j < q0 + kRows; j += kThreads) {
    const long long r = r0 + (long long)j * h;
    s_da[j] = j < l ? da[r] : 0.0f;
    s_dt[j] = j < l ? dt[r] : 0.0f;
  }
  // this thread's two rows of the warp's 16: lane / 4 and lane / 4 + 8;
  // a key j is kept for row i when j <= last[i] (-1 for rows past l)
  const int wrow = warp * 16 + (lane >> 2);
  int last[2];
  float da_i[2];
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + wrow + 8 * r;
    last[r] = i < l ? i : -1;
    da_i[r] = s_da[i];
  }
  // the warp's C rows as the A fragment of k-step ks (16 columns of n)
  auto c_frag = [&](int ks, uint32_t (&a)[4]) {
    ldsm_x4(smem_u32(cs + swz<NP>(warp * 16 + (lane & 15),
                                  2 * ks + (lane >> 4))),
            a);
  };
  // held in registers for the whole key loop where they fit beside the
  // y accumulators (at most n 128 with p 64); else reloaded a k-step pair
  // at a time
  constexpr bool kHoldC = NP * PP <= 128 * 64;
  uint32_t cf[kHoldC ? NP / 16 : 1][4];
  if constexpr (kHoldC) {
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks) c_frag(ks, cf[ks]);
  }
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = 0; t <= q; ++t) {
    const int sg = t & 1;
    if (t > 0) {
      cp_async_wait<0>();
      __syncthreads();        // tile t is in; every warp is done with t - 1
    }
    if (t < q) {
      load_tile<NP, kSlim>(bs + (sg ^ 1) * kKeys * NP, Bb, bstride,
                           (t + 1) * kKeys, l, 0, n, d.vec_bc);
      load_tile<PP>(xs + (sg ^ 1) * kKeys * PP, xb, xstride, (t + 1) * kKeys,
                    l, 0, p, d.vec_x);
    }
    cp_async_commit();
    const bf16* bst = bs + sg * kKeys * NP;
    const bf16* xst = xs + sg * kKeys * PP;

    // S = C B^T: 16 rows x 64 keys a warp, two k-steps (32 columns of n)
    // a kp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    auto s_pair = [&](int kp, const uint32_t (&a0)[4],
                      const uint32_t (&a1)[4]) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t kf[4];
        ldsm_x4(smem_u32(bst + swz<NP>(j * 8 + (lane & 7),
                                       4 * kp + (lane >> 3))),
                kf);
        mma(s[j], a0, kf[0], kf[1]);
        mma(s[j], a1, kf[2], kf[3]);
      }
    };
    if constexpr (kHoldC) {
#pragma unroll
      for (int kp = 0; kp < NP / 32; ++kp)
        s_pair(kp, cf[2 * kp], cf[2 * kp + 1]);
    } else {
#pragma unroll 1
      for (int kp = 0; kp < NP / 32; ++kp) {
        uint32_t a0[4], a1[4];
        c_frag(2 * kp, a0);
        c_frag(2 * kp + 1, a1);
        s_pair(kp, a0, a1);
      }
    }
    // M = S exp(da_i - da_j) dt_j for keys j <= i, else 0
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * kKeys + j * 8 + (lane & 3) * 2 + (e & 1);
        const int r = e >> 1;
        s[j][e] = key <= last[r]
                      ? __fmul_rn(s[j][e], __fmul_rn(expf(da_i[r] - s_da[key]),
                                                     s_dt[key]))
                      : 0.0f;
      }
    // y += M x, M from the S accumulators as A fragments (hi + lo)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t mh[4], ml[4];
      split2(s[2 * kk][0], s[2 * kk][1], mh[0], ml[0]);
      split2(s[2 * kk][2], s[2 * kk][3], mh[1], ml[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], mh[2], ml[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], mh[3], ml[3]);
#pragma unroll
      for (int jp = 0; jp < OT / 2; ++jp) {
        uint32_t vf[4];
        ldsm_x4_t(smem_u32(xst + swz<PP>(16 * kk + (lane & 15),
                                         2 * jp + (lane >> 4))),
                  vf);
        mma(o[2 * jp], mh, vf[0], vf[1]);
        mma(o[2 * jp], ml, vf[0], vf[1]);
        mma(o[2 * jp + 1], mh, vf[2], vf[3]);
        mma(o[2 * jp + 1], ml, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // every warp is done with the tiles

  // y -> the warp's own 16 rows of stage 0 of x -> device memory
  bf16* os = xs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = wrow + 8 * r;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(os + swz<PP>(rr, j) +
                                         (lane & 3) * 2) =
          __floats2bfloat162_rn(o[j][2 * r], o[j][2 * r + 1]);
  }
  __syncwarp();
  bf16* yb = y + r0 * p;
  for (int idx = lane; idx < 16 * OT; idx += 32) {
    const int rr = warp * 16 + idx / OT, c = idx % OT, row = q0 + rr;
    if (row >= l || c * 8 >= p) continue;
    bf16* dst = yb + (long long)row * xstride + c * 8;
    const bf16* src = os + swz<PP>(rr, c);
    if (d.vec_x) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c * 8 + e < p; ++e) dst[e] = src[e];
    }
  }
}

template <int NP, int PP>
cudaError_t launch(const void* x, const void* dt, const void* da,
                   const void* B, const void* C, void* y, void* st, int bc,
                   const Dims& d, cudaStream_t s) {
  const int l64 = (d.l + kKeys - 1) / kKeys * kKeys;
  const int bytes = 2 * l64 * (int)sizeof(float) +
                    (kRows * NP + 2 * kKeys * (NP + PP)) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tc<NP, PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bc * d.h, d.s_ctas + d.q_tiles);
  ssd_chunk_tc<NP, PP><<<grid, kThreads, bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(da), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<bf16*>(y),
      static_cast<float*>(st), d);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_p(const void* x, const void* dt, const void* da,
                     const void* B, const void* C, void* y, void* st, int bc,
                     const Dims& d, cudaStream_t s) {
  return d.p <= 64 ? launch<NP, 64>(x, dt, da, B, C, y, st, bc, d, s)
                   : launch<NP, 128>(x, dt, da, B, C, y, st, bc, d, s);
}

}  // namespace tc

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores), of x, B,
// C and y.  Every tensor contiguous.  p <= 128, n <= 256, l <= 4096.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_ssd_chunk(const void* x, const void* dt, const void* da,
                            const void* B, const void* C, void* y, void* st,
                            int bc, int l, int h, int p, int n, int dtype,
                            void* stream) {
  if (bc < 1 || bc > 65535 || l < 1 || l > 4096 || h < 1 || h > 65535 ||
      p < 1 || p > kMaxP || n < 1 || n > kMaxN || dtype < 0 || dtype > 1 ||
      (long long)bc * h > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    f32::Dims d;
    d.l = l;
    d.h = h;
    d.p = p;
    d.n = n;
    d.p4 = (p + 3) & ~3;
    d.q_tiles = (l + f32::kTile - 1) / f32::kTile;
    // state rows per CTA: a multiple of 4 with ns * p4 <= kStMax
    const int cap = (f32::kStMax / d.p4) & ~3;
    d.ns = ((n + 3) & ~3) < cap ? ((n + 3) & ~3) : cap;
    return f32::launch(x, dt, da, B, C, y, st, bc, d, s);
  }
  tc::Dims d;
  d.l = l;
  d.h = h;
  d.p = p;
  d.n = n;
  d.q_tiles = (l + tc::kRows - 1) / tc::kRows;
  d.s_ctas = (n + tc::kRows - 1) / tc::kRows;
  d.vec_x = p % 8 == 0 && aligned16(x, y);
  d.vec_bc = n % 8 == 0 && aligned16(B, C);
  if (n <= 64) return tc::launch_p<64>(x, dt, da, B, C, y, st, bc, d, s);
  if (n <= 128) return tc::launch_p<128>(x, dt, da, B, C, y, st, bc, d, s);
  return tc::launch_p<256>(x, dt, da, B, C, y, st, bc, d, s);
}
