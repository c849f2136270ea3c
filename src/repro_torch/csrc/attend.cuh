// Body of the float32 decode-attention kernels (flash_decode.cu's f32
// templates: paged, contiguous and view) and combine_splits, the split
// merge every decode and MLA template shares: masked online-softmax
// attention of a tile of query rows against the keys of one (row, kv
// head), in f32 on CUDA cores.  The bfloat16 kernels run on tensor cores
// (flash_decode.cu's flash_decode_tc, mla_decode.cu's mla_attend_tc).
//
// One CTA = one (row b, kv head, tile of kTileRows query rows, key
// split).  The C*G query rows that share a kv head (C queries per row
// times G heads per kv head, row index = c*G + g) are cut into tiles of
// 8; decode has one tile (G <= 8), a prefill chunk of C queries has
// ceil(C*G/8).  The keys the tile can see are cut into `nsplit` equal
// ranges, one per CTA, so that a decode step with few rows still puts
// enough CTAs on the card (split-K, "flash decoding"); with nsplit > 1
// each CTA writes its unnormalised partial (m, l, acc) and a second
// kernel (combine_splits) merges them.
//
// Inside a CTA the keys go in chunks of 32 (one key per lane): the
// chunk's K and V rows are read with 16-byte vector loads, up to 8 a
// thread issued before any is stored, into shared memory as f32; each
// lane scores its key against the tile's queries, and each warp keeps
// m/l/acc of its 2 query rows in registers, each lane owning columns
// lane, lane + 32, ... of the accumulator (at hd 120 the last of its
// four exists for lanes 0-23 only: lane_col).  Keys past the last position any query of the tile
// sees are never read; with a window, keys before the first visible one
// are skipped too.  The tile's q, k and v live in dynamic shared memory
// (attend_smem_bytes: 73,856 bytes at hd 256, past the 48 KB a kernel
// may declare statically), which each launcher allows once a process.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kChunk = 32;

// dynamic shared memory of attend_tile: q (kTileRows, HD), k (kChunk,
// HD + 1), v (kChunk, HD), f32
template <int HD>
constexpr int attend_smem_bytes() {
  return (kTileRows * HD + kChunk * (HD + 1) + kChunk * HD) *
         (int)sizeof(float);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Columns of a head dim over a warp: lane owns lane + 32 * j for j <
// lane_cols(HD); lane_col says whether that column exists (at a head dim
// that is no multiple of 32, as 120, the last j is partial).
template <int HD>
__host__ __device__ constexpr int lane_cols() { return (HD + 31) / 32; }
template <int HD>
__device__ __forceinline__ bool lane_col(int lane, int j) {
  return HD % 32 == 0 || lane + 32 * j < HD;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Element offset of key position t of kv head kv, row b, in a paged pool
// (nb, bs, KV, HD): the logical block t / bs is routed through the row's
// block table — what the TPU kernel's scalar prefetch did.
struct PagedKeys {
  const int* bt;
  int nb_seq, bs, kv_heads, hd;
  __device__ __forceinline__ long long offset(int b, int kv, int t) const {
    const int phys = bt[(long long)b * nb_seq + t / bs];
    return ((long long)phys * bs + t % bs) * kv_heads * hd + (long long)kv * hd;
  }
};

// The same for a per-row contiguous view (B, S1, KV, HD): slot t = t.
struct ViewKeys {
  int s1, kv_heads, hd;
  __device__ __forceinline__ long long offset(int b, int kv, int t) const {
    return ((long long)b * s1 + t) * kv_heads * hd + (long long)kv * hd;
  }
};

// Stage keys [k0, k0 + kChunk) ∩ [.., k_end) of K and V in shared memory
// as f32 (zeros past k_end).  The vector loads go in groups of up to 8 a
// thread (one group up to hd 128 in f32), each issued whole before its
// first store, so their latencies overlap.  A row is HD / VEC vectors
// (30 in f32 at hd 120, 16-byte aligned at 480 bytes a row); where the
// chunk's vectors do not fill the last pass, its idle threads load none.
template <typename T, int HD, typename Keys>
__device__ __forceinline__ void load_chunk(const T* __restrict__ kbuf,
                                           const T* __restrict__ vbuf,
                                           const Keys& keys, int b, int kv,
                                           int k0, int k_end,
                                           float (*ks)[HD + 1],
                                           float (*vs)[HD]) {
  constexpr int VEC = 16 / sizeof(T);           // elements per 16 bytes
  constexpr int PER_TOKEN = HD / VEC;
  constexpr int TOTAL = kChunk * PER_TOKEN;
  constexpr int N = (TOTAL + kThreads - 1) / kThreads;
  constexpr int GROUP = N < 8 ? N : 8;
  static_assert(PER_TOKEN * VEC == HD && N % GROUP == 0, "chunk tiling");
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += GROUP) {
    uint4 kr[GROUP], vr[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int idx = threadIdx.x + (i0 + i) * kThreads;
      const int t = idx / PER_TOKEN, key = k0 + t;
      if ((TOTAL % kThreads == 0 || idx < TOTAL) && key < k_end) {
        const long long off =
            keys.offset(b, kv, key) + (idx % PER_TOKEN) * VEC;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kbuf + off));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(vbuf + off));
      } else {
        kr[i] = make_uint4(0, 0, 0, 0);
        vr[i] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int idx = threadIdx.x + (i0 + i) * kThreads;
      if (TOTAL % kThreads != 0 && idx >= TOTAL) continue;
      const int t = idx / PER_TOKEN, d0 = (idx % PER_TOKEN) * VEC;
      const T* kx = reinterpret_cast<const T*>(&kr[i]);
      const T* vx = reinterpret_cast<const T*>(&vr[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ks[t][d0 + j] = to_f(kx[j]);
        vs[t][d0 + j] = to_f(vx[j]);
      }
    }
  }
}

// q, out: this row's (C, H, HD) queries / outputs.  n_keys: key
// positions addressable for this row (NB*bs, or the view length).
// part_acc (rows, nsplit, HD) and part_ml (rows, nsplit, 2), indexed by
// the row's flat output row (b*C*H + c*H + head), take the partial
// results when nsplit > 1.
template <typename T, int HD, typename Keys>
__device__ void attend_tile(const T* __restrict__ q, const T* __restrict__ kbuf,
                            const T* __restrict__ vbuf, T* __restrict__ out,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_ml, const Keys keys,
                            int b, int kv, int C, int H, int G, int row0,
                            int split, int nsplit, int pos, int n_keys,
                            int window, float scale) {
  constexpr int PER_LANE = lane_cols<HD>();
  extern __shared__ float attend_smem[];   // attend_smem_bytes<HD>()
  float(*qs)[HD] = reinterpret_cast<float(*)[HD]>(attend_smem);
  // +1: lane-per-key reads hit distinct banks
  float(*ks)[HD + 1] =
      reinterpret_cast<float(*)[HD + 1]>(attend_smem + kTileRows * HD);
  float(*vs)[HD] = reinterpret_cast<float(*)[HD]>(
      attend_smem + kTileRows * HD + kChunk * (HD + 1));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_rows = C * G;
  const int row_end = min(row0 + kTileRows, n_rows);

  for (int i = tid; i < kTileRows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, gr = row0 + r;
    float x = 0.f;
    if (gr < n_rows) {
      const int c = gr / G, head = kv * G + gr % G;
      x = to_f(q[((long long)c * H + head) * HD + d]);
    }
    qs[r][d] = x;
  }

  // keys any query of the tile can see: [k_begin, k_end), then this
  // CTA's share of them
  const int c_lo = row0 / G, c_hi = (row_end - 1) / G;
  int k_end = min(pos + c_hi, n_keys - 1) + 1;
  int k_begin = window > 0 ? max(0, pos + c_lo - window + 1) : 0;
  if (nsplit > 1) {
    const int span = max(k_end - k_begin, 0);
    const int per = ((span + nsplit - 1) / nsplit + kChunk - 1) / kChunk * kChunk;
    k_begin += split * per;
    k_end = min(k_end, k_begin + per);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][PER_LANE];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) acc[rr][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    __syncthreads();  // previous chunk consumed (and qs written, first time)
    load_chunk<T, HD>(kbuf, vbuf, keys, b, kv, k0, k_end, ks, vs);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr, gr = row0 + r;
      if (gr >= row_end) continue;  // warp-uniform
      const int qpos = pos + gr / G;
      const int key = k0 + lane;
      const bool ok = key < k_end && key <= qpos &&
                      (window <= 0 || key > qpos - window);
      float s = -INFINITY;
      if (ok) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qs[r][d], ks[lane][d], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m[rr], warp_max(s));
      if (m_new == -INFINITY) continue;  // no visible key yet (warp-uniform)
      const float alpha = expf(m[rr] - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) acc[rr][j] *= alpha;
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j)
          if (lane_col<HD>(lane, j))
            acc[rr][j] = fmaf(pt, vs[t][lane + 32 * j], acc[rr][j]);
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int gr = row0 + warp * kRowsPerWarp + rr;
    if (gr >= row_end) continue;
    const int c = gr / G, head = kv * G + gr % G;
    if (nsplit > 1) {
      const long long prow =
          ((long long)b * C * H + (long long)c * H + head) * nsplit + split;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (lane_col<HD>(lane, j))
          part_acc[prow * HD + lane + 32 * j] = acc[rr][j];
      if (lane == 0) {
        part_ml[prow * 2] = m[rr];
        part_ml[prow * 2 + 1] = l[rr];
      }
      continue;
    }
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    T* o = out + ((long long)c * H + head) * HD;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (lane_col<HD>(lane, j)) o[lane + 32 * j] = from_f<T>(acc[rr][j] * inv);
  }
}

// Merge the nsplit partial results of each output row (one warp per
// row): out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
combine_splits(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, T* __restrict__ out,
               int rows, int nsplit) {
  constexpr int PER_LANE = lane_cols<HD>();
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part_ml + (long long)row * nsplit * 2;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ml[2 * s]);
  float acc[PER_LANE], l = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) acc[j] = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < nsplit; ++s) {
      const float ms = ml[2 * s];
      if (ms == -INFINITY) continue;  // a split that saw no key
      const float w = expf(ms - mx);
      l += w * ml[2 * s + 1];
      const float* a = part_acc + ((long long)row * nsplit + s) * HD;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (lane_col<HD>(lane, j)) acc[j] = fmaf(w, a[lane + 32 * j], acc[j]);
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    if (lane_col<HD>(lane, j))
      out[(long long)row * HD + lane + 32 * j] = from_f<T>(acc[j] * inv);
}

}  // namespace rt
