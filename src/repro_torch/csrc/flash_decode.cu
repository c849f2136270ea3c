// Decode attention over K/V caches, three entry points:
//
// rt_flash_decode_paged: decode / prefill-chunk attention over shared
// K/V block pools.  Replaces the Pallas kernel
// repro/kernels/flash_decode.py flash_decode_paged_bhd.
//
// q (B, C, H, HD), pools (nb, bs, KV, HD), block_tables (B, NB) int32,
// pos (B,) int32 -> out (B, C, H, HD).  Query c of row b sits at
// position pos[b] + c and sees keys kpos <= pos[b] + c (and
// kpos > pos[b] + c - window when window > 0).  Pools are read in place
// at any head dim the kernel is built for (64, 120, 128, 256): nothing is
// padded, and the scale comes from the caller (1/sqrt(true hd)).
//
// rt_flash_decode: one query token per row over a contiguous cache.
// Replaces the Pallas kernel repro/kernels/flash_decode.py
// flash_decode_bhd.  q (B, H, HD), k/v (B, S, KV, HD), length: an int32
// scalar in device memory, the number of valid slots shared by every
// row (slot j is visible when j < length; a ring cache past its end has
// length > S and every slot visible).  The kernel reads length itself,
// so a decode step needs no host read of the position.  The cache is
// addressed as a per-row view (attend.cuh's ViewKeys: slot t of row b
// at (b*S + t)*KV*HD), the query as position length - 1 against keys
// up to it.
//
// rt_decode_view_attend: one query token per row over the N-step loop's
// per-row views.  Replaces the Pallas kernel
// repro/kernels/decode_view.py decode_view_attend_bhd.  q (B, H, HD),
// views (B, S1, KV, HD) with slot j = position j (slot S1 - 1 is the
// trash slot inactive rows write to), pos (B,) int32.  Row b sees slots
// j <= pos[b] (and j > pos[b] - window when window > 0): kernel 1's
// arithmetic with one query a row, over ViewKeys addressing, so on the
// same keys as a view and as a pool, split alike, the two agree bit for
// bit.
//
// All three pack the C*G query rows that share a kv head (G = H/KV) as row
// c*G + g, at position pos + row / G, so one staged K/V chunk serves
// all G heads.  With nsplit > 1 the keys a tile sees are cut into
// nsplit ranges, one a CTA, whose partial (m, l, acc) combine_splits
// (attend.cuh) merges in split order.
//
// bfloat16: tensor cores (flash_decode_tc).  4 warps; the MMA's rows
// are the query rows.  Two layouts, chosen from C*G alone:
//   wide (C*G > 16: prefill chunks): 64 rows a CTA, 16 a warp (one
//     m16n8k16 A tile), every warp over the whole 64-key chunk, as
//     flash_attention.cu's flash_attention_tc.  At qwen2's prefill chunk
//     (C = 128, G = 6) a (row, kv head) is 12 tiles, so its K/V is
//     read 12 times (96 with 8-row CUDA-core tiles).
//   narrow (C*G <= 16: decode and mixed steps, every call of the view
//     and contiguous entry points): one 16-row tile (G = 6
//     real rows, the rest read zeros and are not stored); each warp
//     scores its own 16 keys of every chunk and keeps its own (m, l, O);
//     at the end the warps merge through shared memory, in warp order.
// Q is copied once (cp.async, issued before the position is read) into
// XOR-swizzled shared memory and moved by ldmatrix into A fragments held
// for the whole key loop up to hd 128.  K and V go in 64-key chunks
// through a 2-stage
// cp.async ring of bf16 in swizzled shared memory (nothing converted to
// f32 there), each 16-byte piece of a paged key routed through the block
// table; keys past the CTA's last are zero-filled by the copy, never
// read, and masked.  Chunk n+1's K is issued before chunk n's Q·Kᵀ and
// its V before chunk n's P·V.  S = Q·Kᵀ and P·V are mma.sync bf16 ->
// f32; softmax runs online in f32 in log2 units (exp2f), P enters P·V as
// bf16 hi + lo (split2: one bf16 P errs up to 2^-8 of a term, beyond the
// one-ulp tolerance on rows that see few keys).  A split's m leaves in
// natural-log units, as combine_splits expects.  Merging the splits in
// the kernel instead (the last CTA of a tile to finish, by an atomic
// ticket) measured slower on the H100: one CTA's serial pass over the
// partials took longer than the second launch.
//
// Head dim 256 (recurrentgemma's MQA, G = 10): O alone is 128 f32
// registers a thread, so Q's A fragments are not held across the key
// loop but read from shared memory by ldmatrix at each k-step (64
// registers fewer, one more ldmatrix a K one); and the wide layout
// stages 32-key chunks, (64 + 4 x 32) x 256 x 2 = 96 KB, so two CTAs
// still share an SM.  The narrow layout keeps 64-key chunks (16 keys a
// warp is one m16n8k16 k-step of P·V): (16 + 4 x 64) x 256 x 2 = 136 KB,
// one CTA an SM.
//
// Head dim 120 (h2o-danube-3's GQA, G = 4): rows are 240 bytes apart in
// bf16, so 15 16-byte copies tile one in place.  The shared layout is
// hd 128's (rt::smem_hd): the 16th chunk of every staged Q, K and V row
// is zero-filled by the copy, never read from device memory, so the last
// k-step of Q·Kᵀ adds zeros; P·V runs 15 n8 tiles of O (the last
// ldmatrix pair's second tile is the zero chunk, no MMA issued for it)
// and only 120 columns are stored.  No pad of the pools or of q.
//
// float32: CUDA cores (attend.cuh's attend_tile, 8 rows a CTA, one
// kernel per entry point); tensor cores would be TF32 and change the
// numbers against the f32 plain version.
#include "attend.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

template <int HD>
__global__ void __launch_bounds__(rt::kThreads)
flash_decode_paged_kernel(const float* __restrict__ q,
                          const float* __restrict__ kp,
                          const float* __restrict__ vp,
                          const int* __restrict__ bt,
                          const int* __restrict__ pos, float* __restrict__ out,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int C, int H, int KV,
                          int bs, int nb_seq, int window, float scale,
                          int nsplit) {
  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const long long row_off = (long long)b * C * H * HD;
  const rt::PagedKeys keys{bt, nb_seq, bs, KV, HD};
  rt::attend_tile<float, HD>(q + row_off, kp, vp, out + row_off, part_acc,
                             part_ml, keys, b, kv, C, H, G,
                             tile * rt::kTileRows, split, nsplit, pos[b],
                             nb_seq * bs, window, scale);
}

template <int HD>
__global__ void __launch_bounds__(rt::kThreads)
flash_decode_bhd_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ length,
                        float* __restrict__ out, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int H, int KV, int S,
                        float scale, int nsplit) {
  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int kv = blockIdx.y, b = blockIdx.z;
  const long long row_off = (long long)b * H * HD;
  const rt::ViewKeys keys{S, KV, HD};
  rt::attend_tile<float, HD>(q + row_off, k, v, out + row_off, part_acc,
                             part_ml, keys, b, kv, 1, H, H / KV,
                             tile * rt::kTileRows, split, nsplit,
                             length[0] - 1, S, 0, scale);
}

template <int HD>
__global__ void __launch_bounds__(rt::kThreads)
decode_view_kernel(const float* __restrict__ q,
                   const float* __restrict__ kview,
                   const float* __restrict__ vview,
                   const int* __restrict__ pos, float* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int H, int KV, int S1, int window, float scale,
                   int nsplit) {
  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int kv = blockIdx.y, b = blockIdx.z;
  const long long row_off = (long long)b * H * HD;
  const rt::ViewKeys keys{S1, KV, HD};
  rt::attend_tile<float, HD>(q + row_off, kview, vview, out + row_off,
                             part_acc, part_ml, keys, b, kv, 1, H, H / KV,
                             tile * rt::kTileRows, split, nsplit, pos[b], S1,
                             window, scale);
}

// After a launch: with nsplit > 1, the merge of its `rows` output rows.
template <int HD>
cudaError_t merge(void* pacc, void* pml, void* out, int rows, int nsplit,
                  cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  rt::combine_splits<float, HD><<<(rows + rt::kWarps - 1) / rt::kWarps,
                                  rt::kThreads, 0, stream>>>(
      static_cast<const float*>(pacc), static_cast<const float*>(pml),
      static_cast<float*>(out), rows, nsplit);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* bt, const void* pos, void* out, void* pacc,
                   void* pml, int B, int C, int H, int KV, int bs, int nb_seq,
                   int window, float scale, int nsplit, cudaStream_t stream) {
  constexpr int bytes = rt::attend_smem_bytes<HD>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_decode_paged_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = (C * (H / KV) + rt::kTileRows - 1) / rt::kTileRows;
  flash_decode_paged_kernel<HD><<<dim3(tiles * nsplit, KV, B), rt::kThreads,
                                  bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<float*>(pacc), static_cast<float*>(pml), C, H, KV, bs,
      nb_seq, window, scale, nsplit);
  return merge<HD>(pacc, pml, out, B * C * H, nsplit, stream);
}

template <int HD>
cudaError_t launch_bhd(const void* q, const void* k, const void* v,
                       const void* length, void* out, void* pacc, void* pml,
                       int B, int H, int KV, int S, float scale, int nsplit,
                       cudaStream_t stream) {
  constexpr int bytes = rt::attend_smem_bytes<HD>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_decode_bhd_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = (H / KV + rt::kTileRows - 1) / rt::kTileRows;
  flash_decode_bhd_kernel<HD><<<dim3(tiles * nsplit, KV, B), rt::kThreads,
                                bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(length),
      static_cast<float*>(out), static_cast<float*>(pacc),
      static_cast<float*>(pml), H, KV, S, scale, nsplit);
  return merge<HD>(pacc, pml, out, B * H, nsplit, stream);
}

template <int HD>
cudaError_t launch_view(const void* q, const void* k, const void* v,
                        const void* pos, void* out, void* pacc, void* pml,
                        int B, int H, int KV, int S1, int window, float scale,
                        int nsplit, cudaStream_t stream) {
  constexpr int bytes = rt::attend_smem_bytes<HD>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(decode_view_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = (H / KV + rt::kTileRows - 1) / rt::kTileRows;
  decode_view_kernel<HD><<<dim3(tiles * nsplit, KV, B), rt::kThreads, bytes,
                           stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(pos),
      static_cast<float*>(out), static_cast<float*>(pacc),
      static_cast<float*>(pml), H, KV, S1, window, scale, nsplit);
  return merge<HD>(pacc, pml, out, B * H, nsplit, stream);
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
constexpr int kNarrowRows = 16;           // the wrapper's NARROW_ROWS
constexpr int kWideRows = kWarps * 16;    // the wrapper's WIDE_ROWS

// query rows a CTA, keys a staged chunk (the wrapper's chunk_keys), keys
// of a chunk one warp scores, whether Q's A fragments stay in registers
// for the whole key loop (else read from shared memory at each k-step: at
// hd 256 O alone takes 128 registers a thread), and the staged rows'
// width (hd 120 staged as 128, its last chunk zeros)
template <int HD, bool NARROW>
struct Layout {
  static constexpr int kRows = NARROW ? kNarrowRows : kWideRows;
  static constexpr int kKeys = !NARROW && HD > 128 ? 32 : 64;
  static constexpr int kWarpKeys = NARROW ? kKeys / kWarps : kKeys;
  static constexpr bool kQRegs = HD <= 128;
  static constexpr int kLd = smem_hd(HD);
};

template <int HD, bool NARROW>
constexpr int smem_bytes() {   // Q, 2 x (K, V)
  using L = Layout<HD, NARROW>;
  return (L::kRows + 4 * L::kKeys) * L::kLd * (int)sizeof(bf16);
}

// The narrow layout's merge: each warp's (16, HD) f32 O, rows kLd + 8
// floats apart (a quad's float2 stores of 4 rows then hit 32 distinct
// banks), and its (m, l) per row, in the ring once every chunk is used.
template <int HD>
constexpr int merge_bytes() {
  return kWarps * 16 * ((smem_hd(HD) + 8) + 2) * (int)sizeof(float);
}
template <int HD>
constexpr bool merge_fits() {
  return merge_bytes<HD>() <= 4 * Layout<HD, true>::kKeys * smem_hd(HD) * 2;
}
static_assert(merge_fits<64>() && merge_fits<120>() && merge_fits<128>() &&
                  merge_fits<256>(),
              "the merge fits in the ring");
static_assert(2 * smem_bytes<120, true>() <= 232448 &&
                  2 * smem_bytes<120, false>() <= 232448,
              "hd 120: two CTAs an SM in either layout, as at 128");
static_assert(smem_bytes<256, true>() <= 232448 &&
                  2 * smem_bytes<256, false>() <= 232448,
              "hd 256: one narrow CTA, two wide CTAs an SM");

// Keys [k0, k0 + KEYS) of (row b, kv head kv) into a swizzled stage of
// smem_hd(HD)-wide rows, each 16-byte piece at the offset Keys gives
// (through the block table when paged); keys at and past k_end (> k0) and
// the chunks past HD (hd 120) zero-filled, never read.
template <int HD, int KEYS, typename Keys>
__device__ __forceinline__ void stage_keys(bf16* dst,
                                           const bf16* __restrict__ src,
                                           const Keys& keys, int b, int kv,
                                           int k0, int k_end) {
  constexpr int LD = smem_hd(HD), CH = LD / 8, CHG = HD / 8;
  static_assert(KEYS * CH % kThreads == 0, "chunk tiling");
#pragma unroll
  for (int it = 0; it < KEYS * CH / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / CH, c = idx % CH, key = k0 + r;
    const bool in_row = CHG == CH || c < CHG;
    const bool ok = key < k_end && in_row;
    cp_async16(smem_u32(dst + swz<LD>(r, c)),
               src + keys.offset(b, kv, key < k_end ? key : k0) +
                   (in_row ? c : 0) * 8,
               ok);
  }
}

// pos_[b * pos_stride] + pos_add: the position of row b's first query
// (paged: pos[b]; contiguous: length - 1, stride 0).  n_keys: key
// positions addressable for a row (NB*bs, or S).
template <int HD, bool NARROW, typename Keys>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_tc(const bf16* __restrict__ q, const bf16* __restrict__ kbuf,
                const bf16* __restrict__ vbuf, const Keys keys,
                const int* __restrict__ pos_, int pos_stride, int pos_add,
                bf16* __restrict__ out, float* __restrict__ part_acc,
                float* __restrict__ part_ml, int C, int H, int KV,
                int n_keys, int window, float scale_log2, int nsplit) {
  using L = Layout<HD, NARROW>;
  constexpr int ROWS = L::kRows;
  constexpr int kKeys = L::kKeys;
  constexpr int WK = L::kWarpKeys;
  constexpr int LD = L::kLd;       // staged row width (HD, or 128 at 120)
  constexpr int CH = LD / 8;       // 16-byte chunks a staged row
  constexpr int CHG = HD / 8;      // ... of them in a row in device memory
  constexpr int KSTEPS = LD / 16;  // k-steps of Q·Kᵀ
  constexpr int NT = WK / 8;       // n-tiles of a warp's S
  constexpr int OT = HD / 8;       // n-tiles of O (15 at hd 120)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [ROWS][LD], then O (wide)
  bf16* ks = qs + ROWS * LD;                  // [2][kKeys][LD]
  bf16* vs = ks + 2 * kKeys * LD;             // [2][kKeys][LD]

  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = H / KV, n_rows = C * G;
  const int row0 = tile * ROWS;
  const int row_last = min(row0 + ROWS, n_rows) - 1;
  const long long orow0 = (long long)b * C * H;   // flat row of (b, 0, 0)
  // flat output row of tile row gr
  auto out_row = [&](int gr) {
    return orow0 + (long long)(gr / G) * H + kv * G + gr % G;
  };

  // the Q tile (rows past the last zero-filled), issued before the
  // position is read; chunk 0's K joins its copy group, chunk 0's V
  // forms a second
#pragma unroll
  for (int it = 0; it < ROWS * CH / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / CH, c = idx % CH, gr = row0 + r;
    const bool in_row = CHG == CH || c < CHG;
    const bool ok = gr < n_rows && in_row;
    cp_async16(smem_u32(qs + swz<LD>(r, c)),
               q + out_row(gr < n_rows ? gr : row0) * HD + (in_row ? c : 0) * 8,
               ok);
  }

  // keys any row of the tile sees, then this CTA's share of them
  const int pos = pos_[(long long)b * pos_stride] + pos_add;
  const int q_lo = pos + row0 / G, q_hi = pos + row_last / G;
  int k_end = min(q_hi, n_keys - 1) + 1;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  if (nsplit > 1) {
    const int span = max(k_end - k_begin, 0);
    const int per = ((span + nsplit - 1) / nsplit + kKeys - 1) / kKeys * kKeys;
    k_begin += split * per;
    k_end = min(k_end, k_begin + per);
  }
  const int n_chunks =
      k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  if (n_chunks > 0)
    stage_keys<HD, kKeys>(ks, kbuf, keys, b, kv, k_begin, k_end);
  cp_async_commit();
  if (n_chunks > 0)
    stage_keys<HD, kKeys>(vs, vbuf, keys, b, kv, k_begin, k_end);
  cp_async_commit();

  // the warp's rows of the tile and keys of a chunk; this thread's two
  // rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int rbase = NARROW ? 0 : warp * 16;
  const int kbase = NARROW ? warp * WK : 0;
  const int wrow = rbase + (lane >> 2);
  const int qpos[2] = {pos + (row0 + wrow) / G, pos + (row0 + wrow + 8) / G};
  const bool live = row0 + rbase < n_rows;   // warp-uniform
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  cp_async_wait<1>();   // Q and K of chunk 0
  __syncthreads();
  // Q's A fragments: all KSTEPS held, or the two of one k-step pair
  uint32_t qf[L::kQRegs ? KSTEPS : 2][4];
  const uint32_t q_addr = smem_u32(qs + rbase * LD);
  auto load_q = [&](int s, uint32_t(&f)[4]) {
    ldsm_x4(q_addr + 2 * swz<LD>(lane & 15, 2 * s + (lane >> 4)), f);
  };
  if constexpr (L::kQRegs) {
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
      stage_keys<HD, kKeys>(ks + (st ^ 1) * kKeys * LD, kbuf, keys, b, kv,
                            k0 + kKeys, k_end);
    cp_async_commit();

    const int kw = k0 + kbase;                // the warp's first key
    const bool busy = live && kw < k_end;     // warp-uniform
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (busy) {
      // S = Q Kᵀ: 16 rows x WK keys a warp
#pragma unroll
      for (int kp = 0; kp < KSTEPS / 2; ++kp) {
        if constexpr (!L::kQRegs) {
          load_q(2 * kp, qf[0]);
          load_q(2 * kp + 1, qf[1]);
        }
        const int qa = L::kQRegs ? 2 * kp : 0;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t kf[4];
          ldsm_x4(smem_u32(kst + swz<LD>(kbase + j * 8 + (lane & 7),
                                         4 * kp + (lane >> 3))),
                  kf);
          mma(s[j], qf[qa], kf[0], kf[1]);
          mma(s[j], qf[qa + 1], kf[2], kf[3]);
        }
      }

      // scale (in log2 units), mask where the warp's keys cross the
      // CTA's last key, a row's position or a window edge
      const bool edge = kw + WK > k_end || kw + WK - 1 > q_lo ||
                        (window > 0 && kw <= q_hi - window);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int key = kw + j * 8 + (lane & 3) * 2 + (e & 1);
            const int qp = qpos[e >> 1];
            if (key >= k_end || key > qp || (window > 0 && key <= qp - window))
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
    }

    cp_async_wait<1>();   // V of chunk n (chunk n + 1's K may be in flight)
    __syncthreads();      // and every warp is done with chunk n - 1's V
    if (n + 1 < n_chunks)
      stage_keys<HD, kKeys>(vs + (st ^ 1) * kKeys * LD, vbuf, keys, b, kv,
                            k0 + kKeys, k_end);
    cp_async_commit();

    if (busy) {
      // O += P V, P from the S accumulators as A fragments (hi + lo);
      // at hd 120 the last pair's second n-tile is the zero chunk
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int jp = 0; jp < (OT + 1) / 2; ++jp) {
          uint32_t vf[4];
          ldsm_x4_t(smem_u32(vst + swz<LD>(kbase + 16 * kk + (lane & 15),
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
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  constexpr float kLn2 = 0.6931471805599453f;

  if constexpr (NARROW) {
    // the warps' (m, l, O) over their keys -> shared memory -> one row
    // result, merged in warp order
    constexpr int OLD = LD + 8;
    float* os = reinterpret_cast<float*>(ks);   // [kWarps][16][OLD]
    float* ml = os + kWarps * 16 * OLD;         // [kWarps][16][2]
    __syncthreads();                            // every warp is done with the ring
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = warp * 16 + wrow + 8 * r;
      float* dst = os + rr * OLD + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < OT; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if ((lane & 3) == 0) {
        ml[rr * 2] = m[r];
        ml[rr * 2 + 1] = l[r];
      }
    }
    __syncthreads();
    const int rows_here = min(ROWS, n_rows - row0);
    for (int idx = tid; idx < rows_here * (HD / 4); idx += kThreads) {
      const int rr = idx / (HD / 4), d = idx % (HD / 4) * 4;
      float mw[kWarps], mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        mw[w] = ml[(w * 16 + rr) * 2];
        mx = fmaxf(mx, mw[w]);
      }
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      float lsum = 0.f;
      if (mx != -INFINITY) {   // else no key of this CTA is visible
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float wt = exp2f(mw[w] - mx);   // 0 for a warp that saw none
          lsum = fmaf(wt, ml[(w * 16 + rr) * 2 + 1], lsum);
          const float4 x =
              *reinterpret_cast<const float4*>(os + (w * 16 + rr) * OLD + d);
          acc.x = fmaf(wt, x.x, acc.x);
          acc.y = fmaf(wt, x.y, acc.y);
          acc.z = fmaf(wt, x.z, acc.z);
          acc.w = fmaf(wt, x.w, acc.w);
        }
      }
      const long long orow = out_row(row0 + rr);
      if (nsplit > 1) {   // the split's partial (m, l, acc), m in natural log
        const long long prow = orow * nsplit + split;
        *reinterpret_cast<float4*>(part_acc + prow * HD + d) = acc;
        if (d == 0) {
          part_ml[prow * 2] = mx * kLn2;
          part_ml[prow * 2 + 1] = lsum;
        }
      } else {
        const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
        __nv_bfloat162 y[2] = {__floats2bfloat162_rn(acc.x * inv, acc.y * inv),
                               __floats2bfloat162_rn(acc.z * inv, acc.w * inv)};
        *reinterpret_cast<uint2*>(out + orow * HD + d) =
            *reinterpret_cast<const uint2*>(y);
      }
    }
  } else {
    if (nsplit > 1) {   // the split's partial (m, l, acc), m in natural log
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gr = row0 + wrow + 8 * r;
        if (gr >= n_rows) continue;
        const long long prow = out_row(gr) * nsplit + split;
        float* pa = part_acc + prow * HD + (lane & 3) * 2;
#pragma unroll
        for (int j = 0; j < OT; ++j)
          *reinterpret_cast<float2*>(pa + j * 8) =
              make_float2(o[j][2 * r], o[j][2 * r + 1]);
        if ((lane & 3) == 0) {
          part_ml[prow * 2] = m[r] * kLn2;
          part_ml[prow * 2 + 1] = l[r];
        }
      }
      return;
    }
    // O / l -> the warp's own 16 rows of the Q tile's shared memory
    // (only this warp read them) -> device as 16-byte rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = wrow + 8 * r;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
      for (int j = 0; j < OT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(qs + swz<LD>(rr, j) +
                                           (lane & 3) * 2) =
            __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 16 * CH / 32; ++it) {
      const int idx = lane + it * 32;
      const int rr = rbase + idx / CH, c = idx % CH, gr = row0 + rr;
      if (gr < n_rows && (CHG == CH || c < CHG))
        *reinterpret_cast<uint4*>(out + out_row(gr) * HD + c * 8) =
            *reinterpret_cast<const uint4*>(qs + swz<LD>(rr, c));
    }
  }
}

// One launch of the layout C*G selects, then with nsplit > 1 the merge.
template <int HD, bool NARROW, typename Keys>
cudaError_t launch_layout(const void* q, const void* k, const void* v,
                          const Keys& keys, const void* pos, int pos_stride,
                          int pos_add, void* out, void* pacc, void* pml,
                          int B, int C, int H, int KV, int n_keys, int window,
                          float scale, int nsplit, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD, NARROW>();
  auto kernel = flash_decode_tc<HD, NARROW, Keys>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  constexpr int rows = Layout<HD, NARROW>::kRows;
  const int tiles = (C * (H / KV) + rows - 1) / rows;
  float* pa = static_cast<float*>(pacc);
  float* pm = static_cast<float*>(pml);
  kernel<<<dim3(tiles * nsplit, KV, B), kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), keys, static_cast<const int*>(pos),
      pos_stride, pos_add, static_cast<bf16*>(out), pa, pm, C, H, KV, n_keys,
      window, scale * 1.4426950408889634f, nsplit);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const int out_rows = B * C * H;
  rt::combine_splits<bf16, HD><<<(out_rows + rt::kWarps - 1) / rt::kWarps,
                                 rt::kThreads, 0, stream>>>(
      pa, pm, static_cast<bf16*>(out), out_rows, nsplit);
  return cudaGetLastError();
}

template <int HD, typename Keys>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Keys& keys, const void* pos, int pos_stride,
                   int pos_add, void* out, void* pacc, void* pml, int B,
                   int C, int H, int KV, int n_keys, int window, float scale,
                   int nsplit, cudaStream_t s) {
  if (C * (H / KV) <= kNarrowRows)
    return launch_layout<HD, true>(q, k, v, keys, pos, pos_stride, pos_add,
                                   out, pacc, pml, B, C, H, KV, n_keys,
                                   window, scale, nsplit, s);
  return launch_layout<HD, false>(q, k, v, keys, pos, pos_stride, pos_add,
                                  out, pacc, pml, B, C, H, KV, n_keys, window,
                                  scale, nsplit, s);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
// part_acc (B*C*H, nsplit, hd) and part_ml (B*C*H, nsplit, 2) are f32
// scratch, unused when nsplit == 1.  Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int rt_flash_decode_paged(const void* q, const void* kp,
                                     const void* vp, const void* bt,
                                     const void* pos, void* out,
                                     void* part_acc, void* part_ml, int B,
                                     int C, int H, int KV, int hd, int bs,
                                     int nb_seq, int window, float scale,
                                     int nsplit, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0 || H % KV != 0 || nsplit < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rt::PagedKeys keys{static_cast<const int*>(bt), nb_seq, bs, KV, hd};
  if (dtype == 0 && hd == 64)
    return f32::launch<64>(q, kp, vp, bt, pos, out, part_acc, part_ml, B, C, H, KV, bs, nb_seq, window, scale, nsplit, s);
  if (dtype == 0 && hd == 120)
    return f32::launch<120>(q, kp, vp, bt, pos, out, part_acc, part_ml, B, C, H, KV, bs, nb_seq, window, scale, nsplit, s);
  if (dtype == 0 && hd == 128)
    return f32::launch<128>(q, kp, vp, bt, pos, out, part_acc, part_ml, B, C, H, KV, bs, nb_seq, window, scale, nsplit, s);
  if (dtype == 0 && hd == 256)
    return f32::launch<256>(q, kp, vp, bt, pos, out, part_acc, part_ml, B, C, H, KV, bs, nb_seq, window, scale, nsplit, s);
  if (dtype == 1 && hd == 64)
    return tc::launch<64>(q, kp, vp, keys, pos, 1, 0, out, part_acc, part_ml, B, C, H, KV, nb_seq * bs, window, scale, nsplit, s);
  if (dtype == 1 && hd == 120)
    return tc::launch<120>(q, kp, vp, keys, pos, 1, 0, out, part_acc, part_ml, B, C, H, KV, nb_seq * bs, window, scale, nsplit, s);
  if (dtype == 1 && hd == 128)
    return tc::launch<128>(q, kp, vp, keys, pos, 1, 0, out, part_acc, part_ml, B, C, H, KV, nb_seq * bs, window, scale, nsplit, s);
  if (dtype == 1 && hd == 256)
    return tc::launch<256>(q, kp, vp, keys, pos, 1, 0, out, part_acc, part_ml, B, C, H, KV, nb_seq * bs, window, scale, nsplit, s);
  return cudaErrorInvalidValue;
}

// One-token decode over a contiguous cache.  dtype as above.  part_acc
// (B*H, nsplit, hd) and part_ml (B*H, nsplit, 2) are f32 scratch, unused
// when nsplit == 1.  length points at one int32 in device memory, at
// least 1.
extern "C" int rt_flash_decode(const void* q, const void* k, const void* v,
                               const void* length, void* out, void* part_acc,
                               void* part_ml, int B, int H, int KV, int hd,
                               int S, float scale, int nsplit, int dtype,
                               void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || nsplit < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rt::ViewKeys keys{S, KV, hd};
  if (dtype == 0 && hd == 64)
    return f32::launch_bhd<64>(q, k, v, length, out, part_acc, part_ml, B, H, KV, S, scale, nsplit, s);
  if (dtype == 0 && hd == 120)
    return f32::launch_bhd<120>(q, k, v, length, out, part_acc, part_ml, B, H, KV, S, scale, nsplit, s);
  if (dtype == 0 && hd == 128)
    return f32::launch_bhd<128>(q, k, v, length, out, part_acc, part_ml, B, H, KV, S, scale, nsplit, s);
  if (dtype == 0 && hd == 256)
    return f32::launch_bhd<256>(q, k, v, length, out, part_acc, part_ml, B, H, KV, S, scale, nsplit, s);
  if (dtype == 1 && hd == 64)
    return tc::launch<64>(q, k, v, keys, length, 0, -1, out, part_acc, part_ml, B, 1, H, KV, S, 0, scale, nsplit, s);
  if (dtype == 1 && hd == 120)
    return tc::launch<120>(q, k, v, keys, length, 0, -1, out, part_acc, part_ml, B, 1, H, KV, S, 0, scale, nsplit, s);
  if (dtype == 1 && hd == 128)
    return tc::launch<128>(q, k, v, keys, length, 0, -1, out, part_acc, part_ml, B, 1, H, KV, S, 0, scale, nsplit, s);
  if (dtype == 1 && hd == 256)
    return tc::launch<256>(q, k, v, keys, length, 0, -1, out, part_acc, part_ml, B, 1, H, KV, S, 0, scale, nsplit, s);
  return cudaErrorInvalidValue;
}

// One-token decode over the N-step loop's per-row views.  dtype as
// above; part_acc (B*H, nsplit, hd) and part_ml (B*H, nsplit, 2) are f32
// scratch, unused when nsplit == 1.  pos (B,) int32 in device memory.
extern "C" int rt_decode_view_attend(const void* q, const void* kview,
                                     const void* vview, const void* pos,
                                     void* out, void* part_acc, void* part_ml,
                                     int B, int H, int KV, int hd, int S1,
                                     int window, float scale, int nsplit,
                                     int dtype, void* stream) {
  if (B <= 0 || S1 <= 0 || KV <= 0 || H % KV != 0 || nsplit < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rt::ViewKeys keys{S1, KV, hd};
  if (dtype == 0 && hd == 64)
    return f32::launch_view<64>(q, kview, vview, pos, out, part_acc, part_ml, B, H, KV, S1, window, scale, nsplit, s);
  if (dtype == 0 && hd == 120)
    return f32::launch_view<120>(q, kview, vview, pos, out, part_acc, part_ml, B, H, KV, S1, window, scale, nsplit, s);
  if (dtype == 0 && hd == 128)
    return f32::launch_view<128>(q, kview, vview, pos, out, part_acc, part_ml, B, H, KV, S1, window, scale, nsplit, s);
  if (dtype == 0 && hd == 256)
    return f32::launch_view<256>(q, kview, vview, pos, out, part_acc, part_ml, B, H, KV, S1, window, scale, nsplit, s);
  if (dtype == 1 && hd == 64)
    return tc::launch<64>(q, kview, vview, keys, pos, 1, 0, out, part_acc, part_ml, B, 1, H, KV, S1, window, scale, nsplit, s);
  if (dtype == 1 && hd == 120)
    return tc::launch<120>(q, kview, vview, keys, pos, 1, 0, out, part_acc, part_ml, B, 1, H, KV, S1, window, scale, nsplit, s);
  if (dtype == 1 && hd == 128)
    return tc::launch<128>(q, kview, vview, keys, pos, 1, 0, out, part_acc, part_ml, B, 1, H, KV, S1, window, scale, nsplit, s);
  if (dtype == 1 && hd == 256)
    return tc::launch<256>(q, kview, vview, keys, pos, 1, 0, out, part_acc, part_ml, B, 1, H, KV, S1, window, scale, nsplit, s);
  return cudaErrorInvalidValue;
}
