// Decode attention over K/V caches, two kernels on attend.cuh's
// arithmetic:
//
// flash_decode_paged_kernel: decode / prefill-chunk attention over shared
// K/V block pools.  Replaces the Pallas kernel
// repro/kernels/flash_decode.py flash_decode_paged_bhd.
//
// q (B, C, H, HD), pools (nb, bs, KV, HD), block_tables (B, NB) int32,
// pos (B,) int32 -> out (B, C, H, HD).  Query c of row b sits at
// position pos[b] + c and sees keys kpos <= pos[b] + c (and
// kpos > pos[b] + c - window when window > 0).  Pools are read in place
// at any head dim the kernel is built for (64, 128): nothing is
// padded, and the scale comes from the caller (1/sqrt(true hd)).
// With nsplit > 1 the keys of each tile are split over nsplit CTAs whose
// partial results (part_acc, part_ml: f32 scratch from the caller) a
// second kernel merges.
//
// flash_decode_bhd_kernel: one query token per row over a contiguous
// cache.  Replaces the Pallas kernel repro/kernels/flash_decode.py
// flash_decode_bhd.  q (B, H, HD), k/v (B, S, KV, HD), length: an int32
// scalar in device memory, the number of valid slots shared by every
// row (slot j is visible when j < length; a ring cache past its end has
// length > S and every slot visible).  The kernel reads length itself,
// so a decode step needs no host read of the position.  The cache is
// addressed as a per-row view (attend.cuh's ViewKeys: slot t of row b
// at (b*S + t)*KV*HD), the query as position length - 1 against keys
// up to it; split-K as for the pools.
#include "attend.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(rt::kThreads)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp, const int* __restrict__ bt,
                          const int* __restrict__ pos, T* __restrict__ out,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int C, int H, int KV,
                          int bs, int nb_seq, int window, float scale,
                          int nsplit) {
  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const long long row_off = (long long)b * C * H * HD;
  const rt::PagedKeys keys{bt, nb_seq, bs, KV, HD};
  rt::attend_tile<T, HD>(q + row_off, kp, vp, out + row_off, part_acc,
                         part_ml, keys, b, kv, C, H, G, tile * rt::kTileRows,
                         split, nsplit, pos[b], nb_seq * bs, window, scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(rt::kThreads)
flash_decode_bhd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ length, T* __restrict__ out,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int H, int KV, int S,
                        float scale, int nsplit) {
  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int kv = blockIdx.y, b = blockIdx.z;
  const long long row_off = (long long)b * H * HD;
  const rt::ViewKeys keys{S, KV, HD};
  rt::attend_tile<T, HD>(q + row_off, k, v, out + row_off, part_acc, part_ml,
                         keys, b, kv, 1, H, H / KV, tile * rt::kTileRows,
                         split, nsplit, length[0] - 1, S, 0, scale);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* bt, const void* pos, void* out, void* pacc,
                   void* pml, int B, int C, int H, int KV, int bs, int nb_seq,
                   int window, float scale, int nsplit, cudaStream_t stream) {
  const int tiles = (C * (H / KV) + rt::kTileRows - 1) / rt::kTileRows;
  dim3 grid(tiles * nsplit, KV, B);
  flash_decode_paged_kernel<T, HD><<<grid, rt::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<T*>(out),
      static_cast<float*>(pacc), static_cast<float*>(pml), C, H, KV, bs,
      nb_seq, window, scale, nsplit);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int rows = B * C * H;
    rt::combine_splits<T, HD><<<(rows + rt::kWarps - 1) / rt::kWarps,
                                rt::kThreads, 0, stream>>>(
        static_cast<const float*>(pacc), static_cast<const float*>(pml),
        static_cast<T*>(out), rows, nsplit);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* kp, const void* vp,
                  const void* bt, const void* pos, void* out, void* pacc,
                  void* pml, int B, int C, int H, int KV, int bs, int nb_seq,
                  int window, float scale, int nsplit, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, kp, vp, bt, pos, out, pacc, pml, B, C, H, KV, bs, nb_seq, window, scale, nsplit, s);
    case 128: return launch<T, 128>(q, kp, vp, bt, pos, out, pacc, pml, B, C, H, KV, bs, nb_seq, window, scale, nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int HD>
cudaError_t launch_bhd(const void* q, const void* k, const void* v,
                       const void* length, void* out, void* pacc, void* pml,
                       int B, int H, int KV, int S, float scale, int nsplit,
                       cudaStream_t stream) {
  const int tiles = (H / KV + rt::kTileRows - 1) / rt::kTileRows;
  dim3 grid(tiles * nsplit, KV, B);
  flash_decode_bhd_kernel<T, HD><<<grid, rt::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(length),
      static_cast<T*>(out), static_cast<float*>(pacc),
      static_cast<float*>(pml), H, KV, S, scale, nsplit);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int rows = B * H;
    rt::combine_splits<T, HD><<<(rows + rt::kWarps - 1) / rt::kWarps,
                                rt::kThreads, 0, stream>>>(
        static_cast<const float*>(pacc), static_cast<const float*>(pml),
        static_cast<T*>(out), rows, nsplit);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bhd_by_hd(int hd, const void* q, const void* k, const void* v,
                      const void* length, void* out, void* pacc, void* pml,
                      int B, int H, int KV, int S, float scale, int nsplit,
                      cudaStream_t s) {
  switch (hd) {
    case 64: return launch_bhd<T, 64>(q, k, v, length, out, pacc, pml, B, H, KV, S, scale, nsplit, s);
    case 128: return launch_bhd<T, 128>(q, k, v, length, out, pacc, pml, B, H, KV, S, scale, nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_acc (B*C*H, nsplit, hd) and
// part_ml (B*C*H, nsplit, 2) are f32 scratch, unused when nsplit == 1.
// Returns cudaGetLastError() after the launches (0 = launched).
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
  if (dtype == 0)
    return by_hd<float>(hd, q, kp, vp, bt, pos, out, part_acc, part_ml, B, C, H, KV, bs, nb_seq, window, scale, nsplit, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, q, kp, vp, bt, pos, out, part_acc, part_ml, B, C, H, KV, bs, nb_seq, window, scale, nsplit, s);
  return cudaErrorInvalidValue;
}

// One-token decode over a contiguous cache (see flash_decode_bhd_kernel).
// dtype: 0 = float32, 1 = bfloat16.  part_acc (B*H, nsplit, hd) and
// part_ml (B*H, nsplit, 2) are f32 scratch, unused when nsplit == 1.
// length points at one int32 in device memory, at least 1.
extern "C" int rt_flash_decode(const void* q, const void* k, const void* v,
                               const void* length, void* out, void* part_acc,
                               void* part_ml, int B, int H, int KV, int hd,
                               int S, float scale, int nsplit, int dtype,
                               void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || nsplit < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bhd_by_hd<float>(hd, q, k, v, length, out, part_acc, part_ml, B, H, KV, S, scale, nsplit, s);
  if (dtype == 1)
    return bhd_by_hd<__nv_bfloat16>(hd, q, k, v, length, out, part_acc, part_ml, B, H, KV, S, scale, nsplit, s);
  return cudaErrorInvalidValue;
}
