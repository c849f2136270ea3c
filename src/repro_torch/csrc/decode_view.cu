// Decode attention over the N-step loop's per-row contiguous K/V views.
// Replaces the Pallas kernel repro/kernels/decode_view.py
// decode_view_attend_bhd; the arithmetic is attend.cuh's.
//
// q (B, H, HD), views (B, S1, KV, HD) with slot j = position j (slot
// S1 - 1 is the trash slot inactive rows write to), pos (B,) int32 ->
// out (B, H, HD).  Row b sees slots j <= pos[b] (and j > pos[b] - window
// when window > 0); the ragged S1 edge is masked in the kernel, so the
// view is read in place, unpadded.  nsplit > 1 splits each row's keys
// over CTAs as in flash_decode.cu.
#include "attend.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(rt::kThreads)
decode_view_kernel(const T* __restrict__ q, const T* __restrict__ kview,
                   const T* __restrict__ vview, const int* __restrict__ pos,
                   T* __restrict__ out, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int H, int KV, int S1,
                   int window, float scale, int nsplit) {
  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int kv = blockIdx.y, b = blockIdx.z;
  const long long row_off = (long long)b * H * HD;
  const rt::ViewKeys keys{S1, KV, HD};
  rt::attend_tile<T, HD>(q + row_off, kview, vview, out + row_off, part_acc,
                         part_ml, keys, b, kv, 1, H, H / KV,
                         tile * rt::kTileRows, split, nsplit, pos[b], S1,
                         window, scale);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kv_, const void* vv,
                   const void* pos, void* out, void* pacc, void* pml, int B,
                   int H, int KV, int S1, int window, float scale, int nsplit,
                   cudaStream_t stream) {
  const int tiles = (H / KV + rt::kTileRows - 1) / rt::kTileRows;
  dim3 grid(tiles * nsplit, KV, B);
  decode_view_kernel<T, HD><<<grid, rt::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_),
      static_cast<const T*>(vv), static_cast<const int*>(pos),
      static_cast<T*>(out), static_cast<float*>(pacc),
      static_cast<float*>(pml), H, KV, S1, window, scale, nsplit);
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
cudaError_t by_hd(int hd, const void* q, const void* k, const void* v,
                  const void* pos, void* out, void* pacc, void* pml, int B,
                  int H, int KV, int S1, int window, float scale, int nsplit,
                  cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, pos, out, pacc, pml, B, H, KV, S1, window, scale, nsplit, s);
    case 128: return launch<T, 128>(q, k, v, pos, out, pacc, pml, B, H, KV, S1, window, scale, nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_acc (B*H, nsplit, hd) and
// part_ml (B*H, nsplit, 2) are f32 scratch, unused when nsplit == 1.
// Returns cudaGetLastError() after the launches.
extern "C" int rt_decode_view_attend(const void* q, const void* kview,
                                     const void* vview, const void* pos,
                                     void* out, void* part_acc, void* part_ml,
                                     int B, int H, int KV, int hd, int S1,
                                     int window, float scale, int nsplit,
                                     int dtype, void* stream) {
  if (B <= 0 || S1 <= 0 || KV <= 0 || H % KV != 0 || nsplit < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_hd<float>(hd, q, kview, vview, pos, out, part_acc, part_ml, B, H, KV, S1, window, scale, nsplit, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, q, kview, vview, pos, out, part_acc, part_ml, B, H, KV, S1, window, scale, nsplit, s);
  return cudaErrorInvalidValue;
}
