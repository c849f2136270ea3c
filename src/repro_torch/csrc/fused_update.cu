// Fused SGD-momentum (+ LARS trust ratio) parameter update.  Replaces the
// Pallas kernel repro/kernels/fused_update.py fused_sgd_update_2d.
//
//   g' = trust * g + wd * w
//   m' = mu * m + g'
//   w' = w - lr * (nesterov ? g' + mu * m' : m')
//
// in float32, w and m updated in place.  w is float32 or bfloat16, m
// float32 or bfloat16, g float32; lr and trust are read from a device
// float32 pair, so a LARS trust computed on the card needs no host sync.
// Bound: bytes (each of w, m, g read once, w and m written once; a few
// flops per element).  Design: one streaming pass, 8 elements per thread
// per step so that every load and store is 16 bytes wide for every
// dtype (bf16 w: one 16-byte vector; f32: two), a grid-stride loop over
// about 16 CTAs per SM, and a scalar loop for the n % 8 tail.  No
// padding to tiles (the TPU wrapper padded every leaf to (R, 128)).
// Each operation rounds on its own (__fmul_rn / __fadd_rn, no fused
// multiply-add), as the plain PyTorch version's separate operators do,
// so the two agree bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16_rn(x);
}

// 8 elements of T through 16-byte vectors
template <class T>
__device__ __forceinline__ void load8(const T* p, float (&v)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kVec; j += kPer) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + j);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int q = 0; q < kPer; ++q) v[j + q] = to_f(e[q]);
  }
}

template <class T>
__device__ __forceinline__ void store8(T* p, const float (&v)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kVec; j += kPer) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int q = 0; q < kPer; ++q) e[q] = from_f<T>(v[j + q]);
    *reinterpret_cast<uint4*>(p + j) = raw;
  }
}

struct Hyper {
  float momentum, wd;
  bool nesterov;
};

__device__ __forceinline__ void update(float& w, float& m, float g, float lr,
                                       float trust, const Hyper& h) {
  const float gp = __fadd_rn(__fmul_rn(g, trust), __fmul_rn(h.wd, w));
  const float mn = __fadd_rn(__fmul_rn(h.momentum, m), gp);
  const float upd = h.nesterov ? __fadd_rn(gp, __fmul_rn(h.momentum, mn))
                               : mn;
  w = __fsub_rn(w, __fmul_rn(lr, upd));
  m = mn;
}

template <class TW, class TM>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(TW* __restrict__ w, TM* __restrict__ m,
                 const float* __restrict__ g,
                 const float* __restrict__ scalars, long long n, Hyper h) {
  const float lr = scalars[0], trust = scalars[1];
  const long long nvec = n / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
       v < nvec; v += stride) {
    const long long i = v * kVec;
    float wv[kVec], mv[kVec], gv[kVec];
    load8(w + i, wv);
    load8(m + i, mv);
    load8(g + i, gv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) update(wv[j], mv[j], gv[j], lr, trust, h);
    store8(w + i, wv);
    store8(m + i, mv);
  }
  // the n % 8 tail, one element per thread of CTA 0
  const long long t = nvec * kVec + threadIdx.x;
  if (blockIdx.x == 0 && t < n) {
    float wt = to_f(w[t]), mt = to_f(m[t]);
    update(wt, mt, g[t], lr, trust, h);
    w[t] = from_f<TW>(wt);
    m[t] = from_f<TM>(mt);
  }
}

template <class TW, class TM>
void launch(void* w, void* m, const void* g, const void* scalars,
            long long n, Hyper h, int ctas, cudaStream_t s) {
  fused_sgd_kernel<TW, TM><<<ctas, kThreads, 0, s>>>(
      static_cast<TW*>(w), static_cast<TM*>(m), static_cast<const float*>(g),
      static_cast<const float*>(scalars), n, h);
}

}  // namespace

// w_dtype / m_dtype: 0 = float32, 1 = bfloat16.  Every pointer 16-byte
// aligned (the wrapper checks).  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int rt_fused_sgd_update(void* w, void* m, const void* g,
                                   const void* scalars, long long n,
                                   int w_dtype, int m_dtype, float momentum,
                                   float weight_decay, int nesterov,
                                   int ctas, void* stream) {
  if (n <= 0 || ctas < 1 || w_dtype < 0 || w_dtype > 1 || m_dtype < 0 ||
      m_dtype > 1)
    return cudaErrorInvalidValue;
  const Hyper h{momentum, weight_decay, nesterov != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0 && m_dtype == 0)
    launch<float, float>(w, m, g, scalars, n, h, ctas, s);
  else if (w_dtype == 1 && m_dtype == 0)
    launch<__nv_bfloat16, float>(w, m, g, scalars, n, h, ctas, s);
  else if (w_dtype == 0 && m_dtype == 1)
    launch<float, __nv_bfloat16>(w, m, g, scalars, n, h, ctas, s);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(w, m, g, scalars, n, h, ctas, s);
  return cudaGetLastError();
}
