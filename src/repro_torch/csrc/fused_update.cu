// Fused SGD-momentum (+ LARS trust ratio) update of a whole parameter
// tree, in place.  Replaces the Pallas kernel
// repro/kernels/fused_update.py fused_sgd_update_2d, which the reference
// calls once a leaf (ops.fused_sgd_update from optim/sgd.py).
//
//   g' = trust * g + wd * w
//   m' = mu * m + g'
//   w' = w - lr * (nesterov ? g' + mu * m' : m')
//
// in float32, w and m updated in place.  w and m are float32 or bfloat16,
// g float32 or bfloat16 (upcast here: the caller casts nothing).
//
// Bound: bytes.  Each parameter costs a read of w, m and g and a write of
// w and m (20 bytes for f32 w, m, g); a few flops each.  Over ResNet-50's
// 25.6 M parameters that is 0.15 ms on the H100, less than the host takes
// to launch one kernel per leaf of its 161.  So the design is about the
// host as much as the bytes:
//
// - One launch updates every leaf.  The leaves go to the kernel as a
//   table passed by value (__grid_constant__, read from the parameter
//   bank; no host-to-device copy, nothing to allocate, and a CUDA graph
//   captures it whole): each leaf's w, m, g pointers, its length, its
//   place in the call, and a prefix of chunk offsets.  A table holds
//   kTableLeaves leaves, which fills the 32,764 bytes of kernel
//   parameters CUDA 12.1 and later give sm_90; a longer list goes out in
//   ceil(leaves / kTableLeaves) launches, and one launch holds one
//   (w, m, g) dtype triple, so a call makes, for each triple that occurs,
//   ceil(its leaves / kTableLeaves) launches (kernels/fused_update.py
//   launch_plan; the tests pin it).
// - Equal work a CTA.  The leaves' elements, one after the other, are cut
//   into chunks of kChunk elements (a leaf's last chunk is shorter), and
//   a grid of one wave (as many CTAs as the SMs hold at once, from the
//   occupancy API) walks the chunks, chunk c, c + grid, ...: a
//   64-float batch-norm scale is one short chunk, not a CTA of its own as
//   in a grid sized per leaf.  A CTA finds its chunk's leaf by a binary
//   search of the prefix (about 10 steps over 768 leaves, from the
//   previous chunk's leaf on).
// - 8 elements a thread a step, so every load and store is 16 bytes for
//   either dtype (bf16: one vector, f32: two); each leaf's n % 8 tail one
//   element a thread.  Every pointer is 16-byte aligned (the wrapper
//   checks), and every chunk starts a multiple of 8 elements into its
//   leaf.  Every load is a plain one: g is read once, but reading it
//   evict-first (ld.global.cs) streamed slower on the H100, at both
//   layouts; neither 8192- or 16384-element chunks, nor a shortcut for
//   a chunk in the previous chunk's leaf, nor two steps' loads issued
//   together read faster than this design.
// - lr is read from a device float when the caller gives a tensor (a
//   device schedule, or a CUDA graph replayed at another step), else
//   passed as a float argument (the trainer's schedules return Python
//   floats: no fill kernel to make a tensor of it).  trust is an optional
//   device vector, one entry a leaf of the call.  Nothing syncs the host.
//
// LARS's trust, from ||w|| and ||g|| of every leaf, takes two more
// launches a table (the same leaves, grouped by their (w, g) dtypes), a
// count that does not grow with the leaves: lars_norms_kernel writes
// each chunk's two sums of squares, lars_trust_kernel sums each leaf's
// chunks (a warp a leaf) and applies the formula of optim/sgd.py's
// reference, _lars_trust.  No float atomics: every sum runs in a fixed
// order, so a run repeats bit for bit.
//
// Each operation of the update rounds on its own (__fmul_rn / __fadd_rn,
// no fused multiply-add), as the plain PyTorch version's separate
// operators do, so the two agree bit for bit given the same trust.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

// kernels/fused_update.py THREADS, CHUNK, TABLE_LEAVES
constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int kChunk = 4096;
constexpr int kTableLeaves = 768;
static_assert(kChunk % (kThreads * kVec) == 0, "chunk of whole steps");

// One launch's leaves.  chunk0[i] is leaf i's first chunk, chunk0[count]
// the launch's chunks; idx[i] the leaf's place in the call (its trust).
struct Table {
  void* w[kTableLeaves];
  void* m[kTableLeaves];
  const void* g[kTableLeaves];
  long long n[kTableLeaves];
  int idx[kTableLeaves];
  int chunk0[kTableLeaves + 1];
  int count;
};
// the table and the update's other arguments (two pointers, a float, a
// Hyper) within CUDA 12.1's 32,764 bytes of kernel parameters
static_assert(sizeof(Table) + 64 <= 32764, "table over the parameter bank");

struct Hyper {
  float momentum, wd;
  bool nesterov;
};

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
    for (int k = 0; k < kPer; ++k) v[j + k] = to_f(e[k]);
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
    for (int k = 0; k < kPer; ++k) e[k] = from_f<T>(v[j + k]);
    *reinterpret_cast<uint4*>(p + j) = raw;
  }
}

__device__ __forceinline__ void update(float& w, float& m, float g, float lr,
                                       float trust, const Hyper& h) {
  const float gp = __fadd_rn(__fmul_rn(g, trust), __fmul_rn(h.wd, w));
  const float mn = __fadd_rn(__fmul_rn(h.momentum, m), gp);
  const float upd = h.nesterov ? __fadd_rn(gp, __fmul_rn(h.momentum, mn))
                               : mn;
  w = __fsub_rn(w, __fmul_rn(lr, upd));
  m = mn;
}

// The leaf of chunk c: the last i with chunk0[i] <= c, searched from
// leaf `from` on (a CTA's chunks rise).  An empty leaf shares its first
// chunk with the next leaf, which the search picks.
__device__ __forceinline__ int leaf_of(const Table& t, int c, int from) {
  int lo = from, hi = t.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.chunk0[mid] <= c) lo = mid; else hi = mid;
  }
  return lo;
}

// Chunk c's elements [lo, hi) of its leaf, and where its 8-wide steps end.
struct Span {
  long long lo, hi, vec_hi;
};
__device__ __forceinline__ Span span_of(const Table& t, int leaf, int c) {
  Span s;
  s.lo = (long long)(c - t.chunk0[leaf]) * kChunk;
  s.hi = min(s.lo + kChunk, t.n[leaf]);
  s.vec_hi = s.lo + (s.hi - s.lo) / kVec * kVec;
  return s;
}

template <class TW, class TM, class TG>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(const __grid_constant__ Table t,
                 const float* __restrict__ lr_ptr, float lr_value,
                 const float* __restrict__ trust, Hyper h) {
  const float lr = lr_ptr ? *lr_ptr : lr_value;
  const int chunks = t.chunk0[t.count];
  int leaf = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    leaf = leaf_of(t, c, leaf);
    TW* w = static_cast<TW*>(t.w[leaf]);
    TM* m = static_cast<TM*>(t.m[leaf]);
    const TG* g = static_cast<const TG*>(t.g[leaf]);
    const float tr = trust ? trust[t.idx[leaf]] : 1.f;
    const Span s = span_of(t, leaf, c);
    for (long long i = s.lo + threadIdx.x * kVec; i < s.vec_hi;
         i += kThreads * kVec) {
      float wv[kVec], mv[kVec], gv[kVec];
      load8(w + i, wv);
      load8(m + i, mv);
      load8(g + i, gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) update(wv[j], mv[j], gv[j], lr, tr, h);
      store8(w + i, wv);
      store8(m + i, mv);
    }
    const long long i = s.vec_hi + threadIdx.x;   // the leaf's n % 8 tail
    if (i < s.hi) {
      float wt = to_f(w[i]), mt = to_f(m[i]);
      update(wt, mt, to_f(g[i]), lr, tr, h);
      w[i] = from_f<TW>(wt);
      m[i] = from_f<TM>(mt);
    }
  }
}

// A block's sum of v, the same order every run: each warp by shuffles,
// then every thread over the warps' sums in warp order, so every thread
// gets the same result.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();              // scratch free from the previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) s += scratch[k];
  return s;
}

// partial[c] = (sum of w^2, sum of g^2) over chunk c
template <class TW, class TG>
__global__ void __launch_bounds__(kThreads)
lars_norms_kernel(const __grid_constant__ Table t,
                  float2* __restrict__ partial) {
  __shared__ float scratch[kThreads / 32];
  const int chunks = t.chunk0[t.count];
  int leaf = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    leaf = leaf_of(t, c, leaf);
    const TW* w = static_cast<const TW*>(t.w[leaf]);
    const TG* g = static_cast<const TG*>(t.g[leaf]);
    const Span s = span_of(t, leaf, c);
    float sw = 0.f, sg = 0.f;
    for (long long i = s.lo + threadIdx.x * kVec; i < s.vec_hi;
         i += kThreads * kVec) {
      float wv[kVec], gv[kVec];
      load8(w + i, wv);
      load8(g + i, gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sw = __fmaf_rn(wv[j], wv[j], sw);
        sg = __fmaf_rn(gv[j], gv[j], sg);
      }
    }
    const long long i = s.vec_hi + threadIdx.x;
    if (i < s.hi) {
      const float wt = to_f(w[i]), gt = to_f(g[i]);
      sw = __fmaf_rn(wt, wt, sw);
      sg = __fmaf_rn(gt, gt, sg);
    }
    sw = block_sum(sw, scratch);
    sg = block_sum(sg, scratch);
    if (threadIdx.x == 0) partial[c] = make_float2(sw, sg);
  }
}

// trust[idx[i]] for leaf i of the table, a warp a leaf:
//   eta * ||w|| / (||g|| + wd * ||w|| + eps), 1 where either norm is 0
__global__ void __launch_bounds__(kThreads)
lars_trust_kernel(const __grid_constant__ Table t,
                  const float2* __restrict__ partial,
                  float* __restrict__ trust, float eta, float wd,
                  float eps) {
  const int leaf = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (leaf >= t.count) return;
  float sw = 0.f, sg = 0.f;
  for (int c = t.chunk0[leaf] + lane; c < t.chunk0[leaf + 1]; c += 32) {
    const float2 p = partial[c];
    sw += p.x;
    sg += p.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sw += __shfl_xor_sync(0xffffffffu, sw, o);
    sg += __shfl_xor_sync(0xffffffffu, sg, o);
  }
  if (lane == 0) {
    const float wn = __fsqrt_rn(sw), gn = __fsqrt_rn(sg);
    const float r = __fdiv_rn(
        __fmul_rn(eta, wn), __fadd_rn(__fadd_rn(gn, __fmul_rn(wd, wn)), eps));
    trust[t.idx[leaf]] = (wn > 0.f && gn > 0.f) ? r : 1.f;
  }
}

// The table of `count` leaves from the wrapper's arrays: leaves (count x
// 4: w, m, g, n), idx (count), chunk0 (count + 1).
bool fill(Table& t, const long long* leaves, const int* idx,
          const int* chunk0, int count) {
  if (count < 1 || count > kTableLeaves) return false;
  for (int i = 0; i < count; ++i) {
    t.w[i] = reinterpret_cast<void*>(leaves[4 * i]);
    t.m[i] = reinterpret_cast<void*>(leaves[4 * i + 1]);
    t.g[i] = reinterpret_cast<const void*>(leaves[4 * i + 2]);
    t.n[i] = leaves[4 * i + 3];
    t.idx[i] = idx[i];
  }
  for (int i = 0; i <= count; ++i) t.chunk0[i] = chunk0[i];
  t.count = count;
  return true;
}

// The persistent grid of `kernel` over the table's chunks on a card of
// `sms` SMs: as many CTAs as are resident at once (the registers decide:
// 6 of 256 threads an SM for the update), never more than the chunks.
// A grid past one wave would leave its last CTAs to walk their chunks
// after the others had finished.
template <class K>
int grid_of(K kernel, const Table& t, int sms) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) ||
      per_sm < 1)
    per_sm = 1;
  const int chunks = t.chunk0[t.count];
  return chunks < 1 ? 1 : (chunks < per_sm * sms ? chunks : per_sm * sms);
}

template <class K, class... A>
void launch(K kernel, const Table& t, int sms, cudaStream_t s, A... args) {
  kernel<<<grid_of(kernel, t, sms), kThreads, 0, s>>>(t, args...);
}

template <class TW, class TM>
void launch_update(const Table& t, int g_dtype, const float* lr_ptr,
                   float lr, const float* trust, Hyper h, int sms,
                   cudaStream_t s) {
  if (g_dtype == 0)
    launch(fused_sgd_kernel<TW, TM, float>, t, sms, s, lr_ptr, lr, trust,
           h);
  else
    launch(fused_sgd_kernel<TW, TM, __nv_bfloat16>, t, sms, s, lr_ptr, lr,
           trust, h);
}

template <class TW>
void launch_norms(const Table& t, int g_dtype, float2* partial, int sms,
                  cudaStream_t s) {
  if (g_dtype == 0)
    launch(lars_norms_kernel<TW, float>, t, sms, s, partial);
  else
    launch(lars_norms_kernel<TW, __nv_bfloat16>, t, sms, s, partial);
}

bool codes_ok(int a, int b, int c) {
  return a >= 0 && a <= 1 && b >= 0 && b <= 1 && c >= 0 && c <= 1;
}

}  // namespace

// One launch of the update over `count` leaves (at most kTableLeaves) of
// one dtype triple; dtype codes 0 = float32, 1 = bfloat16.  lr_ptr: a
// device float, or null to use `lr`; trust: a device float vector indexed
// by idx, or null (trust 1).  Every pointer 16-byte aligned (the wrapper
// checks); `sms` the card's SMs.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int rt_fused_sgd_update(const long long* leaves, const int* idx,
                                   const int* chunk0, int count,
                                   const void* lr_ptr, float lr,
                                   const void* trust, int w_dtype,
                                   int m_dtype, int g_dtype, float momentum,
                                   float weight_decay, int nesterov,
                                   int sms, void* stream) {
  Table t;
  if (sms < 1 || !codes_ok(w_dtype, m_dtype, g_dtype) ||
      !fill(t, leaves, idx, chunk0, count))
    return cudaErrorInvalidValue;
  const Hyper h{momentum, weight_decay, nesterov != 0};
  const float* lp = static_cast<const float*>(lr_ptr);
  const float* tr = static_cast<const float*>(trust);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0 && m_dtype == 0)
    launch_update<float, float>(t, g_dtype, lp, lr, tr, h, sms, s);
  else if (w_dtype == 1 && m_dtype == 0)
    launch_update<__nv_bfloat16, float>(t, g_dtype, lp, lr, tr, h, sms, s);
  else if (w_dtype == 0 && m_dtype == 1)
    launch_update<float, __nv_bfloat16>(t, g_dtype, lp, lr, tr, h, sms, s);
  else
    launch_update<__nv_bfloat16, __nv_bfloat16>(t, g_dtype, lp, lr, tr, h,
                                                 sms, s);
  return cudaGetLastError();
}

// LARS's norms pass over `count` leaves of one (w, g) dtype pair: each
// chunk's two sums of squares into `partial` (chunk0[count] float2s);
// `sms` the card's SMs.  Returns cudaGetLastError().  The caller may sum
// `partial` over the ranks that hold a sharded leaf's other parts (equal
// parts: the chunks line up) before rt_lars_trust reads it.
extern "C" int rt_lars_norms(const long long* leaves, const int* idx,
                             const int* chunk0, int count, void* partial,
                             int w_dtype, int g_dtype, int sms,
                             void* stream) {
  Table t;
  if (sms < 1 || !codes_ok(w_dtype, g_dtype, 0) ||
      !fill(t, leaves, idx, chunk0, count))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(partial);
  if (w_dtype == 0)
    launch_norms<float>(t, g_dtype, p, sms, s);
  else
    launch_norms<__nv_bfloat16>(t, g_dtype, p, sms, s);
  return cudaGetLastError();
}

// LARS's trust of the same `count` leaves from their chunks' sums in
// `partial`: trust[idx[i]] for every leaf i, a warp a leaf.  Returns
// cudaGetLastError().
extern "C" int rt_lars_trust(const long long* leaves, const int* idx,
                             const int* chunk0, int count,
                             const void* partial, void* trust, float eta,
                             float weight_decay, float eps, void* stream) {
  Table t;
  if (!fill(t, leaves, idx, chunk0, count)) return cudaErrorInvalidValue;
  const int warps_per_cta = kThreads / 32;
  lars_trust_kernel<<<(count + warps_per_cta - 1) / warps_per_cta, kThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float2*>(partial), static_cast<float*>(trust),
      eta, weight_decay, eps);
  return cudaGetLastError();
}
