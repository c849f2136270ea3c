// Slot-state gather and scatter for the recurrent-state pools of the
// ssm / rglru families.  Replace the Pallas kernels
// repro/kernels/slot_state.py slot_gather_rows and slot_scatter_rows.
//
// A pool holds one fixed-size state row per slot, (L, S, F) with the
// stacked layer axis in front (L = 1 for one layer's pool):
//   gather   out[l, b, :] = fresh[b] ? 0 : pool[l, slots[b], :]
//   scatter  pool[l, slots[b], :] = values[l, b, :]        (in place)
// The caller has routed the scatter's rows with valid_len == 0 to trash
// slot 0 (the only slot two rows may share, whose content no live row
// reads; which row wins there is unspecified).  The TPU scatter built a
// new pool by walking all S rows against an inverse map; here the B
// rows are written in place and nothing else is touched.
//
// Bound: bytes (the rows moved, each read once and written once; no
// arithmetic).  Design: the rows are copied as raw units of `unit` bytes
// (16 where the row length and the pointers allow it, so every thread
// moves 16-byte vectors, else the widest unit that divides them: any F
// and dtype works, no padding), over a grid of (row chunks, B, L): a
// layered launch moves every layer's rows at once, as the reference's
// vmap over the layer axis does.  A slot outside [0, S) reads as zeros
// and writes nothing, so a bad index cannot reach outside the pool.
//
// The gather is one launch a call: it reads the fresh mask as the caller
// holds it (bool or uint8, 1 byte an element, or int32: a bool mask
// needs no cast kernel first).  Its rows are short on the mamba path (a
// conv-window row is 864 16-byte units) and its row counts small, so its
// CTAs are 128 threads and the wrapper picks the units a thread (8, 4, 2
// or 1) that still gives the launch about one CTA an SM (gather_plan in
// kernels/slot_state.py).  A CTA reads its slot and mask first, then
// issues every load of its units before any store, reading the pool
// rows with ld.global.cs (evict first: each is read once).  The scatter
// keeps 256-thread CTAs of 4 units a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // the scatter's CTA
constexpr int kUnroll = 4;      // units per thread per CTA (scatter)
constexpr int kGatherThreads = 128;   // kernels/slot_state.py GATHER_THREADS

struct alignas(1) U1 { uint8_t v; };
struct alignas(2) U2 { uint16_t v; };
struct alignas(4) U4 { uint32_t v; };
struct alignas(8) U8 { uint64_t v; };
struct alignas(16) U16 { uint4 v; };

// Whether row `row` of a fresh mask of `bytes`-wide elements (1 or 4; 0:
// no mask) is set.
__device__ __forceinline__ bool marked(const void* fresh, int bytes,
                                       int row) {
  if (bytes == 1) return static_cast<const uint8_t*>(fresh)[row] != 0;
  if (bytes == 4) return static_cast<const uint32_t*>(fresh)[row] != 0;
  return false;
}

// One unit of the pool, by ld.global.cs (__ldcs has no uint64_t overload
// on every toolkit, so 8-byte units go as unsigned long long).
template <class V>
__device__ __forceinline__ V load_unit(const V* p) {
  V x;
  if constexpr (sizeof(V) == 8)
    x.v = __ldcs(reinterpret_cast<const unsigned long long*>(p));
  else
    x.v = __ldcs(&p->v);
  return x;
}

template <class V, int U>
__global__ void __launch_bounds__(kGatherThreads)
slot_gather_kernel(const V* __restrict__ pool, const int* __restrict__ slots,
                   const void* __restrict__ fresh, int fresh_bytes,
                   V* __restrict__ out, int s, int b, long long units) {
  const int row = blockIdx.y, layer = blockIdx.z;
  const int slot = slots[row];
  const bool zero = marked(fresh, fresh_bytes, row) || slot < 0 || slot >= s;
  const V* src = pool + ((long long)layer * s + (zero ? 0 : slot)) * units;
  V* dst = out + ((long long)layer * b + row) * units;
  const long long base =
      (long long)blockIdx.x * kGatherThreads * U + threadIdx.x;
  V vals[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long i = base + (long long)k * kGatherThreads;
    if (i < units) vals[k] = zero ? V{} : load_unit<V>(src + i);
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long i = base + (long long)k * kGatherThreads;
    if (i < units) dst[i] = vals[k];
  }
}

template <class V>
__global__ void __launch_bounds__(kThreads)
slot_scatter_kernel(V* __restrict__ pool, const int* __restrict__ slots,
                    const V* __restrict__ values, int s, int b,
                    long long units) {
  const int row = blockIdx.y, layer = blockIdx.z;
  const int slot = slots[row];
  if (slot < 0 || slot >= s) return;
  V* dst = pool + ((long long)layer * s + slot) * units;
  const V* src = values + ((long long)layer * b + row) * units;
  const long long base =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  V vals[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < units) vals[k] = src[i];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < units) dst[i] = vals[k];
  }
}

dim3 grid_of(long long units, int b, int layers) {
  const long long per = (long long)kThreads * kUnroll;
  return dim3((unsigned)((units + per - 1) / per), b, layers);
}

bool bad_shape(int layers, int s, int b, long long row_bytes, int unit) {
  return layers < 1 || layers > 65535 || s < 1 || b < 1 || b > 65535 ||
         row_bytes < 1 || unit < 1 || row_bytes % unit != 0 ||
         (row_bytes / unit + (long long)kThreads * kUnroll - 1) /
                 ((long long)kThreads * kUnroll) >
             0x7fffffffLL;
}

// The gather's grid: row chunks of kGatherThreads * per_thread units, one
// CTA each, x B x L; a zero grid where the shape cannot be launched.
dim3 gather_grid(int layers, int s, int b, long long row_bytes, int unit,
                 int per_thread) {
  if (layers < 1 || layers > 65535 || s < 1 || b < 1 || b > 65535 ||
      row_bytes < 1 || unit < 1 || row_bytes % unit != 0 || per_thread < 1)
    return dim3(0, 0, 0);
  const long long per = (long long)kGatherThreads * per_thread;
  const long long chunks = (row_bytes / unit + per - 1) / per;
  if (chunks > 0x7fffffffLL) return dim3(0, 0, 0);
  return dim3((unsigned)chunks, b, layers);
}

template <class V, int U>
void gather(const void* pool, const int* slots, const void* fresh,
            int fresh_bytes, void* out, int s, int b, long long units,
            dim3 grid, cudaStream_t st) {
  slot_gather_kernel<V, U><<<grid, kGatherThreads, 0, st>>>(
      static_cast<const V*>(pool), slots, fresh, fresh_bytes,
      static_cast<V*>(out), s, b, units);
}

template <class V>
bool gather_by(int per_thread, const void* pool, const int* slots,
               const void* fresh, int fresh_bytes, void* out, int s, int b,
               long long units, dim3 grid, cudaStream_t st) {
  switch (per_thread) {
    case 1: gather<V, 1>(pool, slots, fresh, fresh_bytes, out, s, b, units, grid, st); return true;
    case 2: gather<V, 2>(pool, slots, fresh, fresh_bytes, out, s, b, units, grid, st); return true;
    case 4: gather<V, 4>(pool, slots, fresh, fresh_bytes, out, s, b, units, grid, st); return true;
    case 8: gather<V, 8>(pool, slots, fresh, fresh_bytes, out, s, b, units, grid, st); return true;
    default: return false;
  }
}

template <class V>
void scatter(void* pool, const int* slots, const void* values, int layers,
             int s, int b, long long units, cudaStream_t st) {
  slot_scatter_kernel<V><<<grid_of(units, b, layers), kThreads, 0, st>>>(
      static_cast<V*>(pool), slots, static_cast<const V*>(values), s, b,
      units);
}

}  // namespace

// pool (L, S, row_bytes) -> out (L, B, row_bytes); slots (B,) int32;
// fresh (B,) of fresh_bytes (1 or 4) bytes an element, nonzero = fresh
// (null with fresh_bytes 0: no row is fresh).  `unit` (1, 2, 4, 8
// or 16) divides row_bytes and every pointer's address (the wrapper
// picks it); per_thread (1, 2, 4 or 8) units a thread.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_slot_gather(const void* pool, const void* slots,
                              const void* fresh, int fresh_bytes, void* out,
                              int layers, int s, int b, long long row_bytes,
                              int unit, int per_thread, void* stream) {
  const dim3 grid = gather_grid(layers, s, b, row_bytes, unit, per_thread);
  if (grid.x == 0 || (fresh == nullptr) != (fresh_bytes == 0) ||
      (fresh_bytes != 0 && fresh_bytes != 1 && fresh_bytes != 4))
    return cudaErrorInvalidValue;
  const long long units = row_bytes / unit;
  const int* sl = static_cast<const int*>(slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (unit) {
    case 16: ok = gather_by<U16>(per_thread, pool, sl, fresh, fresh_bytes, out, s, b, units, grid, st); break;
    case 8: ok = gather_by<U8>(per_thread, pool, sl, fresh, fresh_bytes, out, s, b, units, grid, st); break;
    case 4: ok = gather_by<U4>(per_thread, pool, sl, fresh, fresh_bytes, out, s, b, units, grid, st); break;
    case 2: ok = gather_by<U2>(per_thread, pool, sl, fresh, fresh_bytes, out, s, b, units, grid, st); break;
    case 1: ok = gather_by<U1>(per_thread, pool, sl, fresh, fresh_bytes, out, s, b, units, grid, st); break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// values (L, B, row_bytes) written into pool (L, S, row_bytes) at rows
// slots (B,) int32, in place.
extern "C" int rt_slot_scatter(void* pool, const void* slots,
                               const void* values, int layers, int s, int b,
                               long long row_bytes, int unit, void* stream) {
  if (bad_shape(layers, s, b, row_bytes, unit)) return cudaErrorInvalidValue;
  const int* sl = static_cast<const int*>(slots);
  const long long units = row_bytes / unit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: scatter<U16>(pool, sl, values, layers, s, b, units, st); break;
    case 8: scatter<U8>(pool, sl, values, layers, s, b, units, st); break;
    case 4: scatter<U4>(pool, sl, values, layers, s, b, units, st); break;
    case 2: scatter<U2>(pool, sl, values, layers, s, b, units, st); break;
    case 1: scatter<U1>(pool, sl, values, layers, s, b, units, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
