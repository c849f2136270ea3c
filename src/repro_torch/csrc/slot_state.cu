// Slot-state gather and scatter for the recurrent-state pools of the
// ssm / rglru families.  Replace the Pallas kernels
// repro/kernels/slot_state.py slot_gather_rows and slot_scatter_rows.
//
// A pool holds one fixed-size state row per slot, (L, S, F) with the
// stacked layer axis in front (L = 1 for one layer's pool):
//   gather   out[l, b, :] = fresh[b] ? 0 : pool[l, slots[b], :]
//   scatter  pool[l, w[b], :] = values[l, b, :]        (in place)
//            w[b] = valid_len[b] > 0 ? slots[b] : 0
// A row with valid_len == 0 (padding, a stale row) writes trash slot 0,
// the only slot two rows may share, whose content no live row reads
// (which row wins there is unspecified; different units of it may come
// from different rows).  No valid_len: every row writes its own slot.
// The TPU scatter built a new pool by walking all S rows against an
// inverse map; here the B rows are written in place and nothing else is
// touched.
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
// Each is one launch a call.  The gather reads the fresh mask as the
// caller holds it (bool or uint8, 1 byte an element, or int32: a bool
// mask needs no cast kernel first); the scatter reads valid_len as it
// comes (int32 or int64) and routes its stale rows itself, so the
// caller launches no compare, zeros or select first.  The gather's rows
// are short on the mamba path (a conv-window row is 864 16-byte units)
// and its row counts small, so each launch takes the most units a thread
// (8, 4, 2 or 1) that still gives it about one CTA an SM (gather_plan in
// kernels/slot_state.py), over 128-thread CTAs.  The scatter keeps 256
// threads of 4 units a CTA: sized like the gather it ran no faster on
// the H100 (PERF.md).  A CTA reads its slot (and mask or length) first,
// then issues every load of its units before any store.  The gather
// reads the pool rows with ld.global.cs (evict first: each is read
// once); the scatter's loads and stores are plain (its values read
// evict-first made the 48-layer state scatter 1.4% slower; the next
// step's gather reads the rows it stores).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the CTAs (kernels/slot_state.py GATHER_THREADS, SCATTER_THREADS) and
// the scatter's units a thread (SCATTER_PER_THREAD)
constexpr int kGatherThreads = 128;
constexpr int kScatterThreads = 256;
constexpr int kScatterUnits = 4;

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

// Whether row `row` of a valid_len of `bytes`-wide integers (4 or 8; 0:
// none) is a stale row, one that writes trash slot 0: not valid_len > 0,
// the reference's test.
__device__ __forceinline__ bool stale(const void* valid_len, int bytes,
                                      int row) {
  if (bytes == 4) return static_cast<const int32_t*>(valid_len)[row] <= 0;
  if (bytes == 8) return static_cast<const int64_t*>(valid_len)[row] <= 0;
  return false;
}

// One unit, by ld.global.cs (__ldcs has no uint64_t overload
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
__global__ void __launch_bounds__(kScatterThreads)
slot_scatter_kernel(V* __restrict__ pool, const int* __restrict__ slots,
                    const void* __restrict__ valid_len, int len_bytes,
                    const V* __restrict__ values, int s, int b,
                    long long units) {
  const int row = blockIdx.y, layer = blockIdx.z;
  // the slot and the length loaded together, not one after the other
  const int own = slots[row];
  const int slot = stale(valid_len, len_bytes, row) ? 0 : own;
  if (slot < 0 || slot >= s) return;
  V* dst = pool + ((long long)layer * s + slot) * units;
  const V* src = values + ((long long)layer * b + row) * units;
  const long long base =
      (long long)blockIdx.x * kScatterThreads * kScatterUnits + threadIdx.x;
  V vals[kScatterUnits];
#pragma unroll
  for (int k = 0; k < kScatterUnits; ++k) {
    const long long i = base + (long long)k * kScatterThreads;
    if (i < units) vals[k] = src[i];
  }
#pragma unroll
  for (int k = 0; k < kScatterUnits; ++k) {
    const long long i = base + (long long)k * kScatterThreads;
    if (i < units) dst[i] = vals[k];
  }
}

// Either kernel's grid: row chunks of threads * per_thread units, one CTA
// each, x B x L; a zero grid where the shape cannot be launched.
dim3 copy_grid(int layers, int s, int b, long long row_bytes, int unit,
               int threads, int per_thread) {
  if (layers < 1 || layers > 65535 || s < 1 || b < 1 || b > 65535 ||
      row_bytes < 1 || unit < 1 || row_bytes % unit != 0 || per_thread < 1)
    return dim3(0, 0, 0);
  const long long per = (long long)threads * per_thread;
  const long long chunks = (row_bytes / unit + per - 1) / per;
  if (chunks > 0x7fffffffLL) return dim3(0, 0, 0);
  return dim3((unsigned)chunks, b, layers);
}

// One call's operands: the gather copies pool rows (src) to out (dst)
// under the fresh mask (flag); the scatter copies values (src) into the
// pool (dst), routed by valid_len (flag).
struct Copy {
  const void* src;
  void* dst;
  const int* slots;
  const void* flag;
  int flag_bytes, s, b;
  long long units;
};

template <class V, int U>
void gather(const Copy& c, dim3 grid, cudaStream_t st) {
  slot_gather_kernel<V, U><<<grid, kGatherThreads, 0, st>>>(
      static_cast<const V*>(c.src), c.slots, c.flag, c.flag_bytes,
      static_cast<V*>(c.dst), c.s, c.b, c.units);
}

// Launches the gather at per_thread units a thread, or the scatter (at
// kScatterUnits); false for a per_thread the kernel has no variant of.
template <bool Scatter, class V>
bool launch_by(int per_thread, const Copy& c, dim3 grid, cudaStream_t st) {
  if constexpr (Scatter) {
    if (per_thread != kScatterUnits) return false;
    slot_scatter_kernel<V><<<grid, kScatterThreads, 0, st>>>(
        static_cast<V*>(c.dst), c.slots, c.flag, c.flag_bytes,
        static_cast<const V*>(c.src), c.s, c.b, c.units);
    return true;
  } else {
    switch (per_thread) {
      case 1: gather<V, 1>(c, grid, st); return true;
      case 2: gather<V, 2>(c, grid, st); return true;
      case 4: gather<V, 4>(c, grid, st); return true;
      case 8: gather<V, 8>(c, grid, st); return true;
      default: return false;
    }
  }
}

// Checks the shape and the flag's element size (one of flag_sizes, 0 only
// with a null flag), then launches; cudaGetLastError() after the launch
// (0 = launched).
template <bool Scatter>
int launch(const Copy& c, int layers, long long row_bytes, int unit,
           int per_thread, int size_a, int size_b, void* stream) {
  const dim3 grid =
      copy_grid(layers, c.s, c.b, row_bytes, unit,
                Scatter ? kScatterThreads : kGatherThreads, per_thread);
  if (grid.x == 0 || (c.flag == nullptr) != (c.flag_bytes == 0) ||
      (c.flag_bytes != 0 && c.flag_bytes != size_a && c.flag_bytes != size_b))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (unit) {
    case 16: ok = launch_by<Scatter, U16>(per_thread, c, grid, st); break;
    case 8: ok = launch_by<Scatter, U8>(per_thread, c, grid, st); break;
    case 4: ok = launch_by<Scatter, U4>(per_thread, c, grid, st); break;
    case 2: ok = launch_by<Scatter, U2>(per_thread, c, grid, st); break;
    case 1: ok = launch_by<Scatter, U1>(per_thread, c, grid, st); break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
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
  const Copy c{pool, out, static_cast<const int*>(slots), fresh, fresh_bytes,
               s, b, row_bytes / (unit > 0 ? unit : 1)};
  return launch<false>(c, layers, row_bytes, unit, per_thread, 1, 4, stream);
}

// values (L, B, row_bytes) written into pool (L, S, row_bytes) at rows
// slots (B,) int32, in place; valid_len (B,) of len_bytes (4: int32, 8:
// int64) bytes an element routes its zero rows to slot 0 (null with
// len_bytes 0: no routing).  unit as the gather's.
extern "C" int rt_slot_scatter(void* pool, const void* slots,
                               const void* valid_len, int len_bytes,
                               const void* values, int layers, int s, int b,
                               long long row_bytes, int unit, void* stream) {
  const Copy c{values, pool, static_cast<const int*>(slots), valid_len,
               len_bytes, s, b, row_bytes / (unit > 0 ? unit : 1)};
  return launch<true>(c, layers, row_bytes, unit, kScatterUnits, 4, 8,
                      stream);
}
