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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // units per thread per CTA

struct alignas(1) U1 { uint8_t v; };
struct alignas(2) U2 { uint16_t v; };
struct alignas(4) U4 { uint32_t v; };
struct alignas(8) U8 { uint64_t v; };
struct alignas(16) U16 { uint4 v; };

template <class V>
__global__ void __launch_bounds__(kThreads)
slot_gather_kernel(const V* __restrict__ pool, const int* __restrict__ slots,
                   const int* __restrict__ fresh, V* __restrict__ out, int s,
                   int b, long long units) {
  const int row = blockIdx.y, layer = blockIdx.z;
  const int slot = slots[row];
  const bool zero = (fresh != nullptr && fresh[row] != 0) || slot < 0 ||
                    slot >= s;
  const V* src = pool + ((long long)layer * s + (zero ? 0 : slot)) * units;
  V* dst = out + ((long long)layer * b + row) * units;
  const long long base =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  V vals[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < units) {
      if (zero)
        vals[k] = V{};
      else
        vals[k] = src[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = base + (long long)k * kThreads;
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

template <class V>
void gather(const void* pool, const int* slots, const int* fresh, void* out,
            int layers, int s, int b, long long units, cudaStream_t st) {
  slot_gather_kernel<V><<<grid_of(units, b, layers), kThreads, 0, st>>>(
      static_cast<const V*>(pool), slots, fresh, static_cast<V*>(out), s, b,
      units);
}

template <class V>
void scatter(void* pool, const int* slots, const void* values, int layers,
             int s, int b, long long units, cudaStream_t st) {
  slot_scatter_kernel<V><<<grid_of(units, b, layers), kThreads, 0, st>>>(
      static_cast<V*>(pool), slots, static_cast<const V*>(values), s, b,
      units);
}

}  // namespace

// pool (L, S, row_bytes) -> out (L, B, row_bytes); slots, fresh (B,) int32
// (fresh may be null: no row is fresh).  `unit` (1, 2, 4, 8 or 16) divides
// row_bytes and every pointer's address (the wrapper picks it).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_slot_gather(const void* pool, const void* slots,
                              const void* fresh, void* out, int layers, int s,
                              int b, long long row_bytes, int unit,
                              void* stream) {
  if (bad_shape(layers, s, b, row_bytes, unit)) return cudaErrorInvalidValue;
  const int* sl = static_cast<const int*>(slots);
  const int* fr = static_cast<const int*>(fresh);
  const long long units = row_bytes / unit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: gather<U16>(pool, sl, fr, out, layers, s, b, units, st); break;
    case 8: gather<U8>(pool, sl, fr, out, layers, s, b, units, st); break;
    case 4: gather<U4>(pool, sl, fr, out, layers, s, b, units, st); break;
    case 2: gather<U2>(pool, sl, fr, out, layers, s, b, units, st); break;
    case 1: gather<U1>(pool, sl, fr, out, layers, s, b, units, st); break;
    default: return cudaErrorInvalidValue;
  }
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
