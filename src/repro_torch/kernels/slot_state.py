"""Slot-state gather and scatter for the ssm / rglru recurrent-state pools.

Replace the Pallas TPU kernels of ``repro/kernels/slot_state.py``:
``slot_gather_rows`` and ``slot_scatter_rows`` (reached through
``ops.slot_gather`` / ``ops.slot_scatter`` from ``models/ssm.py`` and the
decode loop's ``_loop_views`` / ``_scatter_loop_views``).  CUDA source:
``csrc/slot_state.cu``.

A slot-state pool holds one fixed-size state row per sequence slot: (S,
*F) for one layer, (L, S, *F) for a stacked run (``stacked=True``).

  gather   out[b] = 0 if fresh[b] else pool[slots[b]]       -> (B, *F)
  scatter  pool[w[b]] = values[b], in place,
           w[b] = slots[b] if valid_len[b] > 0 else 0

A row with ``valid_len == 0`` (padding, a stale row) writes trash slot 0,
as ``repro.models.layers.slot_state_scatter`` routes it; the kernel does
the routing itself (``layers.slot_state_scatter`` passes ``valid_len``
through).  Duplicate destinations only ever meet at slot 0; which row
wins there is unspecified in both packages, and no live row reads it.

Bound on the H100: bytes (rows copied, nothing computed).  Design: raw
16-byte vector copies over a grid of (row chunks, B, L); one launch
serves one layer, as the fused step calls it, or every layer of a run,
as the decode loop's entry and exit call it.  The reference instead
rebuilt the whole (S, F) pool against an inverse map on the TPU; the
port writes the B rows in place and leaves the other S - B alone.  No
lane padding of F.

Each is one launch a call: the gather reads the fresh mask in its own
dtype (a bool mask, as the models pass it, needs no cast kernel first),
the scatter reads ``valid_len`` as it comes (int32 or int64) and routes
the stale rows itself (no compare, zeros or select kernel first).  The
gather's CTAs are ``GATHER_THREADS`` threads, and ``gather_plan`` sizes
the units a thread from B, L and the row so that a launch has about one
CTA an SM: a conv-window row at B=2 is 14 CTAs of one unit a thread,
not 2 of four.  The pool rows are read with evict-first loads (each is
read once); plain loads and a fixed 4 or 8 units a thread were no
faster on the H100 (PERF.md).  The scatter keeps a fixed 256-thread CTA
of 4 units a thread (``SCATTER_THREADS``, ``SCATTER_PER_THREAD``) and
plain loads and stores: the gather's plan gave it more CTAs at few rows
and no time, and evict-first loads of its values made the 48-layer
scatter slower (PERF.md).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import require_cuda, sm_count

# the gather's CTA (csrc/slot_state.cu kGatherThreads) and the units a
# thread its plan chooses from, most first; the scatter's fixed CTA and
# units a thread (kScatterThreads, kScatterUnits)
GATHER_THREADS = 128
GATHER_PER_THREAD = (8, 4, 2, 1)
SCATTER_THREADS = 256
SCATTER_PER_THREAD = 4
# the element types the kernels read their per-row flag in: the gather's
# fresh mask (1 or 4 bytes an element; nonzero = fresh) and the scatter's
# valid_len (4 or 8; zero = stale)
_MASK_DTYPES = (torch.bool, torch.uint8, torch.int32)
_LEN_DTYPES = (torch.int32, torch.int64)


def gather_plan(units: int, b: int, layers: int, sms: int) -> int:
    """Units a thread of the gather's launch over ``b`` rows of ``units``
    copy units in each of ``layers`` layers on a card of ``sms`` SMs: the
    most whose grid (ceil(units / (GATHER_THREADS x per)) row chunks x b
    x layers, as the kernel's copy_grid makes it) still has a CTA for
    every SM, else one."""
    for per in GATHER_PER_THREAD:
        chunks = -(-units // (GATHER_THREADS * per))
        if chunks * b * layers >= sms or per == 1:
            return per


def _flag_code(t: Optional[torch.Tensor], dtypes, what: str) -> int:
    if t is None:
        return 0
    if t.dtype not in dtypes:
        raise ValueError(f"{what} must be "
                         f"{' or '.join(str(d)[6:] for d in dtypes)}, "
                         f"got {t.dtype}")
    return t.element_size()


def mask_code(fresh: Optional[torch.Tensor]) -> int:
    """The gather's mask argument: the bytes of an element of ``fresh``
    (1 for bool and uint8, 4 for int32), 0 for no mask."""
    return _flag_code(fresh, _MASK_DTYPES, "slot_gather: fresh")


def len_code(valid_len: Optional[torch.Tensor]) -> int:
    """The scatter's valid_len argument: the bytes of an element (4 for
    int32, 8 for int64), 0 for none (no row is routed)."""
    return _flag_code(valid_len, _LEN_DTYPES, "slot_scatter: valid_len")


def _flat_rows(pool: torch.Tensor, stacked: bool):
    """(L, S, row elements) of a pool laid out as (S, *F) or, stacked,
    (L, S, *F)."""
    lead = 2 if stacked else 1
    if pool.dim() < lead:
        raise ValueError(f"slot pool of shape {tuple(pool.shape)} has no "
                         f"{'layer and ' if stacked else ''}slot axis")
    layers = pool.shape[0] if stacked else 1
    s = pool.shape[lead - 1]
    return layers, s, math.prod(pool.shape[lead:])


def _unit(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy unit (16, 8, 4, 2 or 1 bytes) dividing the row
    length and every tensor's address."""
    for unit in (16, 8, 4, 2, 1):
        if row_bytes % unit == 0 and all(t.data_ptr() % unit == 0
                                         for t in tensors):
            return unit
    return 1


def slot_gather_plain(pool: torch.Tensor, slots: torch.Tensor,
                      fresh: Optional[torch.Tensor] = None, *,
                      stacked: bool = False) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``ops.slot_gather``: the pool rows
    at ``slots``, zeros for ``fresh`` rows)."""
    axis = 1 if stacked else 0
    out = pool.index_select(axis, slots.long())
    if fresh is not None:
        shape = [1] * out.dim()
        shape[axis] = -1
        out = out.masked_fill(fresh.bool().reshape(shape), 0)
    return out


def slot_scatter_plain(pool: torch.Tensor, slots: torch.Tensor,
                       values: torch.Tensor, *,
                       valid_len: Optional[torch.Tensor] = None,
                       stacked: bool = False) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``layers.slot_state_scatter``):
    ``pool[where(valid_len > 0, slots, 0)] = values`` in place (along
    the slot axis; no valid_len: ``pool[slots]``); returns ``pool``."""
    idx = slots.long()
    if valid_len is not None:
        idx = torch.where(valid_len > 0, idx, torch.zeros_like(idx))
    with torch.no_grad():
        if stacked:
            pool[:, idx] = values.to(pool.dtype)
        else:
            pool[idx] = values.to(pool.dtype)
    return pool


def _check(name, pool, slots, flag, stacked, *others):
    """(L, S, row elements) of the pool, after the checks both wrappers
    make: CUDA, contiguous, slots (B,) int32, the flag None or (B,)."""
    extra = () if flag is None else (flag,)
    require_cuda(name, pool, slots, *extra, *others)
    if slots.dim() != 1 or slots.dtype != torch.int32:
        raise ValueError(f"{name}: slots must be (B,) int32, got "
                         f"{tuple(slots.shape)} {slots.dtype}")
    if flag is not None and flag.shape != slots.shape:
        raise ValueError(f"{name}: fresh / valid_len must be "
                         f"{tuple(slots.shape)}, got {tuple(flag.shape)}")
    return _flat_rows(pool, stacked)


def slot_gather(pool: torch.Tensor, slots: torch.Tensor,
                fresh: Optional[torch.Tensor] = None, *,
                stacked: bool = False) -> torch.Tensor:
    """pool (S, *F), or (L, S, *F) with ``stacked``; slots (B,) int32 in
    [0, S); fresh None or (B,) bool, uint8 or int32 (nonzero rows read
    zeros).  Returns (B, *F), or (L, B, *F), in the pool's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel once,
    with ``gather_plan``'s units a thread."""
    if pool.device.type == "cpu":
        return slot_gather_plain(pool, slots, fresh, stacked=stacked)
    layers, s, f = _check("slot_gather", pool, slots, fresh, stacked)
    b = slots.shape[0]
    code = mask_code(fresh)
    lead = (layers, b) if stacked else (b,)
    feat = pool.shape[2:] if stacked else pool.shape[1:]
    out = torch.empty(lead + tuple(feat), dtype=pool.dtype,
                      device=pool.device)
    if b == 0 or f == 0:
        return out
    row_bytes = f * pool.element_size()
    unit = _unit(row_bytes, pool, out)
    per = gather_plan(row_bytes // unit, b, layers, sm_count(pool.device))
    lib = _build.library()
    rc = lib.rt_slot_gather(
        pool.data_ptr(), slots.data_ptr(),
        None if fresh is None else fresh.data_ptr(), code, out.data_ptr(),
        layers, s, b, row_bytes, unit, per,
        torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(rc, "slot_gather")
    slot_gather.launches += 1
    return out


slot_gather.launches = 0


def slot_scatter(pool: torch.Tensor, slots: torch.Tensor,
                 values: torch.Tensor, *,
                 valid_len: Optional[torch.Tensor] = None,
                 stacked: bool = False) -> torch.Tensor:
    """Write values (B, *F), or (L, B, *F) with ``stacked``, into the
    pool's rows ``slots`` (B,) int32, in place; returns ``pool``.  Rows
    with ``valid_len`` (None or (B,) int32 or int64) 0 write trash slot
    0.  CPU tensors take the plain version; CUDA tensors launch the
    kernel once."""
    if pool.device.type == "cpu":
        return slot_scatter_plain(pool, slots, values, valid_len=valid_len,
                                  stacked=stacked)
    layers, s, f = _check("slot_scatter", pool, slots, valid_len, stacked,
                          values)
    b = slots.shape[0]
    code = len_code(valid_len)
    want = ((layers, b) if stacked else (b,)) + tuple(
        pool.shape[2:] if stacked else pool.shape[1:])
    if tuple(values.shape) != want or values.dtype != pool.dtype:
        raise ValueError(f"slot_scatter: values must be {want} "
                         f"{pool.dtype}, got {tuple(values.shape)} "
                         f"{values.dtype}")
    if b == 0 or f == 0:
        return pool
    row_bytes = f * pool.element_size()
    unit = _unit(row_bytes, pool, values)
    lib = _build.library()
    rc = lib.rt_slot_scatter(
        pool.data_ptr(), slots.data_ptr(),
        None if valid_len is None else valid_len.data_ptr(), code,
        values.data_ptr(), layers, s, b, row_bytes, unit,
        torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(rc, "slot_scatter")
    slot_scatter.launches += 1
    return pool


slot_scatter.launches = 0
