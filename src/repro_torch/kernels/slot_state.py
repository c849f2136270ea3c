"""Slot-state gather and scatter for the ssm / rglru recurrent-state pools.

Replace the Pallas TPU kernels of ``repro/kernels/slot_state.py``:
``slot_gather_rows`` and ``slot_scatter_rows`` (reached through
``ops.slot_gather`` / ``ops.slot_scatter`` from ``models/ssm.py`` and the
decode loop's ``_loop_views`` / ``_scatter_loop_views``).  CUDA source:
``csrc/slot_state.cu``.

A slot-state pool holds one fixed-size state row per sequence slot: (S,
*F) for one layer, (L, S, *F) for a stacked run (``stacked=True``).

  gather   out[b] = 0 if fresh[b] else pool[slots[b]]       -> (B, *F)
  scatter  pool[slots[b]] = values[b], in place

The scatter's caller routes rows that must not write (``valid_len ==
0``) to trash slot 0 first (``layers.slot_state_scatter``).  Duplicate
destinations only ever meet there; which row wins slot 0 is unspecified
in both packages, and no live row reads it.

Bound on the H100: bytes (rows copied, nothing computed).  Design: raw
16-byte vector copies over a grid of (row chunks, B, L); one launch
serves one layer, as the fused step calls it, or every layer of a run,
as the decode loop's entry and exit call it.  The reference instead
rebuilt the whole (S, F) pool against an inverse map on the TPU; the
port writes the B rows in place and leaves the other S - B alone.  No
lane padding of F.

The gather is one launch a call: the kernel reads the fresh mask in its
own dtype (a bool mask, as the models pass it, needs no cast kernel
first).  Its CTAs are ``GATHER_THREADS`` threads, and ``gather_plan``
sizes the units a thread from B, L and the row so that a launch has
about one CTA an SM: a conv-window row at B=2 is 14 CTAs of one unit a
thread, not 2 of four.  The pool rows are read with evict-first loads
(each is read once); plain loads and a fixed 4 or 8 units a thread were
no faster on the H100 (PERF.md).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import require_cuda, sm_count

# the gather's CTA (csrc/slot_state.cu kGatherThreads) and the units a
# thread its plan chooses from, most first
GATHER_THREADS = 128
GATHER_PER_THREAD = (8, 4, 2, 1)
# the fresh mask's element types, as the kernel reads them (1 or 4 bytes
# an element; nonzero = fresh)
_MASK_DTYPES = (torch.bool, torch.uint8, torch.int32)


def gather_plan(units: int, b: int, layers: int, sms: int) -> int:
    """Units a thread of the gather's launch over ``b`` rows of ``units``
    copy units in each of ``layers`` layers on a card of ``sms`` SMs: the
    most whose grid (ceil(units / (GATHER_THREADS x per)) row chunks x b
    x layers, as the kernel's gather_grid makes it) still has a CTA for
    every SM, else one."""
    for per in GATHER_PER_THREAD:
        chunks = -(-units // (GATHER_THREADS * per))
        if chunks * b * layers >= sms or per == 1:
            return per


def mask_code(fresh: Optional[torch.Tensor]) -> int:
    """The kernel's mask argument: the bytes of an element of ``fresh``
    (1 for bool and uint8, 4 for int32), 0 for no mask."""
    if fresh is None:
        return 0
    if fresh.dtype not in _MASK_DTYPES:
        raise ValueError(f"slot_gather: fresh must be bool, uint8 or int32, "
                         f"got {fresh.dtype}")
    return fresh.element_size()


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
                       stacked: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``pool[slots] = values`` in place (along
    the slot axis); returns ``pool``."""
    idx = slots.long()
    with torch.no_grad():
        if stacked:
            pool[:, idx] = values.to(pool.dtype)
        else:
            pool[idx] = values.to(pool.dtype)
    return pool


def _check(name, pool, slots, stacked, *others):
    require_cuda(name, pool, slots, *others)
    if slots.dim() != 1 or slots.dtype != torch.int32:
        raise ValueError(f"{name}: slots must be (B,) int32, got "
                         f"{tuple(slots.shape)} {slots.dtype}")
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
    extra = () if fresh is None else (fresh,)
    layers, s, f = _check("slot_gather", pool, slots, stacked, *extra)
    b = slots.shape[0]
    if fresh is not None and fresh.shape != (b,):
        raise ValueError(f"slot_gather: fresh must be ({b},), got "
                         f"{tuple(fresh.shape)}")
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
                 stacked: bool = False) -> torch.Tensor:
    """Write values (B, *F), or (L, B, *F) with ``stacked``, into the
    pool's rows ``slots`` (B,) int32, in place; returns ``pool``.  The
    caller has routed rows that must not write to trash slot 0.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if pool.device.type == "cpu":
        return slot_scatter_plain(pool, slots, values, stacked=stacked)
    layers, s, f = _check("slot_scatter", pool, slots, stacked, values)
    b = slots.shape[0]
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
        pool.data_ptr(), slots.data_ptr(), values.data_ptr(), layers, s, b,
        row_bytes, unit, torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(rc, "slot_scatter")
    slot_scatter.launches += 1
    return pool


slot_scatter.launches = 0
