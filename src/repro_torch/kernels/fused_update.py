"""Fused SGD-momentum (+ LARS trust) update of a list of leaves, in place.

Replaces the Pallas TPU kernel ``repro/kernels/fused_update.py``
``fused_sgd_update_2d`` (reached through ``ops.fused_sgd_update`` from
``optim/sgd.py`` ``apply_update(fused=True)``): the memory-bound update
where LSGD's deferred gradient lands at the top of each step.  CUDA
source: ``csrc/fused_update.cu``.

    g' = trust * g + wd * w
    m' = mu * m + g'
    w' = w - lr * (nesterov ? g' + mu * m' : m')

Bound on the H100: bytes — w, m and g read once, w and m written once
(20 bytes a parameter for f32 w, m and g).  The reference launches its
kernel once a leaf; here one launch takes every leaf of a parameter tree
from a table passed as the kernel's argument (``csrc/fused_update.cu``
says how): the update of ResNet-50's 161 leaves is one launch, and its
host cost is one pass over the leaves' pointers and lengths.  The launch
rule (``launch_plan``): one launch for each (w, m, g) dtype triple that
occurs and each ``TABLE_LEAVES`` leaves of it; LARS's trust adds two
launches for each (w, g) pair and each ``TABLE_LEAVES`` leaves of it
(``lars_trust``; ``launches_per_call`` counts both).  The port updates ``w`` and
``m`` in place (the reference returns new arrays): an optimizer step
that allocated fresh copies would double the parameter and momentum
memory for the length of the step.
"""
from __future__ import annotations

import bisect
from operator import attrgetter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import dtype_code, sm_count

THREADS = 256
CHUNK = 4096             # elements a chunk of work (csrc kChunk)
TABLE_LEAVES = 768       # leaves a launch's table holds (csrc kTableLeaves)
# LARS: the kernel's trust sums squares in another order than PyTorch's
# vector_norm; the two trusts agree to this relative tolerance (f32 sums
# of up to millions of squares)
LARS_TRUST_RTOL = 1e-5
_DTYPE = attrgetter("dtype")


def chunk_offsets(numels: Sequence[int]) -> np.ndarray:
    """The prefix of chunk counts: leaf i's chunks are [off[i], off[i+1]),
    ceil(numel / CHUNK) of them (none for an empty leaf)."""
    counts = -(-np.asarray(numels, dtype=np.int64) // CHUNK)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def leaf_of(offsets: Sequence[int], chunk: int) -> int:
    """The leaf that holds ``chunk``: the last i with offsets[i] <= chunk
    (the kernel's binary search; an empty leaf yields to the next)."""
    return bisect.bisect_right(list(offsets), chunk) - 1


def launch_plan(keys: Sequence) -> List[Tuple[object, List[int]]]:
    """Launches of one call over leaves whose dtype triples are ``keys``:
    (triple, leaf indices) for each triple in order of first appearance,
    cut into runs of at most TABLE_LEAVES leaves."""
    groups: Dict[object, List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return [(k, idx[s:s + TABLE_LEAVES]) for k, idx in groups.items()
            for s in range(0, len(idx), TABLE_LEAVES)]


def launches_per_call(keys: Sequence, lars: bool = False) -> int:
    """Kernel launches of one update over leaves of dtype triples ``keys``
    ((w, m, g) dtypes); with LARS's trust (``lars``), two more for each
    launch of its norms pass, whose table groups the leaves by (w, g)."""
    n = len(launch_plan(keys))
    if lars:
        n += 2 * len(launch_plan([(w, g) for w, _, g in keys]))
    return n


def _tables(name: str, ws, ms, gs):
    """The device and the launches of one call on CUDA tensors: (dtype
    codes, leaves (k, 4) int64 of w, m, g pointers and lengths, indices
    (k,) int32, chunk offsets (k + 1,) int32) for each launch of
    ``launch_plan``.  ``ms`` None: a pass that reads no m (w's pointer
    stands in).  The checks run once over all the leaves, each reading
    one attribute of every tensor: one CUDA device, contiguous, equal
    lengths, 16-byte aligned, float32 or bfloat16."""
    k = len(ws)
    lists = [ws, gs] if ms is None else [ws, ms, gs]
    if any(len(x) != k for x in lists):
        raise ValueError(f"{name}: lists of {[len(x) for x in lists]} "
                         "leaves")
    every = sum(lists, [])
    devices = set(map(torch.Tensor.get_device, every))
    if len(devices) != 1 or min(devices) < 0:
        got = sorted({str(t.device) for t in every})
        raise ValueError(f"{name}: the kernel takes CUDA tensors on one "
                         f"device (got {got}; CPU tensors take the plain "
                         "version)")
    if not all(map(torch.Tensor.is_contiguous, every)):
        raise ValueError(f"{name}: tensors must be contiguous")
    n = np.fromiter(map(torch.Tensor.numel, every), np.int64,
                    len(every)).reshape(len(lists), k)
    bad = np.flatnonzero((n != n[0]).any(axis=0))
    if bad.size:
        i = int(bad[0])
        raise ValueError(f"{name}: leaf {i}'s tensors differ in length: "
                         f"{[tuple(x[i].shape) for x in lists]}")
    ptr = np.fromiter(map(torch.Tensor.data_ptr, every), np.int64,
                      len(every)).reshape(len(lists), k)
    if int(np.bitwise_or.reduce(ptr, axis=None)) % 16:
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    dtypes = list(map(_DTYPE, every))
    if ms is None:
        ptr = ptr[[0, 0, 1]]
        dtypes = dtypes[:k] + dtypes
    keys = list(zip(dtypes[:k], dtypes[k:2 * k], dtypes[2 * k:]))
    table = np.concatenate([ptr, n[:1]]).T          # (k, 4): w, m, g, n
    out = []
    for (wd, md, gd), idx in launch_plan(keys):
        off = chunk_offsets(table[idx, 3])
        if off[-1] >= 2 ** 31:
            raise ValueError(f"{name}: {off[-1]} chunks in one launch")
        codes = (dtype_code(wd), dtype_code(md), dtype_code(gd))
        out.append((codes, np.ascontiguousarray(table[idx]),
                    np.asarray(idx, dtype=np.int32), off.astype(np.int32)))
    return ws[0].device, out


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def fused_sgd_update_plain(ws, ms, gs, *, lr, trust=None, momentum: float,
                           weight_decay: float, nesterov: bool = False):
    """Plain PyTorch version: ``optim/sgd.py``'s ``_sgd_leaf`` of the
    reference, one operator per step of the formula in float32, looped
    over the leaves (trust[i] for leaf i); updates each w and m in place
    and returns the lists."""
    for i, (w, m, g) in enumerate(zip(ws, ms, gs)):
        g32, w32 = g.float(), w.float()
        if trust is not None:
            g32 = g32 * trust[i]
        gw = g32 + weight_decay * w32
        m_new = momentum * m.float() + gw
        upd = gw + momentum * m_new if nesterov else m_new
        w_new = w32 - lr * upd
        with torch.no_grad():
            w.copy_(w_new)
            m.copy_(m_new)
    return ws, ms


def fused_sgd_update(ws: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                     gs: Sequence[torch.Tensor], *, lr,
                     trust: Optional[torch.Tensor] = None, momentum: float,
                     weight_decay: float, nesterov: bool = False):
    """Lists of leaves: w (float32/bfloat16), m (float32/bfloat16), g
    (float32/bfloat16), each w, m, g of one length; lr a float or a 0-dim
    tensor, trust None (1) or a float32 vector of one entry a leaf.
    Updates every w and m in place and returns the lists.  CPU tensors
    take the plain version; CUDA tensors launch the kernel
    (``launches_per_call`` launches) or raise."""
    ws, ms, gs = list(ws), list(ms), list(gs)
    if not ws:
        return ws, ms
    if ws[0].device.type == "cpu":
        return fused_sgd_update_plain(
            ws, ms, gs, lr=lr, trust=trust, momentum=momentum,
            weight_decay=weight_decay, nesterov=nesterov)
    dev, launches = _tables("fused_sgd_update", ws, ms, gs)
    lr_ptr, lr_value = 0, 0.0
    if isinstance(lr, torch.Tensor) and lr.device.type == "cuda":
        if lr.numel() != 1 or lr.dtype != torch.float32 or lr.device != dev:
            raise ValueError("fused_sgd_update: a tensor lr is one float32 "
                             "on the leaves' device")
        lr_ptr = lr.data_ptr()
    else:
        lr_value = float(lr)
    trust_ptr = 0
    if trust is not None:
        if (trust.device != dev or trust.dtype != torch.float32
                or trust.shape != (len(ws),) or not trust.is_contiguous()):
            raise ValueError(f"fused_sgd_update: trust a contiguous float32 "
                             f"({len(ws)},) on {dev}, got "
                             f"{tuple(trust.shape)} {trust.dtype} "
                             f"{trust.device}")
        trust_ptr = trust.data_ptr()
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for (wc, mc, gc), table, idx, off in launches:
        rc = lib.rt_fused_sgd_update(
            _ptr(table), _ptr(idx), _ptr(off), len(idx), lr_ptr, lr_value,
            trust_ptr, wc, mc, gc, float(momentum), float(weight_decay),
            int(bool(nesterov)), sm_count(dev), stream)
        _build.check(rc, "fused_sgd_update")
        fused_sgd_update.launches += 1
    return ws, ms


fused_sgd_update.launches = 0


class ShardNorms:
    """How LARS's norms of sharded leaves add up over the ranks of
    ``group`` that hold pieces of them (split over data, over model or
    both): each rank's sums of squares are summed over the group, and a
    piece several ranks hold counts once.  ``keep[i]`` false: another
    rank counts all of this rank's leaf i (its sums are zeroed before
    the sum); ``drop[i]``: the (axis, lo, n) pieces of a kept leaf that
    another rank counts (their squares are taken off leaf i's first
    row)."""

    def __init__(self, group, keep: Sequence[bool],
                 drop: Optional[Dict[int, list]] = None):
        self.group = group
        self.keep = np.asarray(keep, dtype=bool)
        self.drop = drop or {}

    def sum_(self, sq: torch.Tensor, leaf_of_row: np.ndarray, ws, gs
             ) -> None:
        """Sum the (rows, 2) float32 sums of squares ``sq`` over the
        group in place; row r belongs to leaf ``leaf_of_row[r]`` of
        ``ws`` / ``gs``."""
        import torch.distributed as dist
        zero = ~self.keep[leaf_of_row]
        if zero.any():
            sq[torch.from_numpy(zero).to(sq.device)] = 0.0
        for i, pieces in self.drop.items():
            rows = np.flatnonzero(leaf_of_row == i)
            if not len(rows):
                continue
            for axis, lo, n in pieces:
                w = ws[i].narrow(axis, lo, n).float()
                g = gs[i].narrow(axis, lo, n).float()
                sq[int(rows[0])] -= torch.stack([w.square().sum(),
                                                 g.square().sum()])
        dist.all_reduce(sq, group=self.group)


def _trust_of(sq: torch.Tensor, *, eta: float, eps: float,
              weight_decay: float) -> torch.Tensor:
    wn, gn = sq.sqrt().unbind(-1)
    t = eta * wn / (gn + weight_decay * wn + eps)
    return torch.where((wn > 0) & (gn > 0), t, torch.ones_like(t))


def lars_trust_plain(ws, gs, *, eta: float, eps: float,
                     weight_decay: float,
                     shards: Optional[ShardNorms] = None) -> torch.Tensor:
    """Plain version: the reference's ``_lars_trust`` a leaf, stacked
    (float32, one entry a leaf).  With ``shards`` the leaves' sums of
    squares are summed over the shard group first (the norms of the
    whole leaves)."""
    if shards is not None:
        sq = torch.stack([torch.stack([w.float().square().sum(),
                                       g.float().square().sum()])
                          for w, g in zip(ws, gs)])
        shards.sum_(sq, np.arange(len(ws)), ws, gs)
        return _trust_of(sq, eta=eta, eps=eps, weight_decay=weight_decay)
    out = []
    for w, g in zip(ws, gs):
        wn = torch.linalg.vector_norm(w.float())
        gn = torch.linalg.vector_norm(g.float())
        t = eta * wn / (gn + weight_decay * wn + eps)
        out.append(torch.where((wn > 0) & (gn > 0), t, torch.ones_like(t)))
    return torch.stack(out)


def lars_trust(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor], *,
               eta: float, eps: float, weight_decay: float,
               shards: Optional[ShardNorms] = None) -> torch.Tensor:
    """LARS's per-leaf trust ratio, eta * ||w|| / (||g|| + wd * ||w|| +
    eps) and 1 where either norm is 0, as a float32 device vector (no
    host sync).  CPU tensors take the plain version; CUDA tensors run
    kernel 5's norms pass over the update's table, two launches for each
    (w, g) dtype pair and each TABLE_LEAVES leaves of it, counted in
    ``fused_sgd_update.launches``.  With ``shards`` (FSDP: leaves that
    are this rank's parts) the chunks' sums of squares are summed over
    the shard group between the two launches."""
    ws, gs = list(ws), list(gs)
    if ws[0].device.type == "cpu":
        return lars_trust_plain(ws, gs, eta=eta, eps=eps,
                                weight_decay=weight_decay, shards=shards)
    dev, launches = _tables("lars_trust", ws, None, gs)
    trust = torch.empty(len(ws), dtype=torch.float32, device=dev)
    lib = _build.library()
    sms = sm_count(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for (wc, _, gc), table, idx, off in launches:
        partial = torch.empty((int(off[-1]), 2), dtype=torch.float32,
                              device=dev)
        rc = lib.rt_lars_norms(_ptr(table), _ptr(idx), _ptr(off), len(idx),
                               partial.data_ptr(), wc, gc, sms, stream)
        _build.check(rc, "lars_trust")
        if shards is not None:
            shards.sum_(partial, np.repeat(idx, np.diff(off)), ws, gs)
        rc = lib.rt_lars_trust(_ptr(table), _ptr(idx), _ptr(off), len(idx),
                               partial.data_ptr(), trust.data_ptr(),
                               float(eta), float(weight_decay), float(eps),
                               stream)
        _build.check(rc, "lars_trust")
        fused_sgd_update.launches += 2
    return trust
