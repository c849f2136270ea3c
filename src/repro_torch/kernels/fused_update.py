"""Fused SGD-momentum (+ LARS trust) parameter update, in place.

Replaces the Pallas TPU kernel ``repro/kernels/fused_update.py``
``fused_sgd_update_2d`` (reached through ``ops.fused_sgd_update`` from
``optim/sgd.py`` ``apply_update(fused=True)``): the memory-bound update
where LSGD's deferred gradient lands at the top of each step.  CUDA
source: ``csrc/fused_update.cu``.

    g' = trust * g + wd * w
    m' = mu * m + g'
    w' = w - lr * (nesterov ? g' + mu * m' : m')

Bound on the H100: bytes — w, m and g read once, w and m written once
(16 bytes per parameter for bf16 w, f32 m and g).  Design: one streaming
pass per leaf with 16-byte vector loads, ``lr`` and ``trust`` read from
a device pair so that LARS never syncs the host, no padding to tiles.
The port updates ``w`` and ``m`` in place (the reference returns new
arrays): an optimizer step that allocated fresh copies would double the
parameter and momentum memory for the length of the step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import dtype_code, require_cuda, sm_count

THREADS = 256
CTAS_PER_SM = 16


def _scalar(x, device) -> torch.Tensor:
    """A float or a 0-dim tensor -> 0-dim float32 tensor on ``device``
    (a fill, not a host copy, for a float)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def fused_sgd_update_plain(w, m, g, *, lr, trust=None, momentum: float,
                           weight_decay: float, nesterov: bool = False):
    """Plain PyTorch version (mirrors ``optim/sgd.py`` ``_sgd_leaf``, one
    operator per step of the formula, in float32); updates w and m in
    place and returns them."""
    g32, w32 = g.float(), w.float()
    if trust is not None:
        g32 = g32 * trust
    gw = g32 + weight_decay * w32
    m_new = momentum * m.float() + gw
    upd = gw + momentum * m_new if nesterov else m_new
    w_new = w32 - lr * upd
    with torch.no_grad():
        w.copy_(w_new)
        m.copy_(m_new)
    return w, m


def fused_sgd_update(w: torch.Tensor, m: torch.Tensor, g: torch.Tensor, *,
                     lr, trust: Optional[torch.Tensor] = None,
                     momentum: float, weight_decay: float,
                     nesterov: bool = False):
    """w (float32/bfloat16), m (float32/bfloat16), g float32, one shape;
    lr a float or a 0-dim tensor, trust None (1) or a 0-dim tensor.
    Updates w and m in place and returns them.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if w.device.type == "cpu":
        return fused_sgd_update_plain(
            w, m, g, lr=lr, trust=trust, momentum=momentum,
            weight_decay=weight_decay, nesterov=nesterov)
    require_cuda("fused_sgd_update", w, m, g)
    if not (w.shape == m.shape == g.shape) or g.dtype != torch.float32:
        raise ValueError("fused_sgd_update: w, m, g of one shape and g "
                         f"float32, got {tuple(w.shape)} {tuple(m.shape)} "
                         f"{tuple(g.shape)} {g.dtype}")
    for t in (w, m, g):
        if t.data_ptr() % 16:
            raise ValueError("fused_sgd_update: tensors must be 16-byte "
                             "aligned")
    n = w.numel()
    if n == 0:
        return w, m
    dev = w.device
    scalars = torch.stack([_scalar(lr, dev),
                           _scalar(1.0 if trust is None else trust, dev)])
    ctas = max(1, min(-(-n // (8 * THREADS)), sm_count(dev) * CTAS_PER_SM))
    lib = _build.library()
    rc = lib.rt_fused_sgd_update(
        w.data_ptr(), m.data_ptr(), g.data_ptr(), scalars.data_ptr(), n,
        dtype_code(w.dtype), dtype_code(m.dtype), float(momentum),
        float(weight_decay), int(bool(nesterov)), ctas,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_sgd_update")
    fused_sgd_update.launches += 1
    return w, m


fused_sgd_update.launches = 0
