"""Parameters across the two packages.

The JAX package's param pytree flattens to ``{path: array}`` with the
``::``-joined tree paths of ``repro/checkpoint/checkpoint.py:_flatten``
(``"layers::run_0::attn::wq"``, stacked per run with a leading layer
axis).  The port keeps exactly that nesting, as a nested dict of tensors,
so the mapping is 1:1 and needs no renaming or transposes.  A trainer
state (params, optimizer state, pending update, step) maps the same way,
so the two trainers can start from one point.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import items

SEP = "::"


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")      # an own, writable copy
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes supplies it, torch
        # cannot read it): move the 16 raw bits over unchanged
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_flat(flat: Dict[str, np.ndarray], *,
              device: Optional[torch.device | str] = None,
              dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """``{"a::b::c": array}`` -> nested dict of tensors on ``device``
    (cast to ``dtype`` where given)."""
    out: Dict[str, Any] = {}
    for key, arr in flat.items():
        t = _to_tensor(np.asarray(arr))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        if device is not None:
            t = t.to(device)
        node = out
        *parents, leaf = key.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def to_flat(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested dict of tensors -> ``{"a::b::c": float32-or-int array}``
    (bf16 leaves come back as float32, as the reference's checkpoints
    store them)."""
    flat: Dict[str, np.ndarray] = {}
    for path, v in items(params):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat[SEP.join(path)] = t.numpy()
    return flat


def state_from_flat(flat: Dict[str, np.ndarray], *,
                    device: Optional[torch.device | str] = None
                    ) -> Dict[str, Any]:
    """A whole trainer state of the JAX package, flattened by tree path
    (``"params::…"``, ``"opt::m::…"``, ``"pending::…"``, ``"step"``,
    optionally ``"residual::…"`` and AdamW's ``"opt::v::…"`` /
    ``"opt::t"``), as the port's trainer state: the same nesting, each
    leaf keeping its dtype, the step counters as host ints and no phase-2
    collective in flight."""
    state = from_flat(flat, device=device)
    state["step"] = int(np.asarray(flat["step"]))
    if "t" in state["opt"]:
        state["opt"]["t"] = int(np.asarray(flat["opt::t"]))
    state["inflight"] = None
    return state

