"""Optimizers (``repro/optim/sgd.py``): SGD with momentum and weight
decay in the PyTorch convention the paper's implementation uses,

    m <- mu * m + (g + wd * w)
    w <- w - lr * m

LARS (a per-tensor trust ratio on the same update) and AdamW.
``apply_update`` is the one function the LSGD trainer defers.  sgd and
lars always go through ``fused_sgd_update`` (``kernels/fused_update.py``)
once for the whole tree, its leaves in the tree's flatten order, with
the LARS trust computed on the device (``fused_update.lars_trust``): on
the card they launch the hand-written CUDA kernel (one launch a dtype
triple for sgd, three for lars), on CPU tensors they run the plain
PyTorch version, which is the reference's ``_sgd_leaf`` and
``_lars_trust`` operator for operator.  The reference's ``fused`` option
has no counterpart here.

The port updates params and optimizer state in place and returns them
(the reference returns new trees): a step that allocated fresh copies
would double the parameter and state memory for its length.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import _DTYPES
from repro_torch.kernels.fused_update import (ShardNorms, fused_sgd_update,
                                              lars_trust)
from repro_torch.tree import tree_map, zip_leaves


@dataclass(frozen=True)
class OptimConfig:
    kind: str = "sgd"            # sgd | lars | adamw
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False
    # LARS
    lars_eta: float = 0.001
    lars_eps: float = 1e-9
    # AdamW
    beta1: float = 0.9
    beta2: float = 0.95
    adam_eps: float = 1e-8
    # execution
    state_dtype: str = "float32"  # momentum/moments dtype


def init_state(params, cfg: OptimConfig) -> Dict[str, Any]:
    """Zero optimizer state (``state_dtype``, f32 by default whatever the
    param dtype)."""
    dt = _DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    if cfg.kind in ("sgd", "lars"):
        return {"m": tree_map(zeros, params)}
    if cfg.kind == "adamw":
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": 0}
    raise ValueError(cfg.kind)


@torch.no_grad()
def apply_update(params, state, grads, lr, cfg: OptimConfig,
                 shards: Optional[ShardNorms] = None) -> Tuple[Any, Any]:
    """One optimizer step, in place; returns (params, state).  ``lr`` is
    a float or a 0-dim tensor.  ``shards`` (FSDP): which leaves are this
    rank's parts of sharded leaves, whose LARS norms are summed over the
    shard group (SGD is elementwise and needs nothing)."""
    if cfg.kind in ("sgd", "lars"):
        ws, ms, gs = zip_leaves(params, state["m"], grads)
        trust = None
        if cfg.kind == "lars":
            trust = lars_trust(ws, gs, eta=cfg.lars_eta, eps=cfg.lars_eps,
                               weight_decay=cfg.weight_decay, shards=shards)
        fused_sgd_update(ws, ms, gs, lr=lr, trust=trust,
                         momentum=cfg.momentum,
                         weight_decay=cfg.weight_decay,
                         nesterov=cfg.nesterov)
        return params, state
    if cfg.kind == "adamw":
        step = state["t"] + 1
        c1, c2 = 1 - cfg.beta1 ** step, 1 - cfg.beta2 ** step

        def leaf(w, m, v, g):
            g32, w32 = g.float(), w.float()
            m_new = cfg.beta1 * m.float() + (1 - cfg.beta1) * g32
            v_new = cfg.beta2 * v.float() + (1 - cfg.beta2) * g32 ** 2
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.adam_eps)
            w.copy_(w32 - lr * (upd + cfg.weight_decay * w32))
            m.copy_(m_new)
            v.copy_(v_new)

        tree_map(leaf, params, state["m"], state["v"], grads)
        state["t"] = step
        return params, state
    raise ValueError(cfg.kind)
