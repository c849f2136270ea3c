"""The LSGD / CSGD trainer (``repro/core/trainer.py``), one process per
data-parallel rank on ``torch.distributed``.

The step body is the reference's ``_algorithm``: in the deferred modes
(``lsgd``, ``lsgd_rsag``, ``lsgd_compressed``) the update of step t-1 is
applied at the top of step t, after step t's batch was fetched, then
the local gradient is taken and synced.  The paper's overlap, in torch
idiom: step t runs phase 1 (the fast, intra-group mean) and issues
phase 2 (the communicator all-reduce) with ``async_op=True`` on the
pending buffers; step t+1 waits for it just before the deferred update.
``csgd`` syncs flat and updates at once; ``lsgd_eager`` runs both phases
and updates at once.

Exact-sequence property: ``finalize`` applies the trailing pending
update, after which LSGD's params equal CSGD's after as many steps.

The state is a dict: params, opt, step (a host int: the schedule needs
no device value), pending (deferred modes), residual (compressed mode)
and inflight (the phase-2 collective not yet waited for).  Params and
optimizer state are updated in place.  The reference's pjit/FSDP path
(``make_pjit_step``) is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.configs.base import _DTYPES
from repro_torch.core.autodiff import value_and_grad
from repro_torch.core.sync import GradSync
from repro_torch.core.topology import Topology
from repro_torch.optim.sgd import OptimConfig, apply_update, init_state
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class TrainerConfig:
    sync_mode: str = "lsgd"       # csgd | lsgd | lsgd_eager | lsgd_rsag |
                                  # lsgd_compressed
    optim: OptimConfig = field(default_factory=OptimConfig)
    topology: Topology = field(default_factory=Topology)
    pending_dtype: str = "float32"  # deferred-gradient buffer dtype
    grad_dtype: str = "float32"   # gradient sync dtype

    @property
    def defer_update(self) -> bool:
        return self.sync_mode in ("lsgd", "lsgd_rsag", "lsgd_compressed")

    @property
    def layered(self) -> bool:
        return self.sync_mode != "csgd"


def make_init_state(model, tcfg: TrainerConfig, device):
    """Returns init_fn(seed) -> state dict on ``device``."""

    def init_fn(seed: int):
        params = model.init(seed, device)
        state = {"params": params, "opt": init_state(params, tcfg.optim),
                 "step": 0, "inflight": None}
        if tcfg.defer_update:
            pdt = _DTYPES[tcfg.pending_dtype]
            state["pending"] = tree_map(
                lambda p: torch.zeros(p.shape, dtype=pdt, device=p.device),
                params)
        if tcfg.sync_mode == "lsgd_compressed":
            state["residual"] = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
        return state

    return init_fn


def _apply_pending(state, lr_fn, ocfg) -> None:
    """Deferred update of step t-1 (Alg. 3 line 10): waits for its phase
    2 first; a no-op at step 0."""
    if state.get("inflight") is not None:
        state["inflight"].wait()
        state["inflight"] = None
    if state["step"] > 0:
        apply_update(state["params"], state["opt"], state["pending"],
                     lr_fn(state["step"] - 1), ocfg)


def make_step(model, tcfg: TrainerConfig, lr_fn, sync: GradSync = None):
    """Returns step(state, batch) -> (state, (loss, metrics)); ``state``
    is updated and returned.  ``sync`` defaults to a ``GradSync`` over
    the default process group (the identity on one rank)."""
    sync = sync or GradSync(tcfg.sync_mode, tcfg.topology)
    ocfg = tcfg.optim
    gdt = _DTYPES[tcfg.grad_dtype]

    def step(state, batch):
        if tcfg.defer_update:
            _apply_pending(state, lr_fn, ocfg)
        loss, metrics, grads = value_and_grad(model.loss, state["params"],
                                              batch)
        grads = tree_map(lambda g: g.to(gdt), grads)
        if tcfg.sync_mode == "csgd":
            sync.flat(grads)
        else:
            sync.phase1(grads)
        if tcfg.defer_update:
            pdt = _DTYPES[tcfg.pending_dtype]
            state["pending"] = tree_map(lambda g: g.to(pdt), grads)
            state["inflight"] = sync.phase2(state["pending"],
                                            state.get("residual"))
        else:
            if tcfg.layered:
                inflight = sync.phase2(grads)
                if inflight is not None:
                    inflight.wait()
            apply_update(state["params"], state["opt"], grads,
                         lr_fn(state["step"]), ocfg)
        state["step"] += 1
        if sync.world > 1:          # report the data-parallel mean
            loss = loss.clone()
            dist.all_reduce(loss)
            loss /= sync.world
        return state, (loss, metrics)

    return step


def make_finalize(model, tcfg: TrainerConfig, lr_fn):
    """Flush the trailing pending update (makes LSGD == CSGD exactly)."""

    def finalize(state):
        if not tcfg.defer_update:
            return state
        _apply_pending(state, lr_fn, tcfg.optim)
        state["pending"] = tree_map(torch.zeros_like, state["pending"])
        return state

    return finalize
