"""The train-step builder (``repro/launch/builders.py``): the step the
reference would build for an (arch x shape x mesh) combination, with its
sharded initial state, ready to run rather than to lower.

Path selection, as the reference's:
  * shard_map path (``core.trainer.make_step``): the paper's explicit
    two-phase collectives, params whole on every rank.  For the archs
    whose params and f32 optimizer state fit whole on a rank.
  * pjit path (``core.trainer.make_pjit_step``): FSDP (ZeRO-3) params
    for the configs past ``FSDP_PARAM_THRESHOLD`` parameters, and every
    MoE config (expert parallelism over ``data``) and ResNet.  The step
    runs with the mesh active, so the MoE runs expert-parallel.
On a mesh with ``model`` over 1 either step trains tensor-parallel
(``core.trainer``: each rank its model shard, under ZeRO-3 its data part
of it) for the dense GQA, GQA + MoE and mamba2 families; the others
raise ``NotImplementedError`` when the plan is built.
The reference's serving lowerables, dry run and HLO accounting have no
counterpart here.

    step = make_train_step(get_config("dbrx-132b").replace(num_layers=1),
                           ShapeConfig("cli", 512, 4, "train"),
                           make_mesh((1, 1), ("data", "model")))
    loss, metrics = step(batch)       # the global batch; this rank's rows
    state = step.finish()             # the trailing deferred update
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.core.sync import GradSync
from repro_torch.core.topology import Topology
from repro_torch.core.trainer import (FsdpPlan, TrainerConfig, local_batch,
                                      make_finalize, make_init_state,
                                      make_pjit_step, make_step)
from repro_torch.launch.train import device_of
from repro_torch.models.model import build_model
from repro_torch.optim import schedules
from repro_torch.optim.sgd import OptimConfig
from repro_torch import sharding
from repro_torch.tree import leaves

FSDP_PARAM_THRESHOLD = 8e9      # params above this can't replicate over DP


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


def param_count(cfg) -> int:
    """The exact parameter count of ``cfg``, from an init on the meta
    device (no memory)."""
    return sum(p.numel() for p in leaves(build_model(cfg).init(0, "meta")))


def needs_fsdp(cfg) -> bool:
    return param_count(cfg) > FSDP_PARAM_THRESHOLD


def use_pjit_path(cfg) -> bool:
    # expert parallelism needs the data axis the pjit step shards over
    return needs_fsdp(cfg) or cfg.moe is not None or cfg.family == "resnet"


def paper_lr_fn(shape: ShapeConfig, base_lr: float = 0.1,
                base_batch: int = 256, steps_per_epoch: int = 100):
    """The paper's recipe: linear scaling + 5-epoch warmup + /10 step
    decay every 30 epochs (§5.3.1), parameterized in steps."""
    peak = schedules.linear_scaled_lr(base_lr, shape.global_batch, base_batch)
    return functools.partial(
        schedules.warmup_step_decay, base_lr=base_lr, peak_lr=peak,
        warmup_steps=5 * steps_per_epoch, decay_every=30 * steps_per_epoch)


@dataclass
class TrainStep:
    """A built training step and its state.  ``step(batch)`` takes the
    global batch, keeps this rank's rows (``trainer.batch_pspecs``) and
    runs one step, with ``mesh`` active on the pjit path; it returns
    (loss, metrics), the data-parallel mean.  ``finish()`` flushes the
    trailing deferred update and returns the state."""
    fn: Callable
    finalize: Callable
    state: Dict[str, Any]
    mesh: Any
    tcfg: TrainerConfig
    lr_fn: Callable
    plan: Optional[FsdpPlan] = None
    tp: Optional[FsdpPlan] = None    # the shard_map step's model layout
    description: str = ""
    n_params: int = field(default=0)

    def _active(self, fn, *args):
        if self.plan is None:
            return fn(*args)
        sharding.set_active_mesh(self.mesh)
        try:
            return fn(*args)
        finally:
            sharding.set_active_mesh(None)

    def __call__(self, batch):
        self.state, out = self._active(self.fn, self.state,
                                       local_batch(batch, self.mesh))
        return out

    def finish(self):
        self.state = self._active(self.finalize, self.state)
        return self.state


def make_train_step(cfg, shape: ShapeConfig, mesh, sync_mode: str = "lsgd",
                    *, zero3: bool = False, device: str = "cuda",
                    lr_fn: Optional[Callable] = None) -> TrainStep:
    """The counterpart of the reference's ``make_train_lowerable``: the
    step that arch would train with on ``mesh`` (the reference's path
    choice, ``use_pjit_path``), the optimizer of its size (bf16
    momentum, pending and gradients past ``FSDP_PARAM_THRESHOLD``), its
    initial state from seed 0 (sharded by the plan on the pjit path) on
    ``device`` (CUDA unless the caller asks for the CPU), and ``lr_fn``
    (default ``paper_lr_fn(shape)``).  ZeRO-3 is on past the threshold,
    as in the reference, or where ``zero3`` forces it (on the pjit
    path, whatever the arch).  A ``model`` axis over 1 splits the
    params along it on either path."""
    dev = device_of(device)
    model = build_model(cfg)
    lr_fn = lr_fn or paper_lr_fn(shape)
    pjit_path = use_pjit_path(cfg) or zero3
    big = needs_fsdp(cfg)
    tcfg = TrainerConfig(
        sync_mode=sync_mode,
        optim=OptimConfig(kind="sgd", momentum=0.9, weight_decay=1e-4,
                          state_dtype="bfloat16" if big else "float32"),
        topology=Topology(intra_group_size=mesh.size("data")
                          if mesh.size("pod") > 1 else None),
        fsdp=pjit_path and (big or zero3),
        pending_dtype="bfloat16" if big else "float32",
        grad_dtype="bfloat16" if big else "float32")
    tp = mesh.size("model")
    plan = FsdpPlan(model, tcfg, mesh) if pjit_path else None
    shard = (FsdpPlan(model, tcfg, mesh, shard_data=False)
             if tp > 1 and not pjit_path else None)
    layout = plan or shard
    state = make_init_state(model, tcfg, dev, layout)(0)
    if pjit_path:
        fn = make_pjit_step(model, tcfg, lr_fn, plan)
    else:
        fn = make_step(model, tcfg, lr_fn,
                       GradSync(sync_mode, tcfg.topology, mesh), shard)
    return TrainStep(
        fn=fn, finalize=make_finalize(model, tcfg, lr_fn, layout),
        state=state, mesh=mesh, tcfg=tcfg, lr_fn=lr_fn, plan=plan, tp=shard,
        description=f"train[{'pjit' if pjit_path else 'shard_map'}/"
                    f"{sync_mode}{'/fsdp' if tcfg.fsdp else ''}"
                    f"{f'/tp{tp}' if tp > 1 else ''}]",
        n_params=param_count(cfg))
