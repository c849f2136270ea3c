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
optimizer state are updated in place.

**The FSDP / pjit path** (``make_pjit_step``, the reference's step for
the 100B+ and expert-parallel configs): ZeRO-3 over the data-parallel
ranks of a mesh (``launch.mesh``).  ``FsdpPlan`` places each leaf by the
reference's training specs (``sharding.train_plan``): a leaf split over
``data`` is held as this rank's part, and params, momentum and the
pending buffer all hold that part.  The loss reads a split leaf through
an all-gather over the data group whose backward reduce-scatters the
gradient back to the parts (``sharding.Part``): a decoder gathers each
layer's leaves when the layer runs, so a gathered layer lives for the
layer (under remat it is gathered again for the backward), and the
embedding, head and final norm once a loss; ResNet and the
encoder-decoder gather every leaf when the loss starts.  The routed
experts under expert parallelism are read as this rank's own
(``models/moe.py``).
After the backward, whole leaves' gradients are summed over the data
group (phase 1, the fast axis), then every gradient part over the pods
(phase 2, the slow axis, issued asynchronously) and divided by the
data-parallel width.  LSGD's deferral holds: step t's averaged gradient
part becomes ``pending``, its pod collective may be in flight until the
top of step t+1, where it is applied.  The reference's pjit step syncs
through the identity, so ``lsgd_rsag`` runs there as ``lsgd`` does and
``lsgd_compressed`` (an error-feedback residual) raises.  LARS sums its
norms over the shard group (``kernels.fused_update.ShardNorms``).

**Tensor parallelism** (a mesh with ``model`` over 1, either step): a
rank at model coordinate m holds shard m of each split module
(``sharding.TpPlan``: heads, kv groups, channels, vocab, the experts'
hidden width), and under ZeRO-3 its data part of that shard, so a leaf
may split on two dims.  The loss reads the shard through a
``PartTree`` with the rank's ``ModelAxis`` (``transformer.apply_layer_rank``:
copy-in and reduce-out collectives over the model group).  After the
backward the pieces that several model ranks hold (a shared kv head,
mamba's B and C columns) have their gradients summed over those ranks
(``FsdpPlan.reduce_model``); then the data-parallel sync runs over the
(pod, data) ranks of this rank's model coordinate, exactly as without a
model axis.  The loss each model rank reports is the same; it is
averaged over the data-parallel ranks only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.configs.base import _DTYPES
from repro_torch.core.autodiff import value_and_grad
from repro_torch.core.sync import SYNC_MODES, GradSync, Inflight
from repro_torch.core.topology import Topology
from repro_torch.kernels.fused_update import ShardNorms
from repro_torch.models import moe
from repro_torch.optim.sgd import OptimConfig, apply_update, init_state
from repro_torch.tree import items, leaves, tree_map, unflatten, zip_leaves


@dataclass(frozen=True)
class TrainerConfig:
    sync_mode: str = "lsgd"       # csgd | lsgd | lsgd_eager | lsgd_rsag |
                                  # lsgd_compressed
    optim: OptimConfig = field(default_factory=OptimConfig)
    topology: Topology = field(default_factory=Topology)
    fsdp: bool = False            # the pjit step shards every large leaf
    pending_dtype: str = "float32"  # deferred-gradient buffer dtype
    grad_dtype: str = "float32"   # gradient sync dtype (bf16 halves the
                                  # FSDP sync's bytes; the update still
                                  # computes in f32)

    @property
    def defer_update(self) -> bool:
        return self.sync_mode in ("lsgd", "lsgd_rsag", "lsgd_compressed")

    @property
    def layered(self) -> bool:
        return self.sync_mode != "csgd"


def make_init_state(model, tcfg: TrainerConfig, device, plan=None):
    """Returns init_fn(seed) -> state dict on ``device``.  With an
    ``FsdpPlan`` the params are the unsharded init sliced to this rank's
    parts (so weights carried from the reference shard the same way),
    and the optimizer state and pending buffers take the parts' shapes."""

    def init_fn(seed: int):
        params = model.init(seed, device)
        if plan is not None:
            params = plan.shard(params)
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


def _apply_pending(state, lr_fn, ocfg, shards=None) -> None:
    """Deferred update of step t-1 (Alg. 3 line 10): waits for its phase
    2 first; a no-op at step 0."""
    if state.get("inflight") is not None:
        state["inflight"].wait()
        state["inflight"] = None
    if state["step"] > 0:
        apply_update(state["params"], state["opt"], state["pending"],
                     lr_fn(state["step"] - 1), ocfg, shards)


def make_step(model, tcfg: TrainerConfig, lr_fn, sync: GradSync = None,
              plan: Optional["FsdpPlan"] = None):
    """Returns step(state, batch) -> (state, (loss, metrics)); ``state``
    is updated and returned.  ``sync`` defaults to a ``GradSync`` over
    the default process group (the identity on one rank).  ``plan``: a
    tensor-parallel rank's layout (``FsdpPlan(..., shard_data=False)``:
    its model shard, whole over data), the state sharded by it
    (``make_init_state(..., plan=plan)``)."""
    sync = sync or GradSync(tcfg.sync_mode, tcfg.topology)
    ocfg = tcfg.optim
    gdt = _DTYPES[tcfg.grad_dtype]

    def step(state, batch):
        norms = plan.norms(state["params"]) if plan is not None else None
        if tcfg.defer_update:
            _apply_pending(state, lr_fn, ocfg, norms)
        loss, metrics, grads = value_and_grad(
            model.loss, state["params"], batch,
            wrap=plan.wrap(state["params"], False) if plan else None)
        if plan is not None:
            plan.reduce_model(grads)
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
                         lr_fn(state["step"]), ocfg, norms)
        state["step"] += 1
        return state, (sync.mean(loss), metrics)

    return step


def make_finalize(model, tcfg: TrainerConfig, lr_fn, plan=None):
    """Flush the trailing pending update (makes LSGD == CSGD exactly);
    ``plan`` the ``FsdpPlan`` of a sharded state (over data, model or
    both)."""

    def finalize(state):
        if not tcfg.defer_update:
            return state
        _apply_pending(state, lr_fn, tcfg.optim,
                       plan.norms(state["params"]) if plan is not None
                       else None)
        for p in leaves(state["pending"]):  # in place: no second tree
            p.zero_()
        return state

    return finalize


# ---------------------------------------------------------------------------
# the FSDP / pjit path
# ---------------------------------------------------------------------------

# the state subtrees laid out like the params (lsgd_compressed's
# residual only on the shard_map step: the pjit step refuses that mode)
_MIRRORS = ("params", "pending", "residual")


def _cast_(tree, dtype) -> None:
    """Every leaf of ``tree`` to ``dtype``, replaced in place (the old
    leaf freed as soon as its copy exists)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _cast_(v, dtype)
        else:
            tree[k] = v.to(dtype)


class FsdpPlan:
    """The layout of a trainer state on this rank of ``mesh``: along
    ``model`` its shard of each split module (``tp``, a
    ``sharding.TpPlan``, None without a model axis), and over ``data``
    the reference's training specs of ``model``'s params (``fsdp`` per
    ``tcfg``; the routed experts split over ``data`` either way),
    legalized for the mesh, as ``sharding.Shard`` placements of the
    model part (``places``; with ``shard_data`` False, the launcher's
    shard_map step on a tensor-parallel mesh, none: the model part is
    whole over data); and the mesh's groups the steps reduce over."""

    def __init__(self, model, tcfg: TrainerConfig, mesh, *,
                 shard_data: bool = True):
        self.mesh, self.cfg = mesh, model.cfg
        meta = model.init(0, "meta")
        self.tp = (sharding.TpPlan(model.cfg, meta, mesh)
                   if mesh.size("model") > 1 else None)
        self.places = (sharding.train_plan(meta, mesh, fsdp=tcfg.fsdp)
                       if shard_data else tree_map(lambda _: None, meta))
        for pl in leaves(self.places):
            if pl is not None and pl.axes != ("data",):
                raise NotImplementedError(
                    f"the FSDP step splits leaves over data only, not {pl}")
        self.n_dp = mesh.size(("pod", "data"))
        self.data = mesh.group("data")
        self.pod = mesh.group("pod")
        self.dp = mesh.group(("pod", "data"))
        self._experts = sharding.map_paths(
            lambda path, _: "moe/experts/" in path, self.places)

    def norms(self, params) -> Optional[ShardNorms]:
        """How LARS sums the norms of ``params``' leaves (in their
        order) over the ranks of a model replica (data x model): the
        data-split ones and the model parts summed, a piece that several
        ranks hold counted once."""
        split = [pl is not None for pl in zip_leaves(params,
                                                     self.places)[1]]
        over_data = self.data is not None and any(split)
        lead = self.mesh.index("data") == 0
        keep = [s or lead or not over_data for s in split]
        if self.tp is None:
            return ShardNorms(self.data, keep) if over_data else None
        keep_m, drop = self.tp.counts()
        keep = [a and b for a, b in zip(keep, keep_m)]
        group = self.mesh.group(("data", "model") if over_data
                                else "model")
        return ShardNorms(group, keep,
                          {i: d for i, d in drop.items() if keep[i]})

    # -- the state ----------------------------------------------------------

    def shard(self, tree):
        """This rank's parts of a tree of whole leaves (params-shaped), in
        the plan's leaf order."""
        def part(pl, mp, x):
            if self.tp is not None:
                x = sharding.take_part(x, mp, self.tp.index, self.tp.size)
            return x if pl is None else pl.take(x)

        return tree_map(part, self.places, self._model_places(tree), tree)

    def _whole(self, x, pl, mp):
        """The whole leaf of this rank's part ``x`` (``pl`` its data
        placement, ``mp`` its model one): gathered over data, then over
        model."""
        if isinstance(pl, sharding.Shard):
            x = sharding.gather_dim(x, pl.dim, pl.size, self.data)
        return x if self.tp is None else self.tp.gather_leaf(x, mp)

    def _model_places(self, tree):
        return (self.tp.places if self.tp is not None
                else tree_map(lambda _: None, tree))

    def gather(self, tree):
        """The whole leaves of a tree of this rank's parts (a collective
        over the data and model groups)."""
        return tree_map(lambda x, pl, mp: self._whole(x, pl, mp), tree,
                        self.places, self._model_places(tree))

    def _state_map(self, fn, state):
        out = dict(state)
        for k in _MIRRORS:
            if out.get(k) is not None:
                out[k] = fn(out[k])
        out["opt"] = {k: fn(v) if isinstance(v, dict) else v
                      for k, v in state["opt"].items()}
        return out

    def shard_state(self, state):
        """A trainer state of whole leaves cut to this rank's parts."""
        return self._state_map(self.shard, state)

    def whole_items(self, state):
        """(path, leaf) of every leaf of a sharded trainer state, in leaf
        order, each split leaf gathered whole only when it is reached (a
        collective every rank joins): a consumer that drops each leaf
        before taking the next holds one whole leaf at a time."""
        places = dict(items(self._state_map(lambda _: self.places, state)))
        model = dict(items(self._state_map(
            lambda t: self._model_places(t), state)))
        for path, x in items(state):
            pl, mp = places.get(path), model.get(path)
            if isinstance(pl, sharding.Shard) or isinstance(
                    mp, sharding.Split):
                x = self._whole(x, pl, mp)
            yield path, x

    # -- the step -------------------------------------------------------------

    def ep(self) -> bool:
        """Whether the loss runs expert-parallel (``moe.ep_mesh``), on
        this plan's mesh."""
        mesh = moe.ep_mesh(self.cfg)
        if mesh is not None and mesh is not self.mesh:
            raise ValueError("the active mesh is not the FSDP plan's mesh")
        return mesh is not None

    def wrap(self, params, ep: bool):
        """The params the loss reads, from the aliases of this rank's
        parts: a decoder's split leaves as ``sharding.Part``s in a
        ``PartTree`` (gathered over data layer by layer as the forward
        runs; with the rank's ``ModelAxis`` on a model axis), other
        models' gathered whole at once; the routed experts under expert
        parallelism as this rank's own."""
        axis = self.tp.axis if self.tp is not None else None
        if self.data is None and axis is None:       # nothing is split
            return None
        lazy = self.cfg.family not in ("resnet", "audio")

        def read(p, pl, expert):
            if pl is None or (ep and expert):
                return p
            part = sharding.Part(p, pl.dim, pl.size, self.data)
            return part if lazy else part.full()

        def f(ps):
            tree = tree_map(read, unflatten(params, ps), self.places,
                            self._experts)
            return sharding.PartTree(tree, axis) if lazy else tree

        return f

    def reduce_model(self, grads) -> None:
        """Sum the gradients of the pieces that several model ranks hold
        over those ranks (``TpPlan.reduce_partial``); nothing without a
        model axis."""
        if self.tp is not None:
            self.tp.reduce_partial(grads)

    def reduce_data(self, grads) -> None:
        """Phase 1: sum the whole leaves' gradients over the data group
        (split leaves' parts were summed by their reduce-scatter, local
        experts' by the all-to-all's backward)."""
        if self.data is None:
            return
        for g, pl in zip(*zip_leaves(grads, self.places)):
            if pl is None:
                dist.all_reduce(g, group=self.data)

    def reduce_pods(self, grads) -> Inflight:
        """Phase 2: sum every gradient part over the pods (issued
        asynchronously) and divide by the data-parallel width."""
        gs, n = leaves(grads), self.n_dp

        def finish():
            if n > 1:
                for g in gs:
                    g.div_(n)

        works = ([] if self.pod is None else
                 [dist.all_reduce(g, group=self.pod, async_op=True)
                  for g in gs])
        return Inflight(works, finish)

    def mean(self, loss, metrics):
        """The data-parallel mean of the loss and the metrics."""
        if self.dp is None:
            return loss, metrics
        vals = torch.stack([loss.float()] + [v.float()
                                             for v in metrics.values()])
        dist.all_reduce(vals, group=self.dp)
        vals /= self.n_dp
        return vals[0], dict(zip(metrics, vals[1:]))


def make_pjit_step(model, tcfg: TrainerConfig, lr_fn, plan: FsdpPlan):
    """The reference's pjit step (``_algorithm`` with an identity sync)
    on a state sharded by ``plan`` (``make_init_state(..., plan=plan)``):
    step(state, batch) -> (state, (loss, metrics)), ``batch`` this rank's
    rows of the global batch (``local_batch``)."""
    if tcfg.sync_mode not in SYNC_MODES:
        raise ValueError(f"sync mode {tcfg.sync_mode!r} not in {SYNC_MODES}")
    if tcfg.sync_mode == "lsgd_compressed":
        raise ValueError(
            "lsgd_compressed does not run on the FSDP / pjit step: the "
            "reference's pjit step syncs through the identity (autodiff of "
            "the global loss already averages), which carries no "
            "error-feedback residual; train it through make_step")
    ocfg = tcfg.optim
    gdt, pdt = _DTYPES[tcfg.grad_dtype], _DTYPES[tcfg.pending_dtype]

    def step(state, batch):
        if tcfg.defer_update:
            _apply_pending(state, lr_fn, ocfg, plan.norms(state["params"]))
            state["pending"] = None     # applied: freed before the backward
        loss, metrics, grads = value_and_grad(
            model.loss, state["params"], batch,
            wrap=plan.wrap(state["params"], plan.ep()))
        plan.reduce_model(grads)
        _cast_(grads, gdt)
        plan.reduce_data(grads)
        if tcfg.defer_update:
            _cast_(grads, pdt)
            state["pending"] = grads
            state["inflight"] = plan.reduce_pods(grads)
        else:
            plan.reduce_pods(grads).wait()
            apply_update(state["params"], state["opt"], grads,
                         lr_fn(state["step"]), ocfg,
                         plan.norms(state["params"]))
        state["step"] += 1
        return state, plan.mean(loss, metrics)

    return step


def state_pspecs(state, *, fsdp: bool):
    """The reference's spec tree of a trainer state: params by
    ``sharding.param_pspecs``, the momentum, pending and residual trees
    as the params, the counters whole."""
    pspec = sharding.param_pspecs(state["params"], fsdp=fsdp)
    specs = {"params": pspec,
             "opt": {k: () if k == "t" else pspec for k in state["opt"]},
             "step": ()}
    for k in ("pending", "residual"):
        if k in state:
            specs[k] = pspec
    return specs


def batch_pspecs(batch, mesh):
    """Every batch leaf split on its rows over the mesh's data-parallel
    axes (pod, data)."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return {k: (dp,) + (None,) * (v.dim() - 1) for k, v in batch.items()}


def local_batch(batch, mesh):
    """This rank's rows of a global batch under ``batch_pspecs``: its
    (pod, data) position's equal share, in rank order."""
    n, i = mesh.size(("pod", "data")), mesh.index(("pod", "data"))
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch leaf {k}: {v.shape[0]} rows over {n} "
                             "data-parallel ranks")
        per = v.shape[0] // n
        out[k] = v[i * per:(i + 1) * per]
    return out
