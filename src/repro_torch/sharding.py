"""The port's partition plans (``repro/sharding.py``): the training
plan over a rank mesh, and the tensor-parallel serving plan.

**Training** (``param_pspecs``, ``filter_spec_for_mesh``,
``legalize_pspecs``, ``placements``): the reference's ``_RULES`` and its
FSDP rule, one spec a leaf (a tuple with an entry a dim: None, an axis
name or a tuple of names), matched against the leaf's ``/``-joined path.
The routed experts split over ``data`` always (expert parallelism);
``fsdp`` also splits the first large replicated dim of every other
matched leaf over ``data``, skipping the stacked-layer axis of a leaf of
three dims or more.  ``placements`` turns the legalized specs into what
a rank holds over the data-parallel axes: ``Shard(dim, axes)`` (this
rank's equal slice along dim over those mesh axes) or None (the whole
leaf).  A ``model`` entry is left to ``TpPlan``, the tensor-parallel
training plan: a rank at model coordinate m holds shard m of each split
module, cut by the serving plan's unit boundaries below (heads, kv
groups, channels, vocab; the routed experts by their hidden width), and
a module whose units the model width does not divide runs whole on
every model rank.  So a leaf may split on two dims: ``model`` by
``TpPlan`` and ``data`` by its ``Shard`` of the model part.  The
cross-shard points of a rank's forward are autograd-aware collectives
over the model group (``ModelAxis``: copy-in, reduce-out, sum-all).
``set_active_mesh`` is the reference's switch for expert parallelism
(``models/moe.py``).

**Serving** (``serve_param_pspecs`` / ``serve_cache_pspecs`` of the
reference), written for explicit per-shard tensors.

An engine over a slice of ``tp`` devices holds ``tp`` shards, shard ``s``
on ``devices[s]`` (a slice may name one device twice: that is how one
card holds two shards).  Each param leaf and each paged-cache leaf has a
placement:

  ``Split``   the leaf splits along one axis into the shards' parts, by
              heads (attention, MLA, mamba), channels (the dense MLP's
              and the shared expert's hidden width, the RG-LRU's width),
              experts (routed experts, expert-parallel) or vocab (the
              embedding rows and the lm head's columns)
  ``EVERY``   a whole copy on every shard (MLA's latent projections, the
              MoE router; the MLA latent pools)
  ``None``    whole on shard 0 alone (the norms, which the slice applies
              once, and every module the slice cannot split)

Leaves are matched by the same ``/``-joined paths as the reference's
``_RULES``, and legalized as the reference legalizes: a module whose
units the slice width does not divide (2 kv heads over 3 shards, a
vocabulary of 50,280 over 16) is not split.  A split never cuts through
a head, a kv group or an expert: attention splits when each shard's
query heads see whole kv groups (``H % tp == 0`` and ``tp`` dividing
``KV`` or ``KV`` dividing ``tp``; in the latter case a shard holds the
one kv head its queries read).

Where the reference's column split would cut through a group, the port
splits by the group's structure instead:
  - mamba's ``in_proj`` is ``[z | x | B | C | dt]`` with B and C shared
    by the heads of a group: a shard holds its heads' z, x and dt
    columns and every B and C column (the conv's B and C channels too),
    unless the groups split as well (``n_groups % tp == 0``);
  - the RG-LRU's ``w_r`` / ``w_i`` split by output columns as the
    reference's do, but each shard's gates read the whole post-conv
    ``xr``, which the slice gathers first (``rglru.rglru_steps``).
``tests/test_torch_tp.py`` holds the plan against the reference's specs
leaf by leaf and lists these deviations.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves, split_tree

# ---------------------------------------------------------------------------
# the training plan
# ---------------------------------------------------------------------------

_ACTIVE_MESH = None


def set_active_mesh(mesh) -> None:
    """Make ``mesh`` (``launch.mesh.Mesh``) the active one, or clear it
    with None.  An active mesh with a ``data`` axis turns expert
    parallelism on in the training MoE."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


def axis_size(name: str) -> int:
    """Ranks along ``name`` on the active mesh (1 without one or without
    that axis)."""
    return 1 if _ACTIVE_MESH is None else _ACTIVE_MESH.size(name)


# Matched against the '/'-joined path of each param leaf, first match
# wins; written for the per-layer shape, leading stacked-layer axes
# padded with None (the reference's table, entry for entry).
_RULES = [
    # embeddings / unembedding: vocab over model
    (r"embed/embedding$",        ("model", None)),
    (r"lm_head/w$",              (None, "model")),
    (r"pos_embed/embedding$",    (None, None)),
    # attention
    (r"attn/wq$",                (None, "model")),
    (r"attn/wk$",                (None, "model")),
    (r"attn/wv$",                (None, "model")),
    (r"attn/wo$",                ("model", None)),
    (r"attn/[bw]?b[qkv]$",       ("model",)),
    # MLA
    (r"attn/wq_a$",              (None, None)),
    (r"attn/wq_b$",              (None, "model")),
    (r"attn/wkv_a$",             (None, None)),
    (r"attn/wkv_b$",             (None, "model")),
    (r"attn/(q_norm|kv_norm)/scale$", (None,)),
    # dense mlp
    (r"mlp/w_gate$",             (None, "model")),
    (r"mlp/w_up$",               (None, "model")),
    (r"mlp/w_down$",             ("model", None)),
    # MoE: experts over data (expert parallel), hidden over model
    (r"moe/router/w$",           (None, None)),
    (r"moe/experts/w_gate$",     ("data", None, "model")),
    (r"moe/experts/w_up$",       ("data", None, "model")),
    (r"moe/experts/w_down$",     ("data", "model", None)),
    (r"moe/shared/w_gate$",      (None, "model")),
    (r"moe/shared/w_up$",        (None, "model")),
    (r"moe/shared/w_down$",      ("model", None)),
    # mamba2 / SSD
    (r"ssm/in_proj$",            (None, "model")),
    (r"ssm/conv_w$",             (None, "model")),
    (r"ssm/conv_b$",             ("model",)),
    (r"ssm/(A_log|D|dt_bias)$",  ("model",)),
    (r"ssm/norm/scale$",         ("model",)),
    (r"ssm/out_proj$",           ("model", None)),
    # RG-LRU
    (r"rglru/w_x$",              (None, "model")),
    (r"rglru/w_gate$",           (None, "model")),
    (r"rglru/conv_w$",           (None, "model")),
    (r"rglru/conv_b$",           ("model",)),
    (r"rglru/(w_r|w_i)$",        (None, "model")),
    (r"rglru/(b_r|b_i|lam)$",    ("model",)),
    (r"rglru/w_out$",            ("model", None)),
    # norms & scalars: replicated
    (r"(norm|ln)[^/]*/(scale|bias)$", None),
    (r"scale$|bias$",            None),
    # resnet convs
    (r"conv[^/]*/w$",            (None, None, None, "model")),
    (r"fc/w$",                   (None, "model")),
]


def _spec_for(path: str, ndim: int, fsdp_axis: Optional[str]) -> tuple:
    """The reference's ``_spec_for``: the first rule matching ``path``,
    padded for leading stacked axes; ``fsdp_axis`` also goes on the first
    replicated dim (not a 3+-dim leaf's stacked axis 0)."""
    for pat, spec in _RULES:
        if re.search(pat, path):
            if spec is None:
                return ()
            spec = list(spec)
            while len(spec) < ndim:
                spec.insert(0, None)
            spec = spec[:ndim] if len(spec) > ndim else spec
            used = {a for s in spec if s
                    for a in (s if isinstance(s, tuple) else (s,))}
            if fsdp_axis and fsdp_axis not in used:
                for i, s in enumerate(spec):
                    if s is None and ndim - i <= len(spec):
                        if i == 0 and ndim > 2:
                            continue
                        spec[i] = fsdp_axis
                        break
            return tuple(spec)
    return ()


def map_paths(fn, tree, prefix=""):
    """``fn(path, leaf)`` over a nested dict, paths ``/``-joined."""
    return {k: map_paths(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


def param_pspecs(params: Dict[str, Any], *, fsdp: bool = False):
    """The spec of every leaf of ``params`` (tensors, meta tensors
    included, or anything with ``.shape``)."""
    axis = "data" if fsdp else None
    return map_paths(lambda path, leaf: _spec_for(path, len(leaf.shape),
                                                    axis), params)


def _spec_map(fn, specs, *rest):
    return {k: _spec_map(fn, v, *(r[k] for r in rest))
            if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
            for k, v in specs.items()}


def filter_spec_for_mesh(specs, mesh):
    """Drop axis names the mesh does not have (e.g. no ``pod``)."""
    axes = set(mesh.axis_names)

    def clean(spec):
        out = []
        for s in spec:
            if isinstance(s, tuple):
                kept = tuple(a for a in s if a in axes)
                out.append(kept if kept else None)
            else:
                out.append(s if s in axes else None)
        return tuple(out)

    return _spec_map(clean, specs)


def legalize_pspecs(tree, specs, mesh):
    """Drop split entries whose dim the mesh's axes do not divide (a
    vocabulary of 50,280 over 16 stays whole), as the reference does."""
    sizes = mesh.sizes

    def fix(leaf, spec):
        out = []
        for i, s in enumerate(spec):
            if s is None or i >= len(leaf.shape):
                out.append(None if i >= len(leaf.shape) else s)
                continue
            names = s if isinstance(s, tuple) else (s,)
            n = 1
            for a in names:
                n *= sizes.get(a, 1)
            out.append(s if n and leaf.shape[i] % n == 0 else None)
        return tuple(out)

    return _spec_map(lambda spec, leaf: fix(leaf, spec), specs, tree)


@dataclass(frozen=True)
class Shard:
    """A leaf held as this rank's slice along ``dim``: the leaf's
    ``size`` equal parts over the mesh axes ``axes``, part ``index``."""
    dim: int
    axes: Tuple[str, ...]
    size: int
    index: int

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf, as a tensor of its own."""
        n = full.shape[self.dim] // self.size
        return full.narrow(self.dim, self.index * n, n).clone(
            memory_format=torch.contiguous_format)


def placements(specs, mesh):
    """What this rank holds of each leaf under legalized ``specs`` on
    ``mesh`` over its data-parallel axes: a ``Shard`` over the axes of
    size > 1, or None (whole).  ``model`` entries are ``TpPlan``'s (the
    Shard then cuts the model part along another dim).  Raises where a
    leaf would split along two dims over those axes."""

    def place(spec):
        split = []
        for dim, s in enumerate(spec):
            names = s if isinstance(s, tuple) else (s,)
            names = tuple(a for a in names
                          if a and a != "model" and mesh.size(a) > 1)
            if names:
                split.append((dim, names))
        if not split:
            return None
        if len(split) > 1:
            raise ValueError(f"a training plan splitting {split} over the "
                             "data-parallel axes on two dims")
        dim, names = split[0]
        return Shard(dim, names, mesh.size(names), mesh.index(names))

    return _spec_map(place, specs)


def train_plan(params, mesh, *, fsdp: bool):
    """``placements`` of the reference's training specs for ``params``
    (``param_pspecs`` filtered and legalized for ``mesh``) over the
    data-parallel axes."""
    specs = filter_spec_for_mesh(param_pspecs(params, fsdp=fsdp), mesh)
    return placements(legalize_pspecs(params, specs, mesh), mesh)


def gather_dim(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The n ranks' equal parts of a leaf along ``dim``, whole."""
    import torch.distributed as dist
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(g: torch.Tensor, dim: int, n: int, group
                       ) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum of the n ranks' g."""
    import torch.distributed as dist
    gt = g.movedim(dim, 0).contiguous()
    out = gt.new_empty((gt.shape[0] // n,) + tuple(gt.shape[1:]))
    dist.reduce_scatter_tensor(out, gt, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """A split leaf, gathered whole where the loss reads it; the
    backward sums the ranks' gradients of the whole leaf and hands each
    rank its part (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, part, dim, n, group):
        ctx.dim, ctx.n, ctx.group = dim, n, group
        return gather_dim(part, dim, n, group)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g, ctx.dim, ctx.n, ctx.group), None,
                None, None)


class Part:
    """A leaf this rank holds as its part (``tensor``) of a leaf split
    along ``dim`` over ``group`` (``size`` ranks), read whole through
    ``full()``: an all-gather whose backward reduce-scatters the
    gradient to the part.  A stacked leaf's layers are parts of their
    own (``unbind``), so a layer gathers its slice alone, when it runs
    (and again when remat runs it again)."""

    __slots__ = ("tensor", "dim", "size", "group")

    def __init__(self, tensor, dim: int, size: int, group):
        self.tensor, self.dim, self.size, self.group = tensor, dim, size, group

    def full(self) -> torch.Tensor:
        return _Gather.apply(self.tensor, self.dim, self.size, self.group)

    def unbind(self, dim: int = 0):
        if dim != 0:
            raise ValueError("a part unbinds its leading (layer) axis only")
        if self.dim == 0:              # split along the layers: gather first
            return self.full().unbind(0)
        return [Part(t, self.dim - 1, self.size, self.group)
                for t in self.tensor.unbind(0)]


class PartTree(dict):
    """Params whose split leaves are ``Part``s (the FSDP step's): the
    decoder gathers each layer's leaves as the layer runs
    (``gathered``) and the other leaves once (``gather_top``).  On a
    tensor-parallel training rank ``axis`` is its ``ModelAxis`` and the
    leaves (or parts) are its model shard's: the decoder then runs
    ``transformer.apply_layer_rank``."""

    def __init__(self, tree=(), axis=None):
        super().__init__(tree)
        self.axis = axis


def gathered(tree):
    """``tree`` with every ``Part`` read whole."""
    return {k: gathered(v) if isinstance(v, dict)
            else v.full() if isinstance(v, Part) else v
            for k, v in tree.items()}


def gather_top(params):
    """A ``PartTree`` with every leaf outside ``layers`` read whole (the
    embedding, the head, the final norm, the MTP head: once a loss);
    other params as they are."""
    if not isinstance(params, PartTree):
        return params
    return PartTree({k: v if k == "layers" else
                     gathered(v) if isinstance(v, dict)
                     else v.full() if isinstance(v, Part) else v
                     for k, v in params.items()}, params.axis)


def axis_of(params):
    """The ``ModelAxis`` of a tensor-parallel rank's params, else None."""
    return params.axis if isinstance(params, PartTree) else None

# ---------------------------------------------------------------------------
# the tensor-parallel serving plan
# ---------------------------------------------------------------------------

EVERY = "every"          # a whole copy on every shard of the module


@dataclass(frozen=True)
class Split:
    """A leaf split along ``axis`` (counted from the last, so a leading
    layer axis does not move it) by ``kind``.  ``segments`` are the
    (length, units) runs along that axis in order: a run of ``u`` units
    is dealt out to the shards (``u / tp`` units each when ``tp``
    divides ``u``; else, ``u`` dividing ``tp``, one unit read by ``tp /
    u`` shards), a run of 0 units is whole on every shard."""
    axis: int
    kind: str
    segments: Tuple[Tuple[int, int], ...]

    def ranges(self, shard: int, tp: int) -> Tuple[Tuple[int, int], ...]:
        """(start, length) of each piece of shard ``shard``'s part along
        the axis, in order."""
        out, off = [], 0
        for length, units in self.segments:
            if units == 0:
                out.append((off, length))
            else:
                lo, hi = deal(units, shard, tp)
                width = length // units
                out.append((off + lo * width, (hi - lo) * width))
            off += length
        return tuple(out)


def deal(units: int, shard: int, tp: int) -> Tuple[int, int]:
    """[lo, hi) of the ``units`` that shard ``shard`` of ``tp`` holds:
    ``units / tp`` of them when ``tp`` divides ``units``, else the one
    unit ``shard * units // tp`` (``units`` divides ``tp``)."""
    if units % tp == 0:
        n = units // tp
        return shard * n, (shard + 1) * n
    if tp % units:
        raise ValueError(f"{units} units cannot be dealt to {tp} shards")
    u = shard * units // tp
    return u, u + 1


def split_modules(cfg, tp: int, train: bool = False) -> Dict[str, bool]:
    """Which modules a slice of ``tp`` shards splits (the rest run whole
    on shard 0; in training, on every model rank): ``vocab``, ``attn``
    (GQA or MLA, global or local), ``mlp``, ``moe`` (routed experts and
    the shared expert: by experts in serving, by their hidden width in
    training, as the reference's ``_RULES``), ``ssm`` and ``rglru``."""
    def even(n):
        return n > 0 and n % tp == 0

    h, kv = cfg.num_heads, cfg.num_kv_heads
    if cfg.mla is not None:
        attn = even(h)
    else:
        attn = even(h) and kv > 0 and (kv % tp == 0 or tp % kv == 0)
    moe = False
    if cfg.moe is not None:
        m = cfg.moe
        moe = (even(m.d_ff_expert) if train else even(m.num_experts)) and (
            not m.num_shared_experts
            or even(m.d_ff_expert * m.num_shared_experts))
    ssm = False
    if cfg.ssm is not None:
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        ssm = even(heads) and (s.n_groups == 1 or even(s.n_groups))
    rglru = False
    if cfg.rglru is not None:
        rglru = even(cfg.rglru.lru_width or cfg.d_model)
    return {"vocab": even(cfg.vocab_size), "attn": attn,
            "mlp": even(cfg.d_ff), "moe": moe, "ssm": ssm, "rglru": rglru}


def _param_rules(cfg, tp: int, train: bool = False
                 ) -> List[Tuple[str, Any]]:
    """(path pattern, placement) pairs for ``cfg``'s params over ``tp``
    shards; the first match wins (the reference's ``_RULES`` order).
    ``train``: the routed experts split by their hidden width."""
    mods = split_modules(cfg, tp, train)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def split(mod, kind, axis, *segments):
        return Split(axis, kind, tuple(segments)) if mods[mod] else None

    def every(mod):
        return EVERY if mods[mod] else None

    v = cfg.vocab_size
    rules = [(r"embed/embedding$", split("vocab", "vocab", -2, (v, v))),
             (r"lm_head/w$", split("vocab", "vocab", -1, (v, v))),
             (r"^mtp/", None)]
    if cfg.mla is not None:
        a = cfg.mla
        qk = a.qk_nope_head_dim + a.qk_rope_head_dim
        rules += [
            (r"attn/wq_b$", split("attn", "heads", -1, (h * qk, h))),
            (r"attn/wkv_b$", split("attn", "heads", -1,
                                   (h * (a.qk_nope_head_dim + a.v_head_dim),
                                    h))),
            (r"attn/wo$", split("attn", "heads", -2, (h * a.v_head_dim, h))),
            (r"attn/", every("attn"))]
    rules += [
        (r"attn/(wq|bq)$", split("attn", "heads", -1, (h * hd, h))),
        (r"attn/(wk|wv|bk|bv)$", split("attn", "heads", -1, (kv * hd, kv))),
        (r"attn/wo$", split("attn", "heads", -2, (h * hd, h))),
        (r"mlp/(w_gate|w_up)$", split("mlp", "channels", -1,
                                      (cfg.d_ff, cfg.d_ff))),
        (r"mlp/w_down$", split("mlp", "channels", -2, (cfg.d_ff, cfg.d_ff)))]
    if cfg.moe is not None:
        m = cfg.moe
        e, fs = m.num_experts, m.d_ff_expert * m.num_shared_experts
        fe = m.d_ff_expert
        if train:
            rules += [
                (r"moe/experts/(w_gate|w_up)$",
                 split("moe", "channels", -1, (fe, fe))),
                (r"moe/experts/w_down$",
                 split("moe", "channels", -2, (fe, fe)))]
        rules += [
            (r"moe/experts/", split("moe", "experts", -3, (e, e))),
            (r"moe/shared/(w_gate|w_up)$", split("moe", "channels", -1,
                                                 (fs, fs))),
            (r"moe/shared/w_down$", split("moe", "channels", -2, (fs, fs))),
            (r"moe/router/", every("moe"))]
    if cfg.ssm is not None:
        s = cfg.ssm
        di = s.expand * cfg.d_model
        nh = di // s.head_dim
        gn = s.n_groups * s.d_state
        g = s.n_groups if s.n_groups % tp == 0 else 0   # B/C whole
        xbc = ((di, nh), (gn, g), (gn, g))
        rules += [
            (r"ssm/in_proj$", split("ssm", "heads", -1, (di, nh), *xbc,
                                    (nh, nh))),
            (r"ssm/conv_[wb]$", split("ssm", "heads", -1, *xbc)),
            (r"ssm/(A_log|D|dt_bias)$", split("ssm", "heads", -1, (nh, nh))),
            (r"ssm/norm/scale$", split("ssm", "heads", -1, (di, nh))),
            (r"ssm/out_proj$", split("ssm", "heads", -2, (di, nh)))]
    if cfg.rglru is not None:
        w = cfg.rglru.lru_width or cfg.d_model
        rules += [
            (r"rglru/w_out$", split("rglru", "channels", -2, (w, w))),
            (r"rglru/", split("rglru", "channels", -1, (w, w)))]
    # the norms (ln1, ln2, final_norm) and anything else: shard 0
    return rules


def _cache_rules(cfg, tp: int) -> Dict[str, Any]:
    """Placement of each paged-cache leaf by name (the reference's
    ``_CACHE_AXES`` / ``_CACHE_LAST``), per the modules that split."""
    mods = split_modules(cfg, tp)
    out: Dict[str, Any] = {}
    if cfg.mla is not None:
        out["ckv"] = out["krope"] = EVERY if mods["attn"] else None
    elif cfg.num_kv_heads:
        kv = cfg.num_kv_heads
        out["k"] = out["v"] = (Split(-2, "heads", ((kv, kv),))
                               if mods["attn"] else None)
    if cfg.ssm is not None:
        s = cfg.ssm
        di = s.expand * cfg.d_model
        nh, gn = di // s.head_dim, s.n_groups * s.d_state
        g = s.n_groups if s.n_groups % tp == 0 else 0
        out["conv"] = (Split(-1, "heads", ((di, nh), (gn, g), (gn, g)))
                       if mods["ssm"] else None)
        out["state"] = Split(-3, "heads", ((nh, nh),)) if mods["ssm"] else None
    if cfg.rglru is not None:
        w = cfg.rglru.lru_width or cfg.d_model
        lru = Split(-1, "channels", ((w, w),)) if mods["rglru"] else None
        out["h"] = lru
        out.setdefault("conv", lru)
    return out


def param_placement(cfg, path: str, tp: int):
    """The placement of the param leaf at ``path`` (``/``-joined)."""
    for pat, place in _param_rules(cfg, tp):
        if re.search(pat, path):
            return place
    return None


def cache_placement(cfg, name: str, tp: int):
    """The placement of a paged-cache leaf called ``name``."""
    return _cache_rules(cfg, tp).get(name)


def take(t: torch.Tensor, place, shard: int, tp: int) -> torch.Tensor:
    """Shard ``shard``'s part of leaf ``t`` (a view where one piece is
    contiguous in memory, else a copy)."""
    if not isinstance(place, Split):
        return t
    ax = t.dim() + place.axis
    pieces = [t.narrow(ax, lo, n) for lo, n in place.ranges(shard, tp)]
    part = pieces[0] if len(pieces) == 1 else torch.cat(pieces, ax)
    return part.contiguous()


def _takes_part(place, shard: int) -> bool:
    return place is not None or shard == 0


@dataclass
class ShardedParams:
    """A model's params over a tensor-parallel slice: ``shards[s]`` is
    shard s's tree on ``devices[s]`` (leaves placed ``None`` only in
    shard 0's), ``modules`` the modules the slice splits
    (``split_modules``)."""
    shards: List[Dict[str, Any]]
    devices: Tuple[torch.device, ...]
    modules: Dict[str, bool]

    @property
    def tp(self) -> int:
        return len(self.devices)


def shard_params(params: Dict[str, Any], cfg, devices: Sequence
                 ) -> ShardedParams:
    """Split a full param tree (the port's own, or one carried from the
    JAX pytree by ``interop``) into per-shard trees on their devices,
    following the plan.  A part already on its device is not copied
    (``Tensor.to``), so shards on one card read whole-leaf placements
    from one tensor."""
    devices = tuple(torch.device(d) for d in devices)
    tp = len(devices)

    def parts(path, leaf):
        place = param_placement(cfg, "/".join(path), tp)
        return [take(leaf, place, s, tp).to(dev)
                if _takes_part(place, s) else None
                for s, dev in enumerate(devices)]

    return ShardedParams(split_tree(params, parts, tp), devices,
                         split_modules(cfg, tp))


def shard_cache(cache: Dict[str, Any], cfg, devices: Sequence
                ) -> List[Dict[str, Any]]:
    """Zero per-shard paged caches shaped after ``cache`` (a full one,
    on the ``meta`` device: only its shapes and dtypes are read).  Shards
    on one device whose parts of a leaf are the same (the MLA latent
    pools, a kv head read by several shards) share one tensor, which
    the first of them writes."""
    devices = tuple(torch.device(d) for d in devices)
    tp = len(devices)
    made: Dict[Any, torch.Tensor] = {}

    def parts(path, leaf):
        place = cache_placement(cfg, path[-1], tp)
        out = []
        for s, dev in enumerate(devices):
            if not _takes_part(place, s):
                out.append(None)
                continue
            shape = list(leaf.shape)
            key = (path, str(dev))
            if isinstance(place, Split):
                ranges = place.ranges(s, tp)
                shape[len(shape) + place.axis] = sum(n for _, n in ranges)
                key += (ranges,)
            if key not in made:
                made[key] = torch.zeros(shape, dtype=leaf.dtype, device=dev)
            out.append(made[key])
        return out

    return split_tree(cache, parts, tp)

# ---------------------------------------------------------------------------
# tensor-parallel training: a rank's model shard
# ---------------------------------------------------------------------------
# Megatron-style, one process a rank: the residual stream is whole on
# every model rank; a split module reads it through a copy-in (identity
# forward, the gradient summed over the model group backward) and its
# partial output leaves through a reduce-out (summed forward, identity
# backward).  Every model rank computes the same loss, so a leaf whole
# on every model rank gets the same gradient on each and is not summed.

def _tp_unported(cfg) -> Optional[str]:
    """The family of ``cfg`` if the port does not train it along the
    model axis yet, else None."""
    if cfg.family == "resnet":
        return "ResNet"
    if cfg.is_encoder_decoder or cfg.family == "audio":
        return "the encoder-decoder (whisper)"
    if cfg.mla is not None:
        return "MLA attention (deepseek-v3)"
    if cfg.rglru is not None:
        return "the RG-LRU hybrid (recurrentgemma)"
    return None


def check_tp_training(cfg, tp: int) -> None:
    """Raise ``NotImplementedError`` when ``cfg`` cannot train over a
    model axis of ``tp`` ranks (the dense GQA, GQA + MoE and mamba2
    families can)."""
    what = _tp_unported(cfg)
    if tp > 1 and what:
        raise NotImplementedError(
            f"{cfg.name}: training along the model axis (model {tp}) is "
            f"not ported for {what} yet (ROADMAP.md queue 1, item 4)")


def _all_reduce(x, group):
    import torch.distributed as dist
    dist.all_reduce(x, group=group)
    return x


class _CopyIn(torch.autograd.Function):
    """The identity; backward sums the gradient over the group (the
    whole input feeds every rank's part of a split module)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """The sum over the group of the ranks' partial outputs; backward the
    identity (the sum feeds the same loss on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumAll(torch.autograd.Function):
    """The sum over the group, forward and backward: each rank reads the
    sum in its own way (the gated norm's sum of squares)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


@dataclass(frozen=True)
class ModelAxis:
    """A training rank's place on the model axis: ``size`` ranks, this
    one at ``index``, their process ``group``, and the modules the plan
    splits (``split_modules(..., train=True)``)."""
    size: int
    index: int
    group: Any
    modules: Dict[str, bool]

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.group)

    def sum_all(self, x: torch.Tensor) -> torch.Tensor:
        return _SumAll.apply(x, self.group)


def train_placement(cfg, path: str, tp: int) -> Optional[Split]:
    """The model split of the param leaf at ``path`` in training: the
    unit plan's ``Split``, or None (whole on every model rank: the
    norms, the router, a module the width does not divide)."""
    for pat, place in _param_rules(cfg, tp, train=True):
        if re.search(pat, path):
            return place if isinstance(place, Split) else None
    return None


def take_part(full: torch.Tensor, place: Optional[Split], index: int,
              tp: int) -> torch.Tensor:
    """Model rank ``index``'s part of a whole leaf, a tensor of its own."""
    if place is None:
        return full
    ax = full.dim() + place.axis
    return torch.cat([full.narrow(ax, lo, n)
                      for lo, n in place.ranges(index, tp)], ax)


class TpPlan:
    """What this rank of ``mesh`` holds along ``model`` of ``cfg``'s
    params (``params``: a tree of them, meta tensors will do): each
    leaf's ``train_placement`` (``places``), the rank's ``ModelAxis``,
    and the pieces of its parts that other model ranks hold too: a kv
    head that the tp / KV ranks reading it share, mamba's B and C
    columns and conv channels that every rank holds (one group).  Each
    rank's gradient of such a piece is its own heads' share, so it is
    summed over the ranks that hold it (``reduce_partial``); LARS counts
    it once (``counts``).  Raises for the families not ported along
    model (``check_tp_training``)."""

    def __init__(self, cfg, params, mesh):
        tp = mesh.size("model")
        check_tp_training(cfg, tp)
        self.size, self.index = tp, mesh.index("model")
        self.group = mesh.group("model")
        self.axis = ModelAxis(tp, self.index, self.group,
                              split_modules(cfg, tp, train=True))
        self.places = map_paths(
            lambda path, _: train_placement(cfg, path, tp), params)
        # per leaf: [(axis, lo, n, readers)] of its shared pieces
        self._shared = []
        for pl in leaves(self.places):
            shared, off = [], 0
            if pl is not None:
                for (_, n), (_, units) in zip(pl.ranges(self.index, tp),
                                              pl.segments):
                    # the ranks holding this piece: every rank for a
                    # run of 0 units, tp / units for a unit several read
                    readers = tp if units == 0 else max(tp // units, 1)
                    if readers > 1:
                        shared.append((pl.axis, off, n, readers))
                    off += n
            self._shared.append(shared)
        # every rank makes the same groups in the same order
        self._groups = {r: mesh.block_group("model", r)
                        for r in sorted({s[3] for sh in self._shared
                                         for s in sh})}

    def gather_leaf(self, x: torch.Tensor, place) -> torch.Tensor:
        """The whole leaf of this rank's part ``x`` (a collective over
        the model group): the ranks' parts, each piece put back at its
        range (a piece several ranks hold is the same on each)."""
        if place is None:
            return x
        ax = x.dim() + place.axis
        parts = gather_dim(x, ax, self.size, self.group).chunk(self.size, ax)
        shape = list(x.shape)
        shape[ax] = sum(length for length, _ in place.segments)
        full = x.new_empty(shape)
        for r, part in enumerate(parts):
            off = 0
            for lo, n in place.ranges(r, self.size):
                full.narrow(ax, lo, n).copy_(part.narrow(ax, off, n))
                off += n
        return full

    def reduce_partial(self, grads) -> None:
        """Sum the gradient of every shared piece over the ranks that
        hold it, in place (``grads`` in the params' leaf order; a leaf
        may be this rank's data part of its model part, split on
        another dim)."""
        import torch.distributed as dist
        for g, shared in zip(leaves(grads), self._shared):
            for axis, lo, n, readers in shared:
                group = self._groups[readers]
                if n == g.shape[axis]:
                    dist.all_reduce(g, group=group)
                    continue
                piece = g.narrow(axis, lo, n).contiguous()
                dist.all_reduce(piece, group=group)
                g.narrow(axis, lo, n).copy_(piece)

    def counts(self):
        """How LARS counts each leaf's sums of squares on this rank, in
        leaf order: (keep, drop), keep[i] false where another model rank
        counts all of leaf i (a leaf whole on every rank counts on rank
        0, a shared kv head on the first rank that reads it), drop[i]
        the (axis, lo, n) pieces of a kept leaf that another rank counts
        (mamba's B and C columns, counted on rank 0)."""
        keep, drop = [], {}
        for i, (pl, shared) in enumerate(zip(leaves(self.places),
                                             self._shared)):
            if pl is None:
                keep.append(self.index == 0)
                continue
            others = [(a, lo, n) for a, lo, n, r in shared
                      if self.index % r]
            whole = sum(n for _, n in pl.ranges(self.index, self.size))
            if sum(n for _, _, n in others) == whole:
                keep.append(False)
                continue
            keep.append(True)
            if others:
                drop[i] = others
        return keep, drop

