"""The tensor-parallel serving plan of the port (``repro/sharding.py``'s
``serve_param_pspecs`` / ``serve_cache_pspecs``), written for explicit
per-shard tensors.

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
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.tree import split_tree

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


def split_modules(cfg, tp: int) -> Dict[str, bool]:
    """Which modules a slice of ``tp`` shards splits (the rest run whole
    on shard 0): ``vocab``, ``attn`` (GQA or MLA, global or local),
    ``mlp``, ``moe`` (routed experts and the shared expert), ``ssm`` and
    ``rglru``."""
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
        moe = even(m.num_experts) and (
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


def _param_rules(cfg, tp: int) -> List[Tuple[str, Any]]:
    """(path pattern, placement) pairs for ``cfg``'s params over ``tp``
    shards; the first match wins (the reference's ``_RULES`` order)."""
    mods = split_modules(cfg, tp)
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
