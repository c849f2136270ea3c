"""Mixture-of-experts FFN of the port (``repro/models/moe.py``): the f32
softmax top-k router, the load-balance auxiliary loss, the sort-and-rank
dispatch into an (E, cap, D) buffer, batched expert products, the
gate-weighted gather back and DeepSeek's shared expert.

Two capacities, as in the reference: dropless (``cap = T``, serving:
a token's output never depends on its batchmates) and capacity-bounded
(``cap = ceil(T * K * capacity_factor / E)``, training: overflow is
dropped).  The router is the reference's softmax one, not DeepSeek's
published sigmoid router.  The expert products are plain batched matrix
products (``torch.bmm``), as the reference leaves them to XLA.

Expert parallelism (``apply_moe_ep``, the reference's shard_map path):
in training, with an active mesh (``sharding.set_active_mesh``) whose
``data`` axis divides the experts, each rank holds E / data routed
experts and routes its own tokens; the dispatch buffer crosses the
``data`` group (never the pods) by an all-to-all whose backward is the
reverse exchange.  Unlike the reference, a fault there raises (the
reference falls back to the scatter path), and the EP region runs in
the compute dtype (the reference's f32 casts work around an XLA CPU
partitioner crash).

On a tensor-parallel training rank (``tp``, a ``sharding.ModelAxis``)
the routed experts' hidden width and the shared expert's are this
rank's part: the router is whole and reads the whole input (its aux
loss is the same on every model rank); the tokens enter the expert
products, and the gates the combine, through copy-ins, so their
gradients sum over the model group; y is this rank's partial sum, which
the caller reduces over ``model``.  Under expert parallelism the
exchange runs over the data group of this rank's model coordinate, the
same on every model rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.models.layers import apply_mlp, dense_init

# an expert pass over weights of another dtype than its activations (the
# f32 oracle over bf16 weights) casts the experts in groups of about
# this many bytes, never a whole (E, D, F) leaf at once
CAST_GROUP_BYTES = 1 << 30


def _expert_init(gen: torch.Generator, n: int, e: int, shape, dtype,
                 device) -> torch.Tensor:
    """An (n, E) + shape expert leaf, drawn expert by expert into one
    preallocated tensor: the reference's ``dense_init`` of the (E,) +
    shape leaf, whose fan-in is its first axis, E (kept as the reference
    has it), without an f32 draw of the whole leaf."""
    out = torch.empty((n, e) + tuple(shape), dtype=dtype, device=device)
    if out.is_meta:                    # shapes only (``builders``)
        return out
    scale = 1.0 / math.sqrt(max(e, 1))
    for i in range(n):
        for j in range(e):
            out[i, j] = dense_init(gen, shape, dtype, device, scale=scale)
    return out


def init_moe(gen: torch.Generator, cfg, device, n: int):
    """The params of n MoE layers, stacked on a leading layer axis."""
    m = cfg.moe
    d, fe, e, pd = cfg.d_model, m.d_ff_expert, m.num_experts, cfg.pdtype

    def stacked(shape, **kw):
        return torch.stack([dense_init(gen, shape, pd, device, **kw)
                            for _ in range(n)])

    p = {"router": {"w": stacked((d, e), scale=0.02)},
         "experts": {"w_gate": _expert_init(gen, n, e, (d, fe), pd, device),
                     "w_up": _expert_init(gen, n, e, (d, fe), pd, device),
                     "w_down": _expert_init(gen, n, e, (fe, d), pd, device)}}
    if m.num_shared_experts:
        f = fe * m.num_shared_experts
        p["shared"] = {"w_gate": stacked((d, f)), "w_up": stacked((d, f)),
                       "w_down": stacked((f, d))}
    return p


def _segment_rank(sorted_ids: torch.Tensor, n: int) -> torch.Tensor:
    """Rank of each element within its run of equal ids (ids sorted)."""
    idx = torch.arange(n, device=sorted_ids.device)
    is_new = torch.ones((n,), dtype=torch.bool, device=sorted_ids.device)
    is_new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.where(is_new, idx, torch.zeros_like(idx))
    return idx - torch.cummax(seg_start, dim=0).values


def route(params, xt: torch.Tensor, cfg):
    """The f32 softmax router over tokens xt (T, D): (probs (T, E),
    renormalised top-k gates (T, K), expert ids (T, K))."""
    logits = xt.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.moe.num_experts_per_tok,
                                       dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_ids


def _expert_ffn(xe: torch.Tensor, experts) -> torch.Tensor:
    """The swiglu expert products over the dispatch buffer (E, cap, D).
    Weights of the activations' dtype go in one batched product each;
    others are cast a group of experts at a time (``CAST_GROUP_BYTES``)."""
    dt = xe.dtype
    e = xe.shape[0]
    wg, wu, wd = experts["w_gate"], experts["w_up"], experts["w_down"]
    if wg.dtype == dt:
        return torch.bmm(F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu), wd)
    group = max(1, CAST_GROUP_BYTES // (wg[0].numel() * xe.element_size()))
    ye = torch.empty((e, xe.shape[1], wd.shape[-1]), dtype=dt,
                     device=xe.device)
    for e0 in range(0, e, group):
        sl = slice(e0, e0 + group)
        h = (F.silu(torch.bmm(xe[sl], wg[sl].to(dt)))
             * torch.bmm(xe[sl], wu[sl].to(dt)))
        torch.bmm(h, wd[sl].to(dt), out=ye[sl])
    return ye


def apply_moe(params, x: torch.Tensor, cfg, dropless: bool = False,
              expert0: int = 0, tp=None):
    """x (B,S,D) -> (y (B,S,D), aux loss).  ``dropless`` (serving): the
    capacity is T, so nothing is dropped (top-k ids are distinct per
    token, so no expert gets more than T assignments); otherwise the
    reference's training capacity, overflow dropped, and expert-parallel
    (``apply_moe_ep``) when the active mesh has a ``data`` axis that
    divides the experts, as the reference chooses.

    An expert-parallel shard (``repro_torch.sharding``) holds the routed
    experts ``expert0`` onward, as many as its ``experts`` leaves have,
    and the shared expert's share of its hidden width: the whole router
    routes over every expert, the shard adds only its own experts'
    contributions, and y is its partial sum.  ``tp``: a tensor-parallel
    training rank's ``ModelAxis`` (see the module's docstring)."""
    m = cfg.moe
    mesh = None if dropless else ep_mesh(cfg)
    if mesh is not None:
        return apply_moe_ep(params, x, cfg, mesh, tp)
    b, s, d = x.shape
    t, k, e = b * s, m.num_experts_per_tok, m.num_experts
    mine = params["experts"]["w_gate"].shape[-3]
    xt = x.reshape(t, d)
    probs, gate_vals, expert_ids = route(params, xt, cfg)

    # load-balance aux loss (Switch/GShard form)
    tk = t * k
    flat_e = expert_ids.reshape(tk)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.ones((tk,), dtype=torch.float32,
                              device=x.device)) / tk
    aux = e * torch.sum(probs.mean(0) * ce) * m.aux_loss_weight

    # position of each assignment within its expert, by a stable sort
    cap = (t if dropless
           else int(max(4, -(-t * k * m.capacity_factor // e))))
    order = torch.argsort(flat_e, stable=True)
    ranks = torch.empty_like(flat_e).scatter_(
        0, order, _segment_rank(flat_e[order], tk))
    keep = ranks < cap
    if mine < e:
        # another shard's experts: dropped here, added by their shard
        local = flat_e - expert0
        keep &= (local >= 0) & (local < mine)
        flat_e = torch.where(keep, local, torch.zeros_like(local))
    slot = torch.where(keep, ranks, torch.zeros_like(ranks))

    # dispatch into (E, cap, D); dropped assignments add zeros at slot 0
    xs, gate_vals = _split_inputs(xt, gate_vals, tp)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    vals = xs[tok_idx] * keep[:, None].to(xt.dtype)
    xe = torch.zeros((mine, cap, d), dtype=xt.dtype, device=x.device)
    xe.index_put_((flat_e, slot), vals, accumulate=True)
    ye = _expert_ffn(xe, params["experts"])

    # gather back, weighted by the gates
    dt = ye.dtype
    y_slots = ye[flat_e, slot] * (gate_vals.reshape(tk, 1).to(dt)
                                  * keep[:, None].to(dt))
    y = y_slots.reshape(t, k, d).sum(1)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], xs, cfg)
    return y.reshape(b, s, d), aux


def _split_inputs(xt, gate_vals, tp):
    """(the tokens the expert products read, the gates the combine
    reads): on a tensor-parallel rank each through a copy-in, whose
    backward sums the ranks' partial gradients."""
    if tp is None:
        return xt, gate_vals
    return tp.copy_in(xt), tp.copy_in(gate_vals)


# ---------------------------------------------------------------------------
# expert parallelism over the mesh's data axis
# ---------------------------------------------------------------------------


def ep_mesh(cfg):
    """The active mesh when ``cfg``'s training MoE runs expert-parallel
    (the reference's rule: a mesh with a ``data`` axis that divides the
    experts), else None."""
    mesh = sharding.active_mesh()
    if (cfg.moe is None or mesh is None or "data" not in mesh.axis_names
            or cfg.moe.num_experts % mesh.size("data")):
        return None
    return mesh


class _AllToAll(torch.autograd.Function):
    """All-to-all of equal leading blocks over a group; its backward is
    the reverse exchange, which for equal blocks is the same one."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


def _exchange(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """All-to-all of x's n equal leading blocks over ``group``: block j
    goes to the group's rank j, and block i of the result came from rank
    i.  Autograd-aware; the identity on one rank."""
    if n == 1:
        return x
    return _AllToAll.apply(x.contiguous(), group)


def _moe_local(xt, router_w, w_gate, w_up, w_down, cfg, n: int, group,
               tp=None):
    """The reference's per-shard MoE body on one rank: xt (T_loc, D) this
    rank's tokens, the experts this rank's E / n.  The f32 router, the
    aux loss from local statistics, the capacity per shard, C_loc =
    max(4, ceil(T_loc K cf / E)) rounded up to a multiple of n, a local
    scatter into (E, C_loc, D), the exchange over the data group to
    (E / n, n C_loc, D), the expert products, the reverse exchange and
    the gate-weighted combine.  ``tp``: the expert products are this
    rank's hidden part (``apply_moe``).  Returns (y (T_loc, D), aux)."""
    m = cfg.moe
    t, d = xt.shape
    k, e = m.num_experts_per_tok, m.num_experts
    probs, gate_vals, expert_ids = route({"router": {"w": router_w}}, xt,
                                         cfg)
    tk = t * k
    flat_e = expert_ids.reshape(tk)
    ce = torch.zeros((e,), dtype=torch.float32, device=xt.device).index_add_(
        0, flat_e, torch.ones((tk,), dtype=torch.float32,
                              device=xt.device)) / tk
    aux = e * torch.sum(probs.mean(0) * ce) * m.aux_loss_weight

    cap = int(max(4, -(-t * k * m.capacity_factor // e)))
    cap += (-cap) % n                  # the exchange splits evenly
    order = torch.argsort(flat_e, stable=True)
    ranks = torch.empty_like(flat_e).scatter_(
        0, order, _segment_rank(flat_e[order], tk))
    keep = ranks < cap
    slot = torch.where(keep, ranks, torch.zeros_like(ranks))
    xs, gate_vals = _split_inputs(xt, gate_vals, tp)
    tok_idx = torch.arange(t, device=xt.device).repeat_interleave(k)
    vals = xs[tok_idx] * keep[:, None].to(xt.dtype)
    xe = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
    xe = xe.index_put((flat_e, slot), vals, accumulate=True)

    # (E, C, D) -> (n, E/n, C, D) by destination -> (E/n, n C, D)
    el = e // n
    xe = _exchange(xe, n, group).view(n, el, cap, d).transpose(0, 1)
    ye = _expert_ffn(xe.reshape(el, n * cap, d),
                     {"w_gate": w_gate, "w_up": w_up, "w_down": w_down})
    ye = ye.view(el, n, cap, d).transpose(0, 1).reshape(e, cap, d)
    ye = _exchange(ye, n, group)       # back to (E, C, D), by source

    dt = ye.dtype
    y_slots = ye[flat_e, slot] * (gate_vals.reshape(tk, 1).to(dt)
                                  * keep[:, None].to(dt))
    return y_slots.reshape(t, k, d).sum(1), aux


def apply_moe_ep(params, x: torch.Tensor, cfg, mesh, tp=None):
    """Expert-parallel training MoE on one rank of ``mesh``: x (B_loc, S,
    D) this rank's rows, ``params["experts"]`` this rank's E / data
    experts (``sharding``'s plan: rank ``data`` index i holds experts [i
    E / data, (i + 1) E / data)).  Returns (y, aux): aux this rank's,
    which the data-parallel mean of the loss averages over the ranks as
    the reference averages it over its shards.  The shared expert is
    added outside the exchange.  ``tp``: a tensor-parallel rank's
    ``ModelAxis`` (``apply_moe``); y is then its partial sum.  Raises
    when the experts are not this rank's share."""
    m = cfg.moe
    b, s, d = x.shape
    n = mesh.size("data")
    ex = params["experts"]
    if m.num_experts % n or ex["w_gate"].shape[-3] != m.num_experts // n:
        raise ValueError(
            f"expert parallelism over data = {n}: this rank holds "
            f"{ex['w_gate'].shape[-3]} experts, want {m.num_experts} / {n}")
    xt = x.reshape(b * s, d)
    y, aux = _moe_local(xt, params["router"]["w"], ex["w_gate"], ex["w_up"],
                        ex["w_down"], cfg, n, mesh.group("data"), tp)
    if "shared" in params:
        y = y + apply_mlp(params["shared"],
                          xt if tp is None else tp.copy_in(xt), cfg)
    return y.reshape(b, s, d), aux
