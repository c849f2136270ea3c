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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
              expert0: int = 0):
    """x (B,S,D) -> (y (B,S,D), aux loss).  ``dropless`` (serving): the
    capacity is T, so nothing is dropped (top-k ids are distinct per
    token, so no expert gets more than T assignments); otherwise the
    reference's training capacity, overflow dropped.

    An expert-parallel shard (``repro_torch.sharding``) holds the routed
    experts ``expert0`` onward, as many as its ``experts`` leaves have,
    and the shared expert's share of its hidden width: the whole router
    routes over every expert, the shard adds only its own experts'
    contributions, and y is its partial sum."""
    m = cfg.moe
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
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    vals = xt[tok_idx] * keep[:, None].to(xt.dtype)
    xe = torch.zeros((mine, cap, d), dtype=xt.dtype, device=x.device)
    xe.index_put_((flat_e, slot), vals, accumulate=True)
    ye = _expert_ffn(xe, params["experts"])

    # gather back, weighted by the gates
    dt = ye.dtype
    y_slots = ye[flat_e, slot] * (gate_vals.reshape(tk, 1).to(dt)
                                  * keep[:, None].to(dt))
    y = y_slots.reshape(t, k, d).sum(1)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], xt, cfg)
    return y.reshape(b, s, d), aux
