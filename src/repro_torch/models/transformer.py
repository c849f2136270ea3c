"""Decoder-only stacks of the port (``repro/models/transformer.py``): the
dense GQA family, the Mamba-2 (ssm) family, GQA attention with an MoE
FFN (dbrx), the MLA + MoE family (deepseek-v3), the Griffin hybrid
(recurrentgemma: RG-LRU blocks and local-window MQA) and the vlm
backbone (llava: a dense GQA decoder whose full-sequence forward takes
an image-embedding prefix).  Params, forward in four cache modes, the non-paged
``prefill`` / ``decode_step`` entry point over contiguous caches, the
fused serving step, the N-step on-device decode loop and the
language-model loss (next-token cross-entropy, the MoE load-balance
auxiliary loss, and DeepSeek's multi-token-prediction term).

Layers are grouped into runs of identical (mixer, ffn) kinds, each
parameter-stacked with a leading layer axis (``params["layers"]["run_0"]
["attn"]["wq"]`` of shape (L, D, H*hd)), so ``repro_torch.interop`` maps
them 1:1.  A run executes as a Python loop over that axis (the
reference's ``lax.scan``).

The contiguous cache (``init_cache``, ``prefill``) holds, per run, K/V
``{"k", "v"}`` of (L, B, Sc, KV, hd), MLA latents ``{"ckv", "krope"}``
of (L, B, Sc, r) / (L, B, Sc, rope), or mamba state ``{"conv",
"state"}`` or RG-LRU state ``{"conv", "h"}`` of (L, B, ...), and
``decode_step`` updates it in place.  The paged cache holds, per run,
K/V block pools ``{"k", "v"}`` of (L, nb, bs, KV, hd) for attention
(global or local), latent block pools ``{"ckv", "krope"}`` of (L, nb,
bs, r) / (L, nb, bs, rope) for MLA, or slot-state pools ``{"conv",
"state"}`` / ``{"conv", "h"}`` of (L, S, ...) for ssm / rglru layers,
and is updated in place.  Block tables are passed to each call
directly: the reference broadcasts them into the cache pytree
(``with_block_tables``/ ``_canonical_block_tables``) only to keep its
jit signatures stable, which eager PyTorch does not need, and
slot-state runs carry none.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import prng
from repro_torch.kernels.sampling import greedy_sample, gumbel_sample
from repro_torch.kernels.slot_state import slot_gather, slot_scatter
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, cross_entropy,
                                       dense_init, embed_init, init_norm,
                                       run_local, vocab_embed, vocab_nll)
from repro_torch.sharding import (PartTree, ShardedParams, axis_of,
                                  gather_top, gathered, shard_cache)
from repro_torch.tree import tree_map

# the (mixer, ffn) runs the port has: attention (GQA or MLA) with a
# dense MLP or an MoE FFN, mamba layers, and the hybrid's RG-LRU and
# local-attention layers with a dense MLP
_PORTED_RUNS = {("attn", "dense"), ("attn", "moe"), ("ssm", "none"),
                ("rglru", "dense"), ("local_attn", "dense")}
_ATTN_KINDS = ("attn", "local_attn")
MTP_WEIGHT = 0.3  # DeepSeek-V3's weight of the multi-token-prediction CE


def runs_of(cfg) -> List[Tuple[str, str, int]]:
    """Runs of identical (mixer, ffn) layers, as the reference groups
    them; raises for kinds the port does not have yet."""
    kinds = cfg.layer_kinds()
    ffns = list(cfg.ffn_kinds())
    if cfg.family == "ssm" or cfg.d_ff == 0:
        ffns = ["none"] * cfg.num_layers
    out: List[List[Any]] = []
    for k, f in zip(kinds, ffns):
        if out and out[-1][0] == k and out[-1][1] == f:
            out[-1][2] += 1
        else:
            out.append([k, f, 1])
    runs = [tuple(r) for r in out]
    if (any((k, f) not in _PORTED_RUNS for k, f, _ in runs)
            or (cfg.activation not in ("swiglu", "gelu")
                and any(f != "none" for _, f, _ in runs))):
        raise NotImplementedError(
            f"{cfg.name}: the port's decoders have GQA or MLA attention "
            "with a dense or MoE FFN, mamba and RG-LRU layers only "
            "(ROADMAP.md §1)")
    return runs


def _layer_window(cfg, kind: str) -> int:
    """The attention window of a layer kind: the hybrid's local window for
    ``local_attn``, else the config's sliding window (0: none)."""
    if kind == "local_attn":
        return cfg.rglru.local_window if cfg.rglru else cfg.sliding_window
    return cfg.sliding_window


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _stack(per_layer):
    return tree_map(lambda *xs: torch.stack(xs), per_layer[0],
                    *per_layer[1:])


def _init_mlp(cfg, stacked):
    """A dense MLP of ``stacked`` leaves: swiglu (gate, up, down) or gelu
    (up, down), as ``cfg.activation`` says."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {"w_gate": stacked((d, f)), "w_up": stacked((d, f)),
                "w_down": stacked((f, d))}
    return {"w_up": stacked((d, f)), "w_down": stacked((f, d))}


def _init_attn_run(cfg, generator, device, n, ffn="dense", kind="attn"):
    """n attention layers (GQA, or MLA when the config has it and the
    layers are global) with a dense MLP or an MoE FFN, stacked."""
    d, pd = cfg.d_model, cfg.pdtype

    def stacked(shape, **kw):
        return torch.stack([dense_init(generator, shape, pd, device, **kw)
                            for _ in range(n)])

    if cfg.mla is not None and kind == "attn":
        attn = _stack([mla_mod.init_mla(generator, cfg, device)
                       for _ in range(n)])
    else:
        attn = attn_mod.init_attention(generator, cfg, device, n)
    out = {"ln1": init_norm(d, cfg, device, n), "attn": attn,
           "ln2": init_norm(d, cfg, device, n)}
    if ffn == "moe":
        out["moe"] = moe_mod.init_moe(generator, cfg, device, n)
    else:
        out["mlp"] = _init_mlp(cfg, stacked)
    return out


def _init_ssm_run(cfg, generator, device, n):
    """n mamba layers drawn one after another (the reference's vmapped
    ``init_layer``), stacked."""
    return _stack([{"ln1": init_norm(cfg.d_model, cfg, device),
                    "ssm": ssm_mod.init_ssm(generator, cfg, device)}
                   for _ in range(n)])


def _init_rglru_run(cfg, generator, device, n):
    """n RG-LRU layers with a dense MLP, each drawn whole, stacked."""
    def layer():
        def one(shape):
            return dense_init(generator, shape, cfg.pdtype, device)
        return {"ln1": init_norm(cfg.d_model, cfg, device),
                "rglru": rglru_mod.init_rglru(generator, cfg, device),
                "ln2": init_norm(cfg.d_model, cfg, device),
                "mlp": _init_mlp(cfg, one)}
    return _stack([layer() for _ in range(n)])


def init_params(cfg, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random params from ``generator`` (same shapes, inits and nesting as
    the reference; the numbers differ — torch and jax draw differently)."""
    layers = {}
    for i, (kind, ffn, n) in enumerate(runs_of(cfg)):
        if kind in _ATTN_KINDS:
            run = _init_attn_run(cfg, generator, device, n, ffn, kind)
        elif kind == "rglru":
            run = _init_rglru_run(cfg, generator, device, n)
        else:
            run = _init_ssm_run(cfg, generator, device, n)
        layers[f"run_{i}"] = run
    d, pd = cfg.d_model, cfg.pdtype
    params: Dict[str, Any] = {
        "embed": {"embedding": embed_init(generator, (cfg.vocab_size, d), pd,
                                          device)},
        "final_norm": init_norm(d, cfg, device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(generator, (d, cfg.vocab_size),
                                             pd, device)}
    if cfg.mtp_depth:
        # the multi-token-prediction head (one unstacked attn + dense
        # layer): only ``lm_loss`` reads it, no serving path
        params["mtp"] = {
            "proj": dense_init(generator, (2 * d, d), pd, device),
            "layer": _layer(_init_attn_run(cfg, generator, device, 1), 0)}
    return params


def _layer(tree, i: int):
    """Layer i's cache out of a stacked run (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree, n: int):
    """The n layers' params out of a stacked run: views, one ``unbind``
    per leaf, whose backward is one ``stack`` of the n layer gradients.
    (Indexing the leaf once per layer would give each layer's gradient
    a zero-filled full-size (n, ...) tensor and sum n of them.)"""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _vocab_axis(params):
    """The ``ModelAxis`` of a tensor-parallel training rank whose plan
    splits the vocab, else None."""
    axis = axis_of(params)
    return axis if axis is not None and axis.modules["vocab"] else None


def _logits(params, h, cfg):
    """The logits of h; on a training rank over a vocab split, this
    rank's vocab columns (h read through a copy-in)."""
    if isinstance(params, ShardedParams):
        return _logits_tp(params, h, cfg)
    axis = _vocab_axis(params)
    if axis is not None:
        h = axis.copy_in(h)
    dt = h.dtype
    if cfg.tie_embeddings:
        return h @ params["embed"]["embedding"].to(dt).t()
    return h @ params["lm_head"]["w"].to(dt)


def _token_nll(params, logits, labels):
    """Per-token CE in f32 of ``_logits``' output against labels (the
    whole-vocab CE on a rank holding vocab columns)."""
    axis = _vocab_axis(params)
    if axis is not None:
        return vocab_nll(logits, labels, axis)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def _cross_entropy(params, logits, labels):
    """Mean next-token CE of ``_logits``' output (``cross_entropy``, or
    its vocab-parallel form on a training rank)."""
    if _vocab_axis(params) is not None:
        return _token_nll(params, logits, labels).mean()
    return cross_entropy(logits, labels)


def embed_tokens(params, tokens, cfg):
    axis = _vocab_axis(params)
    if axis is not None:
        return vocab_embed(params["embed"]["embedding"], tokens, axis,
                           cfg.cdtype)
    return params["embed"]["embedding"][tokens.long()].to(cfg.cdtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_layer(lp, h, cfg, kind: str, ffn: str, *, rope=None, write=None,
                cache=None, block_tables=None, pos=None, valid_len=None,
                state_slots=None, dropless=False, make_cache=False,
                cache_len=0):
    """One layer: the mixer (GQA or MLA attention, global or local, mamba
    or RG-LRU) and the FFN (dense MLP or MoE), each pre-normed and
    residual.  Returns (h, the layer's cache, aux): the given cache,
    updated in place, or with ``make_cache`` a fresh contiguous one of
    ``cache_len`` slots (the window's at most); aux the MoE's
    load-balance loss (a 0-d f32 tensor), or None for a dense FFN.  The
    MoE runs dropless whenever there is a cache or one is made (a
    token's output must not depend on the step it shares) or when
    ``dropless`` asks for it."""
    x = apply_norm(lp["ln1"], h, cfg)
    if kind == "attn" and cfg.mla is not None:
        y, c = mla_mod.apply_mla(lp["attn"], x, cfg, rope=rope, write=write,
                                 cache=cache, block_tables=block_tables,
                                 pos=pos, make_cache=make_cache,
                                 cache_len=cache_len)
    elif kind in _ATTN_KINDS:
        y, c = attn_mod.apply_attention(
            lp["attn"], x, cfg, rope=rope, write=write,
            window=_layer_window(cfg, kind), cache=cache,
            block_tables=block_tables, pos=pos, make_cache=make_cache,
            cache_len=cache_len)
    elif kind == "rglru":
        y, c = rglru_mod.apply_rglru(lp["rglru"], x, cfg, cache=cache,
                                     make_cache=make_cache, pos=pos,
                                     valid_len=valid_len,
                                     state_slots=state_slots)
    else:
        y, c = ssm_mod.apply_ssm(lp["ssm"], x, cfg, cache=cache,
                                 make_cache=make_cache, pos=pos,
                                 valid_len=valid_len,
                                 state_slots=state_slots)
    h = h + y
    aux = None
    if ffn == "dense":
        h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)
    elif ffn == "moe":
        y, aux = moe_mod.apply_moe(
            lp["moe"], apply_norm(lp["ln2"], h, cfg), cfg,
            dropless=cache is not None or make_cache or dropless)
        h = h + y
    return h, c, aux


def _drive_rank(steps, axis):
    """Run a training rank's mixer steps (``ssm.ssm_steps``): its
    ``"sumsq"`` point gets the sum over the model group of each rank's
    squares (``ModelAxis.sum_all``, summed forward and backward), or,
    with ``axis`` None (the module runs whole), nothing: the mixer then
    uses its own.  Returns the mixer's result."""
    if axis is None:
        return run_local(steps)
    try:
        op, part = next(steps)
        while True:
            if op != "sumsq":
                raise NotImplementedError(
                    f"a training rank resolves sumsq only, not {op!r}")
            op, part = steps.send(axis.sum_all(
                part.float().square().sum(-1, keepdim=True)))
    except StopIteration as done:
        return done.value


def apply_layer_rank(lp, h, cfg, kind: str, ffn: str, axis, *, rope,
                     dropless=False):
    """``apply_layer`` on a tensor-parallel training rank, in the
    full-sequence form: ``lp`` this rank's shard of the layer, ``axis``
    its ``ModelAxis``.  Each norm runs once a rank on the whole residual
    stream; a split module reads it through ``axis.copy_in`` and its
    partial output is summed by ``axis.reduce_out`` (the MoE enters its
    routed and shared experts through copy-ins of its own, its router
    reading the whole stream); a module the plan does not split runs
    whole.  Returns (h, None, aux)."""
    x = apply_norm(lp["ln1"], h, cfg)
    split = axis.modules[_MODULE_OF[kind]]
    xin = axis.copy_in(x) if split else x
    if kind == "ssm":
        y, _ = _drive_rank(ssm_mod.ssm_steps(lp["ssm"], xin, cfg),
                           axis if split else None)
    else:
        y, _ = attn_mod.apply_attention(lp["attn"], xin, cfg, rope=rope,
                                        window=_layer_window(cfg, kind))
    h = h + (axis.reduce_out(y) if split else y)
    if ffn == "none":
        return h, None, None
    x = apply_norm(lp["ln2"], h, cfg)
    split = axis.modules[_MODULE_OF[ffn]]
    aux = None
    if ffn == "moe":
        y, aux = moe_mod.apply_moe(lp["moe"], x, cfg, dropless=dropless,
                                   tp=axis if split else None)
    else:
        y = apply_mlp(lp["mlp"], axis.copy_in(x) if split else x, cfg)
    return h + (axis.reduce_out(y) if split else y), None, aux


def forward(params, tokens, cfg, *, cache=None, block_tables=None, pos=None,
            valid_len=None, state_slots=None, need_logits=True,
            dropless=False, make_cache=False, cache_len=0,
            image_embeds=None):
    """Returns (logits, cache, aux, h), as the reference's ``forward``:
    aux the MoE layers' summed load-balance loss, a 0-d f32 tensor, or
    None without MoE layers (so dense and hybrid serving launch nothing
    for it); h the final-normed hidden states.

    image_embeds (B,Si,D), for a config with ``num_image_tokens`` (the
    vlm family): prepended to the token embeddings in the compute dtype,
    positions running over the combined Si + S sequence, logits and h
    over it too.  Full-sequence forms only (training, the non-paged
    prefill): a decode step or a paged step carries no image, as in the
    reference.

    tokens (B,S).  cache None: full-sequence forward (attention by
    ``cfg.attn_impl``, chunked SSD from a zero state; MoE at the training
    capacity unless ``dropless`` or ``make_cache``, the form the
    reference's training forward runs); with ``make_cache`` the returned
    cache is a fresh contiguous one of ``cache_len`` slots (the non-paged
    prefill).
    cache contiguous ("k"/"v", "ckv"/"krope", "conv"/"state", no
    block_tables or state_slots): one non-paged decode step, tokens
    (B,1), pos a scalar (an int or a 0-d tensor).
    cache with pools ("k"/"v" or "ckv"/"krope" + block_tables;
    "conv"/"state" + state_slots): paged step, pos (B,).
    cache with views ("kview"/"vview", "ckv_view"/"kr_view";
    "conv_view"/"state_view"): one decode-loop step, pos (B,).
    params ``ShardedParams`` (a tensor-parallel slice): ``forward_tp``.
    params a ``PartTree`` with a ``ModelAxis`` (a tensor-parallel
    training rank's shard): the full-sequence form, each layer by
    ``apply_layer_rank``; logits are this rank's vocab columns when the
    plan splits the vocab.
    """
    if isinstance(params, ShardedParams):
        return forward_tp(params, tokens, cfg, cache=cache,
                          block_tables=block_tables, pos=pos,
                          valid_len=valid_len, state_slots=state_slots,
                          need_logits=need_logits)
    # the FSDP step's params: each layer's split leaves gathered as the
    # layer runs (and again under remat), the others once
    params = gather_top(params)
    lazy = isinstance(params, PartTree)
    axis = axis_of(params)
    if axis is not None and (cache is not None or make_cache):
        raise ValueError("a tensor-parallel training rank runs the "
                         "full-sequence forward only")
    h = embed_tokens(params, tokens, cfg)
    if cfg.num_image_tokens and image_embeds is not None:
        if cache is not None:
            raise ValueError("an image prefix enters through the "
                             "full-sequence forward only (prefill)")
        h = torch.cat([image_embeds.to(h.dtype), h], dim=1)
    if pos is not None:
        pos = torch.as_tensor(pos, device=h.device)
    rope = write = window = None
    new_cache = {} if make_cache else cache
    aux = None
    for ri, (kind, ffn, n) in enumerate(runs_of(cfg)):
        rp = params["layers"][f"run_{ri}"]
        rc = cache[f"run_{ri}"] if cache is not None else None
        # one rope table and write target for every attention run of a
        # window (a contiguous cache's length, so its ring slot, follows
        # the window)
        if kind in _ATTN_KINDS and window != _layer_window(cfg, kind):
            window = _layer_window(cfg, kind)
            rope, write = attn_mod.shared_inputs(
                cfg, h.shape[1], h.device,
                cache=_layer(rc, 0) if rc else None,
                block_tables=block_tables, pos=pos, valid_len=valid_len)

        def block(h, lp, lc, kind=kind, ffn=ffn):
            if lazy:
                lp = gathered(lp)
            if axis is not None:
                return apply_layer_rank(lp, h, cfg, kind, ffn, axis,
                                        rope=rope, dropless=dropless)
            return apply_layer(lp, h, cfg, kind, ffn, rope=rope, write=write,
                               cache=lc, block_tables=block_tables, pos=pos,
                               valid_len=valid_len, state_slots=state_slots,
                               dropless=dropless, make_cache=make_cache,
                               cache_len=cache_len)

        # the training forward recomputes each layer in the backward pass
        # (the reference's jax.checkpoint around the scanned layer); only
        # the full-sequence form, which writes no cache, is checkpointed
        remat = (cfg.remat and cache is None and not make_cache
                 and torch.is_grad_enabled())
        made = []
        for i, lp in enumerate(_unstack(rp, n)):
            lc = _layer(rc, i) if rc is not None else None
            if remat:
                h, c, a = checkpoint(block, h, lp, lc, use_reentrant=False)
            else:
                h, c, a = block(h, lp, lc)
                made.append(c)
            if a is not None:
                aux = a if aux is None else aux + a
        if make_cache:
            new_cache[f"run_{ri}"] = _stack(made)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = _logits(params, h, cfg) if need_logits else None
    return logits, new_cache, aux, h


def init_layer_cache(cfg, kind: str, batch: int, cache_len: int, dtype,
                     device):
    """One layer's zero contiguous cache (the reference's
    ``init_layer_cache``): K/V of (batch, Sc, KV, hd), Sc = cache_len cut
    to the layer's window; MLA latents of (batch, cache_len, r) and (...,
    rope); mamba's conv window and float32 SSD state
    (``ssm.init_ssm_cache``); the RG-LRU's conv window and hidden state
    (``rglru.init_rglru_cache``)."""
    if kind == "attn" and cfg.mla is not None:
        a = cfg.mla
        return {name: torch.zeros((batch, cache_len, width), dtype=dtype,
                                  device=device)
                for name, width in (("ckv", a.kv_lora_rank),
                                    ("krope", a.qk_rope_head_dim))}
    if kind in _ATTN_KINDS:
        window = _layer_window(cfg, kind)
        sc = min(cache_len, window) if window else cache_len
        shape = (batch, sc, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "rglru":
        return rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)


def init_cache(cfg, batch: int, cache_len: int, dtype=None,
               device="cuda") -> Dict[str, Any]:
    """Zero contiguous decode state, per run stacked over its layers (the
    reference's ``init_cache``)."""
    dtype = dtype or cfg.cdtype
    out = {}
    for i, (kind, _, n) in enumerate(runs_of(cfg)):
        single = init_layer_cache(cfg, kind, batch, cache_len, dtype, "meta")
        out[f"run_{i}"] = {k: torch.zeros((n,) + v.shape, dtype=v.dtype,
                                          device=device)
                           for k, v in single.items()}
    return out


def prefill(params, tokens, cfg, cache_len: int, image_embeds=None):
    """The non-paged prefill: tokens (B,S) -> (logits (B,S,V), a fresh
    contiguous cache of ``cache_len`` slots holding the S positions).
    With ``image_embeds`` (B,Si,D) (vlm) the image positions come first:
    logits (B,Si+S,V), the cache holding Si + S positions, so decoding
    goes on at position Si + S."""
    logits, cache, _, _ = forward(params, tokens, cfg, make_cache=True,
                                  cache_len=cache_len,
                                  image_embeds=image_embeds)
    return logits, cache


def decode_step(params, cache, tokens, pos, cfg):
    """One non-paged decode step: tokens (B,1) int; pos the position of
    this token, shared by every row (an int or, to keep the host out of
    the loop, a 0-d int tensor on the device).  Returns (logits (B,V),
    cache), the cache updated in place."""
    logits, cache, _, _ = forward(params, tokens, cfg, cache=cache, pos=pos)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def chunked_lm_ce(params, h, labels, cfg, *, mask_from: int = 0):
    """Cross-entropy over sequence chunks of ``cfg.loss_chunk``: the
    (B, C, V) logits chunk is the only vocab-sized activation alive.
    h (B, S, D) final hidden states; position p predicts labels[p]
    (already shifted).  Mean nll over positions >= mask_from."""
    b, s, _ = h.shape
    chunk = min(cfg.loss_chunk or s, s)
    if s % chunk:
        chunk = s           # the reference's fallback for a ragged tail
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s, chunk):
        logits = _logits(params, h[:, start:start + chunk], cfg)
        lx = labels[:, start:start + chunk].long()
        nll = _token_nll(params, logits, lx)
        pos = start + torch.arange(chunk, device=h.device)[None]
        m = (pos >= mask_from).float().expand(lx.shape)
        tot = tot + (nll * m).sum()
        cnt = cnt + m.sum()
    return tot / torch.clamp_min(cnt, 1.0)


def lm_loss(params, batch, cfg):
    """The reference's text ``lm_loss`` over ``batch["tokens"]`` (B, S):
    the mean next-token cross-entropy of the full-sequence forward, plus
    the MoE layers' load-balance loss (zero without them), plus, when
    ``cfg.mtp_depth`` is set, DeepSeek-V3's multi-token prediction
    weighted by ``MTP_WEIGHT``: one extra attention + dense layer
    (``params["mtp"]``) over [h_t ; embed(token_t+1)] projected back to
    d_model predicts token t+2.  With ``batch["image_embeds"]`` (B, Si,
    D) (vlm) the forward runs over the image prefix and the text, and
    only text targets count: combined position p predicts combined
    token p + 1, so positions before Si - 1 are masked (chunked: by
    ``mask_from``; unchunked: the logits from Si - 1 against every text
    token); no MTP term then, as in the reference.
    On a tensor-parallel training rank (``apply_layer_rank``) the CE is
    the vocab-parallel one where the plan splits the vocab, and aux the
    replicated router's, the same on every model rank.
    Returns (loss, metrics ``ce``, ``aux``, ``mtp_ce`` (with MTP) and
    ``loss``)."""
    tokens = batch["tokens"]
    params = gather_top(params)
    chunked = bool(cfg.loss_chunk)
    image = batch.get("image_embeds") if cfg.num_image_tokens else None
    n_img = 0 if image is None else image.shape[1]
    logits, _, aux, h = forward(params, tokens, cfg,
                                need_logits=not chunked, image_embeds=image)
    if chunked:
        labels = tokens
        if n_img:
            labels = torch.cat([tokens.new_zeros((tokens.shape[0], n_img)),
                                tokens], dim=1)
        ce = chunked_lm_ce(params, h[:, :-1], labels[:, 1:], cfg,
                           mask_from=max(n_img - 1, 0))
    elif n_img:
        pred = logits[:, n_img - 1:-1]
        ce = _cross_entropy(params, pred, tokens[:, :pred.shape[1]])
    else:
        ce = _cross_entropy(params, logits[:, :-1], tokens[:, 1:])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth and not n_img:
        emb_next = embed_tokens(params, tokens[:, 1:], cfg)
        h_in = torch.cat([h[:, :-1], emb_next], dim=-1)
        h_mtp = h_in @ params["mtp"]["proj"].to(h.dtype)
        rope, _ = attn_mod.shared_inputs(cfg, h_mtp.shape[1], h.device)
        h_mtp, _, _ = apply_layer(params["mtp"]["layer"], h_mtp, cfg,
                                  "attn", "dense", rope=rope)
        mtp_ce = cross_entropy(_logits(params, h_mtp, cfg)[:, :-1],
                               tokens[:, 2:])
        loss = loss + MTP_WEIGHT * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def init_paged_cache(cfg, num_blocks: int, block_size: int, *,
                     num_state_slots: int = 0, dtype=None,
                     device=None, devices=None):
    """Paged per-layer decode state, by run kind:

      attn, local_attn
            K/V block pools (L, num_blocks, block_size, KV, hd), or with
            MLA latent block pools ``ckv`` (L, num_blocks, block_size,
            kv_lora_rank) and ``krope`` (..., qk_rope_head_dim); physical
            block 0 is the trash block inactive rows write to
      ssm   slot-state pools of ``num_state_slots`` rows: the conv window
            (L, S, K-1, convdim) and the SSD state (L, S, H, P, N), the
            latter in float32 (``ssm.init_ssm_cache``); slot 0 is the
            trash slot
      rglru slot-state pools as for ssm: the conv window (L, S, K-1, W)
            and the hidden state (L, S, W), the latter in float32
            (``rglru.init_rglru_cache``)

    With ``devices`` of two or more (a tensor-parallel slice), a list of
    per-shard caches, shard s's on ``devices[s]`` holding its part of
    each leaf (``sharding.shard_cache``).
    """
    if devices is not None and len(devices) > 1:
        full = init_paged_cache(cfg, num_blocks, block_size,
                                num_state_slots=num_state_slots,
                                dtype=dtype, device="meta")
        return shard_cache(full, cfg, devices)
    dtype = dtype or cfg.cdtype
    out = {}
    for i, (kind, _, n) in enumerate(runs_of(cfg)):
        if kind == "attn" and cfg.mla is not None:
            a = cfg.mla
            out[f"run_{i}"] = {
                name: torch.zeros((n, num_blocks, block_size, width),
                                  dtype=dtype, device=device)
                for name, width in (("ckv", a.kv_lora_rank),
                                    ("krope", a.qk_rope_head_dim))}
            continue
        if kind in _ATTN_KINDS:
            shape = (n, num_blocks, block_size, cfg.num_kv_heads,
                     cfg.head_dim)
            out[f"run_{i}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
            continue
        if num_state_slots < 2:
            raise ValueError("slot-state runs need num_state_slots >= 2 "
                             "(slot 0 is the trash slot)")
        init_state = (rglru_mod.init_rglru_cache if kind == "rglru"
                      else ssm_mod.init_ssm_cache)
        single = init_state(cfg, num_state_slots, dtype, "meta")
        out[f"run_{i}"] = {k: torch.zeros((n,) + v.shape, dtype=v.dtype,
                                          device=device)
                           for k, v in single.items()}
    return out


def _sample_rows(logits, rids, positions, *, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0):
    """One token per row on the device: greedy at temperature 0, else
    gumbel-max over the optional top-k.  The noise of a token is
    ``jax.random.gumbel`` under ``fold_in(fold_in(PRNGKey(seed), rid),
    position)``, a pure function of the request and the token's absolute
    position, so the draw is the same at any dispatch depth and across
    preemption recompute.  Keys and noise are built on the device."""
    if temperature <= 0.0:
        return greedy_sample(logits)
    keys = prng.sample_keys(seed, rids, positions)
    noise = prng.gumbel(keys, logits.shape[-1])
    return gumbel_sample(logits, noise, temperature=temperature,
                         top_k=top_k)


def paged_step(params, cache, slot_buf, tokens, block_tables, meta, cfg, *,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0):
    """Fused continuous-batching step: mixed prefill+decode rows, the
    frontier logits sliced and sampled on the device.

    tokens (B,C) int32; block_tables (B,NB) int32; meta (6,B) int32 rows
    pos / valid_len / src_slot / dst_slot / state_slot / rid (see the
    reference's ``paged_step``; state_slot indexes the slot-state pools
    of ssm / rglru runs, 0 the trash slot, and is unused by attention
    runs; rid
    keys the draw at temperature > 0); slot_buf (S+1,) int32, the
    last sampled token per slot (slot S is the spare that rows with
    dst_slot < 0 write).
    Returns (next_tokens (B,) int32, slot_buf, cache); slot_buf and the
    cache are updated in place."""
    pos, valid_len, src_slot, dst_slot, state_slot, rid = meta
    wired = src_slot >= 0
    tok0 = torch.where(wired, slot_buf[src_slot.clamp(min=0).long()],
                       tokens[:, 0])
    tokens = tokens.clone()
    tokens[:, 0] = tok0
    _, cache, _, h = forward(params, tokens, cfg, cache=cache,
                          block_tables=block_tables, pos=pos,
                          valid_len=valid_len, state_slots=state_slot,
                          need_logits=False)
    idx = (valid_len - 1).clamp(min=0).long()
    rows = torch.arange(h.shape[0], device=h.device)
    hf = h[rows, idx][:, None]                                  # (B,1,D)
    logits = _logits(params, hf, cfg)[:, 0].float()
    toks = _sample_rows(logits, rid, pos + valid_len,
                        temperature=temperature, top_k=top_k, seed=seed)
    spare = slot_buf.shape[0] - 1
    dst = torch.where(dst_slot >= 0, dst_slot, torch.full_like(dst_slot, spare))
    slot_buf.index_put_((dst.long(),), toks)
    return toks, slot_buf, cache


# ---------------------------------------------------------------------------
# N-step decode loop
# ---------------------------------------------------------------------------


def _gather_view(pool, bt):
    """(L, nb, bs, ...) pool + (B, NB) tables -> (L, B, NB*bs + 1, ...)
    per-row contiguous views with one trailing trash slot (index S)."""
    l, _, bs = pool.shape[:3]
    b, nbk = bt.shape
    v = pool[:, bt.long()].reshape((l, b, nbk * bs) + pool.shape[3:])
    pad = torch.zeros((l, b, 1) + pool.shape[3:], dtype=pool.dtype,
                      device=pool.device)
    return torch.cat([v, pad], dim=2)


def _scatter_view(pool, bt, view):
    """Write the views (trash slot stripped) back through the tables, in
    place.  A real block belongs to one row, so the only duplicate targets
    are trash placeholders (block 0)."""
    l, _, bs = pool.shape[:3]
    b, nbk = bt.shape
    body = view[:, :, :-1].reshape((l, b, nbk, bs) + pool.shape[3:])
    pool[:, bt.long()] = body
    return pool


# the two pools of a block-pooled run (K/V, or MLA's latent pair) and
# the names of their loop views
_BLOCK_POOLS = ((("k", "kview"), ("v", "vview")),
                (("ckv", "ckv_view"), ("krope", "kr_view")))


def _block_pools(rc):
    """A run's (pool, view) name pairs if it is block-pooled, else ()."""
    return next((pair for pair in _BLOCK_POOLS if pair[0][0] in rc), ())


def _paged_block_size(cache) -> int:
    """Tokens per block of the cache's block pools (K/V or MLA latent:
    they page alike), or 0 when no run is block-pooled (pure slot-state
    families)."""
    if isinstance(cache, list):                # a sharded slice
        cache = cache[0]
    for rc in cache.values():
        pools = _block_pools(rc)
        if pools:
            return rc[pools[0][0]].shape[2]    # (L, nb, bs, ...)
    return 0


def _loop_views(cache, block_tables, state_slot, pos0, made=None):
    """Pools -> per-row resident views, once per dispatch: block pools
    gather through the tables, slot-state pools gather each row's slot
    for every layer of the run in one ``slot_gather`` launch per leaf
    (``pos0 == 0`` rows read zeros, as in the paged step).  A sharded
    slice's cache (a list) gives a list of views, each shard's on its
    device; shards that share a pool share its view (``made``: view of
    each pool gathered so far)."""
    if isinstance(cache, list):
        made = {}
        out = []
        for shard in cache:
            dev = _device_of(shard)
            with device_guard(dev):
                out.append(_loop_views(shard, _to(block_tables, dev),
                                       _to(state_slot, dev), _to(pos0, dev),
                                       made))
        return out
    made = {} if made is None else made
    fresh = pos0 == 0

    def view_of(leaf, gather):
        if id(leaf) not in made:
            made[id(leaf)] = gather()
        return made[id(leaf)]

    views = {}
    for run, rc in cache.items():
        pools = _block_pools(rc)
        if pools:
            views[run] = {view: view_of(rc[pool], lambda p=rc[pool]:
                                        _gather_view(p, block_tables))
                          for pool, view in pools}
        else:
            views[run] = {f"{name}_view": view_of(
                leaf, lambda leaf=leaf: slot_gather(leaf, state_slot, fresh,
                                                    stacked=True))
                for name, leaf in rc.items()}
    return views


def _scatter_loop_views(cache, views, block_tables, state_slot, done=None):
    """Inverse of ``_loop_views``: commit the views into the pools.
    Every slot-state row writes its own slot (padding rows trash slot 0),
    and a stopped row's view holds its state as of stopping (later
    iterations are identity updates), so the write-back is
    unconditional: one ``slot_scatter`` launch per leaf, once per pool
    however many shards share it (``done``: the pools written)."""
    if isinstance(cache, list):
        done = set()
        for shard, shard_views in zip(cache, views):
            dev = _device_of(shard)
            with device_guard(dev):
                _scatter_loop_views(shard, shard_views, _to(block_tables, dev),
                                    _to(state_slot, dev), done)
        return cache
    done = set() if done is None else done
    for run, rc in cache.items():
        pools = _block_pools(rc)
        names = ([(pool, view) for pool, view in pools] if pools
                 else [(name, f"{name}_view") for name in rc])
        for name, view in names:
            if id(rc[name]) in done:
                continue
            done.add(id(rc[name]))
            if pools:
                _scatter_view(rc[name], block_tables, views[run][view])
            else:
                slot_scatter(rc[name], state_slot, views[run][view],
                             stacked=True)
    return cache


def paged_decode_loop(params, cache, slot_buf, block_tables, meta, cfg, *,
                      num_steps: int, temperature: float = 0.0,
                      top_k: int = 0, seed: int = 0):
    """Up to ``num_steps`` decode steps per row in one dispatch.

    meta (6,B) int32 rows pos0 / steps / slot / state_slot / rid / eos
    (see the reference's ``paged_decode_loop``).  A Python loop replaces
    the reference's ``fori_loop``; every stop predicate (step budget,
    eos, and for block-pooled runs the capacity check on the table; pure
    slot-state families rely on the host-metered budget) stays a device
    tensor,
    so the host queues all ``num_steps`` iterations without waiting on
    the device.  Returns (tokens (B,N) int32, counts (B,) int32, eos_hit
    (B,) bool, slot_buf, cache); slot_buf and the cache are updated in
    place."""
    pos0, steps, slot, state_slot, rid, eos = meta
    slot = slot.long()
    b = pos0.shape[0]
    nb = block_tables.shape[1]
    block_size = _paged_block_size(cache)
    spare = slot_buf.shape[0] - 1
    dev = pos0.device
    bt_long = block_tables.long()
    views = _loop_views(cache, block_tables, state_slot, pos0)
    out = torch.full((b, num_steps), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((b,), dtype=torch.int32, device=dev)
    stopped = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(num_steps):
        active = (steps > i) & ~stopped
        pos = pos0 + i
        if block_size:
            # device-side capacity predicate: the write at `pos` must land
            # in a reserved block, not the trash placeholder of the
            # frontier
            lblk = (pos // block_size).long()
            entry = torch.gather(bt_long, 1,
                                 lblk.clamp(max=nb - 1)[:, None])[:, 0]
            active &= (lblk < nb) & (entry != 0)
        valid = active.to(torch.int32)
        tokens = slot_buf[slot][:, None]
        _, views, _, h = forward(params, tokens, cfg, cache=views, pos=pos,
                              valid_len=valid, state_slots=state_slot,
                              need_logits=False)
        logits = _logits(params, h[:, :1], cfg)[:, 0].float()
        tok = _sample_rows(logits, rid, pos + 1, temperature=temperature,
                           top_k=top_k, seed=seed)
        hit = active & (eos >= 0) & (tok == eos)
        out[:, i] = torch.where(active, tok, torch.full_like(tok, -1))
        # inactive rows dump their sample into the spare slot
        slot_buf.index_put_(
            (torch.where(active, slot, torch.full_like(slot, spare)),), tok)
        counts += valid
        stopped |= hit
    _scatter_loop_views(cache, views, block_tables, state_slot)
    # `stopped` is only set by eos, so it doubles as the eos flag
    return out, counts, stopped, slot_buf, cache


# ---------------------------------------------------------------------------
# tensor-parallel slice
# ---------------------------------------------------------------------------
# One engine serves a slice of devices in one process (the reference's
# GSPMD replica): shard s's params and cache live on devices[s], each
# layer's norm runs once on devices[0], every shard of a split module
# runs it on its part, and the partial outputs are copied to devices[0]
# and summed in shard order.  Block tables, slot and token buffers stay
# single, on devices[0], and are copied to another device where a shard
# there reads them.

_MODULE_OF = {"attn": "attn", "local_attn": "attn", "ssm": "ssm",
              "rglru": "rglru", "dense": "mlp", "moe": "moe"}


def device_guard(device):
    """Make ``device`` current for the kernels a shard launches (they
    launch on the current device's stream); a no-op off CUDA."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _to(x, device):
    """x (a tensor, a tuple of them, or None) on ``device``: a tensor
    already there is returned as it is, never copied."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x.to(device)


def _device_of(tree) -> torch.device:
    """The device of a (non-empty) shard tree's first leaf."""
    for v in tree.values():
        return _device_of(v) if isinstance(v, dict) else v.device
    return torch.device("cpu")


def _reduce(parts, devices):
    """The sum of per-shard partials on devices[0], taken in shard order
    in float32 and returned in the partials' dtype (one part: itself)."""
    if len(parts) == 1:
        return parts[0].to(devices[0])
    acc = parts[0].to(devices[0], torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(devices[0], torch.float32)
    return acc.to(parts[0].dtype)


def _collective(op, parts, devices):
    """What each shard of a mixer's steps gets back for its yielded part:
    ``"sumsq"`` the sum over shards of the squares summed over each
    part's last axis (B, S, 1) in float32; ``"cat"`` the parts joined
    along the last axis.  Each shard's copy on its device."""
    if op == "sumsq":
        total = _reduce([p.float().square().sum(-1, keepdim=True)
                         for p in parts], devices)
    else:
        total = torch.cat([p.to(devices[0]) for p in parts], dim=-1)
    return [_to(total, d) for d in devices]


def _drive(steps, devices):
    """Run the shards' mixer steps in lockstep: each shard's generator
    (``ssm.ssm_steps``, ``rglru.rglru_steps``; the attention mixers
    return at once) runs on its device up to its cross-shard point, the
    points are resolved together (``_collective``), and every shard
    goes on to its result.  Returns the results in shard order."""
    out = [None] * len(steps)
    sends = [None] * len(steps)
    live = list(range(len(steps)))
    while live:
        asked = {}
        for i in live:
            with device_guard(devices[i]):
                try:
                    asked[i] = steps[i].send(sends[i])
                except StopIteration as done:
                    out[i] = done.value
        live = sorted(asked)
        if live:
            op = asked[live[0]][0]
            got = _collective(op, [asked[i][1] for i in live],
                              [devices[i] for i in live])
            for i, g in zip(live, got):
                sends[i] = g
    return out


def _mixer_steps(lp, x, cfg, kind, *, cache, writes, rope, write,
                 block_tables, pos, valid_len, state_slots):
    """One shard's mixer as steps (see ``_drive``): the attention
    mixers have no cross-shard point and return at the first step."""
    if kind == "attn" and cfg.mla is not None:
        return mla_mod.apply_mla(lp["attn"], x, cfg, rope=rope, write=write,
                                 cache=cache, block_tables=block_tables,
                                 pos=pos, writes=writes)
    if kind in _ATTN_KINDS:
        return attn_mod.apply_attention(
            lp["attn"], x, cfg, rope=rope, write=write,
            window=_layer_window(cfg, kind), cache=cache,
            block_tables=block_tables, pos=pos, writes=writes)
    steps = rglru_mod.rglru_steps if kind == "rglru" else ssm_mod.ssm_steps
    key = "rglru" if kind == "rglru" else "ssm"
    return (yield from steps(lp[key], x, cfg, cache=cache, pos=pos,
                             valid_len=valid_len, state_slots=state_slots))


def apply_layer_tp(params, lps, h, cfg, kind, ffn, *, caches, writes,
                   inputs):
    """``apply_layer`` over a slice: the norm once on devices[0], the sum
    over shards of the mixer's partial outputs, the residual, then the
    same for the FFN.  ``lps[s]`` / ``caches[s]`` are shard s's layer
    params and cache (a module the slice does not split runs on shard 0
    alone), ``writes[s]`` whether shard s writes the pools it may share
    with another shard on its device, ``inputs[device]`` the layer's
    shared inputs on each device."""
    devices = params.devices
    tp = params.tp if params.modules[_MODULE_OF[kind]] else 1
    x = apply_norm(lps[0]["ln1"], h, cfg)
    xs = {d: _to(x, d) for d in set(devices[:tp])}
    steps = [_mixer_steps(lps[s], xs[devices[s]], cfg, kind,
                          cache=caches[s], writes=writes[s],
                          **inputs[devices[s]]) for s in range(tp)]
    ys = _drive(steps, devices[:tp])
    h = h + _reduce([y for y, _ in ys], devices)
    if ffn == "none":
        return h
    tp = params.tp if params.modules[_MODULE_OF[ffn]] else 1
    x = apply_norm(lps[0]["ln2"], h, cfg)
    xs = {d: _to(x, d) for d in set(devices[:tp])}
    ys = []
    for s in range(tp):
        with device_guard(devices[s]):
            if ffn == "moe":
                mine = lps[s]["moe"]["experts"]["w_gate"].shape[-3]
                y, _ = moe_mod.apply_moe(lps[s]["moe"], xs[devices[s]], cfg,
                                         dropless=True, expert0=s * mine)
            else:
                y = apply_mlp(lps[s]["mlp"], xs[devices[s]], cfg)
            ys.append(y)
    return h + _reduce(ys, devices)


def _embed_tp(params, tokens, cfg):
    """``embed_tokens`` over the vocab split: each shard looks up the
    tokens of its rows (zeros for the others), and the parts sum exactly
    to each token's row, on devices[0]."""
    if not params.modules["vocab"]:
        return embed_tokens(params.shards[0], tokens, cfg)
    parts = []
    for s, dev in enumerate(params.devices):
        table = params.shards[s]["embed"]["embedding"]
        n = table.shape[0]
        with device_guard(dev):
            local = _to(tokens, dev).long() - s * n
            hit = (local >= 0) & (local < n)
            rows = table[local.clamp(0, n - 1)].to(cfg.cdtype)
            parts.append(rows * hit[..., None].to(rows.dtype))
    return _reduce(parts, params.devices)


def _logits_tp(params, h, cfg):
    """``_logits`` over the vocab split: each shard's columns, joined
    into full rows on devices[0] (what kernels 3 and 4 sample)."""
    if not params.modules["vocab"]:
        return _logits(params.shards[0], h, cfg)
    parts = []
    for s, dev in enumerate(params.devices):
        with device_guard(dev):
            parts.append(_logits(params.shards[s], _to(h, dev), cfg))
    return torch.cat([_to(p, params.devices[0]) for p in parts], dim=-1)


def forward_tp(params, tokens, cfg, *, cache, block_tables=None, pos=None,
               valid_len=None, state_slots=None, need_logits=True):
    """``forward`` over a tensor-parallel slice (``ShardedParams``), in
    the serving forms: ``cache`` the list of per-shard caches, pools
    (with block_tables / state_slots) or the decode loop's views.
    Returns (logits or None, cache, None, h), h on devices[0]."""
    if cache is None:
        raise ValueError("a tensor-parallel slice serves the paged step "
                         "and the decode loop only")
    devices = params.devices
    d0 = devices[0]
    h = _embed_tp(params, tokens, cfg)
    if pos is not None:
        pos = torch.as_tensor(pos, device=d0)
    base = dict(block_tables=block_tables, pos=pos, valid_len=valid_len,
                state_slots=state_slots)
    inputs, window = None, None
    for ri, (kind, ffn, n) in enumerate(runs_of(cfg)):
        run = f"run_{ri}"
        if inputs is None or (kind in _ATTN_KINDS
                              and window != _layer_window(cfg, kind)):
            rope = write = None
            if kind in _ATTN_KINDS:
                window = _layer_window(cfg, kind)
                rope, write = attn_mod.shared_inputs(
                    cfg, h.shape[1], d0, cache=_layer(cache[0][run], 0),
                    block_tables=block_tables, pos=pos, valid_len=valid_len)
            here = dict(base, rope=rope, write=write)
            inputs = {d: {k: _to(v, d) for k, v in here.items()}
                      for d in set(devices)}
        runs = [_unstack(p["layers"][run], n) if run in p.get("layers", {})
                else [{}] * n for p in params.shards]
        held = [c.get(run) for c in cache]
        # the first shard holding a pool writes it; shards on its device
        # that share it only read
        seen, writes = set(), []
        for rc in held:
            leaf = id(next(iter(rc.values()))) if rc else None
            writes.append(leaf not in seen)
            seen.add(leaf)
        for i in range(n):
            h = apply_layer_tp(
                params, [r[i] for r in runs], h, cfg, kind, ffn,
                caches=[_layer(rc, i) if rc else None for rc in held],
                writes=writes, inputs=inputs)
    h = apply_norm(params.shards[0]["final_norm"], h, cfg)
    logits = _logits_tp(params, h, cfg) if need_logits else None
    return logits, cache, None, h
