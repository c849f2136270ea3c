"""Decoder-only transformer for the dense GQA family
(``repro/models/transformer.py``): params, forward in three cache modes,
the fused serving step and the N-step on-device decode loop.

Params keep the reference's nesting and its stacked per-run layout
(``params["layers"]["run_0"]["attn"]["wq"]`` of shape (L, D, H*hd)), so
``repro_torch.interop`` maps them 1:1.  The layer stack runs as a Python
loop over the leading axis (the reference's ``lax.scan``).

The cache is ``{"run_0": {"k": (L, nb, bs, KV, hd), "v": ...}}`` and is
updated in place.  Block tables are passed to each call directly: the
reference broadcasts them into the cache pytree
(``with_block_tables``/``_canonical_block_tables``) only to keep its jit
signatures stable, which eager PyTorch does not need.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.kernels.sampling import greedy_sample
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       embed_init)


def runs_of(cfg) -> List[Tuple[str, str, int]]:
    """Runs of identical (mixer, ffn) layers; the port serves the dense
    family only, which is one run of ("attn", "dense")."""
    kinds = cfg.layer_kinds()
    ffns = cfg.ffn_kinds()
    if (cfg.family not in ("dense",) or set(kinds) != {"attn"}
            or set(ffns) != {"dense"} or cfg.mla is not None
            or cfg.activation != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense GQA family only; the "
            "other families are queued in ROADMAP.md §1")
    return [("attn", "dense", cfg.num_layers)]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random params from ``generator`` (same shapes, inits and nesting as
    the reference; the numbers differ — torch and jax draw differently)."""
    ((_, _, n),) = runs_of(cfg)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    h, kv, pd = cfg.num_heads, cfg.num_kv_heads, cfg.pdtype

    def stacked(shape, **kw):
        return torch.stack([dense_init(generator, shape, pd, device, **kw)
                            for _ in range(n)])

    def const(shape, value):
        return torch.full((n,) + shape, value, dtype=pd, device=device)

    attn = {"wq": stacked((d, h * hd)), "wk": stacked((d, kv * hd)),
            "wv": stacked((d, kv * hd)), "wo": stacked((h * hd, d))}
    if cfg.qkv_bias:
        attn.update(bq=const((h * hd,), 0.0), bk=const((kv * hd,), 0.0),
                    bv=const((kv * hd,), 0.0))
    run = {"ln1": {"scale": const((d,), 1.0)}, "attn": attn,
           "ln2": {"scale": const((d,), 1.0)},
           "mlp": {"w_gate": stacked((d, f)), "w_up": stacked((d, f)),
                   "w_down": stacked((f, d))}}
    params: Dict[str, Any] = {
        "embed": {"embedding": embed_init(generator, (cfg.vocab_size, d), pd,
                                          device)},
        "final_norm": {"scale": torch.ones((d,), dtype=pd, device=device)},
        "layers": {"run_0": run},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(generator, (d, cfg.vocab_size),
                                             pd, device)}
    return params


def _layer(tree, i: int):
    """Layer i's params out of a stacked run (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _logits(params, h, cfg):
    dt = h.dtype
    if cfg.tie_embeddings:
        return h @ params["embed"]["embedding"].to(dt).t()
    return h @ params["lm_head"]["w"].to(dt)


def embed_tokens(params, tokens, cfg):
    return params["embed"]["embedding"][tokens.long()].to(cfg.cdtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params, tokens, cfg, *, cache=None, block_tables=None, pos=None,
            valid_len=None, need_logits=True):
    """Returns (logits, cache, h).

    tokens (B,S).  cache None: full-sequence forward (plain attention).
    cache with "k"/"v" pools + block_tables: paged step, pos (B,).
    cache with "kview"/"vview" views: one decode-loop step, pos (B,).
    """
    h = embed_tokens(params, tokens, cfg)
    ((_, _, n),) = runs_of(cfg)
    rp = params["layers"]["run_0"]
    rc = cache["run_0"] if cache is not None else None
    window = cfg.sliding_window
    rope, write = attn_mod.shared_inputs(
        cfg, tokens.shape[1], h.device, cache=_layer(rc, 0) if rc else None,
        block_tables=block_tables, pos=pos, valid_len=valid_len)
    for i in range(n):
        lp = _layer(rp, i)
        lc = _layer(rc, i) if rc is not None else None
        x = apply_norm(lp["ln1"], h, cfg)
        y, _ = attn_mod.apply_attention(
            lp["attn"], x, cfg, rope=rope, write=write, window=window,
            cache=lc, block_tables=block_tables, pos=pos)
        h = h + y
        h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = _logits(params, h, cfg) if need_logits else None
    return logits, cache, h


def init_paged_cache(cfg, num_blocks: int, block_size: int, *, dtype=None,
                     device=None) -> Dict[str, Any]:
    """K/V block pools per layer, (L, num_blocks, block_size, KV, hd).
    Physical block 0 is the trash block inactive rows write to."""
    ((_, _, n),) = runs_of(cfg)
    shape = (n, num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.cdtype
    return {"run_0": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}}


def _sample_rows(logits, *, temperature: float = 0.0):
    """One token per row on the device.  Greedy only: temperature/top-k
    sampling needs the reference's threefry keys (ROADMAP §1)."""
    if temperature > 0.0:
        raise NotImplementedError(
            "temperature > 0 sampling is not ported yet (gumbel_sample with "
            "threefry keys, ROADMAP §1)")
    return greedy_sample(logits)


def paged_step(params, cache, slot_buf, tokens, block_tables, meta, cfg, *,
               temperature: float = 0.0):
    """Fused continuous-batching step: mixed prefill+decode rows, the
    frontier logits sliced and sampled on the device.

    tokens (B,C) int32; block_tables (B,NB) int32; meta (6,B) int32 rows
    pos / valid_len / src_slot / dst_slot / state_slot / rid (see the
    reference's ``paged_step``; state_slot and rid are unused by greedy
    dense serving); slot_buf (S+1,) int32, the last sampled token per
    slot (slot S is the spare that rows with dst_slot < 0 write).
    Returns (next_tokens (B,) int32, slot_buf, cache); slot_buf and the
    cache are updated in place."""
    pos, valid_len, src_slot, dst_slot = meta[0], meta[1], meta[2], meta[3]
    wired = src_slot >= 0
    tok0 = torch.where(wired, slot_buf[src_slot.clamp(min=0).long()],
                       tokens[:, 0])
    tokens = tokens.clone()
    tokens[:, 0] = tok0
    _, cache, h = forward(params, tokens, cfg, cache=cache,
                          block_tables=block_tables, pos=pos,
                          valid_len=valid_len, need_logits=False)
    idx = (valid_len - 1).clamp(min=0).long()
    rows = torch.arange(h.shape[0], device=h.device)
    hf = h[rows, idx][:, None]                                  # (B,1,D)
    logits = _logits(params, hf, cfg)[:, 0].float()
    toks = _sample_rows(logits, temperature=temperature)
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


def _loop_views(cache, block_tables):
    """Pools -> per-row resident views, once per dispatch."""
    return {run: {"kview": _gather_view(rc["k"], block_tables),
                  "vview": _gather_view(rc["v"], block_tables)}
            for run, rc in cache.items()}


def _scatter_loop_views(cache, views, block_tables):
    """Inverse of ``_loop_views``: commit the views into the pools."""
    for run, rc in cache.items():
        _scatter_view(rc["k"], block_tables, views[run]["kview"])
        _scatter_view(rc["v"], block_tables, views[run]["vview"])
    return cache


def paged_decode_loop(params, cache, slot_buf, block_tables, meta, cfg, *,
                      num_steps: int, temperature: float = 0.0):
    """Up to ``num_steps`` decode steps per row in one dispatch.

    meta (6,B) int32 rows pos0 / steps / slot / state_slot / rid / eos
    (see the reference's ``paged_decode_loop``).  A Python loop replaces
    the reference's ``fori_loop``; every stop predicate (step budget,
    eos, the block-capacity check on the table) stays a device tensor,
    so the host queues all ``num_steps`` iterations without waiting on
    the device.  Returns (tokens (B,N) int32, counts (B,) int32, eos_hit
    (B,) bool, slot_buf, cache); slot_buf and the cache are updated in
    place."""
    pos0, steps, slot, eos = meta[0], meta[1], meta[2].long(), meta[5]
    b = pos0.shape[0]
    nb = block_tables.shape[1]
    block_size = cache["run_0"]["k"].shape[2]
    spare = slot_buf.shape[0] - 1
    dev = pos0.device
    bt_long = block_tables.long()
    views = _loop_views(cache, block_tables)
    out = torch.full((b, num_steps), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((b,), dtype=torch.int32, device=dev)
    stopped = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(num_steps):
        active = (steps > i) & ~stopped
        pos = pos0 + i
        # device-side capacity predicate: the write at `pos` must land in
        # a reserved block, not the trash placeholder of the frontier
        lblk = (pos // block_size).long()
        entry = torch.gather(bt_long, 1, lblk.clamp(max=nb - 1)[:, None])[:, 0]
        active &= (lblk < nb) & (entry != 0)
        valid = active.to(torch.int32)
        tokens = slot_buf[slot][:, None]
        _, views, h = forward(params, tokens, cfg, cache=views, pos=pos,
                              valid_len=valid, need_logits=False)
        logits = _logits(params, h[:, :1], cfg)[:, 0].float()
        tok = _sample_rows(logits, temperature=temperature)
        hit = active & (eos >= 0) & (tok == eos)
        out[:, i] = torch.where(active, tok, torch.full_like(tok, -1))
        # inactive rows dump their sample into the spare slot
        slot_buf.index_put_(
            (torch.where(active, slot, torch.full_like(slot, spare)),), tok)
        counts += valid
        stopped |= hit
    _scatter_loop_views(cache, views, block_tables)
    # `stopped` is only set by eos, so it doubles as the eos flag
    return out, counts, stopped, slot_buf, cache
