"""Multi-head latent attention (DeepSeek-V2/V3, arXiv:2412.19437) of the
port (``repro/models/mla.py``).

Queries and keys/values go through low-rank latents; the serving cache
keeps only the compressed latent c_kv (kv_lora_rank) and one shared
rotary key (qk_rope_head_dim) per token.  The cache forms use the
absorbed formulation: q_nope is pushed through W^{UK} so the scores are
taken against the latents directly, and the attention output (in latent
space) is expanded through W^{UV} afterwards.

Four forms, as ``apply_attention``'s:

  cache None               the full sequence with keys and values
                           expanded from the latent (training form and
                           the non-paged prefill, which can also build a
                           contiguous latent cache; the plain oracle of
                           the tests and the chip check)
  {"ckv", "krope"}         the non-paged decode over that contiguous
                           cache (plain PyTorch, as the reference's jnp)
  {"ckv_view", "kr_view"}  the N-step loop's per-row latent views
                           (kernel ``mla_decode_views``)
  {"ckv", "krope"} + tables  the fused step's latent block pools
                           (kernel ``mla_decode_paged``)

The cache forms update their latent storage in place; the contiguous
cache and the pools share their key names and are told apart by
``block_tables is None``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.mla_decode import mla_decode_paged, mla_decode_views
from repro_torch.models.layers import apply_norm, apply_rope, dense_init

NEG_INF = -1e30


def init_mla(gen: torch.Generator, cfg, device):
    """One layer's params, with the reference's shapes and inits (the
    numbers differ: torch and jax draw differently)."""
    a = cfg.mla
    d, h, pd = cfg.d_model, cfg.num_heads, cfg.pdtype
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim

    def ones(n):
        return {"scale": torch.ones((n,), dtype=pd, device=device)}

    return {
        "wq_a": dense_init(gen, (d, a.q_lora_rank), pd, device),
        "q_norm": ones(a.q_lora_rank),
        "wq_b": dense_init(gen, (a.q_lora_rank, h * qk), pd, device),
        "wkv_a": dense_init(gen, (d, a.kv_lora_rank + a.qk_rope_head_dim),
                            pd, device),
        "kv_norm": ones(a.kv_lora_rank),
        "wkv_b": dense_init(gen, (a.kv_lora_rank,
                                  h * (a.qk_nope_head_dim + a.v_head_dim)),
                            pd, device),
        "wo": dense_init(gen, (h * a.v_head_dim, d), pd, device),
    }


def _project_q(params, x, cfg):
    """x (B,S,D) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope)."""
    a = cfg.mla
    dt = x.dtype
    cq = apply_norm(params["q_norm"], x @ params["wq_a"].to(dt), cfg)
    q = (cq @ params["wq_b"].to(dt)).reshape(
        *x.shape[:2], -1, a.qk_nope_head_dim + a.qk_rope_head_dim)
    return q[..., :a.qk_nope_head_dim], q[..., a.qk_nope_head_dim:]


def _latent_kv(params, x, cfg):
    """x (B,S,D) -> the normed latent c (B,S,r), k_rope (B,S,rope)."""
    a = cfg.mla
    ckv = x @ params["wkv_a"].to(x.dtype)
    c, k_rope = ckv[..., :a.kv_lora_rank], ckv[..., a.kv_lora_rank:]
    return apply_norm(params["kv_norm"], c, cfg), k_rope


def _wkv_b_split(params, cfg):
    """W^{UK} (r,H,nope) and W^{UV} (r,H,v) out of wkv_b."""
    a = cfg.mla
    w = params["wkv_b"].reshape(a.kv_lora_rank, -1,
                                a.qk_nope_head_dim + a.v_head_dim)
    return w[..., :a.qk_nope_head_dim], w[..., a.qk_nope_head_dim:]


def apply_mla(params, x, cfg, *, rope, write=None, cache=None,
              block_tables=None, pos=None, make_cache: bool = False,
              cache_len: int = 0, writes: bool = True):
    """Returns (y, cache).  ``rope`` is the table of the query positions
    at ``qk_rope_head_dim`` and ``write`` the latent write targets, both
    from ``attention.shared_inputs`` for the same cache form.  The head
    count is the params' (a tensor-parallel shard holds H/tp heads over
    the whole latent); with ``writes`` False the latents are left
    unwritten, another shard on this device having written the pools
    (or views) they share.

    cache None: causal attention over the full sequence x (B,S,D); with
      ``make_cache`` the returned cache is a fresh contiguous {"ckv":
      (B,Sc,r), "krope": (B,Sc,rope)}, Sc = ``cache_len`` (or S), holding
      the last min(S, Sc) latents from slot 0 (the reference's rule).
    cache {"ckv", "krope"} without block_tables: the non-paged decode; x
      (B,1,D), pos a 0-d int tensor; the token's latent goes to slot
      pos % Sc (``write``), then the absorbed query attends slots
      j <= pos of the cache.
    cache {"ckv_view", "kr_view"}: x (B,1,D), pos (B,); each row writes
      its latent at its view slot ``write`` (inactive rows the trash slot
      S), then attends its view.
    cache {"ckv", "krope"} + block_tables (B,NB): x (B,C,D), pos (B,) the
      position of each row's first token; the C latents are scattered
      into the pools at ``write`` (padding to the trash block) before any
      query attends through the tables.
    """
    a = cfg.mla
    h = params["wo"].shape[-2] // a.v_head_dim
    b, s = x.shape[:2]
    dt = x.dtype
    scale = 1.0 / math.sqrt(a.qk_nope_head_dim + a.qk_rope_head_dim)
    wk, wv = (w.to(dt) for w in _wkv_b_split(params, cfg))
    q_nope, q_rope = _project_q(params, x, cfg)
    c, k_rope = _latent_kv(params, x, cfg)
    q_rope = apply_rope(q_rope, rope)
    k_rope = apply_rope(k_rope[:, :, None, :], rope)[:, :, 0, :]

    if cache is None:
        # keys and values expanded from the latent (the training form)
        k_nope = torch.einsum("bsr,rhn->bshn", c, wk)
        v = torch.einsum("bsr,rhv->bshv", c, wv)
        logits = (torch.einsum("bqhn,bshn->bhqs", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bqhn,bsn->bhqs", q_rope.float(),
                                 k_rope.float())) * scale
        idx = torch.arange(s, device=x.device)
        logits = torch.where(idx[None, :] <= idx[:, None], logits,
                             torch.full((), NEG_INF, device=x.device))
        probs = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bhqs,bshv->bqhv", probs, v)
        y = o.reshape(b, s, h * a.v_head_dim) @ params["wo"].to(dt)
        new_cache = None
        if make_cache:
            sc = cache_len or s
            n = min(s, sc)
            new_cache = {
                "ckv": torch.zeros((b, sc, a.kv_lora_rank), dtype=dt,
                                   device=x.device),
                "krope": torch.zeros((b, sc, a.qk_rope_head_dim), dtype=dt,
                                     device=x.device)}
            new_cache["ckv"][:, :n] = c[:, -n:]
            new_cache["krope"][:, :n] = k_rope[:, -n:]
        return y, new_cache

    # absorb q_nope through W^{UK}: scores against the latents directly
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wk).contiguous()
    q_rope = q_rope.contiguous()
    if "ckv_view" in cache:
        ckv_c, kr_c = cache["ckv_view"], cache["kr_view"]
        if writes:
            rows = torch.arange(b, device=x.device)
            ckv_c.index_put_((rows, write), c[:, 0].to(ckv_c.dtype))
            kr_c.index_put_((rows, write), k_rope[:, 0].to(kr_c.dtype))
        o_lat = mla_decode_views(q_lat, q_rope, ckv_c, kr_c, pos,
                                 scale=scale)
    elif block_tables is None:
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        ckv_c.index_copy_(1, write, c.to(ckv_c.dtype))
        kr_c.index_copy_(1, write, k_rope.to(kr_c.dtype))
        logits = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(),
                               ckv_c.float())
                  + torch.einsum("bqhn,bsn->bhqs", q_rope.float(),
                                 kr_c.float())) * scale
        valid = torch.arange(ckv_c.shape[1], device=x.device) <= pos
        logits = torch.where(valid, logits,
                             torch.full((), NEG_INF, device=x.device))
        probs = torch.softmax(logits, dim=-1).to(dt)
        o_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv_c.to(dt))
    else:
        ckv_pool, kr_pool = cache["ckv"], cache["krope"]
        if writes:
            ckv_pool.index_put_(write, c.to(ckv_pool.dtype))
            kr_pool.index_put_(write, k_rope.to(kr_pool.dtype))
        o_lat = mla_decode_paged(q_lat, q_rope, ckv_pool, kr_pool,
                                 block_tables, pos, scale=scale)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat.to(dt), wv)
    y = o.reshape(b, s, h * a.v_head_dim) @ params["wo"].to(dt)
    return y, cache
