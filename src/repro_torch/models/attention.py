"""Attention of the dense GQA decoder (``repro/models/attention.py``):
QKV projection with optional bias, rope, and the three forms the serve
path needs — full sequence (the plain oracle), paged block pools (the
fused step) and per-row contiguous views (the N-step decode loop).

The two cache forms update their K/V storage in place (``index_put_``)
instead of returning fresh copies as the JAX package does: the pools and
views are large and owned by the caller, who gets the same tensors back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_view import decode_view_attend
from repro_torch.kernels.flash_decode import flash_decode_paged
from repro_torch.models.layers import apply_rope, rope_table

NEG_INF = -1e30


def _group(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,KV,G,hd)"""
    b, s, h, hd = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, hd)


def naive_attention(q, k, v, *, causal: bool, window: int = 0):
    """Plain full-sequence attention, the test oracle.  q (B,Sq,KV,G,hd);
    k, v (B,Sk,KV,hd); softmax in f32."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    logits = torch.where(m, logits, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def paged_decode_attention(q, k_cache, v_cache, q_positions, *,
                           window: int = 0):
    """Attention over a gathered (contiguous) cache with per-row query
    positions: q (B,C,KV,G,hd); caches (B,S,KV,hd) with slot j =
    position j; q_positions (B,C).  Slots past a row's frontier are
    masked because their position exceeds every query's."""
    sk, hd = k_cache.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(),
                          k_cache.float()) * scale
    kpos = torch.arange(sk, device=q.device)
    qp = q_positions.long()
    m = kpos[None, None, :] <= qp[:, :, None]                    # (B,C,S)
    if window:
        m &= kpos[None, None, :] > qp[:, :, None] - window
    logits = torch.where(m[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache)


def paged_write_indices(positions, block_tables, block_size, valid_len):
    """(block, slot) scatter targets for writing per-token paged state.

    positions (B,C) absolute positions; block_tables (B,NB); valid_len
    (B,) or None.  Tail positions past the table and columns at or past
    a row's valid_len land in the trash block (physical 0), never
    clamped onto a live block."""
    c = positions.shape[1]
    nb = block_tables.shape[1]
    lblk = positions // block_size
    writable = lblk < nb
    if valid_len is not None:
        writable &= (torch.arange(c, device=positions.device)[None]
                     < valid_len[:, None])
    blk = torch.gather(block_tables.long(), 1, lblk.clamp(max=nb - 1).long())
    blk = torch.where(writable, blk, torch.zeros_like(blk))
    return blk, (positions % block_size).long()


def _qkv(params, x, cfg, num_heads, num_kv):
    hd = cfg.head_dim
    dt = x.dtype

    def proj(w, bias):
        # x @ w (+ bias) as one product with the bias in its epilogue
        return F.linear(x, params[w].to(dt).t(),
                        params[bias].to(dt) if bias in params else None)

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    b, s = x.shape[:2]
    return (q.reshape(b, s, num_heads, hd), k.reshape(b, s, num_kv, hd),
            v.reshape(b, s, num_kv, hd))


def shared_inputs(cfg, x_len: int, device, *, cache=None,
                  block_tables=None, pos=None, valid_len=None):
    """What every layer of one forward shares (the reference recomputes
    them per layer and XLA folds the copies): the rope table of the query
    positions (at ``qk_rope_head_dim`` for MLA, which ropes only that
    part of its heads), and where each layer's new K/V or latent rows go
    — (block, slot) pairs in the pools, or the slot of each row's view.
    Keyed by the cache form (one layer's), as ``apply_attention`` and
    ``mla.apply_mla`` read them."""
    rope_dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None \
        else cfg.head_dim
    if cache is None:
        positions = torch.arange(x_len, device=device)[None]
        write = None
    elif "kview" in cache or "ckv_view" in cache:
        positions = pos[:, None]
        view = cache["kview"] if "kview" in cache else cache["ckv_view"]
        sview = view.shape[1] - 1                  # (B, S+1, ...)
        write = pos.long().clamp(max=sview - 1)
        if valid_len is not None:
            write = torch.where(valid_len > 0, write,
                                torch.full_like(write, sview))
    else:
        positions = pos[:, None] + torch.arange(x_len, device=device,
                                                dtype=pos.dtype)[None]
        pool = cache["k"] if "k" in cache else cache["ckv"]
        write = paged_write_indices(positions, block_tables,
                                    pool.shape[1], valid_len)  # (nb, bs, ...)
    return rope_table(positions, rope_dim, cfg.rope_theta), write


def apply_attention(params, x, cfg, *, rope, write=None, window: int = 0,
                    cache=None, block_tables=None, pos=None):
    """Returns (y, cache).  ``rope`` and ``write`` come from
    ``shared_inputs`` for the same cache form.

    cache None: full-sequence causal attention over x (B,S,D) — the plain
      path, used as the oracle by the tests and the chip check.
    cache {"kview", "vview"}: the N-step loop; x (B,1,D), pos (B,), each
      row writes its token at its view slot ``write`` (inactive rows the
      trash slot S) and attends the view.
    cache {"k", "v"} + block_tables (B,NB): the fused step; x (B,C,D),
      pos (B,) the position of each row's first token; the C new K/V
      rows are scattered into the pools at ``write`` (padding to the
      trash block) before any query attends through the tables.
    """
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, c = x.shape[:2]
    q, k, v = _qkv(params, x, cfg, h, kv)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)

    if cache is None:
        o = naive_attention(_group(q, kv), k, v, causal=True, window=window)
        y = o.reshape(b, c, h * hd) @ params["wo"].to(x.dtype)
        return y, None

    if "kview" in cache:
        kc, vc = cache["kview"], cache["vview"]
        rows = torch.arange(b, device=x.device)
        kc.index_put_((rows, write), k[:, 0].to(kc.dtype))
        vc.index_put_((rows, write), v[:, 0].to(vc.dtype))
        o = decode_view_attend(q[:, 0].contiguous(), kc, vc, pos,
                               window=window)
        y = o.reshape(b, 1, h * hd) @ params["wo"].to(x.dtype)
        return y, cache

    kpool, vpool = cache["k"], cache["v"]
    kpool.index_put_(write, k.to(kpool.dtype))
    vpool.index_put_(write, v.to(vpool.dtype))
    o = flash_decode_paged(q.contiguous(), kpool, vpool, block_tables, pos,
                           window=window)
    y = o.reshape(b, c, h * hd) @ params["wo"].to(x.dtype)
    return y, cache
