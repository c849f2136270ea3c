"""Attention of the dense GQA decoder and of the encoder-decoder
(``repro/models/attention.py``): QKV projection with optional bias, rope
(or none: the encoder-decoder adds sinusoidal positions to its
embeddings), and four self-attention forms — full sequence, causal or
not (training and the non-paged prefill, which can also build a
contiguous cache), one-token decode over that contiguous cache (the
non-paged ``decode_step``), paged block pools (the fused serving step)
and per-row contiguous views (the N-step decode loop) — plus cross
attention over the K/V that ``make_cross_cache`` projects from an
encoder output (``cross=True``, at any query length).

The full-sequence self-attention follows ``cfg.attn_impl`` as the
reference does: ``"pallas"`` runs the flash-attention kernel (forward
only), ``"blocked"`` the online-softmax ``blocked_attention``, anything
else ``naive_attention``.  Cross attention is ``naive_attention`` in
every form, as in the reference, whose kernels are self-attention only.
The cache forms update their K/V storage in place
(``index_put_`` / ``index_copy_``) instead of returning fresh copies as
the JAX package does: caches, pools and views are large and owned by the
caller, who gets the same tensors back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_view import decode_view_attend
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.models.layers import apply_rope, dense_init, rope_table

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, device, n: int):
    """n layers' GQA attention params, each leaf drawn for its n layers
    in turn and stacked: wq, wk, wv, wo, and zero q/k/v biases under
    ``cfg.qkv_bias``."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv, pd = cfg.num_heads, cfg.num_kv_heads, cfg.pdtype

    def stacked(shape):
        return torch.stack([dense_init(gen, shape, pd, device)
                            for _ in range(n)])

    p = {"wq": stacked((d, h * hd)), "wk": stacked((d, kv * hd)),
         "wv": stacked((d, kv * hd)), "wo": stacked((h * hd, d))}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((n, width), dtype=pd, device=device)
    return p


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


def blocked_attention(q, k, v, *, causal: bool, window: int = 0,
                      block_q: int = 512, block_kv: int = 1024):
    """Flash-style online-softmax attention in plain PyTorch, the
    reference's ``blocked_attention``: q (B,Sq,KV,G,hd); k, v
    (B,Sk,KV,hd).  Memory O(S * block) instead of O(S^2), and a causal
    or windowed query block visits only the key blocks it can see.
    Falls back to ``naive_attention`` when Sq or Sk is not a multiple of
    its block (blocks are cut to the sequence first)."""
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    block_q = min(block_q, sq)
    block_kv = min(block_kv, sk)
    if sq % block_q or sk % block_kv:
        return naive_attention(q, k, v, causal=causal, window=window)
    scale = 1.0 / math.sqrt(hd)
    neg = torch.full((), NEG_INF, device=q.device)
    outs = []
    for q_lo in range(0, sq, block_q):
        q_blk = q[:, q_lo:q_lo + block_q].float()
        qpos = q_lo + torch.arange(block_q, device=q.device)
        hi = min(sk, q_lo + block_q) if causal else sk
        s_blk = max(0, (q_lo + 1 - window) // block_kv) if window else 0
        acc = torch.zeros((b, kvh, g, block_q, hd), dtype=torch.float32,
                          device=q.device)
        m_i = torch.full((b, kvh, g, block_q), NEG_INF, dtype=torch.float32,
                         device=q.device)
        l_i = torch.zeros((b, kvh, g, block_q), dtype=torch.float32,
                          device=q.device)
        for k_lo in range(s_blk * block_kv, hi, block_kv):
            k_blk = k[:, k_lo:k_lo + block_kv]
            v_blk = v[:, k_lo:k_lo + block_kv]
            kpos = k_lo + torch.arange(block_kv, device=q.device)
            logits = torch.einsum("bqkgh,bskh->bkgqs", q_blk,
                                  k_blk.float()) * scale
            msk = None
            if causal:
                msk = kpos[None, :] <= qpos[:, None]
            if window:
                inside = kpos[None, :] > qpos[:, None] - window
                msk = inside if msk is None else msk & inside
            if msk is not None:
                logits = torch.where(msk, logits, neg)
            m_new = torch.maximum(m_i, logits.amax(-1))
            alpha = torch.exp(m_i - m_new)
            p = torch.exp(logits - m_new[..., None])
            l_i = l_i * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(v.dtype), v_blk).float()
            m_i = m_new
        o = acc / torch.clamp_min(l_i[..., None], 1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B,Bq,KV,G,hd)
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    """One token over a contiguous (possibly ring) cache, the reference's
    ``decode_attention``: q (B,1,KV,G,hd); caches (B,Sc,KV,hd) already
    holding the token at slot pos % Sc; pos a scalar.  Slots j <= pos
    are valid, which once pos >= Sc (a full ring) is every slot; the
    window is the ring's length, so ``window`` masks nothing more."""
    sc, hd = k_cache.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(),
                          k_cache.float()) * scale
    valid = torch.arange(sc, device=q.device) <= pos
    logits = torch.where(valid, logits, torch.full((), NEG_INF,
                                                   device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache)


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


def _proj(params, x, w, bias):
    """x @ w (+ bias) as one product with the bias in its epilogue."""
    dt = x.dtype
    return F.linear(x, params[w].to(dt).t(),
                    params[bias].to(dt) if bias in params else None)


def _qkv(params, x, cfg, num_heads, num_kv):
    """Q, K and V of x."""
    hd = cfg.head_dim
    q = _proj(params, x, "wq", "bq")
    k, v = _proj(params, x, "wk", "bk"), _proj(params, x, "wv", "bv")
    b, s = x.shape[:2]
    return (q.reshape(b, s, num_heads, hd), k.reshape(b, s, num_kv, hd),
            v.reshape(b, s, num_kv, hd))


def make_cross_cache(params, kv_x, cfg):
    """Cross-attention K/V of an encoder output kv_x (B, S, D), no rope:
    {"k", "v"} of (B, S, KV, hd), what every decode step attends."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    b, s = kv_x.shape[:2]
    return {"k": _proj(params, kv_x, "wk", "bk").reshape(b, s, kv, hd),
            "v": _proj(params, kv_x, "wv", "bv").reshape(b, s, kv, hd)}


def shared_inputs(cfg, x_len: int, device, *, cache=None,
                  block_tables=None, pos=None, valid_len=None):
    """What every layer of one forward shares (the reference recomputes
    them per layer and XLA folds the copies): the rope table of the query
    positions (at ``qk_rope_head_dim`` for MLA, which ropes only that
    part of its heads), and where each layer's new K/V or latent rows go
    — (block, slot) pairs in the pools, the slot of each row's view, or
    the ring slot ``pos % Sc`` of a contiguous cache (a 0-d device
    tensor, so a decode step reads no position on the host).  Keyed by
    the cache form (one layer's), as ``apply_attention`` and
    ``mla.apply_mla`` read them: a contiguous cache and the pools share
    their key names and are told apart by ``block_tables is None``, as
    the reference tells them apart by its ``"block_tables"`` leaf."""
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
    elif block_tables is None:
        # contiguous cache, one token at the scalar pos: (B, Sc, ...)
        positions = pos.long().reshape(1, 1)
        sc = (cache["k"] if "k" in cache else cache["ckv"]).shape[1]
        write = positions.reshape(1) % sc
    else:
        positions = pos[:, None] + torch.arange(x_len, device=device,
                                                dtype=pos.dtype)[None]
        pool = cache["k"] if "k" in cache else cache["ckv"]
        write = paged_write_indices(positions, block_tables,
                                    pool.shape[1], valid_len)  # (nb, bs, ...)
    return rope_table(positions, rope_dim, cfg.rope_theta), write


def apply_attention(params, x, cfg, *, rope, write=None, window: int = 0,
                    causal: bool = True, cross: bool = False,
                    cache=None, block_tables=None, pos=None,
                    make_cache: bool = False, cache_len: int = 0,
                    writes: bool = True):
    """Returns (y, cache).  ``rope`` and ``write`` come from
    ``shared_inputs`` for the same cache form; ``rope`` None applies
    none.  The head counts are the params': a tensor-parallel shard
    holds H/tp query heads over its kv heads (``repro_torch.sharding``),
    and with ``writes`` False it leaves its new K/V rows unwritten,
    another shard on its device having written the pools (or views)
    they share.

    cache None: full-sequence attention over x (B,S,D) by
      ``cfg.attn_impl``, causal unless ``causal`` is False (the
      encoder); with ``make_cache`` the returned cache is a
      fresh contiguous {"k", "v"} of (B, Sc, KV, hd), Sc = ``cache_len``
      (or S) cut to the window, position p at slot p % Sc (the last Sc
      positions when S >= Sc).
    cache {"k", "v"}, ``cross``: cross attention of x (B,C,D) over the
      K/V of ``make_cross_cache``, unmasked, no rope; nothing is
      written (the encoder-decoder's training, prefill and decode).
    cache {"k", "v"} without block_tables: the non-paged decode; x
      (B,1,D), pos a 0-d int tensor on x's device; the token's K/V go to slot pos % Sc
      (``write``), then it attends the cache — through the
      ``flash_decode`` kernel with length pos + 1 under ``"pallas"``,
      else ``decode_attention``.
    cache {"kview", "vview"}: the N-step loop; x (B,1,D), pos (B,), each
      row writes its token at its view slot ``write`` (inactive rows the
      trash slot S) and attends the view.
    cache {"k", "v"} + block_tables (B,NB): the fused step; x (B,C,D),
      pos (B,) the position of each row's first token; the C new K/V
      rows are scattered into the pools at ``write`` (padding to the
      trash block) before any query attends through the tables.
    """
    hd = cfg.head_dim
    h, kv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    b, c = x.shape[:2]
    if cross and cache is not None:
        q = _proj(params, x, "wq", "bq").reshape(b, c, h, hd)
        o = naive_attention(_group(q, kv), cache["k"], cache["v"],
                            causal=False)
        return o.reshape(b, c, h * hd) @ params["wo"].to(x.dtype), cache
    q, k, v = _qkv(params, x, cfg, h, kv)
    if rope is not None:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)

    if cache is None:
        if cfg.attn_impl == "pallas":
            o = flash_attention(q, k, v, causal=causal, window=window)
        elif cfg.attn_impl == "blocked":
            o = blocked_attention(_group(q, kv), k, v, causal=causal,
                                  window=window, block_q=cfg.attn_block_q,
                                  block_kv=cfg.attn_block_kv)
        else:
            o = naive_attention(_group(q, kv), k, v, causal=causal,
                                window=window)
        y = o.reshape(b, c, h * hd) @ params["wo"].to(x.dtype)
        return y, (_contiguous_cache(k, v, cache_len, window)
                   if make_cache else None)

    if "kview" in cache:
        kc, vc = cache["kview"], cache["vview"]
        if writes:
            rows = torch.arange(b, device=x.device)
            kc.index_put_((rows, write), k[:, 0].to(kc.dtype))
            vc.index_put_((rows, write), v[:, 0].to(vc.dtype))
        o = decode_view_attend(q[:, 0].contiguous(), kc, vc, pos,
                               window=window)
        y = o.reshape(b, 1, h * hd) @ params["wo"].to(x.dtype)
        return y, cache

    if block_tables is None:
        kc, vc = cache["k"], cache["v"]
        kc.index_copy_(1, write, k.to(kc.dtype))
        vc.index_copy_(1, write, v.to(vc.dtype))
        if cfg.attn_impl == "pallas":
            # The reference attends here in jnp (decode_attention); the
            # port uses kernel 7, which computes the same function:
            # slots j < pos + 1 valid, every slot once a ring is full
            # (tests/test_kernels.py pins ops.flash_decode(q, k, v,
            # pos + 1) == decode_attention(q, k, v, pos)).
            o = flash_decode(q[:, 0].contiguous(), kc, vc,
                             (pos + 1).to(torch.int32))
        else:
            o = decode_attention(_group(q, kv), kc, vc, pos, window=window)
        y = o.reshape(b, 1, h * hd) @ params["wo"].to(x.dtype)
        return y, cache

    kpool, vpool = cache["k"], cache["v"]
    if writes:
        kpool.index_put_(write, k.to(kpool.dtype))
        vpool.index_put_(write, v.to(vpool.dtype))
    o = flash_decode_paged(q.contiguous(), kpool, vpool, block_tables, pos,
                           window=window)
    y = o.reshape(b, c, h * hd) @ params["wo"].to(x.dtype)
    return y, cache


def _contiguous_cache(k, v, cache_len: int, window: int):
    """The non-paged cache a prefill leaves: Sc = cache_len (or S) cut to
    the window; position p at slot p % Sc, so when S >= Sc the last Sc
    positions, rolled (the reference's ring invariant)."""
    b, s, kvh, hd = k.shape
    sc = cache_len or s
    sc = min(sc, window) if window else sc
    if s >= sc:
        shift = s % sc
        return {"k": torch.roll(k[:, -sc:], shift, dims=1),
                "v": torch.roll(v[:, -sc:], shift, dims=1)}
    kc = torch.zeros((b, sc, kvh, hd), dtype=k.dtype, device=k.device)
    vc = torch.zeros_like(kc)
    kc[:, :s] = k
    vc[:, :s] = v
    return {"k": kc, "v": vc}
