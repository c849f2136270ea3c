"""Whisper-style encoder-decoder of the port (``repro/models/encdec.py``,
[arXiv:2212.04356]): a non-causal encoder over stub frame embeddings
(the audio frontend, mel spectrogram and conv, is not modelled: the
batch carries ``audio_embeds`` of (B, encoder_seq_len, d_model)) and a
causal decoder with cross attention; layernorm, gelu, tied embeddings
and sinusoidal positions (the reference's recorded deviation from
Whisper's learned decoder positions), no rope.

Params: ``encoder.layers`` (ln1, attn, ln2, mlp) and ``decoder.layers``
(ln1, attn, lnx, xattn, ln2, mlp), each stacked with a leading layer
axis, their ``final_norm`` and the tied ``embed.embedding``: the
reference's tree, so ``repro_torch.interop`` maps it 1:1.

Self attention follows ``cfg.attn_impl`` (under ``"pallas"`` the
flash-attention kernel for the encoder, non-causal, and the decoder's
prefill, and the contiguous-decode kernel for its decode steps); cross
attention is plain PyTorch in every form, as the reference attends it.
The decode cache holds per layer the decoder's self K/V of
``cache_len`` slots and the cross K/V of the encoder output
(``self_k``/``self_v``/``cross_k``/``cross_v``, (L, B, S, KV, hd)),
and ``decode_step`` updates the self K/V in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, cross_entropy,
                                       dense_init, embed_init, init_norm,
                                       sinusoidal_pos_emb)
from repro_torch.models.transformer import _init_mlp, _layer, _stack, _unstack

_CACHE_KEYS = ("self_k", "self_v", "cross_k", "cross_v")


def init_params(cfg, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random params from ``generator`` (the reference's shapes, inits and
    nesting; torch and jax draw other numbers)."""
    d, pd = cfg.d_model, cfg.pdtype

    def stacked(n):
        return lambda shape: torch.stack([dense_init(generator, shape, pd,
                                                     device)
                                          for _ in range(n)])

    def layers(n, cross):
        out = {"ln1": init_norm(d, cfg, device, n),
               "attn": attn_mod.init_attention(generator, cfg, device, n)}
        if cross:
            out["lnx"] = init_norm(d, cfg, device, n)
            out["xattn"] = attn_mod.init_attention(generator, cfg, device, n)
        out["ln2"] = init_norm(d, cfg, device, n)
        out["mlp"] = _init_mlp(cfg, stacked(n))
        return out

    return {
        "encoder": {"layers": layers(cfg.encoder_layers, False),
                    "final_norm": init_norm(d, cfg, device)},
        "decoder": {"layers": layers(cfg.num_layers, True),
                    "final_norm": init_norm(d, cfg, device)},
        "embed": {"embedding": embed_init(generator, (cfg.vocab_size, d), pd,
                                          device)},
    }


def _remat(cfg, body):
    """``body`` recomputed in the backward pass when ``cfg.remat`` asks
    for it and a gradient is being taken (the reference's
    ``jax.checkpoint`` around its scanned layer)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body
    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def encode(params, audio_embeds, cfg):
    """Frame embeddings (B, S, D) -> the encoder output (B, S, D):
    sinusoidal positions added, then non-causal self-attention layers."""
    h = audio_embeds.to(cfg.cdtype)
    pos = torch.arange(h.shape[1], device=h.device)
    h = h + sinusoidal_pos_emb(pos, cfg.d_model, h.dtype)[None]

    def body(h, lp):
        x = apply_norm(lp["ln1"], h, cfg)
        y, _ = attn_mod.apply_attention(lp["attn"], x, cfg, rope=None,
                                        causal=False)
        h = h + y
        return h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)

    body = _remat(cfg, body)
    for lp in _unstack(params["encoder"]["layers"], cfg.encoder_layers):
        h = body(h, lp)
    return apply_norm(params["encoder"]["final_norm"], h, cfg)


def decoder_forward(params, tokens, enc_out, cfg, *, cache=None, pos=None,
                    make_cache: bool = False, cache_len: int = 0):
    """Returns (logits (B, S, V), cache).

    cache None: the full-sequence decoder over tokens (B, S), causal
      self attention and cross attention over ``enc_out``; with
      ``make_cache`` also a fresh cache (self K/V of ``cache_len``
      slots holding the S positions, cross K/V of ``enc_out``), else
      None.
    cache given: one decode step, tokens (B, 1) at position ``pos`` (an
      int or a 0-d device tensor, shared by every row); the token's self
      K/V go to slot pos % cache_len, in place, and cross attention
      reads the cache's cross K/V (``enc_out`` is not used)."""
    emb = params["embed"]["embedding"]
    h = emb[tokens.long()].to(cfg.cdtype)
    decode = cache is not None
    if decode:
        pos = torch.as_tensor(pos, device=h.device)
        positions = pos.long().reshape(1)
        write = positions % cache["self_k"].shape[2]
    else:
        positions = torch.arange(h.shape[1], device=h.device)
        write = None
    h = h + sinusoidal_pos_emb(positions, cfg.d_model, h.dtype)[None]

    def body(h, lp, lc):
        x = apply_norm(lp["ln1"], h, cfg)
        if decode:
            y, _ = attn_mod.apply_attention(
                lp["attn"], x, cfg, rope=None, write=write, pos=pos,
                cache={"k": lc["self_k"], "v": lc["self_v"]})
        else:
            y, self_c = attn_mod.apply_attention(
                lp["attn"], x, cfg, rope=None, make_cache=make_cache,
                cache_len=cache_len)
        h = h + y
        x = apply_norm(lp["lnx"], h, cfg)
        cross_c = ({"k": lc["cross_k"], "v": lc["cross_v"]} if decode else
                   attn_mod.make_cross_cache(lp["xattn"], enc_out, cfg))
        y, _ = attn_mod.apply_attention(lp["xattn"], x, cfg, rope=None,
                                        cross=True, cache=cross_c)
        h = h + y
        h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)
        if not make_cache:
            return h, None
        return h, dict(zip(_CACHE_KEYS, (self_c["k"], self_c["v"],
                                         cross_c["k"], cross_c["v"])))

    if not (decode or make_cache):
        body = _remat(cfg, body)
    made = []
    for i, lp in enumerate(_unstack(params["decoder"]["layers"],
                                    cfg.num_layers)):
        h, c = body(h, lp, _layer(cache, i) if decode else None)
        made.append(c)
    h = apply_norm(params["decoder"]["final_norm"], h, cfg)
    logits = h @ emb.to(h.dtype).t()
    if make_cache:
        cache = _stack(made)
    return logits, cache


def loss(params, batch, cfg):
    """Mean next-token cross-entropy of the decoder over
    ``batch["tokens"]`` (B, S), attending the encoding of
    ``batch["audio_embeds"]``.  Returns (loss, metrics)."""
    enc_out = encode(params, batch["audio_embeds"], cfg)
    logits, _ = decoder_forward(params, batch["tokens"], enc_out, cfg)
    ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
    return ce, {"loss": ce, "ce": ce}


def init_cache(cfg, batch: int, cache_len: int, dtype=None,
               device="cuda") -> Dict[str, Any]:
    """Zero decode state: per layer the self K/V of ``cache_len`` slots
    and the cross K/V of ``cfg.encoder_seq_len``, (L, B, S, KV, hd)."""
    dtype = dtype or cfg.cdtype
    kv, hd, n = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    lens = (cache_len, cache_len, cfg.encoder_seq_len, cfg.encoder_seq_len)
    return {k: torch.zeros((n, batch, s, kv, hd), dtype=dtype, device=device)
            for k, s in zip(_CACHE_KEYS, lens)}


def prefill(params, batch, cfg, cache_len: int):
    """batch {"audio_embeds" (B, Se, D), "tokens" (B, S)} -> (logits (B,
    S, V), a fresh cache of ``cache_len`` self slots holding the S
    positions and the encoder output's cross K/V)."""
    enc_out = encode(params, batch["audio_embeds"], cfg)
    return decoder_forward(params, batch["tokens"], enc_out, cfg,
                           make_cache=True, cache_len=cache_len)


def decode_step(params, cache, tokens, pos, cfg):
    """One decode step: tokens (B, 1) at ``pos`` -> (logits (B, V),
    cache), the cache's self K/V updated in place."""
    logits, cache = decoder_forward(params, tokens, None, cfg, cache=cache,
                                    pos=pos)
    return logits[:, 0], cache
