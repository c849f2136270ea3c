"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427;
``repro/models/rglru.py``).

Recurrence:  r_t = sigmoid(x_t W_r + b_r)        (recurrence gate)
             i_t = sigmoid(x_t W_i + b_i)        (input gate)
             log a_t = -c * softplus(Lambda) * r_t
             h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A sequence runs the linear recurrence h_t = a_t h_{t-1} + b_t as a
log-depth scan (``lru_scan``); a one-token step is the single update.
The Griffin recurrent *block* wraps the RG-LRU with a depthwise conv and
a GeLU-gated branch.

The serving forms keep the conv window and the hidden state in slot
pools shared by every engine row, as the mamba mixer does (``ssm.py``):
the fused step gathers each row's slot through ``slot_gather`` (kernel
10) and writes it back through ``slot_scatter`` (kernel 11); the N-step
loop's per-row views are updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.slot_state import slot_gather
from repro_torch.models.layers import (apply_conv1d, dense_init, init_conv1d,
                                       run_local, slot_conv_window,
                                       slot_state_scatter)


def init_rglru(gen: torch.Generator, cfg, device):
    """One layer's params, with the reference's shapes and inits: Lambda
    set so that a^c spans [0.9, 0.999] at r = 1 (the numbers of the
    random leaves differ: torch and jax draw differently)."""
    g = cfg.rglru
    d = cfg.d_model
    w = g.lru_width or d
    pd = cfg.pdtype
    ramp = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=device)
    p = {"w_x": dense_init(gen, (d, w), pd, device),
         "w_gate": dense_init(gen, (d, w), pd, device),
         "w_r": dense_init(gen, (w, w), pd, device),
         "w_i": dense_init(gen, (w, w), pd, device),
         "b_r": torch.zeros((w,), dtype=pd, device=device),
         "b_i": torch.zeros((w,), dtype=pd, device=device),
         "lam": torch.log(torch.expm1(-torch.log(ramp) / g.gate_c)).to(pd),
         "w_out": dense_init(gen, (w, d), pd, device)}
    p.update(init_conv1d(gen, w, g.conv_kernel, pd, device))
    return p


def lru_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """The linear recurrence h_t = a_t h_{t-1} + b_t over axis 1 as a
    Hillis-Steele scan of the pairs (a, b) under (a1, b1) then (a2, b2)
    -> (a1 a2, a2 b1 + b2), the reference's ``associative_scan``
    operator: ceil(log2 S) passes over whole tensors (7 at a 128-token
    chunk).  A product of the a's by ``exp(cumsum(log a))`` is no
    substitute: a can be about 0.43 at gate_c 8, and such products
    underflow float32 within a chunk.  a, b (B, S, W); h0 (B, W) or
    None (zeros).  Returns h (B, S, W)."""
    if h0 is not None:
        # fold h0 into the first step: b_0 += a_0 * h0
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def lru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """``lru_scan`` as a sequential loop over the positions: the test
    oracle."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def apply_rglru(params, x, cfg, **kw):
    """Griffin recurrent block.  x (B, S, D).  Returns (y, cache).
    Keywords and cache forms: ``rglru_steps``'s, run on one device."""
    return run_local(rglru_steps(params, x, cfg, **kw))


def rglru_steps(params, x, cfg, *, cache=None, make_cache=False, pos=None,
                valid_len=None, state_slots=None):
    """The Griffin recurrent block as steps (``layers.run_local`` runs
    them on one device): it yields ``("cat", xr)`` once, the post-conv
    inputs of its channels, and takes back every shard's concatenated
    (None: these are all of them), which the gates' dense products
    ``w_r`` / ``w_i`` read whole; then returns (y, cache), y this
    shard's partial output.  A tensor-parallel shard holds its channels'
    columns of every product but ``w_out``'s rows.

    cache None: the full sequence from a zero state; with ``make_cache``
      a fresh cache {"conv": (B,K-1,W), "h": (B,W)} comes back, the
      conv window in x's dtype and h in float32 (see
      ``init_rglru_cache``).
    cache {"conv", "h"} without ``state_slots`` (the non-paged decode's
      contiguous cache): continued from it and updated in place.
    cache {"conv_view", "h_view"} (the N-step loop's per-row views):
      updated in place after ``valid_len`` tokens (0 leaves a row as it
      was: its update is the identity).
    cache {"conv": (S,K-1,W), "h": (S,W)} slot pools with
      ``state_slots`` (B,): row b reads slot ``state_slots[b]`` (zeros
      where ``pos[b] == 0``) through ``slot_gather`` and writes it back
      after ``valid_len[b]`` tokens through ``slot_scatter``, in place;
      rows with ``valid_len == 0`` write trash slot 0 instead.
    Padded columns (at or past ``valid_len``) are forced to the identity
    update (a = 1, b = 0), so neither a padded chunk tail nor a stale row
    can move any state.
    """
    g = cfg.rglru
    dt = x.dtype
    s = x.shape[1]
    view = cache is not None and "conv_view" in cache
    paged = state_slots is not None and cache is not None and not view

    gate = F.gelu(x @ params["w_gate"].to(dt), approximate="tanh")
    xr = x @ params["w_x"].to(dt)
    if view:
        conv0 = cache["conv_view"].to(dt)
        h0 = cache["h_view"].float()
        conv_cache = conv0
    elif paged:
        fresh = pos == 0
        conv0 = slot_gather(cache["conv"], state_slots, fresh).to(dt)
        h0 = slot_gather(cache["h"], state_slots, fresh).float()
        conv_cache = conv0
    else:
        conv_cache = cache["conv"] if cache is not None else None
        h0 = cache["h"].float() if cache is not None else None
    xr_raw = xr                         # pre-conv inputs (the conv window)
    xr, new_conv = apply_conv1d({"conv_w": params["conv_w"],
                                 "conv_b": params["conv_b"]}, xr,
                                cache=conv_cache)

    xr_all = yield ("cat", xr)
    if xr_all is None:
        xr_all = xr
    r = torch.sigmoid(xr_all @ params["w_r"].to(dt) + params["b_r"].to(dt))
    i = torch.sigmoid(xr_all @ params["w_i"].to(dt) + params["b_i"].to(dt))
    lam = params["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -g.gate_c * softplus * r.float()
    a = torch.exp(log_a)
    # sqrt(1 - a^2) with a = exp(log_a); stable through expm1
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    bterm = beta * (i.float() * xr.float())
    if valid_len is not None:
        vmask = (torch.arange(s, device=x.device)[None]
                 < valid_len[:, None])[..., None]
        a = torch.where(vmask, a, torch.ones((), device=x.device))
        bterm = torch.where(vmask, bterm, torch.zeros((), device=x.device))

    if s == 1 and h0 is not None:
        h_last = a[:, 0] * h0 + bterm[:, 0]
        hseq = h_last[:, None]
    else:
        hseq = lru_scan(a, bterm, h0)
        h_last = hseq[:, -1]

    out = (hseq.to(dt) * gate) @ params["w_out"].to(dt)
    if view:
        cache["conv_view"].copy_(slot_conv_window(conv0, xr_raw, valid_len))
        cache["h_view"].copy_(h_last)
        return out, cache
    if paged:
        slot_state_scatter(cache["conv"], state_slots, valid_len,
                           slot_conv_window(conv0, xr_raw, valid_len))
        slot_state_scatter(cache["h"], state_slots, valid_len, h_last)
        return out, cache
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)
        return out, cache
    if make_cache:
        return out, {"conv": new_conv.to(dt), "h": h_last}
    return out, None


def init_rglru_cache(cfg, batch: int, dtype, device=None):
    """Zero conv windows in ``dtype`` and hidden states in float32.  The
    reference keeps h in ``dtype`` too; in bfloat16 an update whose
    decay a lies within 2^-9 of 1 (a^c spans [0.9, 0.999] at r = 1)
    moves h by less than half a bf16 ulp and is lost at every decode
    step, as mamba's SSD state was (``ssm.init_ssm_cache``): on the card
    a static batch of recurrentgemma-2b decoding 122 steps with a bf16 h
    emitted a token 0.2301 below the f32 row max.  So the port keeps h,
    an accumulator, in float32 (identical for float32 models)."""
    g = cfg.rglru
    w = g.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, g.conv_kernel - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device)}
