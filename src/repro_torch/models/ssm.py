"""Mamba-2 / SSD (state-space duality) mixer [arXiv:2405.21060]
(``repro/models/ssm.py``).

Prefill and training use the chunked SSD algorithm: quadratic
attention-like work inside chunks of length Q plus a linear recurrence
over chunk states.  Decode is the O(1)-per-token state recurrence.
Layout as the Mamba-2 reference: in_proj -> [z | xBC | dt]; depthwise
causal conv over xBC; heads of ``head_dim`` with a scalar A per head;
B and C shared across ``n_groups``.

The serving forms keep their state in slot pools shared by every engine
row: the fused step gathers each row's slot through ``slot_gather``
(kernel 10) and writes it back through ``slot_scatter`` (kernel 11);
the N-step loop's per-row views are updated in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.slot_state import slot_gather
from repro_torch.kernels.ssd_chunk import ssd_chunk_bchp
from repro_torch.models.layers import (apply_conv1d, apply_norm, dense_init,
                                       init_conv1d, run_local,
                                       slot_conv_window, slot_state_scatter)


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def _shard_dims(params):
    """(d_inner, heads, conv channels) of a mixer's params: the config's
    (``_dims``), or a tensor-parallel shard's part of them."""
    return (params["out_proj"].shape[-2], params["A_log"].shape[-1],
            params["conv_w"].shape[-1])


def init_ssm(gen: torch.Generator, cfg, device):
    """One layer's params, with the reference's shapes and inits (the
    numbers differ: torch and jax draw differently)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    pd = cfg.pdtype
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    # dt bias such that softplus(dt_bias) spans [dt_min, dt_max]
    u = torch.rand((n_heads,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))      # inverse softplus
    p = {"in_proj": dense_init(gen, (d, d_in_proj), pd, device),
         "out_proj": dense_init(gen, (d_inner, d), pd, device),
         "dt_bias": dt_bias.to(pd),
         "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                           device=device)).to(pd),
         "D": torch.ones((n_heads,), dtype=pd, device=device),
         "norm": {"scale": torch.ones((d_inner,), dtype=pd, device=device)}}
    p.update(init_conv1d(gen, conv_dim, s.conv_kernel, pd, device))
    return p


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L) with out[i, j] = sum_{j<k<=i} x[k] for
    j <= i, else -inf: the exponent of the lower-triangular decay."""
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full((), -math.inf,
                                              device=x.device))


def _pad_chunks(chunk, x, dt, B, C):
    s = x.shape[1]
    if s % chunk == 0:
        return x, dt, B, C
    pad = chunk - s % chunk
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad)))


def _scan_states(states, chunk_decay, s0):
    """The inter-chunk recurrence: (final state, the state entering each
    chunk).  states (b, nc, h, p, n); chunk_decay (b, nc, h)."""
    carry, prev = s0, []
    for c in range(states.shape[1]):
        prev.append(carry)
        carry = (carry * chunk_decay[:, c, :, None, None].to(carry.dtype)
                 + states[:, c])
    return carry, torch.stack(prev, dim=1)


def ssd_chunked(x, dt, A, B, C, *, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD, plain PyTorch.

    x (b, s, h, p); dt (b, s, h) positive step sizes; A (h,) negative;
    B, C (b, s, g, n).  Returns (y (b, s, h, p), final_state (b, h, p,
    n)).  The dtype casts follow the reference's (its einsums with
    ``preferred_element_type=f32`` take f32 operands here)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    x, dt, B, C = _pad_chunks(chunk, x, dt, B, C)
    sp = x.shape[1]
    nc = sp // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dA = dtc * A.float()[None, None, None, :]                 # (b,nc,l,h)
    dA_cum = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic, attention-like)
    Lmat = torch.exp(_segsum(dA.movedim(3, 2)))               # (b,nc,h,l,l)
    scores = torch.einsum("bcihn,bcjhn->bchij", Ch.float(), Bh.float())
    M = scores * Lmat
    xdt = xc * dtc[..., None].to(xc.dtype)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M.to(xc.dtype), xdt)

    # chunk states
    decay_to_end = torch.exp(dA_cum[..., -1:, :] - dA_cum)   # (b,nc,l,h)
    states = torch.einsum(
        "bclhn,bclhp->bchpn",
        (Bh * (decay_to_end * dtc)[..., None]).to(xc.dtype), xc)

    # inter-chunk recurrence and contribution
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])              # (b,nc,h)
    s0 = (torch.zeros((b, h, p, n), dtype=xc.dtype, device=x.device)
          if init_state is None else init_state.to(xc.dtype))
    final, prev_states = _scan_states(states, chunk_decay, s0)
    state_decay = torch.exp(dA_cum)                           # (b,nc,l,h)
    y_off = torch.einsum("bclhn,bchpn->bclhp",
                         (Ch * state_decay[..., None]).to(xc.dtype),
                         prev_states)
    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    return y, final


def ssd_chunked_pallas(x, dt, A, B, C, *, chunk: int,
                       init_state: Optional[torch.Tensor] = None):
    """``ssd_chunked`` with the intra-chunk block on the
    ``ssd_chunk_bchp`` kernel (kernel 12); the inter-chunk recurrence and
    the off-diagonal term stay in PyTorch, in float32.  Same signature
    and semantics (the name is the reference's)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    x, dt, B, C = _pad_chunks(chunk, x, dt, B, C)
    sp = x.shape[1]
    nc = sp // chunk
    rep = h // g

    xc = x.reshape(b * nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    dA = dtc * A.float()[None, None, None, :]
    dA_cum = torch.cumsum(dA, dim=2)

    y_diag, states = ssd_chunk_bchp(
        xc.contiguous(), dtc.reshape(b * nc, chunk, h).contiguous(),
        dA_cum.reshape(b * nc, chunk, h).contiguous(),
        Bh.reshape(b * nc, chunk, h, n).contiguous(),
        Ch.reshape(b * nc, chunk, h, n).contiguous())
    y_diag = y_diag.reshape(b, nc, chunk, h, p)
    states = states.reshape(b, nc, h, n, p).transpose(3, 4)   # (b,nc,h,p,n)

    chunk_decay = torch.exp(dA_cum[:, :, -1, :])
    s0 = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    final, prev_states = _scan_states(states, chunk_decay, s0)
    state_decay = torch.exp(dA_cum)
    y_off = torch.einsum("bclhn,bchpn->bclhp",
                         (Ch * state_decay[..., None]).float(), prev_states)
    y = (y_diag.float() + y_off).reshape(b, sp, h, p)[:, :s]
    return y.to(x.dtype), final.to(x.dtype)


def ssd_recurrent_step(state, x_t, dt_t, A, B_t, C_t):
    """One decode step.  state (b, h, p, n); x_t (b, h, p); dt_t (b, h);
    B_t, C_t (b, g, n).  Returns (y_t (b, h, p), new_state), both in the
    state's dtype: the update runs in it (the reference runs the
    increment in x's dtype; the two agree when the dtypes do)."""
    h = x_t.shape[1]
    f = state.dtype
    rep = h // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1)                    # (b,h,n)
    Ch = C_t.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt_t.float() * A.float())                 # (b,h)
    new = (state * dA[..., None, None].to(f)
           + torch.einsum("bhp,bhn->bhpn",
                          x_t.to(f) * dt_t[..., None].to(f), Bh.to(f)))
    y = torch.einsum("bhpn,bhn->bhp", new, Ch.to(f))
    return y, new


def apply_ssm(params, x, cfg, **kw):
    """Mamba-2 mixer.  x (B, S, D).  Returns (y, cache).  Keywords and
    cache forms: ``ssm_steps``'s, run on one device."""
    return run_local(ssm_steps(params, x, cfg, **kw))


def ssm_steps(params, x, cfg, *, cache=None, make_cache=False, pos=None,
              valid_len=None, state_slots=None):
    """The Mamba-2 mixer as steps (``layers.run_local`` runs them on one
    device): it yields ``("sumsq", yz)`` once, the gated output y *
    silu(z) of its channels, and takes back the sum of its squares over
    every shard's channels (None: this is every channel), so that the
    gated RMSNorm spans all ``d_inner`` channels of a tensor-parallel
    slice; then returns (y, cache), y this shard's partial output.
    Dims are the params' (``_shard_dims``).

    cache None: the full sequence; with ``make_cache`` a fresh cache
      {"conv": (B,K-1,convdim), "state": (B,H,P,N)} comes back, the
      state in float32 (see ``init_ssm_cache``).
    cache {"conv", "state"} without ``state_slots`` (the non-paged
      decode's contiguous cache): continued from it and updated in
      place.
    cache {"conv_view", "state_view"} (the N-step loop's per-row views):
      updated in place after ``valid_len`` tokens (0 leaves a row as it
      was: its dt is masked to 0).
    cache {"conv": (S,K-1,convdim), "state": (S,H,P,N)} slot pools with
      ``state_slots`` (B,): row b reads slot ``state_slots[b]`` (zeros
      where ``pos[b] == 0``) through ``slot_gather`` and writes it back
      after ``valid_len[b]`` tokens through ``slot_scatter``, in place;
      rows with ``valid_len == 0`` write trash slot 0 instead.
    """
    s = cfg.ssm
    d_inner, n_heads, conv_dim = _shard_dims(params)
    b, slen, _ = x.shape
    dt_ = x.dtype
    view = cache is not None and "conv_view" in cache
    paged = state_slots is not None and cache is not None and not view

    zxbcdt = x @ params["in_proj"].to(dt_)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., -n_heads:]

    if view:
        conv0 = cache["conv_view"].to(dt_)
        state0 = cache["state_view"]
        conv_cache = conv0
    elif paged:
        fresh = pos == 0
        conv0 = slot_gather(cache["conv"], state_slots, fresh).to(dt_)
        state0 = slot_gather(cache["state"], state_slots, fresh)
        conv_cache = conv0
    else:
        conv_cache = cache["conv"] if cache is not None else None
        state0 = cache["state"] if cache is not None else None
    xBC_raw = xBC                       # pre-conv inputs (the conv window)
    xBC, new_conv = apply_conv1d({"conv_w": params["conv_w"],
                                  "conv_b": params["conv_b"]}, xBC,
                                 cache=conv_cache)
    xBC = F.silu(xBC)
    gn = (conv_dim - d_inner) // 2
    xs = xBC[..., :d_inner].reshape(b, slen, n_heads, s.head_dim)
    Bm = xBC[..., d_inner:d_inner + gn].reshape(b, slen, -1, s.d_state)
    Cm = xBC[..., d_inner + gn:].reshape(b, slen, -1, s.d_state)
    dtf = dt_raw.float() + params["dt_bias"].float()
    dt = torch.logaddexp(dtf, torch.zeros_like(dtf))      # softplus
    if valid_len is not None:
        # dt = 0 makes a position the identity on the recurrence: padded
        # columns, and whole padded rows, cannot advance any state
        vmask = (torch.arange(slen, device=x.device)[None]
                 < valid_len[:, None])
        dt = torch.where(vmask[..., None], dt, torch.zeros((),
                                                           device=x.device))
    A = -torch.exp(params["A_log"].float())

    if slen > 1 or state0 is None:
        y, final_state = ssd_chunked(xs, dt, A, Bm, Cm, chunk=s.chunk_size,
                                     init_state=state0)
    else:
        y_t, final_state = ssd_recurrent_step(
            state0, xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y_t[:, None].to(dt_)

    y = y + xs * params["D"].to(dt_)[None, None, :, None]
    y = y.reshape(b, slen, d_inner)
    # gated RMSNorm (Mamba-2): norm(y * silu(z)) over every channel
    yz = y * F.silu(z)
    sumsq = yield ("sumsq", yz)
    if sumsq is None:
        y = apply_norm(params["norm"], yz, cfg)
    else:
        rms = torch.rsqrt(sumsq / _dims(cfg)[0] + cfg.norm_eps)
        y = (yz.float() * rms * params["norm"]["scale"].float()).to(dt_)
    out = y @ params["out_proj"].to(dt_)

    if view:
        cache["conv_view"].copy_(slot_conv_window(conv0, xBC_raw, valid_len))
        cache["state_view"].copy_(final_state)
        return out, cache
    if paged:
        slot_state_scatter(cache["conv"], state_slots, valid_len,
                           slot_conv_window(conv0, xBC_raw, valid_len))
        slot_state_scatter(cache["state"], state_slots, valid_len,
                           final_state)
        return out, cache
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(final_state)
        return out, cache
    if make_cache:
        return out, {"conv": new_conv.to(dt_), "state": final_state.float()}
    return out, None


def init_ssm_cache(cfg, batch: int, dtype, device=None):
    """Zero conv windows in ``dtype`` and SSD states in float32.  The
    reference keeps the state in ``dtype`` too; in bfloat16 a decay
    factor within 2^-9 of 1 (dt * A > -0.002, common at mamba's dt
    range) rounds to 1 and an increment below half a bf16 ulp of the
    state is lost at every decode step, so the port keeps the state, an
    accumulator, in float32 (identical for float32 models)."""
    s = cfg.ssm
    _, n_heads, conv_dim = _dims(cfg)
    return {"conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, n_heads, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device)}
