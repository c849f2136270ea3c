"""Shared building blocks: inits, rmsnorm and layernorm, the swiglu and
gelu MLPs, rotary and sinusoidal position embeddings, the depthwise
causal conv with its slot-state helpers, and the cross-entropy loss
(``repro/models/layers.py``), with the vocab-parallel embedding lookup
and cross-entropy of a tensor-parallel training rank."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.slot_state import slot_scatter


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (lecun-style), cut at two sigma."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype, device,
               scale: float = 0.02) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def init_norm(dim: int, cfg, device, n: int = 0):
    """A norm's params: a unit scale, and for ``cfg.norm == "layernorm"``
    a zero bias; stacked on a leading axis of n layers when n > 0."""
    shape = ((n,) if n else ()) + (dim,)
    p = {"scale": torch.ones(shape, dtype=cfg.pdtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=cfg.pdtype, device=device)
    return p


def apply_norm(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """rmsnorm (or layernorm when the params carry a bias), in f32."""
    d = (x.shape[-1],)
    x32 = x.float()
    if "bias" in params:
        y = F.layer_norm(x32, d, params["scale"].float(),
                         params["bias"].float(), cfg.norm_eps)
    else:
        y = F.rms_norm(x32, d, params["scale"].float(), cfg.norm_eps)
    return y.to(x.dtype)


def apply_mlp(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """swiglu when the params hold a gate, else gelu in its tanh form
    (``jax.nn.gelu``'s default, which the reference calls)."""
    if "w_gate" in params:
        g = x @ params["w_gate"].to(x.dtype)
        u = x @ params["w_up"].to(x.dtype)
        h = F.silu(g) * u
    else:
        h = F.gelu(x @ params["w_up"].to(x.dtype), approximate="tanh")
    return h @ params["w_down"].to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each (..., S, 1, hd), for positions (..., S), laid out
    for ``apply_rope``: cos = [c, c], sin = [-s, s] over the two halves.
    One table serves every layer of a forward."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs           # (...,S,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], -1)[..., None, :],
            torch.cat([-sin, sin], -1)[..., None, :])


def apply_rope(x: torch.Tensor, table) -> torch.Tensor:
    """x: (..., S, H, hd); table from ``rope_table``.  The half-split
    convention: the first and second halves of the head dim are the two
    coordinates of each rotated pair, so with h = hd/2
    out = [x1 c - x2 s, x2 c + x1 s] = x * [c, c] + [x2, x1] * [-s, s]."""
    cos, sin = table
    x32 = x.float()
    out = x32 * cos + x32.roll(x.shape[-1] // 2, dims=-1) * sin
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions: torch.Tensor, dim: int, dtype):
    """The classic transformer's sinusoidal embeddings, (..., S, dim) for
    positions (..., S): [sin, cos] of position x 10000^(-i / (dim/2 -
    1)), zero-padded by one column for an odd dim."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    args = positions[..., None].float() * freqs
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


# ---------------------------------------------------------------------------
# depthwise causal conv1d (the mamba frontend) and slot-state helpers
# ---------------------------------------------------------------------------


def init_conv1d(gen: torch.Generator, channels: int, kernel: int, dtype,
                device):
    return {"conv_w": dense_init(gen, (kernel, channels), dtype, device,
                                 scale=1.0 / math.sqrt(kernel)),
            "conv_b": torch.zeros((channels,), dtype=dtype, device=device)}


def apply_conv1d(params, x: torch.Tensor, cache=None):
    """Depthwise causal conv.  x (B, S, C); cache (B, K-1, C) past inputs
    or None (zeros).  Returns (y, new_cache), the new cache holding the
    last K-1 inputs."""
    w = params["conv_w"].to(x.dtype)             # (K, C)
    bias = params["conv_b"].to(x.dtype)
    k, s = w.shape[0], x.shape[1]
    if cache is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)              # (B, S+K-1, C)
    # sum_k w[k] * x[t - (K-1) + k], in the reference's order
    y = sum(w[i] * xp[:, i:i + s] for i in range(k))
    y = y + bias
    new_cache = xp[:, -(k - 1):] if k > 1 else pad
    return y, new_cache


def slot_conv_window(conv0: torch.Tensor, x_raw: torch.Tensor, valid_len):
    """Conv cache for a paged state slot: the last K-1 *valid* inputs of
    [conv0 | x_raw], the window ending just before column ``valid_len``
    (None: every column is valid)."""
    b, s = x_raw.shape[:2]
    k1 = conv0.shape[1]
    full = torch.cat([conv0, x_raw], dim=1)      # (B, K-1+S, C)
    vl = (torch.full((b,), s, dtype=torch.long, device=x_raw.device)
          if valid_len is None else valid_len.long())
    idx = vl[:, None] + torch.arange(k1, device=x_raw.device)[None]
    return torch.gather(full, 1, idx[..., None].expand(-1, -1,
                                                      full.shape[2]))


def slot_state_scatter(pool: torch.Tensor, state_slots: torch.Tensor,
                       valid_len, value: torch.Tensor) -> torch.Tensor:
    """Write each row's recurrent state to its slot of ``pool`` (S, *F),
    in place; rows with ``valid_len == 0`` (padding, stale rows) write
    trash slot 0 instead, so they can never advance a live slot's state.
    On the card one ``slot_scatter`` launch, which routes those rows
    itself from ``valid_len`` (int32 or int64) as it comes."""
    return slot_scatter(pool, state_slots.to(torch.int32).contiguous(),
                        value.to(pool.dtype).contiguous(),
                        valid_len=valid_len)


def run_local(steps):
    """Run a mixer's steps (``ssm.ssm_steps``, ``rglru.rglru_steps``) on
    one device: every cross-shard value they yield is theirs alone, so
    each gets None back (the mixer then uses its own).  Returns the
    mixer's result."""
    try:
        next(steps)
        while True:
            steps.send(None)
    except StopIteration as done:
        return done.value


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in f32.  logits (..., V); labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean()


# ---------------------------------------------------------------------------
# over a vocab split along the model axis (a tensor-parallel training rank)
# ---------------------------------------------------------------------------


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, axis, dtype
                ) -> torch.Tensor:
    """The embedding rows of ``tokens`` when this rank holds rows [index
    * n, (index + 1) * n) of the table (n = ``table.shape[0]``): each
    rank looks up the tokens of its rows (zeros for the others) and the
    sum over the model group (``axis.reduce_out``) is each token's row,
    exactly."""
    n = table.shape[0]
    local = tokens.long() - axis.index * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(dtype)
    return axis.reduce_out(rows * hit[..., None].to(dtype))


class _VocabNll(torch.autograd.Function):
    """Per-token cross-entropy over logits split by vocab columns: the
    row max and the sum of exponentials over the model group, the target
    logit from the rank whose columns hold it.  Backward: this rank's
    columns of softmax - onehot, scaled by the incoming gradient."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        import torch.distributed as dist
        m = logits.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[:, None])
        s = e.sum(-1)
        dist.all_reduce(s, group=group)
        local = labels - lo
        hit = (local >= 0) & (local < logits.shape[-1])
        idx = local.clamp(0, logits.shape[-1] - 1)
        tgt = torch.where(hit, logits.gather(-1, idx[:, None])[:, 0],
                          torch.zeros((), dtype=logits.dtype,
                                      device=logits.device))
        dist.all_reduce(tgt, group=group)
        ctx.save_for_backward(e, s, idx, hit)
        return torch.log(s) + m - tgt

    @staticmethod
    def backward(ctx, g):
        e, s, idx, hit = ctx.saved_tensors
        grad = e * (g / s)[:, None]
        grad.scatter_add_(-1, idx[:, None],
                          torch.where(hit, -g, torch.zeros_like(g))[:, None])
        return grad, None, None, None


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, axis
              ) -> torch.Tensor:
    """Per-token next-token CE in f32 (labels' shape) when ``logits``
    (..., V / size) are this rank's vocab columns [index * V / size,
    ...): the whole-vocab CE of each token, on every rank."""
    v = logits.shape[-1]
    flat = _VocabNll.apply(logits.float().reshape(-1, v),
                           labels.long().reshape(-1), axis.index * v,
                           axis.group)
    return flat.reshape(labels.shape)
