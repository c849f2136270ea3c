"""Shared building blocks: inits, rmsnorm, the swiglu MLP, rotary
embeddings and the cross-entropy loss (``repro/models/layers.py``)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


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
    if "w_gate" in params:
        g = x @ params["w_gate"].to(x.dtype)
        u = x @ params["w_up"].to(x.dtype)
        h = F.silu(g) * u
    else:
        h = F.gelu(x @ params["w_up"].to(x.dtype), approximate="none")
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in f32.  logits (..., V); labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean()
