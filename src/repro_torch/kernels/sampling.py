"""Greedy on-device sampling: per-row argmax over the vocab.

Replaces the Pallas TPU kernel ``repro/kernels/sampling.py``
``greedy_sample`` (reached through ``ops.sample_tokens`` at temperature
0).  CUDA source: ``csrc/sampling.cu``.  Temperature / top-k sampling
(``gumbel_sample``) is not ported yet: it needs the reference's threefry
keys reproduced bit for bit (ROADMAP §2).

Bound on the H100: bytes — each logit is read once (B * V * 4 bytes) for
one compare.  Design: each row is cut into contiguous column chunks, one
256-thread CTA each, so that a launch has about two CTAs per SM even at a
few rows (one CTA per row would stream a 0.6 MB row through one SM); the
vocab tail needs no padding (threads stop at V).  Each CTA reduces with
warp shuffles, and a second one-warp-per-row kernel merges the chunks;
every partial reduction breaks ties toward the lower column, which is
``jnp.argmax``'s rule.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import TARGET_CTAS, require_cuda

THREADS = 256
MIN_COLS_PER_THREAD = 8


def greedy_chunks(b: int, v: int) -> int:
    """Column chunks per row: enough for about TARGET_CTAS CTAs in all,
    at least MIN_COLS_PER_THREAD columns per thread of a chunk."""
    want = -(-TARGET_CTAS // b)
    cap = max(1, v // (THREADS * MIN_COLS_PER_THREAD))
    chunks = max(1, min(want, cap))
    return -(-v // -(-v // chunks))         # drop chunks left empty


def greedy_sample_plain(logits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``jnp.argmax(logits, -1)``: first
    occurrence of the maximum)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, V) float32 -> (B,) int32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if logits.device.type == "cpu":
        return greedy_sample_plain(logits)
    require_cuda("greedy_sample", logits)
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError("greedy_sample: logits must be (B, V) float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    b, v = logits.shape
    chunks = greedy_chunks(b, v)
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    part = torch.empty((2 * b * chunks if chunks > 1 else 0,),
                       dtype=torch.int32, device=logits.device)
    lib = _build.library()
    rc = lib.rt_greedy_sample(
        logits.data_ptr(), out.data_ptr(), part.data_ptr(), b, v, chunks,
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(rc, "greedy_sample")
    greedy_sample.launches += 1
    return out


greedy_sample.launches = 0
