"""On-device sampling: greedy argmax and temperature / top-k gumbel-max.

Replace the Pallas TPU kernels of ``repro/kernels/sampling.py``:
``greedy_sample`` (temperature 0) and ``gumbel_sample`` (temperature >
0, reached through ``ops.sample_tokens`` with the noise drawn outside
the kernel from the per-row keys).  CUDA source: ``csrc/sampling.cu``.

Bound on the H100: bytes — each logit (and each noise value) is read
once for a compare or two.  Design of both: each row is cut into
contiguous column chunks, one 256-thread CTA each, so that a launch has
up to eight CTAs per SM even at a few rows (one CTA per row would stream
a 0.6 MB row through one SM); the vocab tail needs no padding (threads
stop at V).  Each CTA reduces with warp shuffles, and a second
one-warp-per-row kernel merges the chunks; every partial reduction
breaks ties toward the lower column, which is ``jnp.argmax``'s rule.

Top-k needs the row's kth largest logit, duplicates counted, before the
argmax: a radix select over the order-preserving uint32 image of the f32
logits finds it, four 8-bit digit passes over the same column chunks
(the rows stay in L2 after the first), each summing per-CTA shared
histograms into a global one; each later pass, and the argmax, replays
the earlier digits' choice from those histograms.  The TPU kernel's k
unrolled max-extractions per block are not carried over.

The score is ``g + lg / temperature`` with IEEE division in both
versions (the build passes no fast-math flag), the mask ``lg >= kth`` as
the reference writes it (``lg < kth`` drops a column).  XLA compiles the
reference's division by the constant temperature as a multiply by its
f32 reciprocal, one ulp off for some logits, so a token can differ from
the reference's only where two scores tie to within that ulp.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import require_cuda, sm_count

THREADS = 256
MIN_COLS_PER_THREAD = 8
# a launch aims at 8 resident 256-thread CTAs on each SM of the card: a
# streaming pass needs many loads in flight
CTAS_PER_SM = 8
RADIX_PASSES = 4
RADIX_BINS = 256


def greedy_chunks(b: int, v: int, sms: int) -> int:
    """Column chunks per row on a card of ``sms`` SMs: enough for about
    CTAS_PER_SM CTAs per SM in all, at least MIN_COLS_PER_THREAD columns
    per thread of a chunk."""
    want = -(-CTAS_PER_SM * sms // b)
    cap = max(1, v // (THREADS * MIN_COLS_PER_THREAD))
    chunks = max(1, min(want, cap))
    return -(-v // -(-v // chunks))         # drop chunks left empty


def greedy_sample_plain(logits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``jnp.argmax(logits, -1)``: first
    occurrence of the maximum)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _check_logits(name, logits, *others):
    require_cuda(name, logits, *others)
    for t in (logits,) + others:
        if t.dim() != 2 or t.dtype != torch.float32 or t.shape != \
                logits.shape:
            raise ValueError(f"{name}: logits (and noise) must be (B, V) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, V) float32 -> (B,) int32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if logits.device.type == "cpu":
        return greedy_sample_plain(logits)
    _check_logits("greedy_sample", logits)
    b, v = logits.shape
    chunks = greedy_chunks(b, v, sm_count(logits.device))
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


def gumbel_sample_plain(logits: torch.Tensor, gumbel: torch.Tensor, *,
                        temperature: float, top_k: int = 0) -> torch.Tensor:
    """Plain PyTorch version, mirroring ``ref.sample_tokens``: top-k mask
    (``lax.top_k``'s kth value, duplicates included), then ``lg /
    temperature``, then the argmax of noise plus scaled logits."""
    lg = logits.float()
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -math.inf), lg)
    # a device tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    t = torch.full((), temperature, dtype=torch.float32, device=lg.device)
    return torch.argmax(gumbel + lg / t, dim=-1).to(torch.int32)


def gumbel_sample(logits: torch.Tensor, gumbel: torch.Tensor, *,
                  temperature: float, top_k: int = 0) -> torch.Tensor:
    """logits, gumbel (B, V) float32 -> (B,) int32: the argmax of
    ``gumbel + logits / temperature`` over the row, or over its columns
    with ``logits >= kth`` when ``top_k > 0``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not temperature > 0.0:
        raise ValueError("gumbel_sample: temperature must be > 0")
    b, v = logits.shape
    if not 0 <= top_k <= v:
        raise ValueError(f"gumbel_sample: top_k {top_k} outside [0, {v}]")
    if logits.device.type == "cpu":
        return gumbel_sample_plain(logits, gumbel, temperature=temperature,
                                   top_k=top_k)
    _check_logits("gumbel_sample", logits, gumbel)
    dev = logits.device
    chunks = greedy_chunks(b, v, sm_count(dev))
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    part = torch.empty((2 * b * chunks if chunks > 1 else 0,),
                       dtype=torch.int32, device=dev)
    hist = torch.empty((RADIX_PASSES * b * RADIX_BINS if top_k else 0,),
                       dtype=torch.int32, device=dev)
    lib = _build.library()
    rc = lib.rt_gumbel_sample(
        logits.data_ptr(), gumbel.data_ptr(), out.data_ptr(),
        part.data_ptr(), hist.data_ptr(), b, v, chunks, int(top_k),
        float(temperature), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "gumbel_sample")
    gumbel_sample.launches += 1
    return out


gumbel_sample.launches = 0
