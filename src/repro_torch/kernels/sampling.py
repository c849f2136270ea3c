"""On-device sampling: greedy argmax and temperature / top-k gumbel-max.

Replace the Pallas TPU kernels of ``repro/kernels/sampling.py``:
``greedy_sample`` (temperature 0) and ``gumbel_sample`` (temperature >
0, reached through ``ops.sample_tokens`` with the noise drawn outside
the kernel from the per-row keys).  CUDA source: ``csrc/sampling.cu``.

Bound on the H100: bytes — each logit (and each noise value) is read
once for a compare or two.  Both kernels are one launch a call of one
cluster kernel: a thread-block cluster a row (Hopper), each CTA taking
a contiguous slice of the row, its partial argmax merged into the
cluster's first CTA through distributed shared memory (no global
scratch, no second kernel); every partial reduction breaks ties toward
the lower column, which is ``jnp.argmax``'s rule.  ``greedy_plan`` and
``gumbel_plan`` pick the cluster size from B, V (top-k) and the SM
count.

Kernel 3 (greedy) and kernel 4 without top-k stream each CTA's slice
once (logits, or logits and noise) into its argmax.  Top-k needs the
row's kth largest logit, duplicates counted, before the argmax: each CTA
holds its logits slice in shared memory, read from device memory once,
and a radix select over the order-preserving uint32 image of the f32
logits finds kth in four 8-bit digits over shared memory, each CTA
adding its histogram into the cluster's first CTA through distributed
shared memory; from the third digit on each CTA reads only its
candidates (the columns at or above the first digit chosen), and the
argmax reads the noise of the kept columns alone.  A row whose slices
no cluster's shared memory holds (``gumbel_staged`` false) runs the
same select over its slices in device memory.  The TPU kernel's k
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

# the cluster sizes (16 is beyond the portable 8, which Hopper allows on
# request), the dynamic shared memory a CTA's staged logits slice may
# take (of the 227 KiB a block may hold; the kernel's own histograms,
# candidate list and partials take 21.3 KiB more), and the fewest columns a
# slice of a cluster of more than one CTA may have (fewer do not pay for
# the cluster barriers)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
GUMBEL_SMEM_BYTES = 200 * 1024
MIN_SLICE = 1024
# the top-k select's slice once the rows fill the card: qwen2's 18,992
# columns (clusters of 8) beat 37,984 and 9,496 at 64-264 rows; and the
# CTAs an SM a streaming launch (one pass: kernel 4 without top-k, and
# kernel 3) comes nearest: kernel 4's fastest size at every row count of
# the three served vocabularies, kernel 3's at all but 64 rows (there 2
# CTAs a row beat the plan's 4 by 5-8%; chip_gumbel_sizes.py; PERF.md)
SELECT_SLICE = 20 * 1024
STREAM_CTAS_PER_SM = 2


def gumbel_slice(v: int, cluster: int) -> int:
    """Columns of a CTA's slice of a ``v``-column row over ``cluster``
    CTAs (csrc/sampling.cu gumbel_slice): CTA r holds [r * slice, (r + 1)
    * slice), a multiple of 4 for 16-byte copies; the last may be short
    (or empty)."""
    cols = -(-v // cluster)
    return -(-cols // 4) * 4


def gumbel_staged(v: int, cluster: int, top_k: int) -> bool:
    """Whether kernel 4 holds each CTA's logits slice in shared memory:
    with top-k, where the slice (f32) fits GUMBEL_SMEM_BYTES.  Else its
    select reads the slice from device memory (with top-k), or nothing
    is selected (without)."""
    return bool(top_k) and 4 * gumbel_slice(v, cluster) <= GUMBEL_SMEM_BYTES


def gumbel_clusters(v: int, top_k: int):
    """The cluster sizes kernels 3 and 4 launch over a ``v``-column row,
    ascending: a slice of MIN_SLICE columns or more when the cluster has
    more than one CTA; with top-k, those that stage their slice
    (``gumbel_staged``) where any does, else every such size (the
    select then reads device memory: rows wider than 16 x 51,200
    columns)."""
    sizes = [c for c in CLUSTER_SIZES
             if c == 1 or gumbel_slice(v, c) >= MIN_SLICE]
    staged = [c for c in sizes if gumbel_staged(v, c, top_k)]
    return staged or sizes


def greedy_plan(b: int, v: int, sms: int) -> int:
    """Kernel 3's cluster size for ``b`` rows of ``v`` columns on a card
    of ``sms`` SMs: kernel 4's without top-k (the same streaming pass
    over half the bytes), the fastest size of the H100's sweep of kernel
    3 or within 1.5% of it but at 64 rows (5-8% there; PERF.md)."""
    return gumbel_plan(b, v, sms, 0)


def gumbel_plan(b: int, v: int, sms: int, top_k: int) -> int:
    """Kernel 4's cluster size for ``b`` rows of ``v`` columns on a card
    of ``sms`` SMs, among ``gumbel_clusters``, as the H100 measured them
    (PERF.md).  Without top-k the one whose launch comes nearest
    STREAM_CTAS_PER_SM CTAs an SM.  With top-k the smallest whose slice
    holds at most SELECT_SLICE columns, made larger while the launch has
    fewer CTAs than SMs (a row no cluster stages takes 16).  Either way
    few rows take the largest: 8 rows of qwen2's vocab are 8 clusters of
    16."""
    fits = gumbel_clusters(v, top_k)
    if not top_k:
        want = STREAM_CTAS_PER_SM * sms
        return min(fits, key=lambda c: abs(math.log(b * c / want)))
    fits = fits[next((i for i, c in enumerate(fits)
                      if gumbel_slice(v, c) <= SELECT_SLICE),
                     len(fits) - 1):]
    return next((c for c in fits if b * c >= sms), fits[-1])


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
    version; CUDA tensors launch the kernel once, in clusters of
    ``greedy_plan``'s size."""
    if logits.device.type == "cpu":
        return greedy_sample_plain(logits)
    _check_logits("greedy_sample", logits)
    b, v = logits.shape
    return _greedy_launch(logits, greedy_plan(b, v, sm_count(logits.device)))


def _greedy_launch(logits, cluster):
    """Kernel 3 once, in clusters of ``cluster`` CTAs: ``greedy_sample``
    passes its plan's size; ``chip_gumbel_sizes.py`` times the others."""
    b, v = logits.shape
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    lib = _build.library()
    rc = lib.rt_greedy_sample(
        logits.data_ptr(), out.data_ptr(), b, v, cluster,
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
    plain version; CUDA tensors launch the kernel once, in clusters of
    ``gumbel_plan``'s size."""
    if not temperature > 0.0:
        raise ValueError("gumbel_sample: temperature must be > 0")
    b, v = logits.shape
    if not 0 <= top_k <= v:
        raise ValueError(f"gumbel_sample: top_k {top_k} outside [0, {v}]")
    if logits.device.type == "cpu":
        return gumbel_sample_plain(logits, gumbel, temperature=temperature,
                                   top_k=top_k)
    _check_logits("gumbel_sample", logits, gumbel)
    return _gumbel_launch(logits, gumbel, temperature, top_k,
                          gumbel_plan(b, v, sm_count(logits.device), top_k))


def _gumbel_launch(logits, gumbel, temperature, top_k, cluster):
    """Kernel 4 once, in clusters of ``cluster`` CTAs: ``gumbel_sample``
    passes its plan's size; ``chip_gumbel_sizes.py`` times the others."""
    b, v = logits.shape
    dev = logits.device
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    lib = _build.library()
    staged = gumbel_staged(v, cluster, top_k)
    rc = lib.rt_gumbel_sample(
        logits.data_ptr(), gumbel.data_ptr(), out.data_ptr(), b, v, cluster,
        int(top_k), int(staged), float(temperature),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "gumbel_sample")
    gumbel_sample.launches += 1
    return out


gumbel_sample.launches = 0
