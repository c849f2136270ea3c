"""On-device sampling: greedy argmax and temperature / top-k gumbel-max.

Replace the Pallas TPU kernels of ``repro/kernels/sampling.py``:
``greedy_sample`` (temperature 0) and ``gumbel_sample`` (temperature >
0, reached through ``ops.sample_tokens`` with the noise drawn outside
the kernel from the per-row keys).  CUDA source: ``csrc/sampling.cu``.

Bound on the H100: bytes — each logit (and each noise value) is read
once for a compare or two.  Kernel 3 (greedy): each row is cut into
contiguous column chunks, one 256-thread CTA each, so that a launch has
up to eight CTAs per SM even at a few rows (one CTA per row would stream
a 0.6 MB row through one SM); the vocab tail needs no padding (threads
stop at V).  Each CTA reduces with warp shuffles, and a second
one-warp-per-row kernel merges the chunks; every partial reduction
breaks ties toward the lower column, which is ``jnp.argmax``'s rule.

Kernel 4 (gumbel) is one launch a call: a thread-block cluster a row
(Hopper), each CTA taking a contiguous slice of the row (``gumbel_plan``
picks the cluster size from B, V, top-k and the SM count).  Without top-k each
CTA streams its slice of logits and noise once into its argmax.  Top-k
needs the row's kth largest logit, duplicates counted, before the
argmax: each CTA holds its logits slice in shared memory, read from
device memory once, and a radix select over the order-preserving uint32
image of the f32 logits finds kth in four 8-bit digits over shared
memory, each CTA adding its histogram into the cluster's first CTA
through distributed shared memory; from the third digit on each CTA
reads only its candidates (the columns at or above the first digit
chosen), and the argmax reads the noise of the kept columns alone.
The partial argmaxes meet in the first CTA too: no global scratch, no
second kernel.  The TPU kernel's k unrolled max-extractions per block
are not carried over.

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
# kernel 4's cluster sizes (16 is beyond the portable 8, which Hopper
# allows on request), the dynamic shared memory a CTA's logits slice may
# take (of the 227 KiB a block may hold; the kernel's own histograms,
# candidate list and partials take 21.3 KiB more), and the fewest columns a
# slice of a cluster of more than one CTA may have (fewer do not pay for
# the cluster barriers)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
GUMBEL_SMEM_BYTES = 200 * 1024
MIN_SLICE = 1024
# the top-k select's slice once the rows fill the card: qwen2's 18,992
# columns (clusters of 8) beat 37,984 and 9,496 at 64-264 rows; and the
# CTAs an SM a launch without top-k (one streaming pass) comes nearest:
# the fastest size at every row count of the three served vocabularies
# (chip_gumbel_sizes.py; PERF.md)
SELECT_SLICE = 20 * 1024
STREAM_CTAS_PER_SM = 2


def greedy_chunks(b: int, v: int, sms: int) -> int:
    """Column chunks per row on a card of ``sms`` SMs: enough for about
    CTAS_PER_SM CTAs per SM in all, at least MIN_COLS_PER_THREAD columns
    per thread of a chunk."""
    want = -(-CTAS_PER_SM * sms // b)
    cap = max(1, v // (THREADS * MIN_COLS_PER_THREAD))
    chunks = max(1, min(want, cap))
    return -(-v // -(-v // chunks))         # drop chunks left empty


def gumbel_slice(v: int, cluster: int) -> int:
    """Columns of a CTA's slice of a ``v``-column row over ``cluster``
    CTAs (csrc/sampling.cu gumbel_slice): CTA r holds [r * slice, (r + 1)
    * slice), a multiple of 4 for 16-byte copies; the last may be short
    (or empty)."""
    cols = -(-v // cluster)
    return -(-cols // 4) * 4


def gumbel_clusters(v: int, top_k: int):
    """The cluster sizes kernel 4 can launch over a ``v``-column row:
    with top-k (which stages the row) a CTA's logits slice (f32) within
    GUMBEL_SMEM_BYTES; and a slice of MIN_SLICE columns or more when the
    cluster has more than one CTA; ascending."""
    return [c for c in CLUSTER_SIZES
            if (not top_k or 4 * gumbel_slice(v, c) <= GUMBEL_SMEM_BYTES)
            and (c == 1 or gumbel_slice(v, c) >= MIN_SLICE)]


def gumbel_plan(b: int, v: int, sms: int, top_k: int) -> int:
    """Kernel 4's cluster size for ``b`` rows of ``v`` columns on a card
    of ``sms`` SMs, among those the row fits (``gumbel_clusters``), as
    the H100 measured them (PERF.md).  Without top-k the one whose launch
    comes nearest STREAM_CTAS_PER_SM CTAs an SM.  With top-k the smallest
    whose slice holds at most SELECT_SLICE columns, made larger while the
    launch has fewer CTAs than SMs.  Either way few rows take the
    largest: 8 rows of qwen2's vocab are 8 clusters of 16.  Raises when
    no cluster size holds the row."""
    fits = gumbel_clusters(v, top_k)
    if not fits:
        raise ValueError(f"gumbel_sample: a row of {v} columns does not fit "
                         f"the shared memory of {max(CLUSTER_SIZES)} CTAs")
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
    rc = lib.rt_gumbel_sample(
        logits.data_ptr(), gumbel.data_ptr(), out.data_ptr(), b, v, cluster,
        int(top_k), float(temperature),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "gumbel_sample")
    gumbel_sample.launches += 1
    return out


gumbel_sample.launches = 0
