"""Mamba-2 SSD intra-chunk block (arXiv:2405.21060).

Replaces the Pallas TPU kernel ``repro/kernels/ssd_chunk.py``
``ssd_chunk_bchp`` (reached through ``ops.ssd_chunk`` from
``models/ssm.py`` ``ssd_chunked_pallas``).  CUDA source:
``csrc/ssd_chunk.cu``.

Per (chunk, head), with ``dacum`` the within-chunk cumsum of dt * A:

    scores = C B^T                                  (l, l)
    y      = (scores * exp(da_i - da_j) [i >= j]) (x dt)   (l, p)
    states = (B * exp(da_last - da) dt)^T x         (n, p)

Bound on the H100: bytes at the model's shapes (l 256, p 64, n 128;
about 1.1 GFLOP against 15 MB for two chunks of 32 heads).  The (l, l)
score tile of the TPU kernel does not fit a block's shared memory at l
= 256, so each CTA takes a tile of query rows of one (chunk, head) and
walks the key tiles at or below them; other CTAs per (chunk, head) sum
the chunk states.  bfloat16 runs on the tensor cores (``ssd_chunk_tc``:
64-row query tiles, 16 rows a warp, ``mma.sync`` over B and x tiles
streamed through a 2-stage ``cp.async`` ring, dt folded into the masked
scores, which feed the second product as bf16 hi + lo; n padded to 64,
128 or 256 and p to 64 or 128 with zeros).  float32 stays on the CUDA
cores (``ssd_chunk_f32``: tensor cores would round to TF32), f32 FMA
over register tiles.  No padding of p or n to 128 lanes in device
memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import dtype_code, require_cuda

MAX_P = 128
MAX_N = 256
MAX_L = 4096


def ssd_chunk_bchp_plain(x, dt, dacum, B, C):
    """Plain PyTorch version (mirrors ``ref.ssd_chunk_bchp``): x (bc, l,
    h, p); dt, dacum (bc, l, h); B, C (bc, l, h, n) -> (y (bc, l, h, p)
    in x's dtype, states (bc, h, n, p) float32), all in float32."""
    x32, dt32, da = x.float(), dt.float(), dacum.float()
    l = x.shape[1]
    scores = torch.einsum("blhn,bshn->bhls", C.float(), B.float())
    decay = torch.exp(da[:, :, None, :] - da[:, None, :, :])  # (bc,l,s,h)
    decay = decay.permute(0, 3, 1, 2)                        # (bc,h,l,s)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    m = scores * torch.where(tri, decay, torch.zeros((), device=x.device))
    y = torch.einsum("bhls,bshp->blhp", m, x32 * dt32[..., None])
    dte = torch.exp(da[:, -1:, :] - da) * dt32               # (bc,l,h)
    st = torch.einsum("blhn,blhp->bhnp", B.float() * dte[..., None], x32)
    return y.to(x.dtype), st


def ssd_chunk_bchp(x: torch.Tensor, dt: torch.Tensor, dacum: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor):
    """x (bc, l, h, p) float32/bfloat16; dt, dacum (bc, l, h) float32; B,
    C (bc, l, h, n) in x's dtype (groups already repeated to heads).
    Returns (y (bc, l, h, p) in x's dtype, states (bc, h, n, p) float32).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return ssd_chunk_bchp_plain(x, dt, dacum, B, C)
    require_cuda("ssd_chunk_bchp", x, dt, dacum, B, C)
    bc, l, h, p = x.shape
    n = B.shape[-1]
    if (dt.shape != (bc, l, h) or dacum.shape != (bc, l, h)
            or B.shape != (bc, l, h, n) or C.shape != (bc, l, h, n)):
        raise ValueError("ssd_chunk_bchp: want x (bc,l,h,p), dt/dacum "
                         f"(bc,l,h), B/C (bc,l,h,n); got {tuple(x.shape)} "
                         f"{tuple(dt.shape)} {tuple(dacum.shape)} "
                         f"{tuple(B.shape)} {tuple(C.shape)}")
    if dt.dtype != torch.float32 or dacum.dtype != torch.float32 or \
            B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError("ssd_chunk_bchp: dt/dacum float32 and B/C in x's "
                         "dtype")
    if p > MAX_P or n > MAX_N or l > MAX_L:
        raise ValueError(f"ssd_chunk_bchp: built for p <= {MAX_P}, n <= "
                         f"{MAX_N}, l <= {MAX_L}; got p={p} n={n} l={l}")
    y = torch.empty_like(x)
    st = torch.empty((bc, h, n, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, st
    lib = _build.library()
    rc = lib.rt_ssd_chunk(
        x.data_ptr(), dt.data_ptr(), dacum.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), st.data_ptr(), bc, l, h, p, n,
        dtype_code(x.dtype), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd_chunk_bchp")
    ssd_chunk_bchp.launches += 1
    return y, st


ssd_chunk_bchp.launches = 0
