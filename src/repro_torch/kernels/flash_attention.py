"""Flash-attention forward over full sequences: the prefill of the
non-paged entry point (``Model.prefill`` under ``attn_impl="pallas"``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention_bhsd`` (reached through ``ops.flash_attention``).
CUDA source: ``csrc/flash_attention.cu``, two templates behind one entry.

Bound on the H100: at qwen2-1.5b's static prefill (8 x 448 tokens, 12
heads over 2 kv heads, hd 128, causal, bf16) 26 MB of q/k/v/o against
4.9 GFLOP: 0.0077 ms of bytes and 0.0050 ms of bf16 tensor-core work,
so bytes bind at the card's peaks.

bfloat16 runs on the tensor cores (``mma.sync`` m16n8k16, f32
accumulate): a CTA of 4 warps owns 64 query rows of one (row, kv head) —
all G query heads of ~64/G positions, 16 rows a warp — with its Q
fragments in registers; K and V stream in 64-key chunks through a
2-stage ``cp.async`` ring in swizzled shared memory read by
``ldmatrix``; the online softmax runs in registers, and P feeds P·V from
registers as two bf16 terms (hi + lo), which keeps P·V within one bf16
ulp of the f32 plain version. At hd 256 the Q fragments are read from
shared memory at each k-step and K/V stream in 32-key chunks (O alone
takes 128 registers a thread; two CTAs still share an SM). float32 keeps
a CUDA-core design (tensor cores would mean TF32): 8 warps of 8 rows, a
lane a key, where the 67 TFLOP/s f32 rate binds. Both read (B,S,H,hd)
and (B,S,KV,hd) in place and mask the ragged tails (the TPU wrapper
padded hd to 128 and S to the block and transposed); causal and window
tiles outside a query tile's range are never read. A query row that sees
no key (window > 0 and position >= Sk + window - 1) gets the reference's
answer, the mean of v over all Sk keys, computed in f32 inside the same
launch. Forward only, as the reference: it has no backward, and its
configs train through ``blocked``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (dtype_code, require_aligned,
                                        require_cuda, require_head_dim)

NEG_INF = -1e30


def flash_attention_bhsd_plain(q, k, v, *, causal: bool = True,
                               window: int = 0):
    """Plain PyTorch version (mirrors ``repro/kernels/ref.py``
    ``flash_attention_bhsd``): q (B,H,Sq,hd); k, v (B,KV,Sk,hd); exact
    softmax attention in f32.  Query and key positions both count from
    0; ``causal`` keeps kpos <= qpos, ``window`` kpos > qpos - window.
    A row that sees no key gets a uniform softmax over its -1e30 logits,
    the mean of v over all Sk keys, as ``ref.py`` gives it (the Pallas
    path of ``ops.flash_attention`` averages over Sk padded to a
    multiple of 128 instead).  Returns (B,H,Sq,hd) in q's dtype."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kvh, g, sq, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                  device=q.device))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(b, h, sq, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,Sq,H,hd); k, v (B,Sk,KV,hd) -> (B,Sq,H,hd), as
    ``ops.flash_attention``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (head dims 64, 128 and 256, float32 and
    bfloat16).  Forward only: raises when autograd would need a
    gradient through it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward (the reference's Pallas "
            "kernel has none either): train with attn_impl='blocked' or "
            "'naive', or call it under torch.no_grad()")
    if q.device.type == "cpu":
        o = flash_attention_bhsd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window)
        return o.transpose(1, 2)
    require_cuda("flash_attention", q, k, v)
    require_aligned("flash_attention", q, k, v)
    b, sq, h, hd = q.shape
    bk, sk, kvh, hd_k = k.shape
    if (v.shape != k.shape or bk != b or hd_k != hd or h % kvh):
        raise ValueError("flash_attention: inconsistent shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    require_head_dim("flash_attention", hd)
    if not (k.dtype == v.dtype == q.dtype):
        raise ValueError("flash_attention: q, k and v must share a dtype")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty_like(q)
    rc = _build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, kvh, hd, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
