"""Paged decode / prefill-chunk attention (the serving hot loop).

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py``
``flash_decode_paged_bhd`` (reached through ``ops.flash_decode_paged``).
CUDA source: ``csrc/flash_decode.cu`` + ``csrc/attend.cuh``.

Bound on the H100: bytes.  Per call it must read each row's visible K/V
once (2 * tokens * KV * hd * itemsize) and does 4 * C * H * hd flops per
visible key: at decode (C=1, G=6) that is about 6 flops per byte, far
under the ~295 the card needs before compute binds.

Design against that bound: pools are read in place (no pad of the head
dim, no copy of the pool — the TPU wrapper padded the whole pool to 128
lanes on every call); each CTA owns one (row, kv head, 8-query tile),
reads each physical block id from the block table itself, stops at the
last key any of its queries can see, and keeps m/l/acc in registers, so
K/V of a row is read once per query tile and never written back.  When
(rows x kv heads x query tiles) would leave SMs idle — decode at small
batch — each tile's keys are split over up to 264 / CTAs CTAs and a
second kernel merges their partial softmax results (split-K).  K/V are
read as 16-byte vectors.  The dot products run on CUDA cores in f32:
tensor cores (``wgmma``) and TMA are a later step.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (dtype_code, launch_splits,
                                        require_aligned, require_cuda,
                                        sm_count, split_scratch)

NEG_INF = -1e30


def flash_decode_paged_plain(q, k_pool, v_pool, block_tables, pos, *,
                             window: int = 0):
    """Plain PyTorch version (mirrors ``repro/kernels/ref.py``
    ``flash_decode_paged``): gather each row's blocks into a contiguous
    view, exact masked softmax attention in f32."""
    b, c, h, hd = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    nb_seq = block_tables.shape[1]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, nb_seq * bs, kvh, hd).float()
    v = v_pool[bt].reshape(b, nb_seq * bs, kvh, hd).float()
    qg = q.reshape(b, c, kvh, g, hd).float()
    logits = torch.einsum("bckgh,bskh->bckgs", qg, k) * scale
    kpos = torch.arange(nb_seq * bs, device=q.device)[None, None]
    qpos = (pos.reshape(-1, 1).long()
            + torch.arange(c, device=q.device)[None])[..., None]
    valid = kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    logits = torch.where(valid[:, :, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bckgs,bskh->bckgh", p, v)
    return o.reshape(b, c, h, hd).to(q.dtype)


def flash_decode_paged(q, k_pool, v_pool, block_tables, pos, *,
                       window: int = 0):
    """q (B,C,H,hd) — C query tokens per row; k_pool, v_pool
    (nb, bs, KV, hd), already holding this call's new tokens;
    block_tables (B, NB) int32; pos (B,) int32 position of each row's
    first query -> (B,C,H,hd).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pool, v_pool, block_tables, pos,
                                        window=window)
    require_cuda("flash_decode_paged", q, k_pool, v_pool, block_tables, pos)
    require_aligned("flash_decode_paged", k_pool, v_pool)
    b, c, h, hd = q.shape
    nb, bs, kvh, hd_p = k_pool.shape
    if (v_pool.shape != k_pool.shape or hd_p != hd or h % kvh
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or pos.shape != (b,)):
        raise ValueError("flash_decode_paged: inconsistent shapes "
                         f"q{tuple(q.shape)} pool{tuple(k_pool.shape)} "
                         f"tables{tuple(block_tables.shape)} "
                         f"pos{tuple(pos.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"flash_decode_paged: head_dim {hd} not built "
                         "(64, 128)")
    if not (k_pool.dtype == v_pool.dtype == q.dtype):
        raise ValueError("flash_decode_paged: q and pools must share a dtype")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("flash_decode_paged: tables and pos must be int32")
    q = q.contiguous()
    out = torch.empty_like(q)
    nb_seq = block_tables.shape[1]
    nsplit = launch_splits(b, c, h, kvh, nb_seq * bs, window,
                           sms=sm_count(q.device))
    part_acc, part_ml = split_scratch(b * c * h, nsplit, hd, q.device)
    lib = _build.library()
    rc = lib.rt_flash_decode_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), b, c, h, kvh, hd, bs,
        nb_seq, int(window), 1.0 / math.sqrt(hd), nsplit,
        dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
