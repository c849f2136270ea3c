"""Decode attention over the N-step loop's per-row contiguous K/V views.

Replaces the Pallas TPU kernel ``repro/kernels/decode_view.py``
``decode_view_attend_bhd`` (reached through ``ops.decode_view_attend``).
CUDA source: ``csrc/decode_view.cu`` + ``csrc/attend.cuh``.

Bound on the H100: bytes — one query per row, so the visible K/V slots
are read once for G (= H/KV) dot products each, a few flops per byte.

Design: the view is indexed in place at its true length S+1 (the TPU
wrapper padded the head dim to 128 and S to the block multiple on every
call); the ragged edge and the trash slot are masked in the kernel by
``kpos <= pos``; the scale comes from the true head dim.  One CTA per
(row, kv head) folds the G query heads of that kv head, stops at the
row's position, and keeps m/l/acc in registers; at small batch the
row's keys are split over several CTAs and merged by a second kernel
(split-K), so the launch fills the card.  f32 on CUDA cores.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (dtype_code, launch_splits,
                                        require_aligned, require_cuda,
                                        sm_count, split_scratch)

NEG_INF = -1e30


def decode_view_attend_plain(q, k_view, v_view, pos, *, window: int = 0):
    """Plain PyTorch version (``repro/models/attention.py``
    ``paged_decode_attention`` with one query per row, the probabilities
    kept in f32 as the Pallas kernel keeps them): q (B,H,hd); views
    (B,S,KV,hd); pos (B,) -> (B,H,hd)."""
    b, h, hd = q.shape
    s, kvh = k_view.shape[1], k_view.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kvh, g, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k_view.float()) * scale
    kpos = torch.arange(s, device=q.device)[None]
    p_ = pos.long()[:, None]
    valid = kpos <= p_
    if window:
        valid &= kpos > p_ - window
    logits = torch.where(valid[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_view.float())
    return o.reshape(b, h, hd).to(q.dtype)


def decode_view_attend(q, k_view, v_view, pos, *, window: int = 0):
    """q (B,H,hd); k_view, v_view (B,S+1,KV,hd), slot j = position j;
    pos (B,) int32 -> (B,H,hd).  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return decode_view_attend_plain(q, k_view, v_view, pos,
                                        window=window)
    require_cuda("decode_view_attend", q, k_view, v_view, pos)
    require_aligned("decode_view_attend", k_view, v_view)
    b, h, hd = q.shape
    bv, s1, kvh, hd_v = k_view.shape
    if (v_view.shape != k_view.shape or bv != b or hd_v != hd or h % kvh
            or pos.shape != (b,)):
        raise ValueError("decode_view_attend: inconsistent shapes "
                         f"q{tuple(q.shape)} view{tuple(k_view.shape)} "
                         f"pos{tuple(pos.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"decode_view_attend: head_dim {hd} not built "
                         "(64, 128)")
    if not (k_view.dtype == v_view.dtype == q.dtype):
        raise ValueError("decode_view_attend: q and views must share a dtype")
    if pos.dtype != torch.int32:
        raise ValueError("decode_view_attend: pos must be int32")
    out = torch.empty_like(q)
    nsplit = launch_splits(b, 1, h, kvh, s1, window, sms=sm_count(q.device))
    part_acc, part_ml = split_scratch(b * h, nsplit, hd, q.device)
    lib = _build.library()
    rc = lib.rt_decode_view_attend(
        q.data_ptr(), k_view.data_ptr(), v_view.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), b, h, kvh,
        hd, s1, int(window), 1.0 / math.sqrt(hd), nsplit,
        dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_view_attend")
    decode_view_attend.launches += 1
    return out


decode_view_attend.launches = 0
