"""Absorbed-query MLA attention over the compressed latent cache: the
N-step loop's per-row latent views and the fused step's latent block
pools.

Replaces the Pallas TPU kernels ``repro/kernels/mla_decode.py``
``mla_views_attend`` and ``mla_paged_attend`` (reached through
``ops.mla_decode_views`` / ``ops.mla_decode_paged``).  CUDA source:
``csrc/mla_decode.cu``.

Every head attends the same latent stream: the score of a key is
``(q_lat . ckv + q_rope . kr) * scale`` (key width r + rd = 576) and the
value is the latent itself (width r = 512); the output stays in latent
space and is expanded through W^{UV} outside.

Bound on the H100: at decode, bytes (each row's visible latents read
once, 1,152 bytes a key, for 128 heads x 2 x 1,088 flops — about 240
flops a byte, under the ~295 where bf16 tensor cores would bind); at
prefill chunks and wide mixed steps, operations (B=2, C=128: 22.8
GFLOP, which f32 CUDA cores could not do in less than 0.34 ms).

Design: the (C*H, r) f32 accumulator of a row (256 KB at H = 128,
r = 512) fits no CTA, so a CTA owns a tile of query rows (c, head) of
one batch row; the heads fold into the tile's rows, and each staged
chunk of 32 latent keys serves every row of the tile as both key
(576 columns) and value (the first 512).  bfloat16 runs on the tensor
cores: 64 rows a CTA, 8 warps of 16 rows x 256 output columns, Q
staged once in shared memory and read by ``ldmatrix``, the latents
through a 3-stage ``cp.async`` ring in bf16, S = Q·Kᵀ by ``mma.sync``
split over the two warps of a row group by columns, P·V with P as bf16
hi + lo (one bf16 P would break the one-ulp tolerance on rows that see
few keys); one CTA an SM.  At the wide layouts it reaches about an
eighth of the bf16 MMA rate; suspects (not measured): ``ldmatrix``
traffic, since every warp loads its own MMA fragments, and two warps
per scheduler to hide it.  float32 keeps the CUDA-core template (16
rows a CTA, latents staged as f32; tensor cores would be TF32).  Nothing
is padded: r and rd are native, the ragged view edge (S + 1 slots), the
table tail and a ragged last tile are masked.  At small batch the keys
of a tile are split over CTAs and merged by ``combine_splits`` (split-K;
``launch_splits``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (attention_splits, dtype_code,
                                        require_aligned, require_cuda,
                                        sm_count, split_scratch)

NEG_INF = -1e30
# the kernel's build: latent rank and rope width (deepseek-v3's), and
# the query rows (c, head) of one batch row a CTA owns in each template
# (both stage ``_common.KEY_CHUNK`` latent keys at a time)
KERNEL_R = 512
KERNEL_RD = 64
TILE_ROWS = {torch.bfloat16: 64, torch.float32: 16}


def launch_splits(b: int, c: int, h: int, keys: int, dtype, sms: int):
    """(tiles, nsplit) of a launch over ``b`` rows of ``c`` queries of
    ``h`` heads, ``keys`` addressable latent positions a row (view or
    table length), for the template ``dtype`` selects, on a card of
    ``sms`` SMs: ``tiles`` CTAs of query rows per batch row, each split
    over ``nsplit`` key ranges (1 takes the direct epilogue)."""
    tiles = -(-(c * h) // TILE_ROWS[dtype])
    return tiles, attention_splits(b * tiles, keys, sms)


def mla_decode_views_plain(q_lat, q_rope, ckv, kr, pos, *, scale: float):
    """Plain PyTorch version (``repro/kernels/ref.py``
    ``mla_decode_views``): q_lat (B,C,H,r), q_rope (B,C,H,rd); ckv
    (B,S,r), kr (B,S,rd) with slot j = position j; pos (B,) the position
    of each row's first query.  Key j is visible to query c of row b
    when j <= pos[b] + c; softmax in f32.  Returns (B,C,H,r) in q_lat's
    dtype."""
    c, s = q_lat.shape[1], ckv.shape[1]
    ckv32, kr32 = ckv.float(), kr.float()
    logits = (torch.einsum("bchr,bsr->bchs", q_lat.float(), ckv32)
              + torch.einsum("bchd,bsd->bchs", q_rope.float(), kr32)) * scale
    kpos = torch.arange(s, device=q_lat.device)[None, None]
    qpos = (pos.reshape(-1, 1).long()
            + torch.arange(c, device=q_lat.device)[None])[..., None]
    logits = torch.where((kpos <= qpos)[:, :, None], logits,
                         torch.full((), NEG_INF, device=q_lat.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bchs,bsr->bchr", p, ckv32).to(q_lat.dtype)


def mla_decode_paged_plain(q_lat, q_rope, ckv_pool, kr_pool, block_tables,
                           pos, *, scale: float):
    """Plain PyTorch version (``repro/kernels/ref.py``
    ``mla_decode_paged``): gather each row's latent blocks (nb, bs, ·)
    through its table (B, NB) into a contiguous view, then
    ``mla_decode_views_plain``."""
    b = q_lat.shape[0]
    bt = block_tables.long()
    s = bt.shape[1] * ckv_pool.shape[1]
    ckv = ckv_pool[bt].reshape(b, s, ckv_pool.shape[-1])
    kr = kr_pool[bt].reshape(b, s, kr_pool.shape[-1])
    return mla_decode_views_plain(q_lat, q_rope, ckv, kr, pos, scale=scale)


def _check(name, q_lat, q_rope, ckv, kr, pos):
    b, c, h, r = q_lat.shape
    rd = q_rope.shape[-1]
    if (q_rope.shape[:3] != (b, c, h) or ckv.shape[-1] != r
            or kr.shape[-1] != rd or ckv.shape[:-1] != kr.shape[:-1]
            or pos.shape != (b,)):
        raise ValueError(f"{name}: inconsistent shapes q_lat"
                         f"{tuple(q_lat.shape)} q_rope{tuple(q_rope.shape)} "
                         f"ckv{tuple(ckv.shape)} kr{tuple(kr.shape)} "
                         f"pos{tuple(pos.shape)}")
    if (r, rd) != (KERNEL_R, KERNEL_RD):
        raise ValueError(f"{name}: latent widths r={r}, rd={rd} not built "
                         f"(r={KERNEL_R}, rd={KERNEL_RD})")
    if not (q_lat.dtype == q_rope.dtype == ckv.dtype == kr.dtype):
        raise ValueError(f"{name}: queries and latents must share a dtype")
    if pos.dtype != torch.int32:
        raise ValueError(f"{name}: pos must be int32")


def _launch(fn, name, q_lat, q_rope, ckv, kr, pos, keys, extra, scale):
    """Shared launch: splits, scratch, the C call, the error check."""
    b, c, h, r = q_lat.shape
    code = dtype_code(q_lat.dtype)
    out = torch.empty_like(q_lat)
    _, nsplit = launch_splits(b, c, h, keys, q_lat.dtype,
                              sm_count(q_lat.device))
    part_acc, part_ml = split_scratch(b * c * h, nsplit, r, q_lat.device)
    rc = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
            kr.data_ptr(), *extra, pos.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), b, c, h,
            float(scale), nsplit, code,
            torch.cuda.current_stream(q_lat.device).cuda_stream)
    _build.check(rc, name)
    return out


def mla_decode_views(q_lat, q_rope, ckv, kr, pos, *, scale: float):
    """q_lat (B,C,H,r), q_rope (B,C,H,rd); ckv (B,S+1,r), kr (B,S+1,rd)
    per-row latent views (slot S the trash slot); pos (B,) int32 ->
    (B,C,H,r).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if q_lat.device.type == "cpu":
        return mla_decode_views_plain(q_lat, q_rope, ckv, kr, pos,
                                      scale=scale)
    name = "mla_decode_views"
    require_cuda(name, q_lat, q_rope, ckv, kr, pos)
    require_aligned(name, q_lat, q_rope, ckv, kr)
    _check(name, q_lat, q_rope, ckv, kr, pos)
    if ckv.shape[0] != q_lat.shape[0]:
        raise ValueError(f"{name}: one view per row")
    s1 = ckv.shape[1]
    out = _launch(_build.library().rt_mla_decode_views, name, q_lat, q_rope,
                  ckv, kr, pos, s1, (s1,), scale)
    mla_decode_views.launches += 1
    return out


def mla_decode_paged(q_lat, q_rope, ckv_pool, kr_pool, block_tables, pos,
                     *, scale: float):
    """q_lat (B,C,H,r), q_rope (B,C,H,rd); latent pools (nb,bs,r) /
    (nb,bs,rd), already holding this call's new tokens; block_tables
    (B,NB) int32 (trash block 0 behind unassigned entries); pos (B,)
    int32 -> (B,C,H,r).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if q_lat.device.type == "cpu":
        return mla_decode_paged_plain(q_lat, q_rope, ckv_pool, kr_pool,
                                      block_tables, pos, scale=scale)
    name = "mla_decode_paged"
    require_cuda(name, q_lat, q_rope, ckv_pool, kr_pool, block_tables, pos)
    require_aligned(name, q_lat, q_rope, ckv_pool, kr_pool)
    _check(name, q_lat, q_rope, ckv_pool, kr_pool, pos)
    if (block_tables.dim() != 2 or block_tables.shape[0] != q_lat.shape[0]
            or block_tables.dtype != torch.int32):
        raise ValueError(f"{name}: block_tables must be (B, NB) int32")
    nb_seq, bs = block_tables.shape[1], ckv_pool.shape[1]
    out = _launch(_build.library().rt_mla_decode_paged, name, q_lat, q_rope,
                  ckv_pool, kr_pool, pos, nb_seq * bs,
                  (block_tables.data_ptr(), nb_seq, bs), scale)
    mla_decode_paged.launches += 1
    return out


mla_decode_views.launches = 0
mla_decode_paged.launches = 0
