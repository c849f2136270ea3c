"""Decode attention over K/V caches: paged decode / prefill-chunk
attention (the serving hot loop, ``flash_decode_paged``) and one-token
decode over a contiguous cache (the non-paged ``Model.decode_step``,
``flash_decode``).

Replace the Pallas TPU kernels ``repro/kernels/flash_decode.py``
``flash_decode_paged_bhd`` and ``flash_decode_bhd`` (reached through
``ops.flash_decode_paged`` / ``ops.flash_decode``).  CUDA source:
``csrc/flash_decode.cu`` + ``csrc/attend.cuh``.

Bound on the H100: bytes at decode and in mixed steps (each row's
visible K/V read once, 2 * tokens * KV * hd * itemsize, for 4 * C * H *
hd flops a visible key: about 6 flops a byte at C = 1, G = 6, far under
the ~295 where bf16 tensor cores would bind).  At the prefill chunk
(C = 128) a byte of K/V feeds about 770 flops, and moving Q and O once
takes about as long as the products at the bf16 MMA rate.

Design.  Pools and caches are read in place (no pad of the head dim, no
copy of the pool: the TPU wrapper padded the whole pool to 128 lanes on
every call); a CTA reads each physical block id from the block table
itself, stops at the last key any of its queries sees and starts at the
first one a window leaves, and the C*G query rows of one (row, kv head)
are packed as row c*G + g, so one staged K/V chunk serves all G heads.

bfloat16 runs on the tensor cores (``mma.sync`` m16n8k16, f32
accumulate), the query rows as the MMA's rows, K/V in 64-key bf16 chunks
through a 2-stage ``cp.async`` ring in swizzled shared memory, Q in
registers (``ldmatrix``), P·V with P as bf16 hi + lo (one-ulp
tolerance), softmax in f32.  At head dim 256 O alone fills 128 f32
registers a thread: Q's fragments are read from shared memory at each
k-step instead, and the wide layout stages 32-key chunks so that two
CTAs still share an SM (``chunk_keys``).  Two layouts, chosen from C*G
alone:

- wide (C*G > 16, the prefill chunk): 64 rows a CTA, 16 a warp, every
  warp over the whole chunk.  What bounded the CUDA-core kernel there
  was re-reading: 8-row tiles read each (row, kv head)'s K/V 96 times at
  C = 128, G = 6, and converted it to f32 in shared memory each time;
  64-row tiles read it 12 times and hand bf16 to the MMA as it lands.
  A split keeps at most two chunks: a CTA's chunks run in order, and
  at the prefill chunk 5 splits measured faster than 4 or 10.
- narrow (C*G <= 16: decode buckets, mixed steps, the contiguous
  decode): one 16-row tile holding the G real rows; each of the 4 warps
  scores its own 16 keys of every chunk with its own (m, l, O), merged
  in warp order through shared memory at the end.  What bounds it is
  latency: a handful of dependent device-memory trips (pos, block
  table, K/V) and a second launch when split.  The Q copy is issued
  before the position is read, a decode split keeps one chunk
  (``launch_splits``) so a step's keys are in flight on all SMs at
  once, and the next chunk's copy overlaps this one's products.

float32 keeps the CUDA-core template (8 query rows a CTA, K/V staged as
f32, one key a lane; tensor cores would be TF32 and change the numbers
against the f32 plain version).  When (rows x kv heads x tiles) would
leave SMs idle, each tile's keys are split over CTAs and
``combine_splits`` merges their partial softmax results in split order
(split-K; ``launch_splits`` per template, from static shapes only).

The contiguous kernel is the same arithmetic over a (B, S, KV, hd) cache
addressed in place (the TPU wrapper padded hd to 128 and S to 512 on
every call); its ``length`` (the number of valid slots, shared by all
rows) is an int32 scalar the kernel reads from device memory, so a
decode step never waits on the host for the position.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, _common
from repro_torch.kernels._common import (dtype_code, require_aligned,
                                        require_cuda, require_head_dim,
                                        sm_count, split_scratch)

NEG_INF = -1e30
# the bf16 template: query rows (c, head) of one kv head a CTA in each
# layout (narrow when they all fit one 16-row MMA tile)
NARROW_ROWS = 16
WIDE_ROWS = 64
# keys a split of the wide bf16 layout keeps at most: each chunk is 64
# rows' products, and a split's chunks run in order in one CTA
WIDE_SPLIT_KEYS = 128


def chunk_keys(hd: int, narrow: bool) -> int:
    """Keys a staged chunk of the bf16 template (its ``Layout::kKeys``):
    64, or 32 in the wide layout at hd 256, where 64-key stages would
    leave one CTA an SM (the narrow layout keeps 64: 16 keys a warp)."""
    return 32 if hd > 128 and not narrow else 64



def launch_splits(b: int, c: int, h: int, kvh: int, keys: int,
                  window: int = 0, *, dtype, sms: int, hd: int = 128):
    """(tiles, nsplit) of a launch over ``b`` rows of ``c`` queries of
    ``h`` heads (``kvh`` kv heads), ``keys`` addressable key positions
    a row (table or cache length), for the template ``dtype`` selects,
    on a card of ``sms`` SMs: ``tiles`` CTAs of query rows per (row, kv
    head), each split over ``nsplit`` key ranges (1 takes the direct
    epilogue).  Static shapes only, so choosing needs no device value.

    bfloat16: the splits that cut the ``chunk_keys``-key chunks a tile
    can see (at most ``keys``, or the window plus the chunk) into equal
    runs, about one CTA an SM (one chunk a split at the decode buckets,
    none where the rows alone fill the card), at most
    ``WIDE_SPLIT_KEYS`` keys a split in the wide layout.  float32:
    ``_common.launch_splits`` (no head dim in its plan)."""
    rows = c * (h // kvh)
    if dtype == torch.float32:
        tiles = -(-rows // _common.TILE_ROWS)
        return tiles, _common.launch_splits(b, c, h, kvh, keys, window,
                                            sms=sms)
    narrow = rows <= NARROW_ROWS
    tiles = 1 if narrow else -(-rows // WIDE_ROWS)
    ck = chunk_keys(hd, narrow)
    chunks = -(-min(keys, (window or keys) + c) // ck)
    per = max(1, chunks * b * kvh * tiles // sms)   # chunks a split
    if not narrow:
        per = min(per, WIDE_SPLIT_KEYS // ck)
    return tiles, -(-chunks // per)


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
    require_aligned("flash_decode_paged", q, k_pool, v_pool)
    b, c, h, hd = q.shape
    nb, bs, kvh, hd_p = k_pool.shape
    if (v_pool.shape != k_pool.shape or hd_p != hd or h % kvh
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or pos.shape != (b,)):
        raise ValueError("flash_decode_paged: inconsistent shapes "
                         f"q{tuple(q.shape)} pool{tuple(k_pool.shape)} "
                         f"tables{tuple(block_tables.shape)} "
                         f"pos{tuple(pos.shape)}")
    require_head_dim("flash_decode_paged", hd)
    if not (k_pool.dtype == v_pool.dtype == q.dtype):
        raise ValueError("flash_decode_paged: q and pools must share a dtype")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("flash_decode_paged: tables and pos must be int32")
    q = q.contiguous()
    out = torch.empty_like(q)
    nb_seq = block_tables.shape[1]
    _, nsplit = launch_splits(b, c, h, kvh, nb_seq * bs, window,
                              dtype=q.dtype, sms=sm_count(q.device), hd=hd)
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


def flash_decode_bhd_plain(q, k, v, length):
    """Plain PyTorch version (mirrors ``repro/kernels/ref.py``
    ``flash_decode``, with the cache in the kernel's (B,S,KV,hd) layout):
    q (B,H,hd); k, v (B,S,KV,hd); slot j valid when j < length (an int
    or a 0-d tensor); softmax in f32.  Returns (B,H,hd) in q's dtype."""
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kvh, g, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * scale
    valid = torch.arange(s, device=q.device) < torch.as_tensor(
        length, device=q.device)
    logits = torch.where(valid, logits, torch.full((), NEG_INF,
                                                   device=q.device))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return o.reshape(b, h, hd).to(q.dtype)


def flash_decode(q, k, v, length):
    """q (B,H,hd); k, v (B,S,KV,hd) contiguous caches; ``length`` the
    number of valid slots, shared by every row: a 0-d int32 tensor on
    q's device (at least 1; past S every slot is valid, as in a full
    ring cache) -> (B,H,hd).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_decode_bhd_plain(q, k, v, length)
    require_cuda("flash_decode", q, k, v, length)
    require_aligned("flash_decode", q, k, v)
    b, h, hd = q.shape
    bk, s, kvh, hd_k = k.shape
    if (v.shape != k.shape or bk != b or hd_k != hd or h % kvh
            or length.shape != ()):
        raise ValueError("flash_decode: inconsistent shapes "
                         f"q{tuple(q.shape)} cache{tuple(k.shape)} "
                         f"length{tuple(length.shape)}")
    require_head_dim("flash_decode", hd)
    if not (k.dtype == v.dtype == q.dtype):
        raise ValueError("flash_decode: q and caches must share a dtype")
    if length.dtype != torch.int32:
        raise ValueError("flash_decode: length must be int32")
    out = torch.empty_like(q)
    _, nsplit = launch_splits(b, 1, h, kvh, s, dtype=q.dtype,
                              sms=sm_count(q.device), hd=hd)
    part_acc, part_ml = split_scratch(b * h, nsplit, hd, q.device)
    rc = _build.library().rt_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), b, h, kvh,
        hd, s, 1.0 / math.sqrt(hd), nsplit, dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
