"""The split plan of kernels 1, 2 and 7 (``flash_decode.launch_splits``,
``decode_view.launch_splits``): tiles of query rows and key splits per
template, from static shapes alone, pinned at the layouts the serving
engine and the static path give them on a 132-SM card (an H100 SXM):
qwen2-1.5b's (hd 128), recurrentgemma-2b's (hd 256, where the wide
bf16 layout stages 32-key chunks) and h2o-danube-3-4b's (hd 120, staged
as 128).  No card and no JAX needed."""
import math
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _common, decode_view, flash_decode
from torch_threads import one_torch_thread  # noqa: F401

SMS = 132
# qwen2-1.5b's attention: 12 heads over 2 kv heads (G = 6); the engine's
# tables are 40 blocks of 16 (640 keys)
H, KV, KEYS = 12, 2, 640

# layouts the engine dispatches (decode buckets 8/4/2, prefill 2 x 128,
# mixed 136/264 rows): (b, c) -> (tiles, nsplit) per template
ENGINE = {
    torch.bfloat16: {(8, 1): (1, 10), (4, 1): (1, 10), (2, 1): (1, 10),
                     (2, 128): (12, 5), (136, 1): (1, 1),
                     (264, 1): (1, 1)},
    torch.float32: {(8, 1): (1, 5), (4, 1): (1, 5), (2, 1): (1, 5),
                    (2, 128): (96, 1), (136, 1): (1, 1), (264, 1): (1, 1)},
}
# kernel 7 at the static decode (B = 8 over caches of 570 / 627 slots)
STATIC = {torch.bfloat16: {570: (1, 9), 627: (1, 10)},
          torch.float32: {570: (1, 5), 627: (1, 5)}}


def _chunks_a_split(keys, nsplit, chunk):
    """Chunks the kernel gives each split of a row that sees ``keys``."""
    return math.ceil(math.ceil(keys / nsplit) / chunk)


@pytest.mark.parametrize("dtype", list(ENGINE))
@pytest.mark.parametrize("b,c", list(ENGINE[torch.bfloat16]))
def test_launch_splits_at_the_engine_layouts(b, c, dtype):
    tiles, nsplit = ENGINE[dtype][(b, c)]
    assert flash_decode.launch_splits(b, c, H, KV, KEYS, dtype=dtype,
                                      sms=SMS) == (tiles, nsplit)
    # split at the decode buckets (and bf16's prefill chunk) only
    assert (nsplit > 1) == (b <= 8 and (c == 1 or dtype == torch.bfloat16))
    if dtype == torch.bfloat16:
        # one tile of 16 rows at C = 1 (narrow), 64-row tiles when wide
        rows = c * H // KV
        assert tiles == (1 if rows <= flash_decode.NARROW_ROWS
                         else math.ceil(rows / flash_decode.WIDE_ROWS))
        if nsplit > 1:   # at a full table: 1-2 chunks a split, none empty
            ck = flash_decode.chunk_keys(128, rows <= flash_decode.NARROW_ROWS)
            per = _chunks_a_split(KEYS, nsplit, ck)
            assert ck == 64 and per * ck <= flash_decode.WIDE_SPLIT_KEYS
            assert (nsplit - 1) * per * ck < KEYS
    else:
        assert tiles == math.ceil(c * H // KV / _common.TILE_ROWS)


@pytest.mark.parametrize("dtype", list(STATIC))
@pytest.mark.parametrize("s", [570, 627])
def test_launch_splits_at_the_static_decode(s, dtype):
    tiles, nsplit = STATIC[dtype][s]
    assert flash_decode.launch_splits(8, 1, H, KV, s, dtype=dtype,
                                      sms=SMS) == (tiles, nsplit)
    if dtype == torch.bfloat16:   # one 64-key chunk a split
        assert _chunks_a_split(s, nsplit,
                               flash_decode.chunk_keys(128, True)) == 1


def test_launch_splits_windowed_and_unbuilt_shapes():
    """A window bounds the keys a tile can see (window + C), so it bounds
    the splits; rows that fill the card alone are not split."""
    assert flash_decode.launch_splits(3, 1, H, KV, 576, 300,
                                      dtype=torch.bfloat16,
                                      sms=SMS) == (1, 5)
    assert flash_decode.launch_splits(80, 1, H, KV, 256,
                                      dtype=torch.bfloat16,
                                      sms=SMS) == (1, 1)
    # C*G = 24 > 16: one wide tile (two of its warps hold no row)
    assert flash_decode.launch_splits(3, 3, 8, 1, 144,
                                      dtype=torch.bfloat16,
                                      sms=SMS)[0] == 1


# kernel 2 at the N-step loop's decode buckets: views of 40 blocks of 16
# plus the trash slot
VIEW_S1 = KEYS + 1
VIEW = {torch.bfloat16: (1, 10), torch.float32: (1, 5)}


@pytest.mark.parametrize("dtype", list(VIEW))
@pytest.mark.parametrize("b", [8, 4, 2])
def test_decode_view_launch_splits_at_the_decode_buckets(b, dtype):
    """Kernel 2 takes kernel 1's plan over the S visible slots of its
    S + 1 slot views: in bf16 the same (tiles, splits) as kernel 1 at 640
    keys, the condition of their bit-for-bit agreement; in f32 5 splits
    (6 when the trash slot counted)."""
    plan = decode_view.launch_splits(b, H, KV, VIEW_S1, dtype=dtype,
                                     sms=SMS)
    assert plan == VIEW[dtype]
    if dtype == torch.bfloat16:
        assert plan == flash_decode.launch_splits(b, 1, H, KV, KEYS,
                                                  dtype=dtype, sms=SMS)
    else:
        assert _common.launch_splits(b, 1, H, KV, VIEW_S1,
                                     sms=SMS) == plan[1] + 1


# recurrentgemma-2b: 10 heads over 1 kv head (G = 10), hd 256, a 2048
# window; the hybrid engine's layouts (decode buckets, the 2 x 128
# prefill, the 10 chunk-wide mixed rows) over tables of 40 blocks of 16
# (640 keys, the serving workload) and 160 (2,560 keys, past the window)
RG_H, RG_KV, RG_HD, RG_W = 10, 1, 256, 2048
RG_ENGINE = {
    640: {torch.bfloat16: {(8, 1): (1, 10), (4, 1): (1, 10),
                           (2, 1): (1, 10), (2, 128): (20, 5),
                           (10, 128): (20, 5)},
          torch.float32: {(8, 1): (2, 5), (4, 1): (2, 5), (2, 1): (2, 5),
                          (2, 128): (160, 1), (10, 128): (160, 1)}},
    2560: {torch.bfloat16: {(8, 1): (1, 17), (4, 1): (1, 33),
                            (2, 1): (1, 33), (2, 128): (20, 17),
                            (10, 128): (20, 17)},
           torch.float32: {(8, 1): (2, 17), (4, 1): (2, 17),
                           (2, 1): (2, 17), (2, 128): (160, 1),
                           (10, 128): (160, 1)}},
}


@pytest.mark.parametrize("keys", list(RG_ENGINE))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c", list(RG_ENGINE[640][torch.bfloat16]))
def test_launch_splits_at_head_dim_256(keys, dtype, b, c):
    tiles, nsplit = RG_ENGINE[keys][dtype][(b, c)]
    assert flash_decode.launch_splits(b, c, RG_H, RG_KV, keys, RG_W,
                                      dtype=dtype, sms=SMS,
                                      hd=RG_HD) == (tiles, nsplit)
    if dtype == torch.float32:       # the f32 plan has no head dim in it
        assert flash_decode.launch_splits(b, c, RG_H, RG_KV, keys, RG_W,
                                          dtype=dtype, sms=SMS) == (tiles,
                                                                    nsplit)
        return
    narrow = c * RG_H // RG_KV <= flash_decode.NARROW_ROWS
    ck = flash_decode.chunk_keys(RG_HD, narrow)
    assert ck == (64 if narrow else 32)
    seen = min(keys, RG_W + c)
    per = _chunks_a_split(seen, nsplit, ck)
    assert (nsplit - 1) * per * ck < seen          # no split is empty
    if not narrow:                   # at most WIDE_SPLIT_KEYS keys a split
        assert per * ck <= flash_decode.WIDE_SPLIT_KEYS
    else:                            # the narrow plan is hd 128's
        assert flash_decode.launch_splits(b, c, RG_H, RG_KV, keys, RG_W,
                                          dtype=dtype, sms=SMS,
                                          hd=128) == (tiles, nsplit)


@pytest.mark.parametrize("keys", list(RG_ENGINE))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [8, 4, 2])
def test_decode_view_launch_splits_at_head_dim_256(keys, dtype, b):
    """Kernel 2 at the decode buckets over views of keys + 1 slots takes
    kernel 1's plan at ``keys``, window and all."""
    assert decode_view.launch_splits(b, RG_H, RG_KV, keys + 1, RG_W,
                                     dtype=dtype, sms=SMS, hd=RG_HD) == \
        RG_ENGINE[keys][dtype][(b, 1)]


@pytest.mark.parametrize("dtype,plan", [(torch.bfloat16, (1, 32)),
                                        (torch.float32, (2, 16))])
def test_launch_splits_over_a_full_2048_ring(dtype, plan):
    """Kernel 7 at B = 8 over recurrentgemma's 2,048-slot ring (the
    window): one 64-key chunk a bf16 split."""
    assert flash_decode.launch_splits(8, 1, RG_H, RG_KV, RG_W, dtype=dtype,
                                      sms=SMS, hd=RG_HD) == plan
    if dtype == torch.bfloat16:
        assert _chunks_a_split(RG_W, plan[1],
                               flash_decode.chunk_keys(RG_HD, True)) == 1


# kernel 7 at recurrentgemma's static decode: B = 8 over caches of 570 /
# 627 slots (its two static batches, inside the window: no ring yet)
RG_STATIC = {torch.bfloat16: {570: (1, 9), 627: (1, 10)},
             torch.float32: {570: (2, 5), 627: (2, 5)}}


@pytest.mark.parametrize("dtype", list(RG_STATIC))
@pytest.mark.parametrize("s", [570, 627])
def test_launch_splits_at_the_static_decode_head_dim_256(s, dtype):
    assert flash_decode.launch_splits(8, 1, RG_H, RG_KV, s, dtype=dtype,
                                      sms=SMS, hd=RG_HD) == \
        RG_STATIC[dtype][s]


# h2o-danube-3-4b's attention: 32 heads over 8 kv heads (G = 4) at hd
# 120, window 4096; the engine's layouts over 640 keys, the static decode
# (B = 8 over 570 / 627 slots), and its long request's 288-block tables
# (4,608 keys, past the window) at one row: (b, c, keys) -> plan
H2O_H, H2O_KV, H2O_HD, H2O_W = 32, 8, 120, 4096
H2O = {
    torch.bfloat16: {(8, 1, 640): (1, 3), (4, 1, 640): (1, 5),
                     (2, 1, 640): (1, 10), (2, 128, 640): (8, 5),
                     (136, 1, 640): (1, 1), (264, 1, 640): (1, 1),
                     (8, 1, 570): (1, 3), (8, 1, 627): (1, 3),
                     (1, 1, 4608): (1, 22), (1, 128, 4608): (8, 33)},
    torch.float32: {(8, 1, 640): (1, 5), (4, 1, 640): (1, 5),
                    (2, 1, 640): (1, 5), (2, 128, 640): (64, 1),
                    (136, 1, 640): (1, 1), (264, 1, 640): (1, 1),
                    (8, 1, 570): (1, 5), (8, 1, 627): (1, 5),
                    (1, 1, 4608): (1, 33), (1, 128, 4608): (64, 1)},
}


@pytest.mark.parametrize("dtype", list(H2O))
@pytest.mark.parametrize("b,c,keys", list(H2O[torch.bfloat16]))
def test_launch_splits_at_head_dim_120(b, c, keys, dtype):
    """Kernels 1 and 7 at hd 120 stage hd 128's chunks (64 keys in both
    bf16 layouts), so the plan is hd 128's; kernel 2 at the decode
    buckets over keys + 1 view slots takes kernel 1's."""
    window = H2O_W
    plan = flash_decode.launch_splits(b, c, H2O_H, H2O_KV, keys, window,
                                      dtype=dtype, sms=SMS, hd=H2O_HD)
    assert plan == H2O[dtype][(b, c, keys)]
    assert plan == flash_decode.launch_splits(b, c, H2O_H, H2O_KV, keys,
                                              window, dtype=dtype, sms=SMS,
                                              hd=128)
    if c == 1 and b in (8, 4, 2) and keys == 640:
        assert decode_view.launch_splits(b, H2O_H, H2O_KV, keys + 1, window,
                                         dtype=dtype, sms=SMS,
                                         hd=H2O_HD) == plan
    if dtype == torch.bfloat16:
        narrow = c * H2O_H // H2O_KV <= flash_decode.NARROW_ROWS
        assert flash_decode.chunk_keys(H2O_HD, narrow) == 64
        seen = min(keys, H2O_W + c)
        per = _chunks_a_split(seen, plan[1], 64)
        assert (plan[1] - 1) * per * 64 < seen     # no split is empty
        if not narrow:
            assert per * 64 <= flash_decode.WIDE_SPLIT_KEYS


def test_wrappers_gate_head_dims():
    assert _common.HEAD_DIMS == (64, 120, 128, 256)
    for hd in _common.HEAD_DIMS:
        _common.require_head_dim("flash_decode", hd)
    for hd in (32, 96, 192, 512):
        with pytest.raises(ValueError, match="not built"):
            _common.require_head_dim("flash_decode", hd)


CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _keys_rule(path, pattern):
    """The (threshold, small, default) of a ``kKeys`` rule ``HD >
    threshold ? small : default`` in a CUDA source."""
    m = re.search(pattern, (CSRC / path).read_text())
    assert m, f"no kKeys rule in {path}"
    return tuple(int(x) for x in m.groups())


def test_chunk_keys_match_the_cuda_sources():
    """``chunk_keys`` (the split plan's staged chunk) copies kernel 1's
    ``Layout<HD, NARROW>::kKeys`` (wide only); kernel 6's
    ``Shape<HD>::kKeys`` stages its chunks by the wide rule too."""
    hd_max, small, default = _keys_rule(
        "flash_decode.cu",
        r"kKeys = !NARROW && HD > (\d+) \? (\d+) : (\d+);")
    kernel6 = _keys_rule("flash_attention.cu",
                         r"kKeys = HD > (\d+) \? (\d+) : (\d+);")
    assert kernel6 == (hd_max, small, default)
    for hd in _common.HEAD_DIMS:
        assert flash_decode.chunk_keys(hd, True) == default
        assert flash_decode.chunk_keys(hd, False) == (
            small if hd > hd_max else default)
    assert flash_decode.NARROW_ROWS == int(re.search(
        r"constexpr int kNarrowRows = (\d+);",
        (CSRC / "flash_decode.cu").read_text()).group(1))
