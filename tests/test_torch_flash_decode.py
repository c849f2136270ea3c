"""The split plan of kernels 1, 2 and 7 (``flash_decode.launch_splits``,
``decode_view.launch_splits``): tiles of query rows and key splits per
template, from static shapes alone, pinned at the layouts the serving
engine and the static path give them on a 132-SM card (an H100 SXM).
No card and no JAX needed."""
import math

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
            per = _chunks_a_split(KEYS, nsplit, flash_decode.TC_KEYS)
            assert per <= flash_decode.WIDE_SPLIT_CHUNKS
            assert (nsplit - 1) * per * flash_decode.TC_KEYS < KEYS
    else:
        assert tiles == math.ceil(c * H // KV / _common.TILE_ROWS)


@pytest.mark.parametrize("dtype", list(STATIC))
@pytest.mark.parametrize("s", [570, 627])
def test_launch_splits_at_the_static_decode(s, dtype):
    tiles, nsplit = STATIC[dtype][s]
    assert flash_decode.launch_splits(8, 1, H, KV, s, dtype=dtype,
                                      sms=SMS) == (tiles, nsplit)
    if dtype == torch.bfloat16:   # one 64-key chunk a split
        assert _chunks_a_split(s, nsplit, flash_decode.TC_KEYS) == 1


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
