"""Checks shared by the kernel wrappers."""
from __future__ import annotations

import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the f32 attention templates (attend.cuh's CUDA-core tile, the f32 MLA
# attend) split each tile's keys over CTAs until a launch has about two
# CTAs per SM of the card, keeping at least four 32-key chunks per split
ATTENTION_CTAS_PER_SM = 2
KEY_CHUNK = 32
TILE_ROWS = 8       # query rows (c, head) of one kv head per f32 CTA
# head dims the attention kernels 1, 2, 6 and 7 are built for
# (csrc/flash_decode.cu, csrc/flash_attention.cu)
HEAD_DIMS = (64, 120, 128, 256)


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' dtype argument (0 = float32, 1 = bfloat16)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel built for float32/bfloat16, not {dtype}")
    return _DTYPE_CODES[dtype]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM),
    read once per device: the kernels size their grids by it."""
    device = torch.device(device)
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return _sm_count(index)


def attention_splits(ctas: int, max_keys: int, sms: int) -> int:
    """Key splits for an attention launch of ``ctas`` CTAs whose tiles see
    at most ``max_keys`` keys (a static bound: the table or view length,
    so choosing it needs no device value) on a card of ``sms`` SMs."""
    want = -(-ATTENTION_CTAS_PER_SM * sms // max(ctas, 1))
    cap = -(-max_keys // (4 * KEY_CHUNK))
    return max(1, min(want, cap))


def launch_splits(b: int, c: int, h: int, kvh: int, keys: int,
                  window: int = 0, *, sms: int) -> int:
    """Key splits of an attention launch over ``b`` rows of ``c`` queries
    of ``h`` heads (``kvh`` kv heads), ``keys`` addressable key positions
    per row (table or view length), on a card of ``sms`` SMs; 1 takes the
    kernel's direct epilogue, more the split-K merge."""
    tiles = -(-(c * (h // kvh)) // TILE_ROWS)
    return attention_splits(b * kvh * tiles, min(keys, (window or keys) + c),
                            sms)


def split_scratch(rows: int, nsplit: int, hd: int, device):
    """f32 scratch for the partial results of a split launch (row, split,
    hd) and (row, split, m/l); zero-size when nothing is split."""
    n = rows * nsplit if nsplit > 1 else 0
    return (torch.empty((n, hd), dtype=torch.float32, device=device),
            torch.empty((n, 2), dtype=torch.float32, device=device))


def require_head_dim(name: str, hd: int) -> None:
    """An attention kernel's head dim is one it is built for."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not built {HEAD_DIMS}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel runs on CUDA tensors of one device, each contiguous (the
    kernels index raw memory); anything else raises — there is no
    fallback to the plain version."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: the kernel takes CUDA tensors on one "
                             f"device (got {t.device}; CPU tensors take "
                             "the plain version)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The attention kernels read K/V (and the decode attends Q) as
    16-byte vectors."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors read as 16-byte vectors "
                             "must be 16-byte aligned")
