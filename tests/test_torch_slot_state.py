"""Kernel 10's launch (``slot_state.gather_plan``, ``mask_code``) pinned
at the mamba path's rows on a 132-SM card (an H100 SXM), the plain slot
gather over every fresh-mask type the kernel reads, kernel 11's
``len_code``, and the port's ``layers.slot_state_scatter`` (stale rows
routed to trash slot 0 by the scatter itself) bit for bit against the
JAX package's on the CPU.  No card needed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import slot_state
from repro_torch.models import layers as tlayers
from torch_threads import one_torch_thread  # noqa: F401

SMS = 132
# mamba2-370m's two state leaves, in 16-byte units a row: the conv window
# (3 x 2304 bf16 = 13,824 bytes) and the SSD state (32 x 64 x 128 f32 =
# 1 MiB), one layer (the fused step) and all 48 (the decode loop)
CONV, STATE = 3 * 2304 * 2 // 16, 32 * 64 * 128 * 4 // 16
# (units, layers, b) -> (units a thread, CTAs along a row)
PLANS = {
    (CONV, 1, 2): (1, 7), (CONV, 1, 4): (1, 7), (CONV, 1, 8): (1, 7),
    (CONV, 1, 10): (1, 7),
    (CONV, 48, 2): (4, 2), (CONV, 48, 4): (8, 1), (CONV, 48, 8): (8, 1),
    (CONV, 48, 10): (8, 1),
    (STATE, 1, 2): (4, 128), (STATE, 1, 4): (8, 64), (STATE, 1, 8): (8, 64),
    (STATE, 1, 10): (8, 64),
    (STATE, 48, 2): (8, 64), (STATE, 48, 4): (8, 64),
    (STATE, 48, 8): (8, 64), (STATE, 48, 10): (8, 64),
}


@pytest.mark.parametrize("units,layers,b", list(PLANS))
def test_gather_plan_at_the_mamba_rows(units, layers, b):
    per, chunks = PLANS[(units, layers, b)]
    assert slot_state.gather_plan(units, b, layers, SMS) == per
    # the kernel's row chunks (csrc/slot_state.cu copy_grid) cover the
    # row, none empty
    span = slot_state.GATHER_THREADS * per
    assert -(-units // span) == chunks
    assert (chunks - 1) * span < units <= chunks * span
    ctas = chunks * b * layers
    if per == 1:
        # a conv-window row at one layer: a CTA per 128 units (B=2: 14
        # CTAs, where 256-thread CTAs of 4 units a thread made 2)
        assert units == CONV and layers == 1 and ctas == 7 * b
    else:
        # as many units a thread as keep a CTA for every SM; the state
        # layer keeps at least the 512 CTAs of the old plan at B=8
        assert ctas >= SMS
        if per < max(slot_state.GATHER_PER_THREAD):
            assert -(-units // (span * 2)) * b * layers < SMS
    if (units, layers, b) == (STATE, 1, 8):
        assert ctas >= 512


@pytest.mark.parametrize("dtype,code", [(torch.bool, 1), (torch.uint8, 1),
                                        (torch.int32, 4), (None, 0)])
def test_mask_code(dtype, code):
    """The mask reaches the kernel in its own dtype (its element size),
    so a bool mask, as the models pass it, is one launch with no cast."""
    fresh = None if dtype is None else torch.tensor([0, 1, 0], dtype=dtype)
    assert slot_state.mask_code(fresh) == code


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
def test_mask_code_rejects_what_the_kernel_does_not_read(dtype):
    with pytest.raises(ValueError, match="fresh"):
        slot_state.mask_code(torch.zeros(3, dtype=dtype))


@pytest.mark.parametrize("stacked", [False, True])
def test_plain_gather_reads_every_mask_dtype_alike(stacked):
    rng = np.random.default_rng(0)
    lead = (3, 7) if stacked else (7,)
    pool = torch.from_numpy(rng.standard_normal(lead + (4, 5))
                            .astype(np.float32)).to(torch.bfloat16)
    slots = torch.tensor([3, 1, 6, 2], dtype=torch.int32)
    flags = np.array([False, True, False, True])
    want = slot_state.slot_gather_plain(pool, slots, None, stacked=stacked)
    axis = 1 if stacked else 0
    want = want.clone()
    want.narrow(axis, 1, 1).zero_()
    want.narrow(axis, 3, 1).zero_()
    for dtype in (torch.bool, torch.uint8, torch.int32):
        fresh = torch.from_numpy(flags).to(dtype)
        got = slot_state.slot_gather_plain(pool, slots, fresh,
                                           stacked=stacked)
        assert got.dtype == pool.dtype
        assert torch.equal(got, want)
        # the wrapper routes a CPU pool to the plain version
        assert torch.equal(slot_state.slot_gather(pool, slots, fresh,
                                                  stacked=stacked), want)


@pytest.mark.parametrize("dtype,code", [(torch.int32, 4), (torch.int64, 8),
                                        (None, 0)])
def test_len_code(dtype, code):
    """valid_len reaches the scatter in its own dtype (its element size):
    the engine's int32 meta row, or a long, with no cast kernel."""
    vl = None if dtype is None else torch.tensor([3, 0, 1], dtype=dtype)
    assert slot_state.len_code(vl) == code


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int16,
                                   torch.float32])
def test_len_code_rejects_what_the_kernel_does_not_read(dtype):
    with pytest.raises(ValueError, match="valid_len"):
        slot_state.len_code(torch.zeros(3, dtype=dtype))


@pytest.mark.parametrize("vl_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("stale", [(1,), (0, 3, 4)])
def test_slot_state_scatter_routes_stale_rows_as_the_reference(vl_dtype,
                                                               stale):
    """The port's route (``valid_len`` passed through to the scatter)
    against ``repro.models.layers.slot_state_scatter``: rows with
    valid_len 0 write trash slot 0 and leave their live slots alone.
    Bit for bit on every slot, slot 0 too where one row writes it."""
    rng = np.random.default_rng(len(stale))
    s, b, feat = 9, 5, (3, 4)
    pool = rng.standard_normal((s,) + feat).astype(np.float32)
    slots = rng.permutation(np.arange(1, s))[:b].astype(np.int32)
    vl = rng.integers(1, 4, b).astype(np.int32)
    vl[list(stale)] = 0
    value = rng.standard_normal((b,) + feat).astype(np.float32)
    want = np.asarray(jlayers.slot_state_scatter(
        jnp.asarray(pool), jnp.asarray(slots), jnp.asarray(vl),
        jnp.asarray(value)))
    tp = torch.from_numpy(pool.copy())
    out = tlayers.slot_state_scatter(tp, torch.from_numpy(slots),
                                     torch.from_numpy(vl).to(vl_dtype),
                                     torch.from_numpy(value))
    assert out is tp                                     # in place
    got = tp.numpy()
    first = 0 if len(stale) == 1 else 1
    np.testing.assert_array_equal(got[first:], want[first:])
    for r in stale:                       # a stale row's slot is untouched
        np.testing.assert_array_equal(got[slots[r]], pool[slots[r]])
    # the plain scatter, stacked, routes alike on every layer
    lp = torch.from_numpy(np.stack([pool, pool + 1]))
    slot_state.slot_scatter_plain(
        lp, torch.from_numpy(slots), torch.from_numpy(np.stack([value] * 2)),
        valid_len=torch.from_numpy(vl).to(vl_dtype), stacked=True)
    np.testing.assert_array_equal(lp[0].numpy()[first:], want[first:])
