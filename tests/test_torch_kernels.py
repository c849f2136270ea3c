"""The port's kernel modules on the CPU: each plain version against the
JAX package's Pallas kernel (interpret mode, through ``ops``) and its
jnp oracle, on the same numpy inputs; the wrappers' device routing.

Tolerances: float32 inputs, atol 3e-5 / rtol 2e-5 for attention (two f32
softmax implementations, sums in different orders); greedy sampling must
be exactly equal.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import attention as jattn
from repro_torch.kernels import (decode_view, flash_attention, flash_decode,
                                 sampling)
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=3e-5, rtol=2e-5)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# kernel 1: paged decode / prefill-chunk attention
# ---------------------------------------------------------------------------

PAGED_CASES = [
    # nb, bs, kv, g, hd, b, c, nb_seq, window
    (16, 8, 2, 2, 64, 3, 1, 4, 0),       # decode, GQA group 2
    (9, 16, 1, 1, 128, 2, 1, 4, 0),      # MHA-like group 1, hd 128
    (32, 8, 2, 6, 128, 2, 1, 6, 20),     # qwen2's group 6 + window
    (16, 8, 2, 2, 64, 3, 5, 4, 0),       # odd chunk of queries (prefill)
    (32, 8, 1, 6, 64, 2, 8, 6, 11),      # chunk + window
    (24, 8, 1, 10, 256, 2, 1, 10, 48),   # recurrentgemma: G 10, hd 256
    (24, 8, 1, 10, 256, 2, 9, 10, 30),   # its prefill chunk past a window
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_flash_decode_paged_plain_matches_pallas_and_ref(case):
    nb, bs, kv, g, hd, b, c, nb_seq, window = case
    h = kv * g
    rng = np.random.default_rng(sum(case))
    q = rng.standard_normal((b, c, h, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:b * nb_seq].reshape(
        b, nb_seq).astype(np.int32)
    pos = rng.integers(0, nb_seq * bs - c + 1, (b,)).astype(np.int32)
    want_pallas = ops.flash_decode_paged(*map(jnp.asarray, (q, kp, vp, bt,
                                                            pos)),
                                         window=window)
    want_ref = ref.flash_decode_paged(*map(jnp.asarray, (q, kp, vp, bt,
                                                         pos)),
                                      window=window)
    got = flash_decode.flash_decode_paged(
        *map(torch.from_numpy, (q, kp, vp, bt, pos)), window=window)
    assert got.shape == (b, c, h, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)


def test_flash_decode_paged_ignores_trash_and_frontier_garbage():
    """Garbage in the trash block and past each row's frontier (huge
    values, as a stale row would leave) must not reach the output."""
    nb, bs, kv, g, hd, b, nb_seq = 12, 8, 2, 3, 64, 2, 4
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, 1, kv * g, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    # row 0 holds 3 blocks then a trash placeholder; row 1 all real
    bt = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    pos = np.array([19, 29], np.int32)
    clean = flash_decode.flash_decode_paged(
        *map(torch.from_numpy, (q, kp, vp, bt, pos)))
    kb, vb = kp.copy(), vp.copy()
    kb[0], vb[0] = 1e4, -1e4                       # trash block
    kb[3, 4:], vb[3, 4:] = 1e4, -1e4               # row 0 past pos 19
    kb[7, 6:], vb[7, 6:] = 1e4, -1e4               # row 1 past pos 29
    poisoned = flash_decode.flash_decode_paged(
        *map(torch.from_numpy, (q, kb, vb, bt, pos)))
    np.testing.assert_allclose(poisoned.numpy(), clean.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        clean.numpy(),
        np.asarray(ref.flash_decode_paged(*map(jnp.asarray,
                                               (q, kp, vp, bt, pos)))),
        **TOL)


# ---------------------------------------------------------------------------
# kernel 2: view attention of the N-step decode loop
# ---------------------------------------------------------------------------

VIEW_CASES = [
    # b, s (view incl. trash slot), kv, g, hd, window
    (3, 41, 2, 3, 64, 0),      # odd S
    (2, 129, 1, 6, 128, 0),
    (2, 65, 2, 2, 128, 20),    # sliding window
    (4, 33, 2, 1, 64, 7),
    (3, 97, 1, 10, 256, 40),   # recurrentgemma: G 10, hd 256, window
]


@pytest.mark.parametrize("case", VIEW_CASES)
def test_decode_view_plain_matches_pallas_and_model(case):
    b, s, kv, g, hd, window = case
    h = kv * g
    rng = np.random.default_rng(sum(case))
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    pos = rng.integers(0, s - 1, (b,)).astype(np.int32)
    want_pallas = ops.decode_view_attend(*map(jnp.asarray, (q, k, v, pos)),
                                         window=window)
    want_model = jattn.paged_decode_attention(
        jnp.asarray(q).reshape(b, 1, kv, g, hd), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(pos)[:, None],
        window=window).reshape(b, h, hd)
    got = decode_view.decode_view_attend(
        *map(torch.from_numpy, (q, k, v, pos)), window=window)
    assert got.shape == (b, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_model), **TOL)


def test_decode_view_ignores_trash_slot_and_frontier_garbage():
    b, s, kv, g, hd = 2, 33, 2, 2, 64
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    pos = np.array([10, 31], np.int32)
    clean = decode_view.decode_view_attend(
        *map(torch.from_numpy, (q, k, v, pos)))
    past = np.arange(s)[None, :, None, None] > pos[:, None, None, None]
    kb = np.where(past, 1e4, k).astype(np.float32)
    vb = np.where(past, -1e4, v).astype(np.float32)
    poisoned = decode_view.decode_view_attend(
        *map(torch.from_numpy, (q, kb, vb, pos)))
    np.testing.assert_allclose(poisoned.numpy(), clean.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# kernel 3: greedy sampling
# ---------------------------------------------------------------------------

GREEDY_CASES = [(5, 203), (2, 512), (3, 1000), (8, 4096), (1, 1537)]


@pytest.mark.parametrize("case", GREEDY_CASES)
def test_greedy_plain_matches_pallas_exactly_with_cross_block_ties(case):
    b, v = case
    rng = np.random.default_rng(v)
    lg = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    top = float(lg.max()) + 1.0
    # exact ties spanning the Pallas kernel's 512-wide vocab blocks (and
    # the CUDA kernel's column chunks): the lowest column wins
    lg[0, 7] = lg[0, v - 1] = top
    if b > 1:
        lg[1, v - 1] = lg[1, v // 2] = top
    keys = ref.sample_keys(0, np.arange(b), np.arange(b))
    want = ops.sample_tokens(jnp.asarray(lg), keys, temperature=0.0,
                             impl="pallas")
    got = sampling.greedy_sample(torch.from_numpy(lg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.argmax(lg, axis=-1))
    assert int(got[0]) == 7
    if b > 1:
        assert int(got[1]) == v // 2


@pytest.mark.parametrize("b", [1, 2, 8, 136, 264])
@pytest.mark.parametrize("v", [9, 1537, 50280, 129280, 151936])
def test_greedy_plan_covers_the_vocab_without_empty_slices(b, v):
    """Kernel 3's cluster launch on a 132-SM card (an H100 SXM): the
    cluster's contiguous slices, a multiple of 4 columns each, cover the
    row and none is empty; the size is one of CLUSTER_SIZES, the one
    whose launch comes nearest STREAM_CTAS_PER_SM CTAs an SM among those
    whose slices hold MIN_SLICE columns (kernel 4's without top-k)."""
    sms = 132
    c = sampling.greedy_plan(b, v, sms)
    sl = sampling.gumbel_slice(v, c)
    assert c in sampling.CLUSTER_SIZES
    assert sl % 4 == 0 and (c - 1) * sl < v <= c * sl
    assert c == 1 or sl >= sampling.MIN_SLICE
    fits = sampling.gumbel_clusters(v, 0)
    want = sampling.STREAM_CTAS_PER_SM * sms
    assert all(abs(math.log(b * c / want)) <= abs(math.log(b * d / want))
               for d in fits)
    assert c == sampling.gumbel_plan(b, v, sms, 0)


# ---------------------------------------------------------------------------
# wrappers: CPU takes the plain version, launches nothing; other devices
# launch the kernel or raise
# ---------------------------------------------------------------------------


def test_wrappers_route_cpu_to_plain_without_counting():
    from repro_torch import kernels
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    lg = torch.from_numpy(rng.standard_normal((2, 33)).astype(np.float32))
    sampling.greedy_sample(lg)
    q = torch.zeros((1, 2, 16))
    view = torch.zeros((1, 5, 1, 16))
    decode_view.decode_view_attend(q, view, view,
                                   torch.zeros(1, dtype=torch.int32))
    sampling.gumbel_sample(lg, torch.zeros_like(lg), temperature=0.5,
                           top_k=3)
    kernels.fused_sgd_update([torch.zeros(4)], [torch.zeros(4)],
                             [torch.ones(4)], lr=0.1, momentum=0.9,
                             weight_decay=0.0)
    pool = torch.zeros((2, 4, 6))
    slots = torch.tensor([1, 3], dtype=torch.int32)
    kernels.slot_gather(pool, slots, stacked=True)
    kernels.slot_scatter(pool[0], slots, torch.ones((2, 6)))
    x = torch.zeros((1, 8, 2, 4))
    bc = torch.zeros((1, 8, 2, 3))
    kernels.ssd_chunk_bchp(x, torch.ones((1, 8, 2)), torch.zeros((1, 8, 2)),
                           bc, bc)
    ql, qr = torch.zeros((1, 1, 2, 8)), torch.zeros((1, 1, 2, 4))
    pos = torch.zeros(1, dtype=torch.int32)
    kernels.mla_decode_views(ql, qr, torch.zeros((1, 5, 8)),
                             torch.zeros((1, 5, 4)), pos, scale=0.5)
    kernels.mla_decode_paged(ql, qr, torch.zeros((3, 4, 8)),
                             torch.zeros((3, 4, 4)),
                             torch.tensor([[1, 2]], dtype=torch.int32), pos,
                             scale=0.5)
    kv = torch.zeros((1, 5, 1, 16))
    flash_attention.flash_attention(torch.zeros((1, 5, 2, 16)), kv, kv)
    flash_decode.flash_decode(q, kv, kv, torch.tensor(3, dtype=torch.int32))
    assert kernels.launch_counts() == {"flash_decode_paged": 0,
                                       "decode_view_attend": 0,
                                       "greedy_sample": 0,
                                       "gumbel_sample": 0,
                                       "fused_sgd_update": 0,
                                       "slot_gather": 0,
                                       "slot_scatter": 0,
                                       "ssd_chunk_bchp": 0,
                                       "mla_decode_views": 0,
                                       "mla_decode_paged": 0,
                                       "flash_attention": 0,
                                       "flash_decode": 0}


def test_wrappers_raise_off_cpu_without_cuda():
    lg = torch.zeros((2, 33), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sampling.greedy_sample(lg)
    q = torch.zeros((1, 1, 2, 64), device="meta")
    pool = torch.zeros((4, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode.flash_decode_paged(
            q, pool, pool, torch.zeros((1, 2), dtype=torch.int32,
                                       device="meta"),
            torch.zeros((1,), dtype=torch.int32, device="meta"))
    from repro_torch import kernels
    slots = torch.zeros((2,), dtype=torch.int32, device="meta")
    pool = torch.zeros((3, 5), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.slot_gather(pool, slots)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.slot_scatter(pool, slots, torch.zeros((2, 5), device="meta"))
    x = torch.zeros((1, 8, 2, 4), device="meta")
    d = torch.zeros((1, 8, 2), device="meta")
    bc = torch.zeros((1, 8, 2, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ssd_chunk_bchp(x, d, d, bc, bc)
    ql = torch.zeros((1, 1, 4, 512), device="meta")
    qr = torch.zeros((1, 1, 4, 64), device="meta")
    pos = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mla_decode_views(
            ql, qr, torch.zeros((1, 9, 512), device="meta"),
            torch.zeros((1, 9, 64), device="meta"), pos, scale=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mla_decode_paged(
            ql, qr, torch.zeros((3, 4, 512), device="meta"),
            torch.zeros((3, 4, 64), device="meta"),
            torch.zeros((1, 2), dtype=torch.int32, device="meta"), pos,
            scale=0.1)
    q = torch.zeros((1, 8, 2, 64), device="meta")
    kv = torch.zeros((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode.flash_decode(q[:, 0], kv, kv,
                                  torch.zeros((), dtype=torch.int32,
                                              device="meta"))


def test_profiler_groups_every_port_kernel():
    """The profilers' "port kernels" group is read from the sources'
    ``__global__`` names, so a renamed or added kernel cannot fall into
    "other"."""
    from repro_torch.kernels import _build
    from repro_torch.serve.profile_engine import _group
    names = _build.kernel_names()
    assert {"flash_decode_paged_kernel", "decode_view_kernel",
            "combine_splits", "gumbel_cluster_kernel", "fused_sgd_kernel",
            "lars_norms_kernel", "lars_trust_kernel",
            "slot_gather_kernel", "slot_scatter_kernel", "ssd_chunk_tc",
            "ssd_chunk_f32", "flash_attention_tc",
            "flash_attention_f32", "flash_decode_bhd_kernel"} <= set(names)
    for name in names:
        assert _group(f"void rt::{name}<float>(float const*, int)") == \
            "port kernels"
    assert _group("nvjet_tst_128x256") == "matrix products"
