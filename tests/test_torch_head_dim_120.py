"""Head dim 120 on the port (h2o-danube-3-4b's): the plain versions of
kernels 1, 2, 6 and 7 at hd 120 against the JAX package's Pallas kernels
(interpret mode, through ``repro.kernels.ops``, which zero-pads hd to
128 and rescales q so that the softmax keeps 1/sqrt(120)) and its jnp
oracles, in float32, causal and windowed, at ragged lengths and at G 1,
4 and 7.  The model at hd 120 is ``test_torch_h2o.py``.

Tolerances: within atol 3e-5 / rtol 2e-5 (two f32 softmax
implementations, the Pallas one blocked).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import attention as jattn
from repro_torch.kernels import decode_view, flash_attention, flash_decode
from torch_threads import one_torch_thread  # noqa: F401

KTOL = dict(atol=3e-5, rtol=2e-5)
HD = 120


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the kernels' plain versions at hd 120
# ---------------------------------------------------------------------------

PAGED_CASES = [
    # nb, bs, kv, g, b, c, nb_seq, window
    (16, 8, 2, 4, 3, 1, 4, 0),      # decode, h2o's G 4
    (16, 8, 2, 1, 2, 1, 4, 20),     # G 1 + window
    (32, 8, 1, 7, 2, 1, 6, 0),      # G 7
    (32, 8, 2, 4, 2, 9, 6, 11),     # a prefill chunk past a window
    (24, 8, 1, 7, 2, 5, 5, 0),      # G 7 chunk
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_flash_decode_paged_plain_at_head_dim_120(case):
    nb, bs, kv, g, b, c, nb_seq, window = case
    h = kv * g
    rng = np.random.default_rng(sum(case))
    q, kp, vp = _normal(sum(case), (b, c, h, HD), (nb, bs, kv, HD),
                        (nb, bs, kv, HD))
    bt = rng.permutation(np.arange(1, nb))[:b * nb_seq].reshape(
        b, nb_seq).astype(np.int32)
    pos = rng.integers(0, nb_seq * bs - c + 1, (b,)).astype(np.int32)
    args = (q, kp, vp, bt, pos)
    want_pallas = ops.flash_decode_paged(*map(jnp.asarray, args),
                                         window=window)
    want_ref = ref.flash_decode_paged(*map(jnp.asarray, args), window=window)
    got = flash_decode.flash_decode_paged(*map(_t, args), window=window)
    assert got.shape == (b, c, h, HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **KTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **KTOL)


VIEW_CASES = [
    # b, s (view incl. trash slot), kv, g, window
    (3, 41, 2, 4, 0),
    (2, 65, 1, 7, 20),
    (4, 33, 2, 1, 7),
]


@pytest.mark.parametrize("case", VIEW_CASES, ids=str)
def test_decode_view_plain_at_head_dim_120(case):
    b, s, kv, g, window = case
    h = kv * g
    q, k, v = _normal(sum(case), (b, h, HD), (b, s, kv, HD), (b, s, kv, HD))
    pos = np.random.default_rng(s).integers(0, s - 1, (b,)).astype(np.int32)
    want_pallas = ops.decode_view_attend(*map(jnp.asarray, (q, k, v, pos)),
                                         window=window)
    want_model = jattn.paged_decode_attention(
        jnp.asarray(q).reshape(b, 1, kv, g, HD), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(pos)[:, None],
        window=window).reshape(b, h, HD)
    got = decode_view.decode_view_attend(*map(_t, (q, k, v, pos)),
                                         window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **KTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_model), **KTOL)


ATTN_CASES = [
    # b, sq, sk, h, kv, causal, window
    (1, 96, 96, 8, 2, True, 0),      # G 4, causal
    (2, 70, 70, 7, 1, True, 24),     # G 7, a window, ragged S
    (1, 64, 160, 4, 4, False, 0),    # G 1, not causal, Sq != Sk
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_plain_at_head_dim_120(case):
    b, sq, sk, h, kv, causal, window = case
    q, k, v = _normal(sq + sk, (b, sq, h, HD), (b, sk, kv, HD),
                      (b, sk, kv, HD))
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window)
    got = flash_attention.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                          window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)
    want_ref = ref.flash_attention_bhsd(
        *(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)),
        causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(),
                               np.swapaxes(np.asarray(want_ref), 1, 2),
                               **KTOL)


DECODE_CASES = [
    # b, s, h, kv, length
    (2, 512, 8, 2, 300),     # G 4
    (3, 200, 7, 1, 13),      # G 7
    (2, 96, 4, 4, 96),       # G 1, a full cache
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_flash_decode_plain_at_head_dim_120(case):
    b, s, h, kv, length = case
    q, k, v = _normal(s + h, (b, h, HD), (b, s, kv, HD), (b, s, kv, HD))
    want = ops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            length)
    got = flash_decode.flash_decode(_t(q), _t(k), _t(v),
                                    torch.tensor(length, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)
    want_ref = ref.flash_decode(jnp.asarray(q),
                                jnp.swapaxes(jnp.asarray(k), 1, 2),
                                jnp.swapaxes(jnp.asarray(v), 1, 2), length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **KTOL)
