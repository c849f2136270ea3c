"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's (``repro.models.rglru``) on the same numpy inputs and weights:
the init's shapes and Lambda, the log-depth ``lru_scan`` against its
sequential plain version and the reference's ``associative_scan``, and
``apply_rglru`` in its four forms — the full sequence (with
``make_cache``), a step over a contiguous cache, the slot pools of the
fused serving step (fresh rows, padded columns, ``valid_len == 0`` rows
routed to trash slot 0; the JAX side at ``attn_impl="naive"`` and at
``"pallas"``, its slot kernels in interpret mode) and the decode loop's
per-row views.

Tolerances: float32 throughout, atol/rtol 1e-4 (the scans and matmuls
sum in other orders); the trash slot 0 is left out of pool comparisons
(every row that must not write lands there; which one wins is defined
in neither package).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models import rglru as jrg
from repro_torch import interop
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import rglru as trg
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
PERTURBED = ("lam", "b_r", "b_i", "conv_b")


def rglru_configs(impl="naive"):
    """(jax cfg, port cfg): the smoke recurrentgemma (d_model and LRU
    width 256, conv 4, window 64), float32."""
    return (jax_smoke_variant(jax_get_config("recurrentgemma-2b")).replace(
                attn_impl=impl),
            smoke_variant(get_config("recurrentgemma-2b")).replace(
                attn_impl=impl))


@pytest.fixture(scope="module")
def block():
    """(jax cfg, port cfg, jax params, port params) of one block: the
    reference's init, with Lambda, both gate biases and the conv bias
    perturbed so that every param matters."""
    jcfg, tcfg = rglru_configs()
    flat = {k: np.asarray(v) for k, v in
            jrg.init_rglru(jax.random.key(0), jcfg).items()}
    rng = np.random.default_rng(0)
    for k in PERTURBED:
        flat[k] = (flat[k] + 0.3 * rng.standard_normal(flat[k].shape)
                   ).astype(np.float32)
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in flat.items()},
            interop.from_flat(flat, device="cpu"))


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


def test_init_shapes_and_lambda_match_reference():
    jcfg, tcfg = rglru_configs()
    want = jrg.init_rglru(jax.random.key(1), jcfg)
    gen = torch.Generator().manual_seed(1)
    got = trg.init_rglru(gen, tcfg, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(np.asarray(v).shape) for k, v in want.items()}
    assert {k: v.dtype for k, v in got.items()} == \
        {k: torch.float32 for k in want}
    np.testing.assert_allclose(got["lam"].numpy(), np.asarray(want["lam"]),
                               rtol=1e-5, atol=1e-6)
    # a^c at r = 1 spans [0.9, 0.999], as the reference's init intends
    a_c = torch.exp(-tcfg.rglru.gate_c * torch.nn.functional.softplus(
        got["lam"]))
    np.testing.assert_allclose(a_c[[0, -1]].numpy(), [0.9, 0.999],
                               rtol=1e-5)
    for k in ("b_r", "b_i", "conv_b"):
        assert not got[k].any()
    for kind, batch in (("cache", 3), ("pool", 6)):
        jc = jrg.init_rglru_cache(jcfg, batch, jnp.float32)
        tc = trg.init_rglru_cache(tcfg, batch, torch.float32)
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(np.asarray(v).shape) for k, v in jc.items()}, kind
    # a deliberate deviation: h stays float32 in a bfloat16 model
    half = trg.init_rglru_cache(tcfg, 2, torch.bfloat16)
    assert (half["conv"].dtype, half["h"].dtype) == (torch.bfloat16,
                                                     torch.float32)


# (b, s, width, lowest a, with h0): a 128-token chunk (7 passes), ragged
# lengths, one position, and a's near 0.43 — gate_c 8's low end, where a
# product of 128 of them underflows float32
SCANS = [(2, 128, 64, 0.8, True), (3, 37, 16, 0.5, False),
         (1, 1, 8, 0.9, True), (2, 130, 32, 0.43, True),
         (2, 128, 8, 0.43, False)]


@pytest.mark.parametrize("case", SCANS)
def test_lru_scan_matches_sequential_and_reference(case):
    b, s, w, lo, with_h0 = case
    rng = np.random.default_rng(sum(map(int, case[:3])))
    a = rng.uniform(lo, lo + 0.02 if lo < 0.5 else 1.0,
                    (b, s, w)).astype(np.float32)
    bt = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    got = trg.lru_scan(_t(a), _t(bt), None if h0 is None else _t(h0))
    plain = trg.lru_scan_plain(_t(a), _t(bt), None if h0 is None else _t(h0))
    want = jrg._lru_scan(jnp.asarray(a), jnp.asarray(bt),
                         None if h0 is None else jnp.asarray(h0))
    assert got.shape == (b, s, w)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(got).all()


def _x(rng, b, s, d):
    return (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)


def test_full_sequence_and_make_cache_match(block):
    jcfg, tcfg, jp, tp = block
    x = _x(np.random.default_rng(3), 2, 45, jcfg.d_model)
    want, wcache = jrg.apply_rglru(jp, jnp.asarray(x), jcfg, make_cache=True)
    got, gcache = trg.apply_rglru(tp, _t(x), tcfg, make_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(gcache[k].numpy(), np.asarray(wcache[k]),
                                   **TOL)
    out, none = trg.apply_rglru(tp, _t(x), tcfg)
    assert none is None and torch.equal(out, got)


def _state(rng, cfg, n):
    w = cfg.rglru.lru_width
    return {"conv": rng.standard_normal(
                (n, cfg.rglru.conv_kernel - 1, w)).astype(np.float32),
            "h": rng.standard_normal((n, w)).astype(np.float32)}


def test_contiguous_cache_step_matches(block):
    """One token over the non-paged decode's cache, updated in place."""
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(4)
    state = _state(rng, jcfg, 3)
    x = _x(rng, 3, 1, jcfg.d_model)
    want, wcache = jrg.apply_rglru(
        jp, jnp.asarray(x), jcfg,
        cache={k: jnp.asarray(v) for k, v in state.items()})
    cache = {k: _t(v) for k, v in state.items()}
    got, same = trg.apply_rglru(tp, _t(x), tcfg, cache=cache)
    assert same is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(wcache[k]),
                                   **TOL)


NS = 7                       # state slots (slot 0 the trash)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_slot_pools_match(block, impl):
    """The fused step's form: rows read their slot (zeros at pos 0),
    padded columns are identity updates, valid_len-0 rows (a padding row
    and a stale row aimed at a live slot) write trash slot 0 only."""
    jcfg, tcfg, jp, tp = block
    jcfg = jcfg.replace(attn_impl=impl)
    rng = np.random.default_rng(5)
    pools = _state(rng, jcfg, NS)
    s = 9
    x = _x(rng, 5, s, jcfg.d_model)
    state_slots = np.array([3, 1, 5, 0, 5], np.int32)
    pos = np.array([0, 17, 4, 0, 9], np.int32)
    valid_len = np.array([9, 1, 6, 0, 0], np.int32)
    want, wpools = jrg.apply_rglru(
        jp, jnp.asarray(x), jcfg,
        cache={k: jnp.asarray(v) for k, v in pools.items()},
        pos=jnp.asarray(pos), valid_len=jnp.asarray(valid_len),
        state_slots=jnp.asarray(state_slots))
    tpools = {k: _t(v) for k, v in pools.items()}
    got, same = trg.apply_rglru(tp, _t(x), tcfg, cache=tpools, pos=_t(pos),
                                valid_len=_t(valid_len),
                                state_slots=_t(state_slots))
    assert same is tpools
    live = valid_len > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(tpools[k].numpy()[1:],
                                   np.asarray(wpools[k])[1:], **TOL)
        # slots no live row owns are as they were: the stale row aimed at
        # slot 5 did not move it past the live row's write
        for untouched in (2, 4, 6):
            np.testing.assert_array_equal(tpools[k].numpy()[untouched],
                                          pools[k][untouched])


def test_decode_loop_views_match(block):
    """The N-step loop's form: per-row views, one token a row, rows with
    valid_len 0 left as they were."""
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(6)
    views = {f"{k}_view": v for k, v in _state(rng, jcfg, 4).items()}
    x = _x(rng, 4, 1, jcfg.d_model)
    valid_len = np.array([1, 0, 1, 1], np.int32)
    pos = np.array([5, 9, 0, 63], np.int32)
    want, wviews = jrg.apply_rglru(
        jp, jnp.asarray(x), jcfg,
        cache={k: jnp.asarray(v) for k, v in views.items()},
        pos=jnp.asarray(pos), valid_len=jnp.asarray(valid_len),
        state_slots=jnp.arange(4, dtype=jnp.int32))
    tviews = {k: _t(v) for k, v in views.items()}
    got, same = trg.apply_rglru(tp, _t(x), tcfg, cache=tviews, pos=_t(pos),
                                valid_len=_t(valid_len),
                                state_slots=torch.arange(4,
                                                         dtype=torch.int32))
    assert same is tviews
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in views:
        np.testing.assert_allclose(tviews[k].numpy(), np.asarray(wviews[k]),
                                   **TOL)
        np.testing.assert_array_equal(tviews[k].numpy()[1], views[k][1])
