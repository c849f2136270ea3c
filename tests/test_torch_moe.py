"""The port's MoE FFN against the JAX package on the CPU: ``apply_moe``
in its dropless (serving) and capacity-bounded (training) forms, y and
the aux loss, with routing skewed so that the capacity form really
drops; ``_segment_rank``; the expert init; the grouped cast of an expert
pass whose weights have another dtype than its activations.

Tolerances: float32; y within atol/rtol 1e-5, the aux loss within 1e-6;
segment ranks exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models import moe as jmoe
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import moe as tmoe
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "deepseek-v3-671b"


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


@pytest.fixture(scope="module")
def carried():
    """One MoE layer of the deepseek smoke variant (4 experts, top-2, one
    shared expert) from the JAX init, with the router pulled toward
    expert 0 so that it overflows its training capacity."""
    jcfg = jax_smoke_variant(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jp = jmoe.init_moe(jax.random.key(1), jcfg)
    flat = jax.tree_util.tree_map(np.asarray, jp)
    w = flat["router"]["w"].copy()
    w[:, 0] += 0.05
    flat["router"]["w"] = w
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, flat), tcfg,
            jax.tree_util.tree_map(_t, flat))


def _x(seed, b, s, d):
    """Activations of a small scale with a common offset (which the
    router's pull toward expert 0 reads): the reference's expert init
    has a fan-in of E, so its products grow fast with the input."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((b, s, d)) + 0.05).astype(np.float32)


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("shape", [(2, 9), (1, 1), (3, 16)])
def test_apply_moe_matches_reference(carried, dropless, shape):
    jcfg, jparams, tcfg, tparams = carried
    x = _x(sum(shape), *shape, jcfg.d_model)
    yj, aj = jmoe.apply_moe_scatter(jparams, jnp.asarray(x), jcfg,
                                    dropless=dropless)
    yt, at = tmoe.apply_moe(tparams, _t(x), tcfg, dropless=dropless)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6, rtol=1e-6)


def test_capacity_form_really_drops(carried):
    """Under the skewed router expert 0 gets more assignments than the
    training capacity holds: the two forms differ, and only there."""
    jcfg, _, tcfg, tparams = carried
    b, s = 3, 16
    x = _t(_x(35, b, s, tcfg.d_model))
    m = tcfg.moe
    t = b * s
    _, _, ids = tmoe.route(tparams, x.reshape(t, -1), tcfg)
    cap = int(max(4, -(-t * m.num_experts_per_tok * m.capacity_factor
                       // m.num_experts)))
    assert int((ids == 0).sum()) > cap
    y_drop, _ = tmoe.apply_moe(tparams, x, tcfg, dropless=False)
    y_full, _ = tmoe.apply_moe(tparams, x, tcfg, dropless=True)
    assert not torch.allclose(y_drop, y_full)


def test_segment_rank_matches_reference():
    rng = np.random.default_rng(2)
    ids = np.sort(rng.integers(0, 7, 50)).astype(np.int32)
    want = np.asarray(jmoe._segment_rank(jnp.asarray(ids), 50))
    got = tmoe._segment_rank(_t(ids).long(), 50)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tmoe._segment_rank(torch.tensor([3, 3, 3]), 3).numpy(), [0, 1, 2])


def test_expert_init_keeps_the_reference_fan_in():
    """Each expert is drawn on its own, truncated at two sigma, at the
    reference's scale 1/sqrt(E) (the fan-in of the (E, D, F) leaf)."""
    gen = torch.Generator().manual_seed(0)
    e = 16
    w = tmoe._expert_init(gen, 2, e, (64, 32), torch.float32, "cpu")
    assert w.shape == (2, e, 64, 32)
    assert float(w.abs().max()) <= 2.0 / np.sqrt(e) + 1e-6
    assert 0.7 / np.sqrt(e) < float(w.std()) < 1.0 / np.sqrt(e)
    assert not torch.equal(w[0, 0], w[0, 1])


def test_grouped_cast_equals_whole_leaf_cast(carried, monkeypatch):
    """An f32 pass over bf16 experts (the chip check's f32 oracle) casts
    a group at a time; the result equals casting every leaf whole."""
    _, _, tcfg, tparams = carried
    bf = {k: {n: w.to(torch.bfloat16) for n, w in v.items()}
          if k != "router" else v for k, v in tparams.items()}
    whole = {k: {n: w.float() for n, w in v.items()} if k != "router"
             else v for k, v in bf.items()}
    x = _t(_x(7, 2, 5, tcfg.d_model))
    want, _ = tmoe.apply_moe(whole, x, tcfg, dropless=True)
    one_expert = bf["experts"]["w_gate"][0].numel() * 4
    monkeypatch.setattr(tmoe, "CAST_GROUP_BYTES", one_expert)
    got, _ = tmoe.apply_moe(bf, x, tcfg, dropless=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
