"""Temperature / top-k sampling of the port against the JAX package.

- ``repro_torch.kernels.prng`` reproduces the reference's threefry keys
  and bits exactly; its gumbel noise is within 2 ulp of
  ``jax.random.gumbel`` at each of its two logarithms (XLA's CPU ``log``
  and PyTorch's may round differently), which bounds the noise to 2 ulp
  of max(|g|, 1).
- The plain ``gumbel_sample`` picks exactly the token of
  ``ref.sample_tokens`` and of ``ops.sample_tokens(impl="pallas")``
  (Pallas in interpret mode) on the same logits and keys, with ties
  planted at the kth value.
- The port's ``Engine`` at temperature 0.8, top_k 0 and 20, depths 1 and
  4, is token-identical to the JAX engine on the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro_torch.kernels import prng, sampling
from repro_torch.serve import Engine, EngineConfig, Request
from test_torch_engine import TINY, WIDE, _workload
from test_torch_model import carried_models

F32_EPS = float(np.finfo(np.float32).eps)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _rows(n=64, seed=0):
    rng = np.random.default_rng(seed)
    rids = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    rids[:4] = [0, 1, 2**31 - 1, 7]
    pos = rng.integers(0, 1 << 20, n).astype(np.int32)
    pos[:4] = [0, 1, 65535, 3]
    return rids, pos


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 5, 2**40 + 3])
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    assert list(prng.prng_key(seed)) == want.tolist()


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_sample_keys_and_bits_exact(seed):
    rids, pos = _rows()
    jk = np.asarray(jref.sample_keys(seed, rids, pos)).astype(np.int64)
    tk = prng.sample_keys(seed, torch.from_numpy(rids),
                          torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), jk)
    v = 1000
    jb = jax.vmap(lambda k: jax.random.bits(k, (v,), jnp.uint32))(
        jnp.asarray(jk, jnp.uint32))
    np.testing.assert_array_equal(prng.random_bits(tk, v).numpy(),
                                  np.asarray(jb).astype(np.int64))
    ju = jax.vmap(lambda k: jax.random.uniform(
        k, (v,), jnp.float32, minval=np.finfo(np.float32).tiny))(
        jnp.asarray(jk, jnp.uint32))
    np.testing.assert_array_equal(prng.uniform(tk, v).numpy(),
                                  np.asarray(ju))


def test_gumbel_within_two_ulp_of_jax():
    rids, pos = _rows(32, seed=1)
    jk = np.asarray(jref.sample_keys(9, rids, pos))
    tk = torch.from_numpy(jk.astype(np.int64))
    v = 1000
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (v,), jnp.float32))(jnp.asarray(jk)))
    tg = prng.gumbel(tk, v).numpy()
    # each logarithm on its own, from the same input
    u = prng.uniform(tk, v).numpy()
    jneg = np.array(jax.jit(lambda x: -jnp.log(x))(u))
    assert _ulps((-torch.log(torch.from_numpy(u))).numpy(), jneg).max() <= 2
    assert _ulps((-torch.log(torch.from_numpy(jneg))).numpy(),
                 np.asarray(jax.jit(lambda x: -jnp.log(x))(jneg))).max() <= 2
    assert (np.abs(tg - jg) / np.maximum(np.abs(jg), 1.0)).max() \
        <= 2 * F32_EPS


def _tied_logits(b, v, top_k, seed):
    """Logits with ties planted at each row's kth value, one of them at
    the last column."""
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    if top_k > 1:
        for r in range(b):
            kth = np.sort(lg[r])[::-1][top_k - 1]
            cols = rng.choice(v - 1, 3, replace=False)
            lg[r, cols] = kth
            lg[r, v - 1] = kth
    if top_k == 1:
        lg[:, [5, v - 1]] = lg.max() + 1.0
    return lg


@pytest.mark.parametrize("top_k", [0, 1, 5])
def test_plain_gumbel_sample_equals_reference_and_pallas(top_k):
    b, v, t = 6, 1000, 0.8
    lg = _tied_logits(b, v, top_k, seed=top_k)
    rids, pos = _rows(b, seed=top_k + 10)
    keys = jref.sample_keys(4, rids, pos)
    want = np.asarray(jref.sample_tokens(jnp.asarray(lg), keys,
                                         temperature=t, top_k=top_k))
    pallas = np.asarray(jops.sample_tokens(jnp.asarray(lg), keys,
                                           temperature=t, top_k=top_k,
                                           impl="pallas"))
    tk = prng.sample_keys(4, torch.from_numpy(rids), torch.from_numpy(pos))
    got = sampling.gumbel_sample(torch.from_numpy(lg),
                                 prng.gumbel(tk, v), temperature=t,
                                 top_k=top_k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    if top_k:
        kth = np.sort(lg, axis=1)[:, ::-1][:, top_k - 1]
        assert (lg[np.arange(b), got] >= kth).all()


def test_gumbel_sample_rejects_bad_arguments():
    lg = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="temperature"):
        sampling.gumbel_sample(lg, lg, temperature=0.0)
    with pytest.raises(ValueError, match="top_k"):
        sampling.gumbel_sample(lg, lg, temperature=1.0, top_k=9)


ENGINE_T = 0.8


@pytest.fixture(scope="module")
def sampled_setup():
    """The JAX engine's sampled streams at top_k 0 and 20, depth 1."""
    jcfg, jmodel, jparams, _, tmodel, tparams = carried_models(TINY)
    work = _workload(jcfg.vocab_size)
    want = {}
    for top_k in (0, 20):
        eng = JaxEngine(jmodel, jparams, JaxEngineConfig(
            temperature=ENGINE_T, top_k=top_k, seed=5, **WIDE))
        res = eng.run([JaxRequest(prompt=p.copy(), max_new_tokens=g, rid=i)
                       for i, (p, g) in enumerate(work)])
        want[top_k] = [res[i].tokens for i in range(len(work))]
    return tmodel, tparams, work, want


@pytest.mark.parametrize("spd", [1, 4])
@pytest.mark.parametrize("top_k", [0, 20])
def test_engine_sampled_token_identical_to_jax_engine(sampled_setup, spd,
                                                      top_k):
    tmodel, tparams, work, want = sampled_setup
    eng = Engine(tmodel, tparams, EngineConfig(
        temperature=ENGINE_T, top_k=top_k, seed=5, steps_per_dispatch=spd,
        **WIDE), device="cpu")
    eng.warmup()
    res = eng.run([Request(prompt=p.copy(), max_new_tokens=g, rid=i)
                   for i, (p, g) in enumerate(work)])
    got = [res[i].tokens for i in range(len(work))]
    assert got == want[top_k]
    if spd > 1:
        assert eng.metrics_snapshot()["counters"]["loop_dispatches"] > 0


def test_sampled_streams_depend_on_top_k(sampled_setup):
    """The draw is live: top-k changes the support, so the two sampled
    stream sets differ."""
    _, _, _, want = sampled_setup
    assert want[0] != want[20]
