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
- ``sampling.gumbel_plan`` (kernel 4's cluster size) is pinned at the
  engine's row counts for the three served vocabularies on a 132-SM card
  (an H100 SXM), with top-k each CTA's staged slice within a block's
  shared memory; a top-k row no cluster stages takes the unstaged
  variant, and the plain version samples the reference's token there.
- The port's ``Engine`` at temperature 0.8, top_k 0 and 20, depths 1 and
  4, is token-identical to the JAX engine on the same weights.
"""
import math

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
from torch_threads import one_torch_thread  # noqa: F401

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


@pytest.mark.parametrize("top_k", [0, 1, 5, 50])
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


@pytest.mark.parametrize("top_k", [1, 50])
def test_plain_gumbel_sample_wide_top_k_row_equals_reference(top_k):
    """A top-k row wider than any cluster stages (16 x 51,200 + 64
    columns; on the card the select then reads device memory) samples
    ``ref.sample_tokens``'s token, ties planted at the kth value."""
    b, v, t = 4, 16 * sampling.GUMBEL_SMEM_BYTES // 4 + 64, 0.8
    lg = _tied_logits(b, v, top_k, seed=top_k + 3)
    rids, pos = _rows(b, seed=top_k + 20)
    keys = jref.sample_keys(6, rids, pos)
    want = np.asarray(jref.sample_tokens(jnp.asarray(lg), keys,
                                         temperature=t, top_k=top_k))
    tk = prng.sample_keys(6, torch.from_numpy(rids), torch.from_numpy(pos))
    got = sampling.gumbel_sample(torch.from_numpy(lg), prng.gumbel(tk, v),
                                 temperature=t, top_k=top_k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k", [0, 3])
def test_plain_gumbel_sample_all_neg_inf_row_gives_column_0(top_k):
    """A row of -inf logits scores -inf everywhere: column 0, as
    ``ref.sample_tokens`` gives it, beside an ordinary row."""
    lg = np.full((4, 40), -np.inf, np.float32)
    lg[1] = np.random.default_rng(top_k).standard_normal(40)
    rids, pos = _rows(4, seed=3)
    keys = jref.sample_keys(1, rids, pos)
    want = np.asarray(jref.sample_tokens(jnp.asarray(lg), keys,
                                         temperature=0.8, top_k=top_k))
    tk = prng.sample_keys(1, torch.from_numpy(rids), torch.from_numpy(pos))
    got = sampling.gumbel_sample(torch.from_numpy(lg), prng.gumbel(tk, 40),
                                 temperature=0.8, top_k=top_k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0


SMS = 132
# a block's shared memory on an H100 and what kernel 4 keeps there besides
# its logits slice (csrc/sampling.cu gumbel_cluster_kernel: a 2048-bin
# and a 256-bin histogram, 4 summed ones of 256 bins, a 2048-column
# candidate list, scan and count words, partials, an mbarrier)
BLOCK_SMEM = 232_448
STATIC_SMEM = 4 * (2048 + 256 + 4 * 256 + 2048 + 8 + 3 + 2 * 16 + 2 * 16) + 8
# (vocab, rows) -> cluster size without and with top-k: the engine's rows
# (decode buckets 8/4/2, mixed 136 / 264, chip_smoke's 1 and 64) for
# qwen2-1.5b, mamba2-370m and deepseek-v3
ROWS = (1, 2, 4, 8, 64, 136, 264)
GUMBEL_PLANS = {
    **{(151936, b): c for b, c in zip(ROWS, [(16, 16)] * 4
                                      + [(4, 8), (2, 8), (1, 8)])},
    **{(50280, b): c for b, c in zip(ROWS, [(16, 16)] * 4
                                     + [(4, 4), (2, 4), (1, 4)])},
    **{(129280, b): c for b, c in zip(ROWS, [(16, 16)] * 4
                                      + [(4, 8), (2, 8), (1, 8)])},
}


@pytest.mark.parametrize("v,b", list(GUMBEL_PLANS))
@pytest.mark.parametrize("top_k", [0, 50])
def test_gumbel_plan_at_the_engine_rows(v, b, top_k):
    c = sampling.gumbel_plan(b, v, SMS, top_k)
    assert c == GUMBEL_PLANS[(v, b)][bool(top_k)]
    sl = sampling.gumbel_slice(v, c)
    # the slices cover the row, none empty, 16-byte copies
    assert sl % 4 == 0 and (c - 1) * sl < v <= c * sl
    fits = sampling.gumbel_clusters(v, top_k)
    if not top_k:
        # one streaming pass: the launch nearest two CTAs an SM
        want = sampling.STREAM_CTAS_PER_SM * SMS
        assert all(abs(math.log(b * c / want)) <= abs(math.log(b * d / want))
                   for d in fits)
        return
    # the logits slice, staged, within a block's shared memory; the
    # select's slice at most SELECT_SLICE columns, unless the rows are too
    # few to fill the card with it
    assert 4 * sl <= sampling.GUMBEL_SMEM_BYTES
    assert 4 * sl + STATIC_SMEM <= BLOCK_SMEM
    fits = [d for d in fits
            if sampling.gumbel_slice(v, d) <= sampling.SELECT_SLICE]
    if b * c < SMS:
        # too few rows to fill the card: the largest cluster
        assert c == fits[-1] == max(sampling.CLUSTER_SIZES)
    else:
        # the smallest that gives every SM a CTA
        assert all(b * d < SMS for d in fits if d < c)


def test_gumbel_plan_small_and_unfit_vocabularies():
    # a slice below MIN_SLICE columns does not pay for a cluster
    assert sampling.gumbel_clusters(1000, 0) == [1]
    assert sampling.gumbel_plan(5, 203, SMS, 0) == 1
    assert sampling.gumbel_plan(5, 203, SMS, 3) == 1
    assert sampling.gumbel_slice(203, 1) == 204
    assert sampling.gumbel_clusters(4096, 3) == [1, 2, 4]
    # with top-k a row no cluster of 16 stages takes the unstaged
    # variant (the select reads its slices from device memory) at any
    # size, the plan 16; without, nothing is staged, so any cluster fits
    v = 16 * sampling.GUMBEL_SMEM_BYTES // 4 + 64
    assert sampling.gumbel_clusters(v, 50) == list(sampling.CLUSTER_SIZES)
    for b in (2, 8, 264):
        c = sampling.gumbel_plan(b, v, SMS, 50)
        assert c == 16 and not sampling.gumbel_staged(v, c, 50)
    assert sampling.gumbel_clusters(v, 0) == list(sampling.CLUSTER_SIZES)
    assert sampling.gumbel_plan(8, v, SMS, 0) == 16
    assert sampling.gumbel_plan(264, v, SMS, 0) == 1
    # the served vocabularies stage their top-k slices at every engine
    # row count, and a row just under the limit still does
    for (vv, b), (_, c) in GUMBEL_PLANS.items():
        assert sampling.gumbel_staged(vv, c, 50)
        assert not sampling.gumbel_staged(vv, c, 0)
    v = 16 * sampling.GUMBEL_SMEM_BYTES // 4
    assert sampling.gumbel_staged(v, sampling.gumbel_plan(8, v, SMS, 50), 50)


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
