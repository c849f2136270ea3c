"""The port's MLA + MoE family (deepseek-v3's smoke variant cut to 3
layers: one dense layer, then a stacked run of 2 MoE layers) against the
JAX package on carried-across weights: params, the MTP head and latent
pools through ``interop``, the full-sequence forward in both MoE forms,
``paged_step`` and ``paged_decode_loop`` over latent block pools, and
the ``Engine`` token-identical to the JAX engine at dispatch depths 1
and 8, greedy and at temperature 0.8 / top-k 20, with and without forced
preemption, against the JAX engine at ``attn_impl="naive"`` (jnp) and
``"pallas"`` (its MLA and sampling kernels, interpret mode).

Tolerances: float32 on the CPU; logits and pools within atol/rtol 1e-4;
tokens, counts and flags exactly equal.  The trash block 0 is left out
of pool comparisons (rows that must not write all land there; which one
wins is unspecified in both packages).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models import transformer as jtf
from repro.models.model import build_model as jax_build_model
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro_torch import interop, kernels
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.serve import Engine, EngineConfig, Request
from repro_torch.serve.engine import _to_device
from test_torch_engine import WIDE, _workload
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
SAMPLED = dict(temperature=0.8, top_k=20, seed=3)
ARCH = "deepseek-v3-671b"
LAYERS = 3


def carried_deepseek(seed=0):
    """(jax cfg, jax model, jax params, port cfg, port model, port
    params): the smoke deepseek at LAYERS layers from the port's own init
    (the JAX init of the stacked MoE run takes tens of seconds on one
    core), with random norm scales so every param matters, carried to
    the reference's tree by path."""
    jcfg = jax_smoke_variant(jax_get_config(ARCH)).replace(num_layers=LAYERS)
    tcfg = smoke_variant(get_config(ARCH)).replace(num_layers=LAYERS)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    flat = interop.to_flat(tmodel.init(seed, "cpu"))
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.split("::")[-1] == "scale":
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    leaves, tree = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jmodel.init, jax.random.key(seed)))
    jparams = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(flat[_path(p)]) for p, _ in leaves])
    tparams = interop.from_flat(flat, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _path(keys):
    return "::".join(str(getattr(k, "key", k)) for k in keys)


@pytest.fixture(scope="module")
def models():
    return carried_deepseek()


def test_interop_roundtrip_and_init_shapes(models):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    ref = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    flat = interop.to_flat(tparams)
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k])
    assert {k.split("::")[1] for k in ref if k.startswith("mtp::")} == \
        {"proj", "layer"}
    # the port's init has the reference's tree and shapes
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jmodel.init, jax.random.key(7)))
    own = interop.to_flat(tmodel.init(7, "cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {_path(p): v.shape for p, v in leaves}
    assert ttf.runs_of(tcfg) == [("attn", "dense", 1), ("attn", "moe", 2)]
    # the latent pools carry across by path too (the reference's cache
    # also holds a block-table placeholder the port passes per call)
    jcache = jmodel.init_paged_cache(5, 8, 3, 2)
    tcache = tmodel.init_paged_cache(5, 8)
    assert {k: v.shape for k, v in interop.to_flat(tcache).items()} == \
        {k: np.asarray(v).shape for k, v in _flatten(jcache).items()
         if not k.endswith("block_tables")}


def test_paged_spec_kernel_spec_and_loss(models):
    tmodel, tparams = models[4:]
    spec = tmodel.paged_spec
    assert spec.has_blocks and not spec.has_state and spec.width1_mixed
    assert spec.reclaim_window == 0
    named = dict(spec.kernel_spec)
    assert named["attn"] == "mla_decode_views/mla_decode_paged"
    wrappers = {fn.__name__ for fn in kernels.KERNELS}
    assert {n for ops in named.values() for n in ops.split("/")} <= wrappers
    # the loss carries the reference's aux and MTP terms
    # (tests/test_torch_trainer.py holds them and the gradient to jax)
    loss, m = tmodel.loss(tparams, {"tokens": torch.arange(8)[None] % 7})
    assert set(m) == {"ce", "aux", "mtp_ce", "loss"}
    assert float(m["aux"]) > 0 and torch.isfinite(loss)
    assert float(loss) == float(m["ce"] + m["aux"] + ttf.MTP_WEIGHT
                                * m["mtp_ce"])


def test_engine_keeps_a_resident_tree():
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    moved = _to_device(tree, torch.device("cpu"))
    assert moved["a"] is tree["a"] and moved["b"]["c"] is tree["b"]["c"]


def test_forward_matches_in_both_moe_forms(models):
    """The full-sequence forward at the training capacity (the
    reference's ``forward``) and dropless (its ``prefill``)."""
    jcfg, _, jparams, _, tmodel, tparams = models
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 13))
    want, _, _, _ = jtf.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                jcfg)
    got, _, _, _ = tmodel.forward(tparams, torch.tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, _ = jtf.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                          cache_len=13)
    got, _, _, _ = tmodel.forward(tparams, torch.tensor(tokens), dropless=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


NB, BS = 17, 8


def _pools(jcfg, seed):
    """Identical random latent pools (garbage everywhere, as a served pool
    holds) for both frameworks."""
    rng = np.random.default_rng(seed)
    jc, tc = {}, {}
    for i, (_, _, n) in enumerate(jtf.runs_of(jcfg)):
        arrs = {name: rng.standard_normal((n, NB, BS, w)).astype(np.float32)
                for name, w in (("ckv", jcfg.mla.kv_lora_rank),
                                ("krope", jcfg.mla.qk_rope_head_dim))}
        jc[f"run_{i}"] = {k: jnp.asarray(v) for k, v in arrs.items()}
        jc[f"run_{i}"]["block_tables"] = jnp.zeros((n, 0, 0), jnp.int32)
        tc[f"run_{i}"] = {k: torch.tensor(v) for k, v in arrs.items()}
    return jc, tc


def _assert_pools_equal(jcache, tcache):
    for run, rc in tcache.items():
        for name, leaf in rc.items():
            np.testing.assert_allclose(leaf.numpy()[:, 1:],
                                       np.asarray(jcache[run][name])[:, 1:],
                                       **TOL)


def test_paged_step_and_decode_loop_match(models):
    jcfg, _, jparams, _, tmodel, tparams = models
    rng = np.random.default_rng(2)
    jcache, tcache = _pools(jcfg, 3)
    jslot = jnp.zeros((6,), jnp.int32)
    tslot = torch.zeros((6,), dtype=torch.int32)
    v = jcfg.vocab_size
    jstep = jax.jit(functools.partial(jtf.paged_step, cfg=jcfg))

    def step(tokens, bt, meta):
        nonlocal jcache, jslot
        jt, jslot, jcache = jstep(jparams, jcache, jslot, jnp.asarray(tokens),
                                  jnp.asarray(bt), jnp.asarray(meta))
        tt, _, _ = tmodel.paged_step(tparams, tcache, tslot,
                                     torch.tensor(tokens), torch.tensor(bt),
                                     torch.tensor(meta))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        _assert_pools_equal(jcache, tcache)

    # 1) prefill: chunk-wide rows; row 1 ragged, row 2 padding
    step(rng.integers(0, v, (3, 12)).astype(np.int32),
         np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32),
         np.array([[0, 0, 0], [12, 7, 0], [-1, -1, -1], [0, 1, -1],
                   [0, 0, 0], [0, 1, 2]], np.int32))
    # 2) a mixed width-1 step: two decode rows wired from the slot buffer,
    #    a 3-token prompt as one row per token, one padding row
    tokens = np.zeros((6, 1), np.int32)
    tokens[2:5, 0] = rng.integers(0, v, (3,))
    step(tokens,
         np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0],
                   [7, 0, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32),
         np.array([[12, 7, 0, 1, 2, 0], [1, 1, 1, 1, 1, 0],
                   [0, 1, -1, -1, -1, -1], [0, 1, -1, -1, 2, -1],
                   [0] * 6, [0, 1, 2, 2, 2, 0]], np.int32))

    # 3) the N-step loop: row 2's table ends at block 7, so the capacity
    #    predicate stops it at position 8; row 0 stops on a planted eos
    bt = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0],
                   [0, 0, 0, 0]], np.int32)
    n = 6
    jloop = jax.jit(functools.partial(jtf.paged_decode_loop, cfg=jcfg,
                                      num_steps=n))

    def loop(eos0):
        meta = np.array([[13, 8, 3, 0], [6, 4, 6, 0], [0, 1, 2, 0],
                         [0] * 4, [0, 1, 2, 0], [eos0, -1, -1, -1]],
                        np.int32)
        jout = jloop(jparams, jcache, jslot, jnp.asarray(bt),
                     jnp.asarray(meta))
        tout = tmodel.paged_decode_loop(
            tparams, {run: {k: t.clone() for k, t in rc.items()}
                      for run, rc in tcache.items()},
            tslot.clone(), torch.tensor(bt), torch.tensor(meta),
            num_steps=n)
        for j, t in zip(jout[:4], tout[:4]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        _assert_pools_equal(jout[4], tout[4])
        return [np.asarray(x) for x in jout[:3]]

    out, counts, eos_hit = loop(-1)
    np.testing.assert_array_equal(counts, [6, 4, 5, 0])
    assert not eos_hit.any()
    out, counts, eos_hit = loop(int(out[0, 2]))
    assert counts[0] <= 3 and eos_hit[0]


# ---------------------------------------------------------------------------
# the Engine against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's token streams over the shared workload, depth 1,
    on the wide pool, for each attn_impl and sampling mode."""
    jcfg, _, jparams = models[:3]
    work = _workload(jcfg.vocab_size)
    out = {}
    for impl in ("naive", "pallas"):
        jmodel = jax_build_model(jcfg.replace(attn_impl=impl))
        for mode, kw in (("greedy", {}), ("sampled", SAMPLED)):
            eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**WIDE, **kw))
            res = eng.run([JaxRequest(prompt=p.copy(), max_new_tokens=g,
                                      rid=i)
                           for i, (p, g) in enumerate(work)])
            out[impl, mode] = [res[i].tokens for i in range(len(work))]
            jax.clear_caches()
    return work, out


def _run_port(tmodel, tparams, work, *, spd, sample, force_every=0):
    """The port's Engine over ``work`` on the wide pool; with
    ``force_every`` the most recent live sequence is preempted after
    every that many steps (in-flight steps flushed first)."""
    eng = Engine(tmodel, tparams, EngineConfig(steps_per_dispatch=spd,
                                               **WIDE, **sample),
                 device="cpu")
    eng.warmup()
    for i, (p, g) in enumerate(work):
        eng.submit(Request(prompt=p.copy(), max_new_tokens=g, rid=i))
    results, forced, steps = {}, 0, 0
    while eng.has_work:
        done = eng.step()
        steps += 1
        if force_every and steps % force_every == 0:
            eng._flush(done)
            forced += eng._preempt_one(exclude_rid=-1)
        for res in done:
            results[res.rid] = res
    counters = eng.metrics_snapshot()["counters"]
    return [results[i].tokens for i in range(len(work))], counters, forced


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("sample", ["greedy", "sampled"])
@pytest.mark.parametrize("spd", [1, 8])
def test_engine_token_identical_to_jax_engine(models, jax_streams, spd,
                                              sample, forced):
    tmodel, tparams = models[4:]
    work, want = jax_streams
    before = kernels.launch_counts()
    got, counters, n_forced = _run_port(
        tmodel, tparams, work, spd=spd,
        sample=SAMPLED if sample == "sampled" else {},
        force_every=3 if forced else 0)
    for impl in ("naive", "pallas"):
        assert got == want[impl, sample], impl
    assert counters["generated_tokens"] == sum(g for _, g in work)
    assert counters["jit_compiles"] == 0
    if forced:
        assert n_forced > 0 and counters["preemptions"] >= n_forced
    if spd > 1:
        assert counters["loop_dispatches"] > 0
    # CPU tensors take the plain versions, which count no launch
    assert kernels.launch_counts() == before
