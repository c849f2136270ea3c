"""The port's mamba (ssm) family against the JAX package on carried-across
weights: params and init shapes, ``paged_step`` and ``paged_decode_loop``
over slot-state pools, the stale-row guard, and the ``Engine``
token-identical to the JAX engine at dispatch depths 1 and 8, greedy and
at temperature 0.8 / top-k 20, with pool-starvation preemption and with
forced mid-generation preemption, against the JAX engine at
``attn_impl="naive"`` (jnp) and ``"pallas"`` (its slot-state and sampling
kernels, interpret mode).

Tolerances: float32 on the CPU; tokens, counts and flags exactly equal;
slot pools within atol/rtol 1e-4, trash slot 0 left out (rows that must
not write all land there; which one wins is unspecified in both
packages).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.models import transformer as jtf
from repro.models.model import build_model as jax_build_model
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro_torch import interop, kernels
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.serve import Engine, EngineConfig, Request
from test_torch_engine import SMALL, WIDE, _workload
from test_torch_ssm import mamba_configs
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
SAMPLED = dict(temperature=0.8, top_k=20, seed=3)


def carried_mamba(seed=0):
    """(jax cfg, jax model, jax params, port cfg, port model, port
    params) for the tiny mamba, with random norm scales, D, dt bias and
    conv bias so every param matters."""
    jcfg, tcfg = mamba_configs()
    jmodel = jax_build_model(jcfg)
    tree = jmodel.init(jax.random.key(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.split("::")[-1] in ("scale", "D", "dt_bias", "conv_b"):
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [jnp.asarray(flat[k]) for k in _flatten(tree)])
    tparams = interop.from_flat(flat, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def models():
    return carried_mamba()


def test_interop_roundtrip_and_init_shapes(models):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    ref = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    flat = interop.to_flat(tparams)
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k])
    ssm = {k.split("::", 3)[-1] for k in ref if "::ssm::" in k}
    assert ssm == {"in_proj", "out_proj", "conv_w", "conv_b", "dt_bias",
                   "A_log", "D", "norm::scale"}
    own = interop.to_flat(tmodel.init(7, "cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert ttf.runs_of(tcfg) == [("ssm", "none", 2)]
    # the slot-state cache leaves carry across by path too
    jcache = jmodel.init_paged_cache(5, 8, 3, 2, num_state_slots=4)
    tcache = tmodel.init_paged_cache(5, 8, num_state_slots=4)
    assert {k: v.shape for k, v in interop.to_flat(tcache).items()} == \
        {k: np.asarray(v).shape for k, v in _flatten(jcache).items()}
    back = interop.from_flat({k: np.asarray(v) + 1.0
                              for k, v in _flatten(jcache).items()})
    assert torch.equal(back["run_0"]["state"],
                       torch.ones_like(tcache["run_0"]["state"]))


def test_paged_spec_and_kernel_spec(models):
    spec = models[4].paged_spec
    assert not spec.has_blocks and spec.has_state and not spec.width1_mixed
    assert spec.reclaim_window == 0
    named = dict(spec.kernel_spec)
    assert named["ssm"] == "slot_gather/slot_scatter"
    wrappers = {fn.__name__ for fn in kernels.KERNELS}
    assert {n for ops in named.values() for n in ops.split("/")} <= wrappers


NS = 6                       # state slots (slot 0 the trash)


def _pools(jcfg, seed):
    """Identical random slot pools (garbage everywhere, as a served pool
    holds) for both frameworks."""
    jc = jtf.init_paged_cache(jcfg, 5, 8, 3, 2, num_state_slots=NS)
    rng = np.random.default_rng(seed)
    arrs = {k: rng.standard_normal(np.asarray(v).shape).astype(np.float32)
            for k, v in jc["run_0"].items()}
    return ({"run_0": {k: jnp.asarray(v) for k, v in arrs.items()}},
            {"run_0": {k: torch.tensor(v) for k, v in arrs.items()}})


def _assert_pools_equal(jcache, tcache):
    for name, leaf in tcache["run_0"].items():
        np.testing.assert_allclose(leaf.numpy()[:, 1:],
                                   np.asarray(jcache["run_0"][name])[:, 1:],
                                   **TOL)


def test_paged_step_and_decode_loop_match(models):
    jcfg, _, jparams, _, tmodel, tparams = models
    rng = np.random.default_rng(2)
    jcache, tcache = _pools(jcfg, 3)
    jslot = jnp.zeros((5,), jnp.int32)
    tslot = torch.zeros((5,), dtype=torch.int32)
    v = jcfg.vocab_size
    jstep = jax.jit(functools.partial(jtf.paged_step, cfg=jcfg))

    def step(tokens, meta):
        nonlocal jcache, jslot
        bt = np.zeros((tokens.shape[0], 1), np.int32)   # no block pools
        jt, jslot, jcache = jstep(jparams, jcache, jslot, jnp.asarray(tokens),
                                  jnp.asarray(bt), jnp.asarray(meta))
        tt, _, _ = tmodel.paged_step(tparams, tcache, tslot,
                                     torch.tensor(tokens), torch.tensor(bt),
                                     torch.tensor(meta))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        _assert_pools_equal(jcache, tcache)

    # 1) prefill rows from pos 0 (their garbage slots must read as
    #    zeros): a 12-token prompt, a ragged 7-token one, a padding row
    tokens = rng.integers(0, v, (3, 12)).astype(np.int32)
    step(tokens, np.array([[0, 0, 0], [12, 7, 0], [-1, -1, -1],
                           [0, 1, -1], [1, 2, 0], [0, 1, 2]], np.int32))
    # 2) the chunk-wide mixed layout: two decode rows at valid_len 1
    #    wired from the slot buffer, a 5-token prompt, a padding row
    tokens = np.zeros((4, 8), np.int32)
    tokens[2, :5] = rng.integers(0, v, (5,))
    step(tokens, np.array([[12, 7, 0, 3], [1, 1, 5, 0], [0, 1, -1, -1],
                           [0, 1, 2, -1], [1, 2, 3, 0], [0, 1, 2, 3]],
                          np.int32))
    # 3) a width-1 decode bucket
    step(np.zeros((4, 1), np.int32),
         np.array([[13, 8, 5, 0], [1, 1, 1, 0], [0, 1, 2, -1],
                   [0, 1, 2, -1], [1, 2, 3, 0], [0, 1, 2, 3]], np.int32))

    # 4) the N-step loop: step budgets alone stop the rows (no block
    #    tables on the device); row 0 also stops on a planted eos
    n = 6
    jloop = jax.jit(functools.partial(jtf.paged_decode_loop, cfg=jcfg,
                                      num_steps=n))

    def loop(eos0):
        meta = np.array([[14, 9, 6, 0], [6, 4, 3, 0], [0, 1, 2, 0],
                         [1, 2, 3, 0], [0, 1, 2, 3], [eos0, -1, -1, -1]],
                        np.int32)
        bt = np.zeros((4, 1), np.int32)
        jout = jloop(jparams, jcache, jslot, jnp.asarray(bt),
                     jnp.asarray(meta))
        tout = tmodel.paged_decode_loop(
            tparams, {"run_0": {k: t.clone() for k, t in
                                tcache["run_0"].items()}},
            tslot.clone(), torch.tensor(bt), torch.tensor(meta),
            num_steps=n)
        for j, t in zip(jout[:4], tout[:4]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        _assert_pools_equal(jout[4], tout[4])
        return [np.asarray(x) for x in jout[:3]]

    out, counts, eos_hit = loop(-1)
    np.testing.assert_array_equal(counts, [6, 4, 3, 0])
    assert not eos_hit.any()
    out, counts, eos_hit = loop(int(out[0, 2]))
    assert counts[0] <= 3 and eos_hit[0]


def test_stale_row_cannot_advance_live_recurrent_state(models):
    """A padded or stale row (valid_len 0) whose state_slot still points
    at a live sequence's slot, with a stale nonzero pos, leaves that
    slot's conv window and SSD state untouched and does not change the
    live row's token (the reference's ``tests/test_serve.py`` case)."""
    jcfg, _, _, _, tmodel, tparams = models
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, jcfg.vocab_size, (6,)).astype(np.int32)

    def run(stale_slot):
        cache = tmodel.init_paged_cache(5, 8, num_state_slots=3)
        slot_buf = torch.zeros((3,), dtype=torch.int32)
        tables = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
        tokens = torch.zeros((2, 8), dtype=torch.int32)
        tokens[0, :6] = torch.from_numpy(prompt)
        meta = torch.tensor([[0, 0], [6, 0], [-1, -1], [0, -1], [1, 0],
                             [0, 0]], dtype=torch.int32)
        toks, _, _ = tmodel.paged_step(tparams, cache, slot_buf, tokens,
                                       tables, meta)
        tokens = torch.tensor([[int(toks[0])], [7]], dtype=torch.int32)
        meta = torch.tensor([[6, 3], [1, 0], [-1, -1], [0, -1],
                             [1, 1 if stale_slot else 0], [0, 0]],
                            dtype=torch.int32)
        toks, _, _ = tmodel.paged_step(tparams, cache, slot_buf, tokens,
                                       tables, meta)
        return toks, cache

    toks_stale, cache_stale = run(stale_slot=True)
    toks_clean, cache_clean = run(stale_slot=False)
    assert int(toks_stale[0]) == int(toks_clean[0])
    for leaf in cache_clean["run_0"]:
        assert torch.equal(cache_stale["run_0"][leaf][:, 1:],
                           cache_clean["run_0"][leaf][:, 1:])


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


def _run_port(tmodel, tparams, work, *, spd, ecfg, sample, force_every=0):
    """The port's Engine over ``work``; with ``force_every`` the most
    recent live sequence is preempted after every that many steps
    (in-flight steps flushed first), whatever the pool holds."""
    eng = Engine(tmodel, tparams, EngineConfig(steps_per_dispatch=spd,
                                               **ecfg, **sample),
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
    assert eng.state_slots.num_free == eng.cfg.num_slots
    gauge = eng.telemetry.registry.gauge("engine_state_slots_free",
                                         replica=0, arch=tmodel.cfg.name)
    assert gauge.value == eng.cfg.num_slots
    return [results[i].tokens for i in range(len(work))], counters, forced


@pytest.mark.parametrize("mode", ["wide", "starved", "forced"])
@pytest.mark.parametrize("sample", ["greedy", "sampled"])
@pytest.mark.parametrize("spd", [1, 8])
def test_engine_token_identical_to_jax_engine(models, jax_streams, spd,
                                              sample, mode):
    tmodel, tparams = models[4:]
    work, want = jax_streams
    got, counters, forced = _run_port(
        tmodel, tparams, work, spd=spd,
        ecfg=SMALL if mode == "starved" else WIDE,
        sample=SAMPLED if sample == "sampled" else {},
        force_every=3 if mode == "forced" else 0)
    for impl in ("naive", "pallas"):
        assert got == want[impl, sample], impl
    assert counters["generated_tokens"] == sum(g for _, g in work)
    if mode == "starved":
        assert counters["preemptions"] > 0
    if mode == "forced":
        assert forced > 0 and counters["preemptions"] >= forced
    if spd > 1:
        assert counters["loop_dispatches"] > 0


def test_engine_mixed_steps_use_chunk_wide_rows(models, jax_streams):
    """A slot-state family never splits a prefill chunk into width-1
    rows: every mixed step is (max_batch + prefill_rows) chunk-wide rows,
    and the engine goes through the slot kernels' wrappers."""
    tmodel, tparams = models[4:]
    work, _ = jax_streams
    eng = Engine(tmodel, tparams, EngineConfig(**WIDE), device="cpu")
    shapes = []
    real = eng.model.paged_step

    def spy(params, cache, slot_buf, tokens, *a, **kw):
        shapes.append(tuple(tokens.shape))
        return real(params, cache, slot_buf, tokens, *a, **kw)

    eng.model = dataclasses.replace(eng.model, paged_step=spy)
    before = kernels.launch_counts()
    eng.run([Request(prompt=p.copy(), max_new_tokens=g, rid=i)
             for i, (p, g) in enumerate(work)])
    ec = eng.cfg
    # on the CPU a one-row layout carries a padding row (Engine._rows)
    allowed = ({(eng._rows(b), 1) for b in ec.decode_buckets}
               | {(eng._rows(ec.prefill_rows), ec.prefill_chunk),
                  (ec.mixed_chunk_rows, ec.prefill_chunk)})
    assert set(shapes) <= allowed
    assert (ec.mixed_chunk_rows, ec.prefill_chunk) in shapes
    # CPU tensors take the plain versions, which count no launch
    assert kernels.launch_counts() == before
