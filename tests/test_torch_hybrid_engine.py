"""The port's RG-LRU hybrid (recurrentgemma's smoke variant: rglru,
rglru, local_attn over a 64-token window, 4 query heads over one kv
head, a gelu MLP) against the JAX package on carried-across weights: the
forward logits and the loss; the non-paged ``prefill`` / ``decode_step`` under
``attn_impl`` naive, blocked and pallas (8 greedy steps, one cache
past the window so the local layers' ring wraps); ``paged_step`` and
``paged_decode_loop`` over block pools and state slots together; and the
``Engine`` token-identical to the JAX engine at dispatch depths 1 and 8,
greedy and at temperature 0.8 / top-k 20, with prompts past the window
(dead blocks reclaimed as the JAX engine reclaims them) and with forced
preemption.  The JAX engine runs at ``"naive"`` (jnp) and at
``"pallas"`` (its kernels in interpret mode), in a module fixture.

Tolerances: float32 on the CPU; logits, caches and pools within
atol/rtol 1e-4 (trash block 0 and trash slot 0 left out: rows that must
not write all land there, and which one wins is defined in neither
package); tokens, counts and flags exactly equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.configs.base import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.models.model import build_model as jax_build_model
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro_torch import interop
from repro_torch.configs import available_archs, get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.serve import Engine, EngineConfig, Request
from test_torch_rglru import rglru_configs
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
SAMPLED = dict(temperature=0.8, top_k=20, seed=3)
# 8-token blocks, sequences up to 128 tokens: prompts past the 64-token
# window reclaim their dead blocks
HYB = dict(max_batch=3, block_size=8, num_blocks=65, max_seq_len=128,
           prefill_chunk=16, prefill_token_budget=24)
PERTURBED = ("scale", "lam", "b_r", "b_i", "conv_b")


def carried_hybrid(seed=0):
    """(jax cfg, jax model, jax params, port cfg, port model, port
    params) for the smoke recurrentgemma, with Lambda, the gate and conv
    biases and the norm scales perturbed so that every param matters."""
    jcfg, tcfg = rglru_configs()
    jmodel = jax_build_model(jcfg)
    tree = jmodel.init(jax.random.key(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.split("::")[-1] in PERTURBED:
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [jnp.asarray(flat[k]) for k in _flatten(tree)])
    tparams = interop.from_flat(flat, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def models():
    return carried_hybrid()


def test_runs_interop_and_forward_logits(models):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    assert ttf.runs_of(tcfg) == [("rglru", "dense", 2),
                                 ("local_attn", "dense", 1)]
    ref = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    flat = interop.to_flat(tparams)
    assert flat.keys() == ref.keys()
    own = interop.to_flat(tmodel.init(7, "cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in ref.items()}
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 80))
    want, _, _, _ = jtf.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                jcfg)
    got, _, _, _ = tmodel.forward(tparams, torch.tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the hybrid trains through lm_loss: the reference's CE of these
    # logits, no aux term (tests/test_torch_trainer.py holds the
    # gradient to jax.grad)
    loss, metrics = tmodel.loss(tparams, {"tokens": torch.tensor(tokens)})
    w = np.asarray(want, np.float64)[:, :-1]
    z = w.max(-1) + np.log(np.exp(w - w.max(-1, keepdims=True)).sum(-1))
    ce = (z - np.take_along_axis(w, tokens[:, 1:, None], -1)[..., 0]).mean()
    assert set(metrics) == {"ce", "aux", "loss"} and float(metrics["aux"]) == 0
    np.testing.assert_allclose(float(loss), ce, rtol=1e-5)


def test_full_width_config_builds():
    cfg = get_config("recurrentgemma-2b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (26, 2560, 10, 1, 256, 7680, 256000)
    assert ttf.runs_of(cfg)[:3] == [("rglru", "dense", 2),
                                    ("local_attn", "dense", 1),
                                    ("rglru", "dense", 2)]
    assert sum(n for _, _, n in ttf.runs_of(cfg)) == 26
    spec = build_model(cfg).paged_spec
    assert (spec.has_blocks, spec.has_state, spec.reclaim_window) == \
        (True, True, 2048)


@pytest.mark.parametrize("arch", sorted(available_archs()))
def test_paged_spec_follows_the_reference(arch):
    """has_blocks, has_state and reclaim_window by the reference's rule,
    and a kernel entry for the same layer kinds, for every config the
    port registers."""
    model = build_model(get_config(arch))
    ref = jax_build_model(jax_get_config(arch))
    if model.paged_spec is None:      # no paged engine: resnet, whisper
        assert ref.paged_spec is None
        # static decode where the reference has it (whisper), else none
        assert (model.decode_step is not None) == ref.supports_decode
        return
    got, want = model.paged_spec, ref.paged_spec
    assert (got.has_blocks, got.has_state, got.reclaim_window) == \
        (want.has_blocks, want.has_state, want.reclaim_window)
    assert dict(got.kernel_spec).keys() == dict(want.kernel_spec).keys()


# ---------------------------------------------------------------------------
# the non-paged entry point
# ---------------------------------------------------------------------------

B, S, STEPS = 2, 60, 8
# room for every step (cut to the 64-token window: the ring wraps after
# 4 steps), and a cache shorter than the window
CACHE_LENS = {"window": S + STEPS, "short": 40}


def _run_static_jax(jcfg, jparams, tokens, cache_len):
    prefill = jax.jit(functools.partial(jtf.prefill, cfg=jcfg),
                      static_argnames=("cache_len",))
    decode = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(tokens)},
                            cache_len=cache_len)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    toks, steps = [np.asarray(tok[:, 0])], []
    for i in range(STEPS):
        lg, cache = decode(jparams, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        steps.append(np.asarray(lg))
        toks.append(np.asarray(tok[:, 0]))
    return np.asarray(logits), steps, np.stack(toks), cache


@pytest.mark.parametrize("ring", list(CACHE_LENS))
@pytest.mark.parametrize("impl", ["naive", "blocked", "pallas"])
def test_prefill_and_decode_steps_match(models, impl, ring):
    jcfg, _, jparams, tcfg, _, tparams = models
    blocks = dict(attn_impl=impl, attn_block_q=4, attn_block_kv=4)
    jcfg, tcfg = jcfg.replace(**blocks), tcfg.replace(**blocks)
    cache_len = CACHE_LENS[ring]
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S))
    wlogits, wsteps, wtoks, wcache = _run_static_jax(jcfg, jparams, tokens,
                                                     cache_len)
    logits, cache = ttf.prefill(tparams, torch.tensor(tokens), tcfg,
                                cache_len)
    np.testing.assert_allclose(logits.numpy(), wlogits, **TOL)
    sc = min(cache_len, tcfg.rglru.local_window)
    assert cache["run_1"]["k"].shape[2] == sc
    tok = logits[:, -1].argmax(-1)[:, None]
    toks = [tok[:, 0].numpy()]
    for i in range(STEPS):
        lg, cache = ttf.decode_step(tparams, cache, tok,
                                    torch.tensor(S + i), tcfg)
        np.testing.assert_allclose(lg.numpy(), wsteps[i], **TOL)
        tok = lg.argmax(-1)[:, None]
        toks.append(tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(toks), wtoks)
    assert cache.keys() == wcache.keys()
    for run, rc in cache.items():
        assert rc.keys() == wcache[run].keys()
        for k, v in rc.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(wcache[run][k]),
                                       **TOL)


# ---------------------------------------------------------------------------
# the fused step and the N-step loop over block pools and state slots
# ---------------------------------------------------------------------------

NB, BS, NS = 12, 8, 6            # blocks, block size, state slots


def _pools(jcfg, seed):
    """Identical random pools (garbage everywhere, as a served pool holds)
    for both frameworks: K/V blocks of the local-attention run, conv and
    h slots of the rglru run."""
    jc = jtf.init_paged_cache(jcfg, NB, BS, 3, 4, num_state_slots=NS)
    rng = np.random.default_rng(seed)
    arrs = {run: {k: rng.standard_normal(np.asarray(v).shape)
                  .astype(np.float32)
                  for k, v in rc.items() if k != "block_tables"}
            for run, rc in jc.items()}
    jcache = {run: dict(jc[run], **{k: jnp.asarray(v) for k, v in a.items()})
              for run, a in arrs.items()}
    return jcache, {run: {k: torch.tensor(v) for k, v in a.items()}
                    for run, a in arrs.items()}


def _assert_pools_equal(jcache, tcache):
    for run, rc in tcache.items():
        for name, leaf in rc.items():
            np.testing.assert_allclose(leaf.numpy()[:, 1:],
                                       np.asarray(jcache[run][name])[:, 1:],
                                       **TOL)


def test_paged_step_and_decode_loop_match(models):
    jcfg, _, jparams, _, tmodel, tparams = models
    rng = np.random.default_rng(4)
    jcache, tcache = _pools(jcfg, 5)
    jslot = jnp.zeros((5,), jnp.int32)
    tslot = torch.zeros((5,), dtype=torch.int32)
    v = jcfg.vocab_size
    jstep = jax.jit(functools.partial(jtf.paged_step, cfg=jcfg))
    tables = np.array([[1, 2, 7, 0], [3, 4, 8, 0], [5, 6, 9, 0],
                       [0, 0, 0, 0]], np.int32)

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

    # 1) prefill rows from pos 0 (their garbage slots must read as zeros):
    #    a 12-token prompt, a ragged 7-token one, a padding row
    step(rng.integers(0, v, (3, 12)).astype(np.int32), tables[[0, 1, 3]],
         np.array([[0, 0, 0], [12, 7, 0], [-1, -1, -1], [0, 1, -1],
                   [1, 2, 0], [0, 1, 2]], np.int32))
    # 2) the chunk-wide mixed layout: two decode rows at valid_len 1
    #    wired from the slot buffer, a 5-token prompt, a padding row
    tokens = np.zeros((4, 8), np.int32)
    tokens[2, :5] = rng.integers(0, v, (5,))
    step(tokens, tables,
         np.array([[12, 7, 0, 3], [1, 1, 5, 0], [0, 1, -1, -1],
                   [0, 1, 2, -1], [1, 2, 3, 0], [0, 1, 2, 3]], np.int32))
    # 3) a width-1 decode bucket
    step(np.zeros((4, 1), np.int32), tables,
         np.array([[13, 8, 5, 0], [1, 1, 1, 0], [0, 1, 2, -1],
                   [0, 1, 2, -1], [1, 2, 3, 0], [0, 1, 2, 3]], np.int32))

    # 4) the N-step loop: row 1 reaches the end of its table (the trash
    #    placeholder past block 3) and stops there; row 0 also stops on a
    #    planted eos
    n = 12
    jloop = jax.jit(functools.partial(jtf.paged_decode_loop, cfg=jcfg,
                                      num_steps=n))

    def loop(eos0):
        meta = np.array([[14, 9, 6, 0], [12, 12, 12, 0], [0, 1, 2, 0],
                         [1, 2, 3, 0], [0, 1, 2, 3], [eos0, -1, -1, -1]],
                        np.int32)
        jout = jloop(jparams, jcache, jslot, jnp.asarray(tables),
                     jnp.asarray(meta))
        tout = tmodel.paged_decode_loop(
            tparams, {run: {k: t.clone() for k, t in rc.items()}
                      for run, rc in tcache.items()},
            tslot.clone(), torch.tensor(tables), torch.tensor(meta),
            num_steps=n)
        for j, t in zip(jout[:4], tout[:4]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        _assert_pools_equal(jout[4], tout[4])
        return [np.asarray(x) for x in jout[:3]]

    out, counts, eos_hit = loop(-1)
    np.testing.assert_array_equal(counts, [10, 12, 12, 0])
    assert not eos_hit.any()
    out, counts, eos_hit = loop(int(out[0, 2]))
    assert counts[0] <= 3 and eos_hit[0]


# ---------------------------------------------------------------------------
# the Engine against the JAX engine
# ---------------------------------------------------------------------------


def _workload(vocab):
    """Six requests, four with prompts past the 64-token window."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (int(p),)).astype(np.int32), int(g))
            for p, g in zip((70, 9, 95, 66, 30, 81), rng.integers(4, 21, 6))]


def _reclaimed(eng) -> int:
    return int(eng.kv._m["reclaimed"].value)


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's streams over the workload at depth 1, for each
    attn_impl and sampling mode, and its reclaimed block count."""
    jcfg, _, jparams = models[:3]
    work = _workload(jcfg.vocab_size)
    out, reclaimed = {}, set()
    for impl in ("naive", "pallas"):
        jmodel = jax_build_model(jcfg.replace(attn_impl=impl))
        for mode, kw in (("greedy", {}), ("sampled", SAMPLED)):
            eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**HYB, **kw))
            res = eng.run([JaxRequest(prompt=p.copy(), max_new_tokens=g,
                                      rid=i)
                           for i, (p, g) in enumerate(work)])
            out[impl, mode] = [res[i].tokens for i in range(len(work))]
            reclaimed.add(_reclaimed(eng))
            jax.clear_caches()
    assert len(reclaimed) == 1
    return work, out, reclaimed.pop()


def _run_port(tmodel, tparams, work, *, spd, sample, force_every=0,
              max_forced=4):
    """The port's Engine over ``work``; with ``force_every`` the most
    recent live sequence is preempted after every that many steps
    (in-flight steps flushed first), whatever the pool holds, up to
    ``max_forced`` times: a prompt longer than the steps between two
    preemptions would otherwise never finish its prefill."""
    eng = Engine(tmodel, tparams, EngineConfig(steps_per_dispatch=spd,
                                               **HYB, **sample),
                 device="cpu")
    eng.warmup()
    for i, (p, g) in enumerate(work):
        eng.submit(Request(prompt=p.copy(), max_new_tokens=g, rid=i))
    results, forced, steps = {}, 0, 0
    while eng.has_work:
        done = eng.step()
        steps += 1
        if force_every and steps % force_every == 0 and forced < max_forced:
            eng._flush(done)
            forced += eng._preempt_one(exclude_rid=-1)
        for res in done:
            results[res.rid] = res
    assert eng.state_slots.num_free == eng.cfg.num_slots
    return ([results[i].tokens for i in range(len(work))],
            eng.metrics_snapshot()["counters"], forced, _reclaimed(eng))


@pytest.mark.parametrize("forced", [False, True], ids=["wide", "forced"])
@pytest.mark.parametrize("sample", ["greedy", "sampled"])
@pytest.mark.parametrize("spd", [1, 8])
def test_engine_token_identical_to_jax_engine(models, jax_streams, spd,
                                              sample, forced):
    tmodel, tparams = models[4:]
    work, want, jax_reclaimed = jax_streams
    got, counters, n_forced, reclaimed = _run_port(
        tmodel, tparams, work, spd=spd,
        sample=SAMPLED if sample == "sampled" else {},
        force_every=3 if forced else 0)
    for impl in ("naive", "pallas"):
        assert got == want[impl, sample], impl
    assert counters["generated_tokens"] == sum(g for _, g in work)
    assert reclaimed > 0
    if spd == 1 and not forced:
        assert reclaimed == jax_reclaimed
    if forced:
        assert n_forced > 0 and counters["preemptions"] >= n_forced
    if spd > 1:
        assert counters["loop_dispatches"] > 0


def test_engine_mixed_steps_use_chunk_wide_rows(models, jax_streams):
    """Recurrent state forbids width-1 mixed rows, block pools or not:
    every mixed step of the hybrid is chunk-wide."""
    tmodel, tparams = models[4:]
    work = jax_streams[0]
    eng = Engine(tmodel, tparams, EngineConfig(**HYB), device="cpu")
    assert not eng.spec.width1_mixed
    shapes = []
    real = eng.model.paged_step

    def spy(params, cache, slot_buf, tokens, *a, **kw):
        shapes.append(tuple(tokens.shape))
        return real(params, cache, slot_buf, tokens, *a, **kw)

    eng.model = dataclasses.replace(eng.model, paged_step=spy)
    eng.run([Request(prompt=p.copy(), max_new_tokens=g, rid=i)
             for i, (p, g) in enumerate(work)])
    ec = eng.cfg
    # on the CPU a one-row layout carries a padding row (Engine._rows)
    allowed = ({(eng._rows(b), 1) for b in ec.decode_buckets}
               | {(eng._rows(ec.prefill_rows), ec.prefill_chunk),
                  (ec.mixed_chunk_rows, ec.prefill_chunk)})
    assert set(shapes) <= allowed
    assert (ec.mixed_chunk_rows, ec.prefill_chunk) in shapes
