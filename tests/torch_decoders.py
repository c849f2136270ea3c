"""Checks shared by the CPU tests of the port's last four decoder configs
(``test_torch_minicpm.py``, ``test_torch_head_dim_120.py``,
``test_torch_dbrx.py``, ``test_torch_vlm.py``): each file carries one
smoke variant across from the JAX package and holds the port to it on
the same weights — the param tree by path, the full-sequence forward,
the non-paged ``prefill`` + greedy ``decode_step`` calls, ``paged_step``
and ``paged_decode_loop`` over K/V block pools, and the ``Engine``
token-identical to the JAX engine at dispatch depths 1 and 8.

Tolerances: float32 on the CPU; forward logits within atol/rtol 1e-5;
the cache paths' logits and the pools within 1e-4, as the other model
tests hold them (kernels' plain versions against the jnp forms, sums in
other orders over up to 8 steps); tokens, counts and flags exactly
equal.  The trash block 0 is left out of pool comparisons (rows that
must not write all land there; which one wins is defined in neither
package).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.models.model import build_model
from repro_torch.serve import Engine, EngineConfig, Request

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
SAMPLED = dict(temperature=0.8, top_k=20, seed=3)
DECODE_STEPS = 8
NB, BS = 17, 8                 # pool blocks, block size


def carried(arch, seed=0, from_port=False, **overrides):
    """(jax cfg, jax model, jax params, port cfg, port model, port
    params): ``arch``'s smoke variant (with ``overrides``) from the JAX
    package's init (or, ``from_port``, the port's, carried the other way:
    the JAX init of an MoE run takes seconds to compile on one core),
    norm scales perturbed so that every param matters, carried to the
    other tree by path (``interop``)."""
    jcfg = jax_smoke_variant(jax_get_config(arch)).replace(**overrides)
    tcfg = smoke_variant(get_config(arch)).replace(**overrides)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    if from_port:
        flat = interop.to_flat(tmodel.init(seed, "cpu"))
    else:
        flat = {k: np.asarray(v) for k, v in
                _flatten(jmodel.init(jax.random.key(seed))).items()}
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.split("::")[-1] == "scale":
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(seed))
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(flat[k]) for k in _flatten(shapes)])
    tparams = interop.from_flat(flat, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def check_interop(models):
    """The carried tree equals the JAX one leaf for leaf, and the port's
    own init has the reference's paths and shapes.  Returns the paths."""
    jcfg, _, jparams, tcfg, tmodel, tparams = models
    ref = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    flat = interop.to_flat(tparams)
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k])
    own = interop.to_flat(tmodel.init(7, "cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in ref.items()}
    return set(ref)


def check_forward(models, tokens, image=None):
    """Full-sequence logits (and the final hidden states) of ``tokens``
    (B, S) numpy, with an image prefix (B, Si, D) when given."""
    jcfg, _, jparams, _, tmodel, tparams = models
    batch = {"tokens": jnp.asarray(tokens)}
    if image is not None:
        batch["image_embeds"] = jnp.asarray(image)
    want, _, _, wh = jtf.forward(jparams, batch, jcfg)
    got, _, _, gh = tmodel.forward(
        tparams, torch.from_numpy(tokens),
        image_embeds=None if image is None else torch.from_numpy(image))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **FWD_TOL)


def jax_static(models, tokens, cache_len, image=None):
    """The reference's non-paged path: ``prefill`` (with the image
    prefix) then DECODE_STEPS greedy ``decode_step`` calls.  Returns
    (prefill logits, step logits, tokens (steps + 1, B))."""
    jcfg, _, jparams = models[:3]
    prefill = jax.jit(functools.partial(jtf.prefill, cfg=jcfg),
                      static_argnames=("cache_len",))
    decode = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    batch = {"tokens": jnp.asarray(tokens)}
    if image is not None:
        batch["image_embeds"] = jnp.asarray(image)
    logits, cache = prefill(jparams, batch, cache_len=cache_len)
    start = logits.shape[1]
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    toks, steps = [np.asarray(tok[:, 0])], []
    for i in range(DECODE_STEPS):
        lg, cache = decode(jparams, cache, tok, jnp.int32(start + i))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        steps.append(np.asarray(lg))
        toks.append(np.asarray(tok[:, 0]))
    return np.asarray(logits), steps, np.stack(toks)


def check_static(models, want, tokens, cache_len, impl, image=None):
    """The port's ``prefill`` + greedy ``decode_step`` under ``impl``
    (``"pallas"``: kernels 6 and 7, their plain versions on the CPU)
    against ``jax_static``'s ``want``."""
    tcfg, tparams = models[3], models[5]
    model = build_model(tcfg.replace(attn_impl=impl))
    wlogits, wsteps, wtoks = want
    logits, cache = model.prefill(
        tparams, torch.from_numpy(tokens), cache_len=cache_len,
        image_embeds=None if image is None else torch.from_numpy(image))
    np.testing.assert_allclose(logits.numpy(), wlogits, **TOL)
    start = logits.shape[1]
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    toks = [tok[:, 0].numpy()]
    for i in range(DECODE_STEPS):
        lg, cache = model.decode_step(tparams, cache, tok,
                                      torch.tensor(start + i))
        np.testing.assert_allclose(lg.numpy(), wsteps[i], **TOL)
        tok = lg.argmax(-1)[:, None].to(torch.int32)
        toks.append(tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(toks), wtoks)


def _pools(jcfg, seed):
    """Identical random K/V pools (garbage everywhere, as a served pool
    holds) for both frameworks, per run."""
    rng = np.random.default_rng(seed)
    jc, tc = {}, {}
    for i, (_, _, n) in enumerate(jtf.runs_of(jcfg)):
        shape = (n, NB, BS, jcfg.num_kv_heads, jcfg.head_dim)
        arrs = {name: rng.standard_normal(shape).astype(np.float32)
                for name in ("k", "v")}
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


def check_paged_step_and_loop(models):
    """A prefill step of chunk-wide rows (one ragged, one padding), a
    mixed width-1 step wired from the slot buffer, then the N-step loop
    (a row stopped by its table's capacity, one by a planted eos), all
    against the reference's ``paged_step`` / ``paged_decode_loop``."""
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

    step(rng.integers(0, v, (3, 12)).astype(np.int32),
         np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32),
         np.array([[0, 0, 0], [12, 7, 0], [-1, -1, -1], [0, 1, -1],
                   [0, 0, 0], [0, 1, 2]], np.int32))
    tokens = np.zeros((6, 1), np.int32)
    tokens[2:5, 0] = rng.integers(0, v, (3,))
    step(tokens,
         np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0],
                   [7, 0, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32),
         np.array([[12, 7, 0, 1, 2, 0], [1, 1, 1, 1, 1, 0],
                   [0, 1, -1, -1, -1, -1], [0, 1, -1, -1, 2, -1],
                   [0] * 6, [0, 1, 2, 2, 2, 0]], np.int32))

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


def jax_engine_streams(models, work, ecfg, modes=("greedy",)):
    """The JAX engine's streams over ``work`` at depth 1 (jnp attention),
    one run per sampling mode, and its reclaimed block counts."""
    jcfg, jmodel, jparams = models[:3]
    out = {}
    for mode in modes:
        kw = SAMPLED if mode == "sampled" else {}
        eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**ecfg, **kw))
        res = eng.run([JaxRequest(prompt=p.copy(), max_new_tokens=g, rid=i)
                       for i, (p, g) in enumerate(work)])
        out[mode] = ([res[i].tokens for i in range(len(work))],
                     int(eng.kv._m["reclaimed"].value))
        jax.clear_caches()
    return out


def check_engine(models, work, ecfg, want, *, spd, mode="greedy"):
    """The port's Engine over ``work`` at dispatch depth ``spd`` equals
    the JAX engine's streams ``want[mode]`` token for token; at depth 1
    it reclaims as many blocks (deeper dispatches free dead blocks at
    other steps), at depth 8 some where the JAX engine freed any.  CPU
    tensors take the kernels' plain versions, which count no launch."""
    tmodel, tparams = models[4:]
    before = kernels.launch_counts()
    eng = Engine(tmodel, tparams,
                 EngineConfig(steps_per_dispatch=spd, **ecfg,
                              **(SAMPLED if mode == "sampled" else {})),
                 device="cpu")
    res = eng.run([Request(prompt=p.copy(), max_new_tokens=g, rid=i)
                   for i, (p, g) in enumerate(work)])
    streams, reclaimed = want[mode]
    assert [res[i].tokens for i in range(len(work))] == streams
    got = int(eng.kv._m["reclaimed"].value)
    assert got == reclaimed if spd == 1 else (got > 0) == (reclaimed > 0)
    counters = eng.metrics_snapshot()["counters"]
    assert counters["generated_tokens"] == sum(g for _, g in work)
    if spd > 1:
        assert counters["loop_dispatches"] > 0
    assert kernels.launch_counts() == before
