"""Tensor-parallel serving replicas on the port, on the CPU, against the
JAX package (``tests/test_serve_tp.py``'s cases): an ``Engine`` over a
slice of two devices (``("cpu", "cpu")``: two shards in one process)
gives tokens identical to the reference's sequential dense decode
(``_sequential_greedy``, and ``_sequential_sample`` at temperature 0.8
keyed by rid) at dispatch depths 1 and 8, for tiny qwen2 (GQA), the
smoke deepseek (MLA + expert-parallel MoE with a shared expert), mamba2
(heads split, the gated norm's sum of squares across shards), the
recurrentgemma hybrid (RG-LRU channels with the gathered ``xr``, MQA
local attention whose one kv head every shard reads) and dbrx (GQA +
MoE); also under forced preemption, and as ``ServeCluster`` replicas of
widths 2 + 2 and 3 + 1 (a 3-way slice of tiny qwen2 divides none of its
modules: everything stays whole on shard 0).  Each family's weights
come from the port's init, norm scales perturbed, carried to the JAX
tree by path; its JAX references are built once in a module fixture.

The plan itself is held leaf by leaf against the reference's
``sharding.serve_param_pspecs`` / ``serve_cache_pspecs`` on a 2-device
mesh (one subprocess, ``XLA_FLAGS`` forcing the CPU device count), each
shard's index ranges against the reference's even split of the same
axis; ``DEVIATIONS`` lists every leaf where the port's plan is not the
reference's, and ``GATHERED`` the products whose split agrees but whose
input the slice gathers first.

Tolerances: tokens exactly equal (float32 on the CPU); shard parts equal
to the full leaves' slices bit for bit.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models.model import build_model as jax_build_model
from repro_torch import interop, sharding
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import MLAConfig
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.serve import Engine, EngineConfig, Request, ServeCluster
from test_serve import _family_config, _sequential_greedy
from test_serve_decode_loop import _sequential_sample, _tiny_qwen2
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen2", "deepseek", "mamba", "rglru", "dbrx")
TP2 = (torch.device("cpu"),) * 2
# tests/test_serve_tp.py's engine
ECFG = dict(max_batch=3, block_size=8, num_blocks=65, max_seq_len=64,
            prefill_chunk=16, prefill_token_budget=24)
# its preemption case: a pool too small for every row's reservation
SMALL = dict(max_batch=3, block_size=4, num_blocks=10, max_seq_len=32,
             prefill_chunk=8, prefill_token_budget=16, steps_per_dispatch=8)
TEMP = 0.8

# where the port's plan is not the reference's at tp 2, by family and
# leaf (param paths, and "cache/<run>/<leaf>"): mamba's in_proj and its
# conv's channels are [z | x | B | C | dt] / [x | B | C] with B and C
# shared by every head (one group), so a shard holds its heads' z, x
# and dt and all of B and C where the reference splits the columns
# evenly through them; the hybrid's local attention has one kv head,
# whose columns the reference splits in two and every port shard holds
# whole (each shard's query heads read all of it)
DEVIATIONS = {
    ("mamba", "layers/run_0/ssm/in_proj"),
    ("mamba", "layers/run_0/ssm/conv_w"),
    ("mamba", "layers/run_0/ssm/conv_b"),
    ("mamba", "cache/run_0/conv"),
    ("rglru", "layers/run_1/attn/wk"),
    ("rglru", "layers/run_1/attn/wv"),
}
# split as the reference splits them, by output columns, but each shard's
# gates read the whole post-conv xr: the slice gathers it first
GATHERED = {("rglru", "layers/run_0/rglru/w_r"),
            ("rglru", "layers/run_0/rglru/w_i")}


def configs(family):
    """(JAX config, port config) of a family's smoke variant, as
    ``tests/test_serve_tp.py`` serves it (dbrx: ``test_torch_dbrx``'s,
    at 2 kv heads)."""
    if family == "qwen2":
        jcfg = _tiny_qwen2()
        tcfg = smoke_variant(get_config("qwen2-1.5b")).replace(
            mtp_depth=0, num_layers=2, d_model=64, d_ff=128, vocab_size=128,
            num_heads=2, num_kv_heads=2, head_dim=32)
    elif family == "dbrx":
        jcfg = jax_smoke_variant(jax_get_config("dbrx-132b")).replace(
            num_kv_heads=2)
        tcfg = smoke_variant(get_config("dbrx-132b")).replace(
            num_kv_heads=2)
    else:
        jcfg = _family_config(family)
        arch = {"deepseek": "deepseek-v3-671b", "mamba": "mamba2-370m",
                "rglru": "recurrentgemma-2b"}[family]
        tcfg = smoke_variant(get_config(arch)).replace(
            **{k: getattr(jcfg, k) for k in (
                "num_layers", "d_model", "vocab_size", "num_heads",
                "num_kv_heads", "head_dim", "d_ff", "mtp_depth")})
        for sub in ("moe", "ssm", "rglru"):
            if getattr(jcfg, sub) is not None:
                tcfg = tcfg.replace(**{sub: dataclasses.replace(
                    getattr(tcfg, sub), **dataclasses.asdict(
                        getattr(jcfg, sub)))})
        if jcfg.mla is not None:
            tcfg = tcfg.replace(mla=MLAConfig(**dataclasses.asdict(jcfg.mla)))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def carried(family, seed=0):
    """(JAX reference, JAX params, port config, port model, port params):
    the port's init with perturbed norm scales, carried to the JAX tree.
    The reference is the JAX model's ``prefill`` and ``decode_step``
    under ``jax.jit`` (what ``_sequential_greedy`` / ``_sequential_sample``
    call; eager, their op-by-op dispatch takes 20-45 s a family on one
    core), one per family for the whole file, so its compiles are
    shared."""
    jcfg, tcfg = configs(family)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    flat = interop.to_flat(tmodel.init(seed, "cpu"))
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.split("::")[-1] == "scale":
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(seed))
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(flat[k]) for k in _flatten(shapes)])
    jref = types.SimpleNamespace(
        prefill=jax.jit(jmodel.prefill, static_argnames=("cache_len",)),
        decode_step=jax.jit(jmodel.decode_step))
    return jref, jparams, tcfg, tmodel, interop.from_flat(flat, device="cpu")


def _requests(vocab):
    """``tests/test_serve_tp.py``'s three requests."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (int(p),)), int(g), 51000 + i)
            for i, (p, g) in enumerate(zip(rng.integers(3, 24, 3),
                                           rng.integers(4, 10, 3)))]


def _serve(model, params, reqs, devices, **ecfg):
    eng = Engine(model, params, EngineConfig(**ecfg), devices=devices)
    res = eng.run([Request(prompt=np.asarray(p).copy(), max_new_tokens=g,
                           rid=rid) for p, g, rid in reqs])
    return eng, [res[rid].tokens for _, _, rid in reqs]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """A family's carried weights and the reference's sequential greedy
    and sampled streams of the three requests."""
    jref, jparams, tcfg, tmodel, tparams = carried(request.param)
    reqs = _requests(tcfg.vocab_size)
    want = {0.0: [_sequential_greedy(jref, jparams, p, g)
                  for p, g, _ in reqs],
            TEMP: [_sequential_sample(jref, jparams, p, g, rid=rid,
                                      temperature=TEMP)
                   for p, g, rid in reqs]}
    assert want[0.0] != want[TEMP]          # the sampling is stochastic
    return request.param, tcfg, tmodel, tparams, reqs, want


@pytest.mark.parametrize("temperature", [0.0, TEMP])
@pytest.mark.parametrize("spd", [1, 8])
def test_tp2_engine_matches_sequential_decode(family, spd, temperature):
    name, tcfg, tmodel, tparams, reqs, want = family
    eng, got = _serve(tmodel, tparams, reqs, TP2, steps_per_dispatch=spd,
                      temperature=temperature, **ECFG)
    assert eng.tp_degree == 2 and eng.devices == TP2
    assert isinstance(eng.params, sharding.ShardedParams)
    assert isinstance(eng.cache, list) and len(eng.cache) == 2
    assert eng.params.modules[{"mamba": "ssm"}.get(name, "attn")]
    assert got == want[temperature], (name, spd, temperature)
    counters = eng.metrics_snapshot()["counters"]
    assert counters["generated_tokens"] == sum(g for _, g, _ in reqs)
    if spd > 1:
        assert counters["loop_dispatches"] > 0


@pytest.mark.parametrize("name", ["qwen2", "mamba"])
def test_tp2_engine_preemption_keeps_equivalence(name):
    """``tests/test_serve_tp.py``'s starved pool, state sharded: partial
    grants and preemption reconciled on the host, streams unchanged."""
    jref, jparams, tcfg, tmodel, tparams = carried(name)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, tcfg.vocab_size, (12,)), 14, 52000 + i)
            for i in range(3)]
    eng, got = _serve(tmodel, tparams, reqs, TP2, **SMALL)
    assert eng.metrics_snapshot()["counters"]["preemptions"] > 0
    assert got == [_sequential_greedy(jref, jparams, p, g)
                   for p, g, _ in reqs]


def test_cluster_tp_replicas_match_sequential():
    """Two tensor-parallel replicas over four devices, router widths 2,
    and an explicit 3 + 1 split (widths 3 and 1; the 3-way slice divides
    none of tiny qwen2's heads, hidden width or vocabulary, so every
    leaf stays whole on its shard 0): every stream equals the
    reference's sequential greedy decode."""
    jref, jparams, tcfg, tmodel, tparams = carried("qwen2")
    rng = np.random.default_rng(9)
    protos = [(rng.integers(0, tcfg.vocab_size, (int(p),)), int(g))
              for p, g in zip(rng.integers(3, 30, 6),
                              rng.integers(2, 12, 6))]
    want = [_sequential_greedy(jref, jparams, p, g) for p, g in protos]
    subs = [Request(prompt=np.asarray(p).copy(), max_new_tokens=g)
            for p, g in protos]
    cluster = ServeCluster.for_replicas(tmodel, tparams,
                                        EngineConfig(**ECFG),
                                        num_replicas=2,
                                        devices=["cpu"] * 4)
    assert [e.tp_degree for e in cluster.engines] == [2, 2]
    assert [cluster.router.width(i) for i in (0, 1)] == [2, 2]
    results = cluster.run(subs)
    assert all(v == 0 for v in cluster.loads().values())
    assert all(e.metrics_snapshot()["counters"]["generated_tokens"] > 0
               for e in cluster.engines)
    assert [results[s.rid].tokens for s in subs] == want

    het = ServeCluster(tmodel, tparams, EngineConfig(**ECFG),
                       slices=[("cpu",) * 3, ("cpu",)])
    assert [e.tp_degree for e in het.engines] == [3, 1]
    assert [het.router.width(i) for i in (0, 1)] == [3, 1]
    three = het.engines[0].params
    assert not any(three.modules.values())
    assert three.shards[1] == {} and three.shards[2] == {}
    assert len(interop.to_flat(three.shards[0])) == \
        len(interop.to_flat(tparams))
    subs = [Request(prompt=np.asarray(p).copy(), max_new_tokens=g)
            for p, g in protos]
    results = het.run(subs)
    assert [results[s.rid].tokens for s in subs] == want


@pytest.mark.parametrize("name", FAMILIES)
def test_shards_reassemble_the_full_leaves(name):
    """Each shard's part is its ranges of the full leaf, bit for bit: the
    even splits' parts join back into the leaf, a whole copy is the
    leaf, and a leaf the slice keeps on shard 0 is nowhere else; the
    paged pools take the same parts, shards on one device sharing a
    pool they both read (the MLA latents, a kv head)."""
    _, tcfg = configs(name)
    tmodel = build_model(tcfg)
    params = tmodel.init(0, "cpu")
    sp = sharding.shard_params(params, tcfg, TP2)
    flats = [interop.to_flat(s) for s in sp.shards]
    for path, leaf in interop.to_flat(params).items():
        place = sharding.param_placement(tcfg, path.replace("::", "/"), 2)
        if place is None:
            assert path not in flats[1]
            np.testing.assert_array_equal(flats[0][path], leaf)
            continue
        for s in (0, 1):
            want = leaf
            if isinstance(place, sharding.Split):
                ax = leaf.ndim + place.axis
                want = np.concatenate(
                    [np.take(leaf, range(lo, lo + n), axis=ax)
                     for lo, n in place.ranges(s, 2)], axis=ax)
            np.testing.assert_array_equal(flats[s][path], want)
        if isinstance(place, sharding.Split) and \
                all(u and u % 2 == 0 for _, u in place.segments):
            np.testing.assert_array_equal(
                np.concatenate([flats[0][path], flats[1][path]],
                               axis=leaf.ndim + place.axis), leaf)
    caches = tmodel.init_paged_cache(9, 8, num_state_slots=6, devices=TP2)
    for run, rc in caches[0].items():
        for leaf, pool in rc.items():
            place = sharding.cache_placement(tcfg, leaf, 2)
            shared = pool is caches[1][run][leaf]
            assert shared == (place == sharding.EVERY or (
                isinstance(place, sharding.Split)
                and place.ranges(0, 2) == place.ranges(1, 2)))


def test_forward_tp_serves_the_paged_forms_only():
    _, tcfg = configs("qwen2")
    tmodel = build_model(tcfg)
    sp = sharding.shard_params(tmodel.init(0, "cpu"), tcfg, TP2)
    with pytest.raises(ValueError, match="paged"):
        ttf.forward(sp, torch.zeros((1, 4), dtype=torch.int32), tcfg)


# ---------------------------------------------------------------------------
# the plan against the reference's PartitionSpecs
# ---------------------------------------------------------------------------

_SPECS = """
import json, jax, numpy as np
from jax.sharding import Mesh
from repro import sharding
from repro.models.model import build_model
from test_torch_tp import configs

mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
out = {}
for name in %r:
    model = build_model(configs(name)[0])
    abstract = model.abstract_params()
    cache = jax.eval_shape(lambda: model.init_paged_cache(
        9, 8, 3, 8, num_state_slots=6))
    got = {}
    for prefix, tree, specs in (
            ("", abstract, sharding.serve_param_pspecs(abstract, mesh)),
            ("cache/", cache, sharding.serve_cache_pspecs(cache, mesh))):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for (path, leaf), spec in zip(flat, leaves):
            axes = [i for i, a in enumerate(spec) if a == "model"]
            got[prefix + sharding._path_str(path)] = [
                list(leaf.shape), axes[0] if axes else None]
    out[name] = got
print("SPECS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", _SPECS % (FAMILIES,)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("SPECS"))
    return json.loads(line[len("SPECS"):])


def _even(shape, axis, shard, tp=2):
    n = shape[axis] // tp
    return ((shard * n, n),)


def _split_axis(place, ndim, tp=2):
    """The axis a placement splits in the reference's terms (its
    PartitionSpec's ``"model"`` axis): one whose runs deal whole units to
    every shard, none shared; None where every shard holds the whole
    leaf, or shard 0 alone does."""
    if isinstance(place, sharding.Split) and any(
            u and u % tp == 0 for _, u in place.segments):
        return ndim + place.axis
    return None


@pytest.mark.parametrize("name", FAMILIES)
def test_plan_matches_the_reference_specs(reference_specs, name):
    """Leaf by leaf, each shard's index ranges along the split axis
    equal the reference's even split of the axis it names (or neither
    splits), except at ``DEVIATIONS``."""
    _, tcfg = configs(name)
    seen = set()
    for path, (shape, ref_axis) in reference_specs[name].items():
        if path.endswith("block_tables"):       # the port passes tables
            continue
        if path.startswith("cache/"):
            place = sharding.cache_placement(tcfg, path.split("/")[-1], 2)
        else:
            place = sharding.param_placement(tcfg, path, 2)
        axis = _split_axis(place, len(shape))
        mine = None if axis is None else (axis, place.ranges(0, 2),
                                          place.ranges(1, 2))
        theirs = None if ref_axis is None else (
            ref_axis, _even(shape, ref_axis, 0), _even(shape, ref_axis, 1))
        if (name, path) in DEVIATIONS:
            assert mine != theirs, path
            seen.add((name, path))
        else:
            assert mine == theirs, (path, mine, theirs)
    assert seen == {d for d in DEVIATIONS if d[0] == name}
    assert {g for g in GATHERED if g[0] == name} <= \
        {(name, p) for p in reference_specs[name]}
