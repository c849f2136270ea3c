"""The port's training over a rank mesh against the JAX package, float32
on the CPU, four gloo ranks on a (pod 2, data 2) mesh.

The config is the reference's tiny one (``tests/test_trainer_distributed.py``:
smoke qwen1.5-0.5b at 2 layers, d 64, d_ff 128, vocab 64; T = 3 steps of
B = 16 rows of S = 12 tokens, lr 0.05), from the port's init (seed 0)
carried to JAX, on the launcher's synthetic batches.  The oracle is the
JAX package's ``virtual.csgd`` over the same four-way row split:

- ``make_pjit_step`` with ``fsdp=True`` (ZeRO-3 over data, each layer
  gathered as it runs, the pods' phase in flight until the next step)
  plus ``finalize``, SGD and LARS (whose norms sum over the shard
  group), LSGD and CSGD, and LSGD under remat (each layer gathered again
  for its backward), and the reported losses: within 1e-5
  (``tests/test_equivalence.py``'s bound);
- the launcher's ``--mesh 2,2,1`` in csgd, lsgd, lsgd_eager and
  lsgd_rsag: within 1e-5;
- checkpoints: a sharded state saved in the full-leaf layout restores
  sharded bit for bit and unsharded (port and JAX package), and an
  unsharded checkpoint restores into shards;
- the training plan (``sharding.param_pspecs`` with and without fsdp,
  ``filter_spec_for_mesh``, ``legalize_pspecs``) equals the reference's
  leaf by leaf for every registered config, on abstract shapes.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sharding as jsharding
from repro.checkpoint import checkpoint as jcheckpoint
from repro.checkpoint.checkpoint import _flatten
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.core import TrainerConfig as JaxTrainerConfig
from repro.core import make_init_state as jax_make_init_state
from repro.core import virtual as jvirtual
from repro.models.model import build_model as jax_build_model
from repro.optim.sgd import OptimConfig as JaxOptimConfig
from repro_torch import interop
from repro_torch import sharding as tsharding
from repro_torch.configs import available_archs, get_config, smoke_variant
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models.model import build_model
from torch_ranks import RANK_PRELUDE, run_ranks
from torch_threads import one_torch_thread  # noqa: F401

BOUND = 1e-5
T, B, S, LR = 3, 16, 12, 0.05
MODES = ("csgd", "lsgd", "lsgd_eager", "lsgd_rsag")
FSDP_CASES = (("sgd", "lsgd"), ("sgd", "csgd"), ("lars", "lsgd"),
              ("sgd", "lsgd_remat"))
TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64)

WORKER = RANK_PRELUDE + r'''
out_dir = ARGS[0]
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import trainer
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.interop import to_flat
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.sgd import OptimConfig
from repro_torch.tree import leaves, unflatten

cfg = smoke_variant(get_config("qwen1.5-0.5b")).replace(
    num_layers=2, d_model=64, d_ff=128, vocab_size=64)
model = build_model(cfg)
dcfg = DataConfig(vocab_size=64, seq_len=12, global_batch=16, seed=0)
batches = [{"tokens": torch.from_numpy(synth_batch(dcfg, t)["tokens"])}
           for t in range(3)]
lr_fn = lambda t: 0.05


def save(name, tree, **extra):
    if rank == 0:
        np.savez(os.path.join(out_dir, name + ".npz"), **to_flat(tree),
                 **extra)


mesh = make_mesh((2, 2), ("pod", "data"))


def fsdp_run(kind, mode, steps, model=model):
    tcfg = trainer.TrainerConfig(sync_mode=mode, fsdp=True,
                                 optim=OptimConfig(kind=kind))
    plan = trainer.FsdpPlan(model, tcfg, mesh)
    state = trainer.make_init_state(model, tcfg, "cpu", plan)(0)
    step = trainer.make_pjit_step(model, tcfg, lr_fn, plan)
    losses = []
    for b in batches[:steps]:
        state, (loss, _) = step(state, trainer.local_batch(b, mesh))
        losses.append(float(loss))
    return tcfg, plan, state, step, losses


remat = build_model(cfg.replace(remat=True))
for kind, mode, m in (("sgd", "lsgd", model), ("sgd", "csgd", model),
                      ("lars", "lsgd", model), ("sgd", "lsgd", remat)):
    tcfg, plan, state, _, losses = fsdp_run(kind, mode, 3, m)
    split = [pl for pl in leaves(plan.places) if pl is not None]
    assert split and all(pl.axes == ("data",) for pl in split), split
    if tcfg.defer_update:
        assert state["inflight"] is not None     # the pods' phase in flight
    state = trainer.make_finalize(m, tcfg, lr_fn, plan)(state)
    name = f"fsdp_{kind}_{mode}" + ("_remat" if m is remat else "")
    save(name, plan.gather(state["params"]), losses=np.asarray(losses))

# checkpoints: two steps in, so the pending part is live
tcfg, plan, state, step, _ = fsdp_run("sgd", "lsgd", 2)
ck = os.path.join(out_dir, "ckpt_fsdp")
# the save gathers a leaf at a time: no whole leaf it gathered is alive
# when it gathers the next
import weakref
from repro_torch import sharding
gather_dim, alive, most, calls = sharding.gather_dim, [], [0], [0]


def counted(*a):
    alive[:] = [r for r in alive if r() is not None]
    out = gather_dim(*a)
    alive.append(weakref.ref(out))
    most[0] = max(most[0], len(alive))
    calls[0] += 1
    return out


sharding.gather_dim = counted
try:
    checkpoint.save(ck, state, state["step"], plan=plan)
finally:
    sharding.gather_dim = gather_dim
n_split = sum(pl is not None for pl in leaves(plan.places))
assert calls[0] == 3 * n_split and most[0] == 1, (calls, n_split, most)
full = unflatten(state, [x for _, x in plan.whole_items(state)])
like = trainer.make_init_state(model, tcfg, "cpu", plan)(1)
back = checkpoint.restore(ck, like, plan=plan)
for a, b in zip(leaves(back), leaves(state)):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
assert back["step"] == state["step"] == 2
if rank == 0:
    whole = trainer.make_init_state(model, trainer.TrainerConfig("lsgd"),
                                    "cpu")(1)
    got = checkpoint.restore(ck, whole)
    for k in ("params", "pending"):
        for a, b in zip(leaves(got[k]), leaves(full[k])):
            assert torch.equal(a, b), k
    for a, b in zip(leaves(got["opt"]["m"]), leaves(full["opt"]["m"])):
        assert torch.equal(a, b)
    save("ckpt_full", full["params"])
dist.barrier()
ck2 = os.path.join(out_dir, "ckpt_whole")
checkpoint.save(ck2, full, full["step"])
back = checkpoint.restore(ck2, like, plan=plan)
for a, b in zip(leaves(back), leaves(plan.shard_state(full))):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
# a restored sharded state goes on exactly as the original
batch = trainer.local_batch(batches[2], mesh)
for i, st in enumerate((state, checkpoint.restore(ck, like, plan=plan))):
    st, _ = step(st, batch)
    st = trainer.make_finalize(model, tcfg, lr_fn, plan)(st)
    save(f"resumed_{i}", plan.gather(st["params"]))

# the launcher over the mesh
train.model_config = lambda args: cfg
for mode in ("csgd", "lsgd", "lsgd_eager", "lsgd_rsag"):
    out = train.main(["--arch", "qwen1.5-0.5b", "--device", "cpu",
                      "--steps", "3", "--batch", "16", "--seq", "12",
                      "--sync-mode", mode, "--mesh", "2,2,1",
                      "--schedule", "const", "--base-lr", "0.05",
                      "--log-every", "100"])
    save(f"mesh_{mode}", out["state"]["params"],
         losses=np.asarray(out["losses"]))
rank_ok()
'''


def _tiny(get, smoke):
    return smoke(get("qwen1.5-0.5b")).replace(**TINY)


def _batches():
    dcfg = DataConfig(vocab_size=TINY["vocab_size"], seq_len=S,
                      global_batch=B, seed=0)
    return [synth_batch(dcfg, t)["tokens"] for t in range(T)]


@pytest.fixture(scope="module")
def jax_side():
    """(jax model, the port's seed-0 init carried to JAX, the JAX
    package's virtual CSGD after T steps from it for sgd and lars:
    (flat params, losses))."""
    jcfg = _tiny(jax_get_config, jax_smoke_variant)
    jmodel = jax_build_model(jcfg)
    like = jmodel.init(jax.random.key(0))
    flat = interop.to_flat(build_model(_tiny(get_config, smoke_variant))
                           .init(0, "cpu"))
    p0 = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [jnp.asarray(flat[k]) for k in _flatten(like)])
    wb = [jvirtual.partition_minibatch({"tokens": jnp.asarray(b)}, 4)
          for b in _batches()]
    refs = {}
    for kind in ("sgd", "lars"):
        p, losses = jvirtual.csgd(jmodel, p0, wb, lambda t: LR,
                                  JaxOptimConfig(kind=kind))
        refs[kind] = ({k: np.asarray(v) for k, v in _flatten(p).items()},
                      losses)
    return jcfg, jmodel, refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp")
    run_ranks(WORKER, 4, out)
    return out


def _diff(path, ref):
    with np.load(path) as got:
        keys = [k for k in got.files if k != "losses"]
        assert sorted(keys) == sorted(ref)
        return max(float(np.abs(got[k] - ref[k]).max()) for k in keys)


@pytest.mark.parametrize("kind,mode", FSDP_CASES)
def test_fsdp_step_matches_jax_csgd(jax_side, ranks, kind, mode):
    ref, ref_losses = jax_side[2][kind]
    path = ranks / f"fsdp_{kind}_{mode}.npz"
    assert _diff(path, ref) < BOUND
    with np.load(path) as got:
        assert np.abs(got["losses"] - np.asarray(ref_losses)).max() < BOUND


@pytest.mark.parametrize("mode", MODES)
def test_mesh_launcher_matches_jax_csgd(jax_side, ranks, mode):
    ref, ref_losses = jax_side[2]["sgd"]
    path = ranks / f"mesh_{mode}.npz"
    assert _diff(path, ref) < BOUND
    with np.load(path) as got:
        assert np.abs(got["losses"] - np.asarray(ref_losses)).max() < BOUND


def test_fsdp_checkpoint_restores_in_the_jax_package(jax_side, ranks):
    """The workers held the round trips (sharded -> sharded bit for bit,
    sharded -> whole, whole -> sharded, a restored state continuing
    exactly); here the sharded run's checkpoint restores into the JAX
    package's trainer state."""
    jcfg, jmodel, _ = jax_side
    tcfg = JaxTrainerConfig(sync_mode="lsgd")
    like = jax_make_init_state(jmodel, tcfg)(jax.random.key(1))
    state = jcheckpoint.restore(str(ranks / "ckpt_fsdp"), like)
    assert int(state["step"]) == 2
    got = {k: np.asarray(v) for k, v in _flatten(state["params"]).items()}
    with np.load(ranks / "ckpt_full.npz") as want:
        assert sorted(want.files) == sorted(got)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    resumed = sorted(p for p in ranks.iterdir()
                     if p.name.startswith("resumed_"))
    assert len(resumed) == 2
    with np.load(resumed[0]) as a, np.load(resumed[1]) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def _norm(spec):
    out = [tuple(s) if isinstance(s, (tuple, list)) else s for s in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


MESHES = ((("pod", "data", "model"), (2, 4, 1)), (("data", "model"), (16, 1)))


@pytest.mark.parametrize("arch", available_archs())
def test_training_plan_matches_reference(arch):
    """Leaf by leaf, the port's spec of every param of ``arch`` (meta
    init) equals the reference's (``jax.eval_shape`` of its init): the
    rules with and without fsdp, then filtered and legalized on a pod x
    data x model mesh of 2 x 4 x 1 and on data 16 x model 1."""
    jmodel = jax_build_model(jax_get_config(arch))
    abstract = jax.eval_shape(jmodel.init, jax.random.key(0))
    tparams = build_model(get_config(arch)).init(0, "meta")
    for fsdp in (False, True):
        jspecs = jsharding.param_pspecs(abstract, fsdp=fsdp)
        tspecs = tsharding.param_pspecs(tparams, fsdp=fsdp)
        cases = [(jspecs, tspecs)]
        for axes, shape in MESHES:
            jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
            tmesh = SimpleNamespace(axis_names=axes,
                                    sizes=dict(zip(axes, shape)))
            cases.append((
                jsharding.legalize_pspecs(
                    abstract, jsharding.filter_spec_for_mesh(jspecs, jmesh),
                    jmesh),
                tsharding.legalize_pspecs(
                    tparams, tsharding.filter_spec_for_mesh(tspecs, tmesh),
                    tmesh)))
        for jtree, ttree in cases:
            want = {k: _norm(v) for k, v in _jax_specs_flat(jtree).items()}
            got = {k: _norm(v) for k, v in _specs_flat(ttree).items()}
            assert got == want, (arch, fsdp)
    if get_config(arch).moe is not None:
        experts = tsharding.param_pspecs(tparams)["layers"]
        assert any("data" in spec for run in experts.values()
                   if "moe" in run for spec in run["moe"]["experts"].values())


def _jax_specs_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"::".join(str(getattr(p, "key", p)) for p in path): spec
            for path, spec in flat}


def _specs_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}::{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_specs_flat(v, key))
        else:
            out[key] = v
    return out


def test_state_batch_specs_and_mesh_helpers_match_reference():
    """``state_pspecs`` of an LSGD state (params, momentum, pending: the
    params' specs; the counters whole) and ``batch_pspecs`` as the
    reference's, on the tiny config; a one-rank host mesh, its sizes and
    ``axis_size`` with and without an active mesh."""
    from repro.core.trainer import batch_pspecs as jax_batch_pspecs
    from repro.core.trainer import state_pspecs as jax_state_pspecs
    from repro_torch.core import trainer
    from repro_torch.launch import mesh as tmesh
    jmodel = jax_build_model(_tiny(jax_get_config, jax_smoke_variant))
    jstate = jax.eval_shape(jax_make_init_state(
        jmodel, JaxTrainerConfig(sync_mode="lsgd")), jax.random.key(0))
    tmodel = build_model(_tiny(get_config, smoke_variant))
    tstate = trainer.make_init_state(tmodel, trainer.TrainerConfig("lsgd"),
                                     "meta")(0)
    for fsdp in (False, True):
        want = jax_state_pspecs(jstate, fsdp=fsdp)
        got = trainer.state_pspecs(tstate, fsdp=fsdp)
        want_flat = {k: _norm(v) for k, v in _jax_specs_flat(want).items()}
        assert {k: _norm(v) for k, v in _specs_flat(got).items()} \
            == want_flat
    axes = ("pod", "data", "model")
    jmesh = SimpleNamespace(axis_names=axes, devices=np.empty((2, 2, 1)))
    batch = {"tokens": np.zeros((8, 12), np.int32)}
    want = jax_batch_pspecs(batch, jmesh)["tokens"]
    got = trainer.batch_pspecs({"tokens": torch.zeros((8, 12))}, jmesh)
    assert _norm(got["tokens"]) == _norm(want)
    m = tmesh.make_host_mesh((1, 1, 1))
    assert tmesh.mesh_axis_sizes(m) == {"pod": 1, "data": 1, "model": 1}
    assert m.group("data") is None and m.index(("pod", "data")) == 0
    assert tsharding.axis_size("data") == 1
    tsharding.set_active_mesh(m)
    try:
        assert tsharding.active_mesh() is m
        assert tsharding.axis_size("data") == 1
    finally:
        tsharding.set_active_mesh(None)
