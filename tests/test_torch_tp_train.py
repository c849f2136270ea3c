"""Tensor-parallel training on the port (a mesh with ``model`` over 1)
against the JAX package, float32 on the CPU, four gloo ranks.

The ranks (one worker run, ``tests/torch_ranks.start_ranks``) train:

- tiny qwen2 (2 layers, d 64, 4 heads over 2 kv heads, hd 16, d_ff 128,
  vocab 64; its QKV biases and tied embedding) through the launcher at
  ``--mesh 1,2,2`` (data 2 x model 2), ``--mesh 1,1,4`` (model 4: each
  kv head is held by the two ranks whose query heads read it, and its
  gradient is summed over exactly those two) and ``--mesh 2,1,2`` (the
  pods' phase over model shards), sgd and LARS, in csgd, lsgd,
  lsgd_eager and lsgd_rsag;
- smoke mamba2 (d 128, 4 heads, one group) at ``--mesh 1,2,2``: heads
  split, the gated norm's sum of squares over the model group, B and C
  whole on every rank with their gradients summed;
- tiny qwen2 through ``launch.builders.make_train_step`` on data 2 x
  model 2 (the shard_map step);
- smoke dbrx (4 experts top-2) through ``launch.builders.make_train_step``
  on data 2 x model 2: the pjit step, experts over data (the
  all-to-all within each model coordinate) and their hidden width over
  model, with and without ZeRO-3 (a leaf split on two dims).

The workers also hold the vocab-parallel cross-entropy over 4 model
ranks to the whole-vocab one, value and gradient, within 1e-6.  Each
run is 3 steps of 8 rows of 12 tokens at lr 0.05 plus ``finalize``,
from the port's seed-0 init, gathered whole on rank 0.  The oracle is the
JAX package's ``virtual.csgd`` of that init over the data-parallel row
split (module fixture, this process), and for dbrx its pjit step on a
(data 2, model 2) mesh of four virtual CPU devices (a subprocess that
runs while the ranks do): params and losses within 1e-5
(``tests/test_equivalence.py``'s bound).

Checkpoints: the (2, 2) qwen2 launcher run and the ZeRO-3 dbrx run save
in the full-leaf layout; each restores into its own sharded layout bit
for bit (in the workers), into a one-rank port state and into the JAX
package's trainer state (here).  The training plan is held leaf by leaf
against the reference's legalized ``param_pspecs`` for qwen2-1.5b,
mamba2-370m and dbrx-132b at model 2 (data 2) and 4, with and without
fsdp; ``DEVIATIONS`` lists where the port splits by units instead.  The
families not ported along model raise.
"""
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
from repro_torch.checkpoint import checkpoint as tcheckpoint
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import trainer
from repro_torch.data.pipeline import data_config_for, synth_batch
from repro_torch.launch import builders, train
from repro_torch.models.model import build_model
from torch_ranks import RANK_PRELUDE, SRC, start_ranks
from torch_threads import one_torch_thread  # noqa: F401

BOUND = 1e-5
T, B, S, LR = 3, 8, 12, 0.05
# the tiny configs, by arch: the smoke variant with these fields
TINY = {"qwen2-1.5b": dict(num_layers=2, d_model=64, num_heads=4,
                           num_kv_heads=2, head_dim=16, d_ff=128,
                           vocab_size=64),
        "mamba2-370m": dict(num_layers=2, d_model=128, vocab_size=64),
        "dbrx-132b": {}}
MODES = ("csgd", "lsgd", "lsgd_eager", "lsgd_rsag")
# (name, arch, --mesh, optimizer, sync mode)
CASES = ([(f"qwen2_{m.replace(',', '')}_{k}_{s}", "qwen2-1.5b", m, k, s)
          for m in ("1,2,2", "1,1,4") for k, s in
          [("sgd", s) for s in MODES] + [("lars", "csgd"), ("lars", "lsgd")]]
         + [("qwen2_212_sgd_lsgd", "qwen2-1.5b", "2,1,2", "sgd", "lsgd"),
            ("qwen2_212_lars_lsgd_eager", "qwen2-1.5b", "2,1,2", "lars",
             "lsgd_eager"),
            ("mamba2_122_sgd_lsgd", "mamba2-370m", "1,2,2", "sgd", "lsgd"),
            ("mamba2_122_lars_csgd", "mamba2-370m", "1,2,2", "lars",
             "csgd")])
CKPT = "qwen2_122_sgd_lsgd"       # the launcher run that checkpoints
ZERO3 = (False, True)

WORKER = RANK_PRELUDE + r'''
import json
out_dir, tiny, cases, ckpt_case = (ARGS[0], json.loads(ARGS[1]),
                                   json.loads(ARGS[2]), ARGS[3])
from repro_torch import interop
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data.pipeline import data_config_for, synth_batch
from repro_torch.launch import builders, train
from repro_torch.launch.mesh import make_mesh
from repro_torch.tree import leaves

cfgs = {a: smoke_variant(get_config(a)).replace(**o) for a, o in tiny.items()}


def save(name, tree, losses):
    if rank == 0:
        np.savez(os.path.join(out_dir, name + ".npz"),
                 losses=np.asarray(losses), **interop.to_flat(tree))


def same(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


# the vocab-parallel CE over 4 model ranks equals the whole-vocab CE
# (value and gradient) within 1e-6
from repro_torch.models.layers import cross_entropy, vocab_nll
from repro_torch.sharding import ModelAxis
m4 = make_mesh((1, 1, 4), ("pod", "data", "model"))
axis = ModelAxis(4, m4.index("model"), m4.group("model"), {"vocab": True})
g = torch.Generator().manual_seed(3)
logits = torch.randn((2, 5, 64), generator=g) * 4
labels = torch.randint(0, 64, (2, 5), generator=g)
whole = logits.clone().requires_grad_(True)
want = cross_entropy(whole, labels)
want.backward()
cols = slice(16 * axis.index, 16 * (axis.index + 1))
part = logits[..., cols].clone().requires_grad_(True)
got = vocab_nll(part, labels, axis).mean()
got.backward()
assert abs(got.item() - want.item()) < 1e-6, (got, want)
assert (part.grad - whole.grad[..., cols]).abs().max() < 1e-6

train.model_config = lambda args: cfgs[args.arch]
for name, arch, mesh, kind, mode in cases:
    ck = os.path.join(out_dir, "ckpt_" + name)
    argv = ["--arch", arch, "--device", "cpu", "--steps", "3", "--batch",
            "8", "--seq", "12", "--sync-mode", mode, "--mesh", mesh,
            "--optimizer", kind, "--schedule", "const", "--base-lr", "0.05",
            "--log-every", "100"]
    out = train.main(argv + (["--ckpt-dir", ck] if name == ckpt_case
                             else []))
    plan, state = out["plan"], out["state"]
    assert plan.tp is not None and plan.tp.size == int(mesh[-1])
    save(name, plan.gather(state["params"]), out["losses"])
    if name == ckpt_case:
        same(checkpoint.restore(ck, state, plan=plan), state)

# a dense config through make_train_step: the shard_map step
shape = builders.ShapeConfig("test", 12, 8, "train")
ts = builders.make_train_step(cfgs["qwen2-1.5b"], shape,
                              make_mesh((2, 2), ("data", "model")), "lsgd",
                              device="cpu", lr_fn=lambda t: 0.05)
assert ts.description == "train[shard_map/lsgd/tp2]" and ts.plan is None
dcfg = data_config_for(cfgs["qwen2-1.5b"], shape)
losses = [float(ts({"tokens": torch.from_numpy(
    synth_batch(dcfg, t)["tokens"])})[0]) for t in range(3)]
save("qwen2_builder", ts.tp.gather(ts.finish()["params"]), losses)

cfg = cfgs["dbrx-132b"]
dcfg = data_config_for(cfg, shape)
batches = [{"tokens": torch.from_numpy(synth_batch(dcfg, t)["tokens"])}
           for t in range(3)]
for zero3 in (False, True):
    ts = builders.make_train_step(cfg, shape,
                                  make_mesh((2, 2), ("data", "model")),
                                  "lsgd", zero3=zero3, device="cpu",
                                  lr_fn=lambda t: 0.05)
    assert ts.description == ("train[pjit/lsgd/fsdp/tp2]" if zero3
                              else "train[pjit/lsgd/tp2]"), ts.description
    # the experts split on two dims (data, model) either way; under
    # ZeRO-3 the attention's columns too
    both = [pl is not None and mp is not None for pl, mp in
            zip(leaves(ts.plan.places), leaves(ts.plan.tp.places))]
    wq = ts.plan.places["layers"]["run_0"]["attn"]["wq"]
    assert any(both) and (wq is not None) == zero3, both
    losses = [float(ts(b)[0]) for b in batches]
    st = ts.finish()
    save(f"dbrx_{int(zero3)}", ts.plan.gather(st["params"]), losses)
    if zero3:
        ck = os.path.join(out_dir, "ckpt_dbrx")
        checkpoint.save(ck, st, st["step"], plan=ts.plan)
        same(checkpoint.restore(ck, st, plan=ts.plan), st)
rank_ok()
'''

JAX_PJIT = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec
from repro import sharding as shd
from repro.checkpoint.checkpoint import _flatten
from repro.configs.base import get_config, smoke_variant
from repro.core import (TrainerConfig, make_finalize, make_init_state,
                        make_pjit_step)
from repro.core.trainer import state_pspecs
from repro.launch.mesh import make_mesh
from repro.models.model import build_model
init, toks, out = sys.argv[1:4]
mesh = make_mesh((2, 2), ("data", "model"))
m = build_model(smoke_variant(get_config("dbrx-132b")))
flat = dict(np.load(init))
for fsdp in (False, True):
    tcfg = TrainerConfig(sync_mode="lsgd", fsdp=fsdp)
    state = make_init_state(m, tcfg)(jax.random.key(0))
    state["params"] = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(state["params"]),
        [jnp.asarray(flat[k]) for k in _flatten(state["params"])])
    specs = state_pspecs(jax.eval_shape(lambda: state), fsdp=fsdp)
    specs = shd.legalize_pspecs(state, shd.filter_spec_for_mesh(specs, mesh),
                                mesh)
    state = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, PartitionSpec)))
    step = make_pjit_step(m, tcfg, lambda t: 0.05)

    def run(state, batch):
        shd.set_active_mesh(mesh)
        try:
            return step(state, batch)
        finally:
            shd.set_active_mesh(None)

    jstep, losses = jax.jit(run), []
    for t in np.load(toks)["tokens"]:
        state, (loss, _) = jstep(state, {"tokens": jnp.asarray(t)})
        losses.append(float(loss))
    state = jax.jit(make_finalize(m, tcfg, lambda t: 0.05))(state)
    np.savez(f"{out}_{int(fsdp)}.npz", losses=np.asarray(losses),
             **{k: np.asarray(v) for k, v in _flatten(state["params"]).items()})
'''


def _configs(arch):
    """(JAX config, port config) of ``arch``'s tiny variant."""
    return (jax_smoke_variant(jax_get_config(arch)).replace(**TINY[arch]),
            smoke_variant(get_config(arch)).replace(**TINY[arch]))


def _tokens(cfg):
    """The launcher's (and ``make_train_step``'s) T batches of B x S."""
    dcfg = data_config_for(cfg, builders.ShapeConfig("test", S, B, "train"))
    return [synth_batch(dcfg, t)["tokens"] for t in range(T)]


def _p0(jmodel, cfg):
    """The port's seed-0 init of ``cfg`` as the JAX model's params."""
    like = jax.eval_shape(jmodel.init, jax.random.key(0))
    flat = interop.to_flat(build_model(cfg).init(0, "cpu"))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [jnp.asarray(flat[k]) for k in _flatten(like)])


def _dp(mesh: str) -> int:
    pod, data, _ = (int(x) for x in mesh.split(","))
    return pod * data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(output dir, the JAX references {(arch, dp, optimizer): (flat
    params, losses)}): the ranks and the JAX pjit subprocess start
    first, the virtual CSGD references are computed while they run."""
    out = tmp_path_factory.mktemp("tp_train")
    dbrx = _configs("dbrx-132b")[1]
    np.savez(out / "init.npz",
             **interop.to_flat(build_model(dbrx).init(0, "cpu")))
    np.savez(out / "toks.npz", tokens=np.stack(_tokens(dbrx)))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    pjit = subprocess.Popen(
        [sys.executable, "-c", JAX_PJIT, str(out / "init.npz"),
         str(out / "toks.npz"), str(out / "jax_dbrx")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    wait = start_ranks(WORKER, 4, out, json.dumps(TINY),
                       json.dumps(CASES), CKPT, timeout=400)
    refs = {}
    try:
        for arch in ("qwen2-1.5b", "mamba2-370m"):
            jcfg, cfg = _configs(arch)
            jmodel = jax_build_model(jcfg)
            p0 = _p0(jmodel, cfg)
            toks = _tokens(cfg)
            for dp in sorted({_dp(c[2]) for c in CASES if c[1] == arch}):
                wb = [jvirtual.partition_minibatch(
                    {"tokens": jnp.asarray(t)}, dp) for t in toks]
                for kind in ("sgd", "lars"):
                    p, losses = jvirtual.csgd(jmodel, p0, wb, lambda t: LR,
                                              JaxOptimConfig(kind=kind))
                    refs[(arch, dp, kind)] = (
                        {k: np.asarray(v) for k, v in _flatten(p).items()},
                        losses)
    finally:
        wait()
        log = pjit.communicate(timeout=400)[0]
    assert pjit.returncode == 0, log[-4000:]
    return out, refs


def _close(path, ref, ref_losses):
    with np.load(path) as got:
        keys = [k for k in got.files if k != "losses"]
        assert sorted(keys) == sorted(ref)
        worst = max(float(np.abs(got[k] - ref[k]).max()) for k in keys)
        assert worst < BOUND, worst
        assert np.abs(got["losses"] - np.asarray(ref_losses)).max() < BOUND


@pytest.mark.parametrize("name,arch,mesh,kind,mode", CASES)
def test_launcher_along_model_matches_jax_csgd(runs, name, arch, mesh, kind,
                                               mode):
    out, refs = runs
    ref, losses = refs[(arch, _dp(mesh), kind)]
    _close(out / f"{name}.npz", ref, losses)


def test_make_train_step_shard_map_along_model(runs):
    """A dense config through ``make_train_step`` on data 2 x model 2
    (the shard_map step, each rank its model shard) equals the JAX
    package's virtual CSGD over the two data-parallel row halves."""
    out, refs = runs
    ref, losses = refs[("qwen2-1.5b", 2, "sgd")]
    _close(out / "qwen2_builder.npz", ref, losses)


@pytest.mark.parametrize("zero3", ZERO3)
def test_dbrx_data_x_model_matches_jax_pjit(runs, zero3):
    """dbrx through ``make_train_step`` on data 2 x model 2 (experts over
    data, their hidden width over model; ZeRO-3 also splits the other
    large leaves over data) equals the JAX package's pjit step on the
    same mesh from the same init."""
    out, _ = runs
    with np.load(out / f"jax_dbrx_{int(zero3)}.npz") as want:
        ref = {k: want[k] for k in want.files if k != "losses"}
        _close(out / f"dbrx_{int(zero3)}.npz", ref, want["losses"])


@pytest.mark.parametrize("case", ("qwen2", "dbrx"))
def test_checkpoint_restores_into_jax_and_one_rank(runs, case):
    """The (2, 2) run's full-leaf checkpoint restores into the JAX
    package's trainer state and into a one-rank port state, each leaf
    equal to the run's gathered params (the workers held the sharded
    round trip bit for bit)."""
    out, _ = runs
    arch, ck, name, fsdp = (("qwen2-1.5b", f"ckpt_{CKPT}", CKPT, False)
                            if case == "qwen2" else
                            ("dbrx-132b", "ckpt_dbrx", "dbrx_1", True))
    jcfg, cfg = _configs(arch)
    with np.load(out / f"{name}.npz") as f:
        want = {k: f[k] for k in f.files if k != "losses"}
    like = jax_make_init_state(jax_build_model(jcfg), JaxTrainerConfig(
        sync_mode="lsgd", fsdp=fsdp))(jax.random.key(1))
    state = jcheckpoint.restore(str(out / ck), like)
    assert int(state["step"]) == T
    got = {k: np.asarray(v) for k, v in _flatten(state["params"]).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    whole = trainer.make_init_state(build_model(cfg),
                                    trainer.TrainerConfig("lsgd"), "cpu")(1)
    back = tcheckpoint.restore(str(out / ck), whole)
    assert back["step"] == T
    for k, v in interop.to_flat(back["params"]).items():
        np.testing.assert_array_equal(v, want[k])


# ---------------------------------------------------------------------------
# the plan against the reference's specs, and the refusals
# ---------------------------------------------------------------------------

# where the port's model split is not the reference's even split: at
# model 4 qwen2's 2 kv heads are read by 2 ranks each, which hold a kv
# head whole (the reference splits its columns through the head); mamba's
# in_proj and conv hold every B and C column on every rank (one group)
DEVIATIONS = {("qwen2-1.5b", 4, f"layers/run_0/attn/{leaf}")
              for leaf in ("wk", "wv", "bk", "bv")} | {
    ("mamba2-370m", tp, f"layers/run_0/ssm/{leaf}")
    for tp in (2, 4) for leaf in ("in_proj", "conv_w", "conv_b")}
PLAN_MESHES = ((2, 2), (1, 4))


def _spec_dims(spec, sizes):
    """{axis name: dim} of a spec (entries a name, a tuple or None), for
    the axes over one rank in ``sizes``."""
    out = {}
    for dim, s in enumerate(spec):
        for a in (s if isinstance(s, tuple) else (s,)):
            if a and sizes[a] > 1:
                out[a] = dim
    return out


@pytest.mark.parametrize("arch", ("qwen2-1.5b", "mamba2-370m", "dbrx-132b"))
@pytest.mark.parametrize("data,tp", PLAN_MESHES)
def test_training_plan_matches_reference_specs(arch, data, tp):
    """Leaf by leaf at full width (meta init, ``jax.eval_shape``), with
    and without fsdp: the port's data split (``train_plan``) is on the
    reference's legalized ``data`` dim, and its model split
    (``train_placement``) deals each rank the reference's even slice of
    its ``model`` dim, except at ``DEVIATIONS``."""
    axes = ("data", "model")
    abstract = jax.eval_shape(jax_build_model(jax_get_config(arch)).init,
                              jax.random.key(0))
    cfg = get_config(arch)
    meta = build_model(cfg).init(0, "meta")
    jmesh = types.SimpleNamespace(axis_names=axes,
                                  devices=np.empty((data, tp)))
    seen = set()
    for fsdp in (False, True):
        specs = jsharding.legalize_pspecs(
            abstract, jsharding.filter_spec_for_mesh(
                jsharding.param_pspecs(abstract, fsdp=fsdp), jmesh), jmesh)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = {"/".join(str(getattr(p, "key", p)) for p in path): spec
                for path, spec in flat}
        mesh = _StubMesh(data, tp)
        data_places = dict(_items(tsharding.train_plan(meta, mesh,
                                                       fsdp=fsdp)))
        for path, leaf in _items(meta):
            dims = _spec_dims(want[path], mesh.sizes)
            pl = data_places[path]
            assert (pl.dim if pl is not None else None) == dims.get("data"), \
                (path, fsdp)
            place = tsharding.train_placement(cfg, path, tp)
            mine = theirs = None
            if place is not None and all(
                    u and u % tp == 0 for _, u in place.segments):
                ax = leaf.dim() + place.axis
                mine = (ax, [place.ranges(r, tp) for r in range(tp)])
            if "model" in dims:
                ax = dims["model"]
                n = leaf.shape[ax] // tp
                theirs = (ax, [((r * n, n),) for r in range(tp)])
            if (arch, tp, path) in DEVIATIONS:
                assert mine != theirs and place is not None, path
                seen.add((arch, tp, path))
            else:
                assert mine == theirs, (path, mine, theirs)
    assert seen == {d for d in DEVIATIONS if d[:2] == (arch, tp)}


class _StubMesh:
    """A (data, model) mesh's sizes and rank 0's coordinates, without a
    process group (what the plans read)."""

    axis_names = ("data", "model")

    def __init__(self, data, tp):
        self.sizes = {"data": data, "model": tp}

    def size(self, names):
        names = (names,) if isinstance(names, str) else tuple(names)
        return int(np.prod([self.sizes.get(a, 1) for a in names]))

    def index(self, names):
        return 0

    def group(self, names):
        return None

    def block_group(self, name, block):
        return None


def _items(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _items(v, path)
        else:
            yield path, v


UNPORTED = ("recurrentgemma-2b", "deepseek-v3-671b", "whisper-tiny",
            "resnet50")


@pytest.mark.parametrize("arch", UNPORTED)
def test_other_families_raise_along_model(arch):
    """RG-LRU, MLA, the encoder-decoder and ResNet raise
    ``NotImplementedError`` naming the ROADMAP item, in the launcher's
    ``--mesh`` (before any mesh is made) and in ``make_train_step``'s
    plan; with a model axis of 1 they are not refused."""
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        train.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "1", "--mesh", "1,1,2"])
    cfg = smoke_variant(get_config(arch))
    shape = builders.ShapeConfig("test", S, B, "train")
    with pytest.raises(NotImplementedError, match="model axis"):
        builders.make_train_step(cfg, shape, _StubMesh(1, 2), device="cpu")
    tsharding.check_tp_training(cfg, 1)
