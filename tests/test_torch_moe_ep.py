"""The port's expert-parallel MoE (``models/moe.apply_moe_ep``) against
the JAX package's on the same pod x data split, float32 on the CPU.

JAX runs its ``apply_moe_ep`` (a shard_map over a (pod 2, data 2) mesh of
four virtual CPU devices) in a subprocess; the port runs four gloo ranks
on a (pod 2, data 2) mesh, each with its rows of x and its data index's
two of the four experts.  Both take the same weights and inputs, made
from a seed with numpy: smoke dbrx (4 experts, top-2) and smoke
deepseek-v3 (4 experts, top-2, its shared expert).  The capacity factor
(0.5) drops tokens (the ranks count the drops and at least one must
occur); the forward, the aux loss and the gradients of sum(y * r) + aux
for the router, the experts, the shared expert and x agree within 1e-5
relative (max |diff| / max |ref| a leaf, as ``tests/test_moe_ep.py``).

One-rank checks: expert parallelism at data = 1 is the capacity path
itself; an EP fault (the experts not this rank's share) raises where the
reference would fall back silently; and the launcher's and the mesh's
refusals.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import trainer
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.model import build_model
from torch_ranks import RANK_PRELUDE, SRC, run_ranks
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
CF = 0.5
B, SEQ = 8, 8
CASES = {"dbrx": ("dbrx-132b", {}),
         "deepseek": ("deepseek-v3-671b", dict(first_k_dense=0))}


def _cfg(get, smoke, case):
    arch, over = CASES[case]
    cfg = smoke(get(arch))
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, num_experts=4, num_experts_per_tok=2, capacity_factor=CF,
        **over))


def _inputs(case, path):
    """Weights, x and the cotangent r, drawn with numpy from a seed."""
    cfg = _cfg(get_config, smoke_variant, case)
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng([7, len(case)])
    f = m.d_ff_expert
    arr = {"router::w": rng.standard_normal((d, m.num_experts)) * 0.5,
           "experts::w_gate": rng.standard_normal((m.num_experts, d, f)),
           "experts::w_up": rng.standard_normal((m.num_experts, d, f)),
           "experts::w_down": rng.standard_normal((m.num_experts, f, d))}
    for k in ("experts::w_gate", "experts::w_up"):
        arr[k] /= np.sqrt(d)
    arr["experts::w_down"] /= np.sqrt(f)
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        arr["shared::w_gate"] = rng.standard_normal((d, fs)) / np.sqrt(d)
        arr["shared::w_up"] = rng.standard_normal((d, fs)) / np.sqrt(d)
        arr["shared::w_down"] = rng.standard_normal((fs, d)) / np.sqrt(fs)
    arr["x"] = rng.standard_normal((B, SEQ, d))
    arr["r"] = rng.standard_normal((B, SEQ, d))
    np.savez(path, **{k: v.astype(np.float32) for k, v in arr.items()})


JAX_RUN = r'''
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config, smoke_variant
from repro.models import moe
from repro.launch.mesh import make_mesh
case, arch, inp, out = sys.argv[1:5]
over = json.loads(sys.argv[5])
cfg = smoke_variant(get_config(arch))
cfg = cfg.replace(moe=dataclasses.replace(
    cfg.moe, num_experts=4, num_experts_per_tok=2,
    capacity_factor=float(sys.argv[6]), **over))
mesh = make_mesh((2, 2), ("pod", "data"))
a = dict(np.load(inp))
x, r = jnp.asarray(a.pop("x")), jnp.asarray(a.pop("r"))
p = {}
for k, v in a.items():
    top, leaf = k.split("::")
    p.setdefault(top, {})[leaf] = jnp.asarray(v)

def f(p, x):
    y, aux = moe.apply_moe_ep(p, x, cfg, mesh)
    return jnp.sum(y * r) + aux, (y, aux)

(_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
    f, argnums=(0, 1), has_aux=True))(p, x)
res = {"y": np.asarray(y), "aux": np.asarray(aux), "grad::x": np.asarray(gx)}
for top, d in gp.items():
    for leaf, g in d.items():
        res[f"grad::{top}::{leaf}"] = np.asarray(g)
np.savez(out, **res)
'''

WORKER = RANK_PRELUDE + r'''
import dataclasses
case, arch, inp, out, over, cf = ARGS[0], ARGS[1], ARGS[2], ARGS[3], ARGS[4], float(ARGS[5])
import json
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
cfg = smoke_variant(get_config(arch))
cfg = cfg.replace(moe=dataclasses.replace(
    cfg.moe, num_experts=4, num_experts_per_tok=2, capacity_factor=cf,
    **json.loads(over)))
mesh = make_mesh((2, 2), ("pod", "data"))
a = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
n_dp, i_dp = mesh.size(("pod", "data")), mesh.index(("pod", "data"))
rows = slice(i_dp * 2, (i_dp + 1) * 2)
el, d_i = 2, mesh.index("data")
x = a.pop("x")[rows].clone().requires_grad_(True)
r = a.pop("r")[rows]
p = {}
for k, v in a.items():
    top, leaf = k.split("::")
    if top == "experts":
        v = v[d_i * el:(d_i + 1) * el]
    p.setdefault(top, {})[leaf] = v.clone().requires_grad_(True)
y, aux = moe.apply_moe_ep(p, x, cfg, mesh)
(torch.sum(y * r) + aux / n_dp).backward()

# drops: assignments past this rank's capacity
t, k, e = x.shape[0] * x.shape[1], 2, 4
cap = int(max(4, -(-t * k * cf // e)))
cap += (-cap) % mesh.size("data")
_, _, ids = moe.route(p, x.detach().reshape(t, -1), cfg)
dropped = torch.clamp(torch.bincount(ids.reshape(-1), minlength=e) - cap,
                      min=0).sum().reshape(1).float()

def gather_rows(v):
    parts = [torch.empty_like(v) for _ in range(world)]
    dist.all_gather(parts, v.contiguous())
    return torch.cat(parts)

res = {"y": gather_rows(y.detach()), "grad::x": gather_rows(x.grad)}
aux_sum = aux.detach().reshape(1).clone()
dist.all_reduce(aux_sum)
dist.all_reduce(dropped)
res["aux"] = aux_sum[0] / n_dp
for top, dd in p.items():
    for leaf, v in dd.items():
        g = v.grad.clone()
        if top == "experts":        # each pod's replica of these experts
            dist.all_reduce(g, group=mesh.group("pod"))
            parts = [torch.empty_like(g) for _ in range(2)]
            dist.all_gather(parts, g, group=mesh.group("data"))
            g = torch.cat(parts)
        else:                        # whole on every rank
            dist.all_reduce(g)
        res[f"grad::{top}::{leaf}"] = g
if rank == 0:
    np.savez(out, dropped=dropped.numpy(),
             **{k: v.numpy() for k, v in res.items()})
rank_ok()
'''


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_ep_matches_jax(case, tmp_path):
    arch, over = CASES[case]
    inp = tmp_path / "in.npz"
    _inputs(case, inp)
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_out = tmp_path / "jax.npz"
    ran = subprocess.run(
        [sys.executable, "-c", JAX_RUN, case, arch, str(inp), str(jax_out),
         json.dumps(over), str(CF)], env=env, capture_output=True, text=True,
        timeout=300)
    assert ran.returncode == 0, ran.stderr[-4000:]
    port_out = tmp_path / "port.npz"
    run_ranks(WORKER, 4, case, arch, inp, port_out, json.dumps(over), CF)
    with np.load(jax_out) as want, np.load(port_out) as got:
        assert float(got["dropped"][0]) >= 1, "no token was dropped"
        assert sorted(want.files) == sorted(k for k in got.files
                                            if k != "dropped")
        for k in want.files:
            u, v = want[k], got[k]
            assert u.shape == v.shape, k
            rel = np.abs(u - v).max() / (np.abs(u).max() + 1e-9)
            assert rel < REL, (k, rel)


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
out, init, toks = sys.argv[1:4]
mesh = make_mesh((2, 2), ("pod", "data"))
m = build_model(smoke_variant(get_config("dbrx-132b")))
tcfg = TrainerConfig(sync_mode="lsgd", fsdp=True)
lr_fn = lambda t: 0.05
state = make_init_state(m, tcfg)(jax.random.key(0))
np.savez(init, **{k: np.asarray(v)
                  for k, v in _flatten(state["params"]).items()})
specs = state_pspecs(jax.eval_shape(lambda: state), fsdp=True)
specs = shd.legalize_pspecs(state, shd.filter_spec_for_mesh(specs, mesh),
                            mesh)
state = jax.device_put(state, jax.tree.map(
    lambda s: NamedSharding(mesh, s), specs,
    is_leaf=lambda x: isinstance(x, PartitionSpec)))
step, fin = make_pjit_step(m, tcfg, lr_fn), make_finalize(m, tcfg, lr_fn)

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
state = jax.jit(fin)(state)
np.savez(out, losses=np.asarray(losses),
         **{k: np.asarray(v) for k, v in _flatten(state["params"]).items()})
'''

STEP_WORKER = RANK_PRELUDE + r'''
out, init, toks = ARGS[0], ARGS[1], ARGS[2]
from repro_torch import interop, sharding
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import trainer
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.tree import leaves
mesh = make_mesh((2, 2), ("pod", "data"))
model = build_model(smoke_variant(get_config("dbrx-132b")))
tcfg = trainer.TrainerConfig(sync_mode="lsgd", fsdp=True)
lr_fn = lambda t: 0.05
plan = trainer.FsdpPlan(model, tcfg, mesh)
state = trainer.make_init_state(model, tcfg, "cpu", plan)(0)
state["params"] = plan.shard(interop.from_flat(dict(np.load(init)),
                                               device="cpu"))
step = trainer.make_pjit_step(model, tcfg, lr_fn, plan)
experts = plan.places["layers"]["run_0"]["moe"]["experts"]["w_gate"]
assert experts is not None and experts.axes == ("data",), experts
losses = []
sharding.set_active_mesh(mesh)
try:
    assert plan.ep()
    for t in np.load(toks)["tokens"]:
        batch = trainer.local_batch({"tokens": torch.from_numpy(t)}, mesh)
        state, (loss, _) = step(state, batch)
        losses.append(float(loss))
    state = trainer.make_finalize(model, tcfg, lr_fn, plan)(state)
finally:
    sharding.set_active_mesh(None)
params = plan.gather(state["params"])
if rank == 0:
    np.savez(out, losses=np.asarray(losses), **interop.to_flat(params))
rank_ok()
'''


def test_fsdp_expert_parallel_step_matches_jax_pjit(tmp_path):
    """Smoke dbrx (4 experts, top-2, the training capacity) trained 3
    LSGD steps of 8 x 16 tokens plus finalize by the FSDP step with the
    mesh active, so the MoE runs expert-parallel on both sides: the port
    over four gloo ranks, the JAX package's pjit step over four virtual
    devices, from the JAX init.  Params and losses within 1e-5."""
    toks = tmp_path / "toks.npz"
    rng = np.random.default_rng(11)
    np.savez(toks, tokens=rng.integers(0, 512, (3, 8, 16)).astype(np.int32))
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    want_p, init = tmp_path / "jax.npz", tmp_path / "init.npz"
    ran = subprocess.run([sys.executable, "-c", JAX_PJIT, str(want_p),
                          str(init), str(toks)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert ran.returncode == 0, ran.stderr[-4000:]
    got_p = tmp_path / "port.npz"
    run_ranks(STEP_WORKER, 4, got_p, init, toks)
    with np.load(want_p) as want, np.load(got_p) as got:
        assert sorted(want.files) == sorted(got.files)
        for k in want.files:
            assert np.abs(want[k] - got[k]).max() < 1e-5, k


def _one_rank_moe(case):
    cfg = _cfg(get_config, smoke_variant, case)
    g = torch.Generator().manual_seed(0)
    p = {top: {k: v[0] for k, v in d.items()}
         for top, d in moe.init_moe(g, cfg, "cpu", 1).items()}
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    return cfg, p, x


@pytest.mark.parametrize("case", list(CASES))
def test_ep_on_one_rank_is_the_capacity_path(case):
    """At data = 1 the expert-parallel body is the scatter path's
    function (its capacity rounds to a multiple of 1): forward, aux and
    every gradient equal."""
    cfg, p, x = _one_rank_moe(case)
    mesh = make_mesh((1, 1), ("data", "model"))

    def run(active):
        q = {top: {k: v.clone().requires_grad_(True) for k, v in d.items()}
             for top, d in p.items()}
        xx = x.clone().requires_grad_(True)
        sharding.set_active_mesh(mesh if active else None)
        try:
            y, aux = moe.apply_moe(q, xx, cfg)
        finally:
            sharding.set_active_mesh(None)
        (y.square().sum() + aux).backward()
        return [y, aux, xx.grad] + [v.grad for d in q.values()
                                    for v in d.values()]

    for a, b in zip(run(True), run(False)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch,zero3,path", [
    ("dbrx-132b", False, "train[pjit/lsgd]"),
    ("qwen2-1.5b", False, "train[shard_map/lsgd]"),
    ("qwen2-1.5b", True, "train[pjit/lsgd/fsdp]")])
def test_make_train_step_takes_the_reference_path(arch, zero3, path,
                                                  monkeypatch):
    """``launch.builders.make_train_step`` on one rank, on the CPU as the
    caller asks: the reference's path for the arch (an MoE config the
    pjit step with its MoE expert-parallel, a dense one the launcher's
    step; ``zero3`` forces the pjit step with fsdp), and 3 steps plus
    the trailing update equal to the launcher's ``make_step`` from the
    same init within 1e-5."""
    from repro_torch.data.pipeline import data_config_for, synth_batch
    from repro_torch.launch import builders
    from repro_torch.tree import leaves
    cfg = smoke_variant(get_config(arch))
    shape = builders.ShapeConfig("test", SEQ, B, "train")
    lr_fn = lambda t: 0.05
    ep_calls = []
    ep = moe.apply_moe_ep
    monkeypatch.setattr(moe, "apply_moe_ep",
                        lambda *a: ep_calls.append(1) or ep(*a))
    ts = builders.make_train_step(cfg, shape,
                                  make_mesh((1, 1), ("data", "model")),
                                  zero3=zero3, device="cpu", lr_fn=lr_fn)
    assert ts.description == path and (ts.plan is not None) == (
        "pjit" in path)
    dcfg = data_config_for(cfg, shape)
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in synth_batch(dcfg, t).items()} for t in range(3)]
    for b in batches:
        ts(b)
    got = ts.finish()["params"]
    assert bool(ep_calls) == (cfg.moe is not None)
    model = build_model(cfg)
    state = trainer.make_init_state(model, ts.tcfg, "cpu")(0)
    step = trainer.make_step(model, ts.tcfg, lr_fn)
    for b in batches:
        state, _ = step(state, b)
    want = trainer.make_finalize(model, ts.tcfg, lr_fn)(state)["params"]
    for a, b in zip(leaves(got), leaves(want)):
        assert (a - b).abs().max().item() < 1e-5


def test_an_ep_fault_raises():
    """Experts that are not this rank's share under an active mesh raise
    (the reference would fall back to the scatter path without a word)."""
    cfg, p, x = _one_rank_moe("dbrx")
    p["experts"] = {k: v[:3] for k, v in p["experts"].items()}
    sharding.set_active_mesh(make_mesh((1, 1), ("data", "model")))
    try:
        with pytest.raises(ValueError, match="expert parallelism"):
            moe.apply_moe(p, x, cfg)
        # serving stays dropless and never expert-parallel
        cfg2, p2, x2 = _one_rank_moe("dbrx")
        y, _ = moe.apply_moe(p2, x2, cfg2, dropless=True)
        assert y.shape == x2.shape
    finally:
        sharding.set_active_mesh(None)


def test_mesh_refusals():
    """``--mesh`` with a model axis over 1 raises NotImplementedError for
    a family the port does not train along it (the RG-LRU hybrid); a
    mesh whose dims do not multiply to the world size raises, a model
    axis included (qwen2 trains along it); the FSDP step refuses
    lsgd_compressed, as the reference's pjit step cannot run it."""
    base = ["--smoke", "--device", "cpu", "--steps", "1"]
    for dims in ("1,2", "2,2,2", "2"):
        with pytest.raises(NotImplementedError, match="model axis"):
            train.main(base + ["--arch", "recurrentgemma-2b", "--mesh",
                               dims])
    for dims in ("2,1", "1,2,1", "1,2", "2,2,2", "2"):
        with pytest.raises(ValueError, match="ranks"):
            train.main(base + ["--mesh", dims])
    with pytest.raises(ValueError, match="pair up"):
        make_mesh((1, 1), ("data",))
    model = build_model(smoke_variant(get_config("qwen2-1.5b")))
    tcfg = trainer.TrainerConfig(sync_mode="lsgd_compressed", fsdp=True)
    plan = trainer.FsdpPlan(model, tcfg, make_mesh((1,), ("data",)))
    with pytest.raises(ValueError, match="lsgd_compressed"):
        trainer.make_pjit_step(model, tcfg, lambda t: 0.1, plan)
