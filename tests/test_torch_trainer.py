"""The port's training path against the JAX package's, float32 on the CPU.

- ``lm_loss`` and its gradient against ``jax.value_and_grad(lm_loss)``
  with the same weights (``interop``): the smoke qwen2, and a tiny one
  plain, checkpointed (``remat``) and chunked; within 1e-5 (two f32
  stacks of matmuls summing in different orders).
- The port's virtual serial SGD, CSGD and LSGD equal each other and the
  JAX package's ``core/virtual.py`` after T steps from the same weights,
  within ``tests/test_equivalence.py``'s bound (max |diff| < 1e-5).
- A JAX trainer state, two LSGD steps in (so its pending update is
  live), carried into the port by ``interop.state_from_flat``: both
  trainers take two more steps and finalize to params within 1e-5.
- Four gloo ranks on the CPU (two groups of two): every sync mode equals
  the flat mean (1e-6), ``lsgd_compressed`` is close (2e-2 of the
  gradient's scale) but not exact, and the launcher's LSGD run over the
  four ranks equals the virtual LSGD on the same batches (1e-5).
- The launcher's loss falls over a few smoke steps on the CPU.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.core import TrainerConfig as JaxTrainerConfig
from repro.core import make_finalize as jax_make_finalize
from repro.core import make_init_state as jax_make_init_state
from repro.core import make_shardmap_step
from repro.core import virtual as jvirtual
from repro.launch.mesh import make_mesh
from repro.models import transformer as jtf
from repro.optim.sgd import OptimConfig as JaxOptimConfig
from repro_torch import interop
from repro_torch.core import trainer as ttrainer
from repro_torch.core import virtual as tvirtual
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttf
from repro_torch.optim.sgd import OptimConfig
from repro_torch.tree import leaves
from test_torch_model import carried_models

SRC = Path(__file__).resolve().parent.parent / "src"
TINY = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=32, num_heads=2,
            num_kv_heads=2, head_dim=16)
BOUND = 1e-5          # tests/test_equivalence.py


def _tokens(t, b, s, vocab, seed=7):
    rng = np.random.default_rng([seed, t])
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def _max_diff(tparams, jparams):
    flat = interop.to_flat(tparams)
    ref = {k: np.asarray(v, np.float32) for k, v in _flatten(jparams).items()}
    assert flat.keys() == ref.keys()
    return max(float(np.abs(flat[k] - ref[k]).max()) for k in ref)


@pytest.fixture(scope="module")
def tiny():
    return carried_models(TINY)


@pytest.mark.parametrize("variant", ["smoke", "plain", "remat", "chunked"])
def test_lm_loss_and_grad_match_jax(tiny, variant):
    """"smoke" is the smoke qwen2 itself (d_model 256, vocab 512); the
    others the tiny one of the equivalence tests."""
    jcfg, _, jparams, tcfg, _, tparams = (carried_models()
                                          if variant == "smoke" else tiny)
    over = {"remat": dict(remat=True), "chunked": dict(loss_chunk=4)
            }.get(variant, {})
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    toks = _tokens(0, 3, 13 if variant != "chunked" else 17,
                   jcfg.vocab_size)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtf.lm_loss(p, {"tokens": jnp.asarray(toks)}, jcfg),
        has_aux=True)(jparams)
    from repro_torch.core.autodiff import value_and_grad
    tl, metrics, tg = value_and_grad(
        lambda p, b: ttf.lm_loss(p, b, tcfg), tparams,
        {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) < BOUND
    assert float(metrics["ce"]) == float(tl)
    assert _max_diff(tg, jg) < BOUND


def _virtual_runs(tiny, T=3, n_workers=4, group=2):
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny
    batches = [_tokens(t, 8, 12, 32) for t in range(T)]
    ocfg_kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=False)
    lr_fn = lambda t: 0.05 / (1 + t)
    jb = [{"tokens": jnp.asarray(b)} for b in batches]
    tb = [{"tokens": torch.from_numpy(b)} for b in batches]
    jw = [jvirtual.partition_minibatch(b, n_workers) for b in jb]
    tw = [tvirtual.partition_minibatch(b, n_workers) for b in tb]
    jo, to = JaxOptimConfig(**ocfg_kw), OptimConfig(**ocfg_kw)
    return dict(
        jax_csgd=jvirtual.csgd(jmodel, jparams, jw, lr_fn, jo),
        serial=tvirtual.serial_sgd(tmodel, tparams, tb, lr_fn, to),
        csgd=tvirtual.csgd(tmodel, tparams, tw, lr_fn, to),
        lsgd=tvirtual.lsgd(tmodel, tparams, tw, lr_fn, to, group),
        jax_lsgd=jvirtual.lsgd(jmodel, jparams, jw, lr_fn, jo, group))


def test_virtual_algorithms_equal_each_other_and_jax(tiny):
    runs = _virtual_runs(tiny)
    tparams = tiny[5]
    serial, csgd, lsgd = runs["serial"][0], runs["csgd"][0], runs["lsgd"][0]
    for a, b in ((serial, csgd), (csgd, lsgd)):
        assert max(float((x - y).abs().max()) for x, y in
                   zip(leaves(a), leaves(b))) < BOUND
    assert _max_diff(csgd, runs["jax_csgd"][0]) < BOUND
    assert _max_diff(lsgd, runs["jax_lsgd"][0]) < BOUND
    np.testing.assert_allclose(runs["csgd"][1], runs["lsgd"][1], atol=BOUND)
    np.testing.assert_allclose(runs["lsgd"][1], runs["jax_lsgd"][1],
                               atol=BOUND)
    # the inputs were copied, not updated in place
    assert max(float((x - y).abs().max()) for x, y in
               zip(leaves(tparams), leaves(serial))) > 0
    assert _max_diff(tparams, tiny[2]) == 0.0


def test_trainer_state_carried_from_jax_continues_identically(tiny):
    """Two JAX LSGD steps, the state carried across, two more steps and
    finalize in each package."""
    jcfg, jmodel, jparams, _, tmodel, _ = tiny
    lr_fn = lambda t: 0.05
    jt = JaxTrainerConfig(sync_mode="lsgd")
    state = jax_make_init_state(jmodel, jt)(jax.random.key(0))
    state["params"] = jparams
    mesh = make_mesh((1, 1), ("data", "model"))
    jstep = jax.jit(make_shardmap_step(jmodel, jt, lr_fn, mesh))
    batches = [_tokens(t, 4, 12, 32, seed=3) for t in range(4)]
    for b in batches[:2]:
        state, _ = jstep(state, {"tokens": jnp.asarray(b)})
    flat = {k: np.asarray(v) for k, v in _flatten(state).items()}
    tstate = interop.state_from_flat(flat, device="cpu")
    assert tstate["step"] == 2 and tstate["inflight"] is None
    assert float(np.abs(flat["pending::embed::embedding"]).max()) > 0
    assert interop.to_flat(tstate["pending"]).keys() == \
        interop.to_flat(tstate["params"]).keys()
    tt = ttrainer.TrainerConfig(sync_mode="lsgd")
    tstep = ttrainer.make_step(tmodel, tt, lr_fn)
    for b in batches[2:]:
        state, (jl, _) = jstep(state, {"tokens": jnp.asarray(b)})
        tstate, (tl, _) = tstep(tstate, {"tokens": torch.from_numpy(b)})
        assert abs(float(jl) - float(tl)) < BOUND
    state = jax.jit(jax_make_finalize(jmodel, jt, lr_fn))(state)
    tstate = ttrainer.make_finalize(tmodel, tt, lr_fn)(tstate)
    assert _max_diff(tstate["params"], state["params"]) < BOUND
    assert _max_diff(tstate["opt"]["m"], state["opt"]["m"]) < BOUND


def test_launcher_loss_falls_on_cpu():
    out = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "16",
                        "--batch", "4", "--seq", "32", "--base-lr", "0.01",
                        "--log-every", "100"])
    losses = out["losses"]
    assert len(losses) == 16 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < losses[0] - 0.3
    assert out["state"]["step"] == 16 and out["peak_mem_bytes"] is None


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

WORKER = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                  MASTER_ADDR="localhost", MASTER_PORT=port)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
from repro_torch.core.sync import GradSync
from repro_torch.core.topology import Topology
from repro_torch.tree import leaves, tree_map

def grads(r):
    g = torch.Generator().manual_seed(100 + r)
    return {"a": torch.randn((5, 7), generator=g),
            "b": {"c": torch.randn((13,), generator=g)}}

mean = tree_map(lambda *xs: sum(xs) / len(xs), *[grads(r) for r in range(world)])
topo = Topology(intra_group_size=2)
for mode in ("csgd", "lsgd", "lsgd_eager", "lsgd_rsag", "lsgd_compressed"):
    sync = GradSync(mode, topo)
    g = grads(rank)
    res = tree_map(torch.zeros_like, g)
    if mode == "csgd":
        sync.flat(g)
    else:
        sync.phase1(g)
        sync.phase2(g, res).wait()
    diff = max(float((x - y).abs().max()) for x, y in zip(leaves(g), leaves(mean)))
    if mode == "lsgd_compressed":
        scale = max(float(x.abs().max()) for x in leaves(mean))
        assert 0 < diff < 2e-2 * scale, (mode, diff)
        assert max(float(r.abs().max()) for r in leaves(res)) > 0
    else:
        assert diff < 1e-6, (mode, diff)

from repro_torch.core import virtual
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import train
from repro_torch.optim.sgd import OptimConfig
argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "8",
        "--seq", "16", "--sync-mode", "lsgd", "--intra-group-size", "2",
        "--schedule", "const", "--base-lr", "0.05", "--layers", "1"]
out = train.main(argv)
args = train.parse_args(argv)
model = train.build_model(train.model_config(args))
p0 = model.init(args.seed, "cpu")
dcfg = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16, global_batch=8)
wb = [virtual.partition_minibatch(
          {"tokens": torch.from_numpy(synth_batch(dcfg, t)["tokens"])}, world)
      for t in range(3)]
pv, _ = virtual.lsgd(model, p0, wb, lambda t: 0.05, OptimConfig(), 2)
diff = max(float((x - y).abs().max())
           for x, y in zip(leaves(out["state"]["params"]), leaves(pv)))
assert diff < 1e-5, diff
print("RANK_OK", rank, diff, flush=True)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_four_gloo_ranks_sync_and_train():
    world, port = 4, str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(world), port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, out[-3000:]
