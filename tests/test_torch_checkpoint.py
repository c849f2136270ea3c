"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the
reference's layout on disk, so that either package restores what the
other wrote.

- save and restore round-trip exactly, bf16 leaves (params and the
  pending buffer) included, the step a host int, nothing in flight;
- save, two more steps, restore, two more steps: the params within
  1e-7 of the run that went on (``tests/test_system.py``'s bound);
- a JAX trainer state written by ``repro.checkpoint.checkpoint.save``
  restores into the port exactly, and the port's restores through
  ``repro.checkpoint.checkpoint.restore`` exactly;
- ``save`` waits for the phase-2 collective in flight first and never
  writes it;
- the launcher's ``--ckpt-dir`` saves and resumes, on one rank and on
  two gloo ranks (rank 0 writes, every rank restores).
"""
import json
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

from repro.checkpoint import checkpoint as jckpt
from repro.checkpoint.checkpoint import _flatten
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.core import TrainerConfig as JaxTrainerConfig
from repro.core import make_init_state as jax_make_init_state
from repro.models.model import build_model as jax_build_model
from repro_torch import interop
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import trainer
from repro_torch.launch import train
from repro_torch.models.model import build_model
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401

SRC = Path(__file__).resolve().parent.parent / "src"
TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64)


def _cfgs(**over):
    over = {**TINY, **over}
    return (jax_smoke_variant(jax_get_config("qwen1.5-0.5b")).replace(**over),
            smoke_variant(get_config("qwen1.5-0.5b")).replace(**over))


def _tokens(t):
    rng = np.random.default_rng([11, t])
    return {"tokens": torch.from_numpy(
        rng.integers(0, TINY["vocab_size"], (4, 16)).astype(np.int32))}


def _trained(steps, *, param_dtype="float32", pending_dtype="float32",
             seed=0):
    """(model, trainer config, step fn, init fn, state after ``steps``
    LSGD steps) of the tiny LM on the CPU."""
    model = build_model(_cfgs(param_dtype=param_dtype)[1])
    tcfg = trainer.TrainerConfig(sync_mode="lsgd",
                                 pending_dtype=pending_dtype)
    init = lambda: trainer.make_init_state(model, tcfg, "cpu")(seed)
    step = trainer.make_step(model, tcfg, lambda t: 0.05)
    state = init()
    for t in range(steps):
        state, _ = step(state, _tokens(t))
    return model, tcfg, step, init, state


def _assert_states_equal(got, want):
    assert got["step"] == want["step"] and got["inflight"] is None
    a, b = checkpoint._flatten(got), checkpoint._flatten(want)
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_save_and_restore_round_trip_exactly(tmp_path):
    _, _, _, init, state = _trained(1, param_dtype="bfloat16",
                                    pending_dtype="bfloat16")
    out = checkpoint.save(str(tmp_path), state, state["step"])
    assert out == str(tmp_path / "step_00000001")
    assert checkpoint.latest_step(str(tmp_path)) == 1
    meta = json.loads((tmp_path / "step_00000001" / "meta.json").read_text())
    bf16 = set(meta["bf16_keys"])
    assert "params::embed::embedding" in bf16
    assert "pending::embed::embedding" in bf16
    assert "opt::m::embed::embedding" not in bf16
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as data:
        assert "inflight" not in data and data["step"].dtype == np.int32
    restored = checkpoint.restore(str(tmp_path), init())
    _assert_states_equal(restored, state)
    assert float(leaves(restored["pending"])[0].float().abs().max()) > 0


def test_missing_checkpoint_or_leaf_raises(tmp_path):
    _, _, _, init, state = _trained(0)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path), state)
    del state["pending"]
    checkpoint.save(str(tmp_path), state, 0)
    with pytest.raises(KeyError, match="pending"):
        checkpoint.restore(str(tmp_path), init())


def test_resume_after_save_is_exact(tmp_path):
    _, _, step, init, state = _trained(2)
    checkpoint.save(str(tmp_path), state, state["step"])
    for t in (2, 3):
        state, _ = step(state, _tokens(t))
    resumed = checkpoint.restore(str(tmp_path), init())
    assert resumed["step"] == 2
    for t in (2, 3):
        resumed, _ = step(resumed, _tokens(t))
    assert max(float((a - b).abs().max()) for a, b in
               zip(leaves(state["params"]), leaves(resumed["params"]))) < 1e-7


@pytest.fixture(scope="module")
def jax_template():
    """A JAX LSGD trainer state (bf16 pending buffer) of the tiny LM, its
    params the port's init (JAX's init compiles for seconds)."""
    jcfg, _ = _cfgs()
    model = jax_build_model(jcfg)
    params = {}
    for key, v in interop.to_flat(
            build_model(_cfgs()[1]).init(0, "cpu")).items():
        *parents, leaf = key.split("::")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    model.init = lambda rng: params
    jt = JaxTrainerConfig(sync_mode="lsgd", pending_dtype="bfloat16")
    return jax_make_init_state(model, jt)(jax.random.key(0))


def test_jax_checkpoint_restores_into_the_port(tmp_path, jax_template):
    rng = np.random.default_rng(1)
    state = jax.tree.map(
        lambda x: (x + jnp.asarray(rng.standard_normal(x.shape), x.dtype))
        if jnp.issubdtype(x.dtype, jnp.floating) else x + 5, jax_template)
    jckpt.save(str(tmp_path), state, int(state["step"]))
    _, _, _, init, _ = _trained(0, pending_dtype="bfloat16")
    like = init()
    got = checkpoint.restore(str(tmp_path), like)
    assert got["step"] == 5 and got["inflight"] is None
    want = {k: np.asarray(v).astype(np.float32)
            for k, v in _flatten(state).items() if k != "step"}
    flat = checkpoint._flatten(got)
    assert flat.keys() - {"step"} == want.keys()
    for k, w in want.items():
        assert flat[k].dtype == checkpoint._flatten(like)[k].dtype
        np.testing.assert_array_equal(flat[k].float().numpy(), w)


def test_port_checkpoint_restores_through_jax(tmp_path, jax_template):
    _, _, _, _, state = _trained(2, pending_dtype="bfloat16")
    checkpoint.save(str(tmp_path), state, state["step"])
    got = jckpt.restore(str(tmp_path), jax_template)
    assert int(got["step"]) == 2
    assert got["pending"]["embed"]["embedding"].dtype == jnp.bfloat16
    want = {**{f"params::{k}": v
               for k, v in interop.to_flat(state["params"]).items()},
            **{f"opt::m::{k}": v
               for k, v in interop.to_flat(state["opt"]["m"]).items()},
            **{f"pending::{k}": v
               for k, v in interop.to_flat(state["pending"]).items()}}
    flat = _flatten(got)
    assert flat.keys() - {"step"} == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(flat[k], np.float32), w)


class _FakeInflight:
    """A phase-2 handle whose ``wait`` finishes the mean (halves the
    pending buffer) and records that it ran."""

    def __init__(self, pending):
        self.pending = pending
        self.waits = 0

    def wait(self):
        self.waits += 1
        for t in leaves(self.pending):
            t.mul_(0.5)


def test_save_waits_for_the_phase2_in_flight(tmp_path):
    _, _, _, init, state = _trained(1)
    before = [t.clone() for t in leaves(state["pending"])]
    handle = state["inflight"] = _FakeInflight(state["pending"])
    checkpoint.save(str(tmp_path), state, state["step"])
    assert handle.waits == 1 and state["inflight"] is None
    restored = checkpoint.restore(str(tmp_path), init())
    for got, b in zip(leaves(restored["pending"]), before):
        assert torch.equal(got, b * 0.5)


LAUNCH = ["--smoke", "--arch", "qwen1.5-0.5b", "--layers", "1", "--device",
          "cpu", "--batch", "4", "--seq", "16", "--schedule", "const",
          "--base-lr", "0.05", "--log-every", "100"]


def test_launcher_saves_and_resumes(tmp_path, capsys):
    d = str(tmp_path)
    first = train.main(LAUNCH + ["--steps", "2", "--ckpt-dir", d,
                                 "--ckpt-every", "1"])
    assert checkpoint.latest_step(d) == 2
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000001",
                                     "step_00000002"]
    saved = checkpoint.restore(d, first["state"])
    _assert_states_equal(saved, first["state"])
    second = train.main(LAUNCH + ["--steps", "1", "--ckpt-dir", d])
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert second["state"]["step"] == 3 and checkpoint.latest_step(d) == 3


WORKER = r'''
import os, sys
rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="localhost",
                  MASTER_PORT=port)
import torch
import torch.distributed as dist
from repro_torch.checkpoint import checkpoint
from repro_torch.launch import train
argv = sys.argv[4:]
out = train.main(argv + ["--steps", "2", "--ckpt-dir", d, "--ckpt-every",
                         "1"])
restored = checkpoint.restore(d, out["state"])
same = torch.equal(restored["params"]["embed"]["embedding"],
                   out["state"]["params"]["embed"]["embedding"])
resumed = train.main(argv + ["--steps", "1", "--ckpt-dir", d])
print("RANK_OK", rank, same, resumed["state"]["step"], flush=True)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_save_on_rank_0_and_resume(tmp_path):
    """Two groups of one: phase 2 is in flight at every save."""
    port, d = str(_free_port()), str(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    argv = LAUNCH + ["--sync-mode", "lsgd", "--intra-group-size", "1"]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port, d,
                               *argv], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r} True 3" in out, out[-3000:]
    assert checkpoint.latest_step(d) == 3
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000001",
                                     "step_00000002", "step_00000003"]
