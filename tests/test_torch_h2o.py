"""h2o-danube-3-4b on the port against the JAX package on the CPU: its
smoke variant at its own head dim 120 over 2 kv heads (the smoke rule
would give hd 64) carried across by path; the forward past its 64-token
window; ``prefill`` + greedy ``decode_step`` under naive and pallas
attention with the ring past the window; ``paged_step`` /
``paged_decode_loop``; and the ``Engine`` token-identical to the JAX
engine at depths 1 and 8 with prompts past the window, reclaiming the
blocks the JAX engine reclaims.  The kernels' plain versions at hd 120
are ``test_torch_head_dim_120.py``.  Tolerances: ``torch_decoders``.
"""
import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from torch_decoders import (carried, check_engine, check_forward,
                            check_interop, check_paged_step_and_loop,
                            check_static, jax_engine_streams, jax_static)
from torch_threads import one_torch_thread  # noqa: F401

HD = 120
ARCH = "h2o-danube-3-4b"
SMOKE = dict(head_dim=HD, num_kv_heads=2)
# 8-token blocks, sequences up to 128 tokens: prompts past the 64-token
# window reclaim their dead blocks
H2O = dict(max_batch=3, block_size=8, num_blocks=65, max_seq_len=128,
           prefill_chunk=16, prefill_token_budget=24)


def _workload(vocab):
    """Six requests, four with prompts past the 64-token window."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (int(p),)).astype(np.int32), int(g))
            for p, g in zip((70, 9, 95, 66, 30, 81), rng.integers(4, 21, 6))]


@pytest.fixture(scope="module")
def models():
    return carried(ARCH, **SMOKE)


@pytest.fixture(scope="module")
def tokens(models):
    return np.random.default_rng(1).integers(
        0, models[0].vocab_size, (2, 80)).astype(np.int32)


def test_full_width_config_builds():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.sliding_window) == \
        (24, 3840, 32, 8, 120, 10240, 32000, 4096)
    assert ttf.runs_of(cfg) == [("attn", "dense", 24)]
    spec = build_model(cfg).paged_spec
    assert spec.reclaim_window == 4096 and not spec.has_state


def test_interop_and_forward_past_the_window(models, tokens):
    check_interop(models)
    assert models[3].head_dim == HD and models[3].sliding_window == 64
    check_forward(models, tokens)


@pytest.fixture(scope="module")
def static_want(models, tokens):
    return jax_static(models, tokens[:, :70], 78)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_prefill_and_decode_steps_match(models, tokens, static_want, impl):
    """A 70-token prefill into a cache cut to the 64-token window (a
    ring), then 8 greedy steps."""
    check_static(models, static_want, tokens[:, :70], 78, impl)


def test_paged_step_and_decode_loop_match(models):
    check_paged_step_and_loop(models)


@pytest.fixture(scope="module")
def engine_want(models):
    work = _workload(models[0].vocab_size)
    return work, jax_engine_streams(models, work, H2O)


@pytest.mark.parametrize("spd", [1, 8])
def test_engine_token_identical_to_jax_engine(models, engine_want, spd):
    work, want = engine_want
    assert want["greedy"][1] > 0          # blocks behind the window freed
    check_engine(models, work, H2O, want, spd=spd)
