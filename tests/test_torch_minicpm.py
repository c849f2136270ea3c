"""minicpm-2b on the port against the JAX package on the CPU: its smoke
variant (2 layers, d_model 256, 4 query heads over 4 kv heads, so G = 1
on kernels 1 and 2, tied embeddings: no ``lm_head``) carried across by
path; the forward; ``prefill`` + greedy ``decode_step`` under naive and
pallas attention; ``paged_step`` / ``paged_decode_loop``; and the
``Engine`` token-identical to the JAX engine at depths 1 and 8.  The
full-width config (36 heads over 36 at hd 64, vocab 122,753) builds.
Tolerances: ``torch_decoders``.
"""
import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from test_torch_engine import WIDE, _workload
from torch_decoders import (carried, check_engine, check_forward,
                            check_interop, check_paged_step_and_loop,
                            check_static, jax_engine_streams, jax_static)
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "minicpm-2b"
B, S = 2, 19


@pytest.fixture(scope="module")
def models():
    return carried(ARCH)


@pytest.fixture(scope="module")
def tokens(models):
    return np.random.default_rng(1).integers(
        0, models[0].vocab_size, (B, S)).astype(np.int32)


def test_full_width_config_builds():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) == \
        (40, 2304, 36, 36, 64, 5760, 122753, True)
    assert ttf.runs_of(cfg) == [("attn", "dense", 40)]
    spec = build_model(cfg).paged_spec
    assert dict(spec.kernel_spec)["attn"] == \
        "decode_view_attend/flash_decode_paged"
    assert spec.reclaim_window == 0


def test_interop_has_no_lm_head(models):
    paths = check_interop(models)
    assert not any(p.startswith("lm_head") for p in paths)
    assert models[3].num_heads == models[3].num_kv_heads


def test_forward_matches(models, tokens):
    check_forward(models, tokens)


@pytest.fixture(scope="module")
def static_want(models, tokens):
    return jax_static(models, tokens, S + 8)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_prefill_and_decode_steps_match(models, tokens, static_want, impl):
    check_static(models, static_want, tokens, S + 8, impl)


def test_paged_step_and_decode_loop_match(models):
    check_paged_step_and_loop(models)


@pytest.fixture(scope="module")
def engine_want(models):
    work = _workload(models[0].vocab_size)
    return work, jax_engine_streams(models, work, WIDE)


@pytest.mark.parametrize("spd", [1, 8])
def test_engine_token_identical_to_jax_engine(models, engine_want, spd):
    work, want = engine_want
    check_engine(models, work, WIDE, want, spd=spd)
