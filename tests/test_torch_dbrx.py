"""dbrx-132b on the port: GQA attention with an MoE FFN (no MLA, no shared
expert, no dense first layers), against the JAX package on the CPU.  Its
smoke variant (2 layers, d_model 256, 4 experts top-2 of d_ff 256) at 2
kv heads, so that it stays GQA (its smoke rule would give 4 over 4),
carried across by path (the ``moe`` subtree beside a GQA ``attn``); the
forward at the training capacity and dropless; the loss with its
load-balance term; ``prefill`` + greedy ``decode_step`` under naive and
pallas attention; and ``paged_step`` / ``paged_decode_loop``.  The
``Engine`` is ``test_torch_dbrx_engine.py``.  Tolerances:
``torch_decoders``; the loss within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from torch_decoders import (FWD_TOL, carried, check_forward, check_interop,
                            check_paged_step_and_loop, check_static,
                            jax_static)
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "dbrx-132b"
SMOKE = dict(num_kv_heads=2)
B, S = 2, 13


@pytest.fixture(scope="module")
def models():
    return carried(ARCH, **SMOKE)


@pytest.fixture(scope="module")
def tokens(models):
    return np.random.default_rng(1).integers(
        0, models[0].vocab_size, (B, S)).astype(np.int32)


def test_full_width_config_builds():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.vocab_size, cfg.mla) == \
        (40, 6144, 48, 8, 128, 100352, None)
    m = cfg.moe
    assert (m.num_experts, m.num_experts_per_tok, m.d_ff_expert,
            m.num_shared_experts, m.first_k_dense) == (16, 4, 10752, 0, 0)
    assert ttf.runs_of(cfg) == [("attn", "moe", 40)]
    spec = build_model(cfg).paged_spec
    assert dict(spec.kernel_spec)["attn"] == \
        "decode_view_attend/flash_decode_paged"


def test_interop_carries_the_moe_beside_gqa(models):
    paths = check_interop(models)
    run = {p.split("::", 2)[2] for p in paths if p.startswith("layers::")}
    assert {"attn::wq", "attn::wk", "attn::wv", "attn::wo",
            "moe::router::w", "moe::experts::w_gate", "moe::experts::w_up",
            "moe::experts::w_down"} <= run
    assert not any(p.startswith(("shared", "mlp")) for p in run)
    assert ttf.runs_of(models[3]) == [("attn", "moe", 2)]


def test_forward_matches_in_both_moe_forms(models, tokens):
    """The full-sequence forward at the training capacity (the
    reference's ``forward``) and dropless (its ``prefill``)."""
    check_forward(models, tokens)
    jcfg, _, jparams, _, tmodel, tparams = models
    want, _ = jtf.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                          cache_len=S)
    got, _, _, _ = tmodel.forward(tparams, torch.from_numpy(tokens),
                                  dropless=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_loss_carries_the_load_balance_term(models, tokens):
    jcfg, _, jparams, _, tmodel, tparams = models
    jl, jm = jtf.lm_loss(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    tl, tm = tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens)})
    assert tm.keys() == jm.keys() == {"ce", "aux", "loss"}
    assert float(tm["aux"]) > 0
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) < 1e-5, k


@pytest.fixture(scope="module")
def static_want(models, tokens):
    return jax_static(models, tokens, S + 8)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_prefill_and_decode_steps_match(models, tokens, static_want, impl):
    check_static(models, static_want, tokens, S + 8, impl)


def test_paged_step_and_decode_loop_match(models):
    check_paged_step_and_loop(models)
