"""llava-next-34b on the port, the vlm family: a dense GQA decoder whose
full-sequence forward takes an image-embedding prefix, against the JAX
package on the CPU.  Its smoke variant (2 layers, d_model 256, 16 image
tokens) at 2 kv heads, so that it stays GQA (its smoke rule would give
4 over 4), carried across by path: the forward over a 16-token stub
image prefix and the text; ``prefill`` over the prefix + greedy
``decode_step`` under naive and pallas attention; ``lm_loss`` and every
gradient against ``jax.value_and_grad`` with ``loss_chunk`` off and on
(image positions masked), and without an image; text-only
``paged_step`` / ``paged_decode_loop`` and the ``Engine`` token-identical
to the JAX engine at depths 1 and 8 (the reference's engine carries no
image either).  Tolerances: ``torch_decoders``; the loss, its metrics
and every gradient within 1e-5 (``tests/test_equivalence.py``'s bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.autodiff import value_and_grad
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.serve.profile_engine import DEPTH_CUTS
from test_torch_engine import WIDE, _workload
from torch_decoders import (carried, check_engine, check_forward,
                            check_interop, check_paged_step_and_loop,
                            check_static, jax_engine_streams, jax_static)
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "llava-next-34b"
SMOKE = dict(num_kv_heads=2)
B, S = 2, 13
BOUND = 1e-5


@pytest.fixture(scope="module")
def models():
    return carried(ARCH, **SMOKE)


@pytest.fixture(scope="module")
def inputs(models):
    """Text tokens (B, S) and a stub image prefix (B, 16, D), numpy."""
    cfg = models[0]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    image = rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model)
                                ).astype(np.float32)
    return tokens, image


def test_full_width_config_builds():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.rope_theta, cfg.num_image_tokens) == \
        ("vlm", 60, 7168, 56, 8, 128, 20480, 64000, 5e6, 2880)
    assert ttf.runs_of(cfg) == [("attn", "dense", 60)]
    model = build_model(cfg)
    assert model.forward is not None and model.paged_step is not None
    assert DEPTH_CUTS[ARCH] == 30


def test_interop_and_forward_with_an_image_prefix(models, inputs):
    check_interop(models)
    assert models[3].num_image_tokens == 16
    tokens, image = inputs
    check_forward(models, tokens, image)
    check_forward(models, tokens)                # no image: text alone


def test_an_image_prefix_needs_the_full_sequence_forward(models, inputs):
    tcfg, tmodel, tparams = models[3:]
    tokens, image = inputs
    cache = tmodel.init_cache(B, 40, device="cpu")
    with pytest.raises(ValueError, match="full-sequence"):
        tmodel.forward(tparams, torch.from_numpy(tokens[:, :1]), cache=cache,
                       pos=3, image_embeds=torch.from_numpy(image))


@pytest.fixture(scope="module")
def static_want(models, inputs):
    tokens, image = inputs
    return jax_static(models, tokens, 16 + S + 8, image)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_prefill_over_the_image_and_decode_steps_match(models, inputs,
                                                       static_want, impl):
    tokens, image = inputs
    check_static(models, static_want, tokens, 16 + S + 8, impl, image)


def _max_diff(tparams, jparams):
    flat = interop.to_flat(tparams)
    ref = {k: np.asarray(v, np.float32) for k, v in _flatten(jparams).items()}
    assert flat.keys() == ref.keys()
    return max(float(np.abs(flat[k] - ref[k]).max()) for k in ref)


@pytest.mark.parametrize("chunk,with_image", [(0, True), (4, True),
                                              (0, False)])
def test_lm_loss_and_grad_match_jax(models, inputs, chunk, with_image):
    """Chunk 4 cuts the 16 + 13 - 1 predicting positions into 7 chunks,
    the first three wholly image positions."""
    jcfg, _, jparams, tcfg, _, tparams = models
    jcfg, tcfg = jcfg.replace(loss_chunk=chunk), tcfg.replace(loss_chunk=chunk)
    tokens, image = inputs
    jbatch = {"tokens": jnp.asarray(tokens)}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    if with_image:
        jbatch["image_embeds"] = jnp.asarray(image)
        tbatch["image_embeds"] = torch.from_numpy(image)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jbatch, jcfg), has_aux=True))(jparams)
    tl, metrics, tg = value_and_grad(lambda p, b: ttf.lm_loss(p, b, tcfg),
                                     tparams, tbatch)
    assert metrics.keys() == jm.keys() == {"ce", "aux", "loss"}
    assert abs(float(tl) - float(jl)) < BOUND
    for k in jm:
        assert abs(float(metrics[k]) - float(jm[k])) < BOUND, k
    assert _max_diff(tg, jg) < BOUND


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
