"""The port's encoder-decoder (whisper-tiny's smoke variant: 2 encoder and
2 decoder layers at d 256, 4 heads of 64, layernorm, gelu, tied
embeddings, 32 stub frames) against the JAX package on carried-across
weights (norm scales and biases perturbed, so that every param matters):

- the config field for field, the params tree by path (interop both
  ways, the port's own init at the reference's shapes), ``init_cache``;
- ``encode``; ``loss`` and its gradient against ``jax.value_and_grad``,
  plain and under ``remat``;
- ``prefill``'s logits and cache (self K/V of ``cache_len`` slots, cross
  K/V), and the cross K/V against the reference's ``make_cross_cache``;
- ``prefill`` plus 8 greedy ``decode_step``s, each package fed its own
  tokens, under ``attn_impl`` naive, blocked and pallas (kernels 6 and 7
  through their plain versions on the CPU): the same tokens, logits and
  final cache as the JAX package's (naive; its functions are the same
  under every impl);
- kernel 6's plain version non-causal with one query head per kv head
  and ragged lengths against ``repro.kernels.ref``;
- a whisper trainer checkpoint written by the port restores through the
  reference's ``checkpoint.restore``, and back, exactly (the
  launcher's whisper run is in ``tests/test_torch_trainer.py``).

The JAX results are computed once, in a module fixture.  Tolerances:
float32 on the CPU; loss and gradients within 1e-5
(``tests/test_equivalence.py``'s bound), logits, encoder outputs and
caches within atol/rtol 1e-4 (two f32 stacks of matmuls summing in
other orders), tokens exactly equal.
"""
import dataclasses

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
from repro.kernels import ref as kref
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models.model import build_model as jax_build_model
from repro_torch import interop
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import trainer
from repro_torch.core.autodiff import value_and_grad
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models.model import build_model
from repro_torch.serve import Engine
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-tiny"
TOL = dict(atol=1e-4, rtol=1e-4)
BOUND = 1e-5
B, S, STEPS, CACHE = 2, 12, 8, 24
PERTURBED = ("scale", "bias")


def carried_whisper(seed=0):
    """(jax cfg, jax params, port cfg, port model, port params) for the
    smoke whisper, with the norms' scales and biases perturbed."""
    jcfg = jax_smoke_variant(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    tree = jax_build_model(jcfg).init(jax.random.key(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.split("::")[-1] in PERTURBED:
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [jnp.asarray(flat[k]) for k in _flatten(tree)])
    return (jcfg, jparams, tcfg, build_model(tcfg),
            interop.from_flat(flat, device="cpu"))


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)
                                ).astype(np.float32)
    return audio, rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    return carried_whisper()


@pytest.fixture(scope="module")
def ref(models):
    """The JAX package's results, once: encoder output, loss and
    gradients, the cross K/V of layer 0, prefill and a greedy decode."""
    jcfg, jparams = models[:2]
    audio, toks = _inputs(jcfg)
    batch = {"audio_embeds": jnp.asarray(audio), "tokens": jnp.asarray(toks)}
    enc = jed.encode(jparams, batch["audio_embeds"], jcfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jed.loss(p, batch, jcfg), has_aux=True))(jparams)
    layer0 = jax.tree.map(lambda x: x[0], jparams["decoder"]["layers"])
    cross = jattn.make_cross_cache(layer0["xattn"], enc, jcfg)
    logits, cache = jed.prefill(jparams, batch, jcfg, cache_len=CACHE)
    out = {"enc": np.asarray(enc), "loss": float(loss),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {k: np.asarray(v) for k, v in _flatten(grads).items()},
           "cross": {k: np.asarray(v) for k, v in cross.items()},
           "prefill": (np.asarray(logits),
                       {k: np.asarray(v) for k, v in cache.items()})}
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    step = jax.jit(lambda p, c, t, pos: jed.decode_step(p, c, t, pos, jcfg))
    toks_out, step_logits = [np.asarray(tok)], []
    for i in range(STEPS):
        lg, cache = step(jparams, cache, tok[:, None], jnp.int32(S + i))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks_out.append(np.asarray(tok))
        step_logits.append(np.asarray(lg))
    out["decode"] = (np.stack(toks_out, 1), step_logits,
                     {k: np.asarray(v) for k, v in cache.items()})
    return out


def _batch(cfg):
    audio, toks = _inputs(cfg)
    return {"audio_embeds": torch.from_numpy(audio),
            "tokens": torch.from_numpy(toks)}


def test_config_fields_match_reference():
    for conv in (lambda c: c, jax_smoke_variant):
        tconv = smoke_variant if conv is jax_smoke_variant else conv
        assert dataclasses.asdict(conv(jax_get_config(ARCH))) == \
            dataclasses.asdict(tconv(get_config(ARCH)))


def test_interop_round_trip_init_shapes_and_members(models):
    jcfg, jparams, tcfg, tmodel, tparams = models
    ref = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    flat = interop.to_flat(tparams)
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k])
    own = interop.to_flat(tmodel.init(7, "cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert {k for k in own if k.endswith("bias")} == \
        {k for k in ref if k.endswith("bias")}
    assert all(float(np.abs(own[k]).max()) == 0 for k in own
               if k.endswith("bias"))
    want = jed.init_cache(jcfg, B, CACHE)
    got = tmodel.init_cache(B, CACHE, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    # the audio family serves through the static entry point only
    assert tmodel.paged_spec is None and tmodel.paged_step is None
    assert tmodel.forward is None and tmodel.paged_decode_loop is None
    with pytest.raises(ValueError, match="'audio' family has no paged"):
        Engine(tmodel, tparams, device="cpu")


def test_encode_matches(models, ref):
    tcfg, _, tparams = models[2:]
    got = ted.encode(tparams, _batch(tcfg)["audio_embeds"], tcfg)
    np.testing.assert_allclose(got.numpy(), ref["enc"], **TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grad_match_jax(models, ref, remat):
    tcfg, _, tparams = models[2:]
    tcfg = tcfg.replace(remat=remat)
    loss, metrics, grads = value_and_grad(
        lambda p, b: ted.loss(p, b, tcfg), tparams, _batch(tcfg))
    assert abs(float(loss) - ref["loss"]) < BOUND
    assert metrics.keys() == ref["metrics"].keys()
    got = interop.to_flat(grads)
    assert got.keys() == ref["grads"].keys()
    assert max(float(np.abs(got[k] - w).max())
               for k, w in ref["grads"].items()) < BOUND


def test_cross_cache_matches_make_cross_cache(models, ref):
    tcfg, _, tparams = models[2:]
    layer0 = {k: {n: t[0] for n, t in v.items()} if isinstance(v, dict)
              else v[0] for k, v in tparams["decoder"]["layers"].items()}
    got = tattn.make_cross_cache(layer0["xattn"],
                                 torch.from_numpy(ref["enc"].copy()), tcfg)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k].numpy(), ref["cross"][k], **TOL)
    # the prefill's cross K/V of layer 0 is that cache
    np.testing.assert_allclose(ref["prefill"][1]["cross_k"][0],
                               ref["cross"]["k"], **TOL)


def _assert_cache(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL)


@pytest.mark.parametrize("impl", ["naive", "blocked", "pallas"])
def test_prefill_and_greedy_decode_match(models, ref, impl):
    """The port under each attention form against the reference's naive
    run: prefill logits and cache, then 8 greedy steps, each package fed
    its own tokens."""
    tcfg, _, tparams = models[2:]
    tcfg = tcfg.replace(attn_impl=impl, attn_block_q=4, attn_block_kv=4)
    tmodel = build_model(tcfg)
    with torch.no_grad():
        logits, cache = tmodel.prefill(tparams, _batch(tcfg),
                                       cache_len=CACHE)
        np.testing.assert_allclose(logits.numpy(), ref["prefill"][0], **TOL)
        _assert_cache(cache, ref["prefill"][1])
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        toks, step_logits = [tok], []
        for i in range(STEPS):
            lg, cache = tmodel.decode_step(tparams, cache, tok[:, None],
                                           torch.tensor(S + i))
            tok = lg.argmax(-1).to(torch.int32)
            toks.append(tok)
            step_logits.append(lg.numpy())
    want_toks, want_logits, want_cache = ref["decode"]
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), want_toks)
    for g, w in zip(step_logits, want_logits):
        np.testing.assert_allclose(g, w, **TOL)
    _assert_cache(cache, want_cache)


@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 130)])
def test_flash_attention_plain_noncausal_one_head_a_group(sq, sk):
    """Kernel 6's plain version as whisper's encoder calls it: not
    causal, one query head per kv head, lengths no block divides."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, 3, sq, 64)).astype(np.float32)
    k = rng.standard_normal((2, 3, sk, 64)).astype(np.float32)
    v = rng.standard_normal((2, 3, sk, 64)).astype(np.float32)
    want = np.asarray(kref.flash_attention_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    got = fa.flash_attention_bhsd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the wrapper on CPU tensors, (B, S, H, hd) in and out
    got = fa.flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                               for x in (q, k, v)), causal=False)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                               atol=1e-5, rtol=1e-5)


def test_checkpoint_restores_across_both_packages(tmp_path, models):
    """Two LSGD steps of the port's whisper trainer (bf16 pending
    buffer), saved; the reference's ``restore`` reads it exactly, and
    what the reference saves back restores into the port exactly."""
    jcfg, _, tcfg, tmodel, _ = models
    tc = trainer.TrainerConfig(sync_mode="lsgd", pending_dtype="bfloat16")
    init = lambda: trainer.make_init_state(tmodel, tc, "cpu")(0)
    step = trainer.make_step(tmodel, tc, lambda t: 0.05)
    state = init()
    for t in range(2):
        state, _ = step(state, _batch(tcfg))
    checkpoint.save(str(tmp_path / "port"), state, state["step"])
    jmodel = jax_build_model(jcfg)
    template = jax_make_init_state(
        jmodel, JaxTrainerConfig(sync_mode="lsgd", pending_dtype="bfloat16")
    )(jax.random.key(0))
    got = jckpt.restore(str(tmp_path / "port"), template)
    assert int(got["step"]) == 2
    assert got["pending"]["embed"]["embedding"].dtype == jnp.bfloat16
    flat = _flatten(got)
    want = {f"{part}::{k}": v for part, tree in
            (("params", state["params"]), ("opt::m", state["opt"]["m"]),
             ("pending", state["pending"]))
            for k, v in interop.to_flat(tree).items()}
    assert flat.keys() - {"step"} == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(flat[k], np.float32), w)
    jckpt.save(str(tmp_path / "jax"), got, 2)
    back = checkpoint.restore(str(tmp_path / "jax"), init())
    assert back["step"] == 2
    for a, b in zip(leaves(back["params"]), leaves(state["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(leaves(back["pending"]), leaves(state["pending"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
