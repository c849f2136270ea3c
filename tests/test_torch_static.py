"""The port's non-paged entry point (``Model.init_cache`` / ``prefill`` /
``decode_step``, the static-batch serving path) against the JAX
package's on carried-across weights: smoke qwen2 at ``attn_impl``
naive, blocked and pallas (the JAX side's Pallas flash attention in
interpret mode), the smoke mamba2 and the smoke deepseek-v3 cut to 3
layers (one dense layer, then a stacked run of 2 MoE layers, dropless
under the cache as in the reference).

For each: the zero cache of ``init_cache``; ``prefill``'s logits and
cache; 8 greedy ``decode_step``s, each framework fed its own tokens,
which must be identical, with matching logits and final caches; the
same with a cache shorter than prompt + steps, so the decode wraps
round its ring (qwen2, deepseek; mamba keeps no slots); ``lm_loss``
under ``blocked``; and for qwen2 under ``pallas`` a loss with a
gradient raises (the flash-attention kernel has no backward).

Tolerances: float32 on the CPU; logits and caches within atol/rtol
1e-4 (two f32 stacks of matmuls summing in other orders), tokens
exactly equal, the loss within 1e-5 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_map
from test_torch_mla_engine import carried_deepseek
from test_torch_model import carried_models
from test_torch_ssm_engine import carried_mamba
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, STEPS = 2, 12, 8
# blocks of 4 tokens, so the 12-token prompt runs the blocked loop
BLOCKS = dict(attn_block_q=4, attn_block_kv=4)
# cache lengths: room for every step, and 4 short of it (the decode
# wraps round the ring for its last 4 steps)
CACHE_LENS = {"full": S + STEPS, "ring": S + STEPS - 4}


@functools.lru_cache(maxsize=None)
def _carried(family):
    """(jax cfg, jax params, port cfg, port params) of a family, carried
    across once per module (the tests that need gradients clone the
    port's params)."""
    if family == "qwen2":
        jcfg, _, jparams, tcfg, _, tparams = carried_models(BLOCKS)
    elif family == "mamba2":
        jcfg, _, jparams, tcfg, _, tparams = carried_mamba()
    else:
        jcfg, _, jparams, tcfg, _, tparams = carried_deepseek()
    return jcfg, jparams, tcfg, tparams


def _case(name):
    family, _, impl = name.partition("-")
    jcfg, jparams, tcfg, tparams = _carried(family)
    if impl:
        jcfg, tcfg = (c.replace(attn_impl=impl) for c in (jcfg, tcfg))
    return jcfg, jparams, tcfg, tparams


CASES = ("qwen2-naive", "qwen2-blocked", "qwen2-pallas", "mamba2",
         "deepseek")
RINGS = [(name, ring) for name in CASES
         for ring in (("full", "ring") if name != "mamba2" else ("full",))]


def _np(x):
    return np.asarray(x).astype(np.float32)


def _run_jax(jcfg, jparams, tokens, cache_len):
    """prefill + STEPS greedy decode_steps of the JAX package: (prefill
    logits, zero cache, prefill cache, per-step logits, tokens, final
    cache), as numpy."""
    prefill = jax.jit(functools.partial(jtf.prefill, cfg=jcfg),
                      static_argnames=("cache_len",))
    decode = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    zero = jtf.init_cache(jcfg, B, cache_len)
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(tokens)},
                            cache_len=cache_len)
    pre = (np.asarray(logits), jax.tree.map(_np, cache))
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    steps, toks = [], [np.asarray(tok[:, 0])]
    for i in range(STEPS):
        lg, cache = decode(jparams, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        steps.append(np.asarray(lg))
        toks.append(np.asarray(tok[:, 0]))
    return (pre[0], jax.tree.map(_np, zero), pre[1], steps, np.stack(toks),
            jax.tree.map(_np, cache))


@pytest.fixture(scope="module", params=RINGS, ids=lambda r: "-".join(r))
def runs(request):
    """Both frameworks' prefill + decode on the same prompt, once per
    (model, cache length)."""
    name, ring = request.param
    jcfg, jparams, tcfg, tparams = _case(name)
    cache_len = CACHE_LENS[ring]
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    want = _run_jax(jcfg, jparams, tokens, cache_len)
    zero = ttf.init_cache(tcfg, B, cache_len, device="cpu")
    logits, cache = ttf.prefill(tparams, torch.tensor(tokens), tcfg,
                                cache_len)
    pre = (logits.numpy(), {r: {k: v.float().numpy().copy()
                                for k, v in c.items()}
                            for r, c in cache.items()})
    tok = logits[:, -1].argmax(-1)[:, None]
    steps, toks = [], [tok[:, 0].numpy()]
    pos = torch.tensor(S)
    for i in range(STEPS):
        lg, cache = ttf.decode_step(tparams, cache, tok, pos + i, tcfg)
        tok = lg.argmax(-1)[:, None]
        steps.append(lg.numpy())
        toks.append(tok[:, 0].numpy())
    got = (pre[0], zero, pre[1], steps, np.stack(toks), cache)
    return name, want, got


def _assert_caches(got, want):
    assert got.keys() == want.keys()
    for run in want:
        assert got[run].keys() == want[run].keys()
        for k in want[run]:
            g = got[run][k]
            g = g.float().numpy() if torch.is_tensor(g) else g
            assert g.shape == want[run][k].shape, (run, k)
            np.testing.assert_allclose(g, want[run][k], **TOL)


def test_init_cache_matches(runs):
    _, want, got = runs
    _assert_caches(got[1], want[1])


def test_prefill_logits_and_cache_match(runs):
    _, want, got = runs
    np.testing.assert_allclose(got[0], want[0], **TOL)
    _assert_caches(got[2], want[2])


def test_greedy_decode_steps_match(runs):
    _, want, got = runs
    np.testing.assert_array_equal(got[4], want[4])
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g, w, **TOL)
    _assert_caches(got[5], want[5])


@pytest.mark.parametrize("name", ["qwen2-blocked", "mamba2"])
def test_lm_loss_under_blocked_matches(name):
    jcfg, jparams, tcfg, tparams = _case(name)
    jcfg, tcfg = (c.replace(attn_impl="blocked") for c in (jcfg, tcfg))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, 16))
    want, _ = jax.jit(functools.partial(jtf.lm_loss, cfg=jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)})
    tparams = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    got, _ = ttf.lm_loss(tparams, {"tokens": torch.tensor(tokens)}, tcfg)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_pallas_loss_with_a_gradient_raises():
    _, _, tcfg, tparams = _case("qwen2-pallas")
    params = dict(tparams, embed={
        "embedding": tparams["embed"]["embedding"].clone().requires_grad_(
            True)})
    tokens = torch.randint(0, tcfg.vocab_size, (B, S))
    with pytest.raises(RuntimeError, match="no backward"):
        ttf.lm_loss(params, {"tokens": tokens}, tcfg)
    with torch.no_grad():
        loss, _ = ttf.lm_loss(params, {"tokens": tokens}, tcfg)
    assert torch.isfinite(loss)
