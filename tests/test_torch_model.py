"""The port's model against the JAX package's on the same weights: the
smoke qwen2 params are carried across by ``repro_torch.interop`` (with
random biases and norm scales, so every param matters), then
``forward`` logits, ``paged_step`` and ``paged_decode_loop`` outputs and
pools are compared on the same numpy inputs.

Tolerances: float32 throughout; logits and pools within atol/rtol 1e-4
(two f32 stacks of matmuls summing in different orders); sampled tokens,
counts and flags exactly equal.  The trash block (physical 0) is left out
of pool comparisons: padded rows write it with duplicate indices, whose
winner neither framework defines.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models import transformer as jtf
from repro.models.model import build_model as jax_build_model
from repro_torch import interop
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def carried_models(overrides=None, seed=0):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    for the smoke qwen2 config, weights carried across."""
    overrides = overrides or {}
    jcfg = jax_smoke_variant(jax_get_config("qwen2-1.5b")).replace(
        mtp_depth=0, **overrides)
    tcfg = smoke_variant(get_config("qwen2-1.5b")).replace(**overrides)
    jmodel = jax_build_model(jcfg)
    flat = {k: np.asarray(v) for k, v in
            _flatten(jmodel.init(jax.random.key(seed))).items()}
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.split("::")[-1] in ("bq", "bk", "bv", "scale"):
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jmodel.init(jax.random.key(seed))),
        [jnp.asarray(flat[k]) for k in
         _flatten(jmodel.init(jax.random.key(seed)))])
    tparams = interop.from_flat(flat, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def models():
    return carried_models()


@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen2-1.5b-swa",
                                  "minicpm-2b", "h2o-danube-3-4b",
                                  "dbrx-132b", "llava-next-34b"])
def test_config_fields_match_reference(name):
    """Full and smoke, field for field."""
    import dataclasses
    for conv in (lambda c: c, jax_smoke_variant):
        j = dataclasses.asdict(conv(jax_get_config(name)))
        t = dataclasses.asdict(
            (smoke_variant if conv is jax_smoke_variant
             else (lambda c: c))(get_config(name)))
        assert j == t, name


def test_interop_roundtrip_is_exact(models):
    _, _, jparams, _, _, tparams = models
    flat = interop.to_flat(tparams)
    ref = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k])
    assert tparams["layers"]["run_0"]["attn"]["wq"].shape[0] == 2


def test_interop_carries_bfloat16_bits():
    x = np.asarray(jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16))
    t = interop.from_flat({"a::b": x})["a"]["b"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))


def test_forward_logits_match(models):
    jcfg, _, jparams, tcfg, tmodel, tparams = models
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 19))
    want, _, _, _ = jtf.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                jcfg)
    got, _, _, _ = tmodel.forward(tparams, torch.tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


NB, BS, NBS = 17, 8, 4          # pool blocks, block size, blocks per seq


def _pools(jcfg, seed):
    """Identical random pools (garbage everywhere, as a served pool
    holds) for both frameworks."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.num_layers, NB, BS, jcfg.num_kv_heads, jcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jcache = {"run_0": {"k": jnp.asarray(k), "v": jnp.asarray(v),
                        "block_tables": jnp.zeros((jcfg.num_layers, 0, 0),
                                                  jnp.int32)}}
    tcache = {"run_0": {"k": torch.tensor(k), "v": torch.tensor(v)}}
    return jcache, tcache


def _assert_pools_equal(jcache, tcache):
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache["run_0"][name].numpy()[:, 1:],
            np.asarray(jcache["run_0"][name])[:, 1:], **TOL)


def _step_both(jcfg, jparams, tmodel, tparams, jstate, tstate, tokens, bt,
               meta):
    jcache, jslot = jstate
    tcache, tslot = tstate
    jfn = jax.jit(functools.partial(jtf.paged_step, cfg=jcfg))
    jt, jslot, jcache = jfn(jparams, jcache, jslot, jnp.asarray(tokens),
                            jnp.asarray(bt), jnp.asarray(meta))
    tt, tslot, tcache = tmodel.paged_step(
        tparams, tcache, tslot, torch.tensor(tokens), torch.tensor(bt),
        torch.tensor(meta))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _assert_pools_equal(jcache, tcache)
    return (jcache, jslot), (tcache, tslot), np.asarray(jt)


def test_paged_step_and_decode_loop_match(models):
    jcfg, _, jparams, tcfg, tmodel, tparams = models
    rng = np.random.default_rng(2)
    jcache, tcache = _pools(jcfg, 3)
    nslots = 5
    jstate = (jcache, jnp.zeros((nslots + 1,), jnp.int32))
    tstate = (tcache, torch.zeros((nslots + 1,), dtype=torch.int32))
    v = jcfg.vocab_size

    # 1) prefill: chunk-wide rows; row 1 is ragged, row 2 is padding
    tokens = rng.integers(0, v, (3, 12)).astype(np.int32)
    bt = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    meta = np.array([[0, 0, 0], [12, 7, 0], [-1, -1, -1], [0, 1, -1],
                     [0, 0, 0], [0, 1, 2]], np.int32)
    jstate, tstate, first = _step_both(jcfg, jparams, tmodel, tparams,
                                       jstate, tstate, tokens, bt, meta)

    # 2) mixed width-1 step: two decode rows wired from the slot buffer,
    #    a 3-token prompt split into one row per token, one padding row
    p3 = rng.integers(0, v, (3,)).astype(np.int32)
    tokens = np.zeros((6, 1), np.int32)
    tokens[2:5, 0] = p3
    bt = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0],
                   [7, 0, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    meta = np.array([[12, 7, 0, 1, 2, 0], [1, 1, 1, 1, 1, 0],
                     [0, 1, -1, -1, -1, -1], [0, 1, -1, -1, 2, -1],
                     [0] * 6, [0, 1, 2, 2, 2, 0]], np.int32)
    jstate, tstate, second = _step_both(jcfg, jparams, tmodel, tparams,
                                        jstate, tstate, tokens, bt, meta)
    np.testing.assert_array_equal(tstate[1].numpy(), np.asarray(jstate[1]))

    # 3) N-step loop; row 2's table ends at block 7, so the capacity
    #    predicate stops it at position 8; row 0 stops on an eos planted
    #    from a first run
    bt = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0],
                   [0, 0, 0, 0]], np.int32)
    n = 6

    def loop(eos0):
        meta = np.array([[13, 8, 3, 0], [6, 4, 6, 0], [0, 1, 2, 0],
                         [0] * 4, [0, 1, 2, 0], [eos0, -1, -1, -1]],
                        np.int32)
        jfn = jax.jit(functools.partial(jtf.paged_decode_loop, cfg=jcfg,
                                        num_steps=n))
        jout = jfn(jparams, jstate[0], jstate[1], jnp.asarray(bt),
                   jnp.asarray(meta))
        tout = tmodel.paged_decode_loop(
            tparams, {"run_0": {k: t.clone() for k, t in
                                tstate[0]["run_0"].items()}},
            tstate[1].clone(), torch.tensor(bt), torch.tensor(meta),
            num_steps=n)
        for j, t in zip(jout[:4], tout[:4]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        _assert_pools_equal(jout[4], tout[4])
        return [np.asarray(x) for x in jout[:3]]

    out, counts, eos_hit = loop(-1)
    np.testing.assert_array_equal(counts, [6, 4, 5, 0])
    assert not eos_hit.any()
    out, counts, eos_hit = loop(int(out[0, 2]))
    assert counts[0] <= 3 and eos_hit[0]


def test_paged_step_padding_row_cannot_clobber_live_blocks(models):
    """A valid_len-0 row carrying a live sequence's table writes only
    the trash block (the reference's stale-row regression)."""
    jcfg, _, _, _, tmodel, tparams = models
    _, tcache = _pools(jcfg, 4)
    before = tcache["run_0"]["k"].clone()
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    bt = torch.tensor([[1, 2, 0, 0], [1, 2, 0, 0]], dtype=torch.int32)
    meta = torch.tensor([[0, 0], [0, 0], [-1, -1], [-1, -1], [0, 0],
                         [0, 0]], dtype=torch.int32)
    tmodel.paged_step(tparams, tcache, torch.zeros(3, dtype=torch.int32),
                      tokens, bt, meta)
    assert torch.equal(tcache["run_0"]["k"][:, 1:], before[:, 1:])


def test_init_params_shapes_match_reference(models):
    jcfg, jmodel, jparams, tcfg, tmodel, _ = models
    tparams = tmodel.init(7, "cpu")
    flat = interop.to_flat(tparams)
    ref = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert ttf.runs_of(tcfg) == [("attn", "dense", tcfg.num_layers)]


def test_kernel_spec_names_the_port_kernels(models):
    from repro_torch import kernels
    mamba = build_model(get_config("mamba2-370m"))
    deepseek = build_model(get_config("deepseek-v3-671b"))
    dbrx = build_model(get_config("dbrx-132b"))
    named = {n for spec in (models[4].paged_spec, mamba.paged_spec,
                            deepseek.paged_spec, dbrx.paged_spec)
             for _, ops in spec.kernel_spec for n in ops.split("/")}
    # GQA + MoE (dbrx) serves its attention through the dense family's
    # kernels 1 and 2
    assert dict(dbrx.paged_spec.kernel_spec) == dict(
        models[4].paged_spec.kernel_spec)
    # every kernel but the optimizer update, which runs on the training
    # path, the SSD block, which (as in the reference) only
    # ``ssd_chunked_pallas`` reaches, and the two attention kernels of
    # the non-paged prefill / decode_step, serves a layer kind's paged
    # hot path of the dense, the mamba or the MLA family
    assert named == {fn.__name__ for fn in kernels.KERNELS} - {
        kernels.fused_sgd_update.__name__, kernels.ssd_chunk_bchp.__name__,
        kernels.flash_attention.flash_attention.__name__,
        kernels.flash_decode.flash_decode.__name__}
