"""The port's Mamba-2 modules against the JAX package on the same numpy
inputs: the SSD functions (``ssd_chunked``, ``ssd_recurrent_step``,
``ssd_chunked_pallas`` with the JAX side through its Pallas kernel in
interpret mode), ``apply_ssm`` in its three cache forms, and the plain
versions of kernels 10-12 (slot gather / scatter, the SSD intra-chunk
block) against ``repro.kernels.ops`` and ``ref``.

Tolerances: float32 throughout unless stated; SSD outputs and states
within atol/rtol 1e-4 (sums over chunks and heads in other orders);
``apply_ssm`` within 1e-4; the slot gather / scatter bit for bit; the
SSD block against ``ref.ssd_chunk_bchp`` within 3e-5 / 2e-5 in f32 (the
JAX package's own kernel tolerance) and one bf16 ulp-ish 3e-2 in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.kernels import ops, ref
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import slot_state, ssd_chunk
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def mamba_configs(**ssm_overrides):
    """(jax cfg, port cfg): the tiny mamba of the reference's family
    tests (2 layers, d_model 64, vocab 128, d_state 8, head_dim 32,
    chunk 16)."""
    out = []
    for get, smoke in ((jax_get_config, jax_smoke_variant),
                       (get_config, smoke_variant)):
        cfg = smoke(get("mamba2-370m")).replace(num_layers=2, d_model=64,
                                                vocab_size=128)
        out.append(cfg.replace(ssm=dataclasses.replace(
            cfg.ssm, d_state=8, head_dim=32, chunk_size=16,
            **ssm_overrides)))
    return out


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


def test_config_matches_reference():
    for conv in (lambda c: c, "smoke"):
        j = jax_get_config("mamba2-370m")
        t = get_config("mamba2-370m")
        if conv == "smoke":
            j, t = jax_smoke_variant(j), smoke_variant(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    cfg = get_config("mamba2-370m")
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (48, 1024, 50280)
    assert cfg.ssm.dt_min == 0.001 and cfg.ssm.dt_max == 0.1


def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((h,)) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    return x, dt, A, B, C, s0


SSD_CASES = [
    # b, s, h, p, g, n, chunk, with an initial state
    (2, 48, 4, 32, 1, 8, 16, False),
    (1, 37, 2, 16, 2, 16, 16, True),     # ragged tail, 2 groups
    (2, 16, 4, 32, 1, 8, 16, True),      # one chunk
]


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("fn", ["ssd_chunked", "ssd_chunked_pallas"])
def test_ssd_chunked_matches_reference(case, fn):
    b, s, h, p, g, n, chunk, init = case
    x, dt, A, B, C, s0 = _ssd_inputs(sum(case[:6]), b, s, h, p, g, n)
    jin = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    tin = [_t(a) for a in (x, dt, A, B, C)]
    y_j, f_j = getattr(jssm, fn)(*jin, chunk=chunk,
                                 init_state=jnp.asarray(s0) if init else None)
    y_t, f_t = getattr(tssm, fn)(*tin, chunk=chunk,
                                 init_state=_t(s0) if init else None)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)
    # and the kernel's route equals the plain one in the port
    y_p, f_p = tssm.ssd_chunked(*tin, chunk=chunk,
                                init_state=_t(s0) if init else None)
    np.testing.assert_allclose(y_t.numpy(), y_p.numpy(), **TOL)
    np.testing.assert_allclose(f_t.numpy(), f_p.numpy(), **TOL)


def test_ssd_recurrent_step_matches_reference():
    b, h, p, g, n = 3, 4, 32, 2, 8
    x, dt, A, B, C, s0 = _ssd_inputs(5, b, 1, h, p, g, n)
    y_j, s_j = jssm.ssd_recurrent_step(
        jnp.asarray(s0), jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]),
        jnp.asarray(A), jnp.asarray(B[:, 0]), jnp.asarray(C[:, 0]))
    y_t, s_t = tssm.ssd_recurrent_step(
        _t(s0), _t(x[:, 0]), _t(dt[:, 0]), _t(A), _t(B[:, 0]), _t(C[:, 0]))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)


SSD_BLOCK = [
    # bc, l, h, p, n
    (2, 32, 4, 64, 128),
    (1, 16, 2, 32, 64),
    (3, 48, 1, 24, 20),     # neither p nor n a power of two
]


@pytest.mark.parametrize("case", SSD_BLOCK)
@pytest.mark.parametrize("dt_", ["float32", "bfloat16"])
def test_ssd_chunk_plain_matches_ref_and_pallas(case, dt_):
    bc, l, h, p, n = case
    rng = np.random.default_rng(sum(case))
    x = (rng.standard_normal((bc, l, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bc, l, h)))).astype(np.float32)
    da = -np.cumsum(np.log1p(np.exp(rng.standard_normal((bc, l, h)))) * 0.1,
                    axis=1).astype(np.float32)
    B = (rng.standard_normal((bc, l, h, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((bc, l, h, n)) * 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dt_), getattr(torch, dt_)
    jx, jB, jC = (jnp.asarray(a).astype(jdt) for a in (x, B, C))
    tx, tB, tC = (_t(a).to(tdt) for a in (x, B, C))
    y_t, st_t = ssd_chunk.ssd_chunk_bchp(tx, _t(dt), _t(da), tB, tC)
    assert y_t.dtype == tdt and st_t.dtype == torch.float32
    assert st_t.shape == (bc, h, n, p)
    tol = (dict(atol=3e-2, rtol=3e-2) if dt_ == "bfloat16"
           else dict(atol=3e-5, rtol=2e-5))
    for fn in (ref.ssd_chunk_bchp, ops.ssd_chunk):
        y_j, st_j = fn(jx, jnp.asarray(dt), jnp.asarray(da), jB, jC)
        np.testing.assert_allclose(y_t.float().numpy(),
                                   np.asarray(y_j, np.float32), **tol)
        np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **tol)


# ---------------------------------------------------------------------------
# kernels 10-11: slot gather / scatter, bit for bit
# ---------------------------------------------------------------------------

SLOT_SHAPES = [
    # S, B, feature shape
    (5, 4, (64,)),
    (33, 2, (4, 2, 32)),     # SSD-state-like
    (9, 3, (3, 7)),          # odd row length
    (11, 10, (3, 40)),       # conv-window-like, B = the engine's 10 rows
]


def _slot_inputs(seed, s, b, feat, layers=None):
    rng = np.random.default_rng(seed)
    lead = (s,) if layers is None else (layers, s)
    pool = rng.standard_normal(lead + feat).astype(np.float32)
    slots = rng.permutation(np.arange(1, s))[:b].astype(np.int32)
    if b >= s:
        slots = rng.integers(0, s, b).astype(np.int32)
    vlead = (b,) if layers is None else (layers, b)
    value = rng.standard_normal(vlead + feat).astype(np.float32)
    return rng, pool, slots, value


@pytest.mark.parametrize("case", SLOT_SHAPES)
@pytest.mark.parametrize("dt_", ["float32", "bfloat16"])
def test_slot_gather_plain_bit_exact_with_ops(case, dt_):
    s, b, feat = case
    rng, pool, slots, _ = _slot_inputs(s + b, s, b, feat)
    fresh = rng.integers(0, 2, (b,)).astype(bool)
    jp = jnp.asarray(pool).astype(getattr(jnp, dt_))
    want = np.asarray(ops.slot_gather(jp, jnp.asarray(slots),
                                      jnp.asarray(fresh)), np.float32)
    tp = _t(pool).to(getattr(torch, dt_))
    got = slot_state.slot_gather(tp, _t(slots), _t(fresh))
    assert got.dtype == tp.dtype and got.shape == (b,) + feat
    np.testing.assert_array_equal(got.float().numpy(), want)
    # no fresh rows: the plain gather
    got = slot_state.slot_gather(tp, _t(slots))
    assert torch.equal(got, tp[_t(slots).long()])


@pytest.mark.parametrize("case", SLOT_SHAPES)
def test_slot_scatter_plain_bit_exact_with_ops(case):
    """``layers.slot_state_scatter`` (the route) over the plain scatter:
    rows with valid_len 0 go to trash slot 0.  Exact on every slot but
    0; exact on slot 0 too where the destinations are distinct (the
    unconditional form with distinct slots)."""
    s, b, feat = case
    rng, pool, slots, value = _slot_inputs(s * b, s, b, feat)
    vl = rng.integers(0, 3, (b,)).astype(np.int32)
    want = np.asarray(ops.slot_scatter(jnp.asarray(pool), jnp.asarray(slots),
                                       jnp.asarray(vl), jnp.asarray(value)))
    want_l = np.asarray(jlayers.slot_state_scatter(
        jnp.asarray(pool), jnp.asarray(slots), jnp.asarray(vl),
        jnp.asarray(value)))
    tp = _t(pool.copy())
    out = tlayers.slot_state_scatter(tp, _t(slots), _t(vl), _t(value))
    assert out is tp                                     # in place
    np.testing.assert_array_equal(tp.numpy()[1:], want[1:])
    np.testing.assert_array_equal(tp.numpy()[1:], want_l[1:])
    if len(set(slots.tolist())) == b:
        want2 = np.asarray(ops.slot_scatter(jnp.asarray(pool),
                                            jnp.asarray(slots), None,
                                            jnp.asarray(value)))
        tp2 = _t(pool.copy())
        tlayers.slot_state_scatter(tp2, _t(slots), None, _t(value))
        np.testing.assert_array_equal(tp2.numpy(), want2)


def test_slot_state_plain_layer_axis_matches_vmapped_ops():
    """The decode loop's layered form: one call over the stacked layer
    axis equals the reference's vmap of the kernels over layers, and
    gather then scatter round-trips the pool."""
    l, s, b, feat = 3, 7, 4, (6, 5)
    rng, pool, _, value = _slot_inputs(12, s, b, feat, layers=l)
    slots = np.asarray([2, 4, 0, 6], np.int32)
    fresh = np.asarray([False, True, False, False])
    jp = jnp.asarray(pool)
    want = np.asarray(jax.vmap(lambda p: ops.slot_gather(
        p, jnp.asarray(slots), jnp.asarray(fresh)))(jp))
    got = slot_state.slot_gather(_t(pool), _t(slots), _t(fresh),
                                 stacked=True)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.vmap(lambda p, v: ops.slot_scatter(
        p, jnp.asarray(slots), None, v))(jp, jnp.asarray(value)))
    tp = _t(pool.copy())
    slot_state.slot_scatter(tp, _t(slots), _t(value), stacked=True)
    np.testing.assert_array_equal(tp.numpy(), want)
    tp = _t(pool.copy())
    g = slot_state.slot_gather(tp, _t(slots), stacked=True)
    slot_state.slot_scatter(tp, _t(slots), g, stacked=True)
    np.testing.assert_array_equal(tp.numpy(), pool)


def test_slot_conv_window_matches_reference():
    rng = np.random.default_rng(3)
    conv0 = rng.standard_normal((4, 3, 10)).astype(np.float32)
    x = rng.standard_normal((4, 6, 10)).astype(np.float32)
    for vl in (None, np.asarray([0, 1, 5, 6], np.int32)):
        want = jlayers.slot_conv_window(
            jnp.asarray(conv0), jnp.asarray(x),
            None if vl is None else jnp.asarray(vl))
        got = tlayers.slot_conv_window(_t(conv0), _t(x),
                                       None if vl is None else _t(vl))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# apply_ssm: the three cache forms
# ---------------------------------------------------------------------------


def _layer_params(seed=0):
    """One mamba layer's params, the same in both packages, with random
    biases, D, dt bias and norm scale so every param matters."""
    jcfg, tcfg = mamba_configs()
    p = jssm.init_ssm(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in p.items():
        if isinstance(v, dict):
            sc = np.asarray(v["scale"])
            flat[k] = {"scale": (sc + 0.1 * rng.standard_normal(sc.shape)
                                 ).astype(np.float32)}
        else:
            a = np.asarray(v)
            if k in ("conv_b", "D", "dt_bias"):
                a = (a + 0.1 * rng.standard_normal(a.shape)).astype(
                    np.float32)
            flat[k] = a
    jp = jax.tree.map(jnp.asarray, flat)
    tp = {k: ({"scale": _t(v["scale"])} if isinstance(v, dict) else _t(v))
          for k, v in flat.items()}
    return jcfg, tcfg, jp, tp


def test_apply_ssm_plain_and_make_cache_match_reference():
    jcfg, tcfg, jp, tp = _layer_params(1)
    x = np.random.default_rng(2).standard_normal((2, 21, 64)).astype(
        np.float32)
    y_j, c_j = jssm.apply_ssm(jp, jnp.asarray(x), jcfg, make_cache=True)
    y_t, c_t = tssm.apply_ssm(tp, _t(x), tcfg, make_cache=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(c_t[k].numpy(), np.asarray(c_j[k]), **TOL)
    # and one decode token from that cache
    x1 = np.random.default_rng(3).standard_normal((2, 1, 64)).astype(
        np.float32)
    y_j, c2_j = jssm.apply_ssm(jp, jnp.asarray(x1), jcfg, cache=c_j)
    y_t, c2_t = tssm.apply_ssm(tp, _t(x1), tcfg, cache=c_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(c2_t["state"].numpy(),
                               np.asarray(c2_j["state"]), **TOL)


@pytest.mark.parametrize("attn_impl", ["naive", "pallas"])
def test_apply_ssm_paged_slots_match_reference(attn_impl):
    """Slot pools: a chunk-wide row from pos 0 (fresh: its garbage slot
    reads as zeros), a ragged row continuing a slot, a decode-like row
    and a padding row (valid_len 0) pointing at trash slot 0.  The JAX
    side at both attn_impl (jnp and its Pallas slot kernels)."""
    jcfg, tcfg, jp, tp = _layer_params(4)
    jcfg = jcfg.replace(attn_impl=attn_impl)
    rng = np.random.default_rng(5)
    s_slots, k1 = 6, jcfg.ssm.conv_kernel - 1
    _, nh, conv_dim = jssm._dims(jcfg)
    conv = rng.standard_normal((s_slots, k1, conv_dim)).astype(np.float32)
    state = rng.standard_normal((s_slots, nh, 32, 8)).astype(np.float32)
    x = rng.standard_normal((4, 20, 64)).astype(np.float32)
    pos = np.asarray([0, 13, 40, 7], np.int32)
    vl = np.asarray([20, 9, 1, 0], np.int32)
    slots = np.asarray([3, 1, 5, 0], np.int32)
    jc = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
    y_j, c_j = jssm.apply_ssm(jp, jnp.asarray(x), jcfg, cache=jc,
                              pos=jnp.asarray(pos), valid_len=jnp.asarray(vl),
                              state_slots=jnp.asarray(slots))
    tc = {"conv": _t(conv.copy()), "state": _t(state.copy())}
    y_t, c_t = tssm.apply_ssm(tp, _t(x), tcfg, cache=tc, pos=_t(pos),
                              valid_len=_t(vl), state_slots=_t(slots))
    assert c_t is tc                                     # in place
    live = [0, 1, 2]                                     # rows with tokens
    for r in live:
        np.testing.assert_allclose(y_t.numpy()[r, :vl[r]],
                                   np.asarray(y_j)[r, :vl[r]], **TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(tc[k].numpy()[1:],
                                   np.asarray(c_j[k])[1:], **TOL)
    # untouched slots stay bit for bit
    np.testing.assert_array_equal(tc["state"].numpy()[[2, 4]],
                                  state[[2, 4]])


def test_apply_ssm_views_match_reference():
    """The N-step loop's views: width-1 rows, one stopped (valid_len 0),
    updated in place."""
    jcfg, tcfg, jp, tp = _layer_params(6)
    rng = np.random.default_rng(7)
    _, nh, conv_dim = jssm._dims(jcfg)
    conv = rng.standard_normal((3, 3, conv_dim)).astype(np.float32)
    state = rng.standard_normal((3, nh, 32, 8)).astype(np.float32)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    pos = np.asarray([5, 9, 2], np.int32)
    vl = np.asarray([1, 0, 1], np.int32)
    y_j, c_j = jssm.apply_ssm(
        jp, jnp.asarray(x), jcfg,
        cache={"conv_view": jnp.asarray(conv),
               "state_view": jnp.asarray(state)},
        pos=jnp.asarray(pos), valid_len=jnp.asarray(vl),
        state_slots=jnp.asarray([1, 2, 0], jnp.int32))
    tc = {"conv_view": _t(conv.copy()), "state_view": _t(state.copy())}
    y_t, c_t = tssm.apply_ssm(tp, _t(x), tcfg, cache=tc, pos=_t(pos),
                              valid_len=_t(vl),
                              state_slots=_t(np.asarray([1, 2, 0],
                                                        np.int32)))
    assert c_t is tc
    np.testing.assert_allclose(y_t.numpy()[[0, 2]],
                               np.asarray(y_j)[[0, 2]], **TOL)
    for k in ("conv_view", "state_view"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(c_j[k]), **TOL)
    # the stopped row is an identity update
    np.testing.assert_array_equal(tc["state_view"].numpy()[1], state[1])
    np.testing.assert_array_equal(tc["conv_view"].numpy()[1], conv[1])
