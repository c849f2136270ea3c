"""The port's MLA attention against the JAX package on the CPU: the plain
versions of the two absorbed attends against ``repro.kernels.ref`` and
against the Pallas kernels (interpret mode, through ``ops``), and
``apply_mla``'s four forms (full sequence, also building a contiguous
latent cache; one-token decode over that cache; per-row latent views;
latent block pools) on carried-across weights.

Tolerances: float32 throughout; the attends within atol 3e-5 / rtol 2e-5
(two f32 softmax implementations summing in other orders), apply_mla's
outputs and the latent storage after its writes within 1e-5.  The trash
block 0 of a pool is left out of the pool comparison: every padding
column writes it, and which write lands last is unspecified in both
packages.
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
from repro.models import mla as jmla
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import _common, mla_decode
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from torch_threads import one_torch_thread  # noqa: F401

KTOL = dict(atol=3e-5, rtol=2e-5)
TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "deepseek-v3-671b"


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


def test_config_matches_reference():
    for smoke in (False, True):
        j, t = jax_get_config(ARCH), get_config(ARCH)
        if smoke:
            j, t = jax_smoke_variant(j), smoke_variant(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads) == (61, 7168, 128)
    assert (cfg.moe.num_experts, cfg.moe.num_experts_per_tok,
            cfg.moe.first_k_dense) == (256, 8, 3)
    assert (cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim) == (512, 64)


# ---------------------------------------------------------------------------
# kernels 8-9: the plain attends
# ---------------------------------------------------------------------------

ATTEND_CASES = [
    # b, c, h, r, rd, s1 (view slots), bs, nb_seq
    (3, 1, 4, 32, 16, 41, 8, 5),       # decode, odd S+1, rd 16
    (2, 8, 4, 64, 64, 33, 4, 8),       # 8-query chunk, rd 64
    (4, 1, 2, 48, 24, 17, 16, 1),      # a single block per row
]


def _attend_inputs(case):
    b, c, h, r, rd, s1, bs, nb_seq = case
    rng = np.random.default_rng(sum(case))
    q_lat = rng.standard_normal((b, c, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((b, c, h, rd)).astype(np.float32)
    ckv = rng.standard_normal((b, s1, r)).astype(np.float32)
    kr = rng.standard_normal((b, s1, rd)).astype(np.float32)
    # mixed positions, one row at 0 and one at its last query's limit
    pos = rng.integers(0, s1 - c, (b,)).astype(np.int32)
    pos[0], pos[-1] = 0, s1 - c - 1
    nb = b * nb_seq + 1
    ckv_pool = rng.standard_normal((nb, bs, r)).astype(np.float32)
    kr_pool = rng.standard_normal((nb, bs, rd)).astype(np.float32)
    # each row's blocks up to its last query, distinct and shuffled; the
    # tail of the table points at trash block 0 (holding garbage)
    perm = rng.permutation(np.arange(1, nb))
    bt = np.zeros((b, nb_seq), np.int32)
    ppos = rng.integers(0, nb_seq * bs - c + 1, (b,)).astype(np.int32)
    ppos[0] = 0
    for i in range(b):
        need = (ppos[i] + c - 1) // bs + 1
        bt[i, :need] = perm[i * nb_seq:i * nb_seq + need]
    scale = 1.0 / np.sqrt(r // 2 + rd)
    return q_lat, q_rope, ckv, kr, pos, ckv_pool, kr_pool, bt, ppos, scale


@pytest.mark.parametrize("case", ATTEND_CASES)
def test_mla_decode_views_plain_matches_ref_and_pallas(case):
    q_lat, q_rope, ckv, kr, pos, *_, scale = _attend_inputs(case)
    args = (q_lat, q_rope, ckv, kr, pos)
    want_ref = ref.mla_decode_views(*map(jnp.asarray, args), scale=scale)
    want_pallas = ops.mla_decode_views(*map(jnp.asarray, args), scale=scale)
    got = mla_decode.mla_decode_views(*map(_t, args), scale=scale)
    assert got.shape == q_lat.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **KTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **KTOL)


@pytest.mark.parametrize("case", ATTEND_CASES)
def test_mla_decode_paged_plain_matches_ref_and_pallas(case):
    q_lat, q_rope, _, _, _, ckv_pool, kr_pool, bt, ppos, scale = \
        _attend_inputs(case)
    args = (q_lat, q_rope, ckv_pool, kr_pool, bt, ppos)
    want_ref = ref.mla_decode_paged(*map(jnp.asarray, args), scale=scale)
    want_pallas = ops.mla_decode_paged(*map(jnp.asarray, args), scale=scale)
    got = mla_decode.mla_decode_paged(*map(_t, args), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **KTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **KTOL)
    # the trash block's garbage never reaches a live query
    poisoned = ckv_pool.copy()
    poisoned[0] = 1e4
    again = mla_decode.mla_decode_paged(_t(q_lat), _t(q_rope), _t(poisoned),
                                        _t(kr_pool), _t(bt), _t(ppos),
                                        scale=scale)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    q_lat, q_rope, ckv, kr, pos, ckv_pool, kr_pool, bt, ppos, scale = \
        _attend_inputs(ATTEND_CASES[0])
    before = (mla_decode.mla_decode_views.launches,
              mla_decode.mla_decode_paged.launches)
    a = mla_decode.mla_decode_views(*map(_t, (q_lat, q_rope, ckv, kr, pos)),
                                    scale=scale)
    b = mla_decode.mla_decode_views_plain(
        *map(_t, (q_lat, q_rope, ckv, kr, pos)), scale=scale)
    assert torch.equal(a, b)
    mla_decode.mla_decode_paged(
        *map(_t, (q_lat, q_rope, ckv_pool, kr_pool, bt, ppos)), scale=scale)
    assert (mla_decode.mla_decode_views.launches,
            mla_decode.mla_decode_paged.launches) == before


# the launch geometry at deepseek-v3's widths (128 heads) for the row
# layouts the engine dispatches (decode buckets 8/4/2, prefill 2 x 128,
# mixed 136/264 rows) on a 132-SM card: (b, c) -> tiles a batch row and
# the key splits over a 640-slot table and a 641-slot view, per template
LAUNCHES = {
    torch.bfloat16: {(8, 1): (2, 5, 6), (4, 1): (2, 5, 6), (2, 1): (2, 5, 6),
                     (2, 128): (256, 1, 1), (136, 1): (2, 1, 1),
                     (264, 1): (2, 1, 1)},
    torch.float32: {(8, 1): (8, 5, 5), (4, 1): (8, 5, 6), (2, 1): (8, 5, 6),
                    (2, 128): (1024, 1, 1), (136, 1): (8, 1, 1),
                    (264, 1): (8, 1, 1)},
}


@pytest.mark.parametrize("dtype", list(LAUNCHES))
@pytest.mark.parametrize("b,c", list(LAUNCHES[torch.bfloat16]))
def test_launch_splits_at_the_engine_layouts(b, c, dtype):
    tiles, paged, views = LAUNCHES[dtype][(b, c)]
    assert mla_decode.launch_splits(b, c, 128, 640, dtype, 132) == (tiles,
                                                                    paged)
    assert mla_decode.launch_splits(b, c, 128, 641, dtype, 132) == (tiles,
                                                                    views)
    # split at the decode buckets only, each split keeping four chunks
    assert (paged > 1) == (views > 1) == (c == 1 and b <= 8)
    assert (views - 1) * 4 * _common.KEY_CHUNK < 641


# ---------------------------------------------------------------------------
# apply_mla's four forms
# ---------------------------------------------------------------------------


def mla_configs():
    """(jax cfg, port cfg): the deepseek smoke variant (d_model 256, 4
    heads, r 32, rope 16, nope 32, v 32), float32."""
    return (jax_smoke_variant(jax_get_config(ARCH)),
            smoke_variant(get_config(ARCH)))


@pytest.fixture(scope="module")
def layer():
    jcfg, tcfg = mla_configs()
    jp = jmla.init_mla(jax.random.key(3), jcfg)
    rng = np.random.default_rng(3)
    flat = {}
    for k, v in jp.items():
        if isinstance(v, dict):           # the norm scales: make them matter
            flat[k] = {"scale": (np.asarray(v["scale"]) + 0.1
                                 * rng.standard_normal(v["scale"].shape)
                                 ).astype(np.float32)}
        else:
            flat[k] = np.asarray(v)
    jparams = jax.tree_util.tree_map(jnp.asarray, flat)
    tparams = jax.tree_util.tree_map(_t, flat)
    return jcfg, jparams, tcfg, tparams


def test_apply_mla_full_sequence_matches(layer):
    jcfg, jparams, tcfg, tparams = layer
    x = np.random.default_rng(4).standard_normal(
        (2, 11, jcfg.d_model)).astype(np.float32)
    yj, cj = jmla.apply_mla(jparams, jnp.asarray(x), jcfg)
    rope, _ = tattn.shared_inputs(tcfg, 11, "cpu")
    yt, ct = tmla.apply_mla(tparams, _t(x), tcfg, rope=rope)
    assert cj is None and ct is None
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_apply_mla_views_matches(layer):
    """The loop form: row 1 inactive (valid_len 0, writes the trash slot),
    row 2 at its view's last live slot."""
    jcfg, jparams, tcfg, tparams = layer
    a = jcfg.mla
    rng = np.random.default_rng(5)
    b, s1 = 3, 25
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((b, s1, a.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, s1, a.qk_rope_head_dim)).astype(np.float32)
    pos = np.array([4, 9, s1 - 2], np.int32)
    valid = np.array([1, 0, 1], np.int32)
    yj, cj = jmla.apply_mla(jparams, jnp.asarray(x), jcfg,
                            cache={"ckv_view": jnp.asarray(ckv),
                                   "kr_view": jnp.asarray(kr)},
                            pos=jnp.asarray(pos),
                            valid_len=jnp.asarray(valid))
    tcache = {"ckv_view": _t(ckv), "kr_view": _t(kr)}
    rope, write = tattn.shared_inputs(tcfg, 1, "cpu", cache=tcache,
                                      pos=_t(pos), valid_len=_t(valid))
    yt, _ = tmla.apply_mla(tparams, _t(x), tcfg, rope=rope, write=write,
                           cache=tcache, pos=_t(pos))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for name in ("ckv_view", "kr_view"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(cj[name]), **TOL)


def test_apply_mla_paged_matches(layer):
    """The fused-step form: a 6-token prefill row, a decode row, a ragged
    row past its valid_len (its tail goes to the trash block) and a
    padding row."""
    jcfg, jparams, tcfg, tparams = layer
    a = jcfg.mla
    rng = np.random.default_rng(6)
    b, c, bs, nb = 4, 6, 4, 14
    x = rng.standard_normal((b, c, jcfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((nb, bs, a.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((nb, bs, a.qk_rope_head_dim)).astype(np.float32)
    bt = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 9],
                   [0, 0, 0, 0]], np.int32)
    pos = np.array([0, 9, 5, 0], np.int32)
    valid = np.array([6, 1, 4, 0], np.int32)
    yj, cj = jmla.apply_mla(jparams, jnp.asarray(x), jcfg,
                            cache={"ckv": jnp.asarray(ckv),
                                   "krope": jnp.asarray(kr),
                                   "block_tables": jnp.asarray(bt)},
                            pos=jnp.asarray(pos),
                            valid_len=jnp.asarray(valid))
    tcache = {"ckv": _t(ckv), "krope": _t(kr)}
    rope, write = tattn.shared_inputs(tcfg, c, "cpu", cache=tcache,
                                      block_tables=_t(bt), pos=_t(pos),
                                      valid_len=_t(valid))
    yt, _ = tmla.apply_mla(tparams, _t(x), tcfg, rope=rope, write=write,
                           cache=tcache, block_tables=_t(bt), pos=_t(pos))
    for row, n in enumerate(valid):
        np.testing.assert_allclose(yt[row, :n].numpy(),
                                   np.asarray(yj)[row, :n], **TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tcache[name][1:].numpy(),
                                   np.asarray(cj[name])[1:], **TOL)


def test_contiguous_cache_decode_is_not_ported(layer):
    """The contiguous-cache decode of the non-paged entry point: a prefill
    with ``make_cache`` into 9 slots, then one token at pos 7 and one at
    pos 11, past the cache's end (slot 11 % 9), against the reference."""
    jcfg, jparams, tcfg, tparams = layer
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    yj, cj = jmla.apply_mla(jparams, jnp.asarray(x), jcfg, make_cache=True,
                            cache_len=9)
    rope, _ = tattn.shared_inputs(tcfg, 7, "cpu")
    yt, ct = tmla.apply_mla(tparams, _t(x), tcfg, rope=rope, make_cache=True,
                            cache_len=9)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for p in (7, 11):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        yj, cj = jmla.apply_mla(jparams, jnp.asarray(xt), jcfg, cache=cj,
                                pos=jnp.int32(p))
        pos = torch.tensor(p)
        rope, write = tattn.shared_inputs(tcfg, 1, "cpu", cache=ct, pos=pos)
        yt, ct = tmla.apply_mla(tparams, _t(xt), tcfg, rope=rope,
                                write=write, cache=ct, pos=pos)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for name in ("ckv", "krope"):
            np.testing.assert_allclose(ct[name].numpy(),
                                       np.asarray(cj[name]), **TOL)
