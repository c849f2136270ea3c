"""The port's full-sequence and contiguous-cache attention against the JAX
package on the CPU: the plain versions of kernel 6 (flash attention) and
kernel 7 (one-token decode over a contiguous cache) against
``repro.kernels.ref`` at every shape of ``tests/test_kernels.py``'s
sweeps and against the Pallas kernels (interpret mode, through ``ops``),
at head dim 256 (recurrentgemma's), and at shapes with query rows that
see no key, which get ``ref.py``'s
mean of v (the Pallas path's padded keys shift that mean where Sk is
not a multiple of 128: a deliberate deviation, pinned here);
``blocked_attention`` and ``decode_attention`` against the reference's;
``apply_attention``'s cache-building prefill and its contiguous decode,
plain and ring, on carried-across weights.

Inputs are made with numpy from fixed seeds.  Tolerances: float32
within atol/rtol 1e-5 (two f32 softmax implementations summing in other
orders; 3e-5 against the Pallas kernels, whose blocked sums differ
more, and against the blocked online softmax); bfloat16 within atol
1e-3 + rtol 1e-2 (both sides round an f32 result to bf16, so they may
differ by one bf16 ulp, at most 2^-7 = 0.0078 of the value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.kernels import ops, ref
from repro.models import attention as jattn
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import attention as tattn
from repro_torch.models.layers import rope_table
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=1e-5, rtol=1e-5)
KTOL = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=1e-3, rtol=1e-2)

# tests/test_kernels.py SHAPES and DECODE_SHAPES
SHAPES = [
    # b, sq, sk, h, kv, hd, causal, window
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 128, 8, 8, 128, True, 0),
    (2, 200, 200, 2, 1, 80, False, 0),
    (1, 384, 384, 4, 2, 64, True, 128),
    (1, 64, 320, 2, 2, 32, False, 0),
]
DECODE_SHAPES = [
    # b, s, h, kv, hd, length
    (2, 512, 8, 2, 64, 300),
    (1, 1024, 4, 4, 128, 1024),
    (3, 700, 2, 1, 96, 13),
]
# rows that see no key: window > 0 and Sq >= Sk + window, so positions
# Sk + window - 1 .. Sq - 1 see none; Sk a multiple of 128 and not
NO_KEY_SHAPES = [
    # b, sq, sk, h, kv, hd, causal, window
    (1, 160, 128, 4, 2, 64, True, 16),
    (2, 100, 70, 2, 1, 32, False, 8),
    (1, 300, 256, 6, 1, 64, True, 40),
]
# head dim 256 (recurrentgemma's local MQA: 10 heads over one kv head,
# a window): beyond test_kernels.py's sweeps, the ports' kernels 6 and 7
# take it since its hd-256 templates
HD256_SHAPES = [
    # b, sq, sk, h, kv, hd, causal, window
    (1, 160, 160, 10, 1, 256, True, 64),
    (2, 96, 96, 4, 2, 256, True, 0),
]
HD256_DECODE = [
    # b, s, h, kv, hd, length (past s: a full ring; s a multiple of the
    # Pallas path's 512-slot block, which would otherwise pad the ring
    # with zero keys that a length past s makes visible)
    (2, 256, 10, 1, 256, 200),
    (2, 512, 10, 1, 256, 700),
]
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


def _pair(arrays, dtype):
    """The same numpy arrays in both frameworks, rounded to ``dtype``
    alike (both round to nearest even)."""
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [_t(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# kernel 6: flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SHAPES + NO_KEY_SHAPES + HD256_SHAPES,
                         ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_plain_matches_ref(case, dtype):
    b, sq, sk, h, kv, hd, causal, window = case
    arrays = _normal(sq + sk + h, (b, h, sq, hd), (b, kv, sk, hd),
                     (b, kv, sk, hd))
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    want = ref.flash_attention_bhsd(jq, jk, jv, causal=causal, window=window)
    got = fa.flash_attention_bhsd_plain(tq, tk, tv, causal=causal,
                                        window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("case", [SHAPES[0], SHAPES[4]] + [
    c for c in NO_KEY_SHAPES if c[2] % 128 == 0] + HD256_SHAPES, ids=str)
def test_flash_attention_wrapper_matches_pallas_kernel(case):
    """The wrapper's (B,S,H,hd) layout on the CPU against the Pallas
    kernel through ``ops.flash_attention`` (interpret mode); with rows
    that see no key only where Sk is a multiple of 128, so that the
    Pallas path pads no key."""
    b, sq, sk, h, kv, hd, causal, window = case
    q, k, v = _normal(7, (b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window)
    _close(got, want, KTOL)


def test_flash_attention_rows_without_a_key_follow_ref_not_padding():
    """A deliberate deviation: at Sk = 70 the Pallas path pads the keys to
    128 with zero v, so a row without a key gets sum(v[:Sk]) / 128; the
    port follows ref.py's mean over Sk."""
    b, sq, sk, h, kv, hd, causal, window = NO_KEY_SHAPES[1]
    q, k, v = _normal(13, (b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window)
    want = ref.flash_attention_bhsd(*(jnp.swapaxes(jnp.asarray(x), 1, 2)
                                      for x in (q, k, v)),
                                    causal=causal, window=window)
    _close(got, jnp.swapaxes(want, 1, 2), F32)
    empty = slice(sk + window - 1, None)
    mean = v.mean(1).repeat(h // kv, axis=1)                    # (b, h, hd)
    _close(got[:, empty], np.broadcast_to(mean[:, None], got[:, empty].shape),
           F32)
    padded = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, window=window)
    np.testing.assert_allclose(np.asarray(padded)[:, empty],
                               np.broadcast_to((mean * sk / 128)[:, None],
                                               padded[:, empty].shape),
                               **KTOL)


def test_flash_attention_refuses_a_gradient():
    q, k, v = (torch.randn(1, 8, 2, 64, requires_grad=True)
               for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, v)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).shape == q.shape


# ---------------------------------------------------------------------------
# kernel 7: one-token decode over a contiguous cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", DECODE_SHAPES + HD256_DECODE, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_plain_matches_ref(case, dtype):
    b, s, h, kv, hd, length = case
    arrays = _normal(s + h, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    want = ref.flash_decode(jq, jnp.swapaxes(jk, 1, 2),
                            jnp.swapaxes(jv, 1, 2), length)
    got = fd.flash_decode_bhd_plain(tq, tk, tv,
                                    torch.tensor(length, dtype=torch.int32))
    assert got.shape == (b, h, hd) and got.dtype == tq.dtype
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("case", [DECODE_SHAPES[0], DECODE_SHAPES[2]]
                         + HD256_DECODE, ids=str)
def test_flash_decode_wrapper_matches_pallas_kernel(case):
    b, s, h, kv, hd, length = case
    q, k, v = _normal(11, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    want = ops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            length)
    got = fd.flash_decode(_t(q), _t(k), _t(v),
                          torch.tensor(length, dtype=torch.int32))
    _close(got, want, KTOL)


# ---------------------------------------------------------------------------
# the model's plain attention forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    # b, sq, h, kv, hd, causal, window, block_q, block_kv
    (2, 64, 4, 2, 16, True, 0, 16, 32),
    (1, 96, 6, 2, 16, True, 20, 32, 16),
    (2, 48, 2, 1, 16, False, 0, 16, 16),
    (1, 40, 2, 2, 16, True, 0, 16, 16),      # 40 % 16: falls back to naive
], ids=str)
def test_blocked_attention_matches_reference(case):
    b, s, h, kv, hd, causal, window, bq, bkv = case
    q, k, v = _normal(s + h, (b, s, kv, h // kv, hd), (b, s, kv, hd),
                      (b, s, kv, hd))
    want = jattn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, block_q=bq, block_kv=bkv)
    got = tattn.blocked_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, block_q=bq, block_kv=bkv)
    _close(got, want, KTOL)


@pytest.mark.parametrize("sc,pos", [(32, 0), (32, 17), (16, 40)])
def test_decode_attention_matches_reference(sc, pos):
    q, k, v = _normal(sc + pos, (2, 1, 2, 3, 16), (2, sc, 2, 16),
                      (2, sc, 2, 16))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.int32(pos))
    got = tattn.decode_attention(_t(q), _t(k), _t(v), torch.tensor(pos))
    _close(got, want, F32)


def _layer_params(cfg, seed):
    """One attention layer's params with random biases, as numpy."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)

    return {"wq": w(d, h * hd), "wk": w(d, kv * hd), "wv": w(d, kv * hd),
            "wo": w(h * hd, d), "bq": w(1, h * hd)[0],
            "bk": w(1, kv * hd)[0], "bv": w(1, kv * hd)[0]}


@pytest.mark.parametrize("window,s,cache_len", [
    (0, 12, 20),       # s < sc: the prompt, then zeros
    (16, 24, 40),      # ring: sc = window = 16 <= s, rolled
], ids=["plain", "ring"])
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_make_cache_and_contiguous_decode_match_reference(window, s,
                                                          cache_len, impl):
    """The prefill's cache (``make_cache``) and four decode tokens through
    it, the last ones past the ring's end, against the reference."""
    jcfg = jax_smoke_variant(jax_get_config("qwen2-1.5b")).replace(
        sliding_window=window, attn_impl=impl)
    tcfg = smoke_variant(get_config("qwen2-1.5b")).replace(
        sliding_window=window, attn_impl=impl)
    p = _layer_params(jcfg, 3)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    x, xs = _normal(5, (2, s, jcfg.d_model), (4, 2, 1, jcfg.d_model))
    jy, jc = jattn.apply_attention(jp, jnp.asarray(x), jcfg, window=window,
                                   make_cache=True, cache_len=cache_len)
    rope = rope_table(torch.arange(s)[None], tcfg.head_dim, tcfg.rope_theta)
    ty, tc = tattn.apply_attention(tp, _t(x), tcfg, rope=rope, window=window,
                                   make_cache=True, cache_len=cache_len)
    _close(ty, jy, KTOL)
    for name in ("k", "v"):
        _close(tc[name], jc[name], F32)
    for i, xt in enumerate(xs):
        pos = torch.tensor(s + i)
        rope, write = tattn.shared_inputs(tcfg, 1, "cpu", cache=tc, pos=pos)
        ty, tc = tattn.apply_attention(tp, _t(xt), tcfg, rope=rope,
                                       write=write, window=window, cache=tc,
                                       pos=pos)
        jy, jc = jattn.apply_attention(jp, jnp.asarray(xt), jcfg,
                                       window=window, cache=jc,
                                       pos=jnp.int32(s + i))
        _close(ty, jy, F32)
        for name in ("k", "v"):
            _close(tc[name], jc[name], F32)
