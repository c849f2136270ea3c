"""The port's optimizers and schedules against the JAX package's.

``repro_torch.optim.sgd.apply_update`` (sgd, nesterov, lars, adamw; on
the CPU sgd and lars run the fused update's plain version; the learning
rate as a float and as a 0-dim tensor, as a device schedule gives it)
against ``repro.optim.sgd.apply_update`` (unfused, and fused through the
Pallas kernel in interpret mode) over three steps from the same float32
params, momentum and gradients.  Tolerance: 1e-6 absolute
plus 1e-6 relative (the same float32 formula; XLA may fuse a multiply
and an add into one rounding).  AdamW gets 1e-5: its bias corrections
are powers taken in float32 by the reference and in float64 by the
port.  AdamW ignores the reference's ``fused``; its cases check that.
The schedules agree to 1e-6 relative at every step tried.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import schedules as jsched
from repro.optim import sgd as jsgd
from repro_torch.kernels import fused_update
from repro_torch.optim import schedules as tsched
from repro_torch.optim import sgd as tsgd

SHAPES = {"w": (6, 40), "b": (37,), "stack": {"k": (3, 5, 9)}}
KINDS = {"sgd": dict(kind="sgd"), "nesterov": dict(kind="sgd", nesterov=True),
         "lars": dict(kind="lars"), "adamw": dict(kind="adamw")}


def _tree(rng, shapes, scale=1.0):
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(np.float32)
            for k, v in shapes.items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32) if not isinstance(
                v, torch.Tensor) else v.numpy()
    return out


@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("lr_tensor", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_apply_update_matches_reference(kind, lr_tensor, jax_fused):
    rng = np.random.default_rng(0)
    w0 = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, 0.1) for _ in range(3)]
    lrs = [0.1, 0.05, 0.02]
    jcfg = jsgd.OptimConfig(fused=jax_fused, **KINDS[kind])
    tcfg = tsgd.OptimConfig(**KINDS[kind])
    jp = jax.tree.map(jnp.asarray, w0)
    js = jsgd.init_state(jp, jcfg)
    tp = _to_torch(w0)
    ts = tsgd.init_state(tp, tcfg)
    for g, lr in zip(grads, lrs):
        jp, js = jsgd.apply_update(jp, js, jax.tree.map(jnp.asarray, g), lr,
                                   jcfg)
        tlr = torch.tensor(lr, dtype=torch.float32) if lr_tensor else lr
        tp, ts = tsgd.apply_update(tp, ts, _to_torch(g), tlr, tcfg)
    tol = 1e-5 if kind == "adamw" else 1e-6
    want, got = _flat(jp), _flat(tp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)
    wm, gm = _flat(js["m"]), _flat(ts["m"])
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], atol=tol, rtol=tol,
                                   err_msg=k)
    if kind == "adamw":
        assert ts["t"] == int(js["t"]) == 3


def test_fused_update_plain_on_cpu_counts_no_launch():
    before = fused_update.fused_sgd_update.launches
    w, m, g = torch.ones(10), torch.zeros(10), torch.ones(10)
    fused_update.fused_sgd_update(w, m, g, lr=0.5, momentum=0.9,
                                  weight_decay=0.0)
    assert fused_update.fused_sgd_update.launches == before
    torch.testing.assert_close(w, torch.full((10,), 0.5))
    torch.testing.assert_close(m, torch.ones(10))


def test_fused_update_bf16_params_f32_momentum():
    """The card's trainer keeps bf16 params with f32 momentum: the plain
    version computes in f32 and rounds w once, to within one bf16 ulp of
    the f32 result."""
    rng = np.random.default_rng(3)
    w32 = torch.tensor(rng.standard_normal(300).astype(np.float32))
    g = torch.tensor(rng.standard_normal(300).astype(np.float32))
    w = w32.to(torch.bfloat16)
    wb = w.float()
    m = torch.zeros(300)
    fused_update.fused_sgd_update(w, m, g, lr=0.1, momentum=0.9,
                                  weight_decay=1e-4)
    ref = wb - 0.1 * (g + 1e-4 * wb)         # m starts at 0: m' = g'
    assert w.dtype == torch.bfloat16 and m.dtype == torch.float32
    torch.testing.assert_close(m, g + 1e-4 * wb, atol=0, rtol=0)
    ulp = torch.abs(ref) * 2.0 ** -7
    assert torch.all(torch.abs(w.float() - ref) <= ulp + 1e-12)


STEPS = list(range(0, 60, 3)) + [19, 20, 21, 29, 30, 31]


@pytest.mark.parametrize("name,kw", [
    ("warmup_step_decay", dict(base_lr=0.1, peak_lr=0.4, warmup_steps=5,
                               decay_every=10)),
    ("wsd", dict(peak_lr=0.3, warmup_steps=5, stable_steps=20,
                 decay_steps=15)),
    ("cosine", dict(peak_lr=0.2, warmup_steps=7, total_steps=50)),
])
def test_schedules_equal_reference(name, kw):
    jf, tf = getattr(jsched, name), getattr(tsched, name)
    for t in STEPS:
        want = float(jf(jnp.int32(t), **kw))
        got = tf(t, **kw)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-3), (name, t)


def test_linear_scaled_lr_equals_reference():
    assert tsched.linear_scaled_lr(0.1, 1024) == \
        jsched.linear_scaled_lr(0.1, 1024)
