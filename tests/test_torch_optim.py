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

Whole trees (kernel 5 takes every leaf of a tree in one call): the
reduced ResNet of ``test_torch_resnet.py`` (53 leaves, 64-float
batch-norm scales beside conv kernels, float32) and smoke qwen2's 14
leaves in bfloat16, as the card's trainer holds qwen2-1.5b (momentum
float32), two steps from numpy inputs.  The reference runs under
``jax.jit``, once a (tree, kind, fused) and its result shared by the
port's variants: lr a float or a 0-dim tensor, g float32 or bfloat16
(the gradients are bfloat16 values, so the reference's own cast of g
to float32 is exact either way).  Tolerance: float32 w and m within
1e-6 + 1e-6 relative as above; bfloat16 w within one bfloat16 ulp
(2^-7 relative: kernel and reference round one float32 result, which
XLA's fusing may move by an ulp of float32).  lars adds an absolute
term: its trust sums up to 262,144 squares a leaf in float32, in XLA's
order there and PyTorch's here, so the two trusts part by up to about
1e-5 relative; m may then differ by LARS_ATOL times the leaf's largest
|m| and w by the sum of the lrs times that (where m or w cancels to
near 0 a relative bound cannot hold).  The reference's fused
path (interpret mode) runs for sgd, ResNet's own optimizer, on the
ResNet tree: its 53 Pallas calls take 7 s to trace and compile, so the
other cases take the unfused reference (lars on ResNet, every kind on
qwen2), and the small tree above holds every kind to both.  The launch rule of kernel
5 (chunk offsets, leaf lookup, launches a call, per-dtype grouping) is
pinned in pure Python against the CUDA source's constants.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.optim import schedules as jsched
from repro.optim import sgd as jsgd
from repro_torch import interop
from repro_torch.kernels import fused_update
from repro_torch.optim import schedules as tsched
from repro_torch.optim import sgd as tsgd
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401

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


def _inputs():
    rng = np.random.default_rng(0)
    w0 = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, 0.1) for _ in range(3)]
    return w0, grads, [0.1, 0.05, 0.02]


@functools.lru_cache(maxsize=None)
def _reference(kind, jax_fused):
    """The reference's params and state after three steps, computed once
    a (kind, fused) and shared by both forms of the port's lr."""
    w0, grads, lrs = _inputs()
    jcfg = jsgd.OptimConfig(fused=jax_fused, **KINDS[kind])
    jp = jax.tree.map(jnp.asarray, w0)
    js = jsgd.init_state(jp, jcfg)
    for g, lr in zip(grads, lrs):
        jp, js = jsgd.apply_update(jp, js, jax.tree.map(jnp.asarray, g), lr,
                                   jcfg)
    return _flat(jp), _flat(js["m"]), int(js["t"]) if "t" in js else None


@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("lr_tensor", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_apply_update_matches_reference(kind, lr_tensor, jax_fused):
    w0, grads, lrs = _inputs()
    want, wm, jt = _reference(kind, jax_fused)
    tcfg = tsgd.OptimConfig(**KINDS[kind])
    tp = _to_torch(w0)
    ts = tsgd.init_state(tp, tcfg)
    for g, lr in zip(grads, lrs):
        tlr = torch.tensor(lr, dtype=torch.float32) if lr_tensor else lr
        tp, ts = tsgd.apply_update(tp, ts, _to_torch(g), tlr, tcfg)
    tol = 1e-5 if kind == "adamw" else 1e-6
    got = _flat(tp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)
    gm = _flat(ts["m"])
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], atol=tol, rtol=tol,
                                   err_msg=k)
    if kind == "adamw":
        assert ts["t"] == jt == 3


def test_fused_update_plain_on_cpu_counts_no_launch():
    before = fused_update.fused_sgd_update.launches
    w, m, g = torch.ones(10), torch.zeros(10), torch.ones(10)
    fused_update.fused_sgd_update([w], [m], [g], lr=0.5, momentum=0.9,
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
    fused_update.fused_sgd_update([w], [m], [g], lr=0.1, momentum=0.9,
                                  weight_decay=1e-4)
    ref = wb - 0.1 * (g + 1e-4 * wb)         # m starts at 0: m' = g'
    assert w.dtype == torch.bfloat16 and m.dtype == torch.float32
    torch.testing.assert_close(m, g + 1e-4 * wb, atol=0, rtol=0)
    ulp = torch.abs(ref) * 2.0 ** -7
    assert torch.all(torch.abs(w.float() - ref) <= ulp + 1e-12)


# the reduced net of test_torch_resnet.py: stages, widths, classes
RESNET_CUT = ((1, 1, 1, 1), (8, 16, 32, 64), 10)
TREE_KINDS = ["sgd", "nesterov", "lars"]
LARS_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _tree_shapes(tree):
    """The leaf paths and shapes of the reduced ResNet or smoke qwen2, from
    the port's init (no JAX compile)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import resnet
    from repro_torch.models.model import build_model
    if tree == "resnet":
        params = resnet.init_params(get_config("resnet50"),
                                    torch.Generator().manual_seed(0), "cpu",
                                    *RESNET_CUT)
    else:
        params = build_model(smoke_variant(get_config("qwen2-1.5b"))).init(
            0, "cpu")
    return tuple((k, v.shape) for k, v in interop.to_flat(params).items())


def _nest(flat):
    out = {}
    for key, v in flat.items():
        *parents, leaf = key.split("::")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@functools.lru_cache(maxsize=None)
def _tree_case(tree, kind, jax_fused):
    """numpy inputs (w0, m0, two gradient steps, lrs) and the reference's
    params and momentum after the two steps, flat by path."""
    rng = np.random.default_rng(7)
    shapes = _tree_shapes(tree)
    wdt = jnp.float32 if tree == "resnet" else jnp.bfloat16
    w0 = {k: np.asarray(jnp.asarray(rng.standard_normal(s), wdt))
          for k, s in shapes}
    m0 = {k: (0.01 * rng.standard_normal(s)).astype(np.float32)
          for k, s in shapes}
    # gradients that bfloat16 holds exactly
    grads = [{k: np.asarray(jnp.asarray(
        0.1 * rng.standard_normal(s), jnp.bfloat16), np.float32)
        for k, s in shapes} for _ in range(2)]
    lrs = [0.1, 0.05]
    jcfg = jsgd.OptimConfig(fused=jax_fused, **KINDS[kind])
    step = jax.jit(functools.partial(jsgd.apply_update, cfg=jcfg))
    jp = _nest({k: jnp.asarray(v) for k, v in w0.items()})
    js = {"m": _nest({k: jnp.asarray(v) for k, v in m0.items()})}
    for g, lr in zip(grads, lrs):
        jp, js = step(jp, js, _nest({k: jnp.asarray(v) for k, v in g.items()}),
                      jnp.float32(lr))
    flat = lambda t: {k: np.asarray(v, np.float32)
                      for k, v in _flatten(t).items()}
    return w0, m0, grads, lrs, flat(jp), flat(js["m"])


TREE_CASES = ([("resnet", "sgd", True), ("resnet", "lars", False)]
              + [("qwen2", k, False) for k in TREE_KINDS])


@pytest.mark.parametrize("tree,kind,jax_fused", TREE_CASES)
def test_whole_tree_update_matches_reference(tree, kind, jax_fused):
    """``apply_update`` over a whole tree (one ``fused_sgd_update`` call, the
    plain version on the CPU) against the reference's ``apply_update``:
    lr as a float and as a 0-dim tensor, g float32 and bfloat16."""
    w0, m0, grads, lrs, want_w, want_m = _tree_case(tree, kind, jax_fused)
    tcfg = tsgd.OptimConfig(**KINDS[kind])
    wdt = torch.float32 if tree == "resnet" else torch.bfloat16
    for lr_tensor in (False, True):
        for gdt in (torch.float32, torch.bfloat16):
            tp = interop.from_flat(w0, device="cpu")
            ts = {"m": interop.from_flat(m0, device="cpu")}
            assert all(x.dtype == wdt for x in leaves(tp))
            for g, lr in zip(grads, lrs):
                tg = interop.from_flat(g, device="cpu")
                tg = _cast_tree(tg, gdt)
                tlr = torch.tensor(lr, dtype=torch.float32) if lr_tensor \
                    else lr
                tp, ts = tsgd.apply_update(tp, ts, tg, tlr, tcfg)
            got_w, got_m = interop.to_flat(tp), interop.to_flat(ts["m"])
            label = f"{tree} {kind} lr_tensor={lr_tensor} g={gdt} "
            for k in want_w:
                atol_m = (LARS_ATOL * np.abs(want_m[k]).max()
                          if kind == "lars" else 1e-6)
                atol_w = sum(lrs) * atol_m if kind == "lars" else 1e-6
                got = np.asarray(got_w[k], np.float32)
                if wdt == torch.bfloat16:
                    assert np.all(np.abs(got - want_w[k]) <= atol_w
                                  + 2.0 ** -7 * np.abs(want_w[k])), label + k
                else:
                    np.testing.assert_allclose(got, want_w[k], atol=atol_w,
                                               rtol=1e-6, err_msg=label + k)
                np.testing.assert_allclose(got_m[k], want_m[k], atol=atol_m,
                                           rtol=1e-6, err_msg=label + k)


def _cast_tree(tree, dtype):
    return {k: _cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def test_lars_trust_plain_matches_reference_per_leaf():
    """The stacked trust of the plain version is the reference's
    ``_lars_trust`` a leaf (1 where a norm is 0: a zero leaf and a zero
    gradient)."""
    rng = np.random.default_rng(2)
    shapes = [(5, 7), (64,), (3, 3, 4, 8), (9,), (4,)]
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [0.1 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    ws[3][:] = 0
    gs[4][:] = 0
    cfg = jsgd.OptimConfig(kind="lars")
    want = np.array([float(jsgd._lars_trust(jnp.asarray(w), jnp.asarray(g),
                                            cfg)) for w, g in zip(ws, gs)])
    got = fused_update.lars_trust(
        [torch.from_numpy(w) for w in ws], [torch.from_numpy(g) for g in gs],
        eta=cfg.lars_eta, eps=cfg.lars_eps, weight_decay=cfg.weight_decay)
    assert got.dtype == torch.float32 and got.shape == (len(shapes),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert got[3] == 1 and got[4] == 1


def _cu_constant(name):
    src = (Path(fused_update.__file__).resolve().parents[1] / "csrc"
           / "fused_update.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_launch_rule_constants_match_the_cuda_source():
    assert fused_update.CHUNK == _cu_constant("kChunk")
    assert fused_update.TABLE_LEAVES == _cu_constant("kTableLeaves")
    assert fused_update.THREADS == _cu_constant("kThreads")
    assert fused_update.CHUNK % (8 * fused_update.THREADS) == 0


def test_chunk_offsets_and_leaf_lookup():
    c = fused_update.CHUNK
    numels = [1, 7, 8, 0, c, c + 1, 2047, 0, 0, 3 * c, 64]
    off = fused_update.chunk_offsets(numels)
    assert off.tolist() == [0, 1, 2, 3, 3, 4, 6, 7, 7, 7, 10, 11]
    # every chunk finds the leaf that holds it; empty leaves hold none
    owner = [fused_update.leaf_of(off, k) for k in range(int(off[-1]))]
    assert owner == [0, 1, 2, 4, 5, 5, 6, 9, 9, 9, 10]
    for k, leaf in enumerate(owner):
        assert off[leaf] <= k < off[leaf + 1] and numels[leaf] > 0
    # ResNet-50's 161 leaves: 25,557,032 params in whole chunks but for
    # each leaf's last
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    ns = [p.numel() for p in leaves(build_model(get_config("resnet50"))
                                    .init(0, "cpu"))]
    off = fused_update.chunk_offsets(ns)
    assert len(ns) == 161 and sum(ns) == 25_557_032
    assert off[-1] == sum(-(-n // c) for n in ns)
    assert sum(ns) / c <= off[-1] < sum(ns) / c + 161


@pytest.mark.parametrize("leaves_n,want", [
    (1, 1), (161, 1), (768, 1), (769, 2), (1536, 2), (1537, 3)])
def test_launches_per_call_follow_the_table_rule(leaves_n, want):
    f32 = torch.float32
    keys = [(f32, f32, f32)] * leaves_n
    assert fused_update.launches_per_call(keys) == want
    assert fused_update.launches_per_call(keys, lars=True) == 3 * want
    plan = fused_update.launch_plan(keys)
    assert [len(idx) for _, idx in plan] == [
        min(fused_update.TABLE_LEAVES, leaves_n - s)
        for s in range(0, leaves_n, fused_update.TABLE_LEAVES)]
    assert [i for _, idx in plan for i in idx] == list(range(leaves_n))


def test_launch_plan_groups_mixed_dtypes():
    """One launch a (w, m, g) dtype triple that occurs, its leaves in
    order; LARS's norms pass groups by (w, g)."""
    f32, bf = torch.float32, torch.bfloat16
    keys = [(f32, f32, f32), (bf, f32, bf), (f32, f32, f32), (bf, f32, bf),
            (bf, bf, bf), (f32, bf, f32)]
    plan = fused_update.launch_plan(keys)
    assert plan == [((f32, f32, f32), [0, 2]), ((bf, f32, bf), [1, 3]),
                    ((bf, bf, bf), [4]), ((f32, bf, f32), [5])]
    # norms: (f32, f32) holds leaves 0, 2, 5 and (bf, bf) 1, 3, 4
    assert fused_update.launches_per_call(keys) == 4
    assert fused_update.launches_per_call(keys, lars=True) == 4 + 2 * 2
    many = [(f32, f32, f32)] * 800 + [(bf, f32, f32)] * 9
    assert fused_update.launches_per_call(many) == 3
    assert fused_update.launches_per_call(many, lars=True) == 9


def test_fused_update_takes_a_list_of_one_and_raises_off_cpu():
    """A single leaf is a list of one; a list on a device that is not CUDA
    (and not the CPU) raises, as every kernel wrapper does."""
    w, m, g = torch.ones(3), torch.zeros(3), torch.ones(3)
    out_w, out_m = fused_update.fused_sgd_update([w], [m], [g], lr=0.5,
                                                 momentum=0.0,
                                                 weight_decay=0.0)
    assert out_w[0] is w and out_m[0] is m
    torch.testing.assert_close(w, torch.full((3,), 0.5))
    meta = [torch.zeros(16, device="meta")]
    with pytest.raises(ValueError, match="CUDA"):
        fused_update.fused_sgd_update(meta, meta, meta, lr=0.1,
                                      momentum=0.9, weight_decay=0.0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_update.lars_trust(meta, meta, eta=1e-3, eps=1e-9,
                                weight_decay=0.0)


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
