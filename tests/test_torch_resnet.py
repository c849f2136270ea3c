"""The port's ResNet against the JAX package's on the CPU, float32.

A reduced net (stages (1, 1, 1, 1), widths (8, 16, 32, 64), 10 classes,
batch 4; batch-norm scales and biases perturbed so that every param
matters) carried across by ``interop``, on 32 x 32 images (every
stride-2 layer pads "SAME" asymmetrically: 0 before, 1 after) and 33 x
33 (symmetric: 1 and 1).  The training checks use 64 x 64 images, so
that the last stage's batch statistics see 2 x 2 positions a row: over
a 1 x 1 map of 2 images a worker they normalise two values, and the
gradient amplifies rounding a hundredfold.

Bound: |port - jax| <= 1e-4 + 1e-4 * |jax| for logits, loss, every
gradient and the params after LSGD / virtual steps (two f32 stacks of
convolutions and batch statistics summing in other orders; the worst
seen is under 1e-5).

Also: batch statistics alone against the reference's ``_bn``, every
gradient in its parameter's strides (autograd alone gives a permuted
HWIO weight a gradient in the OIHW view's layout), the full ResNet-50
tree (161 paths, 25,557,032 params) against ``jax.eval_shape`` of the
reference's init, one LSGD step and ``finalize`` from a JAX trainer
state, the virtual algorithms against the JAX package's, the launcher
on the CPU, the engine's refusal, the configs, and the kernel groups of
``profile_train``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.core import TrainerConfig as JaxTrainerConfig
from repro.core import make_finalize as jax_make_finalize
from repro.core import make_shardmap_step
from repro.core import virtual as jvirtual
from repro.launch.mesh import make_mesh
from repro.models import resnet as jresnet
from repro.models.model import build_model as jax_build_model
from repro.optim.sgd import OptimConfig as JaxOptimConfig
from repro_torch import interop
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import trainer as ttrainer
from repro_torch.core import virtual as tvirtual
from repro_torch.core.autodiff import value_and_grad
from repro_torch.models import resnet
from repro_torch.models.model import build_model, seeded_init
from repro_torch.optim.sgd import OptimConfig
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401

STAGES = (1, 1, 1, 1)
WIDTHS = (8, 16, 32, 64)
CLASSES = 10
BATCH = 4
SIZES = (32, 33)
ATOL = RTOL = 1e-4


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _batch(n, t=0, b=BATCH):
    rng = np.random.default_rng([n, t])
    return {"images": rng.standard_normal((b, n, n, 3)).astype(np.float32),
            "labels": rng.integers(0, CLASSES, (b,)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _nest(flat):
    """``{"a::b": x}`` -> ``{"a": {"b": x}}`` (a JAX pytree)."""
    out = {}
    for key, v in flat.items():
        *parents, leaf = key.split("::")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _models():
    """(jax model, port model) of the reduced net."""
    jcfg, tcfg = jax_get_config("resnet50"), get_config("resnet50")
    jmodel = jax_build_model(jcfg)
    jmodel.init = functools.partial(jresnet.init_params, cfg=jcfg,
                                    stages=STAGES, widths=WIDTHS,
                                    num_classes=CLASSES)
    jmodel.loss = functools.partial(jresnet.loss, cfg=jcfg, stages=STAGES)
    tmodel = dataclasses.replace(
        build_model(tcfg),
        init=functools.partial(seeded_init, cfg=tcfg,
                               init_params=resnet.init_params, stages=STAGES,
                               widths=WIDTHS, num_classes=CLASSES),
        loss=functools.partial(resnet.loss, cfg=tcfg, stages=STAGES))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def carried():
    """The reduced net's params (batch-norm scales and biases and the fc
    bias perturbed) in both packages, and the JAX loss, logits and
    gradients at both image sizes."""
    jmodel, tmodel = _models()
    # the port's init (JAX's compiles for 20 s on one core), carried over
    flat = interop.to_flat(tmodel.init(0, "cpu"))
    rng = np.random.default_rng(0)
    for k in flat:
        if k.split("::")[-1] in ("scale", "bias", "b"):
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    jparams = _nest({k: jnp.asarray(v) for k, v in flat.items()})
    tparams = interop.from_flat(flat, device="cpu")
    # one compile a size: loss, its gradient and (as aux) the logits
    loss_logits = jax.jit(jax.value_and_grad(
        lambda p, b: (jmodel.loss(p, b)[0],
                      jresnet.forward(p, b["images"], jmodel.cfg, STAGES)),
        has_aux=True))
    ref = {}
    for n in SIZES:
        (loss, logits), g = loss_logits(jparams, _jax(_batch(n)))
        ref[n] = (float(loss), np.asarray(logits),
                  {k: np.asarray(v) for k, v in _flatten(g).items()})
    return jmodel, jparams, tmodel, tparams, ref


@pytest.mark.parametrize("n", SIZES)
def test_forward_loss_and_grads_match_jax(carried, n):
    _, _, tmodel, tparams, ref = carried
    want_loss, want_logits, want_g = ref[n]
    b = _torch(_batch(n))
    logits = resnet.forward(tparams, b["images"], tmodel.cfg, STAGES)
    _close(logits.numpy(), want_logits)
    loss, metrics, g = value_and_grad(tmodel.loss, tparams, b)
    _close(float(loss), want_loss)
    assert float(metrics["ce"]) == float(loss)
    got = interop.to_flat(g)
    assert got.keys() == want_g.keys()
    for k in want_g:
        _close(got[k], want_g[k])


@pytest.mark.parametrize("n", SIZES)
def test_gradients_keep_their_params_strides(carried, n):
    """The repair in ``core/autodiff``: every gradient leaf is laid out as
    its param is (contiguous), where autograd alone returns a permuted
    one for each conv weight."""
    _, _, tmodel, tparams, _ = carried
    b = _torch(_batch(n))
    _, _, g = value_and_grad(tmodel.loss, tparams, b)
    for p, gp in zip(leaves(tparams), leaves(g)):
        assert gp.is_contiguous() and gp.stride() == p.stride()
    w = tparams["stage_1"]["block_0"]["conv2"]["w"].clone().requires_grad_()
    x = torch.randn((2, w.shape[2], n, n))
    raw, = torch.autograd.grad(resnet.conv(w, x, 2).sum(), w)
    assert not raw.is_contiguous()


def test_batch_statistics_match_reference_bn():
    rng = np.random.default_rng(3)
    x = (3.0 + 2.0 * rng.standard_normal((5, 7, 6, 16))).astype(np.float32)
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    want = np.asarray(jresnet._bn(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = resnet.bn({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want)
    # the population (biased) variance, not torch.var's default
    t = torch.from_numpy(x)
    mean, var = t.mean((0, 1, 2)), t.var((0, 1, 2), unbiased=False)
    pop = (t - mean) / torch.sqrt(var + resnet.BN_EPS) \
        * torch.from_numpy(p["scale"]) + torch.from_numpy(p["bias"])
    _close(got.permute(0, 2, 3, 1).numpy(), pop.numpy())


@pytest.mark.parametrize("n,k,s,want", [
    (224, 7, 2, (2, 3)),         # the stem
    (112, 3, 2, (0, 1)),         # the max pool
    (56, 3, 2, (0, 1)), (28, 3, 2, (0, 1)), (14, 3, 2, (0, 1)),
    (33, 3, 2, (1, 1)), (17, 3, 2, (1, 1)),
    (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (7, 1, 1, (0, 0))])
def test_same_pads_follow_xla(n, k, s, want):
    assert resnet.same_pads(n, k, s) == want


def test_full_resnet50_tree_matches_reference():
    jcfg, tcfg = jax_get_config("resnet50"), get_config("resnet50")
    shapes = jax.eval_shape(lambda: jresnet.init_params(jax.random.key(0),
                                                        jcfg))
    want = {k: tuple(v.shape) for k, v in _flatten(shapes).items()}
    params = build_model(tcfg).init(0, "cpu")
    got = {k: tuple(v.shape) for k, v in interop.to_flat(params).items()}
    assert got == want and len(got) == 161
    assert sum(int(np.prod(s)) for s in got.values()) == 25_557_032
    assert all(p.dtype == torch.float32 for p in leaves(params))


def test_lsgd_from_a_jax_trainer_state_matches_jax(carried):
    """A JAX LSGD trainer state at step 3 with a live pending update and
    momentum, carried by ``interop.state_from_flat``; one step and
    ``finalize`` in each package."""
    jmodel, jparams, tmodel, _, _ = carried
    lr_fn = lambda t: 0.01
    rng = np.random.default_rng(5)
    noise = lambda p: jnp.asarray(
        1e-2 * rng.standard_normal(p.shape).astype(np.float32))
    state = {"params": jparams, "opt": {"m": jax.tree.map(noise, jparams)},
             "step": jnp.int32(3), "pending": jax.tree.map(noise, jparams)}
    tstate = interop.state_from_flat(
        {k: np.asarray(v) for k, v in _flatten(state).items()}, device="cpu")
    assert tstate["step"] == 3 and tstate["inflight"] is None
    jt = JaxTrainerConfig(sync_mode="lsgd")
    jstep = jax.jit(make_shardmap_step(
        jmodel, jt, lr_fn, make_mesh((1, 1), ("data", "model"))))
    tt = ttrainer.TrainerConfig(sync_mode="lsgd")
    b = _batch(64)
    state, (jl, _) = jstep(state, _jax(b))
    tstate, (tl, _) = ttrainer.make_step(tmodel, tt, lr_fn)(tstate,
                                                             _torch(b))
    _close(float(tl), float(jl))
    state = jax.jit(jax_make_finalize(jmodel, jt, lr_fn))(state)
    tstate = ttrainer.make_finalize(tmodel, tt, lr_fn)(tstate)
    assert tstate["step"] == int(state["step"]) == 4
    for tree in ("params", "opt"):
        want = {k: np.asarray(v) for k, v in _flatten(state[tree]).items()}
        got = interop.to_flat(tstate[tree])
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])


def test_virtual_algorithms_match_jax(carried):
    """Serial SGD, CSGD and LSGD (4 workers of 4 images at 64 x 64, groups
    of 2, 3 steps) in the port; its CSGD and LSGD equal each other and
    the JAX package's LSGD.  Serial SGD runs (batch statistics over all
    16 images make it another function) and moves the params."""
    jmodel, jparams, tmodel, tparams, _ = carried
    batches = [_batch(64, t, b=16) for t in range(3)]
    ocfg = dict(momentum=0.9, weight_decay=1e-4)
    lr_fn = lambda t: 0.01 / (1 + t)
    jw = [jvirtual.partition_minibatch(_jax(b), 4) for b in batches]
    tw = [tvirtual.partition_minibatch(_torch(b), 4) for b in batches]
    to = OptimConfig(**ocfg)
    pj, lj = jvirtual.lsgd(jmodel, jparams, jw, lr_fn,
                           JaxOptimConfig(**ocfg), 2)
    pt_s, _ = tvirtual.serial_sgd(tmodel, tparams,
                                  [_torch(b) for b in batches], lr_fn, to)
    pt_c, lt_c = tvirtual.csgd(tmodel, tparams, tw, lr_fn, to)
    pt_l, lt_l = tvirtual.lsgd(tmodel, tparams, tw, lr_fn, to, 2)
    want = {k: np.asarray(v) for k, v in _flatten(pj).items()}
    for got in (interop.to_flat(pt_c), interop.to_flat(pt_l)):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    _close(lt_c, lj)
    _close(lt_l, lj)
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(pt_s), leaves(tparams))) > 0


def test_launcher_trains_resnet50_on_cpu():
    from repro_torch.launch import train
    out = train.main(["--arch", "resnet50", "--device", "cpu", "--steps",
                      "2", "--batch", "2", "--log-every", "100"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["samples_per_step"] == 2 and out["tokens_per_step"] is None
    assert out["params"] == 25_557_032 and out["state"]["step"] == 2


def test_engine_refuses_a_resnet_model():
    from repro_torch.serve import Engine
    model = build_model(get_config("resnet50"))
    assert model.paged_spec is None and model.paged_step is None
    with pytest.raises(ValueError, match="'resnet' family"):
        Engine(model, {}, device="cpu")


@pytest.mark.parametrize("name", ["resnet50", "qwen1.5-0.5b"])
def test_config_fields_match_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jax_get_config(name))
    assert dataclasses.asdict(smoke_variant(get_config(name))) == \
        dataclasses.asdict(jax_smoke_variant(jax_get_config(name)))


@pytest.mark.parametrize("name,group", [
    ("sm90_xmma_fprop_implicit_gemm_tf32f32_tf32f32_f32_nhwckrsc_nhwc",
     "convolutions"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_tf32f32", "convolutions"),
    ("cudnn::engines_precompiled::nhwcToNchwKernel", "copies"),
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel",
     "batch statistics"),
    ("cudnn::bn_fw_tr_1C11_kernel_NCHW", "batch statistics"),
    ("void cudnn::batchnorm_bwtr_nhwc_semiPersist<float, float, float, 512>",
     "batch statistics"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128_32x5_nt>",
     "matrix products"),
    ("void at::native::max_pool_forward_nhwc<float, float>", "pooling"),
    ("void at::native::elementwise_kernel<128, 4, direct_copy_kernel_cuda>",
     "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, threshold>",
     "elementwise"),
    ("nvjet_tst_128x64_64x4_1x2_h_bz_TNN", "matrix products"),
    ("void rt::fused_sgd_kernel<float, float>", "port kernels"),
    ("void (anonymous namespace)::fused_sgd_kernel<float, float, float>("
     "(anonymous namespace)::Table, float const*, float, float const*, "
     "(anonymous namespace)::Hyper)", "port kernels"),
    ("void (anonymous namespace)::lars_norms_kernel<float, float>("
     "(anonymous namespace)::Table, float2*)", "port kernels"),
    ("(anonymous namespace)::lars_trust_kernel((anonymous namespace)::Table, "
     "float2 const*, float*, float, float, float)", "port kernels"),
    ("void at::native::reduce_kernel<512, 1>", "other")])
def test_profile_train_kernel_groups(name, group):
    from repro_torch.launch.profile_train import group_of
    assert group_of(name) == group
