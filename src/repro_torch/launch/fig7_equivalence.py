"""Paper Fig. 7 + §5.5 on the port (``benchmarks/fig7_equivalence.py``):
LSGD and CSGD give the same loss curve because their parameter
sequences are identical.

The same two experiments, sizes, recipe and checks as the reference
script:

  (a) a reduced ResNet (stages (1, 1, 1, 1), full widths, 10 classes)
      on synthetic 224 x 224 images, global batch 16;
  (b) a small LM (qwen1.5-0.5b's smoke variant cut to 2 layers of 64);

each trained 12 steps with serial SGD (Alg. 1), CSGD (Alg. 2, 8
workers) and LSGD (Alg. 3, 8 workers in groups of 4) through
``core/virtual.py``, with the paper's momentum / weight decay / warmup
recipe.  It fails unless the CSGD and LSGD curves and parameters agree
within 1e-3.  Serial SGD is printed, not checked: with per-shard batch
statistics (2 images a worker) ResNet's serial step is another function.

    python -m repro_torch.launch.fig7_equivalence [--device cpu]

On the card (the default; it raises without one) TF32 is off for
matmuls and cuDNN and cuDNN is deterministic, so that the gap measures
the algorithms rather than rounding or atomics; the flags are restored
on exit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
from typing import List, Tuple

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import virtual
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch.train import device_of
from repro_torch.models import resnet
from repro_torch.models.model import build_model, seeded_init
from repro_torch.optim import schedules
from repro_torch.optim.sgd import OptimConfig
from repro_torch.tree import leaves

N_WORKERS = 8
GROUP = 4
STEPS = 12
BOUND = 1e-3
RESNET_STAGES = (1, 1, 1, 1)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN, cuDNN deterministic; the three
    flags as they were on exit."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic = True
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic) = saved


def _batches(dcfg, device):
    return [{k: torch.from_numpy(v).to(device)
             for k, v in synth_batch(dcfg, t).items()} for t in range(STEPS)]


def _curves(model, p0, batches, lr_fn, ocfg):
    """(serial, csgd, lsgd losses, max |csgd - lsgd| over the params)."""
    wb = [virtual.partition_minibatch(b, N_WORKERS) for b in batches]
    _, l_serial = virtual.serial_sgd(model, p0, batches, lr_fn, ocfg)
    p_c, l_csgd = virtual.csgd(model, p0, wb, lr_fn, ocfg)
    p_l, l_lsgd = virtual.lsgd(model, p0, wb, lr_fn, ocfg, GROUP)
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(leaves(p_c), leaves(p_l)))
    return l_serial, l_csgd, l_lsgd, gap


def reduced_resnet():
    """ResNet-50's config and widths at stages (1, 1, 1, 1), 10 classes."""
    cfg = get_config("resnet50")
    return dataclasses.replace(
        build_model(cfg),
        init=functools.partial(seeded_init, cfg=cfg,
                               init_params=resnet.init_params,
                               stages=RESNET_STAGES, num_classes=10),
        loss=functools.partial(resnet.loss, cfg=cfg, stages=RESNET_STAGES))


def resnet_run(device):
    model = reduced_resnet()
    p0 = model.init(0, device)
    dcfg = DataConfig(kind="image", global_batch=16, image_size=224,
                      num_classes=10, seq_len=0)
    ocfg = OptimConfig(momentum=0.9, weight_decay=1e-4)
    # the reference's modest lr: synthetic labels and batch statistics
    # diverge above ~0.01, and a diverging loss amplifies the rounding
    # between the two-level and the flat mean
    lr_fn = lambda t: schedules.warmup_step_decay(
        t, base_lr=0.002, peak_lr=0.01, warmup_steps=5, decay_every=8)
    return _curves(model, p0, _batches(dcfg, device), lr_fn, ocfg)


def lm_run(device):
    cfg = smoke_variant(get_config("qwen1.5-0.5b")).replace(
        num_layers=2, d_model=64, d_ff=128, vocab_size=128)
    model = build_model(cfg)
    p0 = model.init(0, device)
    dcfg = DataConfig(kind="lm", vocab_size=128, seq_len=32,
                      global_batch=16)
    ocfg = OptimConfig(momentum=0.9, weight_decay=1e-4)
    lr_fn = lambda t: schedules.warmup_step_decay(
        t, base_lr=0.05, peak_lr=0.2, warmup_steps=4, decay_every=8)
    return _curves(model, p0, _batches(dcfg, device), lr_fn, ocfg)


def check(name, curves, print_fn=print) -> Tuple[str, float, float]:
    """Prints one experiment's CSV; raises unless CSGD and LSGD agree."""
    l1, l2, l3, gap = curves
    print_fn(f"# fig7[{name}]: loss curves, serial vs CSGD vs LSGD "
             f"(param gap {gap:.2e})")
    print_fn("step,serial,csgd,lsgd")
    for t, (a, b, c) in enumerate(zip(l1, l2, l3)):
        print_fn(f"{t},{a:.5f},{b:.5f},{c:.5f}")
    curve_gap = max(abs(b - c) / max(abs(b), 1.0) for b, c in zip(l2, l3))
    if not curve_gap < BOUND:
        raise RuntimeError(f"{name}: LSGD curve diverges from CSGD by "
                           f"{curve_gap}")
    if not gap < BOUND:
        raise RuntimeError(f"{name}: parameter gap {gap}")
    return name, gap, curve_gap


def main(argv=None, print_fn=print) -> List[Tuple[str, float, float]]:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fig7_equivalence")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = device_of(ap.parse_args(argv).device)
    with exact_float32():
        return [check(name, fn(device), print_fn)
                for name, fn in (("resnet", resnet_run), ("lm", lm_run))]


if __name__ == "__main__":
    main()
