"""ResNet-50 (He et al. 2016), the paper's own model, as the reference's
``repro/models/resnet.py``: the same nesting, leaf shapes and HWIO
weight layout, so ``interop``, trainer states and checkpoints carry
across 1:1.  Batch-statistics BatchNorm with no running state (the
reference's recorded deviation: per-shard statistics, a functional
step).

Images are NHWC, as the data pipeline makes them.  ``x.permute(0, 3, 1,
2)`` is an NCHW tensor in channels-last memory at no cost, the layout
cuDNN's NHWC convolutions take; an HWIO weight is seen as OIHW through a
permuted view, which the convolution copies.

The reference pads ``"SAME"`` as XLA does: ``total = max((ceil(n/s) - 1)
* s + k - n, 0)``, ``total // 2`` before and the rest after.  Where the
two sides differ (every stride-2 layer on an even size: the stem's 7x7
on 224 pads 2 and 3, the 3x3 convs and the max pool 0 and 1) the input
is padded explicitly, with -inf for the pool; PyTorch's own padding is
symmetric and would shift every window by one.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cross_entropy

STAGES = (3, 4, 6, 3)          # ResNet-50
WIDTHS = (64, 128, 256, 512)
BN_EPS = 1e-5


def _conv_init(gen, shape, dtype, device):  # HWIO
    fan_in = shape[0] * shape[1] * shape[2]
    w = torch.randn(shape, generator=gen, device=device) * math.sqrt(
        2.0 / fan_in)
    return w.to(dtype)


def _bn_init(c, dtype, device):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads(x, k, s):
    """(left, right, top, bottom) of ``"SAME"`` for NCHW ``x``, F.pad's
    order."""
    return same_pads(x.shape[3], k, s) + same_pads(x.shape[2], k, s)


def bn(p, x):
    """Batch statistics over (N, H, W) in float32: mean and the biased
    (population) variance, eps BN_EPS, as the reference's ``_bn``."""
    y = F.batch_norm(x.float(), None, None, p["scale"].float(),
                     p["bias"].float(), training=True, eps=BN_EPS)
    return y.to(x.dtype)


def conv(w, x, stride=1):
    """``"SAME"`` convolution of NCHW ``x`` by HWIO ``w``."""
    k = w.shape[0]
    pads = _pads(x, k, stride)
    w = w.to(x.dtype).permute(3, 2, 0, 1)
    if pads[0] == pads[1] and pads[2] == pads[3]:
        return F.conv2d(x, w, stride=stride, padding=(pads[2], pads[0]))
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def max_pool(x, k=3, s=2):
    """``"SAME"`` max pool, padded with -inf."""
    return F.max_pool2d(F.pad(x, _pads(x, k, s), value=-math.inf), k, s)


def _init_bottleneck(gen, cin, width, stride, dtype, device):
    cout = width * 4
    p = {"conv1": {"w": _conv_init(gen, (1, 1, cin, width), dtype, device)},
         "bn1": _bn_init(width, dtype, device),
         "conv2": {"w": _conv_init(gen, (3, 3, width, width), dtype,
                                   device)},
         "bn2": _bn_init(width, dtype, device),
         "conv3": {"w": _conv_init(gen, (1, 1, width, cout), dtype, device)},
         "bn3": _bn_init(cout, dtype, device)}
    if stride != 1 or cin != cout:
        p["proj"] = {"w": _conv_init(gen, (1, 1, cin, cout), dtype, device)}
        p["bn_proj"] = _bn_init(cout, dtype, device)
    return p


def _bottleneck(p, x, stride):
    r = x
    y = F.relu(bn(p["bn1"], conv(p["conv1"]["w"], x)))
    y = F.relu(bn(p["bn2"], conv(p["conv2"]["w"], y, stride)))
    y = bn(p["bn3"], conv(p["conv3"]["w"], y))
    if "proj" in p:
        r = bn(p["bn_proj"], conv(p["proj"]["w"], x, stride))
    return F.relu(y + r)


def init_params(cfg, gen: torch.Generator, device,
                stages: Sequence[int] = STAGES,
                widths: Sequence[int] = WIDTHS, num_classes: int = 1000):
    """Random params from ``gen`` (the reference's init distributions:
    He-normal convs, unit BN scales, fc normal * 0.01)."""
    dtype = cfg.pdtype
    params = {"stem": {"conv": {"w": _conv_init(gen, (7, 7, 3, 64), dtype,
                                                device)},
                       "bn": _bn_init(64, dtype, device)}}
    cin = 64
    for si, (n, w) in enumerate(zip(stages, widths)):
        blocks = {}
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            blocks[f"block_{bi}"] = _init_bottleneck(gen, cin, w, stride,
                                                     dtype, device)
            cin = w * 4
        params[f"stage_{si}"] = blocks
    fc_w = torch.randn((cin, num_classes), generator=gen, device=device)
    params["fc"] = {"w": (fc_w * 0.01).to(dtype),
                    "b": torch.zeros((num_classes,), dtype=dtype,
                                     device=device)}
    return params


def forward(params, images, cfg, stages: Sequence[int] = STAGES):
    """images (B, H, W, 3) -> logits (B, classes)."""
    x = images.to(cfg.cdtype).permute(0, 3, 1, 2)
    x = F.relu(bn(params["stem"]["bn"],
                  conv(params["stem"]["conv"]["w"], x, stride=2)))
    x = max_pool(x)
    for si, n in enumerate(stages):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            x = _bottleneck(params[f"stage_{si}"][f"block_{bi}"], x, stride)
    x = x.mean((2, 3))
    return x @ params["fc"]["w"].to(x.dtype) + params["fc"]["b"].to(x.dtype)


def loss(params, batch, cfg, stages: Sequence[int] = STAGES):
    logits = forward(params, batch["images"], cfg, stages)
    ce = cross_entropy(logits, batch["labels"])
    acc = (logits.argmax(-1) == batch["labels"]).float().mean()
    return ce, {"loss": ce, "ce": ce, "accuracy": acc}
