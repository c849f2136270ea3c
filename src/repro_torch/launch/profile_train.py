"""Where a training step's time goes on the card: builds the trainer of
``repro_torch.launch.train`` from the same flags (default: full-width
qwen2-1.5b, batch 4 x 512, LSGD, fused SGD, lr 0.01; ``--arch resnet50
--batch 64`` trains ResNet-50 on 224 x 224 images, ``--arch
recurrentgemma-2b`` the RG-LRU hybrid, ``--arch whisper-tiny --batch 8
--seq 448`` the encoder-decoder over 1,500 stub frames a row), takes a
few warm steps on batches already on the card (no host loader), then
profiles
``--steps`` steps under ``torch.profiler`` (device activity only) and
prints one JSON line: step time, the device's busy and idle shares,
kernel time by group and the top kernels.  The groups, first match
first: the port's CUDA kernels, batch statistics (PyTorch's and cuDNN's
batch-norm kernels), pooling, copies (layout changes and casts: the
HWIO weights seen as OIHW, their gradients put back), cuDNN's
convolutions, elementwise, matrix products, everything else.
``--attn-impl`` replaces the config's attention form (``naive`` or
``blocked``; qwen2-1.5b's config asks for ``blocked``), so that two
forms compare in one process.

    python -m repro_torch.launch.profile_train [--steps 3] \
        [--attn-impl naive|blocked] [train flags]

Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core.trainer import make_init_state, make_step
from repro_torch.data.pipeline import synth_batch
from repro_torch.launch import train
from repro_torch.models.model import build_model
from repro_torch.serve.profile_engine import (GEMM_MARKERS, PORT_KERNELS,
                                              _device_us)

DEFAULTS = ["--arch", "qwen2-1.5b", "--batch", "4", "--seq", "512",
            "--sync-mode", "lsgd", "--base-lr", "0.01", "--schedule",
            "const"]
WARM_STEPS = 3
# (group, lower-case name fragments), matched in order after the port's
# kernels; cuDNN's batch-norm and layout kernels carry "cudnn" too
GROUPS = (
    ("batch statistics", ("batch_norm", "batchnorm", "bn_fw", "bn_bw",
                          "welford")),
    ("pooling", ("pool",)),
    ("copies", ("copy", "nchwtonhwc", "nhwctonchw", "transpose")),
    ("convolutions", ("fprop", "dgrad", "wgrad", "convolve", "winograd",
                      "implicit", "cudnn")),
    ("elementwise", ("elementwise",)),
    ("matrix products", GEMM_MARKERS),
)


def group_of(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)),
                "other")


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    steps, impl = 3, None
    if "--steps" in argv:
        i = argv.index("--steps")
        steps = int(argv[i + 1])
        del argv[i:i + 2]
    if "--attn-impl" in argv:
        i = argv.index("--attn-impl")
        impl = argv[i + 1]
        if impl not in ("naive", "blocked"):
            raise SystemExit("profile_train: --attn-impl naive|blocked "
                             "(the flash-attention kernel has no backward)")
        del argv[i:i + 2]
    args = train.parse_args(DEFAULTS + argv)
    if not torch.cuda.is_available() or args.device != "cuda":
        raise SystemExit("profile_train: needs a CUDA card")
    cfg = train.model_config(args)
    if impl is not None:
        cfg = cfg.replace(attn_impl=impl)
    model = build_model(cfg)
    tcfg = train.trainer_config(args)
    state = make_init_state(model, tcfg, "cuda")(args.seed)
    step = make_step(model, tcfg, train.lr_schedule(args))
    dcfg = train.data_config(cfg, args)
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                for k, v in synth_batch(dcfg, t).items()}
               for t in range(WARM_STEPS + steps)]
    for b in batches[:WARM_STEPS]:
        state, (loss, _) = step(state, b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches[WARM_STEPS:]:
            state, (loss, _) = step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_group = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_group[group_of(evt.key)] += us
        kernels.append((us, evt.count, evt.key))
    busy_us = sum(by_group.values())
    kernels.sort(reverse=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {
        "card": card, "arch": cfg.name, "attn_impl": cfg.attn_impl,
        "batch": args.batch,
        "seq": None if dcfg.kind == "image" else args.seq,
        "sync_mode": args.sync_mode, "steps": steps,
        "step_s": wall / steps, "loss": float(loss),
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "kernels_per_step": sum(c for _, c, _ in kernels) / steps,
        "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
        "device_idle_share": 1 - busy_us / 1e6 / wall if busy_us else None,
        "device_s_per_step_by_group": {
            k: v / 1e6 / steps for k, v in sorted(by_group.items())},
        "top_kernels": [{"name": n[:90], "device_s_per_step": us / 1e6 / steps,
                         "count_per_step": c / steps}
                        for us, c, n in kernels[:10]],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
