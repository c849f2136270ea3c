"""Where a training step's time goes on the card: builds the trainer of
``repro_torch.launch.train`` from the same flags (default: full-width
qwen2-1.5b, batch 4 x 512, LSGD, fused SGD, lr 0.01), takes a few warm
steps, then profiles ``--steps`` steps under ``torch.profiler`` (device
activity only) and prints one JSON line: step time, the device's busy
share, kernel time by group (the port's CUDA kernels, matrix products,
everything else) and the top kernels.  ``--attn-impl`` replaces the
config's attention form (``naive`` or ``blocked``; qwen2-1.5b's config
asks for ``blocked``), so that two forms compare in one process.

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
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import train
from repro_torch.models.model import build_model
from repro_torch.serve.profile_engine import _device_us, _group

DEFAULTS = ["--arch", "qwen2-1.5b", "--batch", "4", "--seq", "512",
            "--sync-mode", "lsgd", "--base-lr", "0.01", "--schedule",
            "const"]
WARM_STEPS = 3


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
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    batches = [{"tokens": torch.from_numpy(np.ascontiguousarray(
        synth_batch(dcfg, t)["tokens"])).cuda()}
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
        by_group[_group(evt.key)] += us
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
        "seq": args.seq, "sync_mode": args.sync_mode, "steps": steps,
        "step_s": wall / steps, "loss": float(loss),
        "kernels_per_step": sum(c for _, c, _ in kernels) / steps,
        "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
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
