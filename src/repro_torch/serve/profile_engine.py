"""Where a serving step's time goes on the card: serves a fixed workload
through full-width qwen2-1.5b (random bf16 weights from a seed) at
steps_per_dispatch 1 and 8 under ``torch.profiler`` (device activity
only: recording every host operator slows the run about fourfold), and
prints, per depth, the wall time, the device's busy share (summed
kernel time over wall time), the kernels launched per model call, the
kernel time by group (the port's CUDA kernels, matrix products,
everything else), the top kernels, and the engine's host time per
dispatch.

    python -m repro_torch.serve.profile_engine [--out DIR]

Needs a CUDA card.  With ``--out`` it also writes a Chrome trace per
depth there.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models.model import build_model
from repro_torch.serve import Engine, EngineConfig, Request

PORT_KERNELS = tuple(_build.kernel_names())
# cuBLAS names its Hopper products "nvjet_*"; older builds "*gemm*"
GEMM_MARKERS = ("nvjet", "gemm", "xmma", "cutlass", "wgmma", "matmul")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _group(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    low = name.lower()
    if any(k in low for k in GEMM_MARKERS):
        return "matrix products"
    return "other"


# The serving workload shared with chip_smoke.py: 8 decode rows, pools
# for 513 blocks of 16 tokens, 128-token prefill chunks.
ENGINE_CONFIG = dict(max_batch=8, block_size=16, num_blocks=513,
                     max_seq_len=640, prefill_chunk=128,
                     prefill_token_budget=256)


def workload(vocab_size: int, seed: int):
    """16 requests from ``seed``: prompts of 64-512 random tokens, 32-128
    new tokens each, as (prompt int32 array, max_new_tokens) pairs."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab_size, (int(p),)).astype(np.int32), int(n))
            for p, n in zip(rng.integers(64, 513, 16),
                            rng.integers(32, 129, 16))]


def profile(depth: int, model, params, work, out_dir=None) -> dict:
    eng = Engine(model, params, EngineConfig(steps_per_dispatch=depth,
                                             **ENGINE_CONFIG), device="cuda")
    eng.warmup()
    reqs = [Request(prompt=p.copy(), max_new_tokens=n, rid=i)
            for i, (p, n) in enumerate(work)]
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ntok = sum(len(r.tokens) for r in res.values())
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
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out_dir / f"serve_depth{depth}.json"))
    full = eng.metrics_snapshot()
    snap = full["counters"]
    return {
        "depth": depth, "wall_s": wall, "tokens": ntok,
        "tok_s": ntok / wall, "steps": snap["steps"],
        "model_calls": snap["model_calls"],
        "kernels_per_model_call": sum(c for _, c, _ in kernels)
        / max(snap["model_calls"], 1),
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
        "device_s_by_group": {k: v / 1e6 for k, v in sorted(by_group.items())},
        "top_kernels": [{"name": n[:90], "device_s": us / 1e6, "count": c}
                        for us, c, n in kernels[:8]],
        "dispatch_s": full["dispatch_s"],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the Chrome traces")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine: needs a CUDA card")
    cfg = get_config("qwen2-1.5b")
    model = build_model(cfg)
    params = model.init(args.seed, "cuda")
    work = workload(cfg.vocab_size, args.seed)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[card] {card or torch.cuda.get_device_name(0)}", flush=True)
    for depth in (1, 8):
        print(json.dumps(profile(depth, model, params, work, args.out)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
