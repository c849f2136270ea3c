"""End-to-end training driver of the port (``repro/launch/train.py``).

    # one card (the default device is CUDA; it raises without one)
    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 8 \\
        --batch 4 --seq 512 --sync-mode lsgd

    # the smoke model on the CPU
    python -m repro_torch.launch.train --smoke --device cpu --steps 20

    # four ranks, two groups of two (NCCL on cards, gloo on the CPU)
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
        --device cpu --sync-mode lsgd --intra-group-size 2

One process per rank: under ``torchrun`` (``WORLD_SIZE`` > 1) each rank
joins the process group at ``MASTER_ADDR:MASTER_PORT``, takes rows
[r*B/N, (r+1)*B/N) of each global batch, and the trainer syncs
gradients across ranks.  The data is the reference's synthetic zipf
token stream, a pure function of (seed, step).  SGD and LARS run through
the fused CUDA update.  The reference's ``--mesh`` and checkpoint flags
are not ported.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.sync import SYNC_MODES
from repro_torch.core.topology import Topology
from repro_torch.core.trainer import (TrainerConfig, make_finalize,
                                      make_init_state, make_step)
from repro_torch.data.pipeline import DataConfig, HostLoader
from repro_torch.models.model import build_model
from repro_torch.optim import schedules
from repro_torch.optim.sgd import OptimConfig
from repro_torch.tree import leaves


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family variant (CPU-trainable)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (rows), split over the ranks")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sync-mode", default="lsgd", choices=SYNC_MODES)
    ap.add_argument("--intra-group-size", type=int, default=None)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "lars", "adamw"])
    ap.add_argument("--base-lr", type=float, default=0.1)
    ap.add_argument("--schedule", default="paper",
                    choices=["paper", "wsd", "cosine", "const"])
    ap.add_argument("--warmup-steps", type=int, default=20)
    ap.add_argument("--io-latency", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def model_config(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if args.d_model:
        heads = max(1, cfg.num_heads)
        cfg = cfg.replace(d_model=args.d_model,
                          head_dim=max(args.d_model // heads, 16))
    if args.d_ff:
        cfg = cfg.replace(d_ff=args.d_ff)
    return cfg


def lr_schedule(args):
    """The reference's schedules; the linear scaling rule applied only
    upward (it calibrates growth beyond the base batch of 256)."""
    peak = schedules.linear_scaled_lr(args.base_lr, max(args.batch, 256))
    if args.schedule == "paper":
        return lambda t: schedules.warmup_step_decay(
            t, base_lr=args.base_lr, peak_lr=peak,
            warmup_steps=args.warmup_steps,
            decay_every=max(args.steps // 3, 1))
    if args.schedule == "wsd":
        return lambda t: schedules.wsd(
            t, peak_lr=peak, warmup_steps=args.warmup_steps,
            stable_steps=args.steps // 2, decay_steps=args.steps // 3)
    if args.schedule == "cosine":
        return lambda t: schedules.cosine(
            t, peak_lr=peak, warmup_steps=args.warmup_steps,
            total_steps=args.steps)
    return lambda t: args.base_lr


def trainer_config(args) -> TrainerConfig:
    return TrainerConfig(
        sync_mode=args.sync_mode,
        optim=OptimConfig(kind=args.optimizer),
        topology=Topology(intra_group_size=args.intra_group_size))


def device_of(name: str) -> torch.device:
    """CUDA unless the caller asks for the CPU; no fallback."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the trainer runs on CUDA by default and no CUDA "
                           "device is available; pass --device cpu to "
                           "train on the CPU")
    return torch.device(name)


def init_distributed(device: torch.device):
    """(rank, world); joins the process group when ``WORLD_SIZE`` > 1
    (NCCL on cards, gloo on the CPU)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return (dist.get_rank(), dist.get_world_size()) \
            if dist.is_initialized() else (0, 1)
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    addr = os.environ.get("MASTER_ADDR", "localhost")
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    return rank, world


def main(argv=None) -> Dict[str, Any]:
    """Train; returns a summary (losses, step times, tokens per step, peak
    device memory, the final state)."""
    args = parse_args(argv)
    device = device_of(args.device)
    rank, world = init_distributed(device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} not divisible by {world} "
                         "ranks")
    cfg = model_config(args)
    model = build_model(cfg)
    lr_fn = lr_schedule(args)
    tcfg = trainer_config(args)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = make_init_state(model, tcfg, device)(args.seed)
    if world > 1:                       # every rank starts from rank 0's w0
        for p in leaves(state["params"]):
            dist.broadcast(p, 0)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    log = rank == 0
    if log:
        print(f"arch={cfg.name} params={n_params:,} sync={args.sync_mode} "
              f"ranks={world} device={device} optimizer={args.optimizer}",
              flush=True)

    step_fn = make_step(model, tcfg, lr_fn)
    finalize = make_finalize(model, tcfg, lr_fn)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    per = args.batch // world
    losses: List[float] = []
    step_s: List[float] = []
    loader = HostLoader(dcfg, io_latency_s=args.io_latency)
    t_start = time.perf_counter()
    try:
        for i in range(args.steps):
            t0 = time.perf_counter()
            rows = next(loader)["tokens"][rank * per:(rank + 1) * per]
            tokens = torch.from_numpy(np.ascontiguousarray(rows))
            if device.type == "cuda":
                tokens = tokens.pin_memory().to(device, non_blocking=True)
            state, (loss, _) = step_fn(state, {"tokens": tokens})
            losses.append(float(loss))           # waits for the step
            step_s.append(time.perf_counter() - t0)
            if log and ((i + 1) % args.log_every == 0 or i == 0):
                tput = args.batch * args.seq * (i + 1) / (
                    time.perf_counter() - t_start)
                print(f"step {i + 1:5d} loss {losses[-1]:.4f} "
                      f"lr {lr_fn(i):.4f} tok/s {tput:,.0f} "
                      f"step_s {step_s[-1]:.4f}", flush=True)
    finally:
        loader.close()
    state = finalize(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if log:
        print(f"done in {time.perf_counter() - t_start:.1f}s; final loss "
              f"{losses[-1]:.4f}", flush=True)
    return {"losses": losses, "step_s": step_s,
            "tokens_per_step": args.batch * args.seq, "params": n_params,
            "peak_mem_bytes": peak, "state": state}


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
