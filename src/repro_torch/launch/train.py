"""End-to-end training driver of the port (``repro/launch/train.py``).

    # one card (the default device is CUDA; it raises without one)
    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 8 \\
        --batch 4 --seq 512 --sync-mode lsgd

    # the smoke model on the CPU
    python -m repro_torch.launch.train --smoke --device cpu --steps 20

    # four ranks, two groups of two (NCCL on cards, gloo on the CPU)
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
        --device cpu --sync-mode lsgd --intra-group-size 2

    # ResNet-50, the paper's model: 224 x 224 images, batch 64, f32
    python -m repro_torch.launch.train --arch resnet50 --steps 8 \\
        --batch 64 --ckpt-dir ckpt --ckpt-every 4

    # four ranks on a (pod 2, data 2) mesh: LSGD's slow phase across
    # the pods, its fast phase within each (as --intra-group-size 2)
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
        --device cpu --sync-mode lsgd --mesh 2,2,1

    # four ranks as data 2 x model 2: each rank holds half of every
    # split module (tensor parallelism), each pair of model ranks one
    # data-parallel replica
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
        --device cpu --sync-mode lsgd --mesh 1,2,2

    # the RG-LRU hybrid, and whisper-tiny (each row 1,500 stub frames
    # and --seq decoder tokens)
    python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --steps 8 --batch 4 --seq 512 --base-lr 0.01
    python -m repro_torch.launch.train --arch whisper-tiny --steps 8 \\
        --batch 8 --seq 448 --base-lr 0.01

One process per rank: under ``torchrun`` (``WORLD_SIZE`` > 1) each rank
joins the process group at ``MASTER_ADDR:MASTER_PORT``, takes rows
[r*B/N, (r+1)*B/N) of each global batch, and the trainer syncs
gradients across ranks.  The data is the reference's synthetic stream
(``data_config_for``: zipf tokens, frame embeddings and tokens for
whisper, or images and labels for ResNet), a pure function of (seed,
step).  SGD and LARS run through the fused CUDA
update.  With ``--ckpt-dir`` the run restores the newest checkpoint
there when one exists, saves every ``--ckpt-every`` steps and after
``finalize``, as the reference does (its data stream, too, starts again
at batch 0 after a restore).

``--mesh`` lays the ranks out as the reference's does, on the last
dims of (pod, data, model): ``--mesh 4,1`` is data 4, ``--mesh 2,2,1``
pod 2 and data 2 (``launch.mesh``); the dims' product must be the number
of ranks.  As in the reference, the launcher keeps its shard_map path
(``make_step``) and sets no active mesh: ``pod`` is LSGD's slow axis and
``data`` its fast one, so with two pods or more each pod's ranks are
one fast group (``--intra-group-size`` still subdivides them).  A model
axis over 1 trains tensor-parallel (``core.trainer``): each rank holds
its model shard (``FsdpPlan(..., shard_data=False)``), the (pod, data)
ranks of one model coordinate sync as the ranks of a mesh without a
model axis do, and they share each batch's rows by their (pod, data)
position.  The dense GQA, GQA + MoE and mamba2 families train so; the
others raise ``NotImplementedError``.  The reference's FSDP / pjit
step is ``launch.builders.make_train_step``.
"""
from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.sync import SYNC_MODES, GradSync
from repro_torch.core.topology import Topology
from repro_torch.core.trainer import (FsdpPlan, TrainerConfig, make_finalize,
                                      make_init_state, make_step)
from repro_torch.data.pipeline import HostLoader, data_config_for
from repro_torch.launch.mesh import mesh_from_dims
from repro_torch.models.model import build_model
from repro_torch.optim import schedules
from repro_torch.optim.sgd import OptimConfig
from repro_torch.sharding import check_tp_training
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
    ap.add_argument("--mesh", default="",
                    help="comma dims for the (pod,data,model) rank mesh; "
                         "default one data axis over every rank")
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "lars", "adamw"])
    ap.add_argument("--base-lr", type=float, default=0.1)
    ap.add_argument("--schedule", default="paper",
                    choices=["paper", "wsd", "cosine", "const"])
    ap.add_argument("--warmup-steps", type=int, default=20)
    ap.add_argument("--io-latency", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
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


def mesh_of(args, cfg):
    """The ``--mesh`` over the process group's ranks, or None without
    one.  A model axis over 1 for a family the port does not train
    along it raises ``NotImplementedError`` (checked first); dims whose
    product is not the number of ranks raise ``ValueError``."""
    if not args.mesh:
        return None
    dims = tuple(int(x) for x in args.mesh.split(","))
    check_tp_training(cfg, dims[-1])   # the last dim is always "model"
    return mesh_from_dims(dims)


def trainer_config(args, mesh=None) -> TrainerConfig:
    """The trainer of ``args``; on a ``mesh`` with pods, each pod's data
    ranks form LSGD's fast groups unless ``--intra-group-size`` cuts them
    finer."""
    intra = args.intra_group_size
    if mesh is not None and intra is None and mesh.size("pod") > 1:
        intra = mesh.size("data")
    return TrainerConfig(
        sync_mode=args.sync_mode,
        optim=OptimConfig(kind=args.optimizer),
        topology=Topology(intra_group_size=intra))


def data_config(cfg, args):
    """The reference's synthetic data for ``cfg``'s family, one global
    batch of ``--batch`` rows a step."""
    return data_config_for(
        cfg, SimpleNamespace(seq_len=args.seq, global_batch=args.batch),
        seed=args.seed)


def to_device(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """One rank's rows of a host batch leaf, on ``device`` (pinned and
    non-blocking on a card)."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


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
    """Train; returns a summary (losses, step times, samples and tokens
    per step, peak device memory, the final state: this rank's shard on
    a model axis, with its layout as ``plan``)."""
    args = parse_args(argv)
    device = device_of(args.device)
    rank, world = init_distributed(device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = model_config(args)
    mesh = mesh_of(args, cfg)
    # the data-parallel ranks: every rank, or a mesh's (pod, data) ranks
    n_dp, i_dp = ((world, rank) if mesh is None else
                  (mesh.size(("pod", "data")), mesh.index(("pod", "data"))))
    if args.batch % n_dp:
        raise ValueError(f"--batch {args.batch} not divisible by {n_dp} "
                         "data-parallel ranks")
    model = build_model(cfg)
    lr_fn = lr_schedule(args)
    tcfg = trainer_config(args, mesh)
    plan = (FsdpPlan(model, tcfg, mesh, shard_data=False)
            if mesh is not None and mesh.size("model") > 1 else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = make_init_state(model, tcfg, device, plan)(args.seed)
    if n_dp > 1:         # every replica starts from its first one's w0
        line = (list(range(world)) if mesh is None else
                next(x for x in mesh.lines(("pod", "data")) if rank in x))
        group = None if mesh is None else mesh.group(("pod", "data"))
        for p in leaves(state["params"]):
            dist.broadcast(p, line[0], group=group)
    n_params = sum(p.numel() for p in leaves(model.init(0, "meta")))
    log = rank == 0
    if log:
        print(f"arch={cfg.name} params={n_params:,} sync={args.sync_mode} "
              f"ranks={world} mesh={mesh} device={device} "
              f"optimizer={args.optimizer}", flush=True)
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        state = checkpoint.restore(args.ckpt_dir, state, plan=plan)
        if log:
            print(f"restored checkpoint at step {state['step']}", flush=True)

    step_fn = make_step(model, tcfg, lr_fn,
                        None if mesh is None else
                        GradSync(tcfg.sync_mode, tcfg.topology, mesh), plan)
    finalize = make_finalize(model, tcfg, lr_fn, plan)
    dcfg = data_config(cfg, args)
    images = dcfg.kind == "image"
    per = args.batch // n_dp
    losses: List[float] = []
    step_s: List[float] = []
    loader = HostLoader(dcfg, io_latency_s=args.io_latency)
    t_start = time.perf_counter()
    try:
        for i in range(args.steps):
            t0 = time.perf_counter()
            batch = {k: to_device(v[i_dp * per:(i_dp + 1) * per], device)
                     for k, v in next(loader).items()}
            state, (loss, _) = step_fn(state, batch)
            losses.append(float(loss))           # waits for the step
            step_s.append(time.perf_counter() - t0)
            if log and ((i + 1) % args.log_every == 0 or i == 0):
                rate = args.batch * (1 if images else args.seq) * (i + 1) / (
                    time.perf_counter() - t_start)
                print(f"step {i + 1:5d} loss {losses[-1]:.4f} "
                      f"lr {lr_fn(i):.4f} {'img' if images else 'tok'}/s "
                      f"{rate:,.0f} step_s {step_s[-1]:.4f}", flush=True)
            if args.ckpt_dir and args.ckpt_every \
                    and (i + 1) % args.ckpt_every == 0:
                checkpoint.save(args.ckpt_dir, state, state["step"],
                                plan=plan)
    finally:
        loader.close()
    state = finalize(state)
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, state, state["step"], plan=plan)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if log:
        print(f"done in {time.perf_counter() - t_start:.1f}s; final loss "
              f"{losses[-1]:.4f}", flush=True)
    return {"losses": losses, "step_s": step_s, "samples_per_step": args.batch,
            "tokens_per_step": None if images else args.batch * args.seq,
            "params": n_params, "peak_mem_bytes": peak, "state": state,
            "plan": plan}

if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
