#!/usr/bin/env python3
"""Multi-card check of the port's training over a rank mesh.

    python3 chip_mesh.py            # needs two CUDA cards or more (four
                                    # for the tensor-parallel and dbrx
                                    # runs)

1. Builds the CUDA kernels, then ``chip_smoke.phase_fsdp_parity``:
   qwen2-1.5b at 2 layers in float32, ``make_pjit_step`` with fsdp
   against the launcher's step (sgd and LARS), on one rank and over two
   NCCL ranks (one process a card), within 1e-5.
2. Tensor-parallel parity over NCCL: ``chip_smoke.tp_parity_cases``
   (qwen2-1.5b and mamba2-370m at full width cut to 2 layers, float32,
   TF32 off, sgd and LARS, 3 LSGD steps + finalize) through the
   launcher at ``--mesh 1,2,2`` over four NCCL ranks (data 2 x model 2)
   equal the one-rank launcher within 1e-5, params and losses.
3. Four NCCL ranks under ``torchrun`` (this script with ``--rank``): the
   launcher on qwen2-1.5b uncut, MESH_STEPS LSGD steps of MESH_BATCH x
   512 tokens, at ``--mesh 1,2,2``, ``--mesh 1,1,4`` (each of the 2 kv
   heads held by the two ranks that read it) and ``--mesh 2,2,1`` (the
   pods' phase across two groups of two); then
   ``chip_smoke.phase_train_pjit`` for dbrx-132b at full width cut to
   DBRX_MESH_LAYERS of its 40 layers (14.27B parameters) on data 2 x
   model 2 as ``launch.builders.make_train_step`` builds it: the pjit
   step with ZeRO-3 (past 8B parameters), 8 of the 16 experts a data
   rank and half of each expert's hidden width a model rank, 8 LSGD
   steps of 4 x 512 tokens.  Rank 0 prints each run's losses, the step
   time (median of the last 6), tok/s, the largest rank's peak memory
   and kernel 5's launches; the losses must be finite and the launches
   exactly ``launches_per_call`` an update on every rank.

Every line names the card (``nvidia-smi``: name, power limit).  Exits
non-zero on a failed check or with fewer than two cards.
"""
from __future__ import annotations

import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MESH_STEPS, MESH_BATCH = 8, 16
MESH_LAUNCHER = ("1,2,2", "1,1,4", "2,2,1")
DBRX_MESH_LAYERS = 4


def launcher_run(torch, mesh: str) -> None:
    """qwen2-1.5b uncut through the launcher at ``--mesh mesh`` on this
    rank (every rank calls it), its launch counts set to 0 just before
    and read just after; rank 0 prints the run's numbers."""
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.launch import train
    argv = ["--arch", cs.QWEN2, "--steps", str(MESH_STEPS), "--batch",
            str(MESH_BATCH), "--seq", "512", "--sync-mode", "lsgd",
            "--mesh", mesh, "--base-lr", "0.01", "--schedule", "const",
            "--log-every", "100"]
    kernels.reset_launch_counts()
    out = train.main(argv)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["fused_sgd_update"]
    losses, step_s = out["losses"], out["step_s"]
    if not all(math.isfinite(x) for x in losses):
        cs.fail(f"--mesh {mesh}: loss not finite: {losses}")
    per = cs._update_launches(out["state"])
    if launches != per * len(losses):
        cs.fail(f"--mesh {mesh} rank {dist.get_rank()}: {launches} "
                f"fused_sgd_update launches, want {per} x {len(losses)}")
    peak = torch.tensor([out["peak_mem_bytes"] / 1e9], device="cuda")
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    med = statistics.median(step_s[-6:])
    if dist.get_rank() == 0:
        print(f"[mesh train] {cs.QWEN2} full width, {out['params'] / 1e9:.3f}B"
              f" params bf16, --mesh {mesh} over {dist.get_world_size()} "
              f"NCCL ranks, batch {MESH_BATCH} x 512, lsgd, fused sgd, lr "
              f"0.01: losses {[round(x, 4) for x in losses]}; step ms "
              f"(median of the last 6) {med * 1e3:.1f}; train tok/s "
              f"{out['tokens_per_step'] / med:.0f}; peak memory (largest "
              f"rank) {peak.item():.2f} GB; kernel 5 launches {launches} "
              f"({per} an update); step ms all "
              f"{[round(x * 1e3, 1) for x in step_s]}; card: "
              f"{cs.nvidia_smi()}", flush=True)
    del out


def rank_main() -> None:
    """One rank of step 3 (under torchrun)."""
    import gc

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        "nccl", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
        f"{os.environ['MASTER_PORT']}", rank=rank, world_size=world)
    for mesh in MESH_LAUNCHER:
        launcher_run(torch, mesh)
        gc.collect()
        torch.cuda.empty_cache()
    cfg = get_config(cs.DBRX).replace(num_layers=DBRX_MESH_LAYERS)
    _, ts = cs.phase_train_pjit(torch, cfg,
                                make_mesh((2, 2), ("data", "model")))
    del ts
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    import torch

    import chip_smoke as cs
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"chip_mesh: needs two CUDA cards or more, found {cards}",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f}s; card: {cs.nvidia_smi()}",
          flush=True)
    cs.phase_fsdp_parity(torch)
    if cards < 4:
        print("chip_mesh: the four-rank runs need four cards", flush=True)
        return 0
    out_dir = ROOT / "build" / "tp_mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    with cs.float32_exact():
        ranks = cs.run_tp_ranks(4, "nccl", "1,2,2", out_dir, False)
        diff, loss_diff, moved = cs.tp_parity(torch, out_dir, 2, ranks)
    print(f"[tp train] --mesh 1,2,2 over four NCCL ranks (data 2 x model "
          f"2), {cs.QWEN2} and {cs.MAMBA} at {cs.TP_PARITY_LAYERS} layers "
          f"f32, sgd and lars, vs one rank: max |param diff| {diff:.3g}, "
          f"max |loss diff| {loss_diff:.3g} (bound {cs.TP_BOUND}); params "
          f"moved {moved:.3g}; card: {cs.nvidia_smi()}", flush=True)
    if not (diff < cs.TP_BOUND and loss_diff < cs.TP_BOUND and moved > 0):
        print(f"chip_mesh: FAILED: NCCL tensor-parallel parity {diff} "
              f"(losses {loss_diff})", file=sys.stderr)
        return 1
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "4", str(Path(__file__).resolve()), "--rank"]
    if subprocess.run(cmd, cwd=str(ROOT), env=env, timeout=1500).returncode:
        print(f"chip_mesh: FAILED: {' '.join(cmd)}", file=sys.stderr)
        return 1
    print("chip_mesh: ok", flush=True)
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        rank_main()
    else:
        sys.exit(main())
