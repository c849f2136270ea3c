#!/usr/bin/env python3
"""Multi-card check of the port's training over a rank mesh.

    python3 chip_mesh.py            # needs two CUDA cards or more (four
                                    # for the dbrx and --mesh runs)

1. Builds the CUDA kernels, then ``chip_smoke.phase_fsdp_parity``:
   qwen2-1.5b at 2 layers in float32, ``make_pjit_step`` with fsdp
   against the launcher's step (sgd and LARS), on one rank and over two
   NCCL ranks (one process a card), within 1e-5.
2. Four NCCL ranks under ``torchrun`` (this script with ``--rank``):
   ``chip_smoke.phase_train_pjit`` for dbrx-132b at full width cut to 1
   of 40 layers on a data-4 mesh, 8 LSGD steps of 16 x 512 tokens,
   first as ``launch.builders.make_train_step`` builds it (the
   reference's choice for an MoE config: the pjit step, 4 of the 16
   experts a rank, the MoE's all-to-all over the four ranks), then with
   ``zero3`` (every large leaf split over data 4 as well, each layer
   gathered as it runs).  Rank 0 prints the losses, the step time
   (median of the last 6), tok/s, the peak memory (the largest over the
   ranks) and kernel 5's launches; the losses must be finite and the
   launches exactly ``launches_per_call`` an update.
3. The launcher's ``--mesh 2,2,1`` over four NCCL ranks (qwen2-1.5b, 6
   LSGD steps of 16 x 512 tokens).

Every line names the card (``nvidia-smi``: name, power limit).  Exits
non-zero on a failed check or with fewer than two cards.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ROWS_A_RANK = 4


def rank_main() -> None:
    """One rank of step 2 (under torchrun): ``chip_smoke.phase_train_pjit``
    on a data mesh over the ranks, first as ``make_train_step`` builds it,
    then with ZeRO-3 forced."""
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
    cfg = get_config(cs.DBRX).replace(num_layers=cs.DBRX_TRAIN_LAYERS)
    mesh = make_mesh((world, 1), ("data", "model"))
    for zero3 in (False, True):
        _, ts = cs.phase_train_pjit(torch, cfg, mesh, ROWS_A_RANK * world,
                                    zero3)
        del ts
        gc.collect()
        torch.cuda.empty_cache()
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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [[sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "4", str(Path(__file__).resolve()),
             "--rank"],
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
             "--arch", cs.QWEN2, "--steps", "6", "--batch", "16", "--seq",
             "512", "--sync-mode", "lsgd", "--mesh", "2,2,1", "--base-lr",
             "0.01", "--schedule", "const", "--log-every", "1"]]
    for cmd in runs:
        if subprocess.run(cmd, cwd=str(ROOT), env=env,
                          timeout=900).returncode:
            print(f"chip_mesh: FAILED: {' '.join(cmd)}", file=sys.stderr)
            return 1
    print("chip_mesh: ok", flush=True)
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        rank_main()
    else:
        sys.exit(main())
