"""Run a script as N gloo ranks on the CPU, one subprocess each (the
port's trainer runs one process per rank), for the port's multi-rank
tests: ``run_ranks(code, world, *args)`` starts ``python -c code rank
world port *args`` for every rank and fails with a rank's output unless
every rank exits 0 and prints ``RANK_OK <rank>`` (``start_ranks`` the
same, waiting only when its result is called).  ``RANK_PRELUDE``
joins the process group; a script starts with it and ends with
``rank_ok()``, which meets the other ranks at a barrier before it
prints and leaves the group (a rank that left while another still
talked to it could abort in gloo's teardown)."""
import os
import socket
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"

RANK_PRELUDE = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ARGS = sys.argv[4:]
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                  MASTER_ADDR="localhost", MASTER_PORT=port)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)


def rank_ok():
    dist.barrier()
    print("RANK_OK", rank, flush=True)
    dist.destroy_process_group()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(code: str, world: int, *args, timeout: float = 240):
    """Start the ranks and return ``wait()``: every rank's output, after
    all ranks passed (so a test can work while they run)."""
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world), port, *map(str, args)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def wait() -> list:
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"RANK_OK {r}" in out, out[-4000:]
        return outs

    return wait


def run_ranks(code: str, world: int, *args, timeout: float = 240) -> list:
    """Every rank's output, after all ranks passed."""
    return start_ranks(code, world, *args, timeout=timeout)()
