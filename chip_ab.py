#!/usr/bin/env python3
"""Parent against change on one card, in alternating turns.

    python3 chip_ab.py PARENT_DIR [--turns 4] [--phase NAME ...]
        [--serve ARCH:DEPTH ...] [--profile ARCH:DEPTH]   # one CUDA card

PARENT_DIR is a checkout of the parent commit (for example ``git archive``
of it unpacked into the git-ignored ``build/parent``); the change is the
checkout that holds this script.  Each tree runs in a worker process of
its own, importing its own sources and building its own kernels under
its own ``build/``, both on the one card.  The coordinator hands them
turns in pairs (parent, change, change, parent, parent, ...), one side
running while the other waits.  In each turn a side runs:

- ``--phase NAME``: its own ``chip_smoke.phase_NAME``, called with the
  arguments its parameters name (``torch``, ``timer``, ``cfg`` for
  qwen2-1.5b, ``mcfg`` for mamba2-370m, ``dcfg`` for the served
  deepseek-v3 cut, ``rcfg`` for recurrentgemma-2b, ``ec`` the serving
  engine's config, ``work`` the
  serving workload; a parameter with a default keeps it); every ``ms``
  and ``step_ms`` the phase returns is kept, under the path of keys and
  labels that leads to it;
- ``--serve ARCH:DEPTH``: ARCH at full width (bf16, random weights from
  seed 0) serving the workload of ``serve.profile_engine`` greedily at
  that steps_per_dispatch, through the port's ``Engine``: tok/s and TTFT
  p50.

Once per side, after the turns, ``--profile ARCH:DEPTH`` profiles one
served run (``serve.profile_engine.profile``): kernels per model call
and the card's busy share.  The workers' own output goes to standard
error; standard output carries one JSON line per turn and side, then the
range of each number per side, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0


# ---------------------------------------------------------------------------
# worker: one tree, commands on standard input, answers on a private pipe
# ---------------------------------------------------------------------------


def timings(result, path=()):
    """(label, ms) of every dict with an ``ms`` number in a phase's
    result, the label the keys (and ``label`` fields) on the way to it."""
    if isinstance(result, dict):
        if isinstance(result.get("ms"), float):
            yield " ".join(path), result["ms"]
        if isinstance(result.get("step_ms"), float):   # a training phase
            yield " ".join(path + ("step_ms",)), result["step_ms"]
        for key, value in result.items():
            if isinstance(value, (dict, list, tuple)):
                parts = key if isinstance(key, tuple) else (key,)
                yield from timings(value, path + tuple(map(str, parts)))
    elif isinstance(result, (list, tuple)):
        for i, value in enumerate(result):
            label = value.get("label", i) if isinstance(value, dict) else i
            yield from timings(value, path + (str(label),))


def worker(tree: Path) -> int:
    import os
    answer = os.fdopen(os.dup(1), "w")
    sys.stdout = sys.stderr          # the phases' prints
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import build_model
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.serve.profile_engine import (ENGINE_CONFIG, profile,
                                                  served_config, workload)

    t0 = time.perf_counter()
    so = _build.build()
    print(f"[ab {tree}] {so.name} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    qwen = get_config("qwen2-1.5b")
    context = dict(torch=torch, timer=cs.Timer(torch),
                   ec=EngineConfig(**ENGINE_CONFIG),
                   work=workload(qwen.vocab_size, SEED))
    # the configs a phase may name, resolved only when one does (a tree
    # need not have every arch)
    archs = dict(cfg="qwen2-1.5b", mcfg="mamba2-370m",
                 dcfg="deepseek-v3-671b", rcfg="recurrentgemma-2b")
    models = {}

    def served(arch):
        if arch not in models:
            model = build_model(served_config(arch))
            models[arch] = (model, model.init(SEED, "cuda"),
                            workload(model.cfg.vocab_size, SEED))
        return models[arch]

    def serve(arch, depth):
        model, params, work = served(arch)
        eng = Engine(model, params, EngineConfig(steps_per_dispatch=depth,
                                                 **ENGINE_CONFIG),
                     device="cuda")
        eng.warmup()
        t = time.perf_counter()
        res = eng.run([Request(prompt=p.copy(), max_new_tokens=n, rid=i)
                       for i, (p, n) in enumerate(work)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if sorted(len(r.tokens) for r in res.values()) != sorted(
                n for _, n in work):
            raise SystemExit(f"chip_ab: {arch} depth {depth} did not "
                             "finish every request")
        ntok = sum(len(r.tokens) for r in res.values())
        ttft = sorted(r.first_token_time - t for r in res.values())
        return ntok / wall, ttft[len(ttft) // 2]

    def run(cmd):
        if cmd[0] == "phase":
            fn = getattr(cs, "phase_" + cmd[1])
            args = {name: (served_config(archs[name]) if name in archs
                           else context[name])
                    for name, p in inspect.signature(fn).parameters.items()
                    if p.default is inspect.Parameter.empty}
            return {f"{cmd[1]} {label}": ms
                    for label, ms in timings(fn(**args))}
        arch, depth = cmd[1], int(cmd[2])
        if cmd[0] == "serve":
            rate, ttft = serve(arch, depth)
            print(f"[ab {tree}] {arch} depth={depth} tok_s={rate:.1f} "
                  f"ttft_p50_s={ttft:.4f}", flush=True)
            return {f"{arch} depth {depth} tok_s": rate,
                    f"{arch} depth {depth} ttft_p50_s": ttft}
        if cmd[0] == "profile":
            r = profile(depth, *served(arch))
            print(f"[ab {tree}] profile {json.dumps(r)}", flush=True)
            return {f"{arch} depth {depth} kernels_per_model_call":
                    r["kernels_per_model_call"],
                    f"{arch} depth {depth} device_busy_share":
                    r["device_busy_share"]}
        raise ValueError(f"unknown command {cmd}")

    while True:
        cmd = sys.stdin.readline().split()
        if not cmd or cmd == ["quit"]:
            break
        out = run(cmd)
        torch.cuda.empty_cache()
        answer.write(json.dumps(out) + "\n")
        answer.flush()
    return 0


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------


class Side:
    def __init__(self, name: str, tree: Path):
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(tree)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        self.readings: dict = {}

    def ask(self, cmd: str) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise SystemExit(f"chip_ab: the {self.name} worker died on "
                             f"{cmd!r} (exit {self.proc.wait()})")
        out = json.loads(line)
        for key, value in out.items():
            self.readings.setdefault(key, []).append(value)
        return out

    def close(self):
        if self.proc.poll() is None:
            self.proc.stdin.write("quit\n")
            self.proc.stdin.flush()
            self.proc.wait(timeout=120)
        if self.proc.poll() is None:
            self.proc.kill()


def arch_depth(text: str) -> str:
    arch, depth = text.rsplit(":", 1)
    return f"{arch} {int(depth)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, nargs="?",
                    help="checkout of the parent commit")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--phase", action="append", default=[],
                    help="a chip_smoke phase (phase_NAME), every turn")
    ap.add_argument("--serve", action="append", default=[],
                    type=arch_depth, help="ARCH:DEPTH served every turn")
    ap.add_argument("--profile", type=arch_depth,
                    help="ARCH:DEPTH profiled once a side, at the end")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(args.worker.resolve())
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.parent is None or not (args.parent / "chip_smoke.py").exists():
        ap.error("PARENT_DIR must be a checkout holding chip_smoke.py")
    cmds = ([f"phase {p}" for p in args.phase]
            + [f"serve {s}" for s in args.serve])
    if not cmds:
        ap.error("nothing to run: give --phase or --serve")
    sides = {"parent": Side("parent", args.parent.resolve()),
             "change": Side("change", ROOT)}
    try:
        for turn in range(args.turns):
            order = ("parent", "change") if turn % 2 == 0 else \
                ("change", "parent")
            for name in order:
                out = {}
                for cmd in cmds:
                    out.update(sides[name].ask(cmd))
                print(json.dumps({"turn": turn, "side": name, **out}),
                      flush=True)
        if args.profile:
            for name, side in sides.items():
                print(json.dumps({"side": name, **side.ask(
                    f"profile {args.profile}")}), flush=True)
    finally:
        for side in sides.values():
            side.close()
    for key in sides["change"].readings:
        print(f"[ab] {key}: " + "; ".join(
            f"{name} {min(s.readings.get(key, [0])):.4f}-"
            f"{max(s.readings.get(key, [0])):.4f} "
            f"{[round(x, 4) for x in s.readings.get(key, [])]}"
            for name, s in sides.items()), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
