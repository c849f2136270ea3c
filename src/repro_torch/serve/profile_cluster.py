"""Why two replicas sharing one card serve slower than one engine: serves
``profile_engine``'s workload through full-width qwen2-1.5b (random bf16
weights from a seed) at steps_per_dispatch 8, under ``torch.profiler``
(device activity only), in five arrangements:

- ``one``: one engine, all 16 requests;
- ``two serial``: two engines on the card, each given every other
  request, run one after the other on one thread (the host work of two
  replicas, with no second thread);
- ``two threads``: the same two engines, each driven by ``Engine.run`` on
  a thread of its own under its own stream (two threads, no dispatcher);
- ``cluster``: ``ServeCluster.for_replicas(num_replicas=2)`` on the card
  (the dispatcher's workers, monitor and router);
- the two threaded arrangements again under other interpreter switch
  intervals (``sys.setswitchinterval``; 5 ms is the default).

It prints one JSON line per run: the wall time, tok/s, the process's CPU
seconds (all its threads), and the summed kernel time over wall (the
device's busy share; kernels of two streams may overlap, so the share
of a two-stream run is an upper bound).  Each arrangement runs twice, in
a forward and then a reverse order.

    python -m repro_torch.serve.profile_cluster [--seed N]

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import torch

from repro_torch.models.model import build_model
from repro_torch.serve import Engine, EngineConfig, Request, ServeCluster
from repro_torch.serve.profile_engine import (ENGINE_CONFIG, _device_us,
                                              served_config, workload)

DEPTH = 8
SWITCH_S = (0.005, 0.0001, 0.05)


def _requests(work, rids):
    return [Request(prompt=work[i][0].copy(), max_new_tokens=work[i][1],
                    rid=i) for i in rids]


def _run_threads(engines, halves):
    out = [None] * len(engines)

    def drive(k):
        with engines[k].on_stream():
            out[k] = engines[k].run(halves[k])

    threads = [threading.Thread(target=drive, args=(k,))
               for k in range(len(engines))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {rid: r for res in out for rid, r in res.items()}


def measure(label, make, switch_s) -> dict:
    """One run of ``make()()`` (``make`` builds and warms what the run
    needs, outside the timed window, and returns the call that serves and
    returns {rid: result}) under the profiler, at interpreter switch
    interval ``switch_s``."""
    serve = make()
    old = sys.getswitchinterval()
    sys.setswitchinterval(switch_s)
    try:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            c0, t0 = time.process_time(), time.perf_counter()
            res = serve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cpu = time.process_time() - c0
    finally:
        sys.setswitchinterval(old)
    busy = sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    ntok = sum(len(r.tokens) for r in res.values())
    return {"run": label, "switch_ms": switch_s * 1e3, "requests": len(res),
            "tokens": ntok, "wall_s": wall, "tok_s": ntok / wall,
            "process_cpu_s": cpu, "kernel_s": busy,
            "device_busy_share": busy / wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_cluster: needs a CUDA card")
    cfg = served_config("qwen2-1.5b")
    model = build_model(cfg)
    params = model.init(args.seed, "cuda")
    work = workload(cfg.vocab_size, args.seed)
    ecfg = EngineConfig(steps_per_dispatch=DEPTH, **ENGINE_CONFIG)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[card] {card or torch.cuda.get_device_name(0)}", flush=True)
    one = Engine(model, params, ecfg, device="cuda")
    pair = [Engine(model, params, ecfg, device="cuda", replica_id=k)
            for k in range(2)]
    for eng in [one] + pair:
        eng.warmup()
    everyone = range(len(work))
    halves = [list(everyone)[k::2] for k in range(2)]

    def serve_one():
        with one.on_stream():
            return one.run(_requests(work, everyone))

    def serve_serial():
        out = {}
        for k in range(2):
            with pair[k].on_stream():
                out.update(pair[k].run(_requests(work, halves[k])))
        return out

    def serve_threads():
        return _run_threads(pair, [_requests(work, h) for h in halves])

    def make_cluster():
        cluster = ServeCluster.for_replicas(
            model, params, ecfg, num_replicas=2,
            devices=[torch.device("cuda", 0)])
        cluster.warmup()
        return lambda: cluster.run(_requests(work, everyone))

    runs = [("one", lambda: serve_one, SWITCH_S[0]),
            ("two serial", lambda: serve_serial, SWITCH_S[0])]
    for s in SWITCH_S:
        runs += [("two threads", lambda: serve_threads, s),
                 ("cluster", make_cluster, s)]
    for order in (runs, runs[::-1]):
        for label, make, s in order:
            row = measure(label, make, s)
            if row["requests"] != len(work):
                raise SystemExit(f"profile_cluster: {label} ended "
                                 f"{row['requests']} of {len(work)}")
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
