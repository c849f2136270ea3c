#!/usr/bin/env python3
"""Kernels 3 and 4 (``greedy_sample``, ``gumbel_sample``) at every
cluster size a vocabulary allows.

    python3 chip_gumbel_sizes.py [--kernel greedy|gumbel|both]  # one card

``chip_smoke.py`` checks and times the kernels at ``sampling.greedy_plan``'s
and ``sampling.gumbel_plan``'s cluster sizes only.  This sweep measures
what the plans follow.  Kernel 4: for qwen2-1.5b's, mamba2-370m's and
deepseek-v3's vocabularies, at the row counts of
``chip_smoke.phase_gumbel`` (qwen2's at every row count the engine
samples and at 1 and 64 rows, the others' at 8, 64 and 136), with top-k
0 and 50 at T = 0.8.  Kernel 3: the same three vocabularies at 1, 8, 64,
136 and 264 rows.  Each size in ``sampling.gumbel_clusters`` samples
random logits (and noise), its tokens are checked against the plain
version, and it is timed as ``chip_smoke.Timer`` times a kernel (L2
flushed and the card spun before each of 30 launches; the median),
beside ``torch.argmax`` for kernel 3.  One line per case: the plan's
size, then each size's ms.  The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import sys

import chip_smoke as cs

GREEDY_ROWS = (1, 8, 64, 136, 264)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("greedy", "gumbel", "both"),
                    default="both")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_gumbel_sizes: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import sampling as sp
    from repro_torch.kernels._common import sm_count
    from repro_torch.serve.profile_engine import served_config
    print(f"[card] {cs.nvidia_smi()}", flush=True)
    cfg = get_config("qwen2-1.5b")
    mcfg, dcfg = get_config(cs.MAMBA), served_config(cs.DEEPSEEK)
    vocabs = [c.vocab_size for c in (cfg, mcfg, dcfg)]
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    if args.kernel in ("greedy", "both"):
        for v in vocabs:
            for b in GREEDY_ROWS:
                lg = torch.randn((b, v), generator=g, device="cuda") * 3
                want = sp.greedy_sample_plain(lg)
                ms = {}
                for c in sp.gumbel_clusters(v, 0):
                    def call(c=c):
                        return sp._greedy_launch(lg, c)
                    if not torch.equal(call(), want):
                        cs.fail(f"greedy_sample B={b} V={v} cluster={c}: "
                                "kernel != plain")
                    ms[c] = timer(call)
                lib = timer(lambda: torch.argmax(lg, dim=-1))
                plan = sp.greedy_plan(b, v, sm_count(0))
                print(f"[greedy_sizes] B={b} V={v} plan={plan} argmax_ms="
                      f"{lib:.4f} ms by cluster size: "
                      + ", ".join(f"{c}: {t:.4f}" for c, t in ms.items()),
                      flush=True)
    if args.kernel == "greedy":
        return 0
    qwen_rows = sorted({1, 64} | {rows for rows, _ in
                                  cs.step_shapes(cs.engine_config())})
    cases = [(cfg.vocab_size, b) for b in qwen_rows]
    cases += [(other.vocab_size, b) for other in (mcfg, dcfg)
              for b in (8, 64, 136)]
    for v, b in cases:
        lg = torch.randn((b, v), generator=g, device="cuda") * 3
        noise = torch.randn((b, v), generator=g, device="cuda")
        for top_k in (0, cs.SAMPLE_TOP_K):
            want = sp.gumbel_sample_plain(lg, noise, temperature=cs.SAMPLE_T,
                                          top_k=top_k)
            ms = {}
            for c in sp.gumbel_clusters(v, top_k):
                def call(c=c):
                    return sp._gumbel_launch(lg, noise, cs.SAMPLE_T, top_k, c)
                if not torch.equal(call(), want):
                    cs.fail(f"gumbel_sample B={b} V={v} top_k={top_k} "
                            f"cluster={c}: kernel != plain")
                ms[c] = timer(call)
            plan = sp.gumbel_plan(b, v, sm_count(0), top_k)
            print(f"[gumbel_sizes] B={b} V={v} top_k={top_k} plan={plan} "
                  "ms by cluster size: "
                  + ", ".join(f"{c}: {t:.4f}" for c, t in ms.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
