#!/usr/bin/env python3
"""Kernel 4 (``gumbel_sample``) at every cluster size a vocabulary allows.

    python3 chip_gumbel_sizes.py          # one CUDA card

``chip_smoke.py`` checks and times kernel 4 at ``sampling.gumbel_plan``'s
cluster size only.  This sweep measures what the plan follows: for
qwen2-1.5b's, mamba2-370m's and deepseek-v3's vocabularies, at the row
counts of ``chip_smoke.phase_gumbel`` (qwen2's at every row count the
engine samples and at 1 and 64 rows, the others' at 8, 64 and 136), with
top-k 0 and 50 at T = 0.8, each size in ``sampling.gumbel_clusters``
samples random logits and noise, its tokens are checked against
``gumbel_sample_plain``, and it is timed as ``chip_smoke.Timer`` times a
kernel (L2 flushed and the card spun before each of 30 launches; the
median).  One line per case: the plan's size, then each size's ms.
The card's name and power limit come first.
"""
from __future__ import annotations

import sys

import chip_smoke as cs


def main() -> int:
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
    qwen_rows = sorted({1, 64} | {rows for rows, _ in
                                  cs.step_shapes(cs.engine_config())})
    cases = [(cfg.vocab_size, b) for b in qwen_rows]
    cases += [(other.vocab_size, b) for other in (mcfg, dcfg)
              for b in (8, 64, 136)]
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
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
