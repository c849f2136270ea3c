"""Learning-rate schedules (``repro/optim/schedules.py``), as plain
Python: the port's trainer knows its step on the host, so a schedule is
a float per step and reaches the update kernel without a device value.

* ``linear_scaled_lr`` — the paper's linear scaling rule (§5.3.1):
  lr = base_lr * global_batch / base_batch.
* ``warmup_step_decay`` — the paper's schedule: per-step warmup from
  base_lr to peak over ``warmup_steps``, then x``decay_factor`` every
  ``decay_every`` steps.
* ``wsd`` — MiniCPM's Warmup-Stable-Decay schedule.
* ``cosine`` — cosine with warmup.
"""
from __future__ import annotations

import math


def linear_scaled_lr(base_lr: float, global_batch: int,
                     base_batch: int = 256) -> float:
    return base_lr * global_batch / base_batch


def warmup_step_decay(step, *, base_lr: float, peak_lr: float,
                      warmup_steps: int, decay_every: int,
                      decay_factor: float = 0.1) -> float:
    step = float(step)
    warm = base_lr + (peak_lr - base_lr) * min(step / max(warmup_steps, 1),
                                               1.0)
    n_decays = math.floor(max(step - warmup_steps, 0.0)
                          / max(decay_every, 1))
    return warm * decay_factor ** n_decays


def wsd(step, *, peak_lr: float, warmup_steps: int, stable_steps: int,
        decay_steps: int, final_frac: float = 0.1) -> float:
    step = float(step)
    if step > warmup_steps + stable_steps:
        t = min(max((step - warmup_steps - stable_steps)
                    / max(decay_steps, 1), 0.0), 1.0)
        return peak_lr * final_frac ** t
    return peak_lr * min(step / max(warmup_steps, 1), 1.0)


def cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
           final_frac: float = 0.1) -> float:
    step = float(step)
    if step < warmup_steps:
        return peak_lr * min(step / max(warmup_steps, 1), 1.0)
    t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                0.0), 1.0)
    return peak_lr * (final_frac
                      + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))
