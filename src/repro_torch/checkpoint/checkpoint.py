"""Checkpoints of a trainer state (``repro/checkpoint/checkpoint.py``),
in the reference's layout on disk, so that either package restores what
the other wrote:

  <dir>/step_%08d/arrays.npz   every leaf keyed by its ``::``-joined tree
                               path; bf16 leaves as float32, host ints
                               (``step``, AdamW's ``opt::t``) as int32
  <dir>/step_%08d/meta.json    {"step": n, "bf16_keys": {path: "bfloat16"}}
  <dir>/LATEST                 "step_%08d" of the newest checkpoint

The arrays file is written to a temporary name and renamed into place.
``save`` first waits for the phase-2 collective in flight: the pending
buffer it reduces is half-reduced until then.  ``inflight`` itself is
never written.  Under several ranks every rank waits, rank 0 writes and
all meet at a barrier.  ``lsgd_compressed``'s error-feedback residual is
rank-local in the port (one per group, ``core/sync.py``); rank 0's is
written and every rank restores it (ROADMAP.md §3).

A state sharded by a plan (``core.trainer.FsdpPlan``, passed as
``plan``: over data, over model, or a leaf over both) is saved in the
same full-leaf layout: every rank joins the gathers, one leaf at a time
(over data, then over model), and rank 0 writes; a restore reads the
full leaves on the host and keeps this rank's parts.  So a sharded run
restores an unsharded checkpoint, either package's, and the reverse.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.interop import SEP, state_from_flat
from repro_torch.tree import items, tree_map


def _flatten(state) -> Dict[str, Any]:
    """``{path: tensor or int}`` of every leaf but ``inflight``."""
    return {SEP.join(path): v for path, v in items(state)
            if path != ("inflight",)}


def save(ckpt_dir: str, state: Dict[str, Any], step: int,
         plan=None) -> str:
    """Write ``state`` under ckpt_dir/step_<n>/ and point LATEST at it;
    returns that directory.  Waits for ``state["inflight"]`` first.  A
    state sharded by ``plan`` is gathered a leaf at a time
    (``FsdpPlan.whole_items``): rank 0 copies each whole leaf to the
    host and every rank frees it before the next is gathered."""
    if state.get("inflight") is not None:
        state["inflight"].wait()
        state["inflight"] = None
    out_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    writer = not dist.is_initialized() or dist.get_rank() == 0
    arrays, bf16 = {}, {}
    for path, v in (items(state) if plan is None
                    else plan.whole_items(state)):
        if writer and path != ("inflight",):
            k = SEP.join(path)
            if isinstance(v, torch.Tensor):
                t = v.detach().to("cpu", copy=True)
                if t.dtype == torch.bfloat16:
                    bf16[k] = "bfloat16"
                    t = t.float()
                arrays[k] = t.numpy()
            else:
                arrays[k] = np.asarray(v, np.int32)
        del v                  # before the next leaf is gathered
    if writer:
        os.makedirs(out_dir, exist_ok=True)
        tmp = tempfile.NamedTemporaryFile(dir=out_dir, suffix=".npz",
                                          delete=False)
        np.savez(tmp, **arrays)
        tmp.close()
        os.replace(tmp.name, os.path.join(out_dir, "arrays.npz"))
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump({"step": step, "bf16_keys": bf16}, f)
        with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
            f.write(f"step_{step:08d}")
    if dist.is_initialized():
        dist.barrier()
    return out_dir


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        m = re.match(r"step_(\d+)", f.read().strip())
    return int(m.group(1)) if m else None


def restore(ckpt_dir: str, like: Dict[str, Any],
            step: Optional[int] = None, plan=None) -> Dict[str, Any]:
    """A new state shaped like the trainer state ``like``: each tensor on
    the device and in the dtype of ``like``'s leaf, the step counters as
    host ints, no phase-2 collective in flight.  With ``plan`` (``like``
    sharded by it) each full leaf is cut to this rank's part."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        flat = {}
        for k in _flatten(like):
            if k not in data:
                raise KeyError(f"checkpoint missing leaf {k}")
            flat[k] = data[k]
    out = state_from_flat(flat)
    if plan is not None:
        out = plan.shard_state(out)
    return tree_map(
        lambda l, r: r.to(device=l.device, dtype=l.dtype)
        if isinstance(l, torch.Tensor) else r, like, out)
