"""Gradient synchronization on ``torch.distributed``
(``repro/core/sync.py``), one process per data-parallel rank.

Every mode computes the data-parallel mean of the gradient tree and
differs only in the collectives it schedules:

  flat              one all-reduce over every rank (Alg. 2, CSGD)
  layered           Alg. 3: all-reduce within each fast group (phase 1),
                    then across the groups (phase 2, the communicator
                    layer).  The trainer defers consuming phase 2 to the
                    next step, which is what lets it overlap the step.
  layered_rsag      phase 2 as reduce-scatter + all-gather
  layered_compressed phase 2 carries a bf16 payload, with an f32
                    error-feedback residual kept per rank; it is summed
                    in f32 after an all-gather, as the reference sums the
                    f32 re-expansion of the bf16 payload.

Phase 1 and phase 2 groups come from ``Topology.phase1_groups`` /
``phase2_groups`` over the world's ranks.  With one rank, or one group
(``intra_group_size`` None), phase 2 is absent; with one rank every mode
is the identity.  Collectives work in place on the tensors they are
given.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core.topology import Topology
from repro_torch.tree import leaves

SYNC_MODES = ("csgd", "lsgd", "lsgd_eager", "lsgd_rsag", "lsgd_compressed")


class Inflight:
    """A phase-2 collective issued with ``async_op=True``: ``wait()``
    makes the caller's stream wait for it and finishes the mean."""

    def __init__(self, works: List, finish: Callable[[], None]):
        self.works = works
        self.finish = finish

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        self.finish()


class GradSync:
    """The sync of one trainer, bound to the default process group's
    ranks.  Every rank must construct it (``dist.new_group`` is a
    collective call)."""

    def __init__(self, mode: str, topology: Topology = Topology()):
        if mode not in SYNC_MODES:
            raise ValueError(f"sync mode {mode!r} not in {SYNC_MODES}")
        self.mode = mode
        on = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if on else 1
        self.rank = dist.get_rank() if on else 0
        self.g1 = self.g2 = None
        self.n1, self.n2 = self.world, 1
        if self.world == 1:
            return
        p1 = topology.phase1_groups(self.world)
        p2 = topology.phase2_groups(self.world)
        self.g1, self.n1 = self._mine(p1 or [list(range(self.world))])
        if p2 is not None:
            self.g2, self.n2 = self._mine(p2)

    def _mine(self, groups):
        mine = None
        for ranks in groups:            # every rank creates every group
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (g, len(ranks))
        return mine

    # -- the phases -----------------------------------------------------

    def flat(self, grads) -> None:
        """CSGD: one all-reduce mean over every rank, in place."""
        if self.world == 1:
            return
        for g in leaves(grads):
            dist.all_reduce(g)
            g.div_(self.world)

    def phase1(self, grads) -> None:
        """Mean within this rank's fast group, in place."""
        if self.world == 1:
            return
        for g in leaves(grads):
            dist.all_reduce(g, group=self.g1)
            g.div_(self.n1)

    def phase2(self, grads, residual=None) -> Optional[Inflight]:
        """Issue the mean across groups on ``grads`` (in place, async);
        None when there is no phase 2.  ``residual`` is the
        error-feedback state of the compressed mode, updated at issue."""
        if self.g2 is None:
            return None
        if self.mode == "lsgd_rsag":
            return self._rsag(grads)
        if self.mode == "lsgd_compressed":
            return self._compressed(grads, residual)
        gs = leaves(grads)
        works = [dist.all_reduce(g, group=self.g2, async_op=True)
                 for g in gs]

        def finish():
            for g in gs:
                g.div_(self.n2)

        return Inflight(works, finish)

    def _rsag(self, grads) -> Inflight:
        """Phase 2 as reduce-scatter (blocking) + all-gather (async) over
        a flat buffer padded to a multiple of the group size."""
        n2, gs, works, fulls = self.n2, leaves(grads), [], []
        for g in gs:
            flat = g.reshape(-1)
            pad = (-flat.numel()) % n2
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            shard = flat.new_empty(flat.numel() // n2)
            dist.reduce_scatter_tensor(shard, flat, group=self.g2)
            full = flat if not pad else flat.new_empty(flat.numel())
            works.append(dist.all_gather_into_tensor(
                full, shard, group=self.g2, async_op=True))
            fulls.append(full)

        def finish():
            for g, full in zip(gs, fulls):
                g.copy_(full[:g.numel()].view_as(g)).div_(n2)

        return Inflight(works, finish)

    def _compressed(self, grads, residual) -> Inflight:
        """Phase 2 with a bf16 payload: q = bf16(g + r), r <- (g + r) - q,
        then every member's q gathered and summed in f32."""
        n2, gs, works, outs = self.n2, leaves(grads), [], []
        for g, r in zip(gs, leaves(residual)):
            g32 = g.float() + r.float()
            q = g32.to(torch.bfloat16)
            r.copy_(g32 - q.float())
            out = q.new_empty(n2 * q.numel())
            works.append(dist.all_gather_into_tensor(
                out, q.reshape(-1), group=self.g2, async_op=True))
            outs.append(out)

        def finish():
            for g, out in zip(gs, outs):
                g.copy_((out.view(n2, -1).float().sum(0) / n2).view_as(g))

        return Inflight(works, finish)
