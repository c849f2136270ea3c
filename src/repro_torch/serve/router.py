# A copy of repro/serve/router.py: the port keeps its own copy so that it
# imports nothing of the JAX package.
"""Data-parallel replica routing over the LSGD mesh axes.

Serving reuses the training topology's fabric distinction
(``repro_torch.core.topology.Topology``): one inference replica per
*fast-fabric* group (the paper's worker group — devices that share the
cheap intra-node interconnect hold one model copy and batch together),
while the *slow* axis (``pod``) only separates replicas, exactly like it
only carries the infrequent phase-2 all-reduce in training.  The router
is the host-side front door: requests go to the replica with the fewest
outstanding *tokens per slice device* (prompt + requested generation —
a long-form request weighs what it costs, not 1; load and capacity
normalize by slice width, so a 4-device tensor-parallel replica draws
proportionally more traffic than a 1-device one), lowest replica id on
ties, so heavy traffic spreads without any cross-replica (slow-fabric)
coordination on the hot path.  ``ServeCluster``
(``repro_torch.serve.dispatcher``) turns this placement into actual execution:
one Engine per device slice, fed by per-replica worker threads.

Bookkeeping contract (property-tested): loads never go negative, the sum
of loads equals the outstanding routed weight, and ``route`` /
``complete`` / ``release`` compose in any order — releasing an unknown
or already-released rid is a no-op, never a crash.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.topology import Topology


@dataclass(frozen=True)
class Replica:
    replica_id: int
    pod: int
    group: int                  # fast-axis group index within the pod
    devices: Tuple[int, ...]    # fast-axis ranks forming this replica


class ReplicaRouter:
    """Token-weighted least-loaded routing over the replica grid implied
    by a Topology (pod-major, fast-axis groups inner — the same order
    ``launch.mesh.replica_slices`` emits device slices in, so
    ``replica_id`` indexes both).

    Thread-safe: every replica's worker thread reports progress and
    completions while client threads route and read loads, so the load
    and assignment tables live behind an internal lock — callers need
    no external synchronization, and each public method is atomic
    (``route``'s pick-then-charge cannot interleave with a concurrent
    ``release`` shrinking the load it compared)."""

    def __init__(self, topology: Topology, num_pods: int, data_size: int,
                 capacity_tokens: Optional[int] = None,
                 widths: Optional[Dict[int, int]] = None):
        groups = topology.phase1_groups(data_size)
        if groups is None:
            groups = [list(range(data_size))]
        self.replicas: List[Replica] = []
        for pod in range(num_pods):
            for gi, g in enumerate(groups):
                self.replicas.append(Replica(
                    replica_id=len(self.replicas), pod=pod, group=gi,
                    devices=tuple(g)))
        # backpressure threshold: a loaded replica refuses work past this
        # many outstanding tokens *per device in its slice* (None =
        # unbounded).  An idle replica always accepts, so one oversized
        # request can't deadlock.
        self.capacity_tokens = capacity_tokens
        # slice width per replica: a tensor-parallel replica spanning w
        # devices serves ~w times the throughput of a 1-device one, so
        # both the capacity threshold and the load comparison scale by
        # width — a wide replica draws proportionally more traffic.
        # Defaults to the topology slice width; ``widths`` overrides for
        # heterogeneous explicit-slice clusters.
        self._width: Dict[int, int] = {
            r.replica_id: max(1, len(r.devices)) for r in self.replicas}
        if widths:
            self._width.update({rid: max(1, int(w))
                                for rid, w in widths.items()})
        self._lock = threading.Lock()
        self._load: Dict[int, int] = {r.replica_id: 0 for r in self.replicas}
        self._assignment: Dict[int, Tuple[int, int]] = {}  # rid -> (replica, weight)
        self._disabled: set = set()       # replicas not accepting routes
        self._m: Optional[dict] = None

    def attach_metrics(self, registry, **labels) -> None:
        """Wire routing decisions / per-replica load gauges into a
        :class:`repro_torch.serve.telemetry.MetricsRegistry`.  Optional: with
        no registry attached the router is metrics-free."""
        with self._lock:
            self._m = {
                "routed": registry.counter("router_routed", **labels),
                "refusals": registry.counter("router_refusals", **labels),
                "released": registry.counter("router_released", **labels),
                "progress": registry.counter("router_progress_tokens",
                                             **labels),
                "load": {r.replica_id: registry.gauge(
                             "router_load_tokens", replica=r.replica_id,
                             **labels)
                         for r in self.replicas},
            }

    def _sync_load(self, replica_id: int) -> None:
        if self._m is not None:
            self._m["load"][replica_id].set(self._load[replica_id])

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    def width(self, replica_id: int) -> int:
        """Device-slice width of ``replica_id`` (the TP degree its
        engine serves at)."""
        return self._width[replica_id]

    def disable(self, replica_id: int) -> None:
        """Take ``replica_id`` out of the routing pool (DRAINING/DEAD):
        new routes skip it.  Existing assignments are untouched — the
        failover path releases and re-routes them explicitly, so load
        accounting never jumps behind the dispatcher's back."""
        with self._lock:
            self._disabled.add(replica_id)

    def enable(self, replica_id: int) -> None:
        """Return ``replica_id`` to the routing pool (respawn after a
        clean drain).  Idempotent, like ``disable``."""
        with self._lock:
            self._disabled.discard(replica_id)

    def enabled_count(self) -> int:
        """Replicas currently accepting new routes."""
        with self._lock:
            return len(self.replicas) - len(self._disabled)

    def route(self, rid: int, tokens: int = 1) -> Optional[Replica]:
        """Assign request ``rid`` to the enabled replica with the fewest
        outstanding tokens *per slice device* (lowest id on ties, so
        placement is deterministic) — a width-4 TP replica with 40
        outstanding tokens is as loaded as a width-1 replica with 10.
        ``tokens`` is the request's weight — its outstanding
        prompt+decode tokens.  Returns None when every enabled replica
        is saturated (``capacity_tokens`` × width) or every replica is
        disabled: backpressure, the caller should wait for a release
        (or a respawn) and retry.  Re-routing an already-assigned rid
        returns its existing placement even on a disabled replica — the
        caller owns the release-then-re-route ordering."""
        with self._lock:
            if rid in self._assignment:
                return self.replicas[self._assignment[rid][0]]
            candidates = [r for r in self.replicas
                          if r.replica_id not in self._disabled]
            if not candidates:
                if self._m is not None:
                    self._m["refusals"].inc()
                return None
            best = min(candidates,
                       key=lambda r: (self._load[r.replica_id]
                                      / self._width[r.replica_id],
                                      r.replica_id))
            load = self._load[best.replica_id]
            if (self.capacity_tokens is not None and load > 0
                    and load + tokens >
                    self.capacity_tokens * self._width[best.replica_id]):
                if self._m is not None:
                    self._m["refusals"].inc()
                return None
            self._assignment[rid] = (best.replica_id, tokens)
            self._load[best.replica_id] += tokens
            if self._m is not None:
                self._m["routed"].inc()
                self._sync_load(best.replica_id)
            return best

    def progress(self, rid: int, tokens: int) -> None:
        """Return ``tokens`` of a routed request's weight early — the
        dispatcher reports generated tokens in N-token quanta (one
        report per engine dispatch, so depth-N decode loops amortize the
        bookkeeping the same way they amortize dispatch), and the load
        a replica carries decays as it actually does the work instead of
        only at completion.  Clamped to the remaining weight; unknown
        rids are no-ops — same composability contract as ``release``."""
        with self._lock:
            entry = self._assignment.get(rid)
            if entry is None:
                return
            replica_id, weight = entry
            dec = min(weight, max(int(tokens), 0))
            self._assignment[rid] = (replica_id, weight - dec)
            self._load[replica_id] -= dec
            if self._m is not None:
                self._m["progress"].inc(dec)
                self._sync_load(replica_id)

    def release(self, rid: int) -> None:
        """Drop ``rid``'s assignment and return its weight to the
        replica.  Idempotent: unknown or already-released rids are
        no-ops, so completion, cancellation, and queue-drain paths can
        all call it without coordinating."""
        with self._lock:
            entry = self._assignment.pop(rid, None)
            if entry is None:
                return
            replica_id, weight = entry
            self._load[replica_id] -= weight
            if self._m is not None:
                self._m["released"].inc()
                self._sync_load(replica_id)

    def complete(self, rid: int) -> None:
        """A routed request finished; same semantics as ``release``."""
        self.release(rid)

    def loads(self) -> Dict[int, int]:
        """Outstanding routed tokens per replica (a snapshot)."""
        with self._lock:
            return dict(self._load)

    def outstanding(self) -> int:
        """Requests currently routed and not yet released."""
        with self._lock:
            return len(self._assignment)
