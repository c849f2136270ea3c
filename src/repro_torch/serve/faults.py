# A copy of repro/serve/faults.py: the port keeps its own copy so that it
# imports nothing of the JAX package.
"""Fault model for the serving cluster: replica lifecycle states,
health/retry policy, and a deterministic chaos-injection plan.

LSGD's communicator layer exists so that a slow or dead worker group
stays a *subgroup-local* event — the paper's isolation claim.  The
serving analogue: a replica (one tensor-parallel engine + its worker
thread) must be allowed to die, hang, or stall without stalling the
dispatcher or losing requests.  This module holds the pieces the
dispatcher composes into that guarantee:

  * ``ReplicaState`` — the lifecycle every replica walks:
    LIVE -> SUSPECT (heartbeat older than the soft deadline; routing
    continues, the monitor watches) -> back to LIVE on a fresh beat, or
    -> DEAD (hard deadline blown, worker exception, or forced drain).
    DRAINING is the operator-requested exit: stop admitting, finish
    queued + in-flight work, release the slice.
  * ``HealthConfig`` / ``RetryPolicy`` — the dispatcher-side policy
    knobs: heartbeat deadlines, bounded retry with exponential backoff
    + deterministic jitter, and the poison threshold (a request whose
    replica dies under it ``max_attempts`` times is terminated with a
    fault result instead of retried forever).
  * ``FaultPlan`` — a seedable, deterministic injection plan: at the
    k-th dispatch of replica r, kill (``ReplicaKilled``), raise a
    generic error, hang (block on a releasable event), or delay.  The
    worker thread calls ``apply`` once per dispatch, so the injection
    point is exactly the engine-worker boundary a real crash would hit.

Failover is *correctness-preserving by construction*: the engine's
sampling keys are stateless ``fold_in(rid, position)`` folds
(``repro_torch.kernels.prng``), so re-decoding a reclaimed request on
any surviving replica reproduces the identical token stream — a false-positive DEAD verdict (e.g. a CPU
throttle outlasting the hard deadline) costs duplicated work, never a
wrong or lost result.
"""
from __future__ import annotations

import enum
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple


class ReplicaState(enum.Enum):
    LIVE = "live"
    SUSPECT = "suspect"
    DRAINING = "draining"
    DEAD = "dead"


class ReplicaKilled(RuntimeError):
    """Injected replica death (the chaos plan's ``kill`` action)."""


class FaultInjected(RuntimeError):
    """Injected generic worker exception (the ``error`` action)."""


class Overloaded(RuntimeError):
    """Submission shed: every live replica is past capacity and the
    cluster was built with ``shed_overload=True`` (fail fast instead of
    blocking the client)."""


class NoLiveReplicas(RuntimeError):
    """No replica can admit work: every one is DRAINING or DEAD."""


@dataclass(frozen=True)
class HealthConfig:
    """Heartbeat policy for the dispatcher-side health monitor.

    A worker stamps a monotonic beat once per dispatch; the monitor
    marks a replica SUSPECT when its beat is older than
    ``soft_deadline_s`` (still routed to — a suspect that beats again
    goes back to LIVE) and DEAD when older than ``hard_deadline_s``
    (its requests fail over to survivors).  Defaults are deliberately
    generous: on a throttled CI host a healthy dispatch can stall for
    seconds, and while a false DEAD verdict is correctness-preserving
    (see module docstring) it still wastes recompute."""

    soft_deadline_s: float = 5.0
    hard_deadline_s: float = 30.0
    interval_s: float = 0.05        # monitor wake-up period


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded failover retry: exponential backoff with deterministic
    per-(rid, attempt) jitter, and the poison threshold.

    ``max_attempts`` counts replica deaths *under* a request (picked-up
    and in flight when the replica died) — a queued-but-unpicked
    request re-dispatched off a dead replica's queue does not burn an
    attempt, because it cannot have caused the death."""

    max_attempts: int = 3
    backoff_base_s: float = 0.02
    backoff_factor: float = 2.0
    backoff_max_s: float = 1.0
    jitter: float = 0.25            # +/- fraction of the base delay
    seed: int = 0

    def delay_s(self, attempt: int, rid: int) -> float:
        """Backoff before re-dispatching ``rid``'s ``attempt``-th retry.
        Deterministic: the jitter draw is seeded by (seed, rid, attempt),
        so a replayed chaos run waits the same delays."""
        if attempt <= 0:
            return 0.0
        base = min(self.backoff_max_s,
                   self.backoff_base_s
                   * self.backoff_factor ** (attempt - 1))
        rng = random.Random(f"{self.seed}:{rid}:{attempt}")
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


@dataclass(frozen=True)
class FaultAction:
    """One injected fault: fires immediately before replica ``replica``
    runs its ``dispatch``-th engine dispatch (0-based count of
    ``Engine.step`` calls its worker has made)."""

    replica: int
    dispatch: int
    kind: str                       # "kill" | "error" | "hang" | "delay"
    delay_s: float = 0.05           # only for kind == "delay"


_KINDS = ("kill", "error", "hang", "delay")


class FaultPlan:
    """Deterministic chaos schedule, consumed concurrently by replica
    worker threads (hence the internal lock: pops of the action table
    and the fired log race across workers).

    ``apply(replica, k)`` is called by replica ``replica``'s worker
    immediately before its k-th dispatch; a matching action fires
    exactly once.  ``hang`` blocks on an internal event until
    ``release_hangs()`` (test teardown) or ``hang_timeout_s`` — a hung
    worker that outlives the monitor's hard deadline is declared DEAD
    and its later resumption must be dropped by the dispatcher (the
    orphan guard), which this plan's hang action exists to exercise."""

    def __init__(self, actions: Iterable[FaultAction],
                 hang_timeout_s: float = 60.0):
        self._lock = threading.Lock()
        self._actions: Dict[Tuple[int, int], FaultAction] = {}
        for a in actions:
            if a.kind not in _KINDS:
                raise ValueError(f"unknown fault kind {a.kind!r}")
            self._actions[(a.replica, a.dispatch)] = a
        # the full schedule, immutable: _actions is consumed by apply()
        self._planned: Tuple[FaultAction, ...] = tuple(
            self._actions.values())
        self._fired: List[FaultAction] = []
        self._release = threading.Event()
        self.hang_timeout_s = hang_timeout_s

    @classmethod
    def kill_at(cls, replica: int, dispatch: int) -> "FaultPlan":
        return cls([FaultAction(replica, dispatch, "kill")])

    @classmethod
    def seeded_kill(cls, seed: int, num_replicas: int,
                    min_dispatch: int = 2, max_dispatch: int = 10
                    ) -> "FaultPlan":
        """The chaos-smoke plan: kill one seeded replica at one seeded
        dispatch index in [min_dispatch, max_dispatch] — late enough to
        land mid-generation, early enough that short CI runs reach it."""
        rng = random.Random(seed)
        return cls.kill_at(rng.randrange(num_replicas),
                           rng.randint(min_dispatch, max_dispatch))

    def planned(self) -> List[FaultAction]:
        with self._lock:
            return list(self._planned)

    def fired(self) -> List[FaultAction]:
        with self._lock:
            return list(self._fired)

    def release_hangs(self) -> None:
        """Unblock every current and future ``hang`` action (tests call
        this at teardown so orphaned workers exit instead of sleeping
        out the hang timeout)."""
        self._release.set()

    def apply(self, replica: int, dispatch: int) -> None:
        """Fire the action scheduled for (replica, dispatch), if any.
        Called on the worker thread, so an exception here kills the
        worker exactly like an engine crash would."""
        with self._lock:
            act = self._actions.pop((replica, dispatch), None)
            if act is not None:
                self._fired.append(act)
        if act is None:
            return
        if act.kind == "delay":
            time.sleep(act.delay_s)
        elif act.kind == "hang":
            # block, then RESUME: the worker comes back after the
            # monitor may already have declared it dead — the
            # dispatcher's orphan guard must drop everything it does next
            self._release.wait(self.hang_timeout_s)
        elif act.kind == "error":
            raise FaultInjected(
                f"injected error at replica {replica} dispatch {dispatch}")
        else:
            raise ReplicaKilled(
                f"injected kill at replica {replica} dispatch {dispatch}")
