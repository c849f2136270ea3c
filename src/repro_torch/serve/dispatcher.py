# A port of repro/serve/dispatcher.py: the port keeps its own copy so
# that it imports nothing of the JAX package.
"""Multi-replica serving frontend (``repro/serve/dispatcher.py``):
LSGD's two layers, executed.

The paper's topology is a fast intra-group layer (workers on cheap
fabric) under a slow inter-group layer (communicators) that only carries
infrequent coarse traffic.  ``ServeCluster`` is that structure as a
serving system, not a placement diagram:

  * each *fast-fabric* device slice (``launch.mesh.replica_slices`` —
    one slice per ``Topology`` fast group, pod-major) gets its own
    ``Engine``, driven by a dedicated worker thread on the engine's own
    CUDA stream; ALL per-token traffic — block-table rebuilds, KV
    scatter/gather, sampled-token feedback — stays inside the slice.
    A slice of one device serves one engine alone, a slice of several
    one tensor-parallel engine split over them (a slice may name one
    device twice: two shards on one card); one-device replicas that
    share a card share its params, and every replica owns its pools;
  * the dispatcher is the *slow* layer: it carries only admission
    (token-weighted fan-out through ``ReplicaRouter``, load and
    capacity normalized by slice width), completed ``RequestResult``s,
    health verdicts, and metrics.  Nothing per-token ever crosses it,
    mirroring how the phase-2 all-reduce never sits on the training hot
    path.

Fault tolerance makes the paper's isolation claim operational: a
replica that crashes or hangs is a *subgroup-local* event.  A health
monitor watches per-replica heartbeats (one beat per engine dispatch)
and walks each replica through LIVE -> SUSPECT -> DEAD
(``repro_torch.serve.faults.ReplicaState``); a dead replica's requests are
reclaimed — post-mortem from its quiescent engine after a crash, from
dispatcher-held submit snapshots after a hang (the engine of a hung
worker can never be touched again) — and re-dispatched to survivors
with bounded backoff.  Because the engine samples with stateless
``fold_in(rid, position)`` keys, the re-decode draws the same keys on
any replica: in float32 (and on the CPU, where the engine pads one-row
steps) it reproduces the identical token stream.  In bf16 a row's
logits depend on the other rows of its batch (the attention sums run in
another order), so a failed-over stream may part from the fault-free
one where two logits nearly tie.  Either way a request terminates
exactly once (the trace book refuses double
terminals).  Requests whose replica dies under them ``max_attempts``
times are quarantined with a ``poison`` fault result instead of
retried forever; per-request queue-wait and e2e deadline budgets are
enforced at every dispatch boundary.

Backpressure closes the loop: routing weights requests by outstanding
prompt+decode tokens, and when every replica is past
``capacity_tokens`` the submitting thread blocks until a completion
releases weight (or, with ``shed_overload=True``, the submit fails
fast with ``Overloaded``) — admission control at the slow layer, token
costs metered where they accrue.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.launch.mesh import cuda_devices, replica_slices
from repro_torch.serve.engine import Engine, EngineConfig, RequestResult
from repro_torch.serve.faults import (FaultPlan, HealthConfig,
                                      NoLiveReplicas, Overloaded,
                                      ReplicaState, RetryPolicy)
from repro_torch.serve.router import ReplicaRouter
from repro_torch.serve.scheduler import Request, RequestQueue
from repro_torch.serve.telemetry import Telemetry


@dataclass(frozen=True)
class _Snapshot:
    """What the dispatcher remembers about a submitted request — enough
    to rebuild it from scratch when its replica hangs (a hung worker's
    engine is untouchable: reading it would race the wedged thread).
    The absolute deadline instants ride along so a rebuilt request
    keeps the ORIGINAL budgets — dying replicas never extend a
    deadline."""
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    arrival_time: float
    deadline_at: Optional[float]
    queue_deadline_at: Optional[float]


@dataclass(eq=False)        # identity equality (held in a worklist)
class _Failover:
    """One reclaimed request waiting out its backoff before re-dispatch."""
    ready_at: float
    req: Request
    attempt: int
    cause: str


class ServeCluster:
    """One Engine per fast-fabric device slice + the dispatcher over
    them.  Use as a context manager or call ``close()`` + ``join()``.

    All replicas share one :class:`Telemetry` bundle: replica-labeled
    metric handles keep engines apart in the registry, the request
    trace book sees the whole lifecycle (dispatcher stamps
    submit/route/retry, the owning engine stamps
    admit/first_token/terminal), and the span tracer gets one
    ``replica{i}/host`` + ``replica{i}/device`` track pair per worker
    plus a ``dispatcher`` track.  Pass ``trace=True`` (or a pre-built
    ``telemetry=``) to turn span tracing on; metrics are always on.

    Fault-tolerance knobs: ``health`` (heartbeat deadlines), ``retry``
    (backoff + poison threshold), ``faults`` (a deterministic chaos
    plan injected at the engine-worker boundary), ``shed_overload``
    (fail submissions fast instead of blocking on backpressure), and
    ``join_timeout_s`` (default bound for ``join``; a join that blows
    it force-fails whatever is still wedged instead of hanging
    forever).  ``fault_tolerant=False`` restores the legacy contract:
    the first worker exception is re-raised from ``join``.

    ``devices`` defaults to every visible CUDA device and raises when
    there is none; CPU runs name theirs (``[torch.device("cpu")]``)."""

    def __init__(self, model, params, cfg: EngineConfig = EngineConfig(),
                 topology: Optional[Topology] = None, num_pods: int = 1,
                 devices=None, slices: Optional[List[Tuple]] = None,
                 capacity_tokens: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None,
                 trace: bool = False,
                 faults: Optional[FaultPlan] = None,
                 health: Optional[HealthConfig] = None,
                 retry: Optional[RetryPolicy] = None,
                 fault_tolerant: bool = True,
                 shed_overload: bool = False,
                 join_timeout_s: Optional[float] = None):
        if slices is None:
            topology = topology or Topology()
            devices = cuda_devices() if devices is None else list(devices)
            slices = replica_slices(topology, num_pods, devices)
            data_size = len(devices) // num_pods
        else:
            # explicit slices (the virtual fallback of ``for_replicas``):
            # the router grid degenerates to one single-device pod per
            # slice — placement bookkeeping still 1:1 with engines
            topology, num_pods, data_size = Topology(), len(slices), 1
        self.telemetry = telemetry or Telemetry(trace=trace)
        # router capacity/load normalize by ACTUAL slice width (explicit
        # slices may be heterogeneous, and the shared-single-device
        # fallback's grid replicas claim width 1 regardless of grid shape)
        self.router = ReplicaRouter(topology, num_pods, data_size,
                                    capacity_tokens=capacity_tokens,
                                    widths={i: len(s)
                                            for i, s in enumerate(slices)})
        self.router.attach_metrics(self.telemetry.registry)
        if self.router.num_replicas != len(slices):
            raise ValueError(
                f"replica grid ({self.router.num_replicas}) != device "
                f"slices ({len(slices)})")
        self.slices = slices
        # params already on a slice's device are shared, not copied
        # (``engine._to_device``): replicas on one card own their pools
        self.engines = [Engine(model, params, cfg, devices=s,
                               telemetry=self.telemetry, replica_id=i)
                        for i, s in enumerate(slices)]
        self.faults = faults
        self.health = health or HealthConfig()
        self.retry = retry or RetryPolicy()
        self.fault_tolerant = fault_tolerant
        self.shed_overload = shed_overload
        self.join_timeout_s = join_timeout_s
        self._queues = [RequestQueue() for _ in slices]
        self._threads: List[threading.Thread] = []
        self._thread_of: Dict[int, threading.Thread] = {}
        self._results: Dict[int, RequestResult] = {}
        self._cancelled: set = set()
        self._picked: Dict[int, int] = {}   # rid -> owning replica
        self._errors: List[BaseException] = []
        self._cv = threading.Condition()
        self._started = False
        # replica lifecycle (all under _cv)
        n = len(slices)
        self._state: Dict[int, ReplicaState] = {
            i: ReplicaState.LIVE for i in range(n)}
        self._reason: Dict[int, Optional[str]] = {i: None for i in range(n)}
        self._generation: Dict[int, int] = {i: 0 for i in range(n)}
        self._dispatches: Dict[int, int] = {i: 0 for i in range(n)}
        self._beat: Dict[int, float] = {}
        self._snapshots: Dict[int, _Snapshot] = {}
        self._attempts: Dict[int, int] = {}     # rid -> deaths under it
        self._pending_failover: List[_Failover] = []
        self._monitor_thread: Optional[threading.Thread] = None
        self._stop_monitor = threading.Event()
        reg = self.telemetry.registry
        self._failovers = reg.counter("cluster_failovers")
        self._redispatched = reg.counter("cluster_redispatched")
        self._shed = reg.counter("cluster_requests_shed")
        self._forced_drains = reg.counter("cluster_forced_drains")
        self._state_gauge = {i: reg.gauge("replica_state", replica=i)
                             for i in range(n)}
        _STATE_CODE = {s: c for c, s in enumerate(ReplicaState)}
        self._state_code = _STATE_CODE
        for i in range(n):
            self._state_gauge[i].set(_STATE_CODE[ReplicaState.LIVE])

    @classmethod
    def for_replicas(cls, model, params, cfg: EngineConfig = EngineConfig(),
                     num_replicas: int = 1, devices=None, **kw
                     ) -> "ServeCluster":
        """``num_replicas`` engines over the devices (every visible CUDA
        device by default): honest disjoint slices when the device count
        divides evenly (each slice one fast-fabric group, served
        tensor-parallel when it holds more than one device), round-robin
        shared single-device slices otherwise (two replicas on one
        card)."""
        devices = cuda_devices() if devices is None else list(devices)
        n = len(devices)
        if num_replicas <= n and n % num_replicas == 0:
            topo = Topology(intra_group_size=n // num_replicas)
            return cls(model, params, cfg, topology=topo, devices=devices,
                       **kw)
        slices = [(devices[i % n],) for i in range(num_replicas)]
        return cls(model, params, cfg, slices=slices, **kw)

    @property
    def num_replicas(self) -> int:
        return len(self.engines)

    # -- lifecycle ----------------------------------------------------------

    def warmup(self) -> None:
        """Run every engine's row layouts once before traffic, so the
        kernel library is built and loaded and the allocator holds each
        engine's working set before any worker's heartbeat clock starts
        (``start`` stamps the first beat)."""
        for e in self.engines:
            e.warmup()

    def start(self) -> None:
        # under _cv: a concurrent start() must not double-launch
        # workers, and close() reads _started/_thread_of under the same
        # lock to decide which queues to drain
        with self._cv:
            if self._started:
                return
            self._started = True
            for i in range(len(self.engines)):
                self._spawn_worker(i)
            if self.fault_tolerant:
                t = threading.Thread(target=self._monitor,
                                     name="serve-monitor", daemon=True)
                self._monitor_thread = t
                t.start()

    def _spawn_worker(self, idx: int) -> None:
        """(under _cv) Launch the worker thread driving replica ``idx``
        at its current generation.  The generation token is the orphan
        guard: a thread whose generation no longer matches (the monitor
        declared it hung, or the replica respawned) must drop everything
        and exit — two threads never drive one engine."""
        gen = self._generation[idx]
        self._beat[idx] = time.monotonic()
        t = threading.Thread(
            target=self._worker,
            args=(idx, self.engines[idx], self._queues[idx], gen),
            name=f"serve-replica-{idx}", daemon=True)
        self._thread_of[idx] = t
        self._threads.append(t)
        t.start()

    def close(self) -> None:
        """Close admission.  Requests already routed but sitting in a
        queue no worker will ever run (cluster never started, or THAT
        replica's worker died without failover) are drained and their
        router weight released — a routed-but-never-picked-up request
        must not leak load.  Healthy replicas keep their queues: their
        workers drain and serve the remainder before exiting."""
        for q in self._queues:
            q.close()
        dropped: List[int] = []
        with self._cv:
            for i, q in enumerate(self._queues):
                t = self._thread_of.get(i)
                alive = (t is not None and t.is_alive()
                         and self._state[i] is not ReplicaState.DEAD)
                if not alive:
                    for req in q.drain():
                        self.router.release(req.rid)
                        self._snapshots.pop(req.rid, None)
                        if req.rid not in self._cancelled:
                            dropped.append(req.rid)
            self._cv.notify_all()
        for rid in dropped:       # routed-but-never-run = cancelled
            self.telemetry.requests.finish(rid, "cancel")

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for every worker to retire and every failover to
        settle.  Bounded: when ``timeout`` (or the constructor's
        ``join_timeout_s``) expires with workers still alive, they are
        force-failed — declared hung, their requests failed over from
        snapshots — instead of being waited on forever (the regression
        this fixes: one wedged replica used to hang ``join``, and the
        whole cluster teardown, indefinitely)."""
        budget = self.join_timeout_s if timeout is None else timeout
        deadline = (None if budget is None
                    else time.monotonic() + budget)
        while True:
            with self._cv:
                alive = [i for i, t in self._thread_of.items()
                         if t.is_alive()
                         and self._state[i] is not ReplicaState.DEAD]
                if not alive and not self._pending_failover:
                    break
                now = time.monotonic()
                if deadline is not None and now > deadline:
                    # forced drain: whatever is still alive has outlived
                    # the caller's patience — treat it as hung and fail
                    # its work over (to a respawnable survivor if one
                    # exists, to fault results otherwise), then wait
                    # unbounded for the failover itself to settle
                    deadline = None
                    self._forced_drains.inc()
                    for i in alive:
                        self._fail_replica_hung(i, now)
                    self._process_failover(now)
            time.sleep(0.002)
        with self._cv:
            self._stop_monitor.set()
            self._cv.notify_all()
            mt = self._monitor_thread
        if mt is not None:
            mt.join(timeout=10.0)
        with self._cv:
            if self._errors:
                raise self._errors[0]

    def drain(self, replica_id: int) -> None:
        """Graceful degradation: stop routing NEW work to
        ``replica_id``; its worker finishes everything queued and in
        flight, then retires (DEAD, reason ``drained`` — the one DEAD
        flavor eligible for respawn, because its engine was left empty
        by a cleanly exiting owner)."""
        with self._cv:
            if self._state[replica_id] in (ReplicaState.LIVE,
                                           ReplicaState.SUSPECT):
                self._state[replica_id] = ReplicaState.DRAINING
                self.router.disable(replica_id)
                self._set_state_gauge(replica_id)
                self._cv.notify_all()

    def __enter__(self) -> "ServeCluster":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        if not any(exc):
            self.join()
        return False

    # -- admission (the slow layer) -----------------------------------------

    def submit(self, req: Request, timeout: Optional[float] = None) -> int:
        """Route ``req`` token-weighted and hand it to its replica's
        queue.  Blocks while every replica is saturated (backpressure)
        unless the cluster sheds (``shed_overload=True`` raises
        ``Overloaded`` instead); raises ``NoLiveReplicas`` when no
        replica can ever admit it (all DEAD/DRAINING).  Returns the
        replica_id it landed on."""
        weight = int(req.prompt.size) + req.max_new_tokens
        t_sub = time.perf_counter()
        self.telemetry.requests.stamp(req.rid, "submit", t=t_sub)
        req.start_clock()       # arm deadline budgets at the front door
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            replica = self.router.route(req.rid, tokens=weight)
            while replica is None:
                if self._errors:
                    raise self._errors[0]
                if not self._any_admittable():
                    raise NoLiveReplicas(
                        f"request {req.rid}: every replica is DEAD or "
                        "DRAINING")
                if self.shed_overload:
                    self._shed.inc()
                    raise Overloaded(
                        f"request {req.rid}: every live replica past "
                        f"capacity_tokens={self.router.capacity_tokens}")
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    raise TimeoutError(
                        f"request {req.rid}: every replica saturated for "
                        f"{timeout}s (capacity_tokens="
                        f"{self.router.capacity_tokens})")
                self._cv.wait(wait)
                replica = self.router.route(req.rid, tokens=weight)
            # queue-submit INSIDE the lock: route+enqueue are atomic
            # against a concurrent queue reclaim (replica death), so a
            # routed request is always either in a queue the failover
            # path drains or in _picked under a snapshot
            try:
                self._queues[replica.replica_id].submit(req)
            except BaseException:
                # admission refused (queue closed mid-submit): the
                # routed weight must not leak
                self.router.release(req.rid)
                self._cv.notify_all()
                raise
            self._snapshots[req.rid] = _Snapshot(
                prompt=req.prompt.copy(),
                max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
                arrival_time=req.arrival_time, deadline_at=req.deadline_at,
                queue_deadline_at=req.queue_deadline_at)
        t_routed = time.perf_counter()
        self.telemetry.requests.stamp(req.rid, "route", t=t_routed)
        self.telemetry.tracer.span(
            "dispatcher", f"route:{req.rid}", t_sub, t_routed,
            args={"rid": req.rid, "replica": replica.replica_id,
                  "weight": weight})
        return replica.replica_id

    def cancel(self, rid: int) -> bool:
        """Cancel a routed request no engine has picked up yet.
        Idempotent; releases the router weight immediately.  Returns
        False if an engine already accepted the request (it will run to
        completion and keep its weight until then) or it already
        finished — cancellation only intercepts the queue (and the
        failover backoff line), it never claws back in-flight work."""
        with self._cv:
            if rid in self._picked or rid in self._results:
                return False
            self._cancelled.add(rid)
            self.router.release(rid)
            self._snapshots.pop(rid, None)
            self._attempts.pop(rid, None)
            self._cv.notify_all()
        self.telemetry.requests.finish(rid, "cancel")
        return True

    def _any_admittable(self) -> bool:
        """(under _cv) Whether any replica can accept NEW work."""
        return any(s in (ReplicaState.LIVE, ReplicaState.SUSPECT)
                   for s in self._state.values())

    # -- the fast layer (one thread per replica) ----------------------------

    def _orphaned(self, idx: int, gen: int) -> bool:
        """(under _cv) True when the calling worker no longer owns
        replica ``idx``: the monitor declared it DEAD (hung) or the
        replica respawned under a newer generation.  An orphan must
        drop all results and exit — its requests were already failed
        over."""
        return (self._state[idx] is ReplicaState.DEAD
                or self._generation[idx] != gen)

    def _worker(self, idx: int, eng: Engine, q: RequestQueue,
                gen: int) -> None:
        try:
            with eng.on_stream():
                self._work(idx, eng, q, gen)
        except BaseException as e:
            self._on_worker_death(idx, eng, gen, e)

    def _work(self, idx: int, eng: Engine, q: RequestQueue,
              gen: int) -> None:
        """The worker loop, on the engine's stream (the current stream is
        per thread, and the kernels launch on it)."""
        while True:
            with self._cv:
                if self._orphaned(idx, gen):
                    return
                self._beat[idx] = time.monotonic()
                reqs = self._redispatch_for(idx) + q.drain()
                reqs = [r for r in reqs
                        if r.rid not in self._cancelled
                        and r.rid not in self._results]
                for r in reqs:
                    self._picked[r.rid] = idx
            for r in reqs:
                eng.submit(r)
            if not eng.has_work:
                with self._cv:
                    if self._orphaned(idx, gen):
                        return
                    if (q.empty and not self._redispatch_peek(idx)
                            and (q.closed or self._state[idx]
                                 is ReplicaState.DRAINING)):
                        self._retire(idx)
                        return
                time.sleep(0.0005)   # idle: wait for admissions
                continue
            with self._cv:
                if self._orphaned(idx, gen):
                    return
                k = self._dispatches[idx]
                self._dispatches[idx] = k + 1
            if self.faults is not None:
                self.faults.apply(idx, k)
                # a released hang resumes HERE — if the monitor
                # declared us dead meanwhile, exit before touching
                # the engine (our requests were rebuilt elsewhere)
                with self._cv:
                    if self._orphaned(idx, gen):
                        return
            results = eng.step()
            # token-weighted load accounting in N-token quanta: each
            # dispatch's materialized tokens shed router weight as
            # the work actually happens (a depth-N decode loop sheds
            # up to N*rows tokens in one report), so backpressured
            # submitters unblock mid-request instead of waiting for
            # a completion
            progress = eng.drain_progress()
            with self._cv:
                if self._orphaned(idx, gen):
                    return
                self._beat[idx] = time.monotonic()
                for rid, n in progress.items():
                    self.router.progress(rid, n)
                for res in results:
                    self._record_result(res)
                if results or progress:
                    self._cv.notify_all()

    def _redispatch_for(self, idx: int) -> List[Request]:
        """(under _cv) Take replica ``idx``'s due failover re-dispatch
        work (the monitor routes reclaimed requests here)."""
        mine = [f for f in self._pending_failover
                if f.req.rid in self._picked
                and self._picked[f.req.rid] == idx]
        # requests are moved into _picked by the monitor at routing
        # time, so by construction nothing here is pending backoff
        if mine:
            keep = [f for f in self._pending_failover if f not in mine]
            self._pending_failover[:] = keep
        return [f.req for f in mine]

    def _redispatch_peek(self, idx: int) -> bool:
        """(under _cv) Whether failover work is bound for ``idx``."""
        return any(f.req.rid in self._picked
                   and self._picked[f.req.rid] == idx
                   for f in self._pending_failover)

    def _retire(self, idx: int) -> None:
        """(under _cv) Clean worker exit: queue exhausted (or drain
        requested) and the engine is empty.  Reason ``drained`` marks
        the replica respawn-eligible — its engine was left quiescent
        and empty by its sole owner."""
        self._declare_dead(idx, "drained")
        self._cv.notify_all()

    def _declare_dead(self, idx: int, reason: str) -> None:
        """(under _cv) DEAD transition + routing disable + generation
        bump (orphans any thread still holding the old token)."""
        self._state[idx] = ReplicaState.DEAD
        self._reason[idx] = reason
        self._generation[idx] += 1
        self.router.disable(idx)
        self._set_state_gauge(idx)

    def _set_state_gauge(self, idx: int) -> None:
        self._state_gauge[idx].set(self._state_code[self._state[idx]])

    def _record_result(self, res: RequestResult) -> None:
        """(under _cv) First result for a rid wins; drop the
        bookkeeping that kept it recoverable."""
        if res.rid in self._results:
            return
        self._results[res.rid] = res
        self.router.release(res.rid)
        self._picked.pop(res.rid, None)
        self._snapshots.pop(res.rid, None)
        self._attempts.pop(res.rid, None)

    # -- failure handling ---------------------------------------------------

    def _on_worker_death(self, idx: int, eng: Engine, gen: int,
                         exc: BaseException) -> None:
        """A worker thread died with ``exc`` (engine crash or injected
        fault).  Called OUTSIDE the lock from the worker's exception
        handler; every shared-state touch below re-acquires _cv."""
        with self._cv:
            if self._orphaned(idx, gen):
                return           # the monitor already failed us over
            self._declare_dead(idx, f"{type(exc).__name__}: {exc}")
            self._cv.notify_all()
            tolerate = self.fault_tolerant
            if not tolerate:
                self._errors.append(exc)
                return
        # post-mortem salvage OUTSIDE the lock: the engine's sole owner
        # is this thread, and it is past driving — the engine is
        # quiescent, so walking it cannot race anything
        try:
            salvaged, done = eng.reclaim_requests()
        except BaseException as e2:
            with self._cv:
                self._errors.append(e2)
                self._cv.notify_all()
            return
        with self._cv:
            now = time.monotonic()
            for res in done:
                self._record_result(res)
            self._reclaim_queue(idx, now)
            for req in salvaged:
                a = self._attempts.get(req.rid, 0) + 1
                self._attempts[req.rid] = a
                self._schedule_redispatch(req, "replica_death", a, now)
            # anything still charged to this replica was lost between
            # pick and engine admission (e.g. eng.submit itself raised):
            # rebuild it from its submit snapshot
            for rid in [r for r, owner in self._picked.items()
                        if owner == idx]:
                snap = self._snapshots.get(rid)
                if snap is None:
                    continue
                a = self._attempts.get(rid, 0) + 1
                self._attempts[rid] = a
                self._schedule_redispatch(
                    self._rebuild(rid, snap), "replica_death", a, now)
            self._failovers.inc()
            self._cv.notify_all()

    @staticmethod
    def _rebuild(rid: int, snap: _Snapshot) -> Request:
        """A fresh Request from a submit snapshot (hang failover: the
        wedged engine's partial progress is unreachable, so the request
        restarts from the original prompt — ``fold_in(rid, position)``
        sampling draws the same keys, so in float32 it regenerates the
        identical stream).  Absolute deadline
        instants carry over unchanged."""
        req = Request(prompt=snap.prompt.copy(),
                      max_new_tokens=snap.max_new_tokens, rid=rid,
                      arrival_time=snap.arrival_time, eos_id=snap.eos_id)
        req.deadline_at = snap.deadline_at
        req.queue_deadline_at = snap.queue_deadline_at
        return req

    def _reclaim_queue(self, idx: int, now: float) -> None:
        """(under _cv) Re-dispatch a dead replica's queued-but-unpicked
        requests.  No attempt is burned: a request that never reached
        the engine cannot have caused the death."""
        for req in self._queues[idx].drain():
            if req.rid in self._cancelled or req.rid in self._results:
                continue
            self._schedule_redispatch(
                req, "requeued", self._attempts.get(req.rid, 0), now)

    def _schedule_redispatch(self, req: Request, cause: str, attempt: int,
                             now: float) -> None:
        """(under _cv) Queue ``req`` for re-dispatch after backoff —
        unless its deadline already passed (fault ``deadline``) or its
        replica-death count hit the poison threshold (fault
        ``poison``).  Emits a ``retry`` lifecycle event, NOT a second
        route/admit: first-wins stamps keep TTFT measured from the
        original admission."""
        self._picked.pop(req.rid, None)
        if req.rid in self._results or req.rid in self._cancelled:
            return
        self.router.release(req.rid)
        if req.deadline_at is not None and now > req.deadline_at:
            self._fault_request(req, "deadline")
            return
        if attempt >= self.retry.max_attempts:
            self._fault_request(req, "poison")
            return
        self.telemetry.requests.note_retry(req.rid, cause)
        self._redispatched.inc()
        # at most one pending entry per rid: a request reclaimed again
        # (routed to a replica that died before pickup) supersedes its
        # older entry instead of decoding twice
        self._pending_failover[:] = [f for f in self._pending_failover
                                     if f.req.rid != req.rid]
        self._pending_failover.append(_Failover(
            ready_at=now + self.retry.delay_s(attempt, req.rid),
            req=req, attempt=attempt, cause=cause))

    def _fault_request(self, req: Request, reason: str) -> None:
        """(under _cv) Terminate ``req`` with a fault result — the
        exactly-once terminal for requests failover cannot save."""
        res = RequestResult(
            rid=req.rid, prompt_len=req.orig_prompt_len, tokens=[],
            arrival_time=req.arrival_time,
            finish_time=time.perf_counter(), fault=reason)
        self._results[req.rid] = res
        self.router.release(req.rid)
        self._picked.pop(req.rid, None)
        self._snapshots.pop(req.rid, None)
        self._attempts.pop(req.rid, None)
        self.telemetry.registry.counter(
            "cluster_fault_results", reason=reason).inc()
        self.telemetry.requests.finish(req.rid, "fault")
        self._cv.notify_all()

    # -- health monitor -----------------------------------------------------

    def _monitor(self) -> None:
        """Heartbeat watchdog + failover pump.  Holds _cv across each
        sweep (health verdicts and re-dispatch routing are atomic
        against workers), releases it while waiting."""
        with self._cv:
            while True:
                if self._stop_monitor.is_set() \
                        and not self._pending_failover:
                    return
                now = time.monotonic()
                self._check_health(now)
                self._process_failover(now)
                self._cv.wait(self.health.interval_s)

    def _check_health(self, now: float) -> None:
        """(under _cv) Walk heartbeats: beat older than the soft
        deadline -> SUSPECT (still routed; recovers to LIVE on a fresh
        beat), older than the hard deadline -> DEAD with full hang
        failover."""
        for idx in range(len(self.engines)):
            st = self._state[idx]
            t = self._thread_of.get(idx)
            if st is ReplicaState.DEAD or t is None or not t.is_alive():
                continue
            age = now - self._beat[idx]
            if age > self.health.hard_deadline_s:
                self._fail_replica_hung(idx, now)
            elif age > self.health.soft_deadline_s:
                if st is ReplicaState.LIVE:
                    self._state[idx] = ReplicaState.SUSPECT
                    self._set_state_gauge(idx)
            elif st is ReplicaState.SUSPECT:
                self._state[idx] = ReplicaState.LIVE
                self._set_state_gauge(idx)

    def _fail_replica_hung(self, idx: int, now: float) -> None:
        """(under _cv) Hard-deadline (or forced-drain) verdict: the
        worker is wedged INSIDE the engine, so unlike a crash there is
        no quiescent engine to salvage from.  Every request charged to
        the replica restarts from its submit snapshot; the generation
        bump orphans the wedged thread, whose eventual resumption (if
        any) drops everything and exits.  The replica is never
        respawned — its engine may still be driven by the zombie."""
        self._declare_dead(idx, "hung")
        self._reclaim_queue(idx, now)
        for rid in [r for r, owner in self._picked.items()
                    if owner == idx]:
            snap = self._snapshots.get(rid)
            if snap is None:
                continue
            a = self._attempts.get(rid, 0) + 1
            self._attempts[rid] = a
            self._schedule_redispatch(
                self._rebuild(rid, snap), "replica_hung", a, now)
        self._failovers.inc()
        self._cv.notify_all()

    def _process_failover(self, now: float) -> None:
        """(under _cv) Route due reclaimed requests to survivors.  When
        every replica is disabled, a cleanly-drained one is respawned
        to absorb the work (its engine is empty and unowned); if none
        exists the request terminates with ``no_live_replicas``.
        Saturated-but-live survivors just defer the item one interval."""
        if not self._pending_failover:
            return
        keep: List[_Failover] = []
        for item in self._pending_failover:
            req = item.req
            if req.rid in self._results or req.rid in self._cancelled:
                self._snapshots.pop(req.rid, None)
                continue
            if req.rid in self._picked:
                keep.append(item)    # already routed, awaiting pickup
                continue
            if req.deadline_at is not None and now > req.deadline_at:
                self._fault_request(req, "deadline")
                continue
            if now < item.ready_at:
                keep.append(item)    # backoff not elapsed
                continue
            weight = int(req.prompt.size) + req.max_new_tokens
            rep = self.router.route(req.rid, tokens=weight)
            if rep is None:
                if self.router.enabled_count() == 0:
                    cand = self._respawn_candidate()
                    if cand is not None:
                        self._respawn(cand)
                        rep = self.router.route(req.rid, tokens=weight)
                    if rep is None:
                        self._fault_request(req, "no_live_replicas")
                        continue
                else:
                    item.ready_at = now + self.health.interval_s
                    keep.append(item)
                    continue
            # hand to the worker via _picked + the failover line (the
            # worker's pick loop collects it under this same lock, so a
            # respawned worker cannot observe an empty line and retire
            # before this append lands)
            self._picked[req.rid] = rep.replica_id
            keep.append(item)
            self._cv.notify_all()
        self._pending_failover[:] = keep

    def _respawn_candidate(self) -> Optional[int]:
        """(under _cv) Lowest cleanly-drained replica, or None.  Only
        ``drained`` DEADs qualify: their engine was left empty by a
        cleanly exiting sole owner, so a fresh thread can take it over
        without ever sharing it."""
        for idx in range(len(self.engines)):
            if (self._state[idx] is ReplicaState.DEAD
                    and self._reason[idx] == "drained"):
                return idx
        return None

    def _respawn(self, idx: int) -> None:
        """(under _cv) Bring a cleanly-drained replica back to absorb
        failover work no other replica can take."""
        self._generation[idx] += 1
        self._state[idx] = ReplicaState.LIVE
        self._reason[idx] = None
        self.router.enable(idx)
        self._set_state_gauge(idx)
        self._spawn_worker(idx)

    # -- convenience --------------------------------------------------------

    def run(self, requests: Sequence[Request] = (),
            request_queue: Optional[RequestQueue] = None
            ) -> Dict[int, RequestResult]:
        """Serve ``requests`` (and/or a client-facing queue) to
        completion and return {rid: RequestResult}."""
        self.start()
        for r in requests:
            self.submit(r)
        if request_queue is not None:
            while not request_queue.exhausted:
                for r in request_queue.drain():
                    self.submit(r)
                time.sleep(0.0005)
        self.close()
        self.join()
        return self.results()

    def results(self) -> Dict[int, RequestResult]:
        with self._cv:
            return dict(self._results)

    def loads(self) -> Dict[int, int]:
        with self._cv:
            return self.router.loads()

    _LATENCY_HISTS = (("queue_wait", "request_queue_wait_s"),
                      ("ttft", "request_ttft_s"),
                      ("tpot", "request_tpot_s"),
                      ("e2e", "request_e2e_s"))

    def metrics(self) -> Dict[str, object]:
        """Structured cluster metrics:

        ``{"aggregate": {"counters": {...}, "latency": {ttft: {p50, p95,
        p99, ...}, ...}}, "per_replica": {i: engine.metrics_snapshot()},
        "health": {i: {state, reason, generation, dispatches,
        beat_age_s}}, "failover": {...}}``

        Aggregate counters are sums; aggregate latency histograms are
        bucket-merges of every replica's histogram (same fixed bounds),
        so the percentiles are cluster-wide, not averages of averages."""
        per: Dict[int, Dict[str, object]] = {}
        counters: Dict[str, int] = {}
        for i, e in enumerate(self.engines):
            snap = e.metrics_snapshot()
            per[i] = snap
            for k, v in snap["counters"].items():
                counters[k] = counters.get(k, 0) + v
        reg = self.telemetry.registry
        latency = {k: reg.merged_histogram(name).snapshot()
                   for k, name in self._LATENCY_HISTS}
        with self._cv:
            now = time.monotonic()
            health = {i: {"state": self._state[i].value,
                          "reason": self._reason[i],
                          "generation": self._generation[i],
                          "dispatches": self._dispatches[i],
                          "beat_age_s": (now - self._beat[i]
                                         if i in self._beat else None)}
                      for i in range(len(self.engines))}
            failover = {"failovers": int(self._failovers.value),
                        "redispatched": int(self._redispatched.value),
                        "shed": int(self._shed.value),
                        "forced_drains": int(self._forced_drains.value),
                        "pending": len(self._pending_failover)}
        return {"aggregate": {"counters": counters, "latency": latency},
                "per_replica": per, "health": health, "failover": failover}

    def write_trace(self, path: str) -> None:
        """Export the span timeline as Chrome ``trace_event`` JSON
        (open in Perfetto / chrome://tracing)."""
        self.telemetry.write_trace(path)

    def write_metrics(self, path: str) -> None:
        """Write the full registry snapshot plus the structured
        :meth:`metrics` breakdown as one JSON document."""
        doc = {"snapshot": self.telemetry.registry.snapshot(),
               "metrics": self.metrics()}
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, default=float)
