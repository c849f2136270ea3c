# A copy of repro/serve/scheduler.py: the port keeps its own copy so that it
# imports nothing of the JAX package.
"""Admission / preemption policy and the client-facing request queue.

Policy (paper-shaped): LSGD hides slow communication under other work;
here the same discipline hides host-side request ingestion under device
decode.  Clients submit through a ``RequestQueue`` (the ``HostLoader``
pattern from ``repro.data.pipeline``: bounded queue, race-free close,
context manager) while the engine loop stays on-device; each engine
iteration the FCFS scheduler grants at most ``prefill_token_budget``
prompt tokens of prefill work so ongoing decodes are never starved by a
long prompt — the serving analogue of chunked gradient sync.

With ``steps_per_dispatch = N > 1`` an engine "iteration" is one
dispatch boundary: ``schedule()`` is consulted every boundary, and a
boundary where it grants prefill work runs as a single fused step while
decode-only boundaries run N steps on device.  Waiting requests
therefore see admission latency quantized to N decode tokens — the
deliberate trade the depth-N pipeline makes (the same policy invariants
hold; nothing here is per-token).
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Sequence

import numpy as np

from repro_torch.serve.kv_cache import PagedKVCache

_RID = itertools.count()


@dataclass(eq=False)        # identity equality: prompt is an ndarray
class Request:
    """One generation request.  ``prompt`` is a 1-D int32 token array
    (tokenization happens host-side, overlapped with device decode).

    Deadlines are *budgets* (seconds, relative): ``queue_deadline_s``
    bounds the wait until FIRST admission to an engine slot,
    ``deadline_s`` bounds submit-to-last-token.  ``start_clock`` arms
    them once into absolute ``time.monotonic`` instants; the absolute
    instants — not the budgets — are what failover re-dispatch carries
    across replicas, so dying replicas never extend a deadline."""
    prompt: np.ndarray
    max_new_tokens: int
    rid: int = field(default_factory=lambda: next(_RID))
    arrival_time: float = 0.0
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None        # e2e budget, submit->done
    queue_deadline_s: Optional[float] = None  # wait budget, submit->admit

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # preemption folds generated tokens into the prompt (recompute
        # mode); this remembers where the user's prompt actually ended
        self.orig_prompt_len = int(self.prompt.size)
        self.deadline_at: Optional[float] = None
        self.queue_deadline_at: Optional[float] = None

    def start_clock(self, now: Optional[float] = None) -> None:
        """Arm the absolute deadlines (first caller wins — the budgets
        count from first submission and survive re-dispatch)."""
        if now is None:
            now = time.monotonic()
        if self.deadline_s is not None and self.deadline_at is None:
            self.deadline_at = now + self.deadline_s
        if self.queue_deadline_s is not None \
                and self.queue_deadline_at is None:
            self.queue_deadline_at = now + self.queue_deadline_s


class RequestQueue:
    """Thread-safe bounded handoff from client threads to the engine.

    Same shutdown discipline as ``HostLoader``: ``close()`` must not lose
    the producer mid-``put`` — consumers keep draining until producers
    observe the closed flag, and submitting after close raises instead of
    deadlocking.
    """

    def __init__(self, maxsize: int = 0):
        self._q: "queue.Queue[Request]" = queue.Queue(maxsize=maxsize)
        self._closed = threading.Event()

    def submit(self, req: Request, timeout: Optional[float] = None) -> None:
        if self._closed.is_set():
            raise RuntimeError("submit() on a closed RequestQueue")
        self._q.put(req, timeout=timeout)

    def drain(self) -> List[Request]:
        """Everything currently queued, without blocking."""
        out: List[Request] = []
        try:
            while True:
                out.append(self._q.get_nowait())
        except queue.Empty:
            pass
        return out

    def close(self) -> None:
        self._closed.set()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    @property
    def empty(self) -> bool:
        return self._q.empty()

    @property
    def exhausted(self) -> bool:
        return self._closed.is_set() and self._q.empty()

    def __enter__(self) -> "RequestQueue":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


@dataclass
class PrefillChunk:
    """Run prompt tokens [start, start+length) of ``req`` this step."""
    req: Request
    start: int
    length: int


class Scheduler:
    """FCFS continuous-batching scheduler.

    ``schedule()`` is called once per engine iteration and returns the
    prefill work for this step.  Invariants (tested):
      * granted prefill tokens per step  <= prefill_token_budget
      * admissions are FCFS; a request is only admitted when a decode
        slot is free and the pool can hold its first chunk
      * preempted requests go back to the *front* of the waiting line
        (they were admitted first) with generated tokens folded into the
        prompt, so greedy recompute resumes identically.
    """

    def __init__(self, max_batch: int, prefill_chunk: int,
                 prefill_token_budget: int,
                 max_chunks_per_step: Optional[int] = None):
        if prefill_chunk > prefill_token_budget:
            raise ValueError("prefill_chunk cannot exceed the step budget")
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.prefill_token_budget = prefill_token_budget
        # the engine fuses a step's chunks into one fixed-row model call;
        # never grant more chunks than it has rows
        self.max_chunks_per_step = (max_chunks_per_step
                                    or prefill_token_budget // prefill_chunk)
        self.waiting: Deque[Request] = deque()
        self.prefilling: List[Request] = []   # admitted, prompt not done
        self._progress = {}                   # rid -> tokens prefilled
        self._m: Optional[dict] = None

    def attach_metrics(self, registry, **labels) -> None:
        """Wire queue-depth / admission metrics into a
        :class:`repro_torch.serve.telemetry.MetricsRegistry`.  Optional: with
        no registry attached the scheduler is metrics-free."""
        self._m = {
            "waiting": registry.gauge("sched_waiting", **labels),
            "prefilling": registry.gauge("sched_prefilling", **labels),
            "admitted": registry.counter("sched_admitted", **labels),
        }

    def add(self, req: Request) -> None:
        self.waiting.append(req)

    def add_front(self, req: Request) -> None:
        self.waiting.appendleft(req)

    def progress_of(self, req: Request) -> int:
        return self._progress.get(req.rid, 0)

    def schedule(self, active_slots: int, kv: PagedKVCache
                 ) -> List[PrefillChunk]:
        """Plan this step's prefill work.  ``active_slots`` counts decode
        slots already occupied (running + mid-prefill)."""
        budget = self.prefill_token_budget
        plan: List[PrefillChunk] = []

        # 1. continue prompts already admitted (FCFS among them)
        for req in list(self.prefilling):
            if budget <= 0 or len(plan) >= self.max_chunks_per_step:
                break
            done = self._progress[req.rid]
            length = min(self.prefill_chunk, len(req.prompt) - done, budget)
            if length <= 0:
                continue
            if not kv.ensure_capacity(req.rid, done + length,
                                      query_start=done):
                continue                      # pool full; retry next step
            plan.append(PrefillChunk(req, done, length))
            self._progress[req.rid] += length
            budget -= length
            if self._progress[req.rid] >= len(req.prompt):
                self.prefilling.remove(req)

        # 2. admit new requests while slots + budget + blocks allow
        # (active_slots already counts mid-prefill sequences — the engine
        # assigns a slot at admission)
        admitted = 0
        while (self.waiting and budget > 0
               and len(plan) < self.max_chunks_per_step
               and active_slots + admitted < self.max_batch):
            req = self.waiting[0]
            length = min(self.prefill_chunk, len(req.prompt), budget)
            self._progress[req.rid] = 0
            if not kv.ensure_capacity(req.rid, length):
                del self._progress[req.rid]
                break                         # FCFS: don't skip the head
            self.waiting.popleft()
            plan.append(PrefillChunk(req, 0, length))
            self._progress[req.rid] = length
            budget -= length
            admitted += 1
            if length < len(req.prompt):
                self.prefilling.append(req)
        assert sum(c.length for c in plan) <= self.prefill_token_budget
        if self._m is not None:
            self._m["waiting"].set(len(self.waiting))
            self._m["prefilling"].set(len(self.prefilling))
            if admitted:
                self._m["admitted"].inc(admitted)
        return plan

    def preempt(self, req: Request, generated: Sequence[int]) -> Request:
        """Victim goes back to the head of the line in recompute mode:
        its generated tokens become prompt suffix, so when readmitted the
        (greedy) continuation is bit-identical."""
        self.prefilling = [r for r in self.prefilling if r.rid != req.rid]
        self._progress.pop(req.rid, None)
        req.prompt = np.concatenate(
            [req.prompt, np.asarray(generated, np.int32)])
        req.max_new_tokens -= len(generated)
        self.add_front(req)
        return req

    def forget(self, req: Request) -> None:
        """Drop ``req``'s admission bookkeeping (prefill progress and,
        if mid-prompt, its place in the prefilling line) — eviction for
        any terminal reason, not just completion."""
        self._progress.pop(req.rid, None)
        self.prefilling = [r for r in self.prefilling if r.rid != req.rid]

    def expire(self, now: float) -> List[Request]:
        """Remove and return waiting-line requests whose queue-wait or
        e2e deadline has passed.  Only the *never-admitted* wait is
        policed here: a preempted request re-enters this line but its
        ``queue_deadline_at`` was cleared at first admission (the queue
        budget bounds time-to-first-slot, not recompute churn); its e2e
        deadline still applies."""
        expired = [r for r in self.waiting
                   if (r.queue_deadline_at is not None
                       and now > r.queue_deadline_at)
                   or (r.deadline_at is not None and now > r.deadline_at)]
        if expired:
            gone = {r.rid for r in expired}
            self.waiting = deque(r for r in self.waiting
                                 if r.rid not in gone)
            for r in expired:
                self._progress.pop(r.rid, None)
        return expired

    def reset(self) -> List[Request]:
        """Drop ALL scheduler state and return the requests that were
        waiting (incl. mid-prefill admissions the engine evicts
        separately) — the post-mortem reclaim path."""
        out = list(self.waiting)
        self.waiting.clear()
        self.prefilling = []
        self._progress.clear()
        return out

    def planned(self, req: Request) -> bool:
        """Whether ``req`` still has prefill progress on the books — False
        once it is preempted or forgotten.  The engine uses this to drop
        chunks from an already-planned step whose owner a preemption
        evicted between ``schedule()`` and dispatch."""
        return req.rid in self._progress

    @property
    def has_waiting(self) -> bool:
        return bool(self.waiting) or bool(self.prefilling)


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """Arrival timestamps for an open-loop Poisson workload (bench +
    tests share this so the workload is reproducible)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return start + np.cumsum(gaps)
