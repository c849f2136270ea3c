# A copy of repro/serve/telemetry.py: the port keeps its own copy so that it
# imports nothing of the JAX package.
"""Serving telemetry: metrics registry, request lifecycle tracing, and
Chrome-trace dispatch timelines.

The LSGD paper's central claim is a *timing* claim — slow communication
hidden under other work — and the serving stack makes the same claim
about host scheduling hidden under device dispatch.  This module is how
that claim stops being an argument and becomes a measurement:

  * ``MetricsRegistry`` — typed counters, gauges, and fixed-bucket
    histograms with labels (``replica``, ``arch``, ``phase``).  Handles
    are plain Python objects with attribute arithmetic on the hot path
    (no dict lookup, no lock, no device sync); creation is locked and
    get-or-create, so any component can ask for the same metric and get
    the same handle.  ``registry.snapshot()`` renders everything into a
    JSON-ready dict with p50/p95/p99 for every histogram.
  * ``TraceBook`` — per-request lifecycle records stamped at
    submit → route → admit → first prefill chunk → first token →
    complete/cancel, with repeatable preempt/dispatch marks.  A record
    reaches exactly ONE terminal event (double terminals are counted,
    never silently merged — the invariant tests assert the counter is
    zero); ``finish()`` derives queue-wait, TTFT, per-output-token
    latency (TPOT), and end-to-end into registry histograms.
  * ``SpanTracer`` — span timelines exported as Chrome ``trace_event``
    JSON (``{"traceEvents": [...]}``), one track per replica worker
    thread plus router/dispatcher tracks; ``serve_bench --trace out``
    opens in Perfetto / chrome://tracing and shows the overlap story:
    host ``plan``/``dispatch``/``fetch`` spans running UNDER the device
    track's dispatch windows.  Tracing is opt-in: when ``enabled`` is
    False every call returns before touching a clock.
  * ``JsonlMetricsWriter`` — a periodic snapshot thread appending one
    JSON object per line, for long-running serves.

Cost discipline: counters/gauges are always on (attribute adds on
host-side ints); histograms observe once per request or per dispatch,
never per token; lifecycle stamps are per-request dict writes; span
tracing touches ``time.perf_counter`` only when enabled.  Nothing here
ever forces a device sync — timestamps are taken at host events the
engine already passes through.
"""
from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left
from typing import Dict, IO, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RequestTrace",
    "TraceBook", "SpanTracer", "Telemetry", "JsonlMetricsWriter",
    "DEFAULT_LATENCY_BUCKETS",
]

# Fixed log-spaced latency buckets in SECONDS: 100 us .. 2 min, the span
# from a single tiny-model decode dispatch to a long-form generation on
# a throttled CPU host.  Fixed buckets keep ``observe`` O(log n) with no
# allocation and make histograms mergeable across replicas.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


class Counter:
    """Monotonic counter.  ``inc`` is a plain attribute add — each handle
    has one writer (its component's thread), so no lock; snapshot reads
    from other threads are torn-free under the GIL."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time value (pool free depth, live sequences, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n

    def reset(self) -> None:
        self.value = 0


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max and
    bucket-interpolated percentiles.

    ``bounds[i]`` is the inclusive upper edge of bucket ``i``; one
    overflow bucket catches everything past the last edge.  Percentiles
    interpolate linearly inside the covering bucket, clamped to the
    observed min/max so a single observation reports itself exactly.
    The invariant the tests pin: ``sum(bucket_counts) == count``."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.bounds: Tuple[float, ...] = tuple(buckets)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram buckets must be sorted and unique")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def merge(self, other: "Histogram") -> None:
        """Fold ``other`` in (same bucket layout required) — how
        per-replica histograms become a cluster aggregate."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different buckets")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def percentile(self, q: float) -> float:
        """q in [0, 1]; 0.0 with no observations."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo, hi = max(lo, self.min), min(max(hi, lo), self.max)
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.max

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count, "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": (self.sum / self.count) if self.count else 0.0,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


def _render(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """Process-wide get-or-create registry of labeled metric handles.

    One registry per serving frontend (``ServeCluster`` shares one
    across its replicas; a standalone ``Engine`` makes its own).
    Creation is locked; the handles themselves are lock-free — each is
    written by one component thread and read by snapshots."""

    _KINDS = ("counter", "gauge", "histogram")

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, Tuple[Tuple[str, str], ...]],
                            object] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, object], factory):
        key = (kind, name,
               tuple(sorted((k, str(v)) for k, v in labels.items())))
        got = self._metrics.get(key)
        if got is not None:
            return got
        with self._lock:
            return self._metrics.setdefault(key, factory())

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets))

    def histograms_named(self, name: str) -> List[Histogram]:
        """Every labeled variant of histogram ``name`` (for merging a
        cluster aggregate out of per-replica histograms)."""
        return [h for (kind, n, _), h in list(self._metrics.items())
                if kind == "histogram" and n == name]

    def merged_histogram(self, name: str) -> Histogram:
        parts = self.histograms_named(name)
        out = Histogram(parts[0].bounds if parts else
                        DEFAULT_LATENCY_BUCKETS)
        for h in parts:
            out.merge(h)
        return out

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-ready view: ``{"counters": {...}, "gauges": {...},
        "histograms": {rendered_name: {count, sum, p50, p95, p99, ...}}}``.
        Keys render labels Prometheus-style: ``name{k=v,...}``."""
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for (kind, name, labels), h in sorted(self._metrics.items()):
            rname = _render(name, labels)
            if kind == "counter":
                out["counters"][rname] = h.value
            elif kind == "gauge":
                out["gauges"][rname] = h.value
            else:
                out["histograms"][rname] = h.snapshot()
        return out


# ---------------------------------------------------------------------------
# per-request lifecycle tracing
# ---------------------------------------------------------------------------

# single-stamp events (first stamp wins — a preempted request's re-admit
# must not move its queue-wait), the repeatable ``retry`` mark, and the
# three terminal kinds.  ``fault`` is the failure terminal: deadline
# blown, poison quarantine, or no live replica left to serve on.
LIFECYCLE_EVENTS = ("submit", "route", "admit", "prefill_start",
                    "first_token", "retry", "complete", "cancel", "fault")
TERMINAL_EVENTS = ("complete", "cancel", "fault")


class RequestTrace:
    """One request's lifecycle record: single-stamp event timestamps
    plus repeatable preempt/dispatch counts."""

    __slots__ = ("rid", "stamps", "preemptions", "dispatches", "retries",
                 "tokens", "replica", "terminal")

    def __init__(self, rid: int):
        self.rid = rid
        self.stamps: Dict[str, float] = {}
        self.preemptions = 0
        self.dispatches = 0
        self.retries = 0
        self.tokens = 0
        self.replica: Optional[int] = None
        self.terminal: Optional[str] = None

    def as_dict(self) -> Dict[str, object]:
        return {"rid": self.rid, "stamps": dict(self.stamps),
                "preemptions": self.preemptions,
                "dispatches": self.dispatches, "retries": self.retries,
                "tokens": self.tokens,
                "replica": self.replica, "terminal": self.terminal}


class LatencyHists:
    """The four derived-latency histograms one engine observes into,
    pre-created so ``finish()`` costs four ``observe`` calls and zero
    registry lookups."""

    __slots__ = ("queue_wait", "ttft", "tpot", "e2e")

    def __init__(self, registry: MetricsRegistry, **labels):
        self.queue_wait = registry.histogram("request_queue_wait_s",
                                             **labels)
        self.ttft = registry.histogram("request_ttft_s", **labels)
        self.tpot = registry.histogram("request_tpot_s", **labels)
        self.e2e = registry.histogram("request_e2e_s", **labels)


class TraceBook:
    """Lifecycle records for every request a frontend has seen.

    Thread-safe: the dispatcher stamps submit/route while replica worker
    threads stamp admit/first_token/terminal.  Invariants the tests pin:
    every submitted rid reaches exactly one terminal event
    (``double_terminals == 0``), single-stamp events keep their first
    timestamp, stamps are monotonically consistent (TTFT <= e2e by
    construction: both measured from the same submit stamp)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._lock = threading.Lock()
        self._traces: Dict[int, RequestTrace] = {}
        self.double_terminals = registry.counter("trace_double_terminals")
        self._completed = registry.counter("requests_completed")
        self._cancelled = registry.counter("requests_cancelled")
        self._faulted = registry.counter("requests_faulted")
        self._retried = registry.counter("requests_retried")

    def _trace(self, rid: int) -> RequestTrace:
        got = self._traces.get(rid)
        if got is not None:
            return got
        with self._lock:
            return self._traces.setdefault(rid, RequestTrace(rid))

    def stamp(self, rid: int, event: str, t: Optional[float] = None) -> None:
        """Record ``event`` for ``rid`` at ``t`` (default: now).  First
        stamp wins for repeat calls — re-admission after preemption must
        not move the original admit time.  A terminal closes the record:
        stamps arriving after it are dropped, so derived latencies can
        never run past the terminal timestamp."""
        tr = self._trace(rid)
        if tr.terminal is not None:
            return
        tr.stamps.setdefault(event, time.perf_counter() if t is None else t)

    def note_preempt(self, rid: int) -> None:
        self._trace(rid).preemptions += 1

    def note_dispatch(self, rid: int) -> None:
        self._trace(rid).dispatches += 1

    def note_retry(self, rid: int, cause: str = "") -> None:
        """Failover re-dispatch mark (repeatable): the attempt count on
        the trace plus a cause-labeled counter — and deliberately NOT a
        second ``route``/``admit`` stamp.  Single-stamp events keep
        their first timestamp, so queue-wait and TTFT stay measured
        from the ORIGINAL admission; a retried request's extra latency
        shows up where it belongs, in e2e, not as a double-counted
        TTFT."""
        tr = self._trace(rid)
        if tr.terminal is not None:
            return
        tr.retries += 1
        self._retried.inc()
        if cause:
            self.registry.counter("requests_retried", cause=cause).inc()

    def finish(self, rid: int, kind: str, tokens: int = 0,
               replica: Optional[int] = None,
               hists: Optional[LatencyHists] = None,
               t: Optional[float] = None) -> Optional[RequestTrace]:
        """Terminal event (``complete`` / ``cancel`` / ``fault``): stamp
        it, derive the latency metrics into ``hists``, and return the
        trace.  A second terminal for the same rid is refused (returns
        None) and counted in ``trace_double_terminals`` — the invariant
        failover leans on: a re-dispatched request completes exactly
        once no matter how many replicas died under it."""
        if kind not in TERMINAL_EVENTS:
            raise ValueError(f"not a terminal event: {kind!r}")
        now = time.perf_counter() if t is None else t
        tr = self._trace(rid)
        with self._lock:
            if tr.terminal is not None:
                self.double_terminals.inc()
                return None
            tr.terminal = kind
        tr.stamps[kind] = now
        tr.tokens = tokens
        tr.replica = replica
        {"complete": self._completed, "cancel": self._cancelled,
         "fault": self._faulted}[kind].inc()
        if hists is not None and kind == "complete":
            submit = tr.stamps.get("submit")
            admit = tr.stamps.get("admit")
            first = tr.stamps.get("first_token")
            # each latency is derived only when its stamps are ordered
            # the way the lifecycle orders them (the engine guarantees
            # it; a malformed external caller must not poison the
            # histograms with negative observations)
            if submit is not None and now >= submit:
                hists.e2e.observe(now - submit)
                if admit is not None and admit >= submit:
                    hists.queue_wait.observe(admit - submit)
                if first is not None and first >= submit:
                    hists.ttft.observe(first - submit)
            if first is not None and now >= first and tokens > 1:
                hists.tpot.observe((now - first) / (tokens - 1))
        return tr

    def traces(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._traces.values())

    def get(self, rid: int) -> Optional[RequestTrace]:
        return self._traces.get(rid)


# ---------------------------------------------------------------------------
# Chrome trace_event span timelines
# ---------------------------------------------------------------------------


class SpanTracer:
    """Complete-span ("ph": "X") Chrome trace_event collector.

    Tracks (one ``tid`` each, named via metadata events) are allocated
    on first use; the convention the serving stack uses is
    ``replica{i}/host`` (the worker thread: plan/dispatch/fetch spans),
    ``replica{i}/device`` (dispatch-to-fetch windows — the host-observed
    envelope of device execution), and ``dispatcher`` (routing).  All
    timestamps are ``time.perf_counter`` seconds, rebased to the
    tracer's construction so Perfetto timelines start near zero.

    When ``enabled`` is False every method is a cheap early return —
    the engine guards its ``perf_counter`` calls on this flag too, so
    tracing off means tracing free."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._t0 = time.perf_counter()
        self._events: List[Dict[str, object]] = []
        self._tids: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is not None:
            return tid
        with self._lock:
            if track not in self._tids:
                tid = len(self._tids)
                self._tids[track] = tid
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                    "ts": 0, "args": {"name": track}})
            return self._tids[track]

    def span(self, track: str, name: str, t0: float, t1: float,
             args: Optional[Dict[str, object]] = None) -> None:
        """One complete span on ``track`` over ``[t0, t1]`` perf_counter
        seconds.  Spans on one track should be disjoint or properly
        nested (the Chrome renderer assumes it; the invariant tests
        enforce it) — callers tracking an async resource serialize their
        spans (see ``Engine._dev_tail``)."""
        if not self.enabled:
            return
        self._events.append({
            "name": name, "ph": "X", "pid": 0, "tid": self._tid(track),
            "ts": (t0 - self._t0) * 1e6,
            "dur": max(0.0, (t1 - t0)) * 1e6,
            "args": args or {}})

    def instant(self, track: str, name: str,
                t: Optional[float] = None,
                args: Optional[Dict[str, object]] = None) -> None:
        if not self.enabled:
            return
        t = time.perf_counter() if t is None else t
        self._events.append({
            "name": name, "ph": "i", "pid": 0, "tid": self._tid(track),
            "ts": (t - self._t0) * 1e6, "s": "t", "args": args or {}})

    def events(self) -> List[Dict[str, object]]:
        return list(self._events)

    def export(self) -> Dict[str, object]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)


# ---------------------------------------------------------------------------
# the bundle + periodic JSONL export
# ---------------------------------------------------------------------------


class Telemetry:
    """The per-frontend bundle: one registry, one request trace book,
    one span tracer.  ``ServeCluster`` builds one and hands it to every
    engine (replica-labeled handles keep them apart); a standalone
    ``Engine`` builds its own."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 trace: bool = False,
                 tracer: Optional[SpanTracer] = None):
        self.registry = registry or MetricsRegistry()
        self.tracer = tracer or SpanTracer(enabled=trace)
        self.requests = TraceBook(self.registry)

    def write_trace(self, path: str) -> None:
        self.tracer.write(path)


# analysis: single-writer — the controlling thread is the only mutator
# (_thread/_fh change only in start/stop); the writer thread reads _fh
# strictly between start()'s Thread() launch and stop()'s join(), both
# of which fence the hand-off, and watches only the _stop Event.
class JsonlMetricsWriter:
    """Background thread appending ``registry.snapshot()`` as one JSON
    object per line every ``interval_s`` (plus a final snapshot at
    ``stop()``), timestamped with both wall-clock and perf_counter time.
    Context-manager; close is race-free (the thread observes the stop
    event within one interval)."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float = 1.0):
        self.registry = registry
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fh: Optional[IO[str]] = None

    def _write_one(self) -> None:
        row = {"time": time.time(), "perf_counter": time.perf_counter()}
        row.update(self.registry.snapshot())
        self._fh.write(json.dumps(row, default=float) + "\n")
        self._fh.flush()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write_one()

    def start(self) -> "JsonlMetricsWriter":
        if self._thread is None:
            self._fh = open(self.path, "w")
            self._thread = threading.Thread(
                target=self._run, name="metrics-jsonl", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
            self._write_one()
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlMetricsWriter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
