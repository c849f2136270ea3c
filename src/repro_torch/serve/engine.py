"""Continuous-batching inference engine over a paged KV cache
(``repro/serve/engine.py``), on one device or one tensor-parallel
slice of devices.

Each ``step()`` is one fused ``paged_step`` call carrying mixed
prefill+decode rows, or — with ``steps_per_dispatch = N > 1`` and no
prefill work pending — one ``paged_decode_loop`` dispatch of N decode
steps with per-row stop conditions on the device.  The row layout adapts
to the step (decode buckets, chunk-wide prefill rows, width-1 mixed rows
with prefill chunks split into one row per token, or chunk-wide mixed
rows for families with recurrent state); a per-row ``valid_len`` routes
padded rows' K/V writes to the trash block and their state writes to
the trash slot.  Slot-state families (mamba) hold one state slot per
live sequence (``StateSlotAllocator``, slot 0 the trash), taken at
admission and given back at eviction and preemption.
Sampling happens on the device (greedy, or temperature / top-k with
per-row keys ``fold_in(fold_in(seed, rid), position)``, so a token's
draw does not depend on the dispatch depth), and a device-resident
per-slot token buffer feeds step k's samples into step k+1, so the host
dispatches step k+1 before it reads step k's tokens (depth-1
pipelining): each
dispatch's tokens are copied into pinned host memory behind a CUDA event
at dispatch time, and the fetch waits on that event only.

What the cluster layer (``serve.dispatcher.ServeCluster``) calls on an
engine is here too: request deadlines (``deadline_s`` /
``queue_deadline_s``, enforced at every dispatch boundary with fault
results ``deadline`` / ``queue_deadline``), ``reclaim_requests`` (the
post-mortem salvage of a dead replica) and ``drain_progress`` (tokens
fetched per request, the router's load decay).  On CUDA every engine
owns a stream on each of its devices: construction, ``warmup`` and
``step`` run on them, so the engines of several replicas on one card do
not queue behind each other on the default stream.

A slice of several devices serves tensor-parallel, as the reference's
GSPMD replica does, in one process: the params and the paged pools are
split per ``repro_torch.sharding``'s plan, shard s on ``devices[s]``,
and ``paged_step`` / ``paged_decode_loop`` run over the shards
(``transformer.forward_tp``); the host loop, the block tables and the
token buffers are the one-device engine's, on ``devices[0]``.

Not ported yet (it raises, see ROADMAP.md §1): the unfused
``fused=False`` baseline.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.kv_cache import PagedKVCache, StateSlotAllocator
from repro_torch.serve.scheduler import Request, RequestQueue, Scheduler
from repro_torch.serve.telemetry import LatencyHists, MetricsRegistry, Telemetry
from repro_torch.sharding import shard_params

_STAT_KEYS = ("steps", "decode_steps", "decode_slot_steps",
              "decode_active_slot_steps", "prefill_tokens",
              "generated_tokens", "preemptions", "faulted", "model_calls",
              "host_syncs", "loop_dispatches", "loop_truncations")

_DISPATCH_PHASES = ("prefill", "decode", "mixed", "loop")


class _EngineMetrics:
    """Struct-of-handles for the engine hot path (labels ``replica`` and
    ``arch``)."""

    def __init__(self, registry: MetricsRegistry, **labels):
        for k in _STAT_KEYS:
            setattr(self, k, registry.counter("engine_" + k, **labels))
        # kept for parity with the reference's snapshot: eager PyTorch
        # compiles nothing while serving, so it stays 0
        self.jit_compiles = registry.counter("engine_jit_compiles", **labels)
        self.tp_degree = registry.gauge("engine_tp_degree", **labels)
        self.live_seqs = registry.gauge("engine_live_seqs", **labels)
        self.state_slots_free = registry.gauge("engine_state_slots_free",
                                               **labels)
        self.dispatch_s = {ph: registry.histogram("engine_dispatch_s",
                                                  phase=ph, **labels)
                           for ph in _DISPATCH_PHASES}
        self.latency = LatencyHists(registry, **labels)


@dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8              # decode rows per step
    block_size: int = 16            # tokens per KV block
    num_blocks: int = 257           # pool size incl. trash block 0
    max_seq_len: int = 256          # per-sequence prompt+gen ceiling
    prefill_chunk: int = 32         # tokens per prefill row (padded shape)
    prefill_token_budget: int = 64  # max prefill tokens per engine step
    admission_lookahead: int = 2    # prompts prefilled ahead of a free row
    temperature: float = 0.0        # 0 => greedy (sampled on the device)
    top_k: int = 0                  # 0 => full-vocab temperature sampling
    seed: int = 0
    steps_per_dispatch: int = 1     # decode steps per device dispatch (N)
    fused: bool = True              # only the fused step is ported

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.block_size)

    @property
    def num_slots(self) -> int:
        return self.max_batch + self.admission_lookahead

    @property
    def prefill_rows(self) -> int:
        return max(1, min(self.max_batch,
                          self.prefill_token_budget // self.prefill_chunk))

    @property
    def mixed_buckets(self) -> List[int]:
        full = self.max_batch + self.prefill_token_budget
        half = self.max_batch + max(self.prefill_chunk,
                                    self.prefill_token_budget // 2)
        small = self.max_batch + self.prefill_chunk
        return sorted({full, half, small})

    @property
    def mixed_chunk_rows(self) -> int:
        """Rows of a mixed step of a slot-state family: its prefill chunks
        cannot split into width-1 rows (a token's recurrent state depends
        on the previous token's within the call), so the mixed layout is
        chunk-wide rows, the decode rows riding along at valid_len 1."""
        return self.max_batch + self.prefill_rows

    @property
    def decode_buckets(self) -> List[int]:
        out = []
        b = self.max_batch
        while b >= 1 and len(out) < 3:
            out.append(b)
            b = -(-b // 2) if b > 1 else 0
        return out


@dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: List[int]
    arrival_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    preempted: int = 0
    fault: Optional[str] = None


@dataclass(eq=False)
class _Seq:
    req: Request
    slot: int
    out: List[int] = field(default_factory=list)
    gen_count: int = 0
    first_token_time: float = 0.0
    prefill_done: bool = False
    done: bool = False
    desync: bool = False

    @property
    def next_pos(self) -> int:
        return len(self.req.prompt) + self.gen_count - 1


class _HostCopy:
    """Device tensors on their way to the host: on CUDA the copy into
    pinned memory is queued at dispatch and an event marks its end, so
    ``get()`` waits for this dispatch only, not for later ones."""

    def __init__(self, *tensors: torch.Tensor):
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.clone() for t in tensors]
            self.event = None

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


@dataclass
class _Inflight:
    """One dispatched step whose tokens the host has not read yet: a
    single step carries (rows,) tokens; an N-step loop (rows, N) tokens,
    per-row counts and eos flags, and the per-row steps it planned."""
    copy: _HostCopy
    emits: List[Tuple[int, "_Seq", bool]]
    now: float
    loop: bool = False
    planned: Optional[Dict[int, int]] = None
    t_disp: float = 0.0
    label: str = ""


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("Engine runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return _indexed("cuda")


def _indexed(device) -> torch.device:
    """``device`` as a torch.device, a CUDA one with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md §1)")


# analysis: single-writer — an Engine is thread-confined: one thread
# (the owning ServeCluster worker, or the caller in single-engine use)
# drives warmup/submit/step/drain_progress after construction.
class Engine:
    """Continuous-batching engine on one device (``cuda`` unless the
    caller passes another) or a tensor-parallel slice.

    ``devices`` gives the replica a device slice (one fast-fabric group
    of ``launch.mesh.replica_slices``), as in the reference: one device
    serves alone (``tp_degree`` 1), ``n`` devices serve one engine split
    ``n`` ways (``tp_degree`` n; a slice may name one device more than
    once, which puts several shards on one card).  ``device`` names a
    single device directly."""

    def __init__(self, model, params, cfg: EngineConfig = EngineConfig(),
                 device=None, telemetry: Optional[Telemetry] = None,
                 replica_id: int = 0, devices: Optional[Sequence] = None):
        if model.paged_spec is None:
            raise ValueError(f"{model.cfg.name}: the {model.cfg.family!r} "
                             "family has no paged serving path (whisper "
                             "serves through the static prefill / "
                             "decode_step only, resnet trains only)")
        if cfg.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if not cfg.fused:
            raise _not_ported("the unfused fused=False baseline")
        if devices is not None:
            devices = tuple(_indexed(d) for d in devices)
            if not devices or (device is not None
                               and _indexed(device) != devices[0]):
                raise ValueError(f"devices={devices} and device={device} "
                                 "name no slice")
        else:
            devices = (_indexed(device) if device is not None
                       else _default_device(),)
        self.devices = devices
        self.device = devices[0]
        self.tp_degree = len(devices)
        # one stream per engine and CUDA device; each first waits for the
        # caller's stream there, where the params it is handed were
        # written.  ``stream`` is the one of devices[0]
        self.streams = {}
        for d in dict.fromkeys(devices):
            if d.type == "cuda":
                self.streams[d] = torch.cuda.Stream(d)
                self.streams[d].wait_stream(torch.cuda.current_stream(d))
        self.stream = self.streams.get(self.device)
        with self.on_stream():
            self._build(model, params, cfg, telemetry, replica_id)

    def on_stream(self):
        """Make this engine's streams current on the calling thread (a
        no-op off CUDA).  The kernels launch on the current stream of
        their device, which is per thread."""
        stack = contextlib.ExitStack()
        for st in self.streams.values():
            stack.enter_context(torch.cuda.stream(st))
        return stack

    def _build(self, model, params, cfg, telemetry, replica_id) -> None:
        self.model = model
        self.spec = model.paged_spec
        self.telemetry = telemetry or Telemetry()
        self.replica_id = replica_id
        self._m = _EngineMetrics(self.telemetry.registry,
                                 replica=replica_id, arch=model.cfg.name)
        self._m.tp_degree.set(self.tp_degree)
        self._host_track = f"replica{replica_id}/host"
        self._dev_track = f"replica{replica_id}/device"
        self._dev_tail = 0.0
        self.params = (shard_params(params, model.cfg, self.devices)
                       if self.tp_degree > 1
                       else _to_device(params, self.device))
        self.cfg = cfg
        self._sample_kw = dict(temperature=float(cfg.temperature),
                               top_k=int(cfg.top_k), seed=int(cfg.seed))
        # the host-side block accounting runs for every family: for pure
        # slot-state models (no device block pools) it meters token
        # capacity, so admission and preemption work as for the others
        # (window 0: their "blocks" are tokens)
        self.kv = PagedKVCache(
            cfg.num_blocks, cfg.block_size, cfg.blocks_per_seq,
            window=self.spec.reclaim_window if self.spec.has_blocks else 0)
        self.kv.attach_metrics(self.telemetry.registry,
                               replica=replica_id, arch=model.cfg.name)
        self.scheduler = Scheduler(
            cfg.max_batch + cfg.admission_lookahead, cfg.prefill_chunk,
            cfg.prefill_token_budget, max_chunks_per_step=cfg.prefill_rows)
        self.scheduler.attach_metrics(self.telemetry.registry,
                                      replica=replica_id,
                                      arch=model.cfg.name)
        # one state slot per admittable sequence plus trash slot 0, so a
        # free token-buffer slot implies a free state slot
        self.state_slots = (StateSlotAllocator(cfg.num_slots + 1)
                            if self.spec.has_state else None)
        if self.state_slots is not None:
            self._m.state_slots_free.set(self.state_slots.num_free)
        self.cache = model.init_paged_cache(
            cfg.num_blocks, cfg.block_size,
            num_state_slots=cfg.num_slots + 1, device=self.device,
            devices=self.devices)
        self._slot_buf = torch.zeros((cfg.num_slots + 1,), dtype=torch.int32,
                                     device=self.device)
        self._free_slots: List[int] = list(range(cfg.num_slots - 1, -1, -1))
        self._live: List[_Seq] = []
        self._pending: Deque[_Inflight] = deque()
        self._desynced: List[_Seq] = []
        self._preempt_counts: Dict[int, int] = {}
        self._first_token_times: Dict[int, float] = {}
        # tokens fetched per request since the last drain_progress: the
        # dispatcher turns them into router progress
        self._progress_tokens: Dict[int, int] = {}
        # the deadline sweep runs only once a request with a budget came
        self._has_deadlines = False

    # -- metrics ------------------------------------------------------------

    def metrics_snapshot(self) -> Dict[str, object]:
        m = self._m
        counters = {k: int(getattr(m, k).value) for k in _STAT_KEYS}
        counters["jit_compiles"] = int(m.jit_compiles.value)
        return {"counters": counters,
                "latency": {"queue_wait": m.latency.queue_wait.snapshot(),
                            "ttft": m.latency.ttft.snapshot(),
                            "tpot": m.latency.tpot.snapshot(),
                            "e2e": m.latency.e2e.snapshot()},
                "dispatch_s": {ph: h.snapshot()
                               for ph, h in m.dispatch_s.items()
                               if h.count}}

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new_tokens={total} exceeds "
                f"max_seq_len={self.cfg.max_seq_len}")
        # first-wins no-ops when the dispatcher stamped and armed the
        # request at the cluster's front door (a re-dispatch after a
        # replica death keeps the original absolute deadlines)
        self.telemetry.requests.stamp(req.rid, "submit")
        req.start_clock()
        if req.deadline_at is not None or req.queue_deadline_at is not None:
            self._has_deadlines = True
        self.scheduler.add(req)

    # -- internals ----------------------------------------------------------

    def _seq_of(self, rid: int) -> Optional[_Seq]:
        for s in self._live:
            if s.req.rid == rid:
                return s
        return None

    def _slot_of(self, rid: Optional[int]) -> int:
        """The state slot of ``rid`` (trash slot 0 for None, and for
        every row of a family without recurrent state)."""
        return (self.state_slots.slot_of(rid)
                if self.state_slots is not None else 0)

    def _free_state_slot(self, rid: int) -> None:
        if self.state_slots is not None:
            self.state_slots.free_if_held(rid)
            self._m.state_slots_free.set(self.state_slots.num_free)

    def _admit(self, req: Request) -> _Seq:
        seq = _Seq(req, slot=self._free_slots.pop())
        if self.state_slots is not None:
            if self.state_slots.alloc(req.rid) is None:
                raise RuntimeError("state-slot pool exhausted despite a "
                                   "free token-buffer slot (engine bug)")
            self._m.state_slots_free.set(self.state_slots.num_free)
        self._live.append(seq)
        req.queue_deadline_at = None
        self.telemetry.requests.stamp(req.rid, "admit")
        self._m.live_seqs.set(len(self._live))
        return seq

    def _evict(self, seq: _Seq, now: float,
               finished: List[RequestResult]) -> None:
        self._live.remove(seq)
        self._free_slots.append(seq.slot)
        self.kv.free_seq(seq.req.rid)
        self._free_state_slot(seq.req.rid)
        self.scheduler.forget(seq.req)
        self._first_token_times.pop(seq.req.rid, None)
        # a preempted request's earlier tokens live in its recompute
        # prompt suffix: stitch the generation back together
        regen = list(seq.req.prompt[seq.req.orig_prompt_len:])
        finished.append(RequestResult(
            rid=seq.req.rid, prompt_len=seq.req.orig_prompt_len,
            tokens=regen + list(seq.out),
            arrival_time=seq.req.arrival_time,
            first_token_time=seq.first_token_time, finish_time=now,
            preempted=self._preempt_counts.pop(seq.req.rid, 0)))
        self._m.live_seqs.set(len(self._live))
        self.telemetry.requests.finish(
            seq.req.rid, "complete", tokens=len(regen) + len(seq.out),
            replica=self.replica_id, hists=self._m.latency)

    def _preempt_seq(self, victim: _Seq) -> None:
        """Send ``victim`` back to the waiting line (recompute mode).  The
        caller has flushed in-flight steps: preemption folds the victim's
        generated tokens into its prompt."""
        assert not self._pending
        self._live.remove(victim)
        self._free_slots.append(victim.slot)
        self.kv.free_seq(victim.req.rid)
        # the victim's state stays behind in its freed slot: recompute
        # replays the prompt, and pos == 0 on its first chunk reads zeros
        self._free_state_slot(victim.req.rid)
        self.scheduler.preempt(victim.req, victim.out)
        rid = victim.req.rid
        if victim.prefill_done:
            self._first_token_times[rid] = victim.first_token_time
        self._preempt_counts[rid] = self._preempt_counts.get(rid, 0) + 1
        self._m.preemptions.inc()
        self.telemetry.requests.note_preempt(rid)
        self._m.live_seqs.set(len(self._live))

    def _preempt_one(self, exclude_rid: int) -> bool:
        """Preempt the most recently admitted live sequence (LIFO)."""
        for victim in reversed(self._live):
            if victim.req.rid == exclude_rid or victim.done:
                continue
            self._preempt_seq(victim)
            return True
        return False

    # -- fault terminals / deadline enforcement -----------------------------

    def _fault_result(self, req: Request, reason: str, out: Sequence[int],
                      first_token_time: float = 0.0,
                      finished: Optional[List[RequestResult]] = None
                      ) -> RequestResult:
        """End a request with a fault verdict (``deadline``,
        ``queue_deadline``): its partial output (recompute-prompt suffix
        and host tokens), the ``fault`` terminal, the count."""
        regen = list(req.prompt[req.orig_prompt_len:])
        res = RequestResult(
            rid=req.rid, prompt_len=req.orig_prompt_len,
            tokens=regen + list(out), arrival_time=req.arrival_time,
            first_token_time=first_token_time,
            finish_time=time.perf_counter(),
            preempted=self._preempt_counts.pop(req.rid, 0), fault=reason)
        self._m.faulted.inc()
        self.telemetry.requests.finish(
            req.rid, "fault", tokens=len(res.tokens),
            replica=self.replica_id)
        if finished is not None:
            finished.append(res)
        return res

    def _evict_fault(self, seq: _Seq, reason: str,
                     finished: List[RequestResult]) -> None:
        """``_evict`` with a fault verdict.  The caller has flushed the
        in-flight steps, so ``seq.out`` holds every token."""
        assert not self._pending
        self._live.remove(seq)
        self._free_slots.append(seq.slot)
        self.kv.free_seq(seq.req.rid)
        self._free_state_slot(seq.req.rid)
        self.scheduler.forget(seq.req)
        self._first_token_times.pop(seq.req.rid, None)
        self._fault_result(seq.req, reason, seq.out,
                           first_token_time=seq.first_token_time,
                           finished=finished)
        self._m.live_seqs.set(len(self._live))

    def _expire_deadlines(self, finished: List[RequestResult]) -> None:
        """Queue-wait and e2e budgets at the dispatch boundary: a waiting
        request past either ends with no tokens; a live sequence past its
        e2e deadline is flushed first, so its partial output lands in the
        fault result."""
        mono = time.monotonic()
        for req in self.scheduler.expire(mono):
            # a refused first-chunk admission can leave an empty table
            self.kv.free_seq(req.rid)
            reason = ("queue_deadline"
                      if req.queue_deadline_at is not None
                      and mono > req.queue_deadline_at else "deadline")
            self._fault_result(req, reason, (), finished=finished)
        expired = [s for s in self._live
                   if not s.done and s.req.deadline_at is not None
                   and mono > s.req.deadline_at]
        if expired:
            self._flush(finished)
            for seq in expired:
                if seq in self._live and not seq.done:
                    self._evict_fault(seq, "deadline", finished)

    # -- post-mortem reclaim ------------------------------------------------

    def reclaim_requests(self) -> Tuple[List[Request], List[RequestResult]]:
        """Empty this engine and hand its requests back for re-dispatch:
        the failover path once the replica's worker died.  Call it only
        after the owning thread stopped driving the engine.

        In-flight dispatches are dropped unread; the sampling keys are
        ``fold_in(rid, position)``, so a re-dispatch regenerates their
        tokens.  On CUDA the engine's streams are synchronised first, so
        no dispatch still running writes into a pinned buffer dropped
        here.
        Each live sequence's host tokens fold into its prompt (recompute,
        as preemption); sequences already finished (eos on the host, or
        their budget spent) come back as results.  Returns
        ``(requests_to_redispatch, finished_results)``."""
        for st in self.streams.values():
            st.synchronize()
        requests: List[Request] = []
        finished: List[RequestResult] = []
        self._pending.clear()
        self._desynced.clear()
        now = time.perf_counter()
        for seq in list(self._live):
            req, out = seq.req, list(seq.out)
            if req.eos_id is not None and req.eos_id in out:
                out = out[:out.index(req.eos_id) + 1]
            remaining = req.max_new_tokens - len(out)
            regen = list(req.prompt[req.orig_prompt_len:])
            if (req.eos_id is not None and req.eos_id in out) \
                    or remaining <= 0:
                finished.append(RequestResult(
                    rid=req.rid, prompt_len=req.orig_prompt_len,
                    tokens=regen + out, arrival_time=req.arrival_time,
                    first_token_time=seq.first_token_time, finish_time=now,
                    preempted=self._preempt_counts.pop(req.rid, 0)))
                self.telemetry.requests.finish(
                    req.rid, "complete", tokens=len(regen) + len(out),
                    replica=self.replica_id, hists=self._m.latency)
                continue
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(out, np.int32)])
            req.max_new_tokens = remaining
            requests.append(req)
        requests.extend(self.scheduler.reset())
        self._live = []
        self.kv.release_all()
        if self.state_slots is not None:
            self.state_slots.release_all()
            self._m.state_slots_free.set(self.state_slots.num_free)
        self._free_slots = list(range(self.cfg.num_slots - 1, -1, -1))
        self._first_token_times.clear()
        self._progress_tokens.clear()
        self._m.live_seqs.set(0)
        return requests, finished

    # -- in-flight bookkeeping ----------------------------------------------

    def _note_tokens(self, rid: int, n: int) -> None:
        """Count ``n`` tokens fetched for ``rid``: at fetch, not dispatch,
        so tokens past an eos or refused by the device never count."""
        self._progress_tokens[rid] = self._progress_tokens.get(rid, 0) + n
        self._m.generated_tokens.inc(n)

    def drain_progress(self) -> Dict[int, int]:
        """Tokens fetched per request since the last drain: the
        dispatcher feeds them to ``ReplicaRouter.progress``, so routed
        load decays as the work is done."""
        out, self._progress_tokens = self._progress_tokens, {}
        return out

    def _fetch_one(self, finished: List[RequestResult]) -> None:
        """Read the oldest dispatched step's tokens, apply the stop
        conditions the device applied, and evict sequences whose last
        token just landed.  Tokens of sequences already evicted (eos seen
        in an earlier fetch) are discarded."""
        rec = self._pending.popleft()
        tr = self.telemetry.tracer
        ts0 = time.perf_counter() if tr.enabled else 0.0
        host = rec.copy.get()                       # sync point
        self._m.host_syncs.inc()
        if tr.enabled:
            ts1 = time.perf_counter()
            tr.span(self._host_track, "fetch", ts0, ts1)
            if rec.label:
                d0 = max(rec.t_disp, self._dev_tail)
                d1 = max(ts1, d0)
                tr.span(self._dev_track, rec.label, d0, d1)
                self._dev_tail = d1
        if rec.loop:
            toks, counts, eos_hit = host
            for row, seq, _ in rec.emits:
                if seq not in self._live or seq.desync:
                    continue
                c = int(counts[row])
                seq.out.extend(int(t) for t in toks[row, :c])
                self._note_tokens(seq.req.rid, c)
                planned = rec.planned[row]
                if eos_hit[row]:
                    seq.done = True
                    seq.gen_count = len(seq.out)
                elif c < planned:
                    # the device's capacity predicate refused reserved
                    # steps: roll back and recompute from host-known tokens
                    seq.gen_count -= planned - c
                    seq.done = False
                    seq.desync = True
                    self._desynced.append(seq)
                if seq.done and len(seq.out) >= seq.gen_count \
                        and seq in self._live:
                    self._evict(seq, rec.now, finished)
            return
        (toks,) = host
        for row, seq, is_first in rec.emits:
            if seq not in self._live or seq.desync:
                continue
            tok = int(toks[row])
            seq.out.append(tok)
            self._note_tokens(seq.req.rid, 1)
            if is_first:
                seq.first_token_time = self._first_token_times.pop(
                    seq.req.rid, rec.now)
                self.telemetry.requests.stamp(seq.req.rid, "first_token")
            if (seq.req.eos_id is not None and tok == seq.req.eos_id
                    and not seq.done):
                seq.done = True
                seq.gen_count = len(seq.out)
            if seq.done and len(seq.out) >= seq.gen_count \
                    and seq in self._live:
                self._evict(seq, rec.now, finished)

    def _flush(self, finished: List[RequestResult]) -> None:
        while self._pending:
            self._fetch_one(finished)
        if self._desynced:
            for seq in self._desynced:
                if seq in self._live:
                    seq.done = False
                    self._preempt_seq(seq)
                seq.desync = False
            self._desynced.clear()

    def _rows(self, n: int) -> int:
        """Rows of a step's tensors for a layout of ``n`` rows.  On the
        CPU a product of one row goes to a matrix-vector routine that sums
        in another order than the matrix product, so a sequence alone in
        a step would get other float32 logits than in a batch (and than
        the reference's); there a one-row step carries a padding row."""
        return 2 if n == 1 and self.device.type == "cpu" else n

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting on the device: a
        copy from pageable memory would first wait for the stream to
        drain, so stage through pinned memory."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    # -- fused step ---------------------------------------------------------

    def _dispatch(self, tokens, meta, tables) -> torch.Tensor:
        """One fused call; returns the (B,) sampled tokens on the device."""
        self._m.model_calls.inc()
        toks, self._slot_buf, self.cache = self.model.paged_step(
            self.params, self.cache, self._slot_buf, self._tensor(tokens),
            self._tensor(tables), self._tensor(meta), **self._sample_kw)
        return toks

    def _step_fused(self, now: float, finished: List[RequestResult]) -> None:
        cfg = self.cfg
        tr = self.telemetry.tracer
        t_plan0 = time.perf_counter() if tr.enabled else 0.0
        if self._desynced:
            self._flush(finished)
        plan = self.scheduler.schedule(len(self._live), self.kv)
        active = [s for s in self._live
                  if s.prefill_done and not s.done][:cfg.max_batch]
        if cfg.steps_per_dispatch > 1 and active and not plan:
            self._dispatch_decode_loop(active, now, finished, t_plan0=t_plan0)
            return
        # grow each decoding sequence's table to cover the token being
        # written; preempt LIFO victims if the pool is out of blocks
        for seq in active:
            if seq not in self._live:
                continue
            while not self.kv.ensure_capacity(seq.req.rid, seq.next_pos + 1,
                                              query_start=seq.next_pos):
                if self._pending:
                    self._flush(finished)
                    continue
                if not self._preempt_one(exclude_rid=seq.req.rid):
                    raise RuntimeError(
                        "KV pool too small for a single sequence; raise "
                        "num_blocks or lower max_seq_len")
        active = [s for s in active if s in self._live]
        plan = [ch for ch in plan if self.scheduler.planned(ch.req)]
        if not active and not plan:
            self._flush(finished)
            return

        n_dec = len(active)
        n_pre = sum(ch.length for ch in plan)
        if n_pre == 0:
            rows, width = self._rows(min(k for k in cfg.decode_buckets
                                         if k >= n_dec)), 1
        elif n_dec == 0:
            rows, width = self._rows(cfg.prefill_rows), cfg.prefill_chunk
        elif self.spec.width1_mixed:
            rows, width = min(k for k in cfg.mixed_buckets
                              if k >= n_dec + n_pre), 1
        else:
            rows, width = cfg.mixed_chunk_rows, cfg.prefill_chunk
        tokens = np.zeros((rows, width), np.int32)
        meta = np.zeros((6, rows), np.int32)
        meta[2:4] = -1
        pos, valid, src, dst, state, rid_row = meta
        rids: List[Optional[int]] = [None] * rows
        emits: List[Tuple[int, _Seq, bool]] = []

        for row, seq in enumerate(active):
            pos[row] = seq.next_pos
            valid[row] = 1
            rids[row] = seq.req.rid
            rid_row[row] = seq.req.rid
            state[row] = self._slot_of(seq.req.rid)
            dst[row] = seq.slot
            src[row] = seq.slot
            emits.append((row, seq, False))
            self.telemetry.requests.note_dispatch(seq.req.rid)
            seq.gen_count += 1
            if seq.gen_count >= seq.req.max_new_tokens:
                seq.done = True
        row = n_dec
        for ch in plan:
            seq = self._seq_of(ch.req.rid)
            if seq is None:
                seq = self._admit(ch.req)
            self._m.prefill_tokens.inc(ch.length)
            self.telemetry.requests.stamp(ch.req.rid, "prefill_start")
            completes = ch.start + ch.length >= len(ch.req.prompt)
            chunk_tok = ch.req.prompt[ch.start:ch.start + ch.length]
            if width > 1:                      # chunk-wide: one row/chunk
                tokens[row, :ch.length] = chunk_tok
                pos[row] = ch.start
                valid[row] = ch.length
                rids[row] = ch.req.rid
                rid_row[row] = ch.req.rid
                state[row] = self._slot_of(ch.req.rid)
                if completes:
                    dst[row] = seq.slot
                    seq.prefill_done = True
                    emits.append((row, seq, True))
                    seq.gen_count += 1
                    if seq.gen_count >= seq.req.max_new_tokens:
                        seq.done = True
                row += 1
                continue
            for i in range(ch.length):         # mixed: one row/token
                tokens[row, 0] = chunk_tok[i]
                pos[row] = ch.start + i
                valid[row] = 1
                rids[row] = ch.req.rid
                rid_row[row] = ch.req.rid
                if completes and i == ch.length - 1:
                    dst[row] = seq.slot
                    seq.prefill_done = True
                    emits.append((row, seq, True))
                    seq.gen_count += 1
                    if seq.gen_count >= seq.req.max_new_tokens:
                        seq.done = True
                row += 1

        phase = ("decode" if n_pre == 0
                 else "prefill" if n_dec == 0 else "mixed")
        t0 = time.perf_counter()
        toks = self._dispatch(tokens, meta, self.kv.table_array(rids))
        rec = _Inflight(_HostCopy(toks), emits, now)
        t1 = time.perf_counter()
        self._m.dispatch_s[phase].observe(t1 - t0)
        if n_dec:
            self._m.decode_steps.inc()
            self._m.decode_slot_steps.inc(rows if n_pre == 0
                                          else cfg.max_batch)
            self._m.decode_active_slot_steps.inc(n_dec)
        if tr.enabled:
            tr.span(self._host_track, "plan", t_plan0, t0,
                    args={"decode_rows": n_dec, "prefill_tokens": n_pre})
            tr.span(self._host_track, f"dispatch:{phase}", t0, t1,
                    args={"rows": rows, "width": width})
            rec.t_disp = t1
            rec.label = f"{phase}[{rows}x{width}]"
        self._pending.append(rec)
        self._drain_pipeline(finished)

    def _drain_pipeline(self, finished: List[RequestResult]) -> None:
        # depth-1 pipeline: this dispatch computes while the host reads
        # the previous one's tokens and plans the next
        while len(self._pending) > 1:
            self._fetch_one(finished)

    def _dispatch_decode_loop(self, active: List[_Seq], now: float,
                              finished: List[RequestResult],
                              t_plan0: float = 0.0) -> None:
        """One N-step decode dispatch: reserve up to N tokens of block
        headroom per row (partial grants are used in full; a row that
        gets none triggers flush-then-preempt), hand the device per-row
        step budgets, read back a packed (rows, N) token buffer one
        dispatch later."""
        cfg = self.cfg
        n_steps = cfg.steps_per_dispatch
        grants: Dict[int, Tuple[int, int]] = {}
        for seq in active:
            if seq not in self._live:
                continue
            want = min(n_steps, seq.req.max_new_tokens - seq.gen_count)
            while True:
                covered = self.kv.reserve(seq.req.rid, seq.next_pos + want,
                                          query_start=seq.next_pos)
                granted = min(want, covered - seq.next_pos)
                if granted >= 1:
                    break
                if self._pending:
                    self._flush(finished)
                    if seq not in self._live:
                        break
                    continue
                if not self._preempt_one(exclude_rid=seq.req.rid):
                    raise RuntimeError(
                        "KV pool too small for a single sequence; raise "
                        "num_blocks or lower max_seq_len")
            if seq in self._live:
                grants[seq.req.rid] = (want, granted)
        rows_seqs = [s for s in active
                     if s in self._live and s.req.rid in grants]
        if not rows_seqs:
            self._flush(finished)
            return
        rows = self._rows(min(k for k in cfg.decode_buckets
                              if k >= len(rows_seqs)))
        meta = np.zeros((6, rows), np.int32)
        pos0, steps, slot, state, rid_row, eos = meta
        eos[:] = -1
        emits: List[Tuple[int, _Seq, bool]] = []
        planned: Dict[int, int] = {}
        rids: List[Optional[int]] = [None] * rows
        for row, seq in enumerate(rows_seqs):
            want, granted = grants[seq.req.rid]
            pos0[row] = seq.next_pos
            steps[row] = granted
            slot[row] = seq.slot
            state[row] = self._slot_of(seq.req.rid)
            rid_row[row] = seq.req.rid
            eos[row] = -1 if seq.req.eos_id is None else seq.req.eos_id
            rids[row] = seq.req.rid
            if granted < want:
                self._m.loop_truncations.inc()
            planned[row] = granted
            emits.append((row, seq, False))
            self.telemetry.requests.note_dispatch(seq.req.rid)
            seq.gen_count += granted
            if seq.gen_count >= seq.req.max_new_tokens:
                seq.done = True
        self._m.model_calls.inc()
        self._m.loop_dispatches.inc()
        max_granted = max(planned.values())
        self._m.decode_steps.inc(max_granted)
        self._m.decode_slot_steps.inc(rows * max_granted)
        self._m.decode_active_slot_steps.inc(sum(planned.values()))
        tr = self.telemetry.tracer
        t0 = time.perf_counter()
        out, counts, eos_hit, self._slot_buf, self.cache = \
            self.model.paged_decode_loop(
                self.params, self.cache, self._slot_buf,
                self._tensor(self.kv.table_array(rids)), self._tensor(meta),
                num_steps=n_steps, **self._sample_kw)
        rec = _Inflight(_HostCopy(out, counts, eos_hit), emits, now,
                        loop=True, planned=planned)
        t1 = time.perf_counter()
        self._m.dispatch_s["loop"].observe(t1 - t0)
        if tr.enabled:
            tr.span(self._host_track, "plan", t_plan0, t0,
                    args={"decode_rows": len(rows_seqs), "steps": n_steps})
            tr.span(self._host_track, "dispatch:loop", t0, t1,
                    args={"rows": rows, "steps": n_steps})
            rec.t_disp = t1
            rec.label = f"loop[{rows}x{n_steps}]"
        self._pending.append(rec)
        self._drain_pipeline(finished)

    # -- public loop --------------------------------------------------------

    def warmup(self) -> None:
        """Run every row layout this engine can emit once against the
        trash block and slot (valid_len 0 and zero step budgets mask
        every write),
        so the kernel library is built and loaded, the allocator holds
        its working set and no first-use cost lands mid-serving."""
        with self.on_stream():
            self._warmup()

    def _warmup(self) -> None:
        cfg = self.cfg
        shapes = [(self._rows(b), 1) for b in cfg.decode_buckets]
        shapes += [(self._rows(cfg.prefill_rows), cfg.prefill_chunk)]
        if self.spec.width1_mixed:
            shapes += [(b, 1) for b in cfg.mixed_buckets]
        else:
            shapes += [(cfg.mixed_chunk_rows, cfg.prefill_chunk)]
        for rows, width in shapes:
            meta = np.zeros((6, rows), np.int32)
            meta[2:4] = -1
            self._dispatch(np.zeros((rows, width), np.int32), meta,
                           self.kv.table_array([None] * rows))
        if cfg.steps_per_dispatch > 1:
            for rows in map(self._rows, cfg.decode_buckets):
                meta = np.zeros((6, rows), np.int32)
                meta[5] = -1
                _, _, _, self._slot_buf, self.cache = \
                    self.model.paged_decode_loop(
                        self.params, self.cache, self._slot_buf,
                        self._tensor(self.kv.table_array([None] * rows)),
                        self._tensor(meta), num_steps=cfg.steps_per_dispatch,
                        **self._sample_kw)
        for st in self.streams.values():
            st.synchronize()
        for h in (self._m.model_calls, self._m.host_syncs,
                  self._m.loop_dispatches):
            h.reset()
        for h in self._m.dispatch_s.values():
            h.reset()

    @property
    def has_work(self) -> bool:
        return (self.scheduler.has_waiting or bool(self._live)
                or bool(self._pending))

    def step(self, now: Optional[float] = None) -> List[RequestResult]:
        """One engine iteration; returns requests finished this step."""
        now = time.perf_counter() if now is None else now
        finished: List[RequestResult] = []
        with self.on_stream():
            if self._has_deadlines:
                self._expire_deadlines(finished)
            self._step_fused(now, finished)
        self._m.steps.inc()
        return finished

    def run(self, requests: Sequence[Request] = (),
            request_queue: Optional[RequestQueue] = None,
            max_steps: Optional[int] = None) -> Dict[int, RequestResult]:
        """Drive until all submitted work (and the queue, if given) is
        done.  Returns {rid: RequestResult}."""
        for r in requests:
            self.submit(r)
        results: Dict[int, RequestResult] = {}
        steps = 0
        while True:
            if request_queue is not None:
                for r in request_queue.drain():
                    self.submit(r)
            if not self.has_work:
                if request_queue is None or request_queue.exhausted:
                    break
                time.sleep(0.0005)
                continue
            for res in self.step():
                results[res.rid] = res
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return results


def _to_device(tree, device):
    """The params tree on ``device``: a leaf already there is kept as it
    is (``Tensor.to`` returns the tensor itself, so a card-resident tree
    is never copied)."""
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
