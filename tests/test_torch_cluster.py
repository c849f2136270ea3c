"""The port's cluster layer (``repro_torch.serve.ServeCluster``) on the
CPU, against the JAX package's ``Engine``: the smoke qwen2 that
``tests/test_serve_faults.py`` serves (2 layers, d_model 64, vocab 128),
its weights carried across with ``interop``, float32.

The oracle is one JAX engine run of the workload, greedy and at
temperature 0.8, in a module fixture; every request carries an explicit
rid, so a stream depends on its rid and prompt only (the sampling keys
are ``fold_in(rid, position)``), whichever replica serves it and
whatever else shares its batches.  Then the port's counterparts of the
reference's fault tests: a replica killed mid-generation (greedy and
sampled), poison quarantine, a hang with the orphan guard, SUSPECT back
to LIVE, the bounded join's forced drain, drain, load shedding and
``NoLiveReplicas``, the engine's e2e and queue deadlines and
``reclaim_requests``; every stream must equal the JAX engine's, token
for token.  One kill case runs the recurrentgemma smoke variant (block
pools, state slots, window reclaim) against the port's fault-free single
engine.

Health deadlines follow the reference's tests: soft 60 s and hard 120 s
where no hang is planned, sub-second to 2 s where a hang is the point;
every hang is released in teardown and every join is bounded.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models.model import build_model
from repro_torch.serve import (Engine, EngineConfig, FaultAction, FaultPlan,
                               HealthConfig, NoLiveReplicas, Overloaded,
                               ReplicaKilled, ReplicaState, Request,
                               RetryPolicy, ServeCluster)
from test_torch_model import carried_models
from torch_threads import one_torch_thread  # noqa: F401

LM = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128, num_heads=2,
          num_kv_heads=2, head_dim=32)
ECFG = dict(max_batch=3, block_size=8, num_blocks=65, max_seq_len=64,
            prefill_chunk=16, prefill_token_budget=24)
SAMPLED = dict(temperature=0.8)
CPU = [torch.device("cpu")]
CALM = dict(soft_deadline_s=60.0, hard_deadline_s=120.0, interval_s=0.01)
JOIN_S = 30.0


def _workload(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (int(p),)).astype(np.int32), int(g))
            for p, g in zip(rng.integers(3, 40, n), rng.integers(4, 16, n))]


@pytest.fixture(scope="module")
def lm():
    """(port model, port params, workload, {mode: JAX engine streams})."""
    jcfg, jmodel, jparams, _, tmodel, tparams = carried_models(LM)
    work = _workload(jcfg.vocab_size)
    want = {}
    for mode, kw in (("greedy", {}), ("sampled", SAMPLED)):
        eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**ECFG, **kw))
        res = eng.run([JaxRequest(prompt=p.copy(), max_new_tokens=g, rid=i)
                       for i, (p, g) in enumerate(work)])
        want[mode] = {i: res[i].tokens for i in range(len(work))}
    return tmodel, tparams, work, want


def _ecfg(**kw):
    return EngineConfig(**dict(ECFG, **kw))


def _requests(work, n=None):
    return [Request(prompt=p.copy(), max_new_tokens=g, rid=i)
            for i, (p, g) in enumerate(work[:n])]


def _cluster(model, params, *, ecfg=None, num_replicas=2, **kw):
    kw.setdefault("health", HealthConfig(**CALM))
    kw.setdefault("join_timeout_s", JOIN_S)
    return ServeCluster.for_replicas(model, params, ecfg or _ecfg(),
                                     num_replicas=num_replicas, devices=CPU,
                                     **kw)


def _run(cluster, subs, plan=None):
    try:
        return cluster.run(subs)
    finally:
        if plan is not None:
            plan.release_hangs()


def _assert_streams(results, subs, want, skip=()):
    assert len(results) == len(subs)
    for sub in subs:
        if sub.rid in skip:
            continue
        assert results[sub.rid].fault is None, sub.rid
        assert results[sub.rid].tokens == want[sub.rid], sub.rid


# ---------------------------------------------------------------------------
# fault-free: two replicas give the JAX engine's streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spd", [1, 8])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_cluster_equals_jax_engine(lm, mode, spd):
    model, params, work, want = lm
    kw = SAMPLED if mode == "sampled" else {}
    cluster = _cluster(model, params,
                       ecfg=_ecfg(steps_per_dispatch=spd, **kw))
    assert [e.device for e in cluster.engines] == CPU * 2
    assert [e.tp_degree for e in cluster.engines] == [1, 1]
    cluster.warmup()
    subs = _requests(work)
    results = _run(cluster, subs)
    _assert_streams(results, subs, want[mode])
    m = cluster.metrics()
    # both replicas served, and every token they fetched shed its weight
    assert all(m["per_replica"][i]["counters"]["generated_tokens"] > 0
               for i in (0, 1))
    assert m["aggregate"]["counters"]["generated_tokens"] == \
        sum(g for _, g in work)
    assert m["failover"]["failovers"] == 0
    assert all(h["reason"] == "drained" for h in m["health"].values())
    assert cluster.loads() == {0: 0, 1: 0}
    assert cluster.router.outstanding() == 0
    assert cluster.telemetry.requests.double_terminals.value == 0


# ---------------------------------------------------------------------------
# deterministic failover: kill a replica mid-generation, lose nothing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spd", [1, 8])
def test_failover_kill_matches_jax_greedy(lm, spd):
    """Kill one of two replicas at its 2nd dispatch: every request still
    completes with the fault-free greedy stream, exactly once, and the
    death shows in the health metrics."""
    model, params, work, want = lm
    plan = FaultPlan.kill_at(replica=0, dispatch=2)
    cluster = _cluster(model, params, ecfg=_ecfg(steps_per_dispatch=spd),
                       faults=plan)
    subs = _requests(work)
    results = _run(cluster, subs, plan)
    assert plan.fired(), "the kill never fired — nothing was tested"
    _assert_streams(results, subs, want["greedy"])
    health = cluster.metrics()["health"]
    assert health[0]["state"] == ReplicaState.DEAD.value
    assert "ReplicaKilled" in health[0]["reason"]
    book = cluster.telemetry.requests
    assert book.double_terminals.value == 0
    assert cluster.metrics()["failover"]["failovers"] >= 1
    retried = [t for t in book.traces() if t.retries > 0]
    assert retried, "a mid-generation kill must re-dispatch something"
    for t in retried:
        assert t.terminal == "complete"
    assert sum(v == 0 for v in cluster.loads().values()) == 2


def test_failover_kill_matches_jax_sampled(lm):
    """The same kill at temperature 0.8: ``fold_in(rid, position)`` keys
    make the re-decode on the survivor give the same sampled stream."""
    model, params, work, want = lm
    plan = FaultPlan.kill_at(replica=0, dispatch=2)
    cluster = _cluster(model, params, ecfg=_ecfg(**SAMPLED), faults=plan)
    subs = _requests(work, 4)
    results = _run(cluster, subs, plan)
    assert plan.fired()
    _assert_streams(results, subs, want["sampled"])
    assert cluster.telemetry.requests.double_terminals.value == 0


def test_poison_quarantine(lm):
    """With max_attempts=1, a request whose replica dies under it ends
    with a ``poison`` fault instead of a re-dispatch; the rest of the
    workload completes with the JAX engine's streams."""
    model, params, work, want = lm
    plan = FaultPlan.kill_at(replica=0, dispatch=1)
    cluster = _cluster(model, params, faults=plan,
                       retry=RetryPolicy(max_attempts=1))
    subs = _requests(work)
    results = _run(cluster, subs, plan)
    assert plan.fired()
    poisoned = {rid for rid, r in results.items() if r.fault == "poison"}
    assert poisoned, "the killed replica had work in flight"
    _assert_streams(results, subs, want["greedy"], skip=poisoned)
    assert all(results[rid].tokens == [] for rid in poisoned)
    assert cluster.telemetry.requests.double_terminals.value == 0


def test_hang_failover_and_orphan_guard(lm):
    """A replica that hangs blows the hard heartbeat deadline, is
    declared DEAD, and its requests restart from the dispatcher's
    snapshots on the survivor; released afterwards, the hung worker
    drops everything (the orphan guard) instead of serving twice."""
    model, params, work, want = lm
    plan = FaultPlan([FaultAction(0, 1, "hang")], hang_timeout_s=60.0)
    cluster = _cluster(model, params, faults=plan,
                       health=HealthConfig(soft_deadline_s=0.5,
                                           hard_deadline_s=2.0,
                                           interval_s=0.02))
    cluster.warmup()
    subs = _requests(work, 4)
    results = _run(cluster, subs, plan)
    assert plan.fired()
    _assert_streams(results, subs, want["greedy"])
    health = cluster.metrics()["health"]
    assert health[0]["state"] == ReplicaState.DEAD.value
    assert health[0]["reason"] == "hung"
    # the released orphan exits without touching the engine again
    worker = cluster._threads[0]
    worker.join(JOIN_S)
    assert not worker.is_alive()
    assert cluster.telemetry.requests.double_terminals.value == 0
    assert len(cluster.results()) == len(subs)


def test_suspect_recovers_to_live(lm):
    """A stalled but alive replica walks LIVE -> SUSPECT while its beat is
    stale and back to LIVE on the next beat; no failover fires."""
    model, params, work, want = lm
    plan = FaultPlan([FaultAction(0, 1, "hang")], hang_timeout_s=60.0)
    p, g = work[0]
    req = Request(prompt=p.copy(), max_new_tokens=g, rid=0)
    cluster = _cluster(model, params, num_replicas=1, faults=plan,
                       health=HealthConfig(soft_deadline_s=0.1,
                                           hard_deadline_s=1e6,
                                           interval_s=0.02))
    done = {}
    t = threading.Thread(target=lambda: done.update(cluster.run([req])))
    t.start()
    try:
        deadline = time.monotonic() + 20.0
        seen_suspect = False
        while time.monotonic() < deadline and not seen_suspect:
            st = cluster.metrics()["health"][0]["state"]
            seen_suspect = st == ReplicaState.SUSPECT.value
            time.sleep(0.01)
        assert seen_suspect
    finally:
        plan.release_hangs()
        t.join(JOIN_S)
    assert not t.is_alive()
    assert done[0].tokens == want["greedy"][0]   # served by the SAME replica
    m = cluster.metrics()
    assert m["failover"]["failovers"] == 0
    assert m["health"][0]["reason"] == "drained"


def test_bounded_join_forced_drain(lm):
    """With deadlines the monitor never reaches and a join timeout, join
    returns: it force-fails the wedged replica and its work fails over to
    the respawned survivor."""
    model, params, work, want = lm
    plan = FaultPlan([FaultAction(0, 1, "hang")], hang_timeout_s=60.0)
    cluster = _cluster(model, params, faults=plan,
                       health=HealthConfig(soft_deadline_s=1e6,
                                           hard_deadline_s=1e6,
                                           interval_s=0.02),
                       join_timeout_s=2.0)
    cluster.warmup()
    subs = _requests(work, 4)
    try:
        cluster.start()
        for s in subs:
            cluster.submit(s)
        cluster.close()
        t0 = time.monotonic()
        cluster.join()                           # bounded by join_timeout_s
        assert time.monotonic() - t0 < JOIN_S
    finally:
        plan.release_hangs()
    results = cluster.results()
    _assert_streams(results, subs, want["greedy"])
    m = cluster.metrics()
    assert m["failover"]["forced_drains"] >= 1
    assert m["health"][0]["reason"] == "hung"


def test_drain_stops_new_routing(lm):
    """A drained replica takes no new work, its worker retires cleanly
    (reason ``drained``), and the survivor serves everything."""
    model, params, work, want = lm
    subs = _requests(work, 4)
    cluster = _cluster(model, params)
    with cluster:
        cluster.drain(0)
        placed = {cluster.submit(s) for s in subs}
    assert placed == {1}                         # nothing routed to 0
    results = cluster.results()
    _assert_streams(results, subs, want["greedy"])
    assert cluster.metrics()["health"][0]["reason"] == "drained"


def test_shed_overload_and_no_live_replicas(lm):
    """Load shedding fails fast instead of blocking; a cluster whose every
    replica drains refuses admission outright."""
    model, params, work, _ = lm
    cluster = _cluster(model, params, num_replicas=1, capacity_tokens=20,
                       shed_overload=True)
    rng = np.random.default_rng(5)
    rid = iter(range(100, 200))
    mk = lambda: Request(prompt=rng.integers(0, LM["vocab_size"], (8,)),
                         max_new_tokens=4, rid=next(rid))   # weight 12
    cluster.submit(mk())                         # workers never started
    with pytest.raises(Overloaded):
        cluster.submit(mk())
    cluster.drain(0)
    with pytest.raises(NoLiveReplicas):
        cluster.submit(mk())
    cluster.close()                              # releases the queued one
    assert sum(cluster.loads().values()) == 0
    assert cluster.telemetry.requests.get(100).terminal == "cancel"


def test_fault_intolerant_cluster_reraises_from_join(lm):
    """``fault_tolerant=False``: the first worker exception comes back out
    of ``join``; no failover runs."""
    model, params, work, _ = lm
    plan = FaultPlan.kill_at(replica=0, dispatch=1)
    cluster = _cluster(model, params, faults=plan, fault_tolerant=False)
    with pytest.raises(ReplicaKilled):
        _run(cluster, _requests(work, 4), plan)
    assert cluster.metrics()["failover"]["failovers"] == 0


def test_cancel_metrics_and_trace(lm, tmp_path):
    """Cancel intercepts a routed request no engine picked up; the trace
    has a host and a device track per replica and the dispatcher's; the
    metrics document carries the cluster's counters."""
    model, params, work, want = lm
    cluster = _cluster(model, params, trace=True)
    subs = _requests(work, 4)
    for s in subs:
        cluster.submit(s)                        # not started: all queued
    assert cluster.cancel(3) is True
    assert cluster.cancel(3) is True             # idempotent
    cluster.start()
    cluster.close()
    cluster.join()
    results = cluster.results()
    assert set(results) == {0, 1, 2}
    _assert_streams(results, subs[:3], want["greedy"])
    assert cluster.cancel(0) is False            # finished: not cancelled
    assert cluster.telemetry.requests.get(3).terminal == "cancel"
    cluster.write_trace(str(tmp_path / "trace.json"))
    cluster.write_metrics(str(tmp_path / "metrics.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tracks = {e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"dispatcher", "replica0/host", "replica0/device",
            "replica1/host", "replica1/device"} <= tracks
    doc = json.loads((tmp_path / "metrics.json").read_text())
    assert doc["metrics"]["failover"]["failovers"] == 0
    assert doc["metrics"]["aggregate"]["latency"]["e2e"]["count"] == 3
    assert any(k.startswith("replica_state") for k in
               doc["snapshot"]["gauges"])


# ---------------------------------------------------------------------------
# the RG-LRU hybrid: block pools, state slots and window reclaim
# ---------------------------------------------------------------------------


def test_hybrid_failover_kill_matches_single_engine():
    """recurrentgemma's smoke variant (two RG-LRU layers, one local
    attention layer over a 64-token window): under a kill, with prompts
    past the window, every stream equals the port's fault-free single
    engine's (``tests/test_torch_hybrid_engine.py`` pins that engine
    against the JAX one)."""
    cfg = smoke_variant(get_config("recurrentgemma-2b"))
    model = build_model(cfg)
    params = model.init(0, "cpu")
    ecfg = EngineConfig(max_batch=3, block_size=8, num_blocks=65,
                        max_seq_len=128, prefill_chunk=16,
                        prefill_token_budget=24, steps_per_dispatch=4)
    rng = np.random.default_rng(7)
    work = [(rng.integers(0, cfg.vocab_size, (int(p),)).astype(np.int32),
             int(g)) for p, g in zip((90, 12, 70, 30, 100, 9),
                                     rng.integers(6, 20, 6))]
    single = Engine(model, params, ecfg, device="cpu")
    want = {rid: r.tokens for rid, r in single.run(_requests(work)).items()}
    assert single.kv._m["reclaimed"].value > 0    # the window reclaimed
    plan = FaultPlan.kill_at(replica=0, dispatch=2)
    cluster = _cluster(model, params, ecfg=ecfg, faults=plan)
    subs = _requests(work)
    results = _run(cluster, subs, plan)
    assert plan.fired()
    _assert_streams(results, subs, want)
    assert cluster.metrics()["failover"]["failovers"] >= 1
    assert cluster.telemetry.requests.double_terminals.value == 0
    survivor = cluster.engines[1]
    assert survivor.state_slots.num_free == ecfg.num_slots


# ---------------------------------------------------------------------------
# the engine's side of the cluster: deadlines, reclaim, slices
# ---------------------------------------------------------------------------


def test_engine_e2e_deadline_faults_with_partial_output(lm):
    model, params, _, _ = lm
    eng = Engine(model, params, _ecfg(), device="cpu")
    req = Request(prompt=np.arange(8) % LM["vocab_size"], max_new_tokens=12,
                  deadline_s=1e6)
    eng.submit(req)
    results = {}
    for _ in range(3):                           # admit + some decode
        for r in eng.step():
            results[r.rid] = r
    assert not results
    req.deadline_at = time.monotonic() - 1.0     # force expiry, no sleeps
    while eng.has_work:
        for r in eng.step():
            results[r.rid] = r
    res = results[req.rid]
    assert res.fault == "deadline"
    assert 0 < len(res.tokens) < 12              # partial output kept
    assert eng.metrics_snapshot()["counters"]["faulted"] == 1
    assert eng.kv.allocator.num_free == 64       # everything released
    assert eng.telemetry.requests.get(req.rid).terminal == "fault"


def test_engine_queue_deadline_faults_waiting_request(lm):
    model, params, _, _ = lm
    eng = Engine(model, params, _ecfg(max_batch=1, admission_lookahead=0),
                 device="cpu")
    first = Request(prompt=np.arange(8) % LM["vocab_size"], max_new_tokens=8)
    starved = Request(prompt=np.arange(6) % LM["vocab_size"],
                      max_new_tokens=4, queue_deadline_s=1e6)
    eng.submit(first)
    eng.submit(starved)
    eng.step()                                   # admits only `first`
    starved.queue_deadline_at = time.monotonic() - 1.0
    results = {}
    while eng.has_work:
        for r in eng.step():
            results[r.rid] = r
    assert results[starved.rid].fault == "queue_deadline"
    assert results[starved.rid].tokens == []
    assert results[first.rid].fault is None
    assert len(results[first.rid].tokens) == 8


@pytest.mark.parametrize("spd", [1, 8])
def test_engine_reclaim_requests_stitches_partial_progress(lm, spd):
    """Post-mortem salvage: stop an engine mid-generation, reclaim its
    requests, serve them on a fresh engine: the stitched output equals
    the JAX engine's streams (the recompute fold keeps positions)."""
    model, params, work, want = lm
    reqs = _requests(work)
    eng1 = Engine(model, params, _ecfg(steps_per_dispatch=spd),
                  device="cpu")
    for r in reqs:
        eng1.submit(r)
    results = {}
    for _ in range(4):                           # partial progress
        for r in eng1.step():
            results[r.rid] = r
    progress = eng1.drain_progress()
    assert progress and all(n > 0 for n in progress.values())
    salvaged, done = eng1.reclaim_requests()
    assert not eng1.has_work                     # emptied
    assert eng1.kv.allocator.num_free == 64
    assert eng1.drain_progress() == {}
    assert any(len(r.prompt) > r.orig_prompt_len for r in salvaged)
    for r in done:
        results[r.rid] = r
    eng2 = Engine(model, params, _ecfg(steps_per_dispatch=spd),
                  device="cpu", replica_id=1)
    for rid, r in eng2.run(salvaged).items():
        results[rid] = r
    _assert_streams(results, reqs, want["greedy"])


def test_engine_takes_a_slice_of_one_device(lm):
    model, params, _, _ = lm
    eng = Engine(model, params, _ecfg(), devices=CPU)
    assert (eng.device, eng.devices, eng.tp_degree, eng.stream) == \
        (torch.device("cpu"), tuple(CPU), 1, None)
    # a slice of two serves one tensor-parallel engine (its streams are
    # held to the reference in tests/test_torch_tp.py)
    assert Engine(model, params, _ecfg(), devices=CPU * 2).tp_degree == 2
    one = ServeCluster.for_replicas(model, params, _ecfg(), num_replicas=1,
                                    devices=CPU * 2)
    assert [e.tp_degree for e in one.engines] == [2]
    assert one.router.width(0) == 2
    with pytest.raises(ValueError):
        Engine(model, params, _ecfg(), devices=())


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_a_request_alone_gets_its_batched_stream(lm, mode):
    """A request served alone runs one-row steps, which the engine pads
    to two rows on the CPU (a one-row product would go to a
    matrix-vector routine that sums in another order), so its float32
    stream is the JAX engine's from the batched run: it does not depend
    on which replica's batch it rides."""
    model, params, work, want = lm
    eng = Engine(model, params, _ecfg(**(SAMPLED if mode == "sampled"
                                         else {})), device="cpu")
    assert eng._rows(1) == 2 and eng._rows(3) == 3
    for i, (p, g) in enumerate(work):
        res = eng.run([Request(prompt=p.copy(), max_new_tokens=g, rid=i)])
        assert res[i].tokens == want[mode][i], i
