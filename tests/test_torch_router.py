"""The port's ``ReplicaRouter`` (``repro_torch.serve.router``) against
the JAX package's: over hypothesis op sequences built as
``tests/test_router_props.py`` builds them (route, progress, complete,
release over colliding rids, plus disable and enable), both routers make
the same placement or refusal at every step and end with the same
loads; the bookkeeping contract (loads never negative, their sum the
outstanding weight) holds throughout.  Then the reference's threaded
stress tests on the port's router, and ``launch.mesh.replica_slices``
against the reference's on the same device list."""
import os
import sys
import threading

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.topology import Topology as RefTopology
from repro.launch import mesh as ref_mesh
from repro.serve import ReplicaRouter as RefRouter
from repro_torch.core.topology import Topology
from repro_torch.launch.mesh import replica_slices
from repro_torch.serve import ReplicaRouter
from repro_torch.serve.telemetry import MetricsRegistry
from torch_threads import one_torch_thread  # noqa: F401

OPS = st.lists(
    st.tuples(
        st.sampled_from(["route", "progress", "complete", "release",
                         "disable", "enable"]),
        st.integers(0, 7),           # rid (or replica for disable/enable)
        st.integers(1, 99)),         # token weight / progress quantum
    max_size=60)


def _pair(group, num_pods, data_size, **kw):
    mine = ReplicaRouter(Topology(intra_group_size=group), num_pods,
                         data_size, **kw)
    theirs = RefRouter(RefTopology(intra_group_size=group), num_pods,
                       data_size, **kw)
    assert [(r.replica_id, r.pod, r.group, r.devices)
            for r in mine.replicas] == \
        [(r.replica_id, r.pod, r.group, r.devices) for r in theirs.replicas]
    return mine, theirs


def _apply(router, op, rid, w):
    if op == "route":
        rep = router.route(rid, tokens=w)
        return None if rep is None else rep.replica_id
    if op == "progress":
        return router.progress(rid, w)
    if op in ("disable", "enable"):
        return getattr(router, op)(rid % router.num_replicas)
    return getattr(router, op)(rid)


def _same_run(mine, theirs, ops):
    outstanding = {}
    for op, rid, w in ops:
        got = _apply(mine, op, rid, w)
        assert got == _apply(theirs, op, rid, w), (op, rid, w)
        if op == "route" and got is not None:
            outstanding.setdefault(rid, w)      # re-route keeps old weight
        elif op == "progress" and rid in outstanding:
            outstanding[rid] = max(0, outstanding[rid] - w)
        elif op in ("complete", "release"):
            outstanding.pop(rid, None)
        loads = mine.loads()
        assert loads == theirs.loads()
        assert mine.outstanding() == theirs.outstanding() == len(outstanding)
        assert mine.enabled_count() == theirs.enabled_count()
        assert all(v >= 0 for v in loads.values())
        assert sum(loads.values()) == sum(outstanding.values())
    for rid in list(outstanding):
        mine.release(rid)
    assert sum(mine.loads().values()) == 0


@settings(max_examples=80, deadline=None)
@given(ops=OPS, num_pods=st.sampled_from([1, 2]),
       group=st.sampled_from([1, 2, 4]))
def test_router_choices_and_loads_equal_the_reference(ops, num_pods, group):
    _same_run(*_pair(group, num_pods, 4), ops)


@settings(max_examples=60, deadline=None)
@given(ops=OPS, capacity=st.integers(1, 120),
       widths=st.sampled_from([None, {0: 2}, {1: 4, 3: 2}]))
def test_router_backpressure_and_widths_equal_the_reference(ops, capacity,
                                                            widths):
    """With a capacity both routers refuse the same routes (a refusal
    leaves the books as they were), and heterogeneous slice widths scale
    placement and capacity alike."""
    _same_run(*_pair(1, 2, 2, capacity_tokens=capacity, widths=widths), ops)


def test_router_metrics_follow_the_books():
    reg = MetricsRegistry()
    router = ReplicaRouter(Topology(intra_group_size=1), 1, 2,
                           capacity_tokens=10)
    router.attach_metrics(reg, arch="smoke")
    assert router.route(0, tokens=8).replica_id == 0
    assert router.route(1, tokens=8).replica_id == 1
    assert router.route(2, tokens=8) is None     # both past capacity
    router.progress(0, 5)
    router.release(1)
    snap = reg.snapshot()["counters"]
    assert snap['router_routed{arch=smoke}'] == 2
    assert snap['router_refusals{arch=smoke}'] == 1
    assert snap['router_progress_tokens{arch=smoke}'] == 5
    assert snap['router_released{arch=smoke}'] == 1
    gauges = reg.snapshot()["gauges"]
    assert gauges['router_load_tokens{arch=smoke,replica=0}'] == 3
    assert gauges['router_load_tokens{arch=smoke,replica=1}'] == 0


@pytest.fixture
def short_switch_interval():
    """Threads hand the interpreter lock over every 10 us instead of 5 ms
    while the test runs, so a lost update has many chances to show."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def test_router_threaded_stress(short_switch_interval):
    """Concurrent route -> progress -> release from more threads than
    cores keeps the books exact."""
    router = ReplicaRouter(Topology(intra_group_size=2), num_pods=2,
                           data_size=4)
    n_threads, per_thread, weight = 2 * (os.cpu_count() or 4), 200, 7
    barrier = threading.Barrier(n_threads)
    errors = []

    def client(tid):
        try:
            barrier.wait()
            for i in range(per_thread):
                rid = tid * per_thread + i
                assert router.route(rid, tokens=weight) is not None
                router.progress(rid, 3)          # partial, then full release
                snap = router.loads()            # torn reads crash/mismatch
                assert all(v >= 0 for v in snap.values())
                router.release(rid)
                router.release(rid)              # idempotent under racing
        except BaseException as e:               # surface into the test
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    assert sum(router.loads().values()) == 0
    assert router.outstanding() == 0


def test_router_threaded_progress_vs_release():
    """Writer threads racing progress against release on the same rids:
    weight never goes negative and a fully released book sums to zero."""
    router = ReplicaRouter(Topology(), num_pods=1, data_size=2)
    rids = list(range(32))
    for rid in rids:
        assert router.route(rid, tokens=100) is not None
    barrier = threading.Barrier(3)
    errors = []

    def run(fn):
        try:
            barrier.wait()
            for _ in range(50):
                for rid in rids:
                    fn(rid)
                    snap = router.loads()
                    assert all(v >= 0 for v in snap.values())
        except BaseException as e:
            errors.append(e)

    threads = [
        threading.Thread(target=run, args=(lambda r: router.progress(r, 1),)),
        threading.Thread(target=run, args=(router.release,)),
        threading.Thread(target=run, args=(router.complete,)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    for rid in rids:
        router.release(rid)
    assert sum(router.loads().values()) == 0
    assert router.outstanding() == 0


def test_router_threaded_release_on_death():
    """The dispatcher's failover sequence (disable the dead replica,
    release its rids, re-route them) racing threads that report progress
    on those rids: re-routes never land on the disabled replica and its
    book drains to exactly zero."""
    router = ReplicaRouter(Topology(intra_group_size=2), num_pods=1,
                           data_size=4)                  # replicas 0, 1
    dead_rids = []
    weight = 10
    rid = 0
    while len(dead_rids) < 16:
        rep = router.route(rid, tokens=weight)
        assert rep is not None
        if rep.replica_id == 0:
            dead_rids.append(rid)
        rid += 1
    barrier = threading.Barrier(3)
    errors = []
    stop = threading.Event()

    def prog():
        try:
            barrier.wait()
            while not stop.is_set():
                for r in dead_rids:
                    router.progress(r, 1)
                    snap = router.loads()
                    assert all(v >= 0 for v in snap.values())
        except BaseException as e:
            errors.append(e)

    def failover():
        try:
            barrier.wait()
            router.disable(0)
            for r in dead_rids:
                router.release(r)
                router.release(r)
            for r in dead_rids:
                rep = router.route(r, tokens=weight)
                assert rep is not None and rep.replica_id != 0
        except BaseException as e:
            errors.append(e)
        finally:
            stop.set()

    threads = [threading.Thread(target=prog),
               threading.Thread(target=prog),
               threading.Thread(target=failover)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    loads = router.loads()
    assert loads[0] == 0
    for r in list(range(rid)):
        router.release(r)
    assert sum(router.loads().values()) == 0
    assert router.enabled_count() == 1
    router.enable(0)
    assert router.enabled_count() == 2


@pytest.mark.parametrize("n, pods, group", [(1, 1, None), (4, 1, None),
                                            (4, 1, 2), (4, 2, 1),
                                            (8, 2, 2), (8, 1, 4)])
def test_replica_slices_equal_the_reference(n, pods, group):
    devices = [torch.device("cuda", i) for i in range(n)]
    mine = replica_slices(Topology(intra_group_size=group), pods, devices)
    theirs = ref_mesh.replica_slices(RefTopology(intra_group_size=group),
                                     pods, list(range(n)))
    assert [tuple(d.index for d in s) for s in mine] == \
        [tuple(s) for s in theirs]
    assert all(isinstance(d, torch.device) for s in mine for d in s)
