"""The port's copies of the host-side serve modules (kv_cache, scheduler,
telemetry) behave as the JAX package's originals: the same seeded random
walks of operations drive one instance of each and must return the same
values and reach the same states at every step."""
import numpy as np
import pytest

from repro.serve import kv_cache as j_kv
from repro.serve import scheduler as j_sched
from repro.serve import telemetry as j_tel
from repro_torch.serve import kv_cache as t_kv
from repro_torch.serve import scheduler as t_sched
from repro_torch.serve import telemetry as t_tel
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("window", [0, 16])
def test_paged_kv_cache_random_walk_matches(window):
    rng = np.random.default_rng(window + 1)
    caches = [m.PagedKVCache(33, 4, 12, window=window) for m in (j_kv, t_kv)]
    regs = [m.MetricsRegistry() for m in (j_tel, t_tel)]
    for c, r in zip(caches, regs):
        c.attach_metrics(r, replica=0)
    front = {}
    for _ in range(400):
        rid = int(rng.integers(0, 6))
        op = rng.random()
        if op < 0.4:
            n = front.get(rid, 0) + int(rng.integers(1, 6))
            outs = [c.ensure_capacity(rid, n, query_start=max(n - 1, 0))
                    for c in caches]
            if outs[0]:
                front[rid] = n
        elif op < 0.7:
            n = front.get(rid, 0) + int(rng.integers(1, 9))
            outs = [c.reserve(rid, n, query_start=front.get(rid, 0))
                    for c in caches]
        else:
            outs = [c.free_seq(rid) for c in caches]
            front.pop(rid, None)
        assert outs[0] == outs[1]
        rids = [None, *range(6)]
        np.testing.assert_array_equal(caches[0].table_array(rids),
                                      caches[1].table_array(rids))
        assert caches[0].allocator.num_free == caches[1].allocator.num_free
    assert regs[0].snapshot() == regs[1].snapshot()


def test_allocators_random_walk_match():
    rng = np.random.default_rng(7)
    blocks = [m.BlockAllocator(num_blocks=20, block_size=4)
              for m in (j_kv, t_kv)]
    slots = [m.StateSlotAllocator(6) for m in (j_kv, t_kv)]
    held = []
    for _ in range(300):
        if held and rng.random() < 0.45:
            got = held.pop(int(rng.integers(len(held))))
            for a in blocks:
                a.free(got)
        else:
            n = int(rng.integers(1, 5))
            got = [a.alloc(n) for a in blocks]
            assert got[0] == got[1]
            if got[0] is not None:
                held.append(got[0])
        assert blocks[0].num_free == blocks[1].num_free
        rid = int(rng.integers(0, 8))
        if rng.random() < 0.5:
            assert slots[0].alloc(rid) == slots[1].alloc(rid)
        else:
            for s in slots:
                s.free_if_held(rid)
        assert [slots[0].slot_of(r) for r in range(8)] == \
            [slots[1].slot_of(r) for r in range(8)]


def test_scheduler_random_walk_matches():
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 50, int(n)) for n in rng.integers(1, 40, 12)]
    sides = []
    for kv_mod, sched_mod in ((j_kv, j_sched), (t_kv, t_sched)):
        kv = kv_mod.PagedKVCache(40, 4, 16)
        sched = sched_mod.Scheduler(4, 8, 16, max_chunks_per_step=2)
        reqs = [sched_mod.Request(prompt=p.copy(), max_new_tokens=4, rid=i)
                for i, p in enumerate(prompts)]
        sides.append((kv, sched, reqs))
    live = set()
    for step in range(60):
        if step < len(prompts):
            for _, sched, reqs in sides:
                sched.add(reqs[step])
        plans = []
        for kv, sched, _ in sides:
            plan = sched.schedule(len(live), kv)
            plans.append([(ch.req.rid, ch.start, ch.length) for ch in plan])
        assert plans[0] == plans[1]
        for rid, start, length in plans[0]:
            if start + length >= len(prompts[rid]):
                live.add(rid)
        if live and rng.random() < 0.3:
            rid = sorted(live)[int(rng.integers(len(live)))]
            live.discard(rid)
            gen = list(rng.integers(0, 50, 2))
            for kv, sched, reqs in sides:
                kv.free_seq(rid)
                sched.preempt(reqs[rid], gen)
        assert sides[0][1].has_waiting == sides[1][1].has_waiting


def test_telemetry_traces_and_histograms_match():
    rng = np.random.default_rng(5)
    tels = [m.Telemetry() for m in (j_tel, t_tel)]
    hists = [m.LatencyHists(t.registry, replica=0)
             for m, t in zip((j_tel, t_tel), tels)]
    t = 0.0
    for rid in range(30):
        for ev in ("submit", "admit", "prefill_start", "first_token"):
            t += float(rng.exponential(0.01))
            for tel in tels:
                tel.requests.stamp(rid, ev, t=t)
        for tel in tels:
            tel.requests.note_dispatch(rid)
        t += float(rng.exponential(0.05))
        kind = "complete" if rid % 7 else "cancel"
        ntok = int(rng.integers(1, 20))
        for tel, h in zip(tels, hists):
            tel.requests.finish(rid, kind, tokens=ntok, replica=0, hists=h,
                                t=t)
            # a second terminal is refused and counted on both
            assert tel.requests.finish(rid, "complete", t=t) is None
    assert tels[0].registry.snapshot() == tels[1].registry.snapshot()
    assert [tr.as_dict() for tr in tels[0].requests.traces()] == \
        [tr.as_dict() for tr in tels[1].requests.traces()]
