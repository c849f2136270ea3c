"""The port's fault model (``repro_torch.serve.faults``) against the JAX
package's (``repro.serve.faults``): the same backoff delays and the same
seeded kill plans for the same seeds, the same defaults, and each
``FaultPlan`` action firing exactly once, as the reference's
``tests/test_serve_faults.py`` pins its own.  Pure Python, no model."""
import dataclasses
import threading
import time

import pytest

from repro.serve import faults as ref
from repro_torch.serve import faults
from repro_torch.serve import (FaultAction, FaultInjected, FaultPlan,
                               HealthConfig, ReplicaKilled, ReplicaState,
                               RetryPolicy)
from torch_threads import one_torch_thread  # noqa: F401


def test_fault_plan_deterministic_and_consume_once():
    a = FaultPlan.seeded_kill(seed=7, num_replicas=4)
    b = FaultPlan.seeded_kill(seed=7, num_replicas=4)
    assert a.planned() == b.planned()            # same seed, same plan
    (act,) = a.planned()
    assert act.kind == "kill" and 2 <= act.dispatch <= 10
    plan = FaultPlan([FaultAction(0, 3, "delay", delay_s=0.0)])
    plan.apply(0, 0)                             # no action scheduled
    plan.apply(0, 3)                             # fires
    assert [f.dispatch for f in plan.fired()] == [3]
    plan.apply(0, 3)                             # consumed: fires once
    assert len(plan.fired()) == 1
    with pytest.raises(ValueError):
        FaultPlan([FaultAction(0, 0, "explode")])


def test_retry_policy_backoff_deterministic_and_bounded():
    pol = RetryPolicy(max_attempts=5, backoff_base_s=0.01,
                      backoff_factor=2.0, backoff_max_s=0.05, jitter=0.25)
    assert pol.delay_s(0, rid=1) == 0.0
    for attempt in range(1, 6):
        d1 = pol.delay_s(attempt, rid=42)
        d2 = pol.delay_s(attempt, rid=42)
        assert d1 == d2                          # deterministic jitter
        assert 0.0 < d1 <= 0.05 * 1.25           # bounded by max * jitter
    assert pol.delay_s(1, rid=1) != pol.delay_s(1, rid=2)  # per-rid draw


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("knobs", [
    {}, dict(backoff_base_s=0.01, backoff_factor=3.0, backoff_max_s=0.2,
             jitter=0.5)])
def test_retry_delays_equal_the_reference(seed, knobs):
    mine = RetryPolicy(seed=seed, **knobs)
    theirs = ref.RetryPolicy(seed=seed, **knobs)
    for rid in range(0, 200, 7):
        for attempt in range(0, 8):
            assert mine.delay_s(attempt, rid) == theirs.delay_s(attempt, rid)


@pytest.mark.parametrize("num_replicas", [1, 2, 4, 7])
def test_seeded_kill_plans_equal_the_reference(num_replicas):
    for seed in range(64):
        for lo, hi in ((2, 10), (0, 3), (5, 5)):
            mine = FaultPlan.seeded_kill(seed, num_replicas, lo, hi)
            theirs = ref.FaultPlan.seeded_kill(seed, num_replicas, lo, hi)
            assert [dataclasses.astuple(a) for a in mine.planned()] == \
                [dataclasses.astuple(a) for a in theirs.planned()]


def test_defaults_and_states_equal_the_reference():
    for mine, theirs in ((HealthConfig(), ref.HealthConfig()),
                         (RetryPolicy(), ref.RetryPolicy()),
                         (FaultAction(0, 0, "kill"),
                          ref.FaultAction(0, 0, "kill"))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert [(s.name, s.value) for s in ReplicaState] == \
        [(s.name, s.value) for s in ref.ReplicaState]
    assert faults._KINDS == ref._KINDS


def test_each_action_fires_once_as_it_says():
    plan = FaultPlan([FaultAction(0, 1, "kill"), FaultAction(1, 1, "error"),
                      FaultAction(0, 2, "delay", delay_s=0.01),
                      FaultAction(1, 2, "hang")], hang_timeout_s=30.0)
    assert len(plan.planned()) == 4
    with pytest.raises(ReplicaKilled, match="replica 0 dispatch 1"):
        plan.apply(0, 1)
    with pytest.raises(FaultInjected, match="replica 1 dispatch 1"):
        plan.apply(1, 1)
    t0 = time.monotonic()
    plan.apply(0, 2)
    assert time.monotonic() - t0 >= 0.01
    hung = threading.Thread(target=plan.apply, args=(1, 2))
    try:
        hung.start()
        hung.join(0.05)
        assert hung.is_alive()                  # blocked on the hang
    finally:
        plan.release_hangs()
    hung.join(30.0)
    assert not hung.is_alive()
    for r, k in ((0, 1), (1, 1), (0, 2), (1, 2)):
        plan.apply(r, k)                        # consumed: nothing fires
    assert sorted((a.replica, a.dispatch) for a in plan.fired()) == \
        [(0, 1), (0, 2), (1, 1), (1, 2)]
    assert sorted(plan.planned(), key=dataclasses.astuple) == \
        sorted(plan.fired(), key=dataclasses.astuple)
    # released before it fires: a later hang does not block at all
    later = FaultPlan([FaultAction(0, 0, "hang")], hang_timeout_s=30.0)
    later.release_hangs()
    t0 = time.monotonic()
    later.apply(0, 0)
    assert time.monotonic() - t0 < 5.0 and len(later.fired()) == 1
