"""The port's Engine against the JAX package's Engine on the same
carried-across weights: greedy token streams must be identical at
dispatch depths 1 and 8, with and without forced preemption (a pool too
small for the live sequences), and equal to sequential greedy decoding
with the port's own full forward.  float32 on the CPU, exact tokens.

The JAX engine runs at depth 1 on the small pool only, once without and
once with eos ids, and the module shares the results: its compiles are
the slow part, and the JAX package's own tests pin that its greedy
output does not depend on depth or pool size.
"""
import numpy as np
import pytest
import torch

from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro_torch.serve import Engine, EngineConfig, Request
from test_torch_model import carried_models
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128,
            num_heads=4, num_kv_heads=2, head_dim=32)
WIDE = dict(max_batch=3, block_size=8, num_blocks=65, max_seq_len=64,
            prefill_chunk=16, prefill_token_budget=24)
# 9 usable blocks x 4 tokens = 36 token slots for ~130 live tokens
SMALL = dict(max_batch=3, block_size=4, num_blocks=10, max_seq_len=32,
             prefill_chunk=8, prefill_token_budget=16)


def _workload(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (int(p),)).astype(np.int32), int(g))
            for p, g in zip(rng.integers(3, 18, 6), rng.integers(2, 14, 6))]


@pytest.fixture(scope="module")
def setup():
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = carried_models(TINY)
    work = _workload(jcfg.vocab_size)
    eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**SMALL))
    res = eng.run([JaxRequest(prompt=p.copy(), max_new_tokens=g, rid=i)
                   for i, (p, g) in enumerate(work)])
    assert eng.metrics_snapshot()["counters"]["preemptions"] > 0
    want = [res[i].tokens for i in range(len(work))]
    # an eos at the 4th token of each stream (the 2nd of a 2-token one)
    eos = {i: int(w[min(3, len(w) - 1)]) for i, w in enumerate(want)}
    eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**SMALL))
    res = eng.run([JaxRequest(prompt=p.copy(), max_new_tokens=g, rid=i,
                              eos_id=eos[i])
                   for i, (p, g) in enumerate(work)])
    want_eos = [res[i].tokens for i in range(len(work))]
    return tmodel, tparams, work, want, eos, want_eos


def _run_port(tmodel, tparams, work, *, spd, ecfg, eos=None):
    eng = Engine(tmodel, tparams, EngineConfig(steps_per_dispatch=spd,
                                               **ecfg), device="cpu")
    eng.warmup()
    res = eng.run([Request(prompt=p.copy(), max_new_tokens=g, rid=i,
                           eos_id=None if eos is None else eos.get(i))
                   for i, (p, g) in enumerate(work)])
    return ([res[i].tokens for i in range(len(work))],
            eng.metrics_snapshot()["counters"])


@pytest.mark.parametrize("spd", [1, 8])
@pytest.mark.parametrize("pool", ["wide", "small"])
def test_engine_token_identical_to_jax_engine(setup, spd, pool):
    tmodel, tparams, work, want, _, _ = setup
    got, counters = _run_port(tmodel, tparams, work, spd=spd,
                              ecfg=WIDE if pool == "wide" else SMALL)
    assert got == want
    assert counters["jit_compiles"] == 0
    assert counters["generated_tokens"] == sum(g for _, g in work)
    if pool == "small":
        assert counters["preemptions"] > 0
    if spd > 1:
        assert counters["loop_dispatches"] > 0


def _sequential_greedy(tmodel, tparams, prompt, max_new):
    """Single-request greedy decoding with the port's full forward."""
    toks = [int(t) for t in prompt]
    out = []
    for _ in range(max_new):
        logits, _, _, _ = tmodel.forward(tparams, torch.tensor([toks]))
        out.append(int(torch.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


def test_engine_equals_sequential_greedy(setup):
    tmodel, tparams, work, want, _, _ = setup
    assert want == [_sequential_greedy(tmodel, tparams, p, g)
                    for p, g in work]


@pytest.mark.parametrize("spd", [1, 8])
def test_engine_eos_stops_inside_step_and_loop(setup, spd):
    tmodel, tparams, work, want, eos, want_eos = setup
    got, _ = _run_port(tmodel, tparams, work, spd=spd, ecfg=SMALL, eos=eos)
    assert got == want_eos
    # streams stop at their eos, except where the reference dispatched
    # the step that fills max_new_tokens before it read the eos (it then
    # keeps that token too; the port reproduces it)
    assert any(len(e) < len(w) for e, w in zip(want_eos, want))


def test_engine_rejects_what_is_not_ported(setup):
    tmodel, tparams, work = setup[:3]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(tmodel, tparams, EngineConfig(fused=False), device="cpu")
    # temperature sampling is ported: it serves (token identity with the
    # JAX engine is tests/test_torch_sampling.py)
    hot = Engine(tmodel, tparams, EngineConfig(temperature=0.8, top_k=5,
                                               **WIDE), device="cpu")
    p, g = work[0]
    res = hot.run([Request(prompt=p.copy(), max_new_tokens=g, rid=0)])
    assert len(res[0].tokens) == g
    # a tensor-parallel slice is ported: it serves (token identity with
    # the reference's sequential decode is tests/test_torch_tp.py)
    tp = Engine(tmodel, tparams, EngineConfig(**WIDE),
                devices=[torch.device("cpu")] * 2)
    assert tp.tp_degree == 2
    res = tp.run([Request(prompt=p.copy(), max_new_tokens=g, rid=2)])
    assert len(res[2].tokens) == g
    # request deadlines and reclaim_requests are ported (the cluster
    # layer's tests are tests/test_torch_cluster.py)
    eng = Engine(tmodel, tparams, EngineConfig(**WIDE), device="cpu")
    res = eng.run([Request(prompt=p.copy(), max_new_tokens=g, rid=1,
                           deadline_s=1e6, queue_deadline_s=1e6)])
    assert len(res[1].tokens) == g and res[1].fault is None
    assert eng.reclaim_requests() == ([], [])
