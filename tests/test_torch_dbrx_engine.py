"""dbrx-132b's ``Engine`` on the port (GQA + MoE, served dropless)
against the JAX engine on the CPU, on its smoke variant at 2 kv heads
from the port's init, carried to the JAX tree by path
(``test_torch_dbrx.py`` holds the model):
token-identical at dispatch depths 1 and 8, greedy, and at depth 8 at
temperature 0.8 / top-k 20, the JAX engine's runs in a module fixture.
"""
import pytest

from test_torch_dbrx import ARCH, SMOKE
from test_torch_engine import WIDE, _workload
from torch_decoders import carried, check_engine, jax_engine_streams
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def models():
    return carried(ARCH, from_port=True, **SMOKE)


@pytest.fixture(scope="module")
def engine_want(models):
    work = _workload(models[0].vocab_size)
    return work, jax_engine_streams(models, work, WIDE,
                                    ("greedy", "sampled"))


@pytest.mark.parametrize("spd,mode", [(1, "greedy"), (8, "greedy"),
                                      (8, "sampled")])
def test_engine_token_identical_to_jax_engine(models, engine_want, spd,
                                              mode):
    work, want = engine_want
    check_engine(models, work, WIDE, want, spd=spd, mode=mode)
