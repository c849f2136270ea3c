"""One fixture the port's CPU test files share: PyTorch runs its
operators on one intra-op thread while a file's tests run, and gets its
thread count back after.

The suite runs under pytest-xdist, several workers on one machine.  Left
at its default, each worker's PyTorch splits every operator over a
thread per core, and the port's tests, which run thousands of small
operators (engines, trainers, the launchers), then wait at every
operator for threads that the other workers hold: with seven cores kept
busy by other processes, the two launcher tests took 26-28 s each on
the default threads and 0.7-3.4 s on one.  The tests compute the same
thing either way; only the number of threads changes.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
