"""The port's CUDA kernels against their plain versions on the card, over
the shapes the CPU tests sweep (head dims 64/128, GQA groups 1/2/6,
windows, chunks of queries, float32 and bfloat16, trash and frontier
garbage).  They need a CUDA card and skip elsewhere; on the card
(``--noconftest``: the suite's conftest imports jax, which the card's
machine need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 within atol/rtol 1e-4 (two f32 softmax orders);
bfloat16 within atol 1e-3 + rtol 1e-2 (kernel and plain version both
round an f32 result to bf16, so they may differ by one bf16 ulp, at
most 2^-7 = 0.0078 of the value); greedy exactly equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_view, flash_decode, sampling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dt):
    return (dict(atol=1e-4, rtol=1e-4) if dt == torch.float32
            else dict(atol=1e-3, rtol=1e-2))


PAGED = [
    # nb, bs, kv, g, hd, b, c, nb_seq, window
    (16, 8, 2, 2, 64, 3, 1, 4, 0),
    (9, 16, 1, 1, 128, 2, 1, 4, 0),
    (40, 16, 2, 6, 128, 3, 1, 12, 20),
    (16, 8, 2, 2, 64, 3, 5, 4, 0),
    (64, 16, 1, 6, 64, 2, 37, 12, 11),
]


@pytest.mark.parametrize("case", PAGED)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_kernel_matches_plain(dev, case, dt):
    nb, bs, kv, g, hd, b, c, nb_seq, window = case
    gen = torch.Generator(device=dev).manual_seed(sum(case))
    q = torch.randn((b, c, kv * g, hd), generator=gen, device=dev).to(dt)
    kp = torch.randn((nb, bs, kv, hd), generator=gen, device=dev).to(dt)
    vp = torch.randn((nb, bs, kv, hd), generator=gen, device=dev).to(dt)
    kp[0], vp[0] = 1e3, -1e3                        # trash garbage
    rng = np.random.default_rng(sum(case))
    bt = torch.tensor(rng.permutation(np.arange(1, nb))[:b * nb_seq]
                      .reshape(b, nb_seq), dtype=torch.int32, device=dev)
    bt[0, -1] = 0                                   # a trash placeholder
    pos = torch.tensor(rng.integers(0, (nb_seq - 1) * bs - c + 1, (b,)),
                       dtype=torch.int32, device=dev)
    got = flash_decode.flash_decode_paged(q, kp, vp, bt, pos, window=window)
    want = flash_decode.flash_decode_paged_plain(q, kp, vp, bt, pos,
                                                 window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


VIEW = [(3, 41, 2, 3, 64, 0), (2, 129, 1, 6, 128, 0), (2, 65, 2, 2, 128, 20),
        (4, 33, 2, 1, 64, 7)]


@pytest.mark.parametrize("case", VIEW)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_decode_view_kernel_matches_plain(dev, case, dt):
    b, s, kv, g, hd, window = case
    gen = torch.Generator(device=dev).manual_seed(sum(case))
    q = torch.randn((b, kv * g, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
    k[:, -1], v[:, -1] = 1e3, -1e3                  # trash slot garbage
    pos = torch.randint(0, s - 1, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    got = decode_view.decode_view_attend(q, k, v, pos, window=window)
    want = decode_view.decode_view_attend_plain(q, k, v, pos, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


@pytest.mark.parametrize("b,v", [(5, 203), (3, 1000), (8, 4096), (2, 151936),
                                 (264, 151936)])
def test_greedy_kernel_exact_with_ties(dev, b, v):
    gen = torch.Generator(device=dev).manual_seed(v)
    lg = torch.randn((b, v), generator=gen, device=dev) * 3
    top = lg.max().item() + 1
    lg[0, [7, v - 1]] = top
    lg[-1, [v - 1, v // 3]] = top
    got = sampling.greedy_sample(lg)
    assert torch.equal(got, sampling.greedy_sample_plain(lg))
    assert int(got[0]) == 7 and int(got[-1]) == v // 3


def test_greedy_kernel_ties_at_chunk_edges(dev):
    """A row cut into column chunks: equal maxima at the last column of
    one chunk and the first of the next, and in the last chunk, go to
    the lowest column."""
    b, v = 8, 151936
    chunk = -(-v // sampling.greedy_chunks(b, v))
    lg = torch.zeros((b, v), device=dev)
    lg[:, [chunk - 1, chunk, v - 1]] = 5.0
    lg[1, chunk - 1] = 0.0
    lg[2, :chunk + 1] = 0.0
    got = sampling.greedy_sample(lg).tolist()
    assert got[0] == chunk - 1 and got[1] == chunk and got[2] == v - 1
    assert torch.equal(sampling.greedy_sample(lg),
                       sampling.greedy_sample_plain(lg))


def test_wrapper_counts_kernel_launches(dev):
    before = sampling.greedy_sample.launches
    sampling.greedy_sample(torch.zeros((2, 9), device=dev))
    assert sampling.greedy_sample.launches == before + 1
