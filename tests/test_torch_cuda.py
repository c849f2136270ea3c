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
most 2^-7 = 0.0078 of the value); greedy and gumbel sampling exactly
equal; the fused update within one bf16 ulp for bf16 w and 1e-6
relative for f32 state (kernel and plain version round each operation
alike, so they agree exactly in practice).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_view, flash_decode,
                                 fused_update, prng, sampling)
from repro_torch.kernels._common import sm_count

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
    chunk = -(-v // sampling.greedy_chunks(b, v, sm_count(dev)))
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


@pytest.mark.parametrize("b,v", [(1, 1000), (8, 151936), (136, 151936),
                                 (5, 203)])
@pytest.mark.parametrize("top_k", [0, 1, 7, 50])
def test_gumbel_kernel_exact_with_ties(dev, b, v, top_k):
    """Ties planted at the kth value (so more than k columns are kept),
    at the edges of the column chunks and at the last column; noise from
    the reference's threefry draw."""
    gen = torch.Generator(device=dev).manual_seed(v + top_k)
    lg = torch.randn((b, v), generator=gen, device=dev) * 3
    chunk = -(-v // sampling.greedy_chunks(b, v, sm_count(dev)))
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        cols = torch.tensor([min(chunk, v - 1), min(chunk - 1, v - 1),
                             v - 1], device=dev)
        lg[:, cols] = kth.expand(-1, 3)
    keys = prng.sample_keys(3, torch.arange(b, device=dev),
                            torch.full((b,), 17, device=dev))
    g = prng.gumbel(keys, v)
    got = sampling.gumbel_sample(lg, g, temperature=0.8, top_k=top_k)
    want = sampling.gumbel_sample_plain(lg, g, temperature=0.8, top_k=top_k)
    assert torch.equal(got, want)


def test_gumbel_kernel_ties_on_equal_scores(dev):
    """Equal scores (zero noise, equal logits) at a chunk edge and the
    vocab edge go to the lowest column."""
    b, v = 8, 151936
    chunk = -(-v // sampling.greedy_chunks(b, v, sm_count(dev)))
    lg = torch.zeros((b, v), device=dev)
    lg[:, [chunk - 1, chunk, v - 1]] = 5.0
    lg[1, chunk - 1] = 0.0
    g = torch.zeros_like(lg)
    for top_k in (0, 3, 10):
        got = sampling.gumbel_sample(lg, g, temperature=0.7, top_k=top_k)
        assert torch.equal(got, sampling.gumbel_sample_plain(
            lg, g, temperature=0.7, top_k=top_k))
        assert got[0] == chunk - 1 and got[1] == chunk


def test_prng_bits_on_card_equal_cpu(dev):
    keys = prng.sample_keys(11, torch.arange(6), torch.arange(6) * 1000)
    bits = prng.random_bits(keys, 4099)
    torch.testing.assert_close(prng.random_bits(keys.to(dev), 4099).cpu(),
                               bits, atol=0, rtol=0)


@pytest.mark.parametrize("n", [1, 7, 8, 4099, 1 << 20])
@pytest.mark.parametrize("wdt,mdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("mode", ["sgd", "nesterov", "lars"])
def test_fused_update_kernel_matches_plain(dev, n, wdt, mdt, mode):
    gen = torch.Generator(device=dev).manual_seed(n)
    w = torch.randn((n,), generator=gen, device=dev).to(wdt)
    m = torch.randn((n,), generator=gen, device=dev).to(mdt)
    g = torch.randn((n,), generator=gen, device=dev)
    trust = (torch.linalg.vector_norm(w.float()) * 1e-3
             if mode == "lars" else None)
    kw = dict(lr=torch.tensor(0.05, device=dev), trust=trust, momentum=0.9,
              weight_decay=1e-4, nesterov=mode == "nesterov")
    w2, m2 = w.clone(), m.clone()
    before = fused_update.fused_sgd_update.launches
    fused_update.fused_sgd_update(w, m, g, **kw)
    assert fused_update.fused_sgd_update.launches == before + 1
    fused_update.fused_sgd_update_plain(w2, m2, g, **kw)
    if wdt == torch.bfloat16:
        ulp = w2.float().abs() * 2.0 ** -7
        assert torch.all((w.float() - w2.float()).abs() <= ulp)
    else:
        torch.testing.assert_close(w, w2, atol=0, rtol=1e-6)
    if mdt == torch.bfloat16:
        ulp = m2.float().abs() * 2.0 ** -7
        assert torch.all((m.float() - m2.float()).abs() <= ulp)
    else:
        torch.testing.assert_close(m, m2, atol=0, rtol=1e-6)


def test_fused_update_rejects_misaligned(dev):
    w = torch.zeros(17, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        fused_update.fused_sgd_update(w, torch.zeros(16, device=dev),
                                      torch.zeros(16, device=dev), lr=0.1,
                                      momentum=0.9, weight_decay=0.0)


@pytest.mark.parametrize("kind", ["sgd", "lars"])
def test_apply_update_on_card_launches_the_kernel(dev, kind):
    """The optimizer has one route for sgd and lars: on CUDA tensors every
    leaf goes through the kernel, never the plain version."""
    from repro_torch.optim import sgd
    cfg = sgd.OptimConfig(kind=kind)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"a": torch.randn((64, 40), generator=gen, device=dev),
              "b": torch.randn((37,), generator=gen, device=dev)}
    grads = {k: torch.randn(v.shape, generator=gen, device=dev)
             for k, v in params.items()}
    state = sgd.init_state(params, cfg)
    want_p = {k: v.clone() for k, v in params.items()}
    want_m = {k: v.clone() for k, v in state["m"].items()}
    before = fused_update.fused_sgd_update.launches
    sgd.apply_update(params, state, grads, 0.05, cfg)
    assert fused_update.fused_sgd_update.launches == before + 2
    for k in params:
        trust = (sgd.lars_trust(want_p[k], grads[k], cfg)
                 if kind == "lars" else None)
        fused_update.fused_sgd_update_plain(
            want_p[k], want_m[k], grads[k], lr=0.05, trust=trust,
            momentum=cfg.momentum, weight_decay=cfg.weight_decay)
        torch.testing.assert_close(params[k], want_p[k], atol=0, rtol=1e-6)
        torch.testing.assert_close(state["m"][k], want_m[k], atol=0,
                                   rtol=1e-6)
