"""The port's CUDA kernels against their plain versions on the card, over
the shapes the CPU tests sweep (head dims 64/120/128/256, GQA groups
1/2/4/6/7/10,
windows, chunks of queries, float32 and bfloat16, trash and frontier
garbage).  They need a CUDA card and skip elsewhere; on the card
(``--noconftest``: the suite's conftest imports jax, which the card's
machine need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 within atol/rtol 1e-4 (two f32 softmax orders);
bfloat16 within atol 1e-3 + rtol 1e-2 (kernel and plain version both
round an f32 result to bf16, so they may differ by one bf16 ulp, at
most 2^-7 = 0.0078 of the value); greedy and gumbel sampling exactly
equal (gumbel at every cluster size the plan takes for a vocabulary);
the fused update within one bf16 ulp for bf16 w and 1e-6 relative for
f32 state (kernel
and plain version round each operation alike, so they agree exactly in
practice), LARS's trust within ``fused_update.LARS_TRUST_RTOL`` of the
plain one (norms summed in another order) and bit for bit from run to
run; the slot gather and scatter bit for bit (the scatter on
every slot but trash slot 0, and on slot 0 too where the destinations
are distinct); the SSD block within
|kernel - plain| <= a * max|plain| + r * |plain|, a = r = 1e-4 for
float32 outputs (f32 sums over up to 256 keys and 256 state columns in
another order) and a = 1e-3, r = 1e-2 for bfloat16 y (one bf16 ulp);
the MLA attends, the flash attention (kernel 6) and the contiguous-cache
decode (kernel 7) as the other attention kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_view, flash_attention, flash_decode,
                                 fused_update, mla_decode, prng, sampling,
                                 slot_state, ssd_chunk)
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


# kernel 1: the bf16 template's narrow layout (C*G <= 16: one 16-row
# tile, keys over the warps) and wide layout (64-row tiles), split and
# unsplit; the engine's prefill chunk (B=2, C=128) and a mixed step
# (B=136, C=1) at qwen2's G = 6, hd 128 over 40-block tables; wide tiles
# whose last tile is ragged (C*G = 78, 100, 222; window 40 and 11), a
# wide tile with only 24 live rows (G = 8, C = 3), G = 1 and G = 8, and
# windows whose first key starts a split off a chunk edge (both layouts)
PAGED = [
    # nb, bs, kv, g, hd, b, c, nb_seq, window
    (16, 8, 2, 2, 64, 3, 1, 4, 0),
    (9, 16, 1, 1, 128, 2, 1, 4, 0),
    (40, 16, 2, 6, 128, 3, 1, 12, 20),
    (16, 8, 2, 2, 64, 3, 5, 4, 0),
    (64, 16, 1, 6, 64, 2, 37, 12, 11),
    (81, 16, 2, 6, 128, 2, 128, 40, 0),
    (5441, 16, 2, 6, 128, 136, 1, 40, 0),
    (40, 16, 2, 6, 128, 3, 13, 12, 40),
    (30, 16, 2, 1, 128, 2, 100, 14, 0),
    (40, 16, 1, 8, 128, 4, 1, 9, 0),
    (40, 16, 1, 8, 64, 3, 3, 9, 25),
    (81, 16, 2, 6, 128, 2, 128, 40, 300),
    (120, 16, 2, 6, 128, 3, 1, 36, 300),
    # hd 256 at recurrentgemma's MQA (G = 10 over one kv head): the decode
    # bucket over 160-block tables with the 2048 window masking keys, the
    # 2 x 128 prefill chunk (wide, 32-key chunks), a mixed step of 136
    # rows (unsplit), a ragged wide tile under a short window, and G = 1
    # wide
    (1281, 16, 1, 10, 256, 8, 1, 160, 2048),
    (321, 16, 1, 10, 256, 2, 128, 160, 2048),
    (1361, 16, 1, 10, 256, 136, 1, 10, 2048),
    (121, 16, 1, 10, 256, 3, 37, 40, 100),
    (41, 16, 1, 1, 256, 2, 40, 20, 0),
    # hd 120 at h2o-danube-3's GQA (G = 4 over 8 kv heads, window 4096):
    # its decode bucket, the 2 x 128 prefill chunk, a 136-row mixed step,
    # its long request's chunk past the window over 288-block tables; a
    # ragged wide tile under a short window, and G = 1
    (321, 16, 8, 4, 120, 8, 1, 40, 4096),
    (81, 16, 8, 4, 120, 2, 128, 40, 4096),
    (5441, 16, 8, 4, 120, 136, 1, 40, 4096),
    (289, 16, 8, 4, 120, 1, 128, 288, 4096),
    (64, 16, 2, 4, 120, 2, 37, 12, 11),
    (40, 16, 2, 1, 120, 3, 1, 12, 20),
    # G = 7 at hd 128 (llava-next's 56 heads over 8): the decode bucket
    # and the prefill chunk (14 wide tiles, the last ragged)
    (321, 16, 8, 7, 128, 8, 1, 40, 0),
    (81, 16, 8, 7, 128, 2, 128, 40, 0),
]


def _paged_inputs(dev, case, dt):
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
    return q, kp, vp, bt, pos


@pytest.mark.parametrize("case", PAGED)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_kernel_matches_plain(dev, case, dt):
    window = case[-1]
    q, kp, vp, bt, pos = _paged_inputs(dev, case, dt)
    got = flash_decode.flash_decode_paged(q, kp, vp, bt, pos, window=window)
    want = flash_decode.flash_decode_paged_plain(q, kp, vp, bt, pos,
                                                 window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


@pytest.mark.parametrize("case", [PAGED[5], PAGED[9], PAGED[13], PAGED[14]])
def test_flash_decode_bf16_split_launches_repeat_bit_for_bit(dev, case):
    """The split partials are merged in split order, never in arrival
    order, so two launches of a split bf16 case (wide: the prefill
    chunk; narrow: a decode row) agree bit for bit, paged and
    contiguous."""
    _, bs, kv, g, hd, b, c, nb_seq, window = case
    _, nsplit = flash_decode.launch_splits(
        b, c, kv * g, kv, nb_seq * bs, window, dtype=torch.bfloat16,
        sms=sm_count(dev), hd=hd)
    assert nsplit > 1
    q, kp, vp, bt, pos = _paged_inputs(dev, case, torch.bfloat16)
    first = flash_decode.flash_decode_paged(q, kp, vp, bt, pos, window=window)
    again = flash_decode.flash_decode_paged(q, kp, vp, bt, pos, window=window)
    assert torch.equal(first, again)
    s = nb_seq * bs
    kc = kp[bt.long()].reshape(b, s, kv, hd)
    vc = vp[bt.long()].reshape(b, s, kv, hd)
    ln = torch.tensor(s, dtype=torch.int32, device=dev)
    qd = q[:, 0].contiguous()
    assert flash_decode.launch_splits(b, 1, kv * g, kv, s,
                                      dtype=torch.bfloat16,
                                      sms=sm_count(dev), hd=hd)[1] > 1
    assert torch.equal(flash_decode.flash_decode(qd, kc, vc, ln),
                       flash_decode.flash_decode(qd, kc, vc, ln))


# kernel 2: b, S+1, kv, g, hd, window; the last two at qwen2's G = 6 over
# views of 641 slots (split in bf16: 10 splits, a window's first key off
# a chunk edge) and G = 8 at hd 64 with a window
VIEW = [(3, 41, 2, 3, 64, 0), (2, 129, 1, 6, 128, 0), (2, 65, 2, 2, 128, 20),
        (4, 33, 2, 1, 64, 7), (3, 641, 2, 6, 128, 300),
        (2, 300, 1, 8, 64, 45),
        # hd 256, G = 10: views of 2561 slots past the 2048 window, and
        # shorter ones with and without a window
        (8, 2561, 1, 10, 256, 2048), (2, 300, 1, 10, 256, 0),
        (3, 641, 1, 10, 256, 100),
        # hd 120 (h2o's G = 4 over 8 kv heads, and G = 1 under a window)
        # and G = 7 at hd 128 (llava's), over the engine's 641-slot views
        (8, 641, 8, 4, 120, 4096), (3, 300, 2, 1, 120, 45),
        (8, 641, 8, 7, 128, 0)]


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


def _view_as_pool(k, v, bs):
    """The first (S+1) - 1 slots of views (B, S+1, KV, hd) as a block
    pool of bs-slot blocks (block 0 the trash, holding garbage) and each
    row's table: the same keys kernel 1 reads through its tables."""
    b, s1, kv, hd = k.shape
    nb_seq = (s1 - 1) // bs
    def pool(x):
        blocks = x[:, :nb_seq * bs].reshape(b * nb_seq, bs, kv, hd)
        trash = torch.full((1, bs, kv, hd), 1e3, dtype=x.dtype,
                           device=x.device)
        return torch.cat([trash, blocks]).contiguous()
    bt = (1 + torch.arange(b * nb_seq, dtype=torch.int32,
                           device=k.device)).reshape(b, nb_seq)
    return pool(k), pool(v), bt


@pytest.mark.parametrize("b", [8, 4, 2])
def test_decode_view_bf16_equals_kernel1_bit_for_bit(dev, b):
    """At the engine's decode buckets (qwen2's heads, views of 40 blocks
    of 16 plus the trash slot) kernel 2 in bf16 runs kernel 1's template,
    arithmetic and split plan over the same keys, so a view and the pool
    holding its keys give the same bits."""
    h, kv, hd, bs, s1 = 12, 2, 128, 16, 641
    gen = torch.Generator(device=dev).manual_seed(b)
    dt = torch.bfloat16
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, s1, kv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, s1, kv, hd), generator=gen, device=dev).to(dt)
    k[:, -1], v[:, -1] = 1e3, -1e3                  # trash slot garbage
    pos = torch.randint(0, s1 - 1, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = s1 - 2                                 # a full view
    kp, vp, bt = _view_as_pool(k, v, bs)
    assert decode_view.launch_splits(b, h, kv, s1, dtype=dt,
                                     sms=sm_count(dev)) == \
        flash_decode.launch_splits(b, 1, h, kv, (s1 - 1), dtype=dt,
                                   sms=sm_count(dev))
    got = decode_view.decode_view_attend(q, k, v, pos)
    want = flash_decode.flash_decode_paged(q[:, None].contiguous(), kp, vp,
                                           bt, pos)[:, 0]
    assert torch.equal(got, want)


def test_decode_view_bf16_split_launches_repeat_bit_for_bit(dev):
    b, s1, kv, g, hd, window = VIEW[4]
    _, nsplit = decode_view.launch_splits(b, kv * g, kv, s1, window,
                                          dtype=torch.bfloat16,
                                          sms=sm_count(dev))
    assert nsplit > 1
    gen = torch.Generator(device=dev).manual_seed(7)
    dt = torch.bfloat16
    q = torch.randn((b, kv * g, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, s1, kv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, s1, kv, hd), generator=gen, device=dev).to(dt)
    pos = torch.tensor([s1 - 2, 17, 400], dtype=torch.int32, device=dev)
    for w in (0, window):
        first = decode_view.decode_view_attend(q, k, v, pos, window=w)
        again = decode_view.decode_view_attend(q, k, v, pos, window=w)
        assert torch.equal(first, again)


def _off_boundary(x):
    """x's values in a contiguous tensor one element past a 16-byte
    boundary (an offset view of a flat buffer)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("entry", ["decode_view_attend", "flash_decode",
                                   "flash_decode_paged", "flash_attention"])
def test_attention_wrappers_reject_misaligned_q(dev, entry):
    """The bf16 templates copy Q with 16-byte cp.async, so a contiguous
    but misaligned Q must raise in the wrapper, not fault on the card."""
    gen = torch.Generator(device=dev).manual_seed(3)
    dt = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    b, h, kv, hd, s = 2, 4, 2, 64, 32
    pos = torch.tensor([5, s - 1], dtype=torch.int32, device=dev)
    if entry == "decode_view_attend":
        k, v = rand(b, s + 1, kv, hd), rand(b, s + 1, kv, hd)
        call = lambda q: decode_view.decode_view_attend(q, k, v, pos)
        q = rand(b, h, hd)
    elif entry == "flash_decode":
        k, v = rand(b, s, kv, hd), rand(b, s, kv, hd)
        ln = torch.tensor(s, dtype=torch.int32, device=dev)
        call = lambda q: flash_decode.flash_decode(q, k, v, ln)
        q = rand(b, h, hd)
    elif entry == "flash_decode_paged":
        bs = 16
        kp, vp = rand(1 + 2 * b, bs, kv, hd), rand(1 + 2 * b, bs, kv, hd)
        bt = (1 + torch.arange(2 * b, dtype=torch.int32,
                               device=dev)).reshape(b, 2)
        call = lambda q: flash_decode.flash_decode_paged(q, kp, vp, bt,
                                                         pos - 1)
        q = rand(b, 1, h, hd)
    else:
        k, v = rand(b, s, kv, hd), rand(b, s, kv, hd)
        call = lambda q: flash_attention.flash_attention(q, k, v,
                                                         causal=True)
        q = rand(b, s, h, hd)
    want = call(q)                       # the aligned call launches
    assert want.shape == q.shape and torch.isfinite(want.float()).all()
    bad = _off_boundary(q)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        call(bad)
    torch.cuda.synchronize()             # nothing faulted on the card


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
    """A row cut into the plan's cluster slices: equal maxima at the last
    column of one slice and the first of the next, and in the last
    slice, go to the lowest column, at every cluster size the plan takes
    for qwen2's vocab."""
    v = 151936
    sizes = {}
    for b in range(3, 2 * sm_count(dev) + 1):
        sizes.setdefault(sampling.greedy_plan(b, v, sm_count(dev)), b)
    assert max(sizes) > 1
    for cluster, b in sizes.items():
        sl = sampling.gumbel_slice(v, cluster)
        edge = sl if cluster > 1 else v // 2
        lg = torch.zeros((b, v), device=dev)
        lg[:, [edge - 1, edge, v - 1]] = 5.0
        lg[1, edge - 1] = 0.0
        lg[2, :edge + 1] = 0.0
        got = sampling.greedy_sample(lg).tolist()
        assert got[:3] == [edge - 1, edge, v - 1], cluster
        assert torch.equal(sampling.greedy_sample(lg),
                           sampling.greedy_sample_plain(lg))


@pytest.mark.parametrize("v", [151936, 50280, 1537])
def test_greedy_kernel_nan_and_neg_inf_rows(dev, v):
    """A NaN wins its row (the first NaN, also across slices), a row of
    -inf gives column 0, and a row of -inf with one finite column gives
    that column, at every cluster size the plan takes for V."""
    sizes = {}
    for b in range(4, 2 * sm_count(dev) + 1):
        sizes.setdefault(sampling.greedy_plan(b, v, sm_count(dev)), b)
    gen = torch.Generator(device=dev).manual_seed(v)
    for cluster, b in sizes.items():
        sl = sampling.gumbel_slice(v, cluster)
        lg = torch.randn((b, v), generator=gen, device=dev)
        lg[0] = -float("inf")
        lg[1, [min(sl + 3, v - 1), v - 1]] = float("nan")
        lg[2, [11, v - 2]] = float("nan")
        lg[3] = -float("inf")
        lg[3, v - 3] = -1e30
        got = sampling.greedy_sample(lg)
        assert torch.equal(got, sampling.greedy_sample_plain(lg)), cluster
        assert got.tolist()[:4] == [0, min(sl + 3, v - 1), 11, v - 3]


def test_greedy_kernel_is_one_launch_a_call(dev):
    """One kernel node a call in a captured CUDA graph (no memset, no
    merge kernel), at the plan's cluster sizes for 8 and 264 rows."""
    for b in (8, 264):
        lg = torch.randn((b, 151936), device=dev)
        before = sampling.greedy_sample.launches
        kernels, nodes = _graph_kernels(
            lambda: sampling.greedy_sample(lg), calls=4)
        assert (kernels, nodes) == (4, 4)
        assert sampling.greedy_sample.launches == before + 5


def test_wrapper_counts_kernel_launches(dev):
    before = sampling.greedy_sample.launches
    sampling.greedy_sample(torch.zeros((2, 9), device=dev))
    assert sampling.greedy_sample.launches == before + 1


def _graph_kernels(fn, calls=4):
    """Kernel nodes of a CUDA graph that captures ``calls`` calls of
    ``fn`` (one call first, outside the capture)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    kind, kernels = ctypes.c_int(-1), 0
    for node in nodes:
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kernels += kind.value == 0              # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels, n.value


def _slice_edges(v, cluster):
    """Columns on both sides of each edge between the slices of kernel
    4's cluster CTAs (``gumbel_slice``), and the last column."""
    sl = sampling.gumbel_slice(v, cluster)
    cols = {v - 1}
    for r in range(1, cluster):
        if r * sl < v:
            cols |= {r * sl - 1, r * sl}
    return sorted(cols)


def _plan_rows(v, top_k, sms, least=1):
    """{cluster size: rows} for every cluster size ``gumbel_plan`` takes
    over ``v``-column rows: the fewest rows (from ``least`` up to 2 x
    ``sms``) at which it does."""
    sizes = {}
    for b in range(least, 2 * sms + 1):
        sizes.setdefault(sampling.gumbel_plan(b, v, sms, top_k), b)
    return sizes


@pytest.mark.parametrize("v", [1000, 151936, 50280, 129280, 203, 4096])
@pytest.mark.parametrize("top_k", [0, 1, 7, 50])
def test_gumbel_kernel_exact_with_ties(dev, v, top_k):
    """At every cluster size the plan takes for V (each at the fewest
    rows that make it): ties planted at the kth value (so more than k
    columns are kept) on both sides of every slice edge and at the last
    column; noise from the reference's threefry draw."""
    gen = torch.Generator(device=dev).manual_seed(v + top_k)
    for cluster, b in _plan_rows(v, top_k, sm_count(dev)).items():
        lg = torch.randn((b, v), generator=gen, device=dev) * 3
        keys = prng.sample_keys(3, torch.arange(b, device=dev),
                                torch.full((b,), 17, device=dev))
        g = prng.gumbel(keys, v)
        if top_k:
            kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
            cols = torch.tensor(_slice_edges(v, cluster), device=dev)
            lg[:, cols] = kth.expand(-1, len(cols))
        got = sampling.gumbel_sample(lg, g, temperature=0.8, top_k=top_k)
        want = sampling.gumbel_sample_plain(lg, g, temperature=0.8,
                                            top_k=top_k)
        assert torch.equal(got, want), (cluster, b, top_k)


@pytest.mark.parametrize("v", [151936, 50280, 4096])
def test_gumbel_kernel_ties_on_equal_scores(dev, v):
    """Equal scores (zero noise, equal logits) on both sides of each
    slice edge and at the vocab edge go to the lowest column, at every
    cluster size the plan takes for V."""
    for top_k in (0, 3, 10):
        for cluster, b in _plan_rows(v, top_k, sm_count(dev), 3).items():
            edges = _slice_edges(v, cluster)
            g = torch.zeros((b, v), device=dev)
            lg = torch.zeros((b, v), device=dev)
            lg[:, edges] = 5.0
            want = [edges[0]]
            if len(edges) >= 3:
                lg[1, edges[0]] = 0.0
                lg[2, :edges[-2] + 1] = 0.0
                want = [edges[0], edges[1], edges[-1]]
            got = sampling.gumbel_sample(lg, g, temperature=0.7,
                                         top_k=top_k)
            assert torch.equal(got, sampling.gumbel_sample_plain(
                lg, g, temperature=0.7, top_k=top_k))
            assert got.tolist()[:len(want)] == want, (cluster, top_k)


@pytest.mark.parametrize("top_k", [0, 1, 5])
def test_gumbel_kernel_nan_and_neg_inf_rows(dev, top_k):
    """A NaN wins its row (the first NaN, also across slices), a row of
    -inf gives column 0, and a row of equal logits (every column a
    top-k candidate: each CTA's list overflows and the select reads its
    whole slice) goes by the noise, at every cluster size the plan takes
    for V."""
    v = 50280
    gen = torch.Generator(device=dev).manual_seed(top_k)
    for cluster, b in _plan_rows(v, top_k, sm_count(dev), 4).items():
        sl = sampling.gumbel_slice(v, cluster)
        g = torch.randn((b, v), generator=gen, device=dev)
        lg = torch.randn((b, v), generator=gen, device=dev)
        lg[0] = -float("inf")
        lg[1, [min(sl + 3, v - 1), v - 1]] = float("nan")
        lg[2, 11] = float("nan")
        lg[3] = 1.5
        got = sampling.gumbel_sample(lg, g, temperature=0.8, top_k=top_k)
        assert torch.equal(got, sampling.gumbel_sample_plain(
            lg, g, temperature=0.8, top_k=top_k)), cluster
        assert got.tolist()[:3] == [0, min(sl + 3, v - 1), 11]


@pytest.mark.parametrize("top_k", [0, 50])
def test_gumbel_kernel_is_one_launch_a_call(dev, top_k):
    """One kernel node a call in a captured CUDA graph (no memset, no
    merge kernel), at the plan's cluster sizes for 8 and 136 rows."""
    for b in (8, 136):
        lg = torch.randn((b, 151936), device=dev)
        g = torch.randn_like(lg)
        before = sampling.gumbel_sample.launches
        kernels, nodes = _graph_kernels(lambda: sampling.gumbel_sample(
            lg, g, temperature=0.8, top_k=top_k), calls=4)
        assert (kernels, nodes) == (4, 4)
        assert sampling.gumbel_sample.launches == before + 5


def test_gumbel_kernel_wide_top_k_row_matches_plain(dev):
    """With top-k, a row whose slices no cluster's shared memory holds
    (16 x 51,200 + 64 columns) runs the select over its slices in device
    memory: ties at the kth value on both sides of every slice edge, a
    NaN row and a row of -inf, against the plain version; without top-k
    the same row streams."""
    v = 16 * sampling.GUMBEL_SMEM_BYTES // 4 + 64
    cluster = sampling.gumbel_plan(2, v, sm_count(dev), 50)
    assert not sampling.gumbel_staged(v, cluster, 50)
    gen = torch.Generator(device=dev).manual_seed(5)
    lg = torch.randn((4, v), generator=gen, device=dev) * 3
    g = torch.randn(lg.shape, generator=gen, device=dev)
    kth = torch.topk(lg[:2], 50, dim=-1).values[:, -1:]
    cols = torch.tensor(_slice_edges(v, cluster), device=dev)
    lg[:2, cols] = kth.expand(-1, len(cols))
    lg[2, [v // 2, v - 1]] = float("nan")
    lg[3] = -float("inf")
    for top_k in (50, 1, 0):
        before = sampling.gumbel_sample.launches
        got = sampling.gumbel_sample(lg, g, temperature=1.0, top_k=top_k)
        assert sampling.gumbel_sample.launches == before + 1
        assert torch.equal(got, sampling.gumbel_sample_plain(
            lg, g, temperature=1.0, top_k=top_k)), top_k
        assert got.tolist()[2:] == [v // 2, 0]


def test_prng_bits_on_card_equal_cpu(dev):
    keys = prng.sample_keys(11, torch.arange(6), torch.arange(6) * 1000)
    bits = prng.random_bits(keys, 4099)
    torch.testing.assert_close(prng.random_bits(keys.to(dev), 4099).cpu(),
                               bits, atol=0, rtol=0)


def _update_close(w, w2, m, m2):
    """Kernel against plain: bit for bit in practice; bf16 within one
    ulp, f32 within 1e-6 relative (the file's stated tolerance)."""
    for got, want in ((w, w2), (m, m2)):
        if got.dtype == torch.bfloat16:
            ulp = want.float().abs() * 2.0 ** -7
            assert torch.all((got.float() - want.float()).abs() <= ulp)
        else:
            torch.testing.assert_close(got, want, atol=0, rtol=1e-6)


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
    trust = (torch.linalg.vector_norm(w.float()).reshape(1) * 1e-3
             if mode == "lars" else None)
    kw = dict(lr=torch.tensor(0.05, device=dev), trust=trust, momentum=0.9,
              weight_decay=1e-4, nesterov=mode == "nesterov")
    w2, m2 = w.clone(), m.clone()
    before = fused_update.fused_sgd_update.launches
    fused_update.fused_sgd_update([w], [m], [g], **kw)
    assert fused_update.fused_sgd_update.launches == before + 1
    fused_update.fused_sgd_update_plain([w2], [m2], [g], **kw)
    _update_close(w, w2, m, m2)


def _ragged(dev, extra=0):
    """Leaves of 1, 7, 8, 9, 63, 64, 2047, 2048 and 2.36 M elements twice:
    f32 w, m, g, and bf16 w with f32 m and bf16 g, interleaved; then
    ``extra`` small f32 leaves (sizes 1-300)."""
    sizes = [1, 7, 8, 9, 63, 64, 2047, 2048, 3 * 3 * 512 * 512]
    gen = torch.Generator(device=dev).manual_seed(11)
    ws, ms, gs = [], [], []
    for n in sizes:
        for wdt, gdt in ((torch.float32, torch.float32),
                         (torch.bfloat16, torch.bfloat16)):
            ws.append(torch.randn((n,), generator=gen, device=dev).to(wdt))
            ms.append(torch.randn((n,), generator=gen, device=dev))
            gs.append(torch.randn((n,), generator=gen, device=dev).to(gdt))
    for i in range(extra):
        n = 1 + (37 * i) % 300
        ws.append(torch.randn((n,), generator=gen, device=dev))
        ms.append(torch.randn((n,), generator=gen, device=dev))
        gs.append(torch.randn((n,), generator=gen, device=dev))
    return ws, ms, gs


def _keys(ws, ms, gs):
    return [(w.dtype, m.dtype, g.dtype) for w, m, g in zip(ws, ms, gs)]


@pytest.mark.parametrize("extra", [0, fused_update.TABLE_LEAVES])
@pytest.mark.parametrize("mode", ["sgd", "nesterov", "lars"])
def test_fused_update_ragged_set_matches_plain(dev, extra, mode):
    """One call over the ragged set (two dtype groups; with ``extra`` the
    f32 group outgrows one table and takes a second launch): every leaf
    equals the plain version, the launches follow ``launches_per_call``,
    and LARS's trust is within LARS_TRUST_RTOL of the plain one."""
    ws, ms, gs = _ragged(dev, extra)
    keys = _keys(ws, ms, gs)
    trust = None
    before = fused_update.fused_sgd_update.launches
    if mode == "lars":
        trust = fused_update.lars_trust(ws, gs, eta=1e-3, eps=1e-9,
                                        weight_decay=1e-4)
        want = fused_update.lars_trust_plain(ws, gs, eta=1e-3, eps=1e-9,
                                             weight_decay=1e-4)
        torch.testing.assert_close(trust, want, atol=0,
                                   rtol=fused_update.LARS_TRUST_RTOL)
    kw = dict(lr=0.05, trust=trust, momentum=0.9, weight_decay=1e-4,
              nesterov=mode == "nesterov")
    w2, m2 = [w.clone() for w in ws], [m.clone() for m in ms]
    fused_update.fused_sgd_update(ws, ms, gs, **kw)
    assert fused_update.fused_sgd_update.launches - before == \
        fused_update.launches_per_call(keys, lars=mode == "lars")
    assert fused_update.launches_per_call(keys) == (3 if extra else 2)
    fused_update.fused_sgd_update_plain(w2, m2, gs, **kw)
    for a, b, c, d in zip(ws, w2, ms, m2):
        _update_close(a, b, c, d)


def test_lars_trust_repeats_bit_for_bit(dev):
    ws, _, gs = _ragged(dev)
    kw = dict(eta=1e-3, eps=1e-9, weight_decay=1e-4)
    a = fused_update.lars_trust(ws, gs, **kw)
    b = fused_update.lars_trust(ws, gs, **kw)
    assert torch.equal(a, b)
    zero = [torch.zeros(64, device=dev), torch.ones(64, device=dev)]
    t = fused_update.lars_trust(zero, [torch.ones(64, device=dev),
                                       torch.zeros(64, device=dev)], **kw)
    assert t.tolist() == [1.0, 1.0]


def test_fused_update_rejects_misaligned(dev):
    ws, ms, gs = _ragged(dev)
    ws[3] = torch.zeros(ws[3].numel() + 1, device=dev,
                        dtype=ws[3].dtype)[1:]
    with pytest.raises(ValueError, match="aligned"):
        fused_update.fused_sgd_update(ws, ms, gs, lr=0.1, momentum=0.9,
                                      weight_decay=0.0)


@pytest.mark.parametrize("shape", [(3, 3, 64, 64), (64,)])
@pytest.mark.parametrize("mode", ["sgd", "nesterov", "lars"])
def test_fused_update_kernel_on_resnet_leaves(dev, shape, mode):
    """ResNet-50's leaves as the trainer holds them: an HWIO conv weight
    whose gradient comes from ``value_and_grad`` through the convolution
    (which sees the weight as OIHW), and a 64-float batch-norm scale."""
    from repro_torch.core.autodiff import value_and_grad
    from repro_torch.models import resnet
    gen = torch.Generator(device=dev).manual_seed(len(shape))
    w = torch.randn(shape, generator=gen, device=dev)
    m = torch.randn(shape, generator=gen, device=dev)
    if len(shape) == 4:
        x = torch.randn((2, 64, 9, 9), generator=gen, device=dev)
        _, _, g = value_and_grad(
            lambda p, b: (resnet.conv(p["w"], b, 2).square().mean(), {}),
            {"w": w}, x)
        g = g["w"]
        assert g.stride() == w.stride()
    else:
        g = torch.randn(shape, generator=gen, device=dev)
    trust = (torch.linalg.vector_norm(w).reshape(1) * 1e-3
             if mode == "lars" else None)
    kw = dict(lr=torch.tensor(0.05, device=dev), trust=trust, momentum=0.9,
              weight_decay=1e-4, nesterov=mode == "nesterov")
    w2, m2 = w.clone(), m.clone()
    before = fused_update.fused_sgd_update.launches
    fused_update.fused_sgd_update([w], [m], [g], **kw)
    assert fused_update.fused_sgd_update.launches == before + 1
    fused_update.fused_sgd_update_plain([w2], [m2], [g], **kw)
    torch.testing.assert_close(w, w2, atol=0, rtol=1e-6)
    torch.testing.assert_close(m, m2, atol=0, rtol=1e-6)


def test_fused_update_refuses_a_non_contiguous_gradient(dev):
    """The gradient of a permuted view, as autograd returns it, is not
    the kernel's input: the wrapper raises (``value_and_grad`` puts it
    back in the parameter's layout first)."""
    w = torch.zeros((3, 3, 8, 16), device=dev)
    g = torch.zeros((16, 8, 3, 3), device=dev).permute(2, 3, 1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_update.fused_sgd_update([w], [torch.zeros_like(w)], [g],
                                      lr=0.1, momentum=0.9, weight_decay=0.0)


def test_reduced_resnet_on_card_matches_cpu(dev):
    """The reduced ResNet's loss and gradients through cuDNN (channels-last
    input, the asymmetric "SAME" pads at 32 x 32) against the same
    model on the CPU, float32 with TF32 off: within 1e-4 + 1e-4
    relative (two f32 convolution orders)."""
    from repro_torch.configs import get_config
    from repro_torch.core.autodiff import value_and_grad
    from repro_torch.models import resnet
    from repro_torch.tree import leaves, tree_map
    cfg, stages = get_config("resnet50"), (1, 1, 1, 1)
    gen = torch.Generator().manual_seed(0)
    params = resnet.init_params(cfg, gen, "cpu", stages, (8, 16, 32, 64), 10)
    batch = {"images": torch.randn((4, 32, 32, 3), generator=gen),
             "labels": torch.randint(0, 10, (4,), generator=gen)}
    loss_fn = lambda p, b: resnet.loss(p, b, cfg, stages)
    want_l, _, want_g = value_and_grad(loss_fn, params, batch)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        got_l, _, got_g = value_and_grad(
            loss_fn, tree_map(lambda t: t.to(dev), params),
            {k: v.to(dev) for k, v in batch.items()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    torch.testing.assert_close(got_l.cpu(), want_l, atol=1e-4, rtol=1e-4)
    for a, b in zip(leaves(got_g), leaves(want_g)):
        assert a.is_contiguous()
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["sgd", "lars"])
def test_apply_update_on_card_launches_the_kernel(dev, kind):
    """The optimizer has one route for sgd and lars: on CUDA tensors the
    whole tree goes through the kernel in one call (1 launch for sgd, 3
    for lars), never the plain version."""
    from repro_torch.optim import sgd
    cfg = sgd.OptimConfig(kind=kind)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"a": torch.randn((64, 40), generator=gen, device=dev),
              "b": torch.randn((37,), generator=gen, device=dev)}
    grads = {k: torch.randn(v.shape, generator=gen, device=dev)
             for k, v in params.items()}
    state = sgd.init_state(params, cfg)
    want_p = [v.clone() for v in params.values()]
    want_m = [v.clone() for v in state["m"].values()]
    gs = list(grads.values())
    trust = None
    if kind == "lars":     # the kernel's trust, held to the plain one
        lars = dict(eta=cfg.lars_eta, eps=cfg.lars_eps,
                    weight_decay=cfg.weight_decay)
        trust = fused_update.lars_trust(want_p, gs, **lars)
        torch.testing.assert_close(
            trust, fused_update.lars_trust_plain(want_p, gs, **lars),
            atol=0, rtol=fused_update.LARS_TRUST_RTOL)
    before = fused_update.fused_sgd_update.launches
    sgd.apply_update(params, state, grads, 0.05, cfg)
    assert fused_update.fused_sgd_update.launches == before + (
        3 if kind == "lars" else 1)
    fused_update.fused_sgd_update_plain(
        want_p, want_m, gs, lr=0.05, trust=trust, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay)
    for got, want in zip(params.values(), want_p):
        torch.testing.assert_close(got, want, atol=0, rtol=1e-6)
    for got, want in zip(state["m"].values(), want_m):
        torch.testing.assert_close(got, want, atol=0, rtol=1e-6)


# ---------------------------------------------------------------------------
# kernels 10-11: slot gather / scatter
# ---------------------------------------------------------------------------

SLOT = [
    # S, feature shape, dtype
    (11, (3, 2304), torch.bfloat16),        # mamba2-370m conv window rows
    (11, (32, 64, 128), torch.bfloat16),    # mamba2-370m SSD state rows
    (11, (1001,), torch.bfloat16),          # odd row length: 2-byte units
    (5, (7,), torch.float32),               # odd: 4-byte units
    (12, (3, 5), torch.float32),
]
ROWS = [1, 2, 3, 4, 8, 10]                  # up to the engine's 10 rows


def _slot_case(dev, s, feat, dt, b, layers, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = (layers, s) if layers else (s,)
    pool = torch.randn(lead + feat, generator=gen, device=dev).to(dt)
    rng = np.random.default_rng(seed)
    # distinct live slots; past S - 1 rows the rest share trash slot 0,
    # the only slot two rows may share
    distinct = b < s
    slots = np.zeros(b, np.int64)
    live = min(b, s - 1)
    slots[:live] = rng.permutation(np.arange(1, s))[:live]
    slots = torch.tensor(rng.permutation(slots), dtype=torch.int32,
                         device=dev)
    vlead = (layers, b) if layers else (b,)
    values = torch.randn(vlead + feat, generator=gen, device=dev).to(dt)
    return pool, slots, values, distinct


@pytest.mark.parametrize("case", SLOT)
@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("layers", [0, 3])
def test_slot_gather_kernel_bit_exact(dev, case, b, layers):
    s, feat, dt = case
    pool, slots, _, _ = _slot_case(dev, s, feat, dt, b, layers, s * b)
    fresh = torch.tensor(np.arange(b) % 3 == 1, device=dev)
    stacked = bool(layers)
    masks = [None] + [fresh.to(t) for t in (torch.bool, torch.uint8,
                                            torch.int32)]
    before = slot_state.slot_gather.launches
    for fr in masks:
        got = slot_state.slot_gather(pool, slots, fr, stacked=stacked)
        want = slot_state.slot_gather_plain(pool, slots, fr,
                                            stacked=stacked)
        assert got.dtype == pool.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert slot_state.slot_gather.launches == before + len(masks)


def _row_for_plan(per, b, layers, sms, esize):
    """Elements of a row (a power of two) that ``gather_plan`` runs at
    ``per`` units a thread for ``b`` rows in ``layers`` layers."""
    for log2 in range(6, 21):
        units = 1 << log2
        if slot_state.gather_plan(units, b, layers, sms) == per:
            return units * 16 // esize
    raise AssertionError(f"no row length reaches {per} units a thread")


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per", slot_state.GATHER_PER_THREAD)
def test_slot_gather_every_plan_bit_exact(dev, dt, per):
    """Every units-a-thread count the plan picks, at one layer and three,
    covers each row exactly (a row of the length that makes the plan
    pick it, plus a ragged tail of 8-byte units)."""
    esize = torch.empty((), dtype=dt).element_size()
    for layers in (0, 3):
        f = _row_for_plan(per, 3, max(layers, 1), sm_count(dev), esize)
        for feat in ((f,), (f + 8 // esize,)):
            pool, slots, _, _ = _slot_case(dev, 7, feat, dt, 3, layers, per)
            fresh = torch.tensor([False, True, False], device=dev)
            got = slot_state.slot_gather(pool, slots, fresh,
                                         stacked=bool(layers))
            want = slot_state.slot_gather_plain(pool, slots, fresh,
                                                stacked=bool(layers))
            assert torch.equal(got, want)


def test_slot_gather_bool_mask_is_one_kernel(dev):
    """With a bool mask, as the models pass ``pos == 0``, one gather is
    one kernel on the card: no cast of the mask first.  The profiler may
    drop a short kernel's record, so a profile that saw nothing is
    repeated; whatever it saw must be the one gather."""
    pool, slots, _, _ = _slot_case(dev, 11, (3, 2304), torch.bfloat16, 2,
                                   0, 5)
    fresh = torch.tensor([True, False], device=dev)
    slot_state.slot_gather(pool, slots, fresh)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            slot_state.slot_gather(pool, slots, fresh)
            torch.cuda.synchronize()
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "slot_gather_kernel" in kernels[0][0], kernels


@pytest.mark.parametrize("case", SLOT)
@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("layers", [0, 3])
def test_slot_scatter_kernel_bit_exact(dev, case, b, layers):
    """Rows with valid_len 0 write trash slot 0, routed by the kernel from
    valid_len in each dtype it reads (int32, int64), or routed by the
    caller with no valid_len: every other slot is exact against the plain
    version; slot 0 too when the destinations are distinct."""
    s, feat, dt = case
    pool, slots, values, distinct = _slot_case(dev, s, feat, dt, b, layers,
                                               s + b)
    stacked = bool(layers)
    stale = torch.tensor(np.arange(b) % 4 == 2, device=dev)
    routed = torch.where(stale, torch.zeros_like(slots), slots)
    vl = torch.where(stale, 0, 1 + torch.arange(b, device=dev) % 3)
    calls = [(slots, None)] + ([(routed, None)] + [
        (slots, vl.to(t)) for t in (torch.int32, torch.int64)]
        if b > 2 else [])
    before = slot_state.slot_scatter.launches
    for dst, valid in calls:
        got, want = pool.clone(), pool.clone()
        slot_state.slot_scatter(got, dst, values, valid_len=valid,
                                stacked=stacked)
        slot_state.slot_scatter_plain(want, dst, values, valid_len=valid,
                                      stacked=stacked)
        body = (slice(None), slice(1, None)) if stacked else (
            slice(1, None),)
        assert torch.equal(got[body], want[body])
        if distinct and dst is slots and valid is None:
            assert torch.equal(got, want)
        if valid is not None:          # the same as routing first
            ref = pool.clone()
            slot_state.slot_scatter(ref, routed, values, stacked=stacked)
            assert torch.equal(got[body], ref[body])
    assert slot_state.slot_scatter.launches == before + len(calls) + sum(
        v is not None for _, v in calls)


def test_slot_state_scatter_route_on_card(dev):
    """The route through ``layers.slot_state_scatter`` on the card is one
    kernel a call (valid_len read by the scatter: no compare, zeros or
    select first) and leaves a live slot alone for a stale row."""
    from repro_torch.models.layers import slot_state_scatter
    pool = torch.zeros((4, 6), device=dev)
    slots = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    vl = torch.tensor([3, 0], dtype=torch.int32, device=dev)
    value = torch.ones((2, 6), device=dev)
    before = slot_state.slot_scatter.launches
    slot_state_scatter(pool, slots, vl, value)
    assert slot_state.slot_scatter.launches == before + 1
    assert torch.equal(pool[1], torch.ones(6, device=dev))
    assert torch.equal(pool[2], torch.zeros(6, device=dev))
    assert torch.equal(pool[0], torch.ones(6, device=dev))
    for valid in (vl, vl.long(), None):
        kernels, nodes = _graph_kernels(
            lambda: slot_state_scatter(pool, slots, valid, value))
        assert (kernels, nodes) == (4, 4), valid


# ---------------------------------------------------------------------------
# kernel 12: the SSD intra-chunk block
# ---------------------------------------------------------------------------

SSD_SHAPES = [
    # bc, h, p, n
    (2, 4, 64, 128),        # mamba2-370m's head dim and state
    (1, 3, 24, 20),         # neither a power of two
    (1, 2, 128, 256),       # the kernel's largest p and n
]


def _close_scaled(got, want, a, r):
    got, want = got.float(), want.float()
    lim = a * want.abs().max() + r * want.abs()
    return bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("l", [16, 48, 64, 128, 256])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_matches_plain(dev, shape, l, dt):
    torch.backends.cuda.matmul.allow_tf32 = False
    bc, h, p, n = shape
    gen = torch.Generator(device=dev).manual_seed(l * p + n)
    x = (torch.randn((bc, l, h, p), generator=gen, device=dev) * 0.5).to(dt)
    dtv = torch.nn.functional.softplus(
        torch.randn((bc, l, h), generator=gen, device=dev) - 3.0)
    da = -torch.cumsum(torch.nn.functional.softplus(
        torch.randn((bc, l, h), generator=gen, device=dev)) * 0.1, dim=1)
    B = (torch.randn((bc, l, h, n), generator=gen, device=dev) * 0.5).to(dt)
    C = (torch.randn((bc, l, h, n), generator=gen, device=dev) * 0.5).to(dt)
    before = ssd_chunk.ssd_chunk_bchp.launches
    y, st = ssd_chunk.ssd_chunk_bchp(x, dtv, da, B, C)
    assert ssd_chunk.ssd_chunk_bchp.launches == before + 1
    y0, st0 = ssd_chunk.ssd_chunk_bchp_plain(x, dtv, da, B, C)
    assert y.dtype == dt and st.dtype == torch.float32
    ya, yr = (1e-4, 1e-4) if dt == torch.float32 else (1e-3, 1e-2)
    assert _close_scaled(y, y0, ya, yr)
    assert _close_scaled(st, st0, 1e-4, 1e-4)


def test_ssd_chunked_pallas_on_card_matches_plain_route(dev):
    """The whole SSD through kernel 12 against the plain chunked SSD, in
    float32 (TF32 off), with a ragged tail and an initial state."""
    from repro_torch.models import ssm
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, p, g, n, chunk = 2, 300, 4, 64, 1, 128, 256
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((b, s, h, p), generator=gen, device=dev) * 0.5
    dtv = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev) - 3.0)
    A = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.3)
    B = torch.randn((b, s, g, n), generator=gen, device=dev) * 0.5
    C = torch.randn((b, s, g, n), generator=gen, device=dev) * 0.5
    s0 = torch.randn((b, h, p, n), generator=gen, device=dev) * 0.5
    y1, f1 = ssm.ssd_chunked(x, dtv, A, B, C, chunk=chunk, init_state=s0)
    y2, f2 = ssm.ssd_chunked_pallas(x, dtv, A, B, C, chunk=chunk,
                                    init_state=s0)
    assert _close_scaled(y2, y1, 1e-4, 1e-4)
    assert _close_scaled(f2, f1, 1e-4, 1e-4)


# the MLA attends at deepseek-v3's widths (r 512, rd 64): decode rows
# with their keys split over CTAs, query chunks whose tiles (64 rows in
# bf16, 16 in f32) span several positions (H = 12, 16, 40) or one
# (H = 128), a ragged last tile (3 x 40 rows), a full-width prefill
# chunk, views of an odd length; every first row at position 0 (one
# visible key)
MLA = [
    # b, c, h, s1 (view slots), bs, nb_seq
    (8, 1, 128, 641, 16, 40),
    (2, 1, 128, 97, 16, 6),
    (3, 5, 12, 33, 8, 4),
    (2, 64, 16, 129, 16, 8),
    (1, 3, 128, 17, 4, 4),
    (2, 3, 40, 97, 16, 7),
    (2, 128, 128, 641, 16, 40),
]


def _mla_inputs(dev, case, dt):
    b, c, h, s1, bs, nb_seq = case
    gen = torch.Generator(device=dev).manual_seed(sum(case))
    q_lat = torch.randn((b, c, h, 512), generator=gen, device=dev).to(dt)
    q_rope = torch.randn((b, c, h, 64), generator=gen, device=dev).to(dt)
    rng = np.random.default_rng(sum(case))
    pos = rng.integers(0, min(s1, nb_seq * bs) - c, (b,))
    pos[0] = 0
    return gen, rng, q_lat, q_rope, torch.tensor(pos, dtype=torch.int32,
                                                 device=dev)


@pytest.mark.parametrize("case", MLA)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_mla_decode_views_kernel_matches_plain(dev, case, dt):
    b, c, h, s1, _, _ = case
    gen, _, q_lat, q_rope, pos = _mla_inputs(dev, case, dt)
    ckv = torch.randn((b, s1, 512), generator=gen, device=dev).to(dt)
    kr = torch.randn((b, s1, 64), generator=gen, device=dev).to(dt)
    ckv[:, -1], kr[:, -1] = 1e3, -1e3                # trash slot garbage
    scale = 192 ** -0.5
    got = mla_decode.mla_decode_views(q_lat, q_rope, ckv, kr, pos,
                                      scale=scale)
    want = mla_decode.mla_decode_views_plain(q_lat, q_rope, ckv, kr, pos,
                                             scale=scale)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


@pytest.mark.parametrize("case", MLA)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_mla_decode_paged_kernel_matches_plain(dev, case, dt):
    b, c, h, _, bs, nb_seq = case
    gen, rng, q_lat, q_rope, pos = _mla_inputs(dev, case, dt)
    nb = b * nb_seq + 1
    ckv = torch.randn((nb, bs, 512), generator=gen, device=dev).to(dt)
    kr = torch.randn((nb, bs, 64), generator=gen, device=dev).to(dt)
    ckv[0], kr[0] = 1e3, -1e3                        # trash garbage
    bt = torch.tensor(rng.permutation(np.arange(1, nb)).reshape(b, nb_seq),
                      dtype=torch.int32, device=dev)
    for row in range(b):                             # trash past the frontier
        bt[row, (int(pos[row]) + c - 1) // bs + 1:] = 0
    scale = 192 ** -0.5
    before = mla_decode.mla_decode_paged.launches
    got = mla_decode.mla_decode_paged(q_lat, q_rope, ckv, kr, bt, pos,
                                      scale=scale)
    want = mla_decode.mla_decode_paged_plain(q_lat, q_rope, ckv, kr, bt,
                                             pos, scale=scale)
    assert mla_decode.mla_decode_paged.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


def test_mla_kernels_reject_unbuilt_widths(dev):
    q = torch.zeros((1, 1, 4, 32), device=dev)
    qr = torch.zeros((1, 1, 4, 16), device=dev)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="not built"):
        mla_decode.mla_decode_views(q, qr, torch.zeros((1, 9, 32), device=dev),
                                    torch.zeros((1, 9, 16), device=dev), pos,
                                    scale=0.1)


# kernel 6 at the CPU tests' shapes (head dims the kernel is built for)
# and qwen2-1.5b's static prefill shapes
FLASH = [
    # b, sq, sk, h, kv, hd, causal, window
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 128, 8, 8, 128, True, 0),
    (2, 200, 200, 2, 1, 64, False, 0),
    (1, 384, 384, 4, 2, 64, True, 128),
    (1, 64, 320, 2, 2, 64, False, 0),
    (2, 100, 130, 12, 2, 128, True, 0),
    (8, 448, 448, 12, 2, 128, True, 0),
    (2, 512, 512, 12, 2, 128, True, 128),
    (1, 77, 77, 6, 1, 128, True, 33),
    # the bf16 tensor-core path's edges: rows without a key (positions
    # >= Sk + window - 1) mixed with rows that see keys, and whole tiles
    # of them; Sq and Sk not multiples of the 64-row tile or the 64-key
    # chunk; G = 1 and G = 6; hd 64
    (2, 150, 100, 6, 1, 128, True, 20),
    (1, 90, 70, 2, 2, 64, False, 16),
    (3, 131, 131, 6, 1, 64, True, 0),
    (2, 65, 193, 4, 4, 128, False, 0),
    (2, 193, 193, 1, 1, 128, True, 70),
    # hd 256 (32-key chunks in bf16, 32-row tiles in f32): recurrentgemma's
    # static prefill at S = 2304 past its 2048 window, G = 10 causal, rows
    # without a key, non-causal Sq != Sk
    (1, 2304, 2304, 10, 1, 256, True, 2048),
    (2, 300, 300, 10, 1, 256, True, 0),
    (2, 150, 100, 10, 1, 256, True, 20),
    (1, 65, 193, 4, 2, 256, False, 0),
    # hd 120 (h2o: 32 heads over 8, window 4096 at its static prefill;
    # rows without a key; non-causal Sq != Sk) and G = 7 (llava: 56 heads
    # over 8 at hd 128, one row of the static prefill over the image
    # prefix, and a ragged one)
    (8, 512, 512, 32, 8, 120, True, 4096),
    (2, 150, 100, 4, 2, 120, True, 20),
    (1, 65, 193, 4, 4, 120, False, 0),
    (1, 3392, 3392, 56, 8, 128, True, 0),
    (2, 300, 300, 7, 1, 128, True, 0),
]


@pytest.mark.parametrize("case", FLASH)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, case, dt):
    b, sq, sk, h, kv, hd, causal, window = case
    gen = torch.Generator(device=dev).manual_seed(sum(case))
    q = torch.randn((b, sq, h, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, sk, kv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, sk, kv, hd), generator=gen, device=dev).to(dt)
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    want = flash_attention.flash_attention_bhsd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window).transpose(1, 2)
    assert flash_attention.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


def test_flash_attention_rejects_what_it_was_not_built_for(dev):
    q = torch.zeros((1, 8, 2, 96), device=dev)
    kv = torch.zeros((1, 8, 1, 96), device=dev)
    with pytest.raises(ValueError, match="not built"):
        flash_attention.flash_attention(q, kv, kv)
    # Sq 40 >= Sk 8 + window 16: rows 23-39 see no key and get the plain
    # version's value, the mean of v over all 8 keys
    gen = torch.Generator(device=dev).manual_seed(40)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((1, 40, 2, 64), generator=gen, device=dev).to(dt)
        k = torch.randn((1, 8, 1, 64), generator=gen, device=dev).to(dt)
        v = torch.randn((1, 8, 1, 64), generator=gen, device=dev).to(dt)
        got = flash_attention.flash_attention(q, k, v, window=16)
        want = flash_attention.flash_attention_bhsd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            window=16).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


# kernel 7 at the CPU tests' shapes and qwen2's static decode; the last
# two run unsplit (a short cache, many rows), the others split their keys
DECODE = [
    # b, s, h, kv, hd, length
    (2, 512, 8, 2, 64, 300),
    (1, 1024, 4, 4, 128, 1024),
    (3, 700, 2, 1, 64, 13),
    (8, 570, 12, 2, 128, 1),
    (8, 570, 12, 2, 128, 570),
    (8, 627, 12, 2, 128, 700),          # a full ring: every slot valid
    (8, 128, 12, 2, 128, 100),
    (160, 256, 12, 2, 128, 200),
    # hd 256, G = 10: a 2048-slot ring at length 1, full and wrapped
    # (every slot valid), and many rows over a short cache (unsplit)
    (8, 2048, 10, 1, 256, 1),
    (8, 2048, 10, 1, 256, 2048),
    (8, 2048, 10, 1, 256, 3000),
    (160, 256, 10, 1, 256, 200),
    # hd 120 (h2o's static decode over 627 slots, and unsplit) and G = 7
    # (llava's over 3,520 slots)
    (8, 627, 32, 8, 120, 1),
    (8, 627, 32, 8, 120, 627),
    (160, 256, 32, 8, 120, 200),
    (8, 3520, 56, 8, 128, 1),
    (8, 3520, 56, 8, 128, 3500),
]


@pytest.mark.parametrize("case", DECODE)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(dev, case, dt):
    b, s, h, kv, hd, length = case
    gen = torch.Generator(device=dev).manual_seed(sum(case))
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
    k[:, length:], v[:, length:] = 1e3, -1e3       # past the valid slots
    ln = torch.tensor(length, dtype=torch.int32, device=dev)
    got = flash_decode.flash_decode(q, k, v, ln)
    want = flash_decode.flash_decode_bhd_plain(q, k, v, ln)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_decode_cases_reach_both_epilogues(dev, dt):
    def split(*args, hd):
        return flash_decode.launch_splits(*args, dtype=dt, sms=sm_count(dev),
                                          hd=hd)[1] > 1
    for dims in ((64, 128), (120,), (256,)):
        assert {split(b, 1, h, kv, s, hd=hd)
                for b, s, h, kv, hd, _ in DECODE if hd in dims} == {
            False, True}
        assert {split(b, c, kv * g, kv, nb_seq * bs, window, hd=hd)
                for _, bs, kv, g, hd, b, c, nb_seq, window in PAGED
                if hd in dims} == {False, True}
