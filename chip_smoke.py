#!/usr/bin/env python3
"""Chip check of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py               # needs one CUDA card

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a).
2. One phase per kernel at the shapes the serving phase's engine gives
   it (every decode bucket, prefill and mixed row layout, at the
   engine's table and view lengths) plus a 2048-key extra: the kernel
   against its plain PyTorch version on the same card inputs, each timed
   with CUDA events (L2 flushed before every launch), beside its bound
   and a one-call PyTorch yardstick (``library_ms``, never used by the
   port).
3. Serves full-width qwen2-1.5b (bf16, random weights from a seed)
   through the port's ``Engine`` at steps_per_dispatch 1 and 8, three
   runs each, with every kernel's launch count reset just before each
   run and read just after, and checks every emitted token against a
   teacher-forced f32 forward of the plain model over the emitted
   stream.
4. Prints the ``kernels`` JSON line, the card's name and power limit, and
   as its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero without the last
line.  Without a CUDA device, or without the repository's ``src`` beside
it, it fails before it measures anything.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores

# bf16 attention: |kernel - plain| <= ATTN_ATOL + ATTN_RTOL * |plain| per
# element.  Both round an f32 result to bf16, so they may differ by one
# bf16 ulp, at most 2^-7 = 0.0078 of the value; ATTN_ATOL covers outputs
# near zero, where the f32 sums differ in order only.
ATTN_ATOL = 1e-3
ATTN_RTOL = 1e-2
# teacher-forced check of the served tokens (see _teacher_forced_check)
TF_LOGIT_TOL = 0.15      # emitted token's f32 logit vs the row max
TF_ARGMAX_FLOOR = 0.93   # share of emitted tokens equal to the f32 argmax
SERVE_REPEATS = 3        # engine runs per depth, for the spread of tok/s

SEED = 0


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of one call, in ms, over ``iters`` launches,
    each after a 128 MiB write that evicts the 50 MB L2 (a serving step
    meets its inputs cold: 3 GB of weights stream between two uses) and
    a spin of about a millisecond on the card, so that the host has
    queued the whole call before its start event is reached and the
    time between the events holds no wait for the host."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, torch, iters=30):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        starts = [torch.cuda.Event(enable_timing=True)
                  for _ in range(self.iters)]
        ends = [torch.cuda.Event(enable_timing=True)
                for _ in range(self.iters)]
        for s, e in zip(starts, ends):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
        return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(torch, q, k, v, mask):
    """One scaled_dot_product_attention call, GQA by enable_gqa where
    this PyTorch has it (the yardstick only)."""
    F = torch.nn.functional
    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)
    except TypeError:       # a PyTorch without enable_gqa
        g = q.shape[1] // k.shape[1]
        k2, v2 = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        return lambda: F.scaled_dot_product_attention(q, k2, v2,
                                                      attn_mask=mask)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def engine_config():
    """The serving phase's EngineConfig (depth aside): its row layouts
    are the shapes the kernels get on the main path."""
    from repro_torch.serve import EngineConfig
    from repro_torch.serve.profile_engine import ENGINE_CONFIG
    return EngineConfig(**ENGINE_CONFIG)


def step_shapes(ec):
    """(rows, width) of every fused step the engine dispatches: decode
    buckets, chunk-wide prefill rows, width-1 mixed rows (as its warmup)."""
    return ([(b, 1) for b in ec.decode_buckets]
            + [(ec.prefill_rows, ec.prefill_chunk)]
            + [(b, 1) for b in ec.mixed_buckets])


def compare_bf16(got, want):
    """max |got - want| and the worst ratio of |got - want| to
    ATTN_ATOL + ATTN_RTOL * |want| (at most 1 passes)."""
    d = (got.float() - want.float()).abs()
    lim = ATTN_ATOL + ATTN_RTOL * want.float().abs()
    return d.max().item(), (d / lim).max().item()


def first_positions(rng, b, span):
    """b first-query positions in [0, span), both ends included."""
    ctx = rng.integers(0, span, b)
    ctx[0] = 0
    if b > 1:
        ctx[-1] = span - 1
    return ctx


def paged_case(torch, g, rng, ctx, c, nb_seq, H, KV, HD, BS):
    """Rows whose first query sits at ctx[b]: each row's real blocks
    (distinct, shuffled) up to its last query, the trash block 0 after;
    the trash block and every slot past a row's frontier hold large
    NaN-free garbage, so a key read past the mask shows."""
    b = len(ctx)
    need = (ctx + c - 1) // BS + 1
    nb = int(need.sum()) + 1
    kp = torch.randn((nb, BS, KV, HD), generator=g, device="cuda").to(
        torch.bfloat16)
    vp = torch.randn((nb, BS, KV, HD), generator=g, device="cuda").to(
        torch.bfloat16)
    perm = rng.permutation(nb - 1) + 1
    bt = np.zeros((b, nb_seq), np.int32)
    poison = np.zeros((nb, BS), bool)
    poison[0] = True
    used = 0
    for r, n in enumerate(need):
        bt[r, :n] = perm[used:used + n]
        used += n
        last = ctx[r] + c - 1
        poison[bt[r, last // BS], last % BS + 1:] = True
    mask = torch.from_numpy(poison).cuda()[:, :, None, None]
    kp.masked_fill_(mask, 60.0)
    vp.masked_fill_(mask, -60.0)
    q = torch.randn((b, c, H, HD), generator=g, device="cuda").to(
        torch.bfloat16)
    return (q, kp, vp, torch.from_numpy(bt).cuda(),
            torch.from_numpy(ctx.astype(np.int32)).cuda())


def phase_flash_decode(torch, timer, cfg, ec):
    """Kernel 1 at every (rows, width) the engine dispatches, tables of
    blocks_per_seq blocks, plus two 2048-key extras.  The engine's
    decode rows split their keys over CTAs; its prefill and mixed steps
    have enough CTAs to run unsplit, the kernel's direct epilogue: the
    phase fails unless both are compared."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels._common import launch_splits
    H, KV, HD, BS = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        ec.block_size
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    cases = [(f"B={b} C={c}", b, c, ec.blocks_per_seq)
             for b, c in step_shapes(ec)]
    cases += [("extra B=8 C=1", 8, 1, 2048 // BS),
              ("extra B=1 C=128", 1, 128, 2048 // BS)]
    results = []
    for label, b, c, nb_seq in cases:
        ctx = first_positions(rng, b, nb_seq * BS - c + 1)
        q, kp, vp, bt, pos = paged_case(torch, g, rng, ctx, c, nb_seq, H,
                                        KV, HD, BS)
        nsplit = launch_splits(b, c, H, KV, nb_seq * BS)
        got = fd.flash_decode_paged(q, kp, vp, bt, pos)
        want = fd.flash_decode_paged_plain(q, kp, vp, bt, pos)
        err, ratio = compare_bf16(got, want)
        if not (math.isfinite(err) and ratio <= 1.0):
            fail(f"flash_decode_paged {label} keys {nb_seq * BS}: max "
                 f"|kernel - plain| = {err}, {ratio:.3g}x the bound "
                 f"{ATTN_ATOL} + {ATTN_RTOL}|plain|")
        keys_read = int((ctx + c).sum())                 # per kv head
        vis = int(sum(p + i + 1 for p in ctx for i in range(c)))
        nbytes = (2 * keys_read * KV * HD * 2 + 2 * q.numel() * 2
                  + bt.numel() * 4 + pos.numel() * 4)
        bnd, by = bound_ms(nbytes, 4 * vis * H * HD, BF16_OPS_PER_S)
        ms = timer(lambda: fd.flash_decode_paged(q, kp, vp, bt, pos))
        plain_ms = timer(lambda: fd.flash_decode_paged_plain(q, kp, vp, bt,
                                                             pos))
        s = nb_seq * BS
        kg = kp[bt.long()].reshape(b, s, KV, HD).transpose(1, 2).contiguous()
        vg = vp[bt.long()].reshape(b, s, KV, HD).transpose(1, 2).contiguous()
        qpos = pos[:, None].long() + torch.arange(c, device="cuda")[None]
        mask = (torch.arange(s, device="cuda")[None, None]
                <= qpos[..., None])[:, None]                   # (B,1,C,S)
        lib_ms = timer(sdpa(torch, q.transpose(1, 2).contiguous(), kg, vg,
                            mask))
        results.append(dict(label=label, b=b, c=c, keys=s, nsplit=nsplit,
                            engine=not label.startswith("extra"),
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd, bound_by=by, library_ms=lib_ms))
        print(f"[flash_decode_paged] {label} keys={s} nsplit={nsplit} "
              f"H={H} KV={KV} hd={HD} bs={BS} err={err:.3g} "
              f"(x{ratio:.3f} of bound) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} ({by}) "
              f"library_ms(sdpa)={lib_ms:.4f}", flush=True)
        del q, kp, vp, kg, vg
    splits = {r["nsplit"] > 1 for r in results if r["engine"]}
    if splits != {False, True}:
        fail("flash_decode_paged: the engine's shapes did not reach both "
             "the split and the unsplit epilogue")
    return results


def phase_decode_view(torch, timer, cfg, ec):
    """Kernel 2 at the N-step loop's shapes: every decode bucket over
    views of blocks_per_seq * block_size + 1 slots, plus a 2049-slot
    extra."""
    from repro_torch.kernels import decode_view as dv
    from repro_torch.kernels._common import launch_splits
    H, KV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    s_eng = ec.blocks_per_seq * ec.block_size + 1
    cases = [(f"B={b}", b, s_eng) for b in ec.decode_buckets]
    cases.append(("extra B=8", 8, 2049))
    results = []
    for label, b, s1 in cases:
        dt = torch.bfloat16
        q = torch.randn((b, H, HD), generator=g, device="cuda").to(dt)
        k = torch.randn((b, s1, KV, HD), generator=g, device="cuda").to(dt)
        v = torch.randn((b, s1, KV, HD), generator=g, device="cuda").to(dt)
        ctx = first_positions(rng, b, s1 - 1)     # slot s1-1 is the trash
        pos = torch.from_numpy(ctx.astype(np.int32)).cuda()
        past = (torch.arange(s1, device="cuda")[None]
                > pos[:, None])[:, :, None, None]   # frontier + trash slot
        k.masked_fill_(past, 60.0)
        v.masked_fill_(past, -60.0)
        nsplit = launch_splits(b, 1, H, KV, s1)
        got = dv.decode_view_attend(q, k, v, pos)
        want = dv.decode_view_attend_plain(q, k, v, pos)
        err, ratio = compare_bf16(got, want)
        if not (math.isfinite(err) and ratio <= 1.0):
            fail(f"decode_view_attend {label} S+1={s1}: max |kernel - plain|"
                 f" = {err}, {ratio:.3g}x the bound {ATTN_ATOL} + "
                 f"{ATTN_RTOL}|plain|")
        keys = int((ctx + 1).sum())
        nbytes = 2 * keys * KV * HD * 2 + 2 * q.numel() * 2 + b * 4
        bnd, by = bound_ms(nbytes, 4 * keys * H * HD, BF16_OPS_PER_S)
        ms = timer(lambda: dv.decode_view_attend(q, k, v, pos))
        plain_ms = timer(lambda: dv.decode_view_attend_plain(q, k, v, pos))
        mask = (torch.arange(s1, device="cuda")[None]
                <= pos[:, None].long())[:, None, None]          # (B,1,1,S)
        lib_ms = timer(sdpa(torch, q[:, :, None],
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), mask))
        results.append(dict(label=label, b=b, s1=s1, nsplit=nsplit,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd, bound_by=by, library_ms=lib_ms))
        print(f"[decode_view_attend] {label} S+1={s1} nsplit={nsplit} H={H} "
              f"KV={KV} hd={HD} err={err:.3g} (x{ratio:.3f} of bound) "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd:.4f} ({by}) library_ms(sdpa)={lib_ms:.4f}",
              flush=True)
    return results


def phase_greedy(torch, timer, cfg, ec):
    """Kernel 3 at every row count the engine samples (its step shapes)
    and at 1 and 64 rows, with exact ties planted across the threads'
    stride, at the edges of the column chunks the rows are cut into and
    at the ragged vocab edge: the lowest column must win."""
    from repro_torch.kernels import sampling as sp
    V = cfg.vocab_size
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    out = {}
    for b in sorted({1, 64} | {rows for rows, _ in step_shapes(ec)}):
        lg = torch.randn((b, V), generator=g, device="cuda") * 3
        top = lg.max().item() + 1.0
        nchunk = sp.greedy_chunks(b, V)
        chunk = -(-V // nchunk)
        rows, cols = [], []
        for r in range(b):
            edge = chunk * (r % nchunk + 1)
            for col in ((7 + 256 * r) % V, V - 1, (5000 + 33 * r) % V,
                        min(edge, V - 1), min(edge - 1, V - 1)):
                rows.append(r)
                cols.append(col)
        lg[torch.tensor(rows, device="cuda"),
           torch.tensor(cols, device="cuda")] = top
        got = sp.greedy_sample(lg)
        want = sp.greedy_sample_plain(lg)
        ref = lg.cpu().numpy().argmax(-1)
        if not (torch.equal(got, want) and (got.cpu().numpy() == ref).all()):
            fail(f"greedy_sample B={b}: kernel != argmax")
        ms = timer(lambda: sp.greedy_sample(lg))
        plain_ms = timer(lambda: sp.greedy_sample_plain(lg))
        lib_ms = timer(lambda: torch.argmax(lg, dim=-1))
        bnd, by = bound_ms(b * V * 4 + b * 4, b * V, F32_OPS_PER_S)
        out[b] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=bnd, bound_by=by, library_ms=lib_ms)
        print(f"[greedy_sample] B={b} V={V} chunks={nchunk} exact=yes "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd:.4f} ({by}) library_ms(argmax)={lib_ms:.4f}",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------


def phase_serve(torch, cfg):
    """The main path: SERVE_REPEATS runs per depth, each through a fresh
    Engine, with every launch count set to 0 just before the run and
    read just after.  Returns the launches of each depth's first run,
    summed over the depths."""
    from repro_torch import kernels
    from repro_torch.models.model import build_model
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.serve.profile_engine import ENGINE_CONFIG, workload

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(params))
    print(f"[serve] qwen2-1.5b full width: {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {nparams / 1e9:.3f}B params "
          f"{cfg.param_dtype}, "
          f"init {time.perf_counter() - t0:.1f}s", flush=True)
    work = workload(cfg.vocab_size, SEED)
    launches = {fn.__name__: 0 for fn in kernels.KERNELS}
    streams = []
    for depth in (1, 8):
        rates = []
        for rep in range(SERVE_REPEATS):
            eng = Engine(model, params,
                         EngineConfig(steps_per_dispatch=depth,
                                      **ENGINE_CONFIG), device="cuda")
            eng.warmup()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = eng.run([Request(prompt=p.copy(), max_new_tokens=n, rid=i)
                           for i, (p, n) in enumerate(work)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            snap = eng.metrics_snapshot()
            if len(res) != len(work):
                fail(f"depth {depth}: {len(res)} of {len(work)} requests "
                     "done")
            for i, (p, n) in enumerate(work):
                if len(res[i].tokens) != n:
                    fail(f"depth {depth}: request {i} gave "
                         f"{len(res[i].tokens)} tokens, wanted {n}")
            need = ["flash_decode_paged", "greedy_sample"]
            if depth > 1:
                need.append("decode_view_attend")
            for name in need:
                if counts[name] <= 0:
                    fail(f"depth {depth}: {name} never launched")
            if snap["counters"]["jit_compiles"] != 0:
                fail("jit_compiles != 0")
            if rep == 0:
                for k, v in counts.items():
                    launches[k] += v
            ntok = sum(len(r.tokens) for r in res.values())
            rates.append(ntok / wall)
            decode_rates = [(len(r.tokens) - 1) / (r.finish_time
                                                   - r.first_token_time)
                            for r in res.values()
                            if r.finish_time > r.first_token_time]
            ttft = sorted(r.first_token_time - t0 for r in res.values())
            print(f"[serve] depth={depth} run={rep} requests={len(res)} "
                  f"tokens={ntok} wall_s={wall:.3f} tok_s={ntok / wall:.1f} "
                  f"ttft_p50_s={ttft[len(ttft) // 2]:.4f} "
                  f"decode_tok_s_per_request_mean="
                  f"{sum(decode_rates) / len(decode_rates):.1f} "
                  f"steps={snap['counters']['steps']} "
                  f"model_calls={snap['counters']['model_calls']} "
                  f"launches={json.dumps(counts)}", flush=True)
            stream = {i: res[i].tokens for i in range(len(work))}
            if stream not in streams:
                streams.append(stream)
            del eng
        rates.sort()
        print(f"[serve] depth={depth} tok_s over {SERVE_REPEATS} runs: "
              f"median {rates[len(rates) // 2]:.1f} min {rates[0]:.1f} "
              f"max {rates[-1]:.1f}", flush=True)
    print(f"[serve] distinct token streams over the {2 * SERVE_REPEATS} "
          f"runs: {len(streams)}", flush=True)
    _teacher_forced_check(torch, model, params, work, streams)
    return launches


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _teacher_forced_check(torch, model, params, work, streams):
    """Every emitted token against a plain f32 forward over the emitted
    stream: its logit must be within TF_LOGIT_TOL of the row's max, and
    at least TF_ARGMAX_FLOOR of them must be the row's argmax.  (bf16
    kernels need not pick the same token as f32 where random weights
    leave near-ties, so exact identity is not required.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p32 = _cast(params, torch.float32)
    cfg32 = model.cfg.replace(param_dtype="float32", compute_dtype="float32")
    from repro_torch.models import transformer
    worst, agree, total = 0.0, 0, 0
    with torch.no_grad():
        for out in streams:
            for i, (prompt, _) in enumerate(work):
                seq = list(prompt) + out[i]
                toks = torch.tensor([seq[:-1]], device="cuda")
                logits, _, _ = transformer.forward(p32, toks, cfg32)
                rows = logits[0, len(prompt) - 1:].float()
                emitted = torch.tensor(out[i], device="cuda")
                chosen = rows.gather(1, emitted[:, None])[:, 0]
                deficit = (rows.max(-1).values - chosen).max().item()
                worst = max(worst, deficit)
                agree += int((rows.argmax(-1) == emitted).sum().item())
                total += len(out[i])
    print(f"[serve] teacher-forced f32 check: {total} tokens, "
          f"{agree / total:.4f} equal to the f32 argmax (floor "
          f"{TF_ARGMAX_FLOOR}), worst logit deficit {worst:.4f} "
          f"(tolerance {TF_LOGIT_TOL})", flush=True)
    if not (worst <= TF_LOGIT_TOL):
        fail(f"emitted token logit deficit {worst} > {TF_LOGIT_TOL}")
    if not (agree / total >= TF_ARGMAX_FLOOR):
        fail(f"emitted tokens equal to the f32 argmax: {agree / total} < "
             f"{TF_ARGMAX_FLOOR}")


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    so = _build.build(verbose=True)
    print(f"[build] {so.name} in {time.perf_counter() - t0:.1f}s "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    card = nvidia_smi()
    print(f"[card] {card}", flush=True)

    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b")
    ec = engine_config()
    timer = Timer(torch)
    fd = phase_flash_decode(torch, timer, cfg, ec)
    dv = phase_decode_view(torch, timer, cfg, ec)
    gs = phase_greedy(torch, timer, cfg, ec)
    launches = phase_serve(torch, cfg)

    def row(results, label):
        """The kernel's JSON numbers: times of the engine's full decode
        bucket, error the worst over every case of the phase."""
        pick = next(r for r in results if r["label"] == label)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return dict(max_abs_err=max(r["max_abs_err"] for r in results),
                    **{k: pick[k] for k in keys})

    src = "src/repro_torch/csrc"
    top = ec.decode_buckets[0]
    rows = [
        dict(name="flash_decode_paged", route="cuda",
             source=f"{src}/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode.py:130",
             launches=launches["flash_decode_paged"],
             **row(fd, f"B={top} C=1")),
        dict(name="decode_view_attend", route="cuda",
             source=f"{src}/decode_view.cu",
             replaces="src/repro/kernels/decode_view.py:84",
             launches=launches["decode_view_attend"],
             **row(dv, f"B={top}")),
        dict(name="greedy_sample", route="cuda", source=f"{src}/sampling.cu",
             replaces="src/repro/kernels/sampling.py:165",
             launches=launches["greedy_sample"], **gs[top]),
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
