#!/usr/bin/env python3
"""Chip check of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py               # needs one CUDA card

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a),
   printing ``ptxas -v``, and counts the flash-attention, MLA-attend,
   flash-decode and SSD-block templates' tensor-core instructions in the
   library's SASS (``cuobjdump``).
2. One phase per kernel at the shapes its main path gives it: the
   attention and sampling kernels at every row layout the serving
   engine dispatches (plus a 2048-key extra; the greedy and gumbel
   samplers, one cluster launch a call at their plans' cluster sizes,
   their ties planted on both sides of every slice edge of that size;
   the gumbel sampler also at a top-k row no cluster's shared memory
   holds), the fused
   update at every leaf shape of full-width qwen2-1.5b, ResNet-50
   (161 f32 leaves, 106 of them batch-norm vectors), recurrentgemma-2b,
   whisper-tiny and mamba2-370m.  Each kernel is
   held against its plain PyTorch version on the same card inputs
   (kernels 1, 2 and 7 in both templates, bf16 and f32; kernel 2 in
   bf16 also bit for bit against kernel 1 on the same keys) and timed
   with CUDA events (L2 flushed and the card spun before every launch),
   beside its bound and a one-call PyTorch yardstick (``library_ms``,
   never used by the port) where one exists.
3. Serves full-width qwen2-1.5b (bf16, random weights from a seed)
   through the port's ``Engine`` at steps_per_dispatch 1 and 8: greedy
   twice per depth, then twice at temperature 0.8 with top-k 50, which
   must repeat its streams.  Every emitted token is checked against a
   teacher-forced f32 forward of the plain model over the emitted
   stream.  Then the same model cut to F32_GATE_LAYERS in float32
   (weights and compute, TF32 off) serves the requests at depths 1 and
   8, greedy and sampled, and
   depth 1 must equal depth 8 token for token (in bf16 the depths part,
   printed and not gated: their kernels sum in other orders).  Then the
   cluster layer: two qwen2-1.5b replicas (CLUSTER_LAYERS layers) share
   the card through
   ``ServeCluster.for_replicas`` at depth 8, fault-free, with replica 0
   killed mid-generation (greedy and sampled) and with replica 1 hung
   past a 3 s hard heartbeat deadline; every request must end exactly
   once with no fault result, every bf16 stream passes the
   teacher-forced check, and in float32 the kill and hang runs must
   equal the fault-free cluster and one engine token for token (the
   cluster's tok/s beside one engine's, and the bf16 streams that part
   from the fault-free run's, printed).
4. Trains full-width qwen2-1.5b for 8 LSGD steps with the fused SGD
   update through ``repro_torch.launch.train``, then runs the virtual
   CSGD and LSGD (4 workers, groups of 2) from one set of weights and
   checks that they agree after ``finalize`` (the paper's claim).  Then
   the paper's own model: ResNet-50 at full width, 224 x 224, batch 64,
   f32, 8 LSGD steps through the same launcher (finite losses, exactly
   161 x 8 fused-update launches), and the ResNet half of the port's
   Fig. 7 (``launch.fig7_equivalence``: CSGD and LSGD curves and
   parameters within 1e-3).  A phase that turns TF32 off restores the
   flags when it ends, so each phase runs under PyTorch's defaults
   unless it sets its own.
5. The static-batch path (the non-paged ``prefill`` / ``decode_step``,
   as benchmarks/serve_bench.py's ``run_static``): the flash-attention
   kernel at the static prefill's shapes (B=8, qwen2's heads, Sq = Sk =
   each batch's padded prompt, bf16 on tensor cores and f32) and at a
   window, a window with rows that see no key, a non-causal Sq != Sk
   and an hd-64 case; the contiguous-cache decode
   kernel at the static decode's shape with length 1, S/2 and S, split
   and unsplit; then full-width qwen2-1.5b under attn_impl="pallas"
   serves the same 16 requests as two static batches of 8, twice (the
   streams must repeat), with exact launch counts of both kernels and
   of greedy_sample, each token checked against a teacher-forced f32
   forward of the plain model over the padded prompt.
6. The mamba path: the slot-state gather and scatter at every row count
   the engine gives them, for one layer (the fused step) and for all 48
   layers at once (the decode loop's entry and exit), for both state
   leaves, bit for bit against their plain versions, the scatter also
   with stale rows routed by valid_len inside the kernel and through
   ``layers.slot_state_scatter`` (timed whole); the SSD intra-chunk
   block at the prefill rows x one 256-token chunk and at 4 x 512
   tokens, and ``ssm.ssd_chunked_pallas`` (its own path) against the
   plain chunked SSD; then mamba2-370m at every width, cut to
   MAMBA_SERVE_LAYERS of its 48 layers (bf16, random weights from a
   seed), serves the same 16 requests at steps_per_dispatch 1 and 8,
   greedy twice and sampled once per depth, each token checked against a
   teacher-forced f32 forward, every state slot free at the end; then
   its float32 depth-1 == depth-8 check, as qwen2's, at
   F32_GATE_LAYERS layers.
7. The MLA + MoE path: the absorbed MLA attends over latent views and
   latent block pools at every row layout the engine dispatches, at
   deepseek-v3's widths (128 heads, latent rank 512, rope 64, 640 keys),
   held to their plain versions within one bf16 ulp, each printing its
   share of the bf16 MMA rate and of its bound; then full-width
   deepseek-v3 cut to 4 layers (3 dense, the first MoE layer with its
   256 experts; bf16, random weights from a seed) serves the same 16
   requests, depth 1 greedy twice (the streams must repeat), depth 8
   greedy and sampled once each, each token checked against a
   teacher-forced f32 forward of the plain model in its dropless form,
   routed as the served run routed (the router's top-8 choice is
   discontinuous; the count of bf16-vs-f32 routing flips is printed);
   then its float32 depth-1 == depth-8 check at the same 4-layer cut
   (63.2 GB of f32 weights: 5 layers would need 109 GB).
8. The RG-LRU hybrid: the phases of kernels 1, 2, 6 and 7 again at
   recurrentgemma-2b's config (10 query heads over one kv head, hd 256,
   window 2048), both dtypes, at the shapes its main path gives them:
   its engine's layouts (chunk-wide mixed rows) over 40-block tables and
   its two static batches; plus its long request's 160-block tables and
   2,561-slot views, a 2,304-token prefill and a full 2,048-slot ring,
   where the window masks keys; kernel 3 at its 256,000-token
   vocabulary (kernel 4's is in its own phase) and kernels 10-11 at its
   RG-LRU state leaves; then recurrentgemma-2b at every width, cut to
   LM_SERVE_LAYERS (12 of its 26 layers; bf16, random weights from a
   seed), serves the 16 requests at depths 1 and 8, greedy twice (the streams
   must repeat) and sampled once, each run with exactly the launches
   its counters call for, and one 2,400-token request that passes the
   window and must reclaim blocks, every token held to the
   teacher-forced f32 check; its float32 depth-1 == depth-8 check at
   F32_GATE_LAYERS layers (two of its patterns); and
   its static path under "pallas" at the same cut (two batches of 8,
   kernels 6, 7 and 3 at hd 256), whose float32 tokens must equal the
   plain attention's.
   Then it trains full-width recurrentgemma-2b (2.383B params, bf16,
   remat, "blocked" attention, autograd through the RG-LRU scan) for 8
   LSGD steps of 4 x 512 tokens through the launcher: finite losses,
   exactly its kernel-5 launches.
9. whisper-tiny, the encoder-decoder: kernel 6 at its encoder's shape
   (B = 8, 1,500 frames, not causal, one query head per kv head at hd
   64) and its decoder prefills, kernel 7 over its 448-slot self cache
   and kernel 3 at its 51,865-token vocabulary (a row no 16-byte copy
   tiles), each against its plain version in both dtypes; then full
   width under "pallas" serves 16 requests (decoder prompts of 4-64
   tokens, 32-128 new, each over 1,500 stub frames) as two static
   batches of 8, twice, with exact launch counts, every bf16 token held
   to a teacher-forced f32 forward and the float32 tokens equal to the
   plain attention's; then 8 LSGD steps of 8 x 448 tokens through the
   launcher, gated as the other trainers.
10. The last four LM configs: kernels 1, 2, 6 and 7 at h2o-danube-3-4b's
   head dim 120 (32 heads over 8, window 4096: its engine's layouts, its
   long request's tables and views, a prefill past the window, a full
   ring, its static path) and 6 and 7 at llava-next-34b's G = 7 over its
   2,880-token image prefix (static prefills of up to 3,392 positions, a
   3,520-slot cache), both dtypes, against their plain versions; kernel
   3 at the four vocabularies (kernel 4's in its own phase); kernels 1
   and 2 at the engine's layouts of minicpm-2b (G = 1 over 36 kv heads,
   hd 64), dbrx-132b (G = 6 over 8) and llava-next-34b (G = 7 over 8),
   both dtypes, against their plain versions; then
   at LM_SERVE_LAYERS depths, minicpm-2b (20 of 40 layers, G = 1, tied
   embeddings), dbrx-132b (GQA + MoE, 2 of 40 layers), h2o-danube-3-4b
   (12 of 24) and llava-next-34b (8 of 60 layers, text-only through the
   engine) each serve the 16 requests at depths 1
   and 8, greedy and sampled, with exact launches and the teacher-forced
   f32 check (dbrx's routed as served, h2o's 4,400-token request past its
   window); h2o and llava also through the static path (two batches of
   8, llava's behind N(0, 1) stub image prefixes, as the reference's data
   pipeline draws them), h2o's float32 kernels equal to its plain
   attention, llava's bf16 tokens beside those of the same batches
   served through the plain attention (``_image_witness``).
11. Tensor-parallel replicas (``tp_devices``: cuda:0 and cuda:1 where
   the machine has two cards, else cuda:0 twice): kernels 1 and 2 at
   one shard's layouts of qwen2-1.5b (6 heads over 1) and
   recurrentgemma-2b (5 over 1 at hd 256), 10-11 and 12 at mamba's 16
   heads, 8 and 9 at deepseek-v3's 64 MLA heads (``shard_layout``), each
   against its plain version; then qwen2-1.5b at full width, TP_LAYERS
   deep, served by one Engine over the two shards (depth 1 greedy,
   depth 8 greedy and sampled, exact launches for the slice, every
   token held to the teacher-forced f32 check), and in float32 each
   stream must equal one engine's; then mamba2-370m, deepseek-v3 and
   recurrentgemma-2b at TP_LAYERS over the slice, depth 1 greedy and
   depth 8 sampled, teacher-forced.
12. Trains the last three LM configs through the launcher as qwen2-1.5b
   is trained (8 LSGD steps of 4 rows): minicpm-2b under its WSD
   schedule and h2o-danube-3-4b over 512 tokens a row, and
   llava-next-34b at LLAVA_TRAIN_LAYERS over the 2,880-token image
   prefix and LLAVA_TEXT text tokens a row; finite losses, exactly their kernel-5 launches, the step time
   and peak memory printed with the card's name and power limit.
13. Training over a mesh (one rank: data 1 x model 1): dbrx-132b at full
   width cut to DBRX_TRAIN_LAYERS layer through
   ``launch.builders.make_train_step`` (the reference's FSDP / pjit step
   for an MoE config, expert-parallel), 8 LSGD steps of 4 x 512 tokens:
   finite losses, exactly its kernel-5 launches, the step time and peak
   memory; kernel 5 held against its plain version over that training
   state's leaves a piece at a time and timed in place; mamba2-370m
   uncut (48 layers) trained through the launcher as qwen2-1.5b; and
   ``make_pjit_step`` with fsdp equal to the launcher's step within 1e-5
   (qwen2-1.5b, 2 layers, float32, 3 steps + finalize), also over two
   NCCL ranks where the machine has two cards.
14. Training along the model axis (``phase_tp_train``): two ranks at
   model 2, on cuda:0 over gloo (NCCL refuses two ranks on one card) or
   over NCCL on two cards where the machine has them, the transport
   printed.  qwen2-1.5b and mamba2-370m at full width cut to
   TP_PARITY_LAYERS, float32 (TF32 off), 3 LSGD steps of 4 x 256 +
   finalize with sgd and LARS through the launcher's ``--mesh 1,1,2``
   equal the one-rank launcher within 1e-5 (params and losses); then
   qwen2-1.5b uncut in bf16, 8 LSGD steps of 4 x 512 at ``--mesh
   1,1,2``: finite losses, the step time and each rank's peak memory,
   and on each rank exactly kernel 5's ``launches_per_call`` an update;
   then kernel 5 over model rank 0's shard of qwen2-1.5b's leaves
   against its plain version, timed beside its bound and
   ``torch.optim.SGD(fused=True)``.
15. Shows from ``torch.profiler`` that kernel 2's bf16 launch runs kernel
   1's tensor-core template over view keys, that a slot gather with a
   bool mask, a ``slot_state_scatter`` with an int32 valid_len, a
   gumbel sample (with and without top-k) and a greedy sample each run
   their kernel alone,
   and from a captured CUDA graph that each is one launch a call (last:
   the profiler leaves the host slower for the rest of the process).
16. Prints the ``kernels`` JSON line (a row a kernel, then rows of the
   same kernels at the last four configs' shapes, at one shard's
   layouts of a TP slice and (kernel 5) at dbrx's and mamba2-370m's
   training leaves and at a model-2 rank's shard of qwen2-1.5b, each
   naming its ``case`` and counting that config's or slice's
   launches), the card's name and
   power limit, and as its last line ``{"ok": true, "device": {...}}``.

Every launch count is set to 0 just before a main-path run and read just
after it.  Any failed check raises, so the script exits non-zero without
the last line.  Without a CUDA device, or without the repository's
``src`` beside it, it fails before it measures anything.
"""
from __future__ import annotations

import contextlib
import gc
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
# f32 attention: the same with ATTN_F32_ATOL, ATTN_F32_RTOL.  Both sum in
# f32 in other orders (at most 1.3e-6 apart on the H100, PERF.md); an f32
# template that computed in TF32 or bf16 (about 1e-3 apart) fails it.
ATTN_F32_ATOL = 1e-5
ATTN_F32_RTOL = 1e-5
# teacher-forced check of the served tokens (see _teacher_forced_check)
TF_LOGIT_TOL = 0.15      # emitted token's f32 logit vs the row max
TF_ARGMAX_FLOOR = 0.93   # share of emitted tokens equal to the f32 argmax
SERVE_REPEATS = 2        # greedy engine runs per depth, for their spread
# sampled serving: temperature, top-k, and how far a sampled token's f32
# logit may sit below the f32 kth value (bf16 serving logits against an
# f32 teacher-forced forward, the same slack as TF_LOGIT_TOL)
SAMPLE_T = 0.8
SAMPLE_TOP_K = 50
TF_TOPK_MARGIN = 0.15
# the gumbel phase: row counts beyond the engine's (1 and 64) and top-k
GUMBEL_TOP_KS = (0, 1, 50)
# the training phase: full width, batch 4 x 512 tokens, 8 LSGD steps of
# fused SGD (momentum 0.9, weight decay 1e-4); lr 0.01 (0.1, the
# launcher's default, is the paper's ResNet recipe)
TRAIN_ARGV = ["--arch", "qwen2-1.5b", "--steps", "8", "--batch", "4",
              "--seq", "512", "--sync-mode", "lsgd", "--optimizer", "sgd",
              "--base-lr", "0.01", "--schedule", "const", "--log-every", "1",
              "--seed", "0", "--device", "cuda"]
# the same phase for the RG-LRU hybrid (full width, 26 layers: remat,
# "blocked" attention, autograd through the RG-LRU scan) and for
# whisper-tiny (full width: 4 + 4 layers over 1,500 stub frames, batch 8
# x 448 decoder tokens)
RG_TRAIN_ARGV = ["--arch", "recurrentgemma-2b"] + TRAIN_ARGV[2:]
WHISPER_TRAIN_ARGV = ["--arch", "whisper-tiny", "--steps", "8", "--batch",
                      "8", "--seq", "448"] + TRAIN_ARGV[8:]
# the last three LM configs, trained as TRAIN_ARGV (8 steps of 4 rows):
# minicpm-2b under its WSD schedule (2 warmup, 4 stable, 2 decay steps)
# and h2o-danube-3-4b at all their layers over 512 tokens a row;
# llava-next-34b's rows carry the 2,880-token image prefix and
# LLAVA_TEXT text tokens, 3,072 positions, a multiple of the blocked
# attention's blocks (with 512 text tokens, 3,392 positions, its
# training forward falls back to naive attention, as the reference's
# does, whose f32 scores and their gradients over 4 rows x 56 heads need
# about 50 GB: a step ran out of memory at 1 layer).  At 12 bytes a
# parameter (bf16 params and grads, f32 momentum and pending update) a
# layer of 557.8M parameters takes 6.7 GB: 4 layers peaked at 57.25 GB
# and 5 at 63.94 GB, so LLAVA_TRAIN_LAYERS of its 60 layers
LLAVA_TEXT = 192
LLAVA_TRAIN_LAYERS = 5
LM_TRAIN_ARGVS = (
    ["--arch", "minicpm-2b"] + TRAIN_ARGV[2:] + ["--schedule", "wsd",
                                                 "--warmup-steps", "2"],
    ["--arch", "h2o-danube-3-4b"] + TRAIN_ARGV[2:],
    ["--arch", "llava-next-34b"] + TRAIN_ARGV[2:] + [
        "--seq", str(2880 + LLAVA_TEXT), "--layers", str(LLAVA_TRAIN_LAYERS)])
# training over a mesh (one rank here: the mesh is data 1 x model 1):
# dbrx-132b at full width cut to DBRX_TRAIN_LAYERS of its 40 layers,
# bf16, through launch.builders.make_train_step, the reference's choice
# for an MoE config (the FSDP / pjit step with the mesh active, so the
# MoE runs expert-parallel), 8 LSGD steps of 4 x 512 tokens, fused SGD
# at lr 0.01; at 12 bytes a parameter (bf16 params and grads, f32
# momentum and pending update) its 1 layer and embeddings, about 4.5B
# parameters, take about 54 GB before activations
DBRX_TRAIN_LAYERS = 1
PJIT_STEPS, PJIT_BATCH, PJIT_SEQ = 8, 4, 512
# mamba2-370m uncut (48 layers) through the launcher, as qwen2-1.5b
MAMBA_TRAIN_ARGV = ["--arch", "mamba2-370m"] + TRAIN_ARGV[2:]
# the FSDP step against the launcher's step: qwen2-1.5b at full width
# cut to 2 layers, float32 (TF32 off), 3 steps + finalize, the bound of
# tests/test_equivalence.py; on two cards or more also as two NCCL ranks
FSDP_LAYERS = 2
FSDP_STEPS = 3
FSDP_BOUND = 1e-5
# kernel 5's whole-set call over dbrx's training state is held against
# the plain version a piece at a time (the plain version's f32
# temporaries of its 1.06B-element leaf would not fit beside the state):
# pieces of at most this many elements
UPDATE_PIECE = 1 << 28
# virtual CSGD vs LSGD on the card: full width cut to 2 layers, float32
# (TF32 off), 4 workers of 1 x 256 tokens in groups of 2, 3 steps; the
# bound of tests/test_equivalence.py
VIRTUAL_LAYERS = 2
VIRTUAL_BOUND = 1e-5
# ResNet-50, the paper's model and shape: 224 x 224 images, local batch
# 64, f32, 8 LSGD steps of fused SGD at the launcher's (the paper's) lr
# schedule; 161 param leaves, all f32: one kernel-5 launch an update
RESNET_ARGV = ["--arch", "resnet50", "--steps", "8", "--batch", "64",
               "--sync-mode", "lsgd", "--optimizer", "sgd", "--log-every",
               "1", "--seed", "0", "--device", "cuda"]
RESNET_LEAVES = 161
# the fused update against its plain version: w within one bf16 ulp,
# f32 momentum within 1e-6 relative
UPDATE_M_RTOL = 1e-6
# the SSD block against its plain version: |kernel - plain| <= a *
# max|plain| + r * |plain|; f32 outputs (states, and y of the f32 path)
# sum up to 256 keys and 256 state columns in another order; bf16 y
# rounds an f32 result, so kernel and plain may differ by one bf16 ulp
SSD_F32_TOL = (1e-4, 1e-4)
SSD_BF16_TOL = (1e-3, 1e-2)
MAMBA = "mamba2-370m"
# ssd_chunk's shapes: the engine's prefill rows x one 256-token chunk,
# and 4 sequences of 512 tokens (two chunks each)
SSD_CASES = (("prefill rows x 1 chunk", None, 256), ("4 x 512", 4, 512))
# the MLA + MoE path; its depth cut is profile_engine.DEPTH_CUTS's
DEEPSEEK = "deepseek-v3-671b"
# the RG-LRU hybrid
RGEMMA = "recurrentgemma-2b"
# the last four LM configs: dense MHA at hd 64 (G = 1), GQA at hd 120
# under a 4096 window, GQA + MoE and the vlm backbone, each served at
# LM_SERVE_LAYERS
MINICPM = "minicpm-2b"
H2O = "h2o-danube-3-4b"
DBRX = "dbrx-132b"
LLAVA = "llava-next-34b"
# one served request of each windowed config past its window: (prompt,
# new tokens), under an EngineConfig whose max_seq_len (``long_seq``, a
# whole number of prefill chunks) holds it; the attention phases add its
# tables and views as extras for that config, and a prefill of
# ``long_prefill`` tokens past the window
LONG_REQUESTS = {RGEMMA: (2400, 64), H2O: (4400, 64)}
# a vlm's static path: each request's stub image prefix is drawn N(0, 1),
# as the reference's data pipeline draws image_embeds.  The witness
# (_image_witness) serves the same batches in bf16 through the plain
# attention (attn_impl "naive": no kernel 6 or 7), WITNESS_ROWS rows at a
# time (the plain version's f32 scores over 8 x 3,392 positions, with
# their softmax, would not fit beside llava's weights), and holds the
# kernels' share of tokens equal to the f32 argmax to TF_ARGMAX_FLOOR
# where the plain path reaches it, else to no less than WITNESS_SIGMAS
# standard errors of the two shares' difference below the plain path's
WITNESS_ROWS = 4
WITNESS_SIGMAS = 3.0
# layer cuts of earlier paths that keep the script inside its time limit
# on a slow host (one card's host ran the phases before the
# tensor-parallel block at these paths' earlier depths in 1,228 s,
# another in 836 s): every width as published; qwen2-1.5b's main
# serving phase keeps all 28 layers
QWEN2 = "qwen2-1.5b"
MAMBA_SERVE_LAYERS = 12
F32_GATE_LAYERS = {QWEN2: 14, MAMBA: 6, RGEMMA: 6}
CLUSTER_LAYERS = 14
LM_SERVE_LAYERS = {RGEMMA: 12, MINICPM: 20, H2O: 12, DBRX: 2, LLAVA: 8}
# the static-batch path (the non-paged prefill / decode_step, as
# benchmarks/serve_bench.py's run_static): batches of 8 requests, each
# prompt right-padded with token 0 to the batch's longest rounded up to
# STATIC_PAD
STATIC_BATCH = 8
STATIC_PAD = 16

SEED = 0


def long_seq(cfg) -> int:
    """max_seq_len of the EngineConfig that serves ``cfg``'s long request
    (LONG_REQUESTS), a whole number of 128-token prefill chunks."""
    return -(-sum(LONG_REQUESTS[cfg.name]) // 128) * 128


def long_prefill(cfg) -> int:
    """A prefill 256 tokens past ``cfg``'s attention window."""
    return attn_window(cfg) + 256


# whisper-tiny's static path: 16 requests of 4-64 decoder prompt tokens
# and 32-128 new tokens, each over its own 1,500 stub frames, served as
# two static batches of 8 with a 448-slot self cache (Whisper's decoder
# context)
WHISPER = "whisper-tiny"
WHISPER_PROMPT_LENS = (4, 64)
WHISPER_CACHE = 448

# the cluster phase: two replicas share cuda:0 (ServeCluster's
# round-robin single-device slices) at depth 8; a kill or a hang at a
# replica's third dispatch (mid-generation); the hang is declared after
# CLUSTER_HANG_HEALTH's hard deadline, the other runs never reach theirs
CLUSTER_REPLICAS = 2
CLUSTER_DEPTH = 8
CLUSTER_FAULT_AT = 2
CLUSTER_HEALTH = dict(soft_deadline_s=60.0, hard_deadline_s=120.0,
                      interval_s=0.01)
CLUSTER_HANG_HEALTH = dict(soft_deadline_s=1.0, hard_deadline_s=3.0,
                           interval_s=0.02)
CLUSTER_JOIN_S = 120.0
# tensor-parallel training (phase_tp_train): model TP_TRAIN over two
# ranks, float32 parity against the one-rank launcher (full width cut
# to TP_PARITY_LAYERS, 3 steps of 4 x 256 + finalize, the bound of
# tests/test_equivalence.py), then qwen2-1.5b uncut as TRAIN_ARGV
TP_TRAIN = 2
TP_PARITY_LAYERS = 2
TP_BOUND = 1e-5
TP_PARITY_ARGV = ["--steps", "3", "--batch", "4", "--seq", "256",
                  "--layers", str(TP_PARITY_LAYERS), "--sync-mode", "lsgd",
                  "--base-lr", "0.01", "--schedule", "const", "--log-every",
                  "100", "--seed", "0", "--device", "cuda"]
# tensor-parallel serving: slices of TP shards (tp_devices), every
# family cut to TP_LAYERS (deepseek: its 3 dense layers and the first
# MoE layer, profile_engine's cut)
TP = 2
TP_LAYERS = {QWEN2: 14, MAMBA: 6, RGEMMA: 6, DEEPSEEK: 4}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN while a phase runs, the flags as
    they were after it, so that a later phase runs under PyTorch's
    defaults (matmul TF32 off, cuDNN TF32 on) as the port's entry points
    do.  Used as a decorator on each phase that checks float32."""
    import torch
    b = torch.backends
    saved = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


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


# the attention templates sass_counts reads: mangled-name pattern ->
# "family_{tc|f32}<template arguments>"
SASS_TEMPLATES = (
    (r"(flash_attention_\w+?)ILi(\d+)E", "{0}<{1}>"),
    (r"(mla_attend_(?:tc|f32))I\S*?(View|Paged)Latents", "{0}<{1}>"),
    (r"flash_decode_tcILi(\d+)ELb([01])EN2rt\d+(Paged|View)Keys",
     "flash_decode_tc<{0},{1},{2}>"),      # <hd, narrow, keys>
    (r"(flash_decode_paged|flash_decode_bhd|decode_view)_kernelILi(\d+)E",
     "flash_decode_f32<{0},{1}>"),
    (r"(ssd_chunk_tc)ILi(\d+)ELi(\d+)E", "{0}<{1},{2}>"),   # <NP, PP>
    (r"(ssd_chunk_f32)", "{0}<>"),
)
# kernels whose resource usage sass_counts prints (and fails on a spill)
RES_KERNELS = ("gumbel_cluster_kernel", "slot_gather_kernel",
               "slot_scatter_kernel", "ssd_chunk_tc", "ssd_chunk_f32",
               "fused_sgd_kernel", "lars_norms_kernel", "lars_trust_kernel")
# bf16 (tensor-core) and f32 templates each family must have: the
# attention families at head dims 64, 120, 128 and 256
SASS_FAMILIES = {"flash_attention_": (4, 4), "mla_attend_": (2, 2),
                 "flash_decode_": (16, 12), "ssd_chunk_": (6, 1)}
# the attention instances that must not spill: the head-dim-120 ones
NO_SPILL_HD = "120"


def sass_counts(so: Path) -> None:
    """Tensor-core MMA (HMMA), ldmatrix (LDSM) and cp.async (LDGSTS)
    instructions of each flash-attention, MLA-attend, flash-decode and
    SSD-block template in the built library, from ``cuobjdump -sass``; fails
    unless the bf16 templates (``_tc``) issue HMMA and the f32 ones do
    not; then the registers, static shared memory and local memory of
    ``RES_KERNELS`` and of every attention template instance
    (``cuobjdump -res-usage``), failing on a spill in ``RES_KERNELS``
    and in the head-dim-120 instances."""
    import re
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode:
        fail(f"cuobjdump: {out.stderr.strip()}")
    ops = ("HMMA", "LDSM", "LDGSTS")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            cur = None
            for pat, fmt in SASS_TEMPLATES:
                m = re.search(r"Function : \S*" + pat, line)
                if m:
                    cur = fmt.format(*m.groups())
                    counts[cur] = dict.fromkeys(ops, 0)
                    break
        elif cur:
            for op in ops:
                if re.search(rf"\b{op}\b", line):
                    counts[cur][op] += 1
    for name, c in sorted(counts.items()):
        print(f"[sass] {name}: "
              + " ".join(f"{op} {n}" for op, n in c.items()), flush=True)
    for family, (n_tc, n_f32) in SASS_FAMILIES.items():
        tc = [c["HMMA"] for n, c in counts.items()
              if n.startswith(family + "tc<")]
        f32 = [c["HMMA"] for n, c in counts.items()
               if n.startswith(family + "f32<")]
        if len(tc) != n_tc or min(tc) == 0 or len(f32) != n_f32 or max(f32):
            fail(f"{family.rstrip('_')} SASS: HMMA counts {counts}")
    # registers, static shared memory and local memory (spills) of the
    # kernels the slot and sampling phases time, from the resource usage
    res = subprocess.run([str(tool), "-res-usage", str(so)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode:
        fail(f"cuobjdump -res-usage: {res.stderr.strip()}")
    usage, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            cur = next((k for k in RES_KERNELS if k in m.group(1)), None)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)",
                      line)
        if cur and m:
            usage.setdefault(cur, []).append(tuple(map(int, m.groups())))
            cur = None
    # and of every attention template instance (SASS_TEMPLATES' names),
    # printed, gated for hd 120 only: the hd-256 tensor-core instances
    # keep a stack frame of spilled registers
    cur, seen_hd = None, 0
    for line in res.stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            cur = next((fmt.format(*mm.groups()) for pat, fmt in
                        SASS_TEMPLATES[:4]
                        for mm in [re.search(pat, m.group(1))] if mm), None)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)",
                      line)
        if cur and m:
            reg, stack, _, local = map(int, m.groups())
            print(f"[res] {cur}: registers {reg}, stack {stack}, local "
                  f"{local}", flush=True)
            if re.search(rf"<{NO_SPILL_HD}[,>]|,{NO_SPILL_HD}>", cur):
                seen_hd += 1
                if stack or local:
                    fail(f"{cur} spills: stack {stack}, local {local}")
            cur = None
    # hd 120: kernel 6's two templates, kernel 1/2/7's four tensor-core
    # instances (narrow, wide x paged, view) and three f32 kernels
    if seen_hd != 9:
        fail(f"cuobjdump -res-usage: {seen_hd} hd-{NO_SPILL_HD} attention "
             "instances, want 9")
    for name in RES_KERNELS:
        rows = usage.get(name)
        if not rows:
            fail(f"cuobjdump -res-usage: no {name}")
        regs = sorted({r[0] for r in rows})
        print(f"[res] {name} ({len(rows)} instantiations): registers "
              f"{regs[0]}-{regs[-1]}, stack {max(r[1] for r in rows)}, "
              f"static shared {max(r[2] for r in rows)} bytes, local "
              f"{max(r[3] for r in rows)}", flush=True)
        if max(r[3] for r in rows):
            fail(f"{name} spills to local memory: {rows}")


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(torch, q, k, v, mask, is_causal=False):
    """One scaled_dot_product_attention call, GQA by enable_gqa where
    this PyTorch has it (the yardstick only)."""
    F = torch.nn.functional
    kw = dict(attn_mask=mask, is_causal=is_causal)
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    except TypeError:       # a PyTorch without enable_gqa
        g = q.shape[1] // k.shape[1]
        k2, v2 = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        return lambda: F.scaled_dot_product_attention(q, k2, v2, **kw)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def engine_config():
    """The serving phase's EngineConfig (depth aside): its row layouts
    are the shapes the kernels get on the main path."""
    from repro_torch.serve import EngineConfig
    from repro_torch.serve.profile_engine import ENGINE_CONFIG
    return EngineConfig(**ENGINE_CONFIG)


def step_shapes(ec, cfg):
    """(rows, width) of every fused step the engine dispatches for
    ``cfg``, as its warmup: decode buckets, chunk-wide prefill rows, and
    mixed rows, width-1 where no layer keeps recurrent state, else
    chunk-wide (``mixed_chunk_rows``)."""
    from repro_torch.models.model import paged_spec
    mixed = ([(b, 1) for b in ec.mixed_buckets]
             if paged_spec(cfg).width1_mixed
             else [(ec.mixed_chunk_rows, ec.prefill_chunk)])
    return ([(b, 1) for b in ec.decode_buckets]
            + [(ec.prefill_rows, ec.prefill_chunk)] + mixed)


def attn_window(cfg) -> int:
    """The window of ``cfg``'s attention layers (0: none), as the model
    hands it to kernels 1, 2 and 6."""
    from repro_torch.models.transformer import _layer_window
    return max(_layer_window(cfg, kind) for kind, _, _ in _runs(cfg)
               if kind in ("attn", "local_attn"))


def row_keys(ctx, c, window):
    """(keys a row reads, visible (query, key) pairs) summed over rows
    whose first query sits at ctx[b], c queries each, under ``window``
    (0: none): a query at p sees keys (p - window, p]."""
    qpos = ctx[:, None] + np.arange(c)[None]
    first = np.maximum(ctx - window + 1, 0) if window else 0
    vis = np.minimum(qpos + 1, window) if window else qpos + 1
    return int((ctx + c - first).sum()), int(vis.sum())


def compare_attn(got, want):
    """max |got - want|, its worst ratio to atol + rtol * |want| (at most
    1 passes) and that bound as text: ATTN_ATOL, ATTN_RTOL for bf16
    results, ATTN_F32_ATOL, ATTN_F32_RTOL for f32."""
    atol, rtol = ((ATTN_F32_ATOL, ATTN_F32_RTOL) if want.element_size() == 4
                  else (ATTN_ATOL, ATTN_RTOL))
    d = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    return d.max().item(), (d / lim).max().item(), f"{atol} + {rtol}|plain|"


def first_positions(rng, b, span):
    """b first-query positions in [0, span), both ends included."""
    ctx = rng.integers(0, span, b)
    ctx[0] = 0
    if b > 1:
        ctx[-1] = span - 1
    return ctx


def paged_tables(rng, ctx, c, nb_seq, bs):
    """Block tables for rows whose first query sits at ctx[b]: each row's
    real blocks (distinct, shuffled) up to its last query, the trash
    block 0 after.  Returns (tables (B, nb_seq), the pool's block count,
    a (blocks, bs) mask of the trash block and every slot past a row's
    frontier, where the caller plants garbage)."""
    need = (ctx + c - 1) // bs + 1
    nb = int(need.sum()) + 1
    perm = rng.permutation(nb - 1) + 1
    bt = np.zeros((len(ctx), nb_seq), np.int32)
    poison = np.zeros((nb, bs), bool)
    poison[0] = True
    used = 0
    for r, n in enumerate(need):
        bt[r, :n] = perm[used:used + n]
        used += n
        last = ctx[r] + c - 1
        poison[bt[r, last // bs], last % bs + 1:] = True
    return bt, nb, poison


def paged_case(torch, g, rng, ctx, c, nb_seq, H, KV, HD, BS):
    """K/V pools and queries for ``paged_tables``' rows; the trash block
    and every slot past a row's frontier hold large NaN-free garbage, so
    a key read past the mask shows."""
    b = len(ctx)
    bt, nb, poison = paged_tables(rng, ctx, c, nb_seq, BS)
    kp = torch.randn((nb, BS, KV, HD), generator=g, device="cuda").to(
        torch.bfloat16)
    vp = torch.randn((nb, BS, KV, HD), generator=g, device="cuda").to(
        torch.bfloat16)
    mask = torch.from_numpy(poison).cuda()[:, :, None, None]
    kp.masked_fill_(mask, 60.0)
    vp.masked_fill_(mask, -60.0)
    q = torch.randn((b, c, H, HD), generator=g, device="cuda").to(
        torch.bfloat16)
    return (q, kp, vp, torch.from_numpy(bt).cuda(),
            torch.from_numpy(ctx.astype(np.int32)).cuda())


def phase_flash_decode(torch, timer, cfg, ec):
    """Kernel 1 at every (rows, width) the engine dispatches for ``cfg``
    (``step_shapes``), tables of blocks_per_seq blocks, under the
    config's attention window (``attn_window``) and head dim, plus
    extras: without a window two 2048-key cases; with one, the same
    layouts over ``long_seq``-key tables (the long request's, where the
    window masks the oldest keys) and 136 width-1 rows, which take the
    bf16 template's direct epilogue.  bf16 (tensor cores) timed beside
    its bound, plain version and SDPA, with its share of the bf16 MMA
    rate; f32 (CUDA cores) on the same inputs, checked.  The phase fails
    unless each template compares both the split and the unsplit
    epilogue: at the engine's layouts, or with a window at any case."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels._common import sm_count
    H, KV, HD, BS = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        ec.block_size
    W = attn_window(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    cases = [(f"B={b} C={c}", b, c, ec.blocks_per_seq)
             for b, c in step_shapes(ec, cfg)]
    if W:
        n = long_seq(cfg)
        cases += [(f"extra B={b} C={c} keys={n}", b, c, n // BS)
                  for b, c in step_shapes(ec, cfg)]
        cases += [("extra B=136 C=1", 136, 1, ec.blocks_per_seq)]
    else:
        cases += [("extra B=8 C=1", 8, 1, 2048 // BS),
                  ("extra B=1 C=128", 1, 128, 2048 // BS)]
    results = []
    for label, b, c, nb_seq in cases:
        ctx = first_positions(rng, b, nb_seq * BS - c + 1)
        q, kp, vp, bt, pos = paged_case(torch, g, rng, ctx, c, nb_seq, H,
                                        KV, HD, BS)
        s = nb_seq * BS
        checked = {}
        for dt in (torch.bfloat16, torch.float32):
            args = [x.to(dt) for x in (q, kp, vp)] + [bt, pos]
            tiles, nsplit = fd.launch_splits(b, c, H, KV, s, W, dtype=dt,
                                             sms=sm_count(0), hd=HD)
            err, ratio, lim = compare_attn(
                fd.flash_decode_paged(*args, window=W),
                fd.flash_decode_paged_plain(*args, window=W))
            if not (math.isfinite(err) and ratio <= 1.0):
                fail(f"flash_decode_paged {cfg.name} {label} {dt} keys {s}: "
                     f"max |kernel - plain| = {err}, {ratio:.3g}x the bound "
                     f"{lim}")
            checked[dt] = (tiles, nsplit, err, ratio)
        tiles, nsplit, err, ratio = checked[torch.bfloat16]
        f32_tiles, f32_nsplit, f32_err, f32_ratio = checked[torch.float32]
        print(f"[flash_decode_paged] {label} float32 keys={s} "
              f"tiles={f32_tiles} nsplit={f32_nsplit} err={f32_err:.3g} "
              f"(x{f32_ratio:.3f} of bound)", flush=True)
        keys_read, vis = row_keys(ctx, c, W)             # per kv head
        nbytes = (2 * keys_read * KV * HD * 2 + 2 * q.numel() * 2
                  + bt.numel() * 4 + pos.numel() * 4)
        ops = 4 * vis * H * HD
        bnd, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        ms = timer(lambda: fd.flash_decode_paged(q, kp, vp, bt, pos,
                                                 window=W))
        plain_ms = timer(lambda: fd.flash_decode_paged_plain(
            q, kp, vp, bt, pos, window=W))
        kg = kp[bt.long()].reshape(b, s, KV, HD).transpose(1, 2).contiguous()
        vg = vp[bt.long()].reshape(b, s, KV, HD).transpose(1, 2).contiguous()
        qpos = (pos[:, None].long()
                + torch.arange(c, device="cuda")[None])[..., None]
        kpos = torch.arange(s, device="cuda")[None, None]
        mask = kpos <= qpos
        if W:
            mask &= kpos > qpos - W
        mask = mask[:, None]                                   # (B,1,C,S)
        lib_ms = timer(sdpa(torch, q.transpose(1, 2).contiguous(), kg, vg,
                            mask))
        results.append(dict(label=label, b=b, c=c, keys=s, nsplit=nsplit,
                            f32_nsplit=f32_nsplit,
                            max_abs_err=max(err, f32_err), ms=ms,
                            plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                            library_ms=lib_ms))
        print(f"[flash_decode_paged] {label} bfloat16 keys={s} tiles={tiles} "
              f"nsplit={nsplit} H={H} KV={KV} hd={HD} window={W} bs={BS} "
              f"err={err:.3g} (x{ratio:.3f} of bound) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} ({by}) "
              f"library_ms(sdpa)={lib_ms:.4f} sdpa_ratio={ms / lib_ms:.3f} "
              f"bf16_tc_rate_share={ops / (ms * 1e-3) / BF16_OPS_PER_S:.4f} "
              f"bound_share={bnd / ms:.4f}", flush=True)
        del q, kp, vp, kg, vg, mask
    # without a window the engine's own layouts reach both; the hybrid's
    # split every bf16 launch (chunk-wide mixed rows), so its extras count
    gated = [r for r in results if W or not r["label"].startswith("extra")]
    if ({r["nsplit"] > 1 for r in gated} != {False, True}
            or {r["f32_nsplit"] > 1 for r in gated} != {False, True}):
        fail(f"flash_decode_paged {cfg.name}: the cases did not reach both "
             "the split and the unsplit epilogue of each template")
    return results


def device_kernels(torch, fn, calls=10, attempts=3):
    """({kernel name: launches seen}, calls of ``fn`` made in all): the
    kernels that ``calls`` calls of ``fn`` run on the card, from
    ``torch.profiler`` (device activity only), after one call outside
    the profile.  In some runs on the H100 the profiler recorded fewer
    launches of a short kernel than calls (3 to 9 of 10; the cause is not
    known), so it is read for which kernels ran, not how often
    (``graph_kernels`` counts); a profile that saw none is repeated, up
    to ``attempts`` profiles."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ran = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        if ran:
            return ran, 1 + (attempt + 1) * calls
    fail(f"torch.profiler saw no device activity in {attempts} profiles")


def graph_kernels(torch, fn, calls=10):
    """(kernel launches, graph nodes of any kind: memsets, copies) that
    ``calls`` calls of ``fn`` make, counted by the CUDA driver: one call
    runs first outside the capture, then the calls are captured into a CUDA
    graph (never replayed) whose nodes are counted (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``)."""
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
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType failed")
        kernels += kind.value == 0           # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels, n.value


def view_as_pool(torch, k, v, bs):
    """The first S slots of views (B, S+1, KV, hd) as a pool of bs-slot
    blocks (block 0 the trash, holding garbage) and each row's block
    table: the keys kernel 1 reads for kernel 2's."""
    b, s1, kv, hd = k.shape
    nb_seq = (s1 - 1) // bs

    def pool(x, fill):
        blocks = x[:, :nb_seq * bs].reshape(b * nb_seq, bs, kv, hd)
        trash = torch.full((1, bs, kv, hd), fill, dtype=x.dtype,
                           device=x.device)
        return torch.cat([trash, blocks]).contiguous()
    bt = (1 + torch.arange(b * nb_seq, dtype=torch.int32,
                           device=k.device)).reshape(b, nb_seq)
    return pool(k, 60.0), pool(v, -60.0), bt


def phase_decode_view(torch, timer, cfg, ec):
    """Kernel 2 at the N-step loop's shapes for ``cfg`` under its
    attention window and head dim: every decode bucket over views of
    blocks_per_seq * block_size + 1 slots, plus extras: without a window
    a 2049-slot view at B=8; with one, every bucket over ``long_seq`` +
    1 slots (the long request's, where the window masks the oldest
    keys).
    bf16 (kernel 1's tensor-core template over view keys) timed beside
    its bound, plain version and SDPA, with its share of the bf16 MMA
    rate; f32 (CUDA cores) on the same inputs, checked.  At the decode
    buckets (and the windowed extras) the bf16 result must equal kernel
    1's on the same keys laid out as a pool, bit for bit
    (``phase_census`` names the kernel it runs)."""
    from repro_torch.kernels import decode_view as dv
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels._common import sm_count
    H, KV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = attn_window(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    s_eng = ec.blocks_per_seq * ec.block_size + 1
    cases = [(f"B={b}", b, s_eng, True) for b in ec.decode_buckets]
    if W:
        n = long_seq(cfg) + 1
        cases += [(f"extra B={b} S+1={n}", b, n, True)
                  for b in ec.decode_buckets]
    else:
        cases.append(("extra B=8", 8, 2049, False))
    results = []
    for label, b, s1, as_pool in cases:
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
        checked = {}
        for dt in (torch.bfloat16, torch.float32):
            args = [x.to(dt) for x in (q, k, v)] + [pos]
            tiles, nsplit = dv.launch_splits(b, H, KV, s1, W, dtype=dt,
                                             sms=sm_count(0), hd=HD)
            err, ratio, lim = compare_attn(
                dv.decode_view_attend(*args, window=W),
                dv.decode_view_attend_plain(*args, window=W))
            if not (math.isfinite(err) and ratio <= 1.0):
                fail(f"decode_view_attend {cfg.name} {label} {dt} S+1={s1}: "
                     f"max |kernel - plain| = {err}, {ratio:.3g}x the bound "
                     f"{lim}")
            checked[dt] = (tiles, nsplit, err, ratio)
        tiles, nsplit, err, ratio = checked[torch.bfloat16]
        f32_tiles, f32_nsplit, f32_err, f32_ratio = checked[torch.float32]
        print(f"[decode_view_attend] {label} float32 S+1={s1} "
              f"tiles={f32_tiles} nsplit={f32_nsplit} err={f32_err:.3g} "
              f"(x{f32_ratio:.3f} of bound)", flush=True)
        same = "n/a"
        if as_pool:
            kp, vp, bt = view_as_pool(torch, k, v, ec.block_size)
            k1 = fd.flash_decode_paged(q[:, None].contiguous(), kp, vp, bt,
                                       pos, window=W)[:, 0]
            same = torch.equal(dv.decode_view_attend(q, k, v, pos, window=W),
                               k1)
            print(f"[decode_view_attend] {label} bfloat16 == kernel 1 "
                  f"(flash_decode_paged) on the same keys as a pool, bit "
                  f"for bit: {same}", flush=True)
            if not same:
                fail(f"decode_view_attend {cfg.name} {label}: bf16 differs "
                     "from kernel 1 on the same keys")
            del kp, vp, bt, k1
        keys, vis = row_keys(ctx, 1, W)
        nbytes = 2 * keys * KV * HD * 2 + 2 * q.numel() * 2 + b * 4
        ops = 4 * vis * H * HD
        bnd, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        ms = timer(lambda: dv.decode_view_attend(q, k, v, pos, window=W))
        plain_ms = timer(lambda: dv.decode_view_attend_plain(q, k, v, pos,
                                                             window=W))
        kpos = torch.arange(s1, device="cuda")[None]
        p_ = pos[:, None].long()
        mask = kpos <= p_
        if W:
            mask &= kpos > p_ - W
        mask = mask[:, None, None]                              # (B,1,1,S)
        lib_ms = timer(sdpa(torch, q[:, :, None],
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), mask))
        results.append(dict(label=label, b=b, s1=s1, nsplit=nsplit,
                            max_abs_err=max(err, f32_err), ms=ms,
                            plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                            library_ms=lib_ms))
        print(f"[decode_view_attend] {label} bfloat16 S+1={s1} "
              f"tiles={tiles} nsplit={nsplit} H={H} KV={KV} hd={HD} "
              f"window={W} err={err:.3g} (x{ratio:.3f} of bound) "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd:.4f} ({by}) library_ms(sdpa)={lib_ms:.4f} "
              f"sdpa_ratio={ms / lib_ms:.3f} "
              f"bf16_tc_rate_share={ops / (ms * 1e-3) / BF16_OPS_PER_S:.4f} "
              f"bound_share={bnd / ms:.4f} equals_kernel1={same}",
              flush=True)
        del q, k, v, mask
    return results


def phase_greedy(torch, timer, cfg, ec, rows=None):
    """Kernel 3 at every row count the engine samples (its step shapes;
    ``rows`` where no engine serves ``cfg``) and at 1 and 64 rows, with
    exact ties planted across the threads' stride, on both sides of
    every edge between the slices of the plan's cluster size
    (``greedy_plan``) and at the ragged vocab edge: the lowest column
    must win.  Then NaN and all -inf rows.  Each layout is
    one kernel node a call in a captured CUDA graph."""
    from repro_torch.kernels import sampling as sp
    from repro_torch.kernels._common import sm_count
    V = cfg.vocab_size
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    out = {}
    if rows is None:
        rows = [b for b, _ in step_shapes(ec, cfg)]
    for b in sorted({1, 64} | set(rows)):
        lg = torch.randn((b, V), generator=g, device="cuda") * 3
        top = lg.max().item() + 1.0
        plan = sp.greedy_plan(b, V, sm_count(0))
        sl = sp.gumbel_slice(V, plan)
        # the first column of each slice but the first (or the middle)
        starts = [k * sl for k in range(1, plan) if k * sl < V] or [V // 2]
        at, cols = [], []
        for r in range(b):
            e = starts[r % len(starts)]
            planted = ([(7 + 256 * r) % V, V - 1, (5000 + 33 * r) % V],
                       [e - 1, e, V - 1], [e, V - 1])[r % 3]
            at += [r] * len(planted)
            cols += planted
        lg[torch.tensor(at, device="cuda"),
           torch.tensor(cols, device="cuda")] = top
        got = sp.greedy_sample(lg)
        want = sp.greedy_sample_plain(lg)
        ref = lg.cpu().numpy().argmax(-1)
        if not (torch.equal(got, want) and (got.cpu().numpy() == ref).all()):
            fail(f"greedy_sample B={b}: kernel != argmax")
        kernels, nodes = graph_kernels(torch, lambda: sp.greedy_sample(lg),
                                       10)
        if (kernels, nodes) != (10, 10):
            fail(f"greedy_sample B={b}: {kernels} kernels, {nodes} graph "
                 "nodes in 10 calls (want one kernel a call)")
        ms = timer(lambda: sp.greedy_sample(lg))
        plain_ms = timer(lambda: sp.greedy_sample_plain(lg))
        lib_ms = timer(lambda: torch.argmax(lg, dim=-1))
        bnd, by = bound_ms(b * V * 4 + b * 4, b * V, F32_OPS_PER_S)
        out[b] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=bnd, bound_by=by, library_ms=lib_ms)
        print(f"[greedy_sample] B={b} V={V} cluster={plan} (slice "
              f"{sp.gumbel_slice(V, plan)} columns, {plan * b} CTAs) "
              f"exact=yes graph=1 kernel a call kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} ({by}) "
              f"bound_share={bnd / ms:.4f} library_ms(argmax)={lib_ms:.4f}",
              flush=True)
    # NaN (the first wins, also across slices) and -inf rows (column 0;
    # one finite column wins)
    for b in (ec.decode_buckets[0], 264):
        plan = sp.greedy_plan(b, V, sm_count(0))
        sl = sp.gumbel_slice(V, plan)
        lg = torch.randn((b, V), generator=g, device="cuda")
        lg[0] = -math.inf
        lg[1, [min(sl + 3, V - 1), V - 1]] = math.nan
        lg[2, [11, V - 2]] = math.nan
        lg[3] = -math.inf
        lg[3, V - 3] = -1e30
        got = sp.greedy_sample(lg)
        if not (torch.equal(got, sp.greedy_sample_plain(lg)) and
                got.tolist()[:4] == [0, min(sl + 3, V - 1), 11, V - 3]):
            fail(f"greedy_sample B={b}: NaN / -inf rows differ from argmax")
        print(f"[greedy_sample] B={b} V={V} cluster={plan} NaN and -inf "
              "rows exact=yes", flush=True)
    return out


def _slice_edges(sp, v, cluster):
    """Columns on both sides of every edge between kernel 4's cluster
    slices (``gumbel_slice``) at ``cluster`` CTAs a row."""
    sl = sp.gumbel_slice(v, cluster)
    return sorted({c for r in range(1, cluster) if r * sl < v
                   for c in (r * sl - 1, r * sl)})


def phase_gumbel(torch, timer, cfg, others, ec):
    """Kernel 4 at every row count the engine samples and at 1 and 64
    rows, V = qwen2's vocab, T = SAMPLE_T, top_k in GUMBEL_TOP_KS, noise
    from the reference's threefry draw as the engine makes it; then the
    vocabularies of the ``others`` configs that serve sampled (mamba,
    deepseek, recurrentgemma, minicpm, h2o, dbrx, llava) at 8, 64 and
    136 rows.
    Planted: with top-k, logits equal to the row's kth value on both
    sides of every slice edge of the plan's cluster size
    (``gumbel_plan``), at a thread-stride column and at the last column
    (all must stay in the kept set); without, equal winning scores at
    those columns (the lowest must win).  Exact token equality with the
    plain version, the kernel timed, and kernel and graph nodes a call
    from a captured CUDA graph (one kernel, nothing else).  Last, rows of
    equal logits at each cluster size the plan takes for qwen2's vocab
    with top-k (the select's fallback from its candidate list to the
    whole slice), checked only."""
    from repro_torch.kernels import prng
    from repro_torch.kernels import sampling as sp
    from repro_torch.kernels._common import sm_count
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    qwen_rows = sorted({1, 64} | {rows for rows, _ in step_shapes(ec, cfg)})
    cases = [(cfg.vocab_size, b, GUMBEL_TOP_KS, None) for b in qwen_rows]
    for other in others:
        cases += [(other.vocab_size, b, (0, SAMPLE_TOP_K),
                   f"V={other.vocab_size}") for b in (8, 64, 136)]
    out = {}
    for v, b, top_ks, tag in cases:
        base = torch.randn((b, v), generator=g, device="cuda") * 3
        keys = prng.sample_keys(SEED, torch.arange(b, device="cuda"),
                                torch.full((b,), 100, device="cuda"))
        noise0 = prng.gumbel(keys, v)
        rows = torch.arange(b, device="cuda")[:, None]
        stride = ((7 + 256 * torch.arange(b, device="cuda")) % v)[:, None]
        for top_k in top_ks:
            plan = sp.gumbel_plan(b, v, sm_count(0), top_k)
            cols = torch.tensor(_slice_edges(sp, v, plan) + [v - 1],
                                device="cuda")
            cols = torch.cat([cols[None].expand(b, -1), stride], 1)
            lg, noise = base.clone(), noise0.clone()
            if top_k:
                kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
                lg[rows, cols] = kth.expand(-1, cols.shape[1])
            else:
                lg[rows, cols] = lg.max() + 30.0
                noise[rows, cols] = 0.0
            want = sp.gumbel_sample_plain(lg, noise, temperature=SAMPLE_T,
                                          top_k=top_k)
            if not top_k and not torch.equal(want.long(),
                                             cols.min(1).values):
                fail(f"gumbel_sample_plain B={b} V={v}: a tie did not go "
                     "to the lowest column")
            label = f"B={b} V={v} T={SAMPLE_T} top_k={top_k}"

            def call():
                return sp.gumbel_sample(lg, noise, temperature=SAMPLE_T,
                                        top_k=top_k)
            got = call()
            if not torch.equal(got, want):
                fail(f"gumbel_sample {label} cluster={plan}: kernel != "
                     f"plain in {int((got != want).sum())} rows")
            ms = timer(call)

            def plain():
                return sp.gumbel_sample_plain(lg, noise,
                                              temperature=SAMPLE_T,
                                              top_k=top_k)
            plain_ms = timer(plain)
            kernels, nodes = graph_kernels(torch, call, 10)
            if (kernels, nodes) != (10, 10):
                fail(f"gumbel_sample {label}: {kernels} kernels, {nodes} "
                     "graph nodes in 10 calls (want one kernel a call)")
            # each logit read once and the noise of the columns that can
            # win (with top-k the kept ones: lg >= kth, NaN kept), one
            # token written; a compare per column, a division and an add
            # per such column
            kept = b * v
            if top_k:
                kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
                kept = int((~(lg < kth)).sum())
            bnd, by = bound_ms(b * v * 4 + kept * 4 + b * 4,
                               b * v + 2 * kept, F32_OPS_PER_S)
            key = (b, top_k) if tag is None else (tag, b, top_k)
            out[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd, bound_by=by, library_ms=None)
            print(f"[gumbel_sample] {label} kept={kept} cluster={plan} "
                  f"(slice {sp.gumbel_slice(v, plan)} columns, "
                  f"{plan * b} CTAs) exact=yes kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} ({by}) "
                  f"bound_share={bnd / ms:.4f} graph={kernels / 10:g} "
                  f"kernels {nodes / 10:g} nodes a call library_ms=none "
                  "(no single PyTorch call)", flush=True)
    # rows of equal logits: every column is a top-k candidate, so each
    # CTA's candidate list overflows and its select reads the whole slice
    v = cfg.vocab_size
    for b in (ec.decode_buckets[0], 64):
        lg = torch.full((b, v), 1.5, device="cuda")
        noise = torch.randn((b, v), generator=g, device="cuda")
        for top_k in GUMBEL_TOP_KS[1:]:
            got = sp.gumbel_sample(lg, noise, temperature=SAMPLE_T,
                                   top_k=top_k)
            if not torch.equal(got, sp.gumbel_sample_plain(
                    lg, noise, temperature=SAMPLE_T, top_k=top_k)):
                fail(f"gumbel_sample B={b} equal logits top_k={top_k}: "
                     "kernel != plain")
        print(f"[gumbel_sample] B={b} V={v} equal logits (candidate lists "
              f"overflow), top_k {GUMBEL_TOP_KS[1:]}, cluster "
              f"{sp.gumbel_plan(b, v, sm_count(0), GUMBEL_TOP_KS[-1])}: "
              "exact=yes", flush=True)
    # a top-k row whose slices no cluster's shared memory holds: the
    # select reads them from device memory; ties at the kth value on both
    # sides of every slice edge
    b, v = 2, 16 * sp.GUMBEL_SMEM_BYTES // 4 + 64
    plan = sp.gumbel_plan(b, v, sm_count(0), SAMPLE_TOP_K)
    if sp.gumbel_staged(v, plan, SAMPLE_TOP_K):
        fail(f"gumbel_plan: a {v}-column row staged in shared memory")
    lg = torch.randn((b, v), generator=g, device="cuda") * 3
    noise = torch.randn((b, v), generator=g, device="cuda")
    kth = torch.topk(lg, SAMPLE_TOP_K, dim=-1).values[:, -1:]
    cols = torch.tensor(_slice_edges(sp, v, plan) + [v - 1], device="cuda")
    lg[:, cols] = kth.expand(-1, len(cols))

    def wide():
        return sp.gumbel_sample(lg, noise, temperature=SAMPLE_T,
                                top_k=SAMPLE_TOP_K)

    def wide_plain():
        return sp.gumbel_sample_plain(lg, noise, temperature=SAMPLE_T,
                                      top_k=SAMPLE_TOP_K)
    if not torch.equal(wide(), wide_plain()):
        fail(f"gumbel_sample B={b} V={v} top_k={SAMPLE_TOP_K} (unstaged): "
             "kernel != plain")
    ms, plain_ms = timer(wide), timer(wide_plain)
    kept = int((~(lg < kth)).sum())
    bnd, by = bound_ms(b * v * 4 + kept * 4 + b * 4, b * v + 2 * kept,
                       F32_OPS_PER_S)
    out[(f"V={v}", b, SAMPLE_TOP_K)] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
        library_ms=None)
    print(f"[gumbel_sample] B={b} V={v} T={SAMPLE_T} top_k={SAMPLE_TOP_K} "
          f"kept={kept} cluster={plan} unstaged (slice "
          f"{sp.gumbel_slice(v, plan)} columns in device memory) exact=yes "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} "
          f"({by}) bound_share={bnd / ms:.4f}", flush=True)
    return out


def _fused_update_check(torch, fu, label, ws, ms_, gs):
    """One whole-set call of kernel 5 for each of sgd, nesterov and lars
    against the plain version on copies of the same inputs: w within one
    bf16 ulp for bf16 w and UPDATE_M_RTOL relative for f32 w, m within
    UPDATE_M_RTOL (both are bit for bit in practice: the kernel rounds as
    the plain version's operators do); LARS's trust from the kernel's
    norms pass within ``fu.LARS_TRUST_RTOL`` of the plain one (norms
    summed in another order), and the update given that trust held to
    the same bounds.  The launches of each call must be
    ``fu.launches_per_call``.  Returns (worst |dw|, worst |dm|, worst
    trust relative error, whether every leaf was bit for bit)."""
    from repro_torch.optim.sgd import OptimConfig
    lars = OptimConfig(kind="lars")
    lkw = dict(eta=lars.lars_eta, eps=lars.lars_eps,
               weight_decay=lars.weight_decay)
    keys = [(w.dtype, m.dtype, g.dtype) for w, m, g in zip(ws, ms_, gs)]
    lr = torch.full((), 0.01, device="cuda")
    worst_w = worst_m = worst_t = 0.0
    exact = True
    for mode in ("sgd", "nesterov", "lars"):
        w1, m1 = [w.clone() for w in ws], [m.clone() for m in ms_]
        before = fu.fused_sgd_update.launches
        trust = None
        if mode == "lars":
            trust = fu.lars_trust(w1, gs, **lkw)
            want = fu.lars_trust_plain(ws, gs, **lkw)
            worst_t = ((trust - want).abs() / want.abs()).max().item()
            if not worst_t <= fu.LARS_TRUST_RTOL:
                fail(f"lars_trust {label}: {worst_t:.3g} relative from the "
                     f"plain trust (bound {fu.LARS_TRUST_RTOL})")
        kw = dict(lr=lr, trust=trust, momentum=0.9, weight_decay=1e-4,
                  nesterov=mode == "nesterov")
        fu.fused_sgd_update(w1, m1, gs, **kw)
        launched = fu.fused_sgd_update.launches - before
        if launched != fu.launches_per_call(keys, lars=mode == "lars"):
            fail(f"fused_sgd_update {label} {mode}: {launched} launches, "
                 f"want {fu.launches_per_call(keys, lars=mode == 'lars')}")
        w2, m2 = [w.clone() for w in ws], [m.clone() for m in ms_]
        fu.fused_sgd_update_plain(w2, m2, gs, **kw)
        for i, (a, b, c, d) in enumerate(zip(w1, w2, m1, m2)):
            w_rtol = 2.0 ** -7 if a.dtype == torch.bfloat16 else \
                UPDATE_M_RTOL
            m_rtol = 2.0 ** -7 if c.dtype == torch.bfloat16 else \
                UPDATE_M_RTOL
            dw = (a.float() - b.float()).abs()
            dm = (c.float() - d.float()).abs()
            if not bool((dw <= b.float().abs() * w_rtol).all()):
                fail(f"fused_sgd_update {label} {mode} leaf {i} "
                     f"{tuple(a.shape)}: w off by more than {w_rtol} "
                     "relative")
            if not bool((dm <= d.float().abs() * m_rtol).all()):
                fail(f"fused_sgd_update {label} {mode} leaf {i} "
                     f"{tuple(a.shape)}: m off by more than {m_rtol} "
                     "relative")
            worst_w = max(worst_w, dw.max().item() if dw.numel() else 0.0)
            worst_m = max(worst_m, dm.max().item() if dm.numel() else 0.0)
            exact = exact and torch.equal(a, b) and torch.equal(c, d)
        del w1, m1, w2, m2
    return worst_w, worst_m, worst_t, exact


def _fused_update_layout(torch, timer, label, ws):
    """Kernel 5 over the leaves ``ws`` as the trainer holds them (w in
    its dtype, f32 momentum and gradient): the whole-set checks of
    ``_fused_update_check``, then times over the whole set: one sgd call
    (the kernel), the LARS set (trust and update), the plain version,
    and the library yardstick ``torch.optim.SGD(fused=True)`` on an
    all-f32 copy (the same function at trust 1); and the host time of
    one ``apply_update`` over the set as a tree (host clock, no sync;
    median of 20 calls, each after a sync), sgd and lars, with its
    launches."""
    import statistics

    from repro_torch.kernels import fused_update as fu
    from repro_torch.optim import sgd
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    ms_ = [torch.randn(w.shape, generator=g, device="cuda") * 1e-2
           for w in ws]
    gs = [torch.randn(w.shape, generator=g, device="cuda") * 1e-2
          for w in ws]
    n = sum(w.numel() for w in ws)
    w_bytes = ws[0].element_size()
    worst_w, worst_m, worst_t, exact = _fused_update_check(
        torch, fu, label, ws, ms_, gs)
    print(f"[fused_sgd_update] {label}: {len(ws)} leaves, {n / 1e6:.3f}M "
          f"params ({ws[0].dtype} w, f32 m and g), sgd/nesterov/lars, one "
          f"call each: max |kernel - plain| w {worst_w:.3g} m "
          f"{worst_m:.3g}, bit for bit {exact}; lars trust max relative "
          f"error {worst_t:.3g}", flush=True)
    lkw = dict(eta=1e-3, eps=1e-9, weight_decay=1e-4)
    tiny = 1e-6

    def kernel():
        fu.fused_sgd_update(ws, ms_, gs, lr=tiny, momentum=0.9,
                            weight_decay=1e-4)

    def lars_set():
        trust = fu.lars_trust(ws, gs, **lkw)
        fu.fused_sgd_update(ws, ms_, gs, lr=tiny, trust=trust, momentum=0.9,
                            weight_decay=1e-4)

    def plain():
        fu.fused_sgd_update_plain(ws, ms_, gs, lr=tiny, momentum=0.9,
                                  weight_decay=1e-4)

    ms = timer(kernel)
    lars_ms = timer(lars_set)
    plain_ms = timer(plain)
    p32 = [w.float().requires_grad_(True) for w in ws]
    for p, gr in zip(p32, gs):
        p.grad = gr
    opt = torch.optim.SGD(p32, lr=1e-6, momentum=0.9, weight_decay=1e-4,
                          fused=True)
    lib_ms = timer(opt.step)
    del p32, opt
    # the host time of the optimizer's call over the set as a tree
    tree = lambda xs: {f"leaf_{i}": x for i, x in enumerate(xs)}
    params, state, grads = tree(ws), {"m": tree(ms_)}, tree(gs)
    host, per_call = {}, {}
    for kind in ("sgd", "lars"):
        cfg = sgd.OptimConfig(kind=kind)
        times = []
        for _ in range(23):
            torch.cuda.synchronize()
            before = fu.fused_sgd_update.launches
            t0 = time.perf_counter()
            sgd.apply_update(params, state, grads, tiny, cfg)
            times.append(time.perf_counter() - t0)
            per_call[kind] = fu.fused_sgd_update.launches - before
        host[kind] = statistics.median(times[3:]) * 1e3
    torch.cuda.synchronize()
    # w and m read and written, g read
    bnd, by = bound_ms(n * (2 * w_bytes + 4 + 4 + 4), 6 * n, F32_OPS_PER_S)
    print(f"[fused_sgd_update] {label} whole set: kernel_ms={ms:.4f} "
          f"lars_ms={lars_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bnd:.4f} ({by}, {2 * w_bytes + 12} B a param; "
          f"{ms / bnd:.2f}x, {bnd / ms:.1%} of the bound) "
          f"library_ms(torch.optim.SGD fused, all-f32)={lib_ms:.4f} "
          f"({ms / lib_ms:.2f}x); apply_update host_ms sgd="
          f"{host['sgd']:.4f} lars={host['lars']:.4f}; launches a call "
          f"sgd {per_call['sgd']} lars {per_call['lars']}", flush=True)
    del ms_, gs, params, state, grads
    return dict(max_abs_err=max(worst_w, worst_m), ms=ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=lib_ms)


def _fused_update_ragged(torch):
    """Kernel 5 over a ragged set against the plain version: leaves of 1,
    7, 8, 9, 63, 64, 2047, 2048 and 2,359,296 elements twice, f32 w, m,
    g and bf16 w with f32 m and bf16 g interleaved, then TABLE_LEAVES
    small f32 leaves (1-300 elements), so that the f32 group outgrows one
    table and takes a second launch: 3 launches for sgd, 9 for lars."""
    from repro_torch.kernels import fused_update as fu
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    sizes = [1, 7, 8, 9, 63, 64, 2047, 2048, 3 * 3 * 512 * 512]
    ws, ms_, gs = [], [], []
    for n in sizes:
        for wdt in (torch.float32, torch.bfloat16):
            ws.append(torch.randn((n,), generator=g, device="cuda").to(wdt))
            ms_.append(torch.randn((n,), generator=g, device="cuda") * 1e-2)
            gs.append((torch.randn((n,), generator=g, device="cuda")
                       * 1e-2).to(wdt))
    for i in range(fu.TABLE_LEAVES):
        n = 1 + (37 * i) % 300
        ws.append(torch.randn((n,), generator=g, device="cuda"))
        ms_.append(torch.randn((n,), generator=g, device="cuda") * 1e-2)
        gs.append(torch.randn((n,), generator=g, device="cuda") * 1e-2)
    keys = [(w.dtype, m.dtype, gr.dtype) for w, m, gr in zip(ws, ms_, gs)]
    sgd_n, lars_n = fu.launches_per_call(keys), fu.launches_per_call(
        keys, lars=True)
    if (sgd_n, lars_n) != (3, 9):
        fail(f"fused_sgd_update ragged set: launch rule gives {sgd_n} / "
             f"{lars_n}, want 3 / 9")
    worst_w, worst_m, worst_t, exact = _fused_update_check(
        torch, fu, "ragged", ws, ms_, gs)
    print(f"[fused_sgd_update] ragged set: {len(ws)} leaves (f32 and bf16 "
          f"w, f32 and bf16 g), launches a call sgd {sgd_n} lars {lars_n}: "
          f"max |kernel - plain| w {worst_w:.3g} m {worst_m:.3g}, bit for "
          f"bit {exact}; lars trust max relative error {worst_t:.3g}",
          flush=True)
    return max(worst_w, worst_m)


def phase_fused_update(torch, timer, cfg):
    """Kernel 5 over every leaf of each tree the trainers update, at full
    width: qwen2-1.5b (14 leaves, bf16 w), whose numbers fill the
    kernel's JSON row; ResNet-50 (161 leaves, f32 w; 106 of them
    batch-norm scales and biases of 64-2048 floats); recurrentgemma-2b
    (bf16 w, 2.383B params, a 655M-element embedding); whisper-tiny (bf16
    w, the stacked encoder and decoder leaves, 384-wide layernorm biases,
    a 51,865 x 384 embedding); mamba2-370m (bf16 w, 48 stacked layers, a
    tied 50,280 x 1,024 embedding); then the ragged set.  The JSON row's
    error is the worst over all of them.  Returns (the row, each set's
    numbers by label)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    out = {}
    for label in (cfg.name, "resnet50", RGEMMA, WHISPER, MAMBA):
        c = cfg if label == cfg.name else get_config(label)
        params = build_model(c).init(SEED, "cuda")
        out[label] = _fused_update_layout(torch, timer, label,
                                          list(_leaves(params)))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    row = dict(out[cfg.name])
    row["max_abs_err"] = max([r["max_abs_err"] for r in out.values()]
                             + [_fused_update_ragged(torch)])
    return row, out


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------


def _init_params(torch, cfg):
    """(model, params) of full-width ``cfg`` (bf16, random weights from
    SEED, on the card), printed with their count and init time."""
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name} full width: {cfg.num_layers} layers "
          f"{[(k, f, n) for k, f, n in _runs(cfg)][:3]}, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads at hd "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}: {nparams / 1e9:.3f}B "
          f"params {cfg.param_dtype} ({torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB on the card), init {time.perf_counter() - t0:.1f}s",
          flush=True)
    return model, params


def _serve_once(torch, model, params, work, depth, *, engine=None,
                stats=None, devices=None, **sample):
    """One main-path run through a fresh Engine (ENGINE_CONFIG, updated by
    ``engine``; on cuda, or over the tensor-parallel slice ``devices``),
    every launch count set to 0 just before it and read just after.
    Returns (token streams, counts, tok/s, a summary line); a ``stats``
    dict takes the engine's counters and its kv_blocks_reclaimed."""
    from repro_torch import kernels
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.serve.profile_engine import ENGINE_CONFIG
    eng = Engine(model, params,
                 EngineConfig(steps_per_dispatch=depth, **sample,
                              **dict(ENGINE_CONFIG, **(engine or {}))),
                 **(dict(devices=devices) if devices else
                    dict(device="cuda")))
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
        fail(f"depth {depth}: {len(res)} of {len(work)} requests done")
    for i, (p, n) in enumerate(work):
        if len(res[i].tokens) != n:
            fail(f"depth {depth}: request {i} gave {len(res[i].tokens)} "
                 f"tokens, wanted {n}")
    if snap["counters"]["jit_compiles"] != 0:
        fail("jit_compiles != 0")
    if eng.state_slots is not None and \
            eng.state_slots.num_free != eng.cfg.num_slots:
        fail(f"depth {depth}: {eng.cfg.num_slots - eng.state_slots.num_free}"
             " state slots still held after the run")
    ntok = sum(len(r.tokens) for r in res.values())
    decode_rates = [(len(r.tokens) - 1) / (r.finish_time
                                           - r.first_token_time)
                    for r in res.values()
                    if r.finish_time > r.first_token_time]
    ttft = sorted(r.first_token_time - t0 for r in res.values())
    reclaimed = int(eng.kv._m["reclaimed"].value)
    if stats is not None:
        stats.update(snap["counters"], kv_blocks_reclaimed=reclaimed)
    line = (f"requests={len(res)} tokens={ntok} wall_s={wall:.3f} "
            f"tok_s={ntok / wall:.1f} "
            f"ttft_p50_s={ttft[len(ttft) // 2]:.4f} "
            f"decode_tok_s_per_request_mean="
            f"{sum(decode_rates) / len(decode_rates):.1f} "
            f"steps={snap['counters']['steps']} "
            f"model_calls={snap['counters']['model_calls']} "
            f"loop_dispatches={snap['counters']['loop_dispatches']} "
            f"kv_blocks_reclaimed={reclaimed} "
            f"launches={json.dumps(counts)}")
    return ({i: res[i].tokens for i in range(len(work))}, counts,
            ntok / wall, line)


def phase_serve(torch, cfg):
    """The serving main path, per depth (1 and 8): SERVE_REPEATS greedy
    runs, then two runs at SAMPLE_T / SAMPLE_TOP_K that must give the
    same streams.  Returns the launches of each depth's first greedy and
    first sampled run, summed."""
    from repro_torch import kernels
    from repro_torch.serve.profile_engine import workload

    model, params = _init_params(torch, cfg)
    work = workload(cfg.vocab_size, SEED)
    launches = {fn.__name__: 0 for fn in kernels.KERNELS}
    greedy_streams, sampled_streams = [], {}
    sample = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=SEED)
    for depth in (1, 8):
        rates = []
        for rep in range(SERVE_REPEATS):
            stream, counts, rate, line = _serve_once(torch, model, params,
                                                     work, depth)
            print(f"[serve] depth={depth} greedy run={rep} {line}",
                  flush=True)
            need = ["flash_decode_paged", "greedy_sample"]
            if depth > 1:
                need.append("decode_view_attend")
            for name in need:
                if counts[name] <= 0:
                    fail(f"depth {depth}: {name} never launched")
            if counts["gumbel_sample"]:
                fail("greedy serving launched gumbel_sample")
            if rep == 0:
                for k, v in counts.items():
                    launches[k] += v
            rates.append(rate)
            if stream not in greedy_streams:
                greedy_streams.append(stream)
        rates.sort()
        print(f"[serve] depth={depth} greedy tok_s over {SERVE_REPEATS} "
              f"runs: median {rates[len(rates) // 2]:.1f} min "
              f"{rates[0]:.1f} max {rates[-1]:.1f}", flush=True)
        runs = []
        for rep in range(2):
            stream, counts, _, line = _serve_once(torch, model, params,
                                                  work, depth, **sample)
            print(f"[serve] depth={depth} T={SAMPLE_T} top_k="
                  f"{SAMPLE_TOP_K} run={rep} {line}", flush=True)
            if counts["gumbel_sample"] <= 0 or counts["greedy_sample"]:
                fail(f"depth {depth}: sampled serving did not go through "
                     "gumbel_sample alone")
            if rep == 0:
                for k, v in counts.items():
                    launches[k] += v
            runs.append(stream)
        if runs[0] != runs[1]:
            fail(f"depth {depth}: a repeat at T={SAMPLE_T} gave other "
                 "streams")
        sampled_streams[depth] = runs[0]
    same = sampled_streams[1] == sampled_streams[8]
    print(f"[serve] distinct greedy token streams over the "
          f"{2 * SERVE_REPEATS} runs: {len(greedy_streams)}; sampled "
          f"streams repeat at each depth; depth 1 == depth 8: {same}",
          flush=True)
    _teacher_forced_check(torch, model, params, work, greedy_streams,
                          list(sampled_streams.values()))
    return launches


@float32_exact()
def phase_depth_f32(torch, cfg):
    """Depth 1 against depth 8 in float32 on the card's kernels: ``cfg``
    (full width; deepseek at its depth cut, qwen2, mamba and
    recurrentgemma at F32_GATE_LAYERS) with f32 weights from SEED
    and f32 compute, TF32 off, serves the workload through the paged
    Engine at steps_per_dispatch 1 and 8, greedy and at SAMPLE_T /
    SAMPLE_TOP_K.  Depth 1 must equal depth 8 token for token, as the
    reference pins it in f32 (tests/test_serve_decode_loop.py).  In bf16
    the serving phases print the two depths parting, ungated: the two
    depths attend with other kernels, whose sums run in other orders."""
    from repro_torch.models.model import build_model
    from repro_torch.serve.profile_engine import workload
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    print(f"[depth_f32] {cfg.name} {cfg.num_layers} layers, "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f}B params "
          f"float32 ({torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
          f"card), init {time.perf_counter() - t0:.1f}s", flush=True)
    if cfg.family == "ssm":
        need = {1: ["slot_gather"], 8: ["slot_gather"]}
    elif cfg.mla is not None:
        need = {1: ["mla_decode_paged"], 8: ["mla_decode_views"]}
    else:
        need = {1: ["flash_decode_paged"], 8: ["decode_view_attend"]}
    work = workload(cfg32.vocab_size, SEED)
    sample = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=SEED)
    streams = {}
    for mode, kw in (("greedy", {}), ("sampled", sample)):
        for depth in (1, 8):
            stream, counts, _, line = _serve_once(torch, model, params, work,
                                                  depth, **kw)
            print(f"[depth_f32] {cfg.name} depth={depth} {mode} {line}",
                  flush=True)
            for name in need[depth]:
                if counts[name] <= 0:
                    fail(f"{cfg.name} f32 depth {depth}: {name} never "
                         "launched")
            streams[mode, depth] = stream
    peak = torch.cuda.max_memory_allocated() / 1e9
    same = {mode: streams[mode, 1] == streams[mode, 8]
            for mode in ("greedy", "sampled")}
    print(f"[depth_f32] {cfg.name}: depth 1 == depth 8 in float32: greedy "
          f"{same['greedy']}, sampled {same['sampled']}; peak memory "
          f"{peak:.2f} GB", flush=True)
    for mode in ("greedy", "sampled"):
        if not same[mode]:
            one, eight = streams[mode, 1], streams[mode, 8]
            rid, t = next((r, i) for r in sorted(one)
                          for i, (a, b) in enumerate(zip(one[r], eight[r]))
                          if a != b)
            fail(f"{cfg.name} f32 {mode}: depth 1 and depth 8 part at "
                 f"request {rid} token {t} ({one[rid][t]} against "
                 f"{eight[rid][t]})")
    del params


# ---------------------------------------------------------------------------
# the cluster layer: two replicas share the card
# ---------------------------------------------------------------------------


def _cluster_once(torch, model, params, work, label, *, plan=None,
                  health=None, **sample):
    """One main-path run through ``ServeCluster.for_replicas`` with
    CLUSTER_REPLICAS replicas sharing cuda:0 (the reference's round-robin
    single-device slices), CLUSTER_DEPTH, ENGINE_CONFIG.  Every launch
    count set to 0 just before it and read just after.  Every request
    must end exactly once with all its tokens and no fault result; each
    planned fault must fire and fail its replica over once, with that
    fault as the replica's reason, while every other replica retires
    drained (a fault-free run: no failover, every replica drained).
    Returns (streams, counts, tok/s)."""
    from repro_torch import kernels
    from repro_torch.serve import (EngineConfig, HealthConfig, Request,
                                   ServeCluster)
    from repro_torch.serve.profile_engine import ENGINE_CONFIG
    cluster = ServeCluster.for_replicas(
        model, params, EngineConfig(steps_per_dispatch=CLUSTER_DEPTH,
                                    **sample, **ENGINE_CONFIG),
        num_replicas=CLUSTER_REPLICAS, devices=[torch.device("cuda", 0)],
        faults=plan, health=health or HealthConfig(**CLUSTER_HEALTH),
        join_timeout_s=CLUSTER_JOIN_S)
    try:
        if [str(e.device) for e in cluster.engines] != \
                ["cuda:0"] * CLUSTER_REPLICAS:
            fail(f"cluster {label}: replicas on "
                 f"{[str(e.device) for e in cluster.engines]}")
        cluster.warmup()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = cluster.run([Request(prompt=p.copy(), max_new_tokens=n, rid=i)
                           for i, (p, n) in enumerate(work)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        if plan is not None:
            plan.release_hangs()
    m = cluster.metrics()
    book = cluster.telemetry.requests
    ntok = sum(len(r.tokens) for r in res.values())
    per = {i: m["per_replica"][i]["counters"]["generated_tokens"]
           for i in range(CLUSTER_REPLICAS)}
    health = {i: (h["state"], h["reason"]) for i, h in m["health"].items()}
    fired = [] if plan is None else [(a.replica, a.dispatch, a.kind)
                                     for a in plan.fired()]
    print(f"[cluster] {model.cfg.name} {label}: requests={len(res)} "
          f"tokens={ntok} wall_s={wall:.3f} tok_s={ntok / wall:.1f} "
          f"tokens_by_replica={per} failovers="
          f"{m['failover']['failovers']} redispatched="
          f"{m['failover']['redispatched']} health={health} fired={fired} "
          f"launches={json.dumps(counts)}", flush=True)
    if sorted(res) != list(range(len(work))):
        fail(f"cluster {label}: {len(res)} of {len(work)} requests ended")
    for i, (_, n) in enumerate(work):
        if res[i].fault is not None or len(res[i].tokens) != n:
            fail(f"cluster {label}: request {i} ended with fault "
                 f"{res[i].fault} and {len(res[i].tokens)} of {n} tokens")
    if book.double_terminals.value != 0:
        fail(f"cluster {label}: {book.double_terminals.value} double "
             "terminals")
    if any(t.terminal != "complete" for t in book.traces()):
        fail(f"cluster {label}: a request's trace ended other than "
             "complete")
    # no failure may hide behind a failover: the planned replicas (and
    # only they) die, each of its planned fault, and every other replica
    # retires cleanly; a fault-free run fails nothing over
    planned = [] if plan is None else plan.planned()
    if [(a.replica, a.dispatch, a.kind) for a in planned] != fired:
        fail(f"cluster {label}: planned {planned}, fired {fired}")
    want = {i: ("dead", "drained") for i in range(CLUSTER_REPLICAS)}
    exc = {"kill": "ReplicaKilled", "error": "FaultInjected"}
    for a in planned:
        want[a.replica] = ("dead", "hung" if a.kind == "hang" else
                           f"{exc[a.kind]}: injected {a.kind} at replica "
                           f"{a.replica} dispatch {a.dispatch}")
    if health != want:
        fail(f"cluster {label}: replica health {health}, expected {want}")
    if m["failover"]["failovers"] != len(planned):
        fail(f"cluster {label}: {m['failover']['failovers']} failovers "
             f"for {len(planned)} planned faults")
    if m["failover"]["shed"] or m["failover"]["forced_drains"]:
        fail(f"cluster {label}: shed or forced drains in {m['failover']}")
    if (m["failover"]["redispatched"] > 0) != bool(planned):
        fail(f"cluster {label}: {m['failover']['redispatched']} requests "
             f"redispatched for {len(planned)} planned faults")
    if sum(cluster.loads().values()) != 0:
        fail(f"cluster {label}: router loads {cluster.loads()} after the "
             "run")
    del cluster
    return {i: res[i].tokens for i in range(len(work))}, counts, ntok / wall


def _kill_plan():
    from repro_torch.serve import FaultPlan
    return FaultPlan.kill_at(replica=0, dispatch=CLUSTER_FAULT_AT)


def _hang_plan():
    from repro_torch.serve import FaultAction, FaultPlan
    return FaultPlan([FaultAction(1, CLUSTER_FAULT_AT, "hang")],
                     hang_timeout_s=CLUSTER_JOIN_S)


def _mismatches(a, b):
    """(requests, tokens) on which two stream sets differ."""
    reqs = [i for i in a if a[i] != b[i]]
    toks = sum(sum(x != y for x, y in zip(a[i], b[i]))
               + abs(len(a[i]) - len(b[i])) for i in reqs)
    return len(reqs), toks


def phase_serve_cluster(torch, cfg, card):
    """The cluster layer on the card: full-width ``cfg`` (qwen2-1.5b,
    bf16, random weights from SEED) served by two replicas sharing cuda:0
    at depth CLUSTER_DEPTH with ENGINE_CONFIG and phase_serve's workload:
    fault-free greedy, greedy and sampled under a kill of replica 0 at
    its CLUSTER_FAULT_AT-th dispatch, and greedy with replica 1 hung
    there under a hard heartbeat deadline of a few seconds.  Each run
    must end every request exactly once with no fault result and launch
    kernels 1-3 (greedy) or 1, 2 and 4 (sampled); every stream passes the
    teacher-forced f32 check.  One engine serves the same workload for
    the tok/s beside the cluster's; the bf16 mismatch count of the kill
    run against the fault-free run is printed, not gated (two replicas
    batch the requests otherwise, and a failover re-prefills).  Then
    float32 (``_cluster_f32``), where the kill and hang runs must equal
    the fault-free cluster's streams and one engine's.  Returns the
    launches of the four bf16 cluster runs, summed."""
    from repro_torch import kernels
    from repro_torch.models.model import build_model
    from repro_torch.serve.profile_engine import workload
    from repro_torch.serve import HealthConfig
    model = build_model(cfg)
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    work = workload(cfg.vocab_size, SEED)
    sample = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=SEED)
    hang = HealthConfig(**CLUSTER_HANG_HEALTH)
    launches = {fn.__name__: 0 for fn in kernels.KERNELS}
    runs = {}
    for label, kw in (("fault-free greedy", {}),
                      ("kill greedy", dict(plan=_kill_plan())),
                      ("kill sampled", dict(plan=_kill_plan(), **sample)),
                      ("hang greedy", dict(plan=_hang_plan(), health=hang))):
        stream, counts, rate = _cluster_once(torch, model, params, work,
                                             label, **kw)
        need = ["flash_decode_paged", "decode_view_attend",
                "gumbel_sample" if "sampled" in label else "greedy_sample"]
        for name in need:
            if counts[name] <= 0:
                fail(f"cluster {label}: {name} never launched")
        if counts["gumbel_sample" if "greedy" in label
                  else "greedy_sample"]:
            fail(f"cluster {label}: launched the other sampler")
        for k, v in counts.items():
            launches[k] += v
        runs[label] = (stream, rate)
    single, _, single_rate, line = _serve_once(torch, model, params, work,
                                               CLUSTER_DEPTH)
    print(f"[cluster] {cfg.name} one engine, depth {CLUSTER_DEPTH}: {line}",
          flush=True)
    free = runs["fault-free greedy"][0]
    kreq, ktok = _mismatches(runs["kill greedy"][0], free)
    hreq, htok = _mismatches(runs["hang greedy"][0], free)
    sreq, stok = _mismatches(single, free)
    print(f"[cluster] {cfg.name} bf16 tok/s: two replicas on one card "
          f"{runs['fault-free greedy'][1]:.1f} (kill "
          f"{runs['kill greedy'][1]:.1f}, kill sampled "
          f"{runs['kill sampled'][1]:.1f}, hang {runs['hang greedy'][1]:.1f}"
          f"), one engine {single_rate:.1f}; streams unlike the fault-free "
          f"cluster's: kill {kreq} requests / {ktok} tokens, hang {hreq} / "
          f"{htok}, one engine {sreq} / {stok} (printed, not gated); "
          f"card: {card}", flush=True)
    _teacher_forced_check(
        torch, model, params, work,
        [runs[k][0] for k in ("fault-free greedy", "kill greedy",
                              "hang greedy")],
        [runs["kill sampled"][0]])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _cluster_f32(torch, cfg, work)
    return launches


@float32_exact()
def _cluster_f32(torch, cfg, work):
    """float32 weights and compute (TF32 off): the kill and the hang
    cluster runs must equal the fault-free cluster run and one engine,
    token for token, greedy, at CLUSTER_DEPTH and ``cfg``'s full depth
    (phase_depth_f32's)."""
    from repro_torch.models.model import build_model
    from repro_torch.serve import HealthConfig
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg32)
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    single, _, rate, line = _serve_once(torch, model, params, work,
                                        CLUSTER_DEPTH)
    print(f"[cluster] {cfg.name} f32 one engine: {line}", flush=True)
    got = {}
    for label, kw in (("f32 fault-free greedy", {}),
                      ("f32 kill greedy", dict(plan=_kill_plan())),
                      ("f32 hang greedy", dict(
                          plan=_hang_plan(),
                          health=HealthConfig(**CLUSTER_HANG_HEALTH)))):
        got[label], counts, _ = _cluster_once(torch, model, params, work,
                                              label, **kw)
        for name in ("flash_decode_paged", "decode_view_attend",
                     "greedy_sample"):
            if counts[name] <= 0:
                fail(f"cluster {label}: {name} never launched")
    for label, stream in got.items():
        req, tok = _mismatches(stream, single)
        print(f"[cluster] {cfg.name} {label} == one engine in float32: "
              f"{req == 0} ({req} requests / {tok} tokens differ)",
              flush=True)
        if req:
            rid, t = next((r, i) for r in sorted(stream)
                          for i, (a, b) in enumerate(zip(stream[r],
                                                         single[r]))
                          if a != b)
            fail(f"{label}: request {rid} parts from one engine's stream "
                 f"at token {t} ({stream[rid][t]} against {single[rid][t]})")
    del params


# ---------------------------------------------------------------------------
# tensor-parallel serving: one engine over a slice of two shards
# ---------------------------------------------------------------------------


def tp_devices(torch):
    """The slice the TP phases serve on: cuda:0 and cuda:1 on a machine
    with two cards or more, else cuda:0 twice (two shards on one card)."""
    two = torch.cuda.device_count() >= 2
    devices = (torch.device("cuda", 0), torch.device("cuda", 1 if two
                                                     else 0))
    print(f"[tp] slice {[str(d) for d in devices]}: "
          f"{'two cards' if two else 'two shards on one card'}", flush=True)
    return devices


def shard_layout(cfg, tp=TP):
    """The config whose unsharded layouts are one shard's of a slice of
    ``tp`` (``repro_torch.sharding``'s plan): the kernel phases run at
    it.  Heads, kv heads (a kv head its shards share stays one), mamba's
    inner width (its B and C whole) and the RG-LRU's width over ``tp``."""
    import dataclasses
    kv = cfg.num_kv_heads
    out = cfg.replace(num_heads=cfg.num_heads // tp,
                      num_kv_heads=kv // tp if kv % tp == 0 else 1)
    if cfg.ssm is not None:
        out = out.replace(ssm=dataclasses.replace(
            cfg.ssm, expand=cfg.ssm.expand // tp))
    if cfg.rglru is not None:
        out = out.replace(rglru=dataclasses.replace(
            cfg.rglru, lru_width=(cfg.rglru.lru_width or cfg.d_model) // tp))
    return out


def _tp_serve(torch, cfg, model, params, work, devices, depth, label,
              **kw):
    """One run of ``cfg`` over the slice ``devices``, its launches held to
    ``_serving_launches`` for the slice (an MLA config: its two kernels
    launched, kernels 1 and 2 never).  Returns (streams, counts, routes
    or None)."""
    moe = cfg.moe is not None
    stats = {}
    with (ServedRouting(torch, model, shards=len(devices)) if moe
          else contextlib.nullcontext()) as rec:
        stream, counts, _, line = _serve_once(
            torch, rec.model if moe else model, params, work, depth,
            stats=stats, devices=devices, **kw)
    print(f"[tp] {cfg.name} TP {len(devices)} depth={depth} {label} {line}",
          flush=True)
    got = {k: v for k, v in counts.items() if v}
    if cfg.mla is not None:
        need = ["mla_decode_paged"] + (["mla_decode_views"] if depth > 1
                                       else [])
        if any(counts[n] <= 0 for n in need) or counts["flash_decode_paged"] \
                or counts["decode_view_attend"]:
            fail(f"{cfg.name} TP depth {depth}: launches {got}")
    else:
        want = _serving_launches(cfg, stats, depth, bool(kw), len(devices))
        if got != {k: v for k, v in want.items() if v}:
            fail(f"{cfg.name} TP {label} depth {depth}: launches {got}, "
                 f"want {want}")
    return stream, counts, rec.resolve() if moe else None


def phase_serve_tp(torch, cfg, devices, depths=((1, False), (8, False),
                                                (8, True))):
    """A tensor-parallel replica on the card: full-width ``cfg`` (bf16,
    random weights from SEED; deepseek, mamba and recurrentgemma at
    TP_LAYERS) served by one Engine over the slice ``devices`` (two
    shards: ``repro_torch.sharding``'s plan), the qwen2 phase's 16
    requests at each (depth, sampled) of ``depths``, each run making
    exactly the launches its counters call for over the slice.  Every
    emitted token is held to the teacher-forced f32 check on the unsplit
    weights (an MoE config's oracle routes as the served run routed).
    Returns the launches of the runs, summed."""
    from repro_torch import kernels
    from repro_torch.serve.profile_engine import workload
    model, params = _init_params(torch, cfg)
    work = workload(cfg.vocab_size, SEED)
    launches = {fn.__name__: 0 for fn in kernels.KERNELS}
    greedy, sampled, routes = [], [], []
    sample = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=SEED)
    for depth, hot in depths:
        label = f"T={SAMPLE_T} top_k={SAMPLE_TOP_K}" if hot else "greedy"
        torch.cuda.reset_peak_memory_stats()
        stream, counts, route = _tp_serve(
            torch, cfg, model, params, work, devices, depth, label,
            **(sample if hot else {}))
        print(f"[tp] {cfg.name} peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        for k, v in counts.items():
            launches[k] += v
        (sampled if hot else greedy).append(stream)
        routes.append((hot, route))
    moe = cfg.moe is not None
    _teacher_forced_check(
        torch, model, params, work, greedy, sampled,
        argmax_floor=None if moe else TF_ARGMAX_FLOOR,
        routes=([r for hot, r in routes if not hot]
                + [r for hot, r in routes if hot]) if moe else None)
    del params
    return launches


@float32_exact()
def phase_tp_f32(torch, cfg, devices):
    """float32 weights and compute (TF32 off): full-width ``cfg`` over the
    slice ``devices`` must give one engine's streams token for token, at
    depth 1 greedy and depth 8 greedy and sampled (the partial sums of
    the split products run in another order than one engine's products,
    so this holds the plan and the reductions, not bits)."""
    from repro_torch.models.model import build_model
    from repro_torch.serve.profile_engine import workload
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg32)
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    work = workload(cfg.vocab_size, SEED)
    sample = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=SEED)
    for depth, kw in ((1, {}), (8, {}), (8, sample)):
        mode = "sampled" if kw else "greedy"
        one, _, rate1, _ = _serve_once(torch, model, params, work, depth,
                                       **kw)
        two, counts, rate2, line = _serve_once(torch, model, params, work,
                                               depth, devices=devices, **kw)
        req, tok = _mismatches(two, one)
        print(f"[tp] {cfg.name} f32 TP {len(devices)} depth={depth} {mode} "
              f"{line}; one engine tok_s={rate1:.1f}; == one engine: "
              f"{req == 0} ({req} requests / {tok} tokens differ)",
              flush=True)
        if req:
            rid, t = next((r, i) for r in sorted(two)
                          for i, (a, b) in enumerate(zip(two[r], one[r]))
                          if a != b)
            fail(f"{cfg.name} f32 TP depth {depth} {mode}: request {rid} "
                 f"parts from one engine's stream at token {t} "
                 f"({two[rid][t]} against {one[rid][t]})")
    del params


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------


def _update_launches(state) -> int:
    """Kernel 5's launches in one deferred update of a trainer's state:
    ``launches_per_call`` of its (param, momentum, pending) dtypes, a
    count that does not grow with the leaves."""
    from repro_torch.kernels import fused_update as fu
    keys = [(w.dtype, m.dtype, g.dtype) for w, m, g in zip(
        _leaves(state["params"]), _leaves(state["opt"]["m"]),
        _leaves(state["pending"]))]
    return fu.launches_per_call(keys)


def phase_train(torch, argv=TRAIN_ARGV):
    """The training main path: ``repro_torch.launch.train`` with
    ``argv`` (TRAIN_ARGV, RG_TRAIN_ARGV or WHISPER_TRAIN_ARGV: LSGD,
    fused SGD), every launch count set to 0 just before and read just
    after.  The loss must be finite at every step, and kernel 5 must
    have launched exactly its launches a call for each of the 7 deferred
    updates and ``finalize``."""
    import statistics

    from repro_torch import kernels
    from repro_torch.launch import train
    args = train.parse_args(argv)
    kernels.reset_launch_counts()
    out = train.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    losses, step_s = out["losses"], out["step_s"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"training loss not finite: {losses}")
    per_step = _update_launches(out["state"])
    if counts["fused_sgd_update"] != per_step * len(losses):
        fail(f"training: {counts['fused_sgd_update']} fused_sgd_update "
             f"launches, want {per_step} a deferred update x "
             f"{len(losses)}")
    med = statistics.median(step_s[-6:])
    res = dict(loss_first=losses[0], loss_last=losses[-1], step_ms=med * 1e3,
               tokens_per_s=out["tokens_per_step"] / med,
               peak_gb=out["peak_mem_bytes"] / 1e9, launches=counts)
    depth = f", {args.layers} layers" if args.layers else ""
    print(f"[train] {args.arch} full width{depth}, {out['params'] / 1e9:.3f}B "
          f"params bf16, batch {args.batch} x {args.seq}, lsgd, fused sgd, "
          f"schedule {args.schedule}: "
          f"loss first "
          f"{losses[0]:.4f} last {losses[-1]:.4f}; step ms (median of the "
          f"last 6) {res['step_ms']:.1f}; train tok/s "
          f"{res['tokens_per_s']:.0f}; peak memory {res['peak_gb']:.2f} GB;"
          f" step ms all {[round(x * 1e3, 1) for x in step_s]}; "
          f"launches={json.dumps(counts)}; card: {nvidia_smi()}", flush=True)
    del out
    return res


@float32_exact()
def phase_virtual(torch, cfg):
    """The paper's claim on the card: virtual CSGD and LSGD (4 workers in
    groups of 2, 3 steps, fused SGD) from one set of weights agree within
    VIRTUAL_BOUND after finalize.  Full width cut to VIRTUAL_LAYERS
    layers, float32 with TF32 off."""
    from repro_torch.core import virtual
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models.model import build_model
    from repro_torch.optim.sgd import OptimConfig
    from repro_torch.tree import leaves
    cfg32 = cfg.replace(num_layers=VIRTUAL_LAYERS, param_dtype="float32",
                        compute_dtype="float32", remat=False)
    model = build_model(cfg32)
    p0 = model.init(SEED, "cuda")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                      global_batch=4, seed=SEED)
    wb = [virtual.partition_minibatch(
        {"tokens": torch.from_numpy(synth_batch(dcfg, t)["tokens"]).cuda()},
        4) for t in range(3)]
    ocfg = OptimConfig()
    lr_fn = lambda t: 0.01
    pc, lc = virtual.csgd(model, p0, wb, lr_fn, ocfg)
    pl, ll = virtual.lsgd(model, p0, wb, lr_fn, ocfg, 2)
    diff = max((a - b).abs().max().item()
               for a, b in zip(leaves(pc), leaves(pl)))
    moved = max((a - b).abs().max().item()
                for a, b in zip(leaves(pc), leaves(p0)))
    print(f"[virtual] csgd vs lsgd, {VIRTUAL_LAYERS} layers f32, 4 workers "
          f"/ groups of 2, 3 steps: max |param diff| {diff:.3g} (bound "
          f"{VIRTUAL_BOUND}); params moved {moved:.3g}; losses csgd "
          f"{[round(x, 4) for x in lc]} lsgd {[round(x, 4) for x in ll]}",
          flush=True)
    if not (diff < VIRTUAL_BOUND and moved > 0):
        fail(f"virtual csgd and lsgd differ by {diff} (bound "
             f"{VIRTUAL_BOUND})")
    return diff


def _synth_batches(torch, cfg, batch, seq, steps, device="cuda"):
    """The launcher's synthetic batches (``data_config_for``, seed SEED)
    on ``device``."""
    from types import SimpleNamespace

    from repro_torch.data.pipeline import data_config_for, synth_batch
    dcfg = data_config_for(cfg, SimpleNamespace(seq_len=seq,
                                                global_batch=batch), SEED)
    return [{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in synth_batch(dcfg, t).items()} for t in range(steps)]


def phase_train_pjit(torch, cfg, mesh=None, batch=PJIT_BATCH, zero3=False):
    """The reference's training step for an MoE config on a mesh
    (``launch.builders.make_train_step``: the FSDP / pjit step, the mesh
    active, so the MoE runs ``apply_moe_ep``; ``zero3`` forces ZeRO-3):
    PJIT_STEPS LSGD steps of ``batch`` x PJIT_SEQ tokens (the global
    batch; each rank its rows) and the trailing update, every launch
    count set to 0 just before and read just after.  ``mesh`` defaults
    to one rank; over several (``chip_mesh.py``, one process a card)
    every step starts at a barrier, the peak memory is the largest
    rank's and rank 0 prints.  Finite losses, and kernel 5 launched
    exactly ``launches_per_call`` of the state's dtypes for each of the
    7 deferred updates and ``finalize``.  Returns (results,
    ``make_train_step``'s TrainStep)."""
    import statistics

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch import builders
    from repro_torch.launch.mesh import make_mesh
    mesh = mesh or make_mesh((1, 1), ("data", "model"))
    ranks = dist.is_initialized()
    shape = builders.ShapeConfig("chip", PJIT_SEQ, batch, "train")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts = builders.make_train_step(cfg, shape, mesh, "lsgd", zero3=zero3,
                                  lr_fn=lambda t: 0.01)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = _synth_batches(torch, cfg, batch, PJIT_SEQ, PJIT_STEPS)
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for b in batches:
        if ranks:
            dist.barrier()
            torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = ts(b)
        losses.append(float(loss))          # waits for the step
        step_s.append(time.perf_counter() - t)
    ts.finish()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if not all(math.isfinite(x) for x in losses):
        fail(f"{cfg.name} pjit training loss not finite: {losses}")
    per_step = _update_launches(ts.state)
    if counts["fused_sgd_update"] != per_step * len(losses):
        fail(f"{cfg.name} pjit training: {counts['fused_sgd_update']} "
             f"fused_sgd_update launches, want {per_step} a deferred "
             f"update x {len(losses)}")
    med = statistics.median(step_s[-6:])
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                        device="cuda")
    if ranks:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    res = dict(loss_first=losses[0], loss_last=losses[-1],
               step_ms=med * 1e3, tokens_per_s=batch * PJIT_SEQ / med,
               peak_gb=peak.item(), launches=counts)
    if mesh.rank == 0:
        print(f"[train pjit] {cfg.name} full width, {cfg.num_layers} "
              f"layers, {ts.n_params / 1e9:.3f}B params {cfg.param_dtype}, "
              f"{ts.description} on {mesh} ({mesh.world} rank(s), "
              f"expert-parallel MoE), batch {batch} x {PJIT_SEQ}, fused "
              f"sgd, lr 0.01: init {init_s:.1f}s; losses "
              f"{[round(x, 4) for x in losses]}; step ms (median of the "
              f"last 6) {res['step_ms']:.1f}; train tok/s "
              f"{res['tokens_per_s']:.0f}; peak memory"
              f"{' (largest rank)' if ranks else ''} {res['peak_gb']:.2f} "
              f"GB; step ms all {[round(x * 1e3, 1) for x in step_s]}; "
              f"launches={json.dumps(counts)}; card: {nvidia_smi()}",
              flush=True)
    return res, ts


def _fused_update_inplace(torch, timer, label, ws, ms_, gs):
    """Kernel 5 over a training state as it lies (params, f32 momentum,
    f32 pending update), where copies of the set would not fit on the
    card.  For sgd and then lars, one call over the whole set in place
    at lr 0.01 (the launches exactly ``launches_per_call``), held
    against the plain version run on the card a piece of at most
    UPDATE_PIECE elements at a time from host copies of w and m taken
    before the call (and put back before the next): w within one bf16
    ulp, m within UPDATE_M_RTOL, as ``_fused_update_check``; LARS's
    trust from the kernel's norms within ``fu.LARS_TRUST_RTOL`` of the
    plain trust, and the plain update given the kernel's trust.  Some
    weights must change, or the w comparison would hold whatever the
    kernel did.  Then the whole set timed in place (the kernel, the LARS
    set, the plain version) and the library yardstick
    ``torch.optim.SGD(fused=True)`` over the f32 momentum as its params
    (all-f32, as the other sets' yardstick)."""
    from repro_torch.kernels import fused_update as fu
    keys = [(w.dtype, m.dtype, g.dtype) for w, m, g in zip(ws, ms_, gs)]
    host_w = [w.cpu() for w in ws]
    host_m = [m.cpu() for m in ms_]
    lr = torch.full((), 0.01, device="cuda")
    lkw = dict(eta=1e-3, eps=1e-9, weight_decay=1e-4)
    worst = worst_t = 0.0
    moved = {}
    for mode in ("sgd", "lars"):
        if mode == "lars":              # the state the sgd call started from
            for w, m, hw, hm in zip(ws, ms_, host_w, host_m):
                w.copy_(hw)
                m.copy_(hm)
        before = fu.fused_sgd_update.launches
        trust = None
        if mode == "lars":
            trust = fu.lars_trust(ws, gs, **lkw)
            want = fu.lars_trust_plain(ws, gs, **lkw)
            worst_t = ((trust - want).abs() / want.abs()).max().item()
            if not worst_t <= fu.LARS_TRUST_RTOL:
                fail(f"lars_trust {label}: {worst_t:.3g} relative from the "
                     f"plain trust (bound {fu.LARS_TRUST_RTOL})")
        kw = dict(lr=lr, momentum=0.9, weight_decay=1e-4)
        fu.fused_sgd_update(ws, ms_, gs, trust=trust, **kw)
        launched = fu.fused_sgd_update.launches - before
        want_n = fu.launches_per_call(keys, lars=mode == "lars")
        if launched != want_n:
            fail(f"fused_sgd_update {label} {mode}: {launched} launches, "
                 f"want {want_n}")
        changed = 0
        for i, (w, m, g) in enumerate(zip(ws, ms_, gs)):
            fw, fm, fg = w.view(-1), m.view(-1), g.view(-1)
            hw, hm = host_w[i].view(-1), host_m[i].view(-1)
            t = None if trust is None else trust[i:i + 1]
            for lo in range(0, fw.numel(), UPDATE_PIECE):
                sl = slice(lo, lo + UPDATE_PIECE)
                w2, m2 = hw[sl].cuda(), hm[sl].cuda()
                changed += int((fw[sl] != w2).sum())
                fu.fused_sgd_update_plain([w2], [m2], [fg[sl]], trust=t,
                                          **kw)
                w_rtol = 2.0 ** -7 if w2.dtype == torch.bfloat16 else \
                    UPDATE_M_RTOL
                dw = (fw[sl].float() - w2.float()).abs()
                dm = (fm[sl] - m2).abs()
                if not (bool((dw <= w2.float().abs() * w_rtol).all())
                        and bool((dm <= m2.abs() * UPDATE_M_RTOL).all())):
                    fail(f"fused_sgd_update {label} {mode} leaf "
                         f"{tuple(w.shape)} piece {lo}: kernel and plain "
                         "version disagree")
                worst = max(worst, dw.max().item(), dm.max().item())
                del w2, m2, dw, dm
        moved[mode] = changed / sum(w.numel() for w in ws)
        if not moved[mode] > 0:
            fail(f"fused_sgd_update {label} {mode}: no weight changed, so "
                 "the comparison shows nothing")
    del host_w, host_m
    n = sum(w.numel() for w in ws)
    w_bytes = ws[0].element_size()
    kw = dict(lr=1e-6, momentum=0.9, weight_decay=1e-4)

    def lars_set():
        trust = fu.lars_trust(ws, gs, **lkw)
        fu.fused_sgd_update(ws, ms_, gs, trust=trust, **kw)

    ms = timer(lambda: fu.fused_sgd_update(ws, ms_, gs, **kw))
    lars_ms = timer(lars_set)
    plain_ms = timer(lambda: fu.fused_sgd_update_plain(ws, ms_, gs, **kw))
    for m, g in zip(ms_, gs):
        m.grad = g
    opt = torch.optim.SGD(ms_, lr=1e-6, momentum=0.9, weight_decay=1e-4,
                          fused=True)
    lib_ms = timer(opt.step)
    for m in ms_:
        m.grad = None
    del opt
    bnd, by = bound_ms(n * (2 * w_bytes + 4 + 4 + 4), 6 * n, F32_OPS_PER_S)
    print(f"[fused_sgd_update] {label} whole set (the training state, in "
          f"place): {len(ws)} leaves, {n / 1e9:.3f}B params ({ws[0].dtype} "
          f"w, f32 m and g), one call each of sgd and lars at lr 0.01 over "
          f"the whole set, held against the plain version in pieces of "
          f"{UPDATE_PIECE}: max |kernel - plain| {worst:.3g}, share of "
          f"weights the update changed sgd {moved['sgd']:.4f} lars "
          f"{moved['lars']:.4f}, lars trust max relative error "
          f"{worst_t:.3g}; kernel_ms={ms:.4f} lars_ms={lars_ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} ({by}; "
          f"{bnd / ms:.1%} of the bound) library_ms(torch.optim.SGD "
          f"fused, all-f32)={lib_ms:.4f} ({ms / lib_ms:.2f}x); card: "
          f"{nvidia_smi()}", flush=True)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms)


def phase_dbrx_train(torch, timer):
    """dbrx-132b at DBRX_TRAIN_LAYERS layers through ``phase_train_pjit``,
    then kernel 5 over its training state's leaves (``_fused_update_inplace``;
    the pending update refilled with N(0, 0.01) noise, which the trailing
    update had zeroed).  Returns (training results, kernel-5 row)."""
    from repro_torch.configs import get_config
    cfg = get_config(DBRX).replace(num_layers=DBRX_TRAIN_LAYERS)
    res, ts = phase_train_pjit(torch, cfg)
    st = ts.state
    ws, ms_ = list(_leaves(st["params"])), list(_leaves(st["opt"]["m"]))
    gs = list(_leaves(st["pending"]))
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for x in gs:
        x.normal_(0.0, 1e-2, generator=g)
    row = _fused_update_inplace(torch, timer, f"{DBRX} {DBRX_TRAIN_LAYERS}"
                                f" layer", ws, ms_, gs)
    del ts, st, ws, ms_, gs
    return res, row


_FSDP_RANK = r"""
import os, sys, json
import torch, torch.distributed as dist
rank, world, port, layers, steps = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], int(sys.argv[4]),
                                    int(sys.argv[5]))
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
torch.cuda.set_device(rank)
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
import chip_smoke as cs
diff, moved = cs.fsdp_against_launcher(torch, layers, steps,
                                       torch.device("cuda", rank))
if rank == 0:
    print("FSDP_NCCL", json.dumps({"diff": diff, "moved": moved}), flush=True)
dist.destroy_process_group()
"""


def fsdp_against_launcher(torch, layers, steps, device):
    """qwen2-1.5b at full width, ``layers`` deep, float32: ``steps`` LSGD
    steps and ``finalize`` through ``make_pjit_step`` (fsdp on, a data
    axis over the process group's ranks) and through the launcher's
    ``make_step``, from the seed's weights and the launcher's batches,
    with fused SGD and with LARS (whose norms the FSDP step sums over the
    shard group).  Returns (max |param diff|, how far the params moved),
    the worst over both optimizers."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import trainer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.sgd import OptimConfig
    from repro_torch.tree import leaves
    cfg = get_config(QWEN2).replace(num_layers=layers, param_dtype="float32",
                                    compute_dtype="float32")
    model = build_model(cfg)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh((world,), ("data",))
    batches = _synth_batches(torch, cfg, PJIT_BATCH, PJIT_SEQ, steps,
                             device)
    lr_fn = lambda t: 0.01
    p0 = model.init(SEED, device)
    diff = moved = 0.0
    for kind in ("sgd", "lars"):
        out = []
        for fsdp in (True, False):
            tcfg = trainer.TrainerConfig(sync_mode="lsgd", fsdp=fsdp,
                                         optim=OptimConfig(kind=kind))
            plan = trainer.FsdpPlan(model, tcfg, mesh) if fsdp else None
            state = trainer.make_init_state(model, tcfg, device, plan)(SEED)
            step = (trainer.make_pjit_step(model, tcfg, lr_fn, plan) if fsdp
                    else trainer.make_step(model, tcfg, lr_fn))
            for b in batches:
                state, _ = step(state, trainer.local_batch(b, mesh))
            state = trainer.make_finalize(model, tcfg, lr_fn, plan)(state)
            out.append(plan.gather(state["params"]) if fsdp
                       else state["params"])
            del state
        diff = max([diff] + [(a - b).abs().max().item()
                             for a, b in zip(leaves(out[0]), leaves(out[1]))])
        moved = max([moved] + [(a - b).abs().max().item()
                               for a, b in zip(leaves(out[1]), leaves(p0))])
    return diff, moved


@float32_exact()
def phase_fsdp_parity(torch):
    """The FSDP step equals the launcher's step on the card
    (``fsdp_against_launcher`` at FSDP_LAYERS layers, FSDP_STEPS steps)
    within FSDP_BOUND, the params having moved; on one rank its
    collectives are the identity.  On a machine with two cards or more,
    the same over two NCCL ranks (one process a card); with one card the
    multi-rank collectives ran only under gloo on the CPU (NCCL refuses
    two ranks on one card)."""
    diff, moved = fsdp_against_launcher(torch, FSDP_LAYERS, FSDP_STEPS,
                                        torch.device("cuda", 0))
    print(f"[fsdp] {QWEN2} {FSDP_LAYERS} layers f32, {FSDP_STEPS} lsgd steps "
          f"of {PJIT_BATCH} x {PJIT_SEQ} + finalize, sgd and lars, one rank: "
          f"make_pjit_step"
          f"(fsdp) vs the launcher's make_step max |param diff| {diff:.3g} "
          f"(bound {FSDP_BOUND}); params moved {moved:.3g}", flush=True)
    if not (diff < FSDP_BOUND and moved > 0):
        fail(f"FSDP step and launcher step differ by {diff} (bound "
             f"{FSDP_BOUND})")
    if torch.cuda.device_count() < 2:
        print("[fsdp] one card: the FSDP step's all-gather, reduce-scatter "
              "and expert all-to-all over several ranks ran only under gloo "
              "on the CPU (tests/test_torch_fsdp.py, "
              "tests/test_torch_moe_ep.py)", flush=True)
        return diff
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = str(sk.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FSDP_RANK, str(r), "2", port,
         str(FSDP_LAYERS), str(FSDP_STEPS)], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    line = next((x for x in outs[0].splitlines()
                 if x.startswith("FSDP_NCCL ")), None)
    if any(p.returncode for p in procs) or line is None:
        fail(f"two NCCL ranks of the FSDP check failed: {outs[0][-3000:]} "
             f"{outs[1][-3000:]}")
    got = json.loads(line.split(" ", 1)[1])
    print(f"[fsdp] two NCCL ranks (cuda:0, cuda:1), data 2, sgd and lars: "
          f"make_pjit_step"
          f"(fsdp) vs make_step max |param diff| {got['diff']:.3g} (bound "
          f"{FSDP_BOUND}); params moved {got['moved']:.3g}", flush=True)
    if not (got["diff"] < FSDP_BOUND and got["moved"] > 0):
        fail(f"two NCCL ranks: FSDP step and launcher step differ by "
             f"{got['diff']}")
    return max(diff, got["diff"])


@contextlib.contextmanager
def launcher_f32():
    """The launcher's configs in float32 (params and compute) while the
    block runs: the launcher has no dtype flag."""
    from repro_torch.launch import train
    orig = train.model_config
    train.model_config = lambda args: orig(args).replace(
        param_dtype="float32", compute_dtype="float32")
    try:
        yield
    finally:
        train.model_config = orig


def tp_parity_cases():
    """(name, launcher argv) of the tensor-parallel parity runs."""
    return [(f"{arch}_{kind}", ["--arch", arch, "--optimizer", kind]
             + TP_PARITY_ARGV) for arch in (QWEN2, MAMBA)
            for kind in ("sgd", "lars")]


def tp_train_rank(torch, mesh, out_dir, bf16=True):
    """One rank of the tensor-parallel training check (``_TP_RANK``):
    the parity cases through the launcher at ``--mesh mesh`` in float32
    with TF32 off, the first data-parallel replica of each model shard
    saving its part of the final params under ``out_dir`` (the parent
    compares them with the one-rank run); then, with ``bf16``,
    TRAIN_ARGV at ``--mesh mesh``, every launch count set to 0 just
    before and read just after.  Returns this rank's numbers."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch import train
    from repro_torch.tree import items
    res = {"rank": dist.get_rank()}
    with float32_exact(), launcher_f32():
        for name, argv in tp_parity_cases():
            out = train.main(argv + ["--mesh", mesh])
            plan = out["plan"]
            if plan.mesh.index(("pod", "data")) == 0:
                torch.save({"/".join(p): t.cpu() for p, t in
                            items(out["state"]["params"])},
                           Path(out_dir) / f"{name}_m{plan.tp.index}.pt")
            res[name] = out["losses"]
            del out
            gc.collect()
            torch.cuda.empty_cache()
    if bf16:
        kernels.reset_launch_counts()
        out = train.main(TRAIN_ARGV + ["--mesh", mesh])
        torch.cuda.synchronize()
        res.update(losses=out["losses"], step_s=out["step_s"],
                   peak_gb=out["peak_mem_bytes"] / 1e9,
                   launches=kernels.launch_counts()["fused_sgd_update"],
                   per_update=_update_launches(out["state"]),
                   params=out["params"], tokens=out["tokens_per_step"],
                   model_index=out["plan"].tp.index)
        del out
    return res


_TP_RANK = r"""
import os, sys, json
import torch, torch.distributed as dist
rank, world, port, backend, mesh, out_dir, bf16 = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], sys.argv[6], sys.argv[7] == "1")
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
torch.cuda.set_device(rank if backend == "nccl" else 0)
dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
import chip_smoke as cs
out = cs.tp_train_rank(torch, mesh, out_dir, bf16)
print("TP_RANK", json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def run_tp_ranks(world, backend, mesh, out_dir, bf16):
    """``tp_train_rank`` as ``world`` processes over ``backend`` (gloo:
    every rank on cuda:0; nccl: rank r on cuda:r), the parity runs at
    ``--mesh mesh``; returns each rank's numbers, in rank order."""
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = str(sk.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TP_RANK, str(r), str(world), port, backend,
         mesh, str(out_dir), "1" if bf16 else "0"], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = []
    for p, out in zip(procs, outs):
        line = next((x for x in out.splitlines()
                     if x.startswith("TP_RANK ")), None)
        if p.returncode or line is None:
            fail(f"tensor-parallel training rank over {backend} failed: "
                 f"{out[-4000:]}")
        got.append(json.loads(line.split(" ", 1)[1]))
    return got


def tp_parity(torch, out_dir, tp, ranks):
    """The one-rank launcher's parity runs (float32, TF32 off: call
    under ``float32_exact``) against the model parts the ranks saved
    under ``out_dir`` (``tp`` model shards) and their losses: (max
    |param diff|, max |loss diff|, how far the params moved)."""
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.sharding import take_part, train_placement
    from repro_torch.tree import items
    diff = loss_diff = moved = 0.0
    with launcher_f32():
        for name, argv in tp_parity_cases():
            out = train.main(argv)
            args = train.parse_args(argv)
            cfg = train.model_config(args)
            dev = next(iter(items(out["state"]["params"])))[1].device
            init = dict(items(build_model(cfg).init(SEED, dev)))
            for r in ranks:
                loss_diff = max([loss_diff] + [
                    abs(a - b) for a, b in zip(out["losses"], r[name])])
            for m in range(tp):
                part = torch.load(Path(out_dir) / f"{name}_m{m}.pt")
                for path, want in items(out["state"]["params"]):
                    place = train_placement(cfg, "/".join(path), tp)
                    got = part["/".join(path)].to(dev)
                    diff = max(diff, (got - take_part(want, place, m, tp))
                               .abs().max().item())
                    moved = max(moved, (want - init[path]).abs().max()
                                .item())
            del out, init
            gc.collect()
            torch.cuda.empty_cache()
    return diff, loss_diff, moved


@float32_exact()
def phase_tp_train(torch, timer):
    """Tensor-parallel training on the card (model TP_TRAIN, data 1):
    two ranks, each on cuda:0 over gloo (NCCL refuses two ranks on one
    card) or over NCCL on cuda:0 and cuda:1 where the machine has two.
    The parity runs (``tp_parity_cases``: qwen2-1.5b and mamba2-370m at
    full width cut to TP_PARITY_LAYERS, float32, sgd and LARS) equal the
    one-rank launcher within TP_BOUND, the params having moved; then
    qwen2-1.5b uncut in bf16 (TRAIN_ARGV at ``--mesh 1,1,2``): finite
    losses, and on each rank kernel 5 launched exactly its
    ``launches_per_call`` for each of the 7 deferred updates and
    ``finalize``; then kernel 5 over model rank 0's shard of
    qwen2-1.5b's leaves against its plain version, timed
    (``_fused_update_layout``).  Returns (the bf16 run's numbers with
    its kernel-5 launches summed over the ranks, kernel 5's row)."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.sharding import take_part, train_placement
    from repro_torch.tree import items
    two = torch.cuda.device_count() >= 2
    backend = "nccl" if two else "gloo"
    transport = ("NCCL, rank r on cuda:r" if two else
                 "gloo, both ranks on cuda:0 (NCCL refuses two ranks on "
                 "one card)")
    out_dir = ROOT / "build" / "tp_train"
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh = f"1,1,{TP_TRAIN}"
    t0 = time.perf_counter()
    ranks = run_tp_ranks(TP_TRAIN, backend, mesh, out_dir, True)
    ranks_s = time.perf_counter() - t0
    diff, loss_diff, moved = tp_parity(torch, out_dir, TP_TRAIN, ranks)
    print(f"[tp train] model {TP_TRAIN} over {transport}: {QWEN2} and "
          f"{MAMBA} at {TP_PARITY_LAYERS} layers f32, "
          f"{TP_PARITY_ARGV[1]} lsgd steps of {TP_PARITY_ARGV[3]} x "
          f"{TP_PARITY_ARGV[5]} + finalize, sgd and lars, --mesh {mesh} vs "
          f"one rank: max |param diff| {diff:.3g}, max |loss diff| "
          f"{loss_diff:.3g} (bound {TP_BOUND}); params moved {moved:.3g}",
          flush=True)
    if not (diff < TP_BOUND and loss_diff < TP_BOUND and moved > 0):
        fail(f"tensor-parallel training differs from one rank by {diff} "
             f"(losses {loss_diff}; bound {TP_BOUND})")
    for r in ranks:
        if not all(math.isfinite(x) for x in r["losses"]):
            fail(f"tensor-parallel training rank {r['rank']}: loss not "
                 f"finite: {r['losses']}")
        want = r["per_update"] * len(r["losses"])
        if r["launches"] != want:
            fail(f"tensor-parallel training rank {r['rank']}: "
                 f"{r['launches']} fused_sgd_update launches, want "
                 f"{r['per_update']} an update x {len(r['losses'])}")
    med = [statistics.median(r["step_s"][-6:]) for r in ranks]
    r0 = ranks[0]
    res = dict(loss_first=r0["losses"][0], loss_last=r0["losses"][-1],
               step_ms=med[0] * 1e3, tokens_per_s=r0["tokens"] / med[0],
               peak_gb=max(r["peak_gb"] for r in ranks),
               launches=sum(r["launches"] for r in ranks))
    print(f"[tp train] {QWEN2} full width, {r0['params'] / 1e9:.3f}B "
          f"params bf16, model {TP_TRAIN} over {transport}, batch "
          f"{TRAIN_ARGV[5]} x {TRAIN_ARGV[7]}, lsgd, fused sgd, lr 0.01: "
          f"losses {[round(x, 4) for x in r0['losses']]}; step ms (median "
          f"of the last 6) by rank {[round(m * 1e3, 1) for m in med]}; "
          f"train tok/s {res['tokens_per_s']:.0f}; peak memory by rank "
          f"{[round(r['peak_gb'], 2) for r in ranks]} GB; kernel 5 "
          f"launches by rank {[r['launches'] for r in ranks]} "
          f"({r0['per_update']} an update); step ms all (rank 0) "
          f"{[round(x * 1e3, 1) for x in r0['step_s']]}; ranks' process "
          f"{ranks_s:.1f}s; card: {nvidia_smi()}", flush=True)
    cfg = get_config(QWEN2)
    params = build_model(cfg).init(SEED, "cuda")
    ws = [take_part(leaf, train_placement(cfg, "/".join(path), TP_TRAIN), 0,
                    TP_TRAIN).contiguous() for path, leaf in items(params)]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    row = _fused_update_layout(torch, timer, f"{QWEN2} model-{TP_TRAIN} "
                               f"rank 0 shard", ws)
    del ws
    return res, row


def phase_resnet_train(torch):
    """ResNet-50, the paper's model, through ``repro_torch.launch.train``
    with RESNET_ARGV (full width, 224 x 224, batch 64, f32, LSGD, fused
    SGD, the paper's lr 0.1), every launch count set to 0 just before and
    read just after, under the TF32 flags the launcher meets when it runs
    alone.  Every loss must be finite and kernel 5 must have launched
    its launches a call (one: every leaf is f32) for each of the 7
    deferred updates and ``finalize``, whatever the leaf count."""
    import statistics

    from repro_torch import kernels
    from repro_torch.launch import train
    tf32 = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)
    kernels.reset_launch_counts()
    out = train.main(RESNET_ARGV)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    losses, step_s = out["losses"], out["step_s"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"resnet50 training loss not finite: {losses}")
    n_leaves = len(list(_leaves(out["state"]["params"])))
    per_step = _update_launches(out["state"])
    want = per_step * len(losses)
    if (n_leaves != RESNET_LEAVES or per_step != 1
            or counts["fused_sgd_update"] != want):
        fail(f"resnet50: {counts['fused_sgd_update']} fused_sgd_update "
             f"launches over {n_leaves} leaves, want {per_step} (of 1) x "
             f"{len(losses)} over {RESNET_LEAVES}")
    med = statistics.median(step_s[-6:])
    res = dict(loss_first=losses[0], loss_last=losses[-1], step_ms=med * 1e3,
               images_per_s=out["samples_per_step"] / med,
               peak_gb=out["peak_mem_bytes"] / 1e9, launches=counts)
    # the layout copies a step makes beside cuDNN's work: each HWIO conv
    # weight to the channels-last OIHW the convolution takes, and its
    # gradient back to HWIO (``core/autodiff``)
    ws = [w for w in _leaves(out["state"]["params"]) if w.dim() == 4]
    cls = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
           for w in ws]

    def copies():
        for w, c in zip(ws, cls):
            w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            torch.empty_like(w).copy_(c.permute(2, 3, 1, 0))

    copy_ms = Timer(torch, iters=10)(copies)
    copy_mb = 4 * sum(w.numel() * w.element_size() for w in ws) / 1e6
    print(f"[resnet_train] layout copies of {len(ws)} conv weights and "
          f"their gradients: {copy_mb:.1f} MB moved, {copy_ms:.4f} ms a "
          f"step", flush=True)
    res["layout_copy_ms"] = copy_ms
    del ws, cls
    print(f"[resnet_train] resnet50 full width, {out['params']:,} params "
          f"f32, 224 x 224, batch {out['samples_per_step']}, lsgd, fused "
          f"sgd, TF32 {json.dumps(tf32)}: losses "
          f"{[round(x, 4) for x in losses]}; step ms (median of the last 6) "
          f"{res['step_ms']:.1f}; images/s {res['images_per_s']:.1f}; peak "
          f"memory {res['peak_gb']:.2f} GB; step ms all "
          f"{[round(x * 1e3, 1) for x in step_s]}; fused_sgd_update "
          f"launches {counts['fused_sgd_update']} = {per_step} x "
          f"{len(losses)} over {n_leaves} leaves", flush=True)
    del out
    return res


def phase_resnet_equivalence(torch):
    """The ResNet half of the port's Fig. 7 on the card
    (``repro_torch.launch.fig7_equivalence``): the reduced ResNet at 224
    x 224, 12 steps of serial SGD, CSGD (8 workers) and LSGD (groups of
    4), TF32 off and cuDNN deterministic.  Fails unless the CSGD and
    LSGD curves and parameters agree within 1e-3."""
    from repro_torch.launch import fig7_equivalence as fig7
    with fig7.exact_float32():
        name, gap, curve_gap = fig7.check(
            "resnet", fig7.resnet_run("cuda"),
            lambda line: print(f"[resnet_equivalence] {line}", flush=True))
    print(f"[resnet_equivalence] csgd vs lsgd: parameter gap {gap:.3g}, "
          f"curve gap {curve_gap:.3g} (bound {fig7.BOUND})", flush=True)
    return gap, curve_gap


# ---------------------------------------------------------------------------
# the static-batch path: flash attention, contiguous-cache decode, serving
# ---------------------------------------------------------------------------


def static_batches(work):
    """run_static's batches of ``work``: (padded prompts (B, pmax) int32,
    the requests' indices, pmax, gmax) for each STATIC_BATCH requests."""
    out = []
    for i in range(0, len(work), STATIC_BATCH):
        batch = work[i:i + STATIC_BATCH]
        pmax = -(-max(len(p) for p, _ in batch) // STATIC_PAD) * STATIC_PAD
        gmax = max(n for _, n in batch)
        toks = np.zeros((len(batch), pmax), np.int32)
        for j, (p, _) in enumerate(batch):
            toks[j, :len(p)] = p
        out.append((toks, list(range(i, i + len(batch))), pmax, gmax))
    return out


def _visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask keeps: the work of one (row, head)."""
    i = np.arange(sq)[:, None]
    j = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    return int(keep.sum())


def phase_flash_attention(torch, timer, cfg, work):
    """Kernel 6 at the static prefill's shapes for ``cfg`` (B = 8 rows,
    its heads, kv heads and head dim, causal under its attention window,
    Sq = Sk = each static batch's padded prompt, after the image prefix
    for a vlm) in bfloat16 and float32, plus a 512-token window-128
    case, a window case whose rows
    past Sk + window - 1 see no key (bf16 and f32: they must get the
    plain version's mean of v), a non-causal Sq 64 / Sk 320 case and an
    hd-64 case (not for a vlm, whose prefix alone is new: its G = 7 at
    up to 3,392 positions), with a window a ``long_prefill``-token
    prefill past it (B = 2, both dtypes), and for an encoder-decoder its
    encoder's self
    attention (B = 8, Sq = Sk = the stub frames, not causal, both
    dtypes), each held to the plain version within ``compare_attn``'s
    bound for its dtype; each prints the share of the bf16 tensor-core
    rate and of the byte bound its time reaches.
    Library yardstick: scaled_dot_product_attention (is_causal,
    enable_gqa; a boolean mask for the windows)."""
    from repro_torch.kernels import flash_attention as fa
    H, KV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = attn_window(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    se = cfg.encoder_seq_len
    cases = [(f"encoder S={se} {str(dt)[6:]}", STATIC_BATCH, se, se, H, KV,
              HD, False, 0, dt) for dt in (torch.bfloat16, torch.float32)
             if cfg.is_encoder_decoder]
    for _, _, pmax, _ in static_batches(work):
        s = cfg.num_image_tokens + pmax
        for dt in (torch.bfloat16, torch.float32):
            cases.append((f"prefill S={s} {str(dt)[6:]}", STATIC_BATCH,
                          s, s, H, KV, HD, True, W, dt))
    if not cfg.num_image_tokens:
        cases += [("window S=512 w=128", STATIC_BATCH, 512, 512, H, KV, HD,
                   True, 128, torch.bfloat16)]
        cases += [(f"no-key Sq=512 Sk=384 w=64 {str(dt)[6:]}",
                   STATIC_BATCH, 512, 384, H, KV, HD, True, 64, dt)
                  for dt in (torch.bfloat16, torch.float32)]
        cases += [("cross Sq=64 Sk=320", STATIC_BATCH, 64, 320, H, KV, HD,
                   False, 0, torch.bfloat16),
                  ("hd64 S=512", STATIC_BATCH, 512, 512, H, KV, 64, True, 0,
                   torch.bfloat16)]
    if W:
        n = long_prefill(cfg)
        cases += [(f"long prefill S={n} {str(dt)[6:]}", 2, n, n, H, KV, HD,
                   True, W, dt) for dt in (torch.bfloat16, torch.float32)]
    results = []
    for label, b, sq, sk, h, kv, hd, causal, window, dt in cases:
        q = torch.randn((b, sq, h, hd), generator=g, device="cuda").to(dt)
        k = torch.randn((b, sk, kv, hd), generator=g, device="cuda").to(dt)
        v = torch.randn((b, sk, kv, hd), generator=g, device="cuda").to(dt)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def plain():
            return fa.flash_attention_bhsd_plain(qt, kt, vt, causal=causal,
                                                 window=window)

        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        err, ratio, lim = compare_attn(got, plain().transpose(1, 2))
        if not (math.isfinite(err) and ratio <= 1.0):
            fail(f"flash_attention {cfg.name} {label}: max |kernel - "
                 f"plain| = {err}, {ratio:.3g}x the bound {lim}")
        esize = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize
        ops = 4 * b * h * hd * _visible_pairs(sq, sk, causal, window)
        bnd, by = bound_ms(nbytes, ops, BF16_OPS_PER_S
                           if dt == torch.bfloat16 else F32_OPS_PER_S)
        ms = timer(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=window))
        plain_ms = timer(plain)
        mask = None
        binds = window and window < sq      # some query's window cuts keys
        if binds:
            i = torch.arange(sq, device="cuda")[:, None]
            j = torch.arange(sk, device="cuda")[None, :]
            mask = (j <= i) & (j > i - window)
        lib_ms = timer(sdpa(torch, qt, kt, vt, mask,
                            is_causal=causal and not binds))
        results.append(dict(label=label, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                            library_ms=lib_ms))
        # shares of the card's peaks this time reaches
        tc_share = ops / (ms * 1e-3) / BF16_OPS_PER_S
        byte_share = nbytes / HBM_BYTES_PER_S * 1e3 / ms
        print(f"[flash_attention] {label} B={b} Sq={sq} Sk={sk} H={h} "
              f"KV={kv} hd={hd} causal={causal} window={window} "
              f"err={err:.3g} (x{ratio:.3f} of bound) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} ({by}) "
              f"library_ms(sdpa)={lib_ms:.4f} sdpa_ratio="
              f"{ms / lib_ms:.3f} bf16_tc_rate_share="
              f"{tc_share:.4f} byte_bound_share={byte_share:.4f}",
              flush=True)
        del q, k, v, qt, kt, vt, got
    return results


def phase_flash_decode_bhd(torch, timer, cfg, work, cache_len=0):
    """Kernel 7 at the static decode's shape for ``cfg`` (B = 8, its
    heads, kv heads and head dim, S = each static batch's cache_len
    (the image prefix's positions included for a vlm), or
    ``cache_len`` where the path fixes one, cut to the attention window
    where one binds: the cache is then a ring)
    with ``length`` 1, S // 2 and S, in bfloat16 (tensor cores) and
    float32 (CUDA cores), plus a case per template that runs unsplit
    (160 / KV rows; 8 rows over 128 slots), and with a window a full
    ring of that many slots at length 1, half, full and wrapped (past
    the ring, every slot live): the phase fails unless each template
    compares both the split-K merge and the direct epilogue.  Slots at
    and past ``length`` hold large garbage, so a read past the mask
    shows.  Library yardstick: scaled_dot_product_attention under a
    boolean mask."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels._common import sm_count
    H, KV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = attn_window(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    b = STATIC_BATCH
    cases = []
    sizes = dict.fromkeys(cache_len or cfg.num_image_tokens + pmax + gmax
                          for _, _, pmax, gmax in static_batches(work))
    for s in sizes:
        s = min(s, W) if W else s
        for dt in (torch.bfloat16, torch.float32):
            for length in (1, s // 2, s):
                cases.append((f"S={s} length={length} {str(dt)[6:]}", b, s,
                              length, dt))
    wide = -(-160 // KV)      # rows x kv heads past the card's 132 SMs
    cases += [(f"extra B={wide} S=256 length=200 bfloat16", wide, 256, 200,
               torch.bfloat16),
              ("extra S=128 length=100 float32", b, 128, 100,
               torch.float32)]
    if W:
        cases += [(f"ring S={W} length={length} {str(dt)[6:]}", b, W, length,
                   dt) for dt in (torch.bfloat16, torch.float32)
                  for length in (1, W // 2, W, W + 52)]
    results = []
    for label, b, s, length, dt in cases:
        q = torch.randn((b, H, HD), generator=g, device="cuda").to(dt)
        k = torch.randn((b, s, KV, HD), generator=g, device="cuda").to(dt)
        v = torch.randn((b, s, KV, HD), generator=g, device="cuda").to(dt)
        past = (torch.arange(s, device="cuda") >= length)[None, :, None,
                                                          None]
        k.masked_fill_(past, 60.0)
        v.masked_fill_(past, -60.0)
        ln = torch.tensor(length, dtype=torch.int32, device="cuda")
        tiles, nsplit = fd.launch_splits(b, 1, H, KV, s, dtype=dt,
                                         sms=sm_count(0), hd=HD)
        got = fd.flash_decode(q, k, v, ln)
        err, ratio, lim = compare_attn(
            got, fd.flash_decode_bhd_plain(q, k, v, ln))
        if not (math.isfinite(err) and ratio <= 1.0):
            fail(f"flash_decode {cfg.name} {label}: max |kernel - plain| = "
                 f"{err}, {ratio:.3g}x the bound {lim}")
        esize = q.element_size()
        seen = min(length, s)                # a wrapped ring: every slot
        nbytes = (2 * b * seen * KV * HD + 2 * q.numel()) * esize + 4
        ops = 4 * b * H * HD * seen
        bnd, by = bound_ms(nbytes, ops, BF16_OPS_PER_S
                           if dt == torch.bfloat16 else F32_OPS_PER_S)
        ms = timer(lambda: fd.flash_decode(q, k, v, ln))
        plain_ms = timer(lambda: fd.flash_decode_bhd_plain(q, k, v, ln))
        mask = (torch.arange(s, device="cuda") < length)[None, None, None]
        lib_ms = timer(sdpa(torch, q[:, :, None],
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), mask))
        results.append(dict(label=label, dtype=dt, nsplit=nsplit,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd, bound_by=by, library_ms=lib_ms))
        share = (f" bf16_tc_rate_share="
                 f"{ops / (ms * 1e-3) / BF16_OPS_PER_S:.4f}"
                 if dt == torch.bfloat16 else "")
        print(f"[flash_decode] {label} B={b} H={H} KV={KV} hd={HD} "
              f"tiles={tiles} nsplit={nsplit} err={err:.3g} "
              f"(x{ratio:.3f} of bound) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} ({by}) "
              f"library_ms(sdpa)={lib_ms:.4f} sdpa_ratio="
              f"{ms / lib_ms:.3f}{share} "
              f"bound_share={bnd / ms:.4f}", flush=True)
        del q, k, v, got
    for dt in (torch.bfloat16, torch.float32):
        if {r["nsplit"] > 1 for r in results if r["dtype"] == dt} != {
                False, True}:
            fail(f"flash_decode {cfg.name}: the {dt} cases did not reach "
                 "both the split and the unsplit epilogue")
    return results


def _static_once(torch, model, params, batches, cache_len=0, audio=None,
                 image=None):
    """One static-batch run through the non-paged entry point (as
    run_static): per batch ``prefill`` with cache_len = pmax + gmax (or
    ``cache_len``; an encoder-decoder's prefill also reads the rows of
    ``audio``, the requests' stub frames; a vlm's takes the rows of
    ``image``, the requests' image prefixes, before the prompt, and its
    positions and cache_len count the prefix), the first token greedy
    from the last prompt position, then gmax - 1
    ``decode_step`` calls at positions pmax, pmax + 1, ... (a device
    tensor: no host read inside the loop), every token through
    ``greedy_sample``.  Every launch count is set to 0 just before and
    read just after.  Returns (streams {request: tokens}, counts, wall
    s, prefill ms per batch, decode ms per step)."""
    from repro_torch import kernels
    from repro_torch.kernels.sampling import greedy_sample
    streams, prefill_ms, decode_ms = {}, [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for toks, rows, pmax, gmax in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        inputs = torch.from_numpy(toks).cuda()
        if audio is not None:
            inputs = {"audio_embeds": audio[rows], "tokens": inputs}
        kw, prefix = {}, 0
        if image is not None:
            kw, prefix = dict(image_embeds=image[rows]), image.shape[1]
        logits, cache = model.prefill(
            params, inputs, cache_len=cache_len or prefix + pmax + gmax, **kw)
        tok = greedy_sample(logits[:, -1].float().contiguous())
        ev[1].record()
        out = [tok]
        pos = torch.tensor(prefix + pmax, dtype=torch.int32, device="cuda")
        for i in range(gmax - 1):
            lg, cache = model.decode_step(params, cache, tok[:, None],
                                          pos + i)
            tok = greedy_sample(lg.float())
            out.append(tok)
        ev[2].record()
        toks_out = torch.stack(out, 1).cpu().numpy()
        prefill_ms.append(ev[0].elapsed_time(ev[1]))
        decode_ms.append(ev[1].elapsed_time(ev[2]) / max(gmax - 1, 1))
        for j, r in enumerate(rows):
            streams[r] = toks_out[j].tolist()
        del logits, cache, lg
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return streams, kernels.launch_counts(), wall, prefill_ms, decode_ms


def phase_serve_static(torch, cfg, f32_equal=False, params=None):
    """The static-batch main path: full-width ``cfg`` (qwen2-1.5b,
    recurrentgemma-2b, whisper-tiny, h2o-danube-3-4b, or llava-next-34b
    at its DEPTH_CUTS depth) under attn_impl="pallas" (bf16, random
    weights from SEED, or ``params``), 16 requests in two static batches
    of 8 (the serving phase's; for an encoder-decoder prompts of
    WHISPER_PROMPT_LENS tokens, each request over its own stub frames
    from SEED, with a WHISPER_CACHE-slot self cache; for a vlm each
    request behind its own ``num_image_tokens``-token stub image prefix
    drawn N(0, 1) from SEED), run
    twice (the streams must repeat), with exact launch
    counts — flash_attention once per attention layer (encoder layers
    included, not causal) and batch, flash_decode once per decoder
    attention layer and decode step, greedy_sample once per step,
    nothing else — so no plain version ran on the card; then every
    emitted token against a teacher-forced f32 forward of the plain
    (naive) model over the padded prompt and the emitted stream (a vlm's
    through ``_image_witness``).  With
    ``f32_equal`` the same batches run once more in float32 (TF32 off)
    under "pallas" (the kernels' f32 templates) and under "naive" (the
    plain attention, no kernel), whose greedy tokens must be equal.  An
    encoder-decoder's cross attention is plain PyTorch on every path, as
    in the reference."""
    from repro_torch import kernels
    from repro_torch.models.model import build_model
    from repro_torch.serve.profile_engine import PROMPT_LENS, workload
    pcfg = cfg.replace(attn_impl="pallas")
    model = build_model(pcfg)
    if params is None:
        params = model.init(SEED, "cuda")
    encdec = cfg.is_encoder_decoder
    work = workload(pcfg.vocab_size, SEED,
                    WHISPER_PROMPT_LENS if encdec else PROMPT_LENS)
    cache_len, audio32 = 0, None
    if encdec:
        cache_len = WHISPER_CACHE
        g = torch.Generator(device="cuda").manual_seed(SEED + 20)
        audio32 = torch.randn((len(work), cfg.encoder_seq_len, cfg.d_model),
                              generator=g, device="cuda")
    audio = audio32.to(pcfg.cdtype) if encdec else None
    image = None
    if cfg.num_image_tokens:
        g = torch.Generator(device="cuda").manual_seed(SEED + 22)
        image = torch.randn((len(work), cfg.num_image_tokens, cfg.d_model),
                            generator=g, device="cuda").to(pcfg.cdtype)
    batches = static_batches(work)
    L = sum(n for kind, _, n in _runs(pcfg)
            if kind in ("attn", "local_attn"))
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    want.update(flash_attention=(L + cfg.encoder_layers) * len(batches),
                flash_decode=L * sum(g - 1 for *_, g in batches),
                greedy_sample=sum(g for *_, g in batches))
    useful = sum(n for _, n in work)
    runs = []
    for rep in range(2):
        streams, counts, wall, pre_ms, dec_ms = _static_once(
            torch, model, params, batches, cache_len, audio, image)
        if counts != want:
            fail(f"static run {rep}: launches {counts}, want {want}")
        runs.append(streams)
        print(f"[serve_static] run={rep} {pcfg.name} pallas batches="
              f"{[(p, g) for _, _, p, g in batches]} (pmax, gmax) "
              f"image_tokens={cfg.num_image_tokens} "
              f"cache_len={cache_len or 'image + pmax + gmax'} "
              f"requests={len(work)} useful_tokens={useful} wall_s="
              f"{wall:.3f} tok_s={useful / wall:.1f} prefill_ms per batch "
              f"{[round(x, 2) for x in pre_ms]} decode_ms per step "
              f"{[round(x, 3) for x in dec_ms]} launches="
              f"{json.dumps(counts)}", flush=True)
    if runs[0] != runs[1]:
        fail("static serving: a repeat gave other streams")
    padded = [(toks[j], gmax) for toks, rows, _, gmax in batches
              for j in range(len(rows))]
    if encdec:
        _teacher_forced_encdec(torch, pcfg, params, audio, padded, runs[0])
    elif image is not None:
        _image_witness(torch, cfg, params, batches, image, want, padded,
                       runs[0])
    else:
        _teacher_forced_check(torch,
                              build_model(cfg.replace(attn_impl="naive")),
                              params, padded, [runs[0]], [])
    if f32_equal:
        p32 = _cast(params, torch.float32)
        del params
        out = {}
        with float32_exact():
            for impl in ("pallas", "naive"):
                m32 = build_model(cfg.replace(attn_impl=impl,
                                              param_dtype="float32",
                                              compute_dtype="float32"))
                streams, got, wall, pre_ms, dec_ms = _static_once(
                    torch, m32, p32, batches, cache_len, audio32,
                    None if image is None else image.float())
                if got != (want if impl == "pallas" else
                           dict(want, flash_attention=0, flash_decode=0)):
                    fail(f"static f32 {impl}: launches {got}")
                out[impl] = streams
                print(f"[serve_static] {pcfg.name} float32 {impl} wall_s="
                      f"{wall:.3f} prefill_ms per batch "
                      f"{[round(x, 2) for x in pre_ms]} decode_ms per step "
                      f"{[round(x, 3) for x in dec_ms]}", flush=True)
        same = out["pallas"] == out["naive"]
        print(f"[serve_static] {pcfg.name} float32: pallas (kernels 6, 7) "
              f"== naive (plain attention) greedy tokens: {same}",
              flush=True)
        if not same:
            fail(f"{pcfg.name} static f32: the kernels' tokens differ from "
                 "the plain attention's")
        del p32
    else:
        del params
    return counts

def _image_witness(torch, cfg, params, batches, image, want, padded,
                   served):
    """A vlm's static path against bf16 itself: the same ``batches``
    behind the same image prefixes, served in bf16 through the plain
    attention (attn_impl "naive", no kernel 6 or 7; WITNESS_ROWS rows of
    a batch at a time, each row's pmax and gmax kept), with exact launch
    counts; then the kernels' streams (``served``) and the witness's
    through the teacher-forced f32 check.  Both are held to
    TF_LOGIT_TOL.  The kernels' share of tokens equal to the f32 argmax
    is held to TF_ARGMAX_FLOOR where the witness reaches it, and
    otherwise to no less than WITNESS_SIGMAS standard errors of the two
    shares' difference below the witness's share: the floor then
    separates what bf16 does to near-ties from what a kernel does."""
    from repro_torch.models.model import build_model
    plain = build_model(cfg.replace(attn_impl="naive"))
    parts = [(toks[i:i + WITNESS_ROWS], rows[i:i + WITNESS_ROWS], pmax, gmax)
             for toks, rows, pmax, gmax in batches
             for i in range(0, len(rows), WITNESS_ROWS)]
    streams, counts, wall, pre_ms, dec_ms = _static_once(
        torch, plain, params, parts, image=image)
    plain_want = dict(want, flash_attention=0, flash_decode=0,
                      greedy_sample=sum(g for *_, g in parts))
    if counts != plain_want:
        fail(f"{cfg.name} static witness: launches {counts}, want "
             f"{plain_want}")
    same = sum(streams[i] == served[i] for i in streams)
    print(f"[serve_static] {cfg.name} witness: bfloat16 naive (plain "
          f"attention) in parts of {WITNESS_ROWS} rows wall_s={wall:.3f} "
          f"prefill_ms per part {[round(x, 2) for x in pre_ms]} decode_ms "
          f"per step {[round(x, 3) for x in dec_ms]}; {same} of "
          f"{len(streams)} streams equal to the kernels'", flush=True)
    shares = {}
    for label, out in (("kernels", served), ("witness", streams)):
        print(f"[serve_static] {cfg.name} {label}:", flush=True)
        agree, total = _teacher_forced_check(torch, plain, params, padded,
                                             [out], [], argmax_floor=None,
                                             images=image)
        shares[label] = (agree / total, total)
    (k, nk), (w, nw) = shares["kernels"], shares["witness"]
    sigma = math.sqrt(k * (1 - k) / nk + w * (1 - w) / nw)
    floor = (TF_ARGMAX_FLOOR if w >= TF_ARGMAX_FLOOR
             else w - WITNESS_SIGMAS * sigma)
    print(f"[serve_static] {cfg.name}: share of bf16 tokens equal to the "
          f"f32 argmax, kernels {k:.4f} ({nk} tokens), plain attention "
          f"{w:.4f} ({nw}); standard error of the difference {sigma:.4f}; "
          f"the kernels' floor {floor:.4f} ("
          + ("TF_ARGMAX_FLOOR" if w >= TF_ARGMAX_FLOOR else
             f"the plain path under TF_ARGMAX_FLOOR {TF_ARGMAX_FLOOR}: "
             f"its share less {WITNESS_SIGMAS} standard errors") + ")",
          flush=True)
    if not k >= floor:
        fail(f"{cfg.name} static: the kernels' tokens equal the f32 argmax "
             f"at {k}, under {floor} (plain attention {w})")


# ---------------------------------------------------------------------------
# the encoder-decoder's static path: its teacher-forced check
# ---------------------------------------------------------------------------


@float32_exact()
def _teacher_forced_encdec(torch, cfg, params, audio, padded, streams):
    """Every emitted token of an encoder-decoder against a plain (naive)
    f32 forward of the same weights over request i's stub frames
    (``audio[i]``, the served bf16 frames upcast), padded prompt
    (``padded[i]``) and emitted stream (``streams[i]``): its logit
    within TF_LOGIT_TOL of the row max, and at least TF_ARGMAX_FLOOR of
    them the row's argmax."""
    from repro_torch.models import encdec
    cfg32 = cfg.replace(attn_impl="naive", param_dtype="float32",
                        compute_dtype="float32")
    p32 = _cast(params, torch.float32)
    worst, agree, total = 0.0, 0, 0
    with torch.no_grad():
        for i, (prompt, _) in enumerate(padded):
            seq = list(prompt) + streams[i]
            toks = torch.tensor([seq[:-1]], device="cuda")
            enc = encdec.encode(p32, audio[i:i + 1].float(), cfg32)
            logits, _ = encdec.decoder_forward(p32, toks, enc, cfg32)
            w, a = _greedy_scores(logits[0, len(prompt) - 1:].float(),
                                  torch.tensor(streams[i], device="cuda"))
            worst, agree = max(worst, w), agree + a
            total += len(streams[i])
    del p32
    print(f"[serve] {cfg.name} teacher-forced f32 check: greedy {total} "
          f"tokens, {agree / total:.4f} equal to the f32 argmax (floor "
          f"{TF_ARGMAX_FLOOR}), worst logit deficit {worst:.4f} (tolerance "
          f"{TF_LOGIT_TOL})", flush=True)
    _greedy_gates(cfg.name, worst, agree, total)


# ---------------------------------------------------------------------------
# the mamba path: slot-state kernels, the SSD block, serving
# ---------------------------------------------------------------------------


def slot_rows(ec):
    """Row counts the slot kernels get on the mamba path: the decode
    buckets and the chunk-wide mixed step."""
    return list(ec.decode_buckets) + [ec.mixed_chunk_rows]


def phase_slot_state(torch, timer, mcfg, ec):
    """Kernels 10 and 11 at the slot-state path's shapes of ``mcfg``:
    both pool leaves as the model allocates them (mamba2-370m: the conv
    window, 3 x 2304 bf16 a row, and the SSD state, 32 x 64 x 128 f32 a
    row; recurrentgemma-2b: the conv window, 3 x 2560 bf16, and the
    hidden state, 2560 f32) of S = num_slots + 1 slots, one layer's pool
    (the fused step's call, once per layer) and a whole run's at once
    (the decode loop's entry and exit: mamba's 48 layers, a run of 2
    RG-LRU layers), at every row count of ``slot_rows``.  Gathers with
    every third row fresh (it reads zeros); scatters to distinct live
    slots, then with every fourth row stale: routed to trash slot 0 by the caller, or by the kernel
    from an int32 valid_len (and, at one layer, through
    ``layers.slot_state_scatter``, the fused step's route).  Bit for bit
    against the plain versions (slot 0 left out where two rows write
    it).  The fresh mask is bool, as the models pass ``pos == 0``
    (``phase_census`` names the kernels a gather then runs).  Timed: each
    kernel alone, and at one layer the route whole (valid_len read by
    the kernel) beside the parent's route (compare, zeros and select
    kernels first, then the scatter).  Library yardsticks, never used by
    the port: ``index_select`` on the slot axis (it does not zero fresh
    rows) and ``index_copy_``."""
    from repro_torch.kernels import slot_state as ss
    from repro_torch.kernels._common import sm_count
    from repro_torch.models.layers import slot_state_scatter
    from repro_torch.models.rglru import init_rglru_cache
    from repro_torch.models.ssm import init_ssm_cache
    s = ec.num_slots + 1
    init_state = init_rglru_cache if mcfg.rglru else init_ssm_cache
    leaves = [(name, tuple(t.shape[1:]), t.dtype) for name, t in
              init_state(mcfg, 1, mcfg.cdtype, "meta").items()]
    run = max(n for kind, _, n in _runs(mcfg) if kind in ("ssm", "rglru"))
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for leaf, feat, dtype in leaves:
        esize = torch.empty((), dtype=dtype).element_size()
        for layers in (0, run):
            lead = (layers, s) if layers else (s,)
            pool = torch.randn(lead + feat, generator=g, device="cuda").to(
                dtype)
            stacked = bool(layers)
            axis = 1 if stacked else 0
            row_bytes = math.prod(feat) * esize * max(layers, 1)
            for b in slot_rows(ec):
                slots = torch.tensor(rng.permutation(np.arange(1, s))[:b],
                                     dtype=torch.int32, device="cuda")
                fresh = torch.tensor(np.arange(b) % 3 == 1, device="cuda")
                vlead = (layers, b) if layers else (b,)
                values = torch.randn(vlead + feat, generator=g,
                                     device="cuda").to(dtype)
                label = (f"{leaf} {'L=%d' % layers if layers else 'layer'}"
                         f" B={b}")
                got = ss.slot_gather(pool, slots, fresh, stacked=stacked)
                want = ss.slot_gather_plain(pool, slots, fresh,
                                            stacked=stacked)
                if not torch.equal(got, want):
                    fail(f"slot_gather {label}: kernel != plain")
                units = row_bytes // max(layers, 1) // 16
                # each kernel's launch (16-byte units on these pools):
                # (units a thread, CTAs); the gather's from its plan
                per = ss.gather_plan(units, b, max(layers, 1), sm_count(0))
                plans = {kind: (per, -(-units // (threads * per)) * b
                                * max(layers, 1))
                         for kind, threads, per in (
                             ("gather", ss.GATHER_THREADS, per),
                             ("scatter", ss.SCATTER_THREADS,
                              ss.SCATTER_PER_THREAD))}
                stale = torch.tensor(np.arange(b) % 4 == 3, device="cuda")
                routed = torch.where(stale, torch.zeros_like(slots), slots)
                vl = torch.where(stale, 0, 1 + torch.arange(
                    b, dtype=torch.int32, device="cuda") % 3).to(torch.int32)
                calls = [(slots, None, ss.slot_scatter),
                         (routed, None, ss.slot_scatter),
                         (slots, vl, ss.slot_scatter)]
                if not layers:
                    calls.append((slots, vl, None))
                for dst, valid, fn in calls:
                    k_pool, p_pool = pool.clone(), pool.clone()
                    if fn is None:
                        slot_state_scatter(k_pool, dst, valid, values)
                    else:
                        fn(k_pool, dst, values, valid_len=valid,
                           stacked=stacked)
                    ss.slot_scatter_plain(p_pool, dst, values,
                                          valid_len=valid, stacked=stacked)
                    whole = dst is slots and valid is None
                    body = ((slice(None),) if whole else
                            ((slice(None), slice(1, None)) if stacked
                             else (slice(1, None),)))
                    if not torch.equal(k_pool[body], p_pool[body]):
                        fail(f"slot_scatter {label} (valid_len "
                             f"{'none' if valid is None else 'int32'}"
                             f"{', the route' if fn is None else ''}): "
                             "kernel != plain")
                    del k_pool, p_pool
                nfresh = int(fresh.sum())
                slots_l = slots.long()
                # gather: the non-fresh rows read once, every row written
                gb, gby = bound_ms((2 * b - nfresh) * row_bytes + 8 * b, 0,
                                   BF16_OPS_PER_S)
                sb, sby = bound_ms(2 * b * row_bytes + 4 * b, 0,
                                   BF16_OPS_PER_S)
                times = dict(
                    gather=timer(lambda: ss.slot_gather(
                        pool, slots, fresh, stacked=stacked)),
                    gather_plain=timer(lambda: ss.slot_gather_plain(
                        pool, slots, fresh, stacked=stacked)),
                    gather_lib=timer(lambda: pool.index_select(
                        axis, slots)),
                    scatter=timer(lambda: ss.slot_scatter(
                        pool, slots, values, stacked=stacked)),
                    scatter_plain=timer(lambda: ss.slot_scatter_plain(
                        pool, slots, values, stacked=stacked)),
                    scatter_lib=timer(lambda: pool.index_copy_(
                        axis, slots_l, values)))
                out[(leaf, layers, b)] = dict(
                    gather=dict(max_abs_err=0.0, ms=times["gather"],
                                plain_ms=times["gather_plain"],
                                bound_ms=gb, bound_by=gby,
                                library_ms=times["gather_lib"]),
                    scatter=dict(max_abs_err=0.0, ms=times["scatter"],
                                 plain_ms=times["scatter_plain"],
                                 bound_ms=sb, bound_by=sby,
                                 library_ms=times["scatter_lib"]))
                route = ""
                if not layers:
                    # the fused step's call whole: valid_len read by the
                    # kernel, against routing first as the parent did
                    r_ms = timer(lambda: slot_state_scatter(
                        pool, slots, vl, values))
                    first_ms = timer(lambda: ss.slot_scatter(
                        pool, torch.where(vl > 0, slots,
                                          torch.zeros_like(slots)), values))
                    out[(leaf, layers, b)]["route"] = dict(ms=r_ms)
                    out[(leaf, layers, b)]["route_first"] = dict(
                        ms=first_ms)
                    route = (f" slot_state_scatter_ms={r_ms:.4f} "
                             f"(routing first: {first_ms:.4f})")
                print(f"[slot_state] {label} S={s} row_bytes="
                      f"{math.prod(feat) * esize} ({str(dtype)[6:]}) "
                      f"fresh={nfresh} stale={int(stale.sum())} exact=yes "
                      f"gather per_thread={plans['gather'][0]} ctas="
                      f"{plans['gather'][1]} scatter per_thread="
                      f"{plans['scatter'][0]} ctas={plans['scatter'][1]}; "
                      f"gather kernel_ms={times['gather']:.4f} plain_ms="
                      f"{times['gather_plain']:.4f} bound_ms={gb:.4f} ({gby})"
                      f" library_ms(index_select)={times['gather_lib']:.4f};"
                      f" scatter kernel_ms={times['scatter']:.4f} plain_ms="
                      f"{times['scatter_plain']:.4f} bound_ms={sb:.4f} "
                      f"({sby}) bound_share={sb / times['scatter']:.4f} "
                      f"library_ms(index_copy_)="
                      f"{times['scatter_lib']:.4f}{route}", flush=True)
                del values
            del pool
    return out


def _ssd_inputs(torch, g, bc, l, h, p, n, dt_bias, A):
    """SSD block inputs as the mamba path makes them: bf16 x, B, C after
    the conv and silu, dt = softplus(raw + dt_bias) with the model's
    dt bias, da the within-chunk cumsum of dt * A."""
    F = torch.nn.functional
    x = F.silu(torch.randn((bc, l, h, p), generator=g, device="cuda")).to(
        torch.bfloat16)
    B = F.silu(torch.randn((bc, l, h, n), generator=g, device="cuda")).to(
        torch.bfloat16)
    C = F.silu(torch.randn((bc, l, h, n), generator=g, device="cuda")).to(
        torch.bfloat16)
    raw = torch.randn((bc, l, h), generator=g, device="cuda")
    dt = F.softplus(raw + dt_bias.float())
    da = torch.cumsum(dt * A.float(), dim=1)
    return x, dt, da, B, C


def _close_scaled(got, want, tol):
    """max |got - want| and its worst ratio to tol[0] * max|want| +
    tol[1] * |want| (at most 1 passes)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    lim = tol[0] * want.abs().max() + tol[1] * want.abs()
    return d.max().item(), (d / lim).max().item()


@float32_exact()
def phase_ssd_chunk(torch, timer, mcfg, ec):
    """Kernel 12 at the mamba shapes (l 256, 32 heads, p 64, n 128, bf16
    x/B/C, f32 dt and da, the dt bias and A of a seeded layer) against
    its plain version: the engine's prefill rows x one chunk and 4 x 512
    tokens.  Then its own path: ``ssm.ssd_chunked_pallas`` against the
    plain ``ssd_chunked`` in float32 on the same two shapes, every
    launch count set to 0 just before and read just after.  No single
    PyTorch call computes the block (library none)."""
    from repro_torch import kernels
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import ssm
    _, nh, _ = ssm._dims(mcfg)
    sm = mcfg.ssm
    l, p, n = sm.chunk_size, sm.head_dim, sm.d_state
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    layer = ssm.init_ssm(gen, mcfg, "cuda")
    A = -torch.exp(layer["A_log"].float())
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    out, path = {}, []
    for label, seqs, tokens in SSD_CASES:
        seqs = seqs or ec.prefill_rows
        bc = seqs * -(-tokens // l)
        x, dt, da, B, C = _ssd_inputs(torch, g, bc, l, nh, p, n,
                                      layer["dt_bias"], A)
        y, st = sc.ssd_chunk_bchp(x, dt, da, B, C)
        y0, st0 = sc.ssd_chunk_bchp_plain(x, dt, da, B, C)
        ey, ry = _close_scaled(y, y0, SSD_BF16_TOL)
        es, rs = _close_scaled(st, st0, SSD_F32_TOL)
        if not (math.isfinite(ey + es) and ry <= 1.0 and rs <= 1.0):
            fail(f"ssd_chunk_bchp {label}: y off by {ey} ({ry:.3g}x its "
                 f"bound), states by {es} ({rs:.3g}x)")
        rows = bc * nh
        nbytes = rows * l * (2 * p + 2 * 2 * n + 2 * 4 + 2 * p) \
            + rows * n * p * 4
        # scores on and below the diagonal, their product with x dt,
        # and the states: two operations a multiply-add
        tri = l * (l + 1) // 2
        ops = rows * (2 * tri * n + 2 * tri * p + 2 * l * n * p)
        bnd, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        ms = timer(lambda: sc.ssd_chunk_bchp(x, dt, da, B, C))
        plain_ms = timer(lambda: sc.ssd_chunk_bchp_plain(x, dt, da, B, C))
        out[label] = dict(max_abs_err=max(ey, es), ms=ms, plain_ms=plain_ms,
                          bound_ms=bnd, bound_by=by, library_ms=None)
        print(f"[ssd_chunk_bchp] {label}: bc={bc} l={l} h={nh} p={p} n={n} "
              f"bf16 y err={ey:.3g} (x{ry:.3f} of bound) states err="
              f"{es:.3g} (x{rs:.3f}) kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={bnd:.4f} ({by}) library_ms=none "
              f"(no single PyTorch call)", flush=True)
        # the kernel's own path, in float32
        xs = x.float().reshape(seqs, -1, nh, p)
        dts = dt.reshape(seqs, -1, nh)
        Bs = B.float().reshape(seqs, -1, nh, n)[:, :, :1]
        Cs = C.float().reshape(seqs, -1, nh, n)[:, :, :1]
        path.append((label, xs, dts, Bs, Cs))
        del x, dt, da, B, C, y, st, y0, st0
    kernels.reset_launch_counts()
    results = [ssm.ssd_chunked_pallas(xs, dts, A, Bs, Cs, chunk=l)
               for _, xs, dts, Bs, Cs in path]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["ssd_chunk_bchp"]
    if launches != len(path):
        fail(f"ssd_chunked_pallas launched ssd_chunk_bchp {launches} times"
             f" in {len(path)} calls")
    for (label, xs, dts, Bs, Cs), (y2, f2) in zip(path, results):
        y1, f1 = ssm.ssd_chunked(xs, dts, A, Bs, Cs, chunk=l)
        ey, ry = _close_scaled(y2, y1, SSD_F32_TOL)
        ef, rf = _close_scaled(f2, f1, SSD_F32_TOL)
        print(f"[ssd_chunked_pallas] {label} f32 vs ssd_chunked: y err "
              f"{ey:.3g} (x{ry:.3f} of bound) final state err {ef:.3g} "
              f"(x{rf:.3f})", flush=True)
        if not (ry <= 1.0 and rf <= 1.0):
            fail(f"ssd_chunked_pallas {label} differs from ssd_chunked")
    return out, launches


def phase_serve_mamba(torch, mcfg):
    """The mamba serving path, ``mcfg`` (mamba2-370m at every width, its
    depth as main cuts it) from SEED, the qwen2 phase's 16 requests: per depth (1 and 8) two greedy runs, which
    must repeat token for token, and one at SAMPLE_T / SAMPLE_TOP_K; the
    slot kernels must launch in every run, attention in none, and every
    state slot must be free after each; then the teacher-forced f32
    check (the logit tolerances only).  Returns the launches of each depth's first greedy and its
    sampled run, summed."""
    from repro_torch import kernels
    from repro_torch.serve.profile_engine import workload
    model, params = _init_params(torch, mcfg)
    work = workload(mcfg.vocab_size, SEED)
    launches = {fn.__name__: 0 for fn in kernels.KERNELS}
    greedy_streams, sampled_streams = [], []
    sample = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=SEED)
    for depth in (1, 8):
        runs = []
        for rep, kw in ((0, {}), (1, {}), (0, sample)):
            stream, counts, _, line = _serve_once(torch, model, params, work,
                                                  depth, **kw)
            mode = (f"T={SAMPLE_T} top_k={SAMPLE_TOP_K}" if kw
                    else "greedy")
            print(f"[serve] {mcfg.name} depth={depth} {mode} run={rep} "
                  f"{line}", flush=True)
            for name in ("slot_gather", "slot_scatter"):
                if counts[name] <= 0:
                    fail(f"{mcfg.name} depth {depth}: {name} never "
                         "launched")
            for name in ("flash_decode_paged", "decode_view_attend"):
                if counts[name]:
                    fail(f"{mcfg.name} launched {name}")
            sampler = "gumbel_sample" if kw else "greedy_sample"
            other = "greedy_sample" if kw else "gumbel_sample"
            if counts[sampler] <= 0 or counts[other]:
                fail(f"{mcfg.name} depth {depth}: {mode} serving did not "
                     f"go through {sampler} alone")
            if rep == 0:
                for k, v in counts.items():
                    launches[k] += v
            if kw:
                sampled_streams.append(stream)
            else:
                runs.append(stream)
        if runs[0] != runs[1]:
            fail(f"{mcfg.name} depth {depth}: two greedy runs gave other "
                 "streams")
        greedy_streams.append(runs[0])
    same = (greedy_streams[0] == greedy_streams[1],
            sampled_streams[0] == sampled_streams[1])
    print(f"[serve] {mcfg.name}: greedy streams repeat at each depth; "
          f"depth 1 == depth 8: greedy {same[0]}, sampled {same[1]}",
          flush=True)
    # held to the qwen2 phase's logit tolerances; the share of tokens equal
    # to the f32 argmax is printed, not held to qwen2's floor: bf16
    # through 48 mamba layers leaves a wider logit error, so near-ties
    # flip more often (PERF.md)
    _teacher_forced_check(torch, model, params, work, greedy_streams,
                          sampled_streams, argmax_floor=None)
    return launches


# ---------------------------------------------------------------------------
# the MLA + MoE path: the absorbed MLA attends, deepseek-v3 serving
# ---------------------------------------------------------------------------


def mla_case(torch, g, rng, b, c, ecfg, dcfg, paged):
    """Inputs of one MLA attend at the deepseek widths: each row's first
    query at a position from ``first_positions`` over the table's (or
    view's) span; views of blocks_per_seq * block_size + 1 slots, or
    pools behind ``paged_tables``.  Slots past a row's frontier, the
    trash slot and the trash block hold large NaN-free garbage."""
    a, H = dcfg.mla, dcfg.num_heads
    r, rd, bs, nb_seq = (a.kv_lora_rank, a.qk_rope_head_dim, ecfg.block_size,
                         ecfg.blocks_per_seq)
    s = nb_seq * bs
    ctx = first_positions(rng, b, s - c + 1)
    dt = torch.bfloat16
    q_lat = torch.randn((b, c, H, r), generator=g, device="cuda").to(dt)
    q_rope = torch.randn((b, c, H, rd), generator=g, device="cuda").to(dt)
    pos = torch.from_numpy(ctx.astype(np.int32)).cuda()
    if not paged:
        ckv = torch.randn((b, s + 1, r), generator=g, device="cuda").to(dt)
        kr = torch.randn((b, s + 1, rd), generator=g, device="cuda").to(dt)
        past = (torch.arange(s + 1, device="cuda")[None]
                > (pos + c - 1)[:, None])[..., None]
        ckv.masked_fill_(past, 60.0)
        kr.masked_fill_(past, -60.0)
        return q_lat, q_rope, ckv, kr, None, pos, ctx
    bt, nb, poison = paged_tables(rng, ctx, c, nb_seq, bs)
    ckv = torch.randn((nb, bs, r), generator=g, device="cuda").to(dt)
    kr = torch.randn((nb, bs, rd), generator=g, device="cuda").to(dt)
    mask = torch.from_numpy(poison).cuda()[..., None]
    ckv.masked_fill_(mask, 60.0)
    kr.masked_fill_(mask, -60.0)
    return (q_lat, q_rope, ckv, kr, torch.from_numpy(bt).cuda(), pos, ctx)


def mla_sdpa(torch, q_lat, q_rope, ckv, kr, pos, scale):
    """The library yardstick: one scaled_dot_product_attention over each
    row's latent view, the heads folded into the query axis (every head
    attends the same latents): q (B, 1, C*H, r + rd), k = [ckv, kr]
    (B, 1, S, r + rd), v = ckv, a boolean causal mask, the scale given.
    Returns (callable, None), or (None, the reason) if SDPA refuses."""
    from repro_torch.kernels import mla_decode as md
    F = torch.nn.functional
    b, c, h, r = q_lat.shape
    s = ckv.shape[1]
    q = torch.cat([q_lat, q_rope], -1).reshape(b, 1, c * h, -1)
    k = torch.cat([ckv, kr], -1)[:, None]
    v = ckv[:, None]
    qpos = (pos[:, None].long() + torch.arange(c, device="cuda")[None])
    mask = (torch.arange(s, device="cuda")[None, None]
            <= qpos[..., None])                               # (B,C,S)
    mask = mask[:, :, None].expand(b, c, h, s).reshape(b, 1, c * h, s)

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)
    try:
        out = call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as err:
        return None, f"{type(err).__name__}: {str(err)[:120]}"
    want = md.mla_decode_views_plain(q_lat, q_rope, ckv, kr, pos,
                                     scale=scale)
    err = (out.reshape(b, c, h, r).float() - want.float()).abs().max().item()
    if not err <= 0.05:
        fail(f"the SDPA yardstick disagrees with the plain MLA attend by "
             f"{err}")
    return call, None


def phase_mla(torch, timer, dcfg, ec, paged):
    """Kernel 8 (views) or 9 (paged) at every row layout the engine
    dispatches (decode buckets, prefill rows x chunk, width-1 mixed
    rows) at deepseek-v3's widths (128 heads, r 512, rd 64), 640 keys a
    row, against its plain version within one bf16 ulp, timed beside its
    bound, the plain version and one SDPA call over the gathered views.
    The decode rows split their keys over CTAs and the wide layouts run
    unsplit: the phase fails unless both epilogues are compared."""
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels._common import sm_count
    name = "mla_decode_paged" if paged else "mla_decode_views"
    a, H = dcfg.mla, dcfg.num_heads
    r, rd = a.kv_lora_rank, a.qk_rope_head_dim
    scale = 1.0 / math.sqrt(a.qk_nope_head_dim + a.qk_rope_head_dim)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7 + paged)
    rng = np.random.default_rng(SEED + 7 + paged)
    results = []
    for b, c in step_shapes(ec, dcfg):
        label = f"B={b} C={c}"
        q_lat, q_rope, ckv, kr, bt, pos, ctx = mla_case(torch, g, rng, b, c,
                                                        ec, dcfg, paged)
        keys = ec.blocks_per_seq * ec.block_size
        if paged:
            def kern():
                return md.mla_decode_paged(q_lat, q_rope, ckv, kr, bt, pos,
                                           scale=scale)

            def plain():
                return md.mla_decode_paged_plain(q_lat, q_rope, ckv, kr, bt,
                                                 pos, scale=scale)
            bl = bt.long()
            vckv = ckv[bl].reshape(b, keys, r)
            vkr = kr[bl].reshape(b, keys, rd)
        else:
            def kern():
                return md.mla_decode_views(q_lat, q_rope, ckv, kr, pos,
                                           scale=scale)

            def plain():
                return md.mla_decode_views_plain(q_lat, q_rope, ckv, kr,
                                                 pos, scale=scale)
            keys += 1
            vckv, vkr = ckv, kr
        tiles, nsplit = md.launch_splits(b, c, H, keys, q_lat.dtype,
                                         sm_count(0))
        err, ratio, lim = compare_attn(kern(), plain())
        if not (math.isfinite(err) and ratio <= 1.0):
            fail(f"{name} {label}: max |kernel - plain| = {err}, "
                 f"{ratio:.3g}x the bound {lim}")
        # each row's visible latents read once, queries read and the
        # output written once; 2 (r + rd) + 2 r operations a visible key
        # and query row
        read = int(np.minimum(ctx + c, keys).sum())
        vis = int(sum(p + i + 1 for p in ctx for i in range(c)))
        nbytes = (read * (r + rd) * 2 + q_lat.numel() * 2 * 2
                  + q_rope.numel() * 2 + b * 4
                  + (bt.numel() * 4 if paged else 0))
        ops = vis * H * (2 * (r + rd) + 2 * r)
        bnd, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        ms = timer(kern)
        plain_ms = timer(plain)
        lib, why = mla_sdpa(torch, q_lat, q_rope, vckv, vkr, pos, scale)
        lib_ms = timer(lib) if lib is not None else None
        results.append(dict(label=label, nsplit=nsplit, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                            bound_by=by, library_ms=lib_ms))
        lib_txt = f"{lib_ms:.4f}" if lib is not None else f"none ({why})"
        # shares of the card's peaks this time reaches: the bf16 MMA rate
        # on useful work, and the bound
        print(f"[{name}] {label} keys={keys} tiles={tiles} nsplit={nsplit} "
              f"H={H} r={r} rd={rd} err={err:.3g} (x{ratio:.3f} of bound) "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd:.4f} ({by}) library_ms(sdpa)={lib_txt} "
              f"bf16_tc_rate_share={ops / (ms * 1e-3) / BF16_OPS_PER_S:.4f} "
              f"bound_share={bnd / ms:.4f}", flush=True)
        del q_lat, q_rope, ckv, kr, vckv, vkr, lib
    if {r["nsplit"] > 1 for r in results} != {False, True}:
        fail(f"{name}: the engine's shapes did not reach both the split and "
             "the unsplit epilogue")
    return results


class ServedRouting:
    """Records the experts the served MoE layers pick for every request
    position, while an engine runs over ``self.model``: the model's step
    functions are wrapped to note the rows' request ids, the forward to
    note their positions and valid lengths, and the router to note its
    choice.  ``resolve()`` gives ``{(rid, position): [ids (K,) of each
    MoE layer]}`` (a recomputed position keeps its last routing).  Over
    a slice of ``shards`` shards every shard routes each MoE layer's
    rows alike (one router, its copies): the first shard's choice is
    noted."""

    def __init__(self, torch, model, shards=1):
        import dataclasses
        from repro_torch.models import moe, transformer
        self.torch, self.moe, self.tf = torch, moe, transformer
        self.records, self.ctx, self.shards = [], {}, shards

        def step(params, cache, slot_buf, tokens, block_tables, meta, **kw):
            self.ctx["rid"] = meta[5]
            return model.paged_step(params, cache, slot_buf, tokens,
                                    block_tables, meta, **kw)

        def loop(params, cache, slot_buf, block_tables, meta, **kw):
            self.ctx["rid"] = meta[4]
            return model.paged_decode_loop(params, cache, slot_buf,
                                           block_tables, meta, **kw)

        self.model = dataclasses.replace(model, paged_step=step,
                                         paged_decode_loop=loop)

    def __enter__(self):
        self._forward, self._route = self.tf.forward, self.moe.route

        def forward(params, tokens, cfg, **kw):
            self.ctx.update(pos=kw.get("pos"), valid=kw.get("valid_len"),
                            rows=tokens.shape[0], layer=0, calls=0)
            return self._forward(params, tokens, cfg, **kw)

        def route(params, xt, cfg):
            out = self._route(params, xt, cfg)
            c = self.ctx
            if c.get("pos") is not None:
                if c["calls"] % self.shards == 0:
                    self.records.append((c["rid"], c["pos"], c["valid"],
                                         c["layer"], out[2].reshape(
                                             c["rows"], -1,
                                             out[2].shape[-1])))
                    c["layer"] += 1
                c["calls"] += 1
            return out

        self.tf.forward, self.moe.route = forward, route
        return self

    def __exit__(self, *exc):
        self.tf.forward, self.moe.route = self._forward, self._route

    def resolve(self):
        by = {}
        for rid, pos, valid, layer, ids in self.records:
            rid, pos, valid, ids = (t.cpu().numpy() for t in
                                    (rid, pos, valid, ids))
            for b in range(ids.shape[0]):
                for c in range(int(valid[b])):
                    by.setdefault((int(rid[b]), int(pos[b]) + c), {})[
                        layer] = np.sort(ids[b, c])
        return {k: [v[i] for i in sorted(v)] for k, v in by.items()}


def phase_serve_deepseek(torch, dcfg):
    """The MLA + MoE serving path: full-width deepseek-v3 cut to its
    first DEEPSEEK_LAYERS layers (3 dense, the first MoE), bf16 weights
    from SEED, the qwen2 phase's 16 requests: depth 1 greedy twice (the
    streams must repeat), depth 8 greedy once and at SAMPLE_T /
    SAMPLE_TOP_K once.  Both MLA kernels must launch at depth 8, the
    paged one at depth 1, the GQA attention kernels never.  Then every
    token against a teacher-forced f32 forward of the plain model in its
    dropless form.  Returns the launches of the first greedy run of each
    depth and of the sampled run, summed."""
    from repro_torch import kernels
    from repro_torch.serve.profile_engine import workload
    model, params = _init_params(torch, dcfg)
    work = workload(dcfg.vocab_size, SEED)
    launches = {fn.__name__: 0 for fn in kernels.KERNELS}
    greedy, sampled, routes = [], [], {}
    sample = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=SEED)
    runs = ((1, 0, {}), (1, 1, {}), (8, 0, {}), (8, 0, sample))
    for depth, rep, kw in runs:
        torch.cuda.reset_peak_memory_stats()
        with ServedRouting(torch, model) as rec:
            stream, counts, _, line = _serve_once(torch, rec.model, params,
                                                  work, depth, **kw)
        mode = f"T={SAMPLE_T} top_k={SAMPLE_TOP_K}" if kw else "greedy"
        print(f"[serve] {dcfg.name} depth={depth} {mode} run={rep} {line} "
              f"peak_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}",
              flush=True)
        need = ["mla_decode_paged"] + (["mla_decode_views"] if depth > 1
                                       else [])
        for name in need:
            if counts[name] <= 0:
                fail(f"{dcfg.name} depth {depth}: {name} never launched")
        for name in ("flash_decode_paged", "decode_view_attend"):
            if counts[name]:
                fail(f"{dcfg.name} launched {name}")
        sampler = "gumbel_sample" if kw else "greedy_sample"
        other = "greedy_sample" if kw else "gumbel_sample"
        if counts[sampler] <= 0 or counts[other]:
            fail(f"{dcfg.name} depth {depth}: {mode} serving did not go "
                 f"through {sampler} alone")
        if rep == 0:
            for k, v in counts.items():
                launches[k] += v
        (sampled if kw else greedy).append(stream)
        routes[id(stream)] = rec.resolve()
    if greedy[0] != greedy[1]:
        fail(f"{dcfg.name} depth 1: two greedy runs gave other streams")
    print(f"[serve] {dcfg.name}: depth-1 greedy streams repeat; depth 1 == "
          f"depth 8 greedy: {greedy[0] == greedy[2]}", flush=True)
    distinct = [s for i, s in enumerate(greedy) if s not in greedy[:i]]
    # held to the qwen2 phase's logit tolerances against an f32 oracle
    # that routes as the served run routed (the router's top-8 choice is
    # discontinuous: bf16 noise flips it for some tokens, PERF.md); the
    # share of tokens equal to the f32 argmax is printed, not held to
    # qwen2's floor
    _teacher_forced_check(torch, model, params, work, distinct, sampled,
                          argmax_floor=None,
                          routes=[routes[id(s)] for s in distinct + sampled])
    del params
    return launches


def _runs(cfg):
    from repro_torch.models.transformer import runs_of
    return runs_of(cfg)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _greedy_scores(rows, emitted):
    """f32 logit rows (T, V) of a stream against its emitted greedy tokens
    (T,): (the worst deficit of an emitted token's logit below its row's
    max, how many of them are the row's argmax)."""
    chosen = rows.gather(1, emitted[:, None])[:, 0]
    return ((rows.max(-1).values - chosen).max().item(),
            int((rows.argmax(-1) == emitted).sum().item()))


def _greedy_gates(label, worst, agree, total, argmax_floor=TF_ARGMAX_FLOOR):
    """The teacher-forced gates of greedy tokens: the worst deficit within
    TF_LOGIT_TOL, and at least ``argmax_floor`` of the tokens (None: no
    floor) the f32 argmax."""
    if not (worst <= TF_LOGIT_TOL):
        fail(f"{label}: emitted token logit deficit {worst} > "
             f"{TF_LOGIT_TOL}")
    if argmax_floor is not None and not (agree / total >= argmax_floor):
        fail(f"{label}: emitted tokens equal to the f32 argmax: "
             f"{agree / total} < {argmax_floor}")


@float32_exact()
def _teacher_forced_check(torch, model, params, work, greedy, sampled,
                          argmax_floor=TF_ARGMAX_FLOOR, routes=None,
                          images=None):
    """Every emitted token against a plain f32 forward over the emitted
    stream (behind request i's image prefix ``images[i]`` for a vlm's
    static path; the weights as ``_oracle_params`` gives them).
    Greedy: its logit within TF_LOGIT_TOL of the row's max, and
    at least ``argmax_floor`` of them (None: printed, not held) the row's
    argmax (bf16 kernels need not pick the same token as f32 where random
    weights leave near-ties, so exact identity is not required).
    Sampled: its logit no more than TF_TOPK_MARGIN below the row's f32
    SAMPLE_TOP_K-th value.  Returns (greedy tokens equal to the argmax,
    greedy tokens).

    ``routes`` (the MoE family; one ``ServedRouting.resolve()`` per
    stream set, greedy then sampled): the forward runs the MoE in its
    dropless (serving) form, the full-sequence default being the training
    capacity; its expert leaves stay bf16 and the MoE casts them a group
    at a time (one f32 expert leaf is 15 GB at deepseek-v3's widths).
    The oracle routes every position to the experts the served run chose
    there, with f32 gates: the top-k choice is discontinuous, and bf16
    noise flips it for some tokens.  A second f32 forward with the f32
    router's own choice counts those flips, and the worst deficit and
    margin of emitted tokens with and without a flip at their position
    are printed beside the check."""
    from repro_torch.models import moe, transformer
    torch.cuda.reset_peak_memory_stats()
    p32 = _oracle_params(torch, params)
    cfg32 = model.cfg.replace(param_dtype="float32", compute_dtype="float32")
    worst, agree, total, worst_k, total_k = 0.0, 0, 0, 0.0, 0
    flips = routed = 0
    # the f32 router's own choice: worst greedy deficit / sampled margin
    # of emitted tokens whose served routing differs (True) or not
    by_flip = {True: [0.0, 0.0, 0], False: [0.0, 0.0, 0]}
    route = moe.route
    forced, natural = [], []

    def forced_route(params_, xt, cfg):
        probs, _, ids = route(params_, xt, cfg)
        natural.append(ids.sort(-1).values)
        if not forced:
            return probs, _, ids
        ids = forced[len(natural) - 1]
        gates = probs.gather(1, ids)
        return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), ids

    moe.route = forced_route
    try:
        with torch.no_grad():
            sets = ([(o, True) for o in greedy]
                    + [(o, False) for o in sampled])
            for j, (out, is_greedy) in enumerate(sets):
                for i, (prompt, _) in enumerate(work):
                    seq = list(prompt) + out[i]
                    toks = torch.tensor([seq[:-1]], device="cuda")
                    img = {} if images is None else dict(
                        image_embeds=images[i:i + 1])
                    first = len(prompt) - 1 + (0 if images is None
                                               else images.shape[1])
                    forced.clear()
                    flipped = torch.zeros((toks.shape[1],), dtype=torch.bool,
                                          device="cuda")
                    if routes is not None:
                        # the f32 router's own choice, then the served one
                        natural.clear()
                        own, _, _, _ = transformer.forward(p32, toks, cfg32,
                                                        dropless=True)
                        try:
                            per_pos = [routes[j][(i, p)]
                                       for p in range(toks.shape[1])]
                        except KeyError as err:
                            fail(f"no served routing recorded at {err}")
                        forced.extend(
                            torch.tensor(np.stack([r[layer] for r in per_pos]),
                                         device="cuda")
                            for layer in range(len(per_pos[0])))
                        for a, b in zip(natural, forced):
                            differ = (a != b).any(-1)
                            flipped |= differ
                            flips += int(differ.sum().item())
                            routed += a.shape[0]
                    natural.clear()
                    logits, _, _, _ = transformer.forward(
                        p32, toks, cfg32, dropless=routes is not None, **img)
                    rows = logits[0, first:].float()
                    del logits
                    emitted = torch.tensor(out[i], device="cuda")
                    if is_greedy:
                        w, a = _greedy_scores(rows, emitted)
                        worst, agree = max(worst, w), agree + a
                        total += len(out[i])
                    else:
                        chosen = rows.gather(1, emitted[:, None])[:, 0]
                        kth = torch.topk(rows, SAMPLE_TOP_K, -1).values
                        gap = kth[:, -1] - chosen
                        worst_k = max(worst_k, gap.max().item())
                        total_k += len(out[i])
                    if routes is None:
                        continue
                    rows = own[0, len(prompt) - 1:].float()
                    chosen = rows.gather(1, emitted[:, None])[:, 0]
                    gap = (rows.max(-1).values if is_greedy else torch.topk(
                        rows, SAMPLE_TOP_K, -1).values[:, -1]) - chosen
                    fl = flipped[len(prompt) - 1:]
                    for key, sel in ((True, gap[fl]), (False, gap[~fl])):
                        if sel.numel():
                            slot = 0 if is_greedy else 1
                            by_flip[key][slot] = max(by_flip[key][slot],
                                                     sel.max().item())
                            by_flip[key][2] += sel.numel()
    finally:
        moe.route = route
    del p32
    floor = "no floor" if argmax_floor is None else f"floor {argmax_floor}"
    oracle = " (routed as served)" if routes is not None else ""
    print(f"[serve] {model.cfg.name} teacher-forced f32 check{oracle}: "
          f"greedy {total} tokens, {agree / total:.4f} equal to the f32 "
          f"argmax ({floor}), worst logit deficit {worst:.4f} "
          f"(tolerance {TF_LOGIT_TOL}); sampled {total_k} tokens, worst "
          f"logit below the f32 top-{SAMPLE_TOP_K} kth value "
          f"{worst_k:.4f} (margin {TF_TOPK_MARGIN})", flush=True)
    if routes is not None:
        print(f"[serve] {model.cfg.name} router: {flips} of {routed} "
              "token-layer routings of the served run differ from the f32 "
              "router's own choice; against the f32 forward that routes "
              "by its own choice, emitted tokens at a flipped position: "
              f"{by_flip[True][2]}, worst greedy deficit "
              f"{by_flip[True][0]:.4f}, worst sampled margin "
              f"{by_flip[True][1]:.4f}; at an unflipped one: "
              f"{by_flip[False][2]}, {by_flip[False][0]:.4f}, "
              f"{by_flip[False][1]:.4f}; peak memory of the check "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    _greedy_gates(model.cfg.name, worst, agree, total, argmax_floor)
    if not (worst_k <= TF_TOPK_MARGIN):
        fail(f"a sampled token's logit sits {worst_k} below the f32 "
             f"top-{SAMPLE_TOP_K} kth value (margin {TF_TOPK_MARGIN})")
    return agree, total


def _cast(tree, dtype):
    """The params the f32 forward reads, in ``dtype``: expert leaves are
    left as they are (see ``_teacher_forced_check``) and the MTP head,
    which no forward here reads, is left out."""
    return {k: v if k == "experts" else
            _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items() if k != "mtp"}


def _oracle_params(torch, params, spare=16e9):
    """The weights of the f32 oracle: ``_cast``'s f32 copy where it fits
    beside ``params`` with ``spare`` bytes left on the card, else the
    bf16 params themselves, which the f32 forward casts a weight at a
    time where it reads it: the same f32 numbers (bf16 -> f32 is exact),
    for llava-next-34b's 30 layers, 35.3 GB in bf16, whose copy would
    take 70.6 GB more."""
    def cast(tree):
        for k, v in tree.items():
            if k not in ("experts", "mtp"):
                yield from cast(v) if isinstance(v, dict) else (v,)
    need = sum(t.numel() * 4 for t in cast(params))
    if need + spare <= torch.cuda.mem_get_info()[0]:
        return _cast(params, torch.float32)
    print(f"[oracle] an f32 copy of the weights ({need / 1e9:.1f} GB) does "
          "not fit beside them: the f32 forward casts each bf16 weight "
          "where it reads it", flush=True)
    return params


# ---------------------------------------------------------------------------
# the decoders served after qwen2 and the MLA family: recurrentgemma-2b
# and the last four LM configs
# ---------------------------------------------------------------------------


def _serving_launches(cfg, counters, depth, sampled, tp=1):
    """The launches one Engine run must make, from its counters: every
    fused step one kernel-1 launch a (local) attention layer and a slot
    gather and scatter a leaf of each recurrent layer; every decode loop
    ``depth`` iterations of one kernel-2 launch an attention layer, and
    one slot gather and scatter a leaf of each recurrent run at entry
    and exit; one sampler launch a step or iteration.  Over a slice of
    ``tp`` shards each shard of a split module launches its own (the
    sampler runs once, on the full rows)."""
    from repro_torch.sharding import split_modules
    mods = split_modules(cfg, tp)
    runs = _runs(cfg)

    def shards(kind):
        return tp if mods["attn" if kind == "local_attn" else kind] else 1

    attn = sum(n * shards(kind) for kind, _, n in runs
               if kind in ("attn", "local_attn"))
    state = [(n * shards(kind), shards(kind)) for kind, _, n in runs
             if kind in ("ssm", "rglru")]
    leaves = 2                               # conv and h (or state)
    loops = counters["loop_dispatches"]
    steps = counters["model_calls"] - loops
    want = dict(flash_decode_paged=steps * attn,
                decode_view_attend=loops * depth * attn,
                slot_gather=leaves * (steps * sum(n for n, _ in state)
                                      + loops * sum(r for _, r in state)))
    want["slot_scatter"] = want["slot_gather"]
    want["gumbel_sample" if sampled else "greedy_sample"] = \
        steps + loops * depth
    return want


def phase_serve_lm(torch, cfg, params=None, greedy_runs=1):
    """A decoder's paged serving path at full width, at the depth ``cfg``
    gives (LM_SERVE_LAYERS: recurrentgemma-2b's RG-LRU and local MQA
    layers at hd 256; minicpm-2b; h2o-danube-3-4b at hd 120; dbrx-132b;
    llava-next-34b; bf16, random weights from SEED, or ``params``): the
    qwen2 phase's 16
    requests at depths 1 and 8, ``greedy_runs`` greedy runs (their
    streams must repeat) and one at SAMPLE_T / SAMPLE_TOP_K, each making
    exactly the launches its counters call for (kernels 1-4 and 10-11,
    ``_serving_launches``) and freeing every state slot; then, for a
    config in LONG_REQUESTS, its long request under an EngineConfig whose
    tables hold it, at depths 1 and 8: its queries pass the window, so
    the kernels mask keys and the engine must reclaim dead blocks
    (kv_blocks_reclaimed > 0).  Every emitted token is held to the
    teacher-forced f32 check; an MoE config's oracle routes as the
    served run routed (``ServedRouting``, as deepseek's) with no argmax
    floor.  Returns the launches of each depth's first greedy and its
    sampled run and of the long runs, summed."""
    from repro_torch import kernels
    from repro_torch.serve.profile_engine import workload
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    if params is None:
        params = _init_params(torch, cfg)[1]
    moe = cfg.moe is not None
    work = workload(cfg.vocab_size, SEED)
    launches = {fn.__name__: 0 for fn in kernels.KERNELS}
    greedy, sampled, routes = [], [], {}
    sample = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=SEED)

    def serve(work, depth, label, engine=None, **kw):
        stats = {}
        with (ServedRouting(torch, model) if moe
              else contextlib.nullcontext()) as rec:
            stream, counts, _, line = _serve_once(
                torch, rec.model if moe else model, params, work, depth,
                engine=engine, stats=stats, **kw)
        print(f"[serve] {cfg.name} depth={depth} {label} {line}", flush=True)
        want = _serving_launches(cfg, stats, depth, bool(kw))
        got = {k: v for k, v in counts.items() if v}
        if got != {k: v for k, v in want.items() if v}:
            fail(f"{cfg.name} {label} depth {depth}: launches {got}, want "
                 f"{want}")
        if moe:
            routes[id(stream)] = rec.resolve()
        return stream, counts, stats

    for depth in (1, 8):
        for kw in ({}, sample):
            runs = []
            mode = f"T={SAMPLE_T} top_k={SAMPLE_TOP_K}" if kw else "greedy"
            for rep in range(1 if kw else greedy_runs):
                stream, counts, _ = serve(work, depth, f"{mode} run={rep}",
                                          **kw)
                if rep == 0:
                    for k, v in counts.items():
                        launches[k] += v
                runs.append(stream)
            if runs[0] != runs[-1]:
                fail(f"{cfg.name} depth {depth} {mode}: a repeat gave "
                     "other streams")
            (sampled if kw else greedy).append(runs[0])
    print(f"[serve] {cfg.name}: depth 1 == depth 8: greedy "
          f"{greedy[0] == greedy[1]}, sampled {sampled[0] == sampled[1]}",
          flush=True)
    floor = None if moe else TF_ARGMAX_FLOOR
    _teacher_forced_check(
        torch, model, params, work, greedy, sampled, argmax_floor=floor,
        routes=[routes[id(s)] for s in greedy + sampled] if moe else None)
    if cfg.name in LONG_REQUESTS:
        # one request past the window: the window mask and block reclaim
        prompt_len, new = LONG_REQUESTS[cfg.name]
        rng = np.random.default_rng(SEED + 21)
        long_work = [(rng.integers(0, cfg.vocab_size, (prompt_len,))
                      .astype(np.int32), new)]
        long_cfg = dict(max_seq_len=long_seq(cfg))
        long_streams = []
        for depth in (1, 8):
            stream, counts, stats = serve(
                long_work, depth, f"long request prompt={prompt_len} "
                f"new={new} max_seq_len={long_cfg['max_seq_len']}",
                engine=long_cfg)
            if stats["kv_blocks_reclaimed"] <= 0:
                fail(f"{cfg.name} long request depth {depth}: no block "
                     f"reclaimed past the {attn_window(cfg)}-token window")
            for k, v in counts.items():
                launches[k] += v
            long_streams.append(stream)
        _teacher_forced_check(torch, model, params, long_work, long_streams,
                              [], argmax_floor=floor)
    del params
    return launches


# ---------------------------------------------------------------------------


def phase_census(torch, cfg, mcfg, ec):
    """The kernels kernels 2, 3, 4, 5, 10 and 11 run on the card: their names
    from the profiler (``device_kernels``), their launches a call from
    the CUDA driver (``graph_kernels``).  Kernel 2 in bf16 at the first
    decode bucket over the loop's views must run ``flash_decode_tc`` over
    ``ViewKeys`` (and its split merge); kernel 10 with a bool fresh
    mask, as the models pass it, at the first decode bucket over each
    state leaf's pool (one layer and all layers) must run the gather
    alone, one launch a call; kernel 11 through
    ``layers.slot_state_scatter`` with an int32 valid_len (the fused
    step's call) over each leaf's one-layer pool must run the scatter
    alone, one launch a call; kernel 4 at the first decode bucket, with
    and without top-k, and kernel 3 there, one cluster launch a call;
    kernel 5 through ``apply_update`` over ResNet-50's 161 leaves, one
    launch a call for sgd and three (norms, trust, update) for lars.
    Last of the phases: once ``torch.profiler`` has run in a process, the
    host launches slower for the rest of it (mamba depth-1 serving read
    about 10% fewer tok/s after it; PERF.md)."""
    from repro_torch.kernels import decode_view as dv
    from repro_torch.kernels import sampling as sp
    from repro_torch.kernels import slot_state as ss
    from repro_torch.models.layers import slot_state_scatter
    from repro_torch.models.ssm import init_ssm_cache
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    H, KV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, s1 = ec.decode_buckets[0], ec.blocks_per_seq * ec.block_size + 1
    q = torch.randn((b, H, HD), generator=g, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((b, s1, KV, HD), generator=g, device="cuda").to(q.dtype)
    pos = torch.arange(b, dtype=torch.int32, device="cuda") * 70

    def view():
        return dv.decode_view_attend(q, k, k, pos)
    ran, calls = device_kernels(torch, view)
    per_call = graph_kernels(torch, view, 10)[0] / 10
    print(f"[census] decode_view_attend B={b} S+1={s1} bfloat16: "
          f"{per_call} kernels a call (CUDA graph); kernels the profiler "
          f"saw over {calls - 1} calls: {ran}", flush=True)
    if not any("flash_decode_tc" in n and "ViewKeys" in n for n in ran):
        fail("decode_view_attend: the bf16 launch did not run "
             "flash_decode_tc over ViewKeys")

    def alone(fn, kernel, label):
        """``fn`` is one launch of ``kernel`` a call, and nothing else."""
        ran, calls = device_kernels(torch, fn)
        n, nodes = graph_kernels(torch, fn, 10)
        print(f"[census] {label}: {n} kernels ({nodes} graph nodes) in 10 "
              f"calls (CUDA graph); kernels the profiler saw over "
              f"{calls - 1} calls: {ran}", flush=True)
        if (n, nodes) != (10, 10) or any(kernel not in name for name in ran):
            fail(f"{label}: a call ran other kernels than the one "
                 f"{kernel}: {n} kernels, {nodes} nodes in 10 calls, {ran}")

    s = ec.num_slots + 1
    slots = torch.arange(1, b + 1, dtype=torch.int32, device="cuda") % s
    fresh = pos == 0
    vl = torch.where(fresh, 0, 1).to(torch.int32)
    for leaf, t in init_ssm_cache(mcfg, 1, mcfg.cdtype, "meta").items():
        for layers in (0, mcfg.num_layers):
            lead = (layers, s) if layers else (s,)
            pool = torch.zeros(lead + tuple(t.shape[1:]), dtype=t.dtype,
                               device="cuda")
            label = f"{leaf} {'L=%d' % layers if layers else 'layer'} B={b}"
            alone(lambda: ss.slot_gather(pool, slots, fresh,
                                         stacked=bool(layers)),
                  "slot_gather_kernel",
                  f"slot_gather {label} ({fresh.dtype} mask)")
            if not layers:
                value = torch.ones((b,) + tuple(t.shape[1:]), dtype=t.dtype,
                                   device="cuda")
                alone(lambda: slot_state_scatter(pool, slots, vl, value),
                      "slot_scatter_kernel",
                      f"slot_state_scatter {label} ({vl.dtype} valid_len)")
            del pool
    lg = torch.randn((b, cfg.vocab_size), generator=g, device="cuda")
    noise = torch.randn(lg.shape, generator=g, device="cuda")
    for top_k in (0, SAMPLE_TOP_K):
        alone(lambda: sp.gumbel_sample(lg, noise, temperature=SAMPLE_T,
                                       top_k=top_k),
              "gumbel_cluster_kernel",
              f"gumbel_sample B={b} V={cfg.vocab_size} top_k={top_k}")
    alone(lambda: sp.greedy_sample(lg), "gumbel_cluster_kernel",
          f"greedy_sample B={b} V={cfg.vocab_size}")
    del lg, noise
    # kernel 5 over ResNet-50's 161 leaves through the optimizer: one
    # launch a call for sgd, three for lars (norms, trust, update)
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_map
    params = build_model(get_config("resnet50")).init(SEED, "cuda")
    state = sgd.init_state(params, sgd.OptimConfig())
    grads = tree_map(lambda p: torch.full_like(p, 1e-3), params)
    for kind, want, names in (
            ("sgd", 1, ("fused_sgd_kernel",)),
            ("lars", 3, ("lars_norms_kernel", "lars_trust_kernel",
                         "fused_sgd_kernel"))):
        cfg5 = sgd.OptimConfig(kind=kind)
        fn = lambda: sgd.apply_update(params, state, grads, 1e-6, cfg5)
        ran, calls = device_kernels(torch, fn)
        n, nodes = graph_kernels(torch, fn, 10)
        print(f"[census] apply_update {kind} over resnet50's "
              f"{len(list(_leaves(params)))} leaves: {n} kernels ({nodes} "
              f"graph nodes) in 10 calls (CUDA graph); kernels the "
              f"profiler saw over {calls - 1} calls: {ran}", flush=True)
        if ((n, nodes) != (10 * want, 10 * want)
                or {k for k in names if not any(k in r for r in ran)}
                or any(not any(k in r for k in names) for r in ran)):
            fail(f"apply_update {kind}: want {want} kernels a call "
                 f"({names}), got {n} kernels, {nodes} nodes in 10 "
                 f"calls, {ran}")
    del params, state, grads


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
    sass_counts(so)
    card = nvidia_smi()
    print(f"[card] {card}", flush=True)

    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b")
    ec = engine_config()
    timer = Timer(torch)

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] {fn.__name__} {time.perf_counter() - t:.1f}s "
              f"(script {time.perf_counter() - t0:.1f}s)", flush=True)
        return out

    fd = phase(phase_flash_decode, torch, timer, cfg, ec)
    dv = phase(phase_decode_view, torch, timer, cfg, ec)
    gs = phase(phase_greedy, torch, timer, cfg, ec)
    from repro_torch.serve.profile_engine import served_config
    mcfg, dcfg = get_config(MAMBA), served_config(DEEPSEEK)
    rcfg = get_config(RGEMMA)
    ccfg, hcfg, bcfg, lcfg = (
        get_config(n).replace(num_layers=LM_SERVE_LAYERS[n])
        for n in (MINICPM, H2O, DBRX, LLAVA))
    lms = (ccfg, hcfg, bcfg, lcfg)
    gb = phase(phase_gumbel, torch, timer, cfg,
               (mcfg, dcfg, rcfg) + lms, ec)
    fu, fu_sets = phase(phase_fused_update, torch, Timer(torch, iters=10),
                        cfg)
    launches = phase(phase_serve, torch, cfg)
    phase(phase_depth_f32, torch,
          cfg.replace(num_layers=F32_GATE_LAYERS[QWEN2]))
    c_launches = phase(phase_serve_cluster, torch,
                       cfg.replace(num_layers=CLUSTER_LAYERS), card)
    for name in ("flash_decode_paged", "decode_view_attend", "greedy_sample",
                 "gumbel_sample"):
        launches[name] += c_launches[name]
    tr = phase(phase_train, torch)
    phase(phase_virtual, torch, cfg)
    rn = phase(phase_resnet_train, torch)
    launches["fused_sgd_update"] = (tr["launches"]["fused_sgd_update"]
                                    + rn["launches"]["fused_sgd_update"])
    phase(phase_resnet_equivalence, torch)
    from repro_torch.serve.profile_engine import workload
    work = workload(cfg.vocab_size, SEED)
    fa = phase(phase_flash_attention, torch, timer, cfg, work)
    fdb = phase(phase_flash_decode_bhd, torch, timer, cfg, work)
    s_launches = phase(phase_serve_static, torch, cfg)
    for name in ("flash_attention", "flash_decode"):
        launches[name] = s_launches[name]
    st = phase(phase_slot_state, torch, timer, mcfg, ec)
    ssd, ssd_launches = phase(phase_ssd_chunk, torch, timer, mcfg, ec)
    m_launches = phase(phase_serve_mamba, torch,
                       mcfg.replace(num_layers=MAMBA_SERVE_LAYERS))
    phase(phase_depth_f32, torch,
          mcfg.replace(num_layers=F32_GATE_LAYERS[MAMBA]))
    for name in ("slot_gather", "slot_scatter"):
        launches[name] = m_launches[name]
    launches["ssd_chunk_bchp"] = ssd_launches
    mv = phase(phase_mla, torch, timer, dcfg, ec, False)
    mp = phase(phase_mla, torch, timer, dcfg, ec, True)
    d_launches = phase(phase_serve_deepseek, torch, dcfg)
    phase(phase_depth_f32, torch, dcfg)
    for name in ("mla_decode_views", "mla_decode_paged"):
        launches[name] = d_launches[name]
    rwork = workload(rcfg.vocab_size, SEED)
    fd += phase(phase_flash_decode, torch, timer, rcfg, ec)
    dv += phase(phase_decode_view, torch, timer, rcfg, ec)
    fa += phase(phase_flash_attention, torch, timer, rcfg, rwork)
    fdb += phase(phase_flash_decode_bhd, torch, timer, rcfg, rwork)
    phase(phase_greedy, torch, timer, rcfg, ec)
    phase(phase_slot_state, torch, timer, rcfg, ec)
    rserved = rcfg.replace(num_layers=LM_SERVE_LAYERS[RGEMMA])
    r_launches = phase(phase_serve_lm, torch, rserved, None, 2)
    phase(phase_depth_f32, torch,
          rcfg.replace(num_layers=F32_GATE_LAYERS[RGEMMA]))
    rs_launches = phase(phase_serve_static, torch, rserved, True)
    for name in ("flash_decode_paged", "decode_view_attend", "greedy_sample",
                 "gumbel_sample", "slot_gather", "slot_scatter"):
        launches[name] += r_launches[name]
    for name in ("flash_attention", "flash_decode"):
        launches[name] += rs_launches[name]
    rt = phase(phase_train, torch, RG_TRAIN_ARGV)
    wcfg = get_config(WHISPER)
    wwork = workload(wcfg.vocab_size, SEED, WHISPER_PROMPT_LENS)
    fa += phase(phase_flash_attention, torch, timer, wcfg, wwork)
    fdb += phase(phase_flash_decode_bhd, torch, timer, wcfg, wwork,
                 WHISPER_CACHE)
    phase(phase_greedy, torch, timer, wcfg, ec, [STATIC_BATCH])
    w_launches = phase(phase_serve_static, torch, wcfg, True)
    wt = phase(phase_train, torch, WHISPER_TRAIN_ARGV)
    for name in ("flash_attention", "flash_decode", "greedy_sample"):
        launches[name] += w_launches[name]
    launches["fused_sgd_update"] += (rt["launches"]["fused_sgd_update"]
                                     + wt["launches"]["fused_sgd_update"])
    # the last four LM configs: kernels 1, 2, 6 and 7 at h2o's head dim
    # 120, 6 and 7 at llava's G = 7 (over its image prefix), 1 and 2 at
    # the engine's layouts of minicpm (G = 1 over 36 kv heads, hd 64),
    # dbrx (G = 6 over 8) and llava (G = 7 over 8), kernel 3 at their
    # vocabularies (kernel 4's are in phase_gumbel); then each
    # served, h2o and llava also through the static path, sharing one
    # init.  lm_launches: each config's main-path launches
    top = ec.decode_buckets[0]
    hwork = workload(hcfg.vocab_size, SEED)
    lwork = workload(lcfg.vocab_size, SEED)
    fd_h = phase(phase_flash_decode, torch, timer, hcfg, ec)
    dv_h = phase(phase_decode_view, torch, timer, hcfg, ec)
    fa_h = phase(phase_flash_attention, torch, timer, hcfg, hwork)
    fdb_h = phase(phase_flash_decode_bhd, torch, timer, hcfg, hwork)
    # llava's prefills (8 x 3,392 positions): a median of 5 launches,
    # its f32 plain version alone is 41 GB of scores and probabilities
    fa_l = phase(phase_flash_attention, torch, Timer(torch, iters=5), lcfg,
                 lwork)
    fdb_l = phase(phase_flash_decode_bhd, torch, timer, lcfg, lwork)
    paged = (ccfg, bcfg, lcfg)
    fd_lm = {c.name: phase(phase_flash_decode, torch, timer, c, ec)
             for c in paged}
    dv_lm = {c.name: phase(phase_decode_view, torch, timer, c, ec)
             for c in paged}
    gs_lm = {c.name: phase(phase_greedy, torch, timer, c, ec, [top])
             for c in lms}
    lm_launches = {c.name: phase(phase_serve_lm, torch, c)
                   for c in (ccfg, bcfg)}
    for c, f32_equal in ((hcfg, True), (lcfg, False)):
        _, params = _init_params(torch, c)
        lm_launches[c.name] = phase(phase_serve_lm, torch, c, params)
        static = phase(phase_serve_static, torch, c, f32_equal, params)
        for name in ("flash_attention", "flash_decode", "greedy_sample"):
            lm_launches[c.name][name] += static[name]
        del params
    for counts in lm_launches.values():
        for name, n in counts.items():
            launches[name] += n
    fd += fd_h + [r for c in paged for r in fd_lm[c.name]]
    dv += dv_h + [r for c in paged for r in dv_lm[c.name]]
    fa += fa_h + fa_l
    fdb += fdb_h + fdb_l
    # tensor-parallel serving: the kernels at one shard's layouts (qwen2
    # H 6 / KV 1, recurrentgemma H 5 / KV 1 at hd 256, mamba 16 heads,
    # deepseek 64 MLA heads; kernels 3 and 4 sample the full rows, one
    # engine's layouts), then qwen2-1.5b at full width over two shards
    # (bf16, then float32 against one engine) and the other paged
    # families at TP_LAYERS; tp_launches: the slice's main-path runs'
    devices = tp_devices(torch)
    qs, rs, ms, ds = (shard_layout(c) for c in (cfg, rcfg, mcfg, dcfg))
    fd_tq = phase(phase_flash_decode, torch, timer, qs, ec)
    dv_tq = phase(phase_decode_view, torch, timer, qs, ec)
    fd_tr = phase(phase_flash_decode, torch, timer, rs, ec)
    dv_tr = phase(phase_decode_view, torch, timer, rs, ec)
    st_tp = phase(phase_slot_state, torch, timer, ms, ec)
    ssd_tp, ssd_tp_launches = phase(phase_ssd_chunk, torch, timer, ms, ec)
    mv_tp = phase(phase_mla, torch, timer, ds, ec, False)
    mp_tp = phase(phase_mla, torch, timer, ds, ec, True)
    tcfg = cfg.replace(num_layers=TP_LAYERS[QWEN2])
    tp_launches = phase(phase_serve_tp, torch, tcfg, devices)
    phase(phase_tp_f32, torch, tcfg, devices)
    for c in (mcfg, dcfg, rcfg):
        counts = phase(phase_serve_tp, torch,
                       c.replace(num_layers=TP_LAYERS[c.name]), devices,
                       ((1, False), (8, True)))
        for name, n in counts.items():
            tp_launches[name] += n
    for name, n in tp_launches.items():
        launches[name] += n
    for argv in LM_TRAIN_ARGVS:
        out = phase(phase_train, torch, argv)
        launches["fused_sgd_update"] += out["launches"]["fused_sgd_update"]
    # training over a mesh: dbrx-132b's FSDP / expert-parallel step at
    # DBRX_TRAIN_LAYERS (then kernel 5 over its training state),
    # mamba2-370m uncut through the launcher, and the FSDP step against
    # the launcher's in float32
    dbrx_tr, fu_dbrx = phase(phase_dbrx_train, torch, Timer(torch, iters=10))
    mamba_tr = phase(phase_train, torch, MAMBA_TRAIN_ARGV)
    phase(phase_fsdp_parity, torch)
    # training along the model axis: float32 parity with one rank, then
    # qwen2-1.5b uncut in bf16 at model 2, then kernel 5 over one model
    # rank's shard
    tp_tr, fu_tp = phase(phase_tp_train, torch, Timer(torch, iters=10))
    train_launches = {DBRX: dbrx_tr["launches"]["fused_sgd_update"],
                      MAMBA: mamba_tr["launches"]["fused_sgd_update"],
                      "tp": tp_tr["launches"]}
    launches["fused_sgd_update"] += sum(train_launches.values())
    phase(phase_census, torch, cfg, mcfg, ec)

    def row(results, label):
        """The kernel's JSON numbers: times of the first case ``label``
        (qwen2's full decode bucket, or its static path's first batch),
        error the worst over every case of ``results`` (a kernel's first
        row: every config its phase ran at)."""
        pick = next(r for r in results if r["label"] == label)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return dict(max_abs_err=max(r["max_abs_err"] for r in results),
                    **{k: pick[k] for k in keys})

    src = "src/repro_torch/csrc"
    top = ec.decode_buckets[0]
    _, _, pmax0, gmax0 = static_batches(work)[0]
    s0 = pmax0 + gmax0
    rows = [
        dict(name="flash_decode_paged", route="cuda",
             source=f"{src}/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode.py:130",
             launches=launches["flash_decode_paged"],
             **row(fd, f"B={top} C=1")),
        dict(name="decode_view_attend", route="cuda",
             source=f"{src}/flash_decode.cu",
             replaces="src/repro/kernels/decode_view.py:84",
             launches=launches["decode_view_attend"],
             **row(dv, f"B={top}")),
        dict(name="greedy_sample", route="cuda", source=f"{src}/sampling.cu",
             replaces="src/repro/kernels/sampling.py:165",
             launches=launches["greedy_sample"], **gs[top]),
        dict(name="gumbel_sample", route="cuda", source=f"{src}/sampling.cu",
             replaces="src/repro/kernels/sampling.py:191",
             launches=launches["gumbel_sample"],
             **gb[(top, SAMPLE_TOP_K)]),
        dict(name="fused_sgd_update", route="cuda",
             source=f"{src}/fused_update.cu",
             replaces="src/repro/kernels/fused_update.py:43",
             launches=launches["fused_sgd_update"], **fu),
        # the fused decode step's call: one layer's SSD state pool
        dict(name="slot_gather", route="cuda", source=f"{src}/slot_state.cu",
             replaces="src/repro/kernels/slot_state.py:44",
             launches=launches["slot_gather"],
             **st[("state", 0, top)]["gather"]),
        dict(name="slot_scatter", route="cuda",
             source=f"{src}/slot_state.cu",
             replaces="src/repro/kernels/slot_state.py:69",
             launches=launches["slot_scatter"],
             **st[("state", 0, top)]["scatter"]),
        dict(name="ssd_chunk_bchp", route="cuda",
             source=f"{src}/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_chunk.py:54",
             launches=launches["ssd_chunk_bchp"],
             **ssd[SSD_CASES[0][0]]),
        dict(name="mla_decode_views", route="cuda",
             source=f"{src}/mla_decode.cu",
             replaces="src/repro/kernels/mla_decode.py:104",
             launches=launches["mla_decode_views"],
             **row(mv, f"B={top} C=1")),
        dict(name="mla_decode_paged", route="cuda",
             source=f"{src}/mla_decode.cu",
             replaces="src/repro/kernels/mla_decode.py:141",
             launches=launches["mla_decode_paged"],
             **row(mp, f"B={top} C=1")),
        # the static path's first batch, bf16; decode at a full cache
        dict(name="flash_attention", route="cuda",
             source=f"{src}/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:77",
             launches=launches["flash_attention"],
             **row(fa, fa[0]["label"])),
        dict(name="flash_decode", route="cuda",
             source=f"{src}/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode.py:179",
             launches=launches["flash_decode"],
             **row(fdb, f"S={s0} length={s0} bfloat16")),
    ]

    def lm_row(name, config, case, numbers):
        """A row of kernel ``name`` at one of the last four configs'
        shapes: ``case`` names them, launches are that config's
        main-path runs' (the kernel's first row counts every path's)."""
        base = next(r for r in rows if r["name"] == name)
        return dict(base, case=f"{config} {case}",
                    launches=lm_launches[config][name], **numbers)

    sl = lcfg.num_image_tokens + s0
    rows += [
        lm_row("flash_decode_paged", H2O, f"hd 120 B={top} C=1",
               row(fd_h, f"B={top} C=1")),
        lm_row("decode_view_attend", H2O, f"hd 120 B={top}",
               row(dv_h, f"B={top}")),
        lm_row("flash_attention", H2O, f"hd 120 {fa_h[0]['label']}",
               row(fa_h, fa_h[0]["label"])),
        lm_row("flash_decode", H2O, f"hd 120 S={s0} length={s0}",
               row(fdb_h, f"S={s0} length={s0} bfloat16")),
        lm_row("flash_decode_paged", MINICPM, f"G 1 hd 64 B={top} C=1",
               row(fd_lm[MINICPM], f"B={top} C=1")),
        lm_row("decode_view_attend", MINICPM, f"G 1 hd 64 B={top}",
               row(dv_lm[MINICPM], f"B={top}")),
        lm_row("flash_decode_paged", DBRX, f"G 6 KV 8 B={top} C=1",
               row(fd_lm[DBRX], f"B={top} C=1")),
        lm_row("decode_view_attend", DBRX, f"G 6 KV 8 B={top}",
               row(dv_lm[DBRX], f"B={top}")),
        lm_row("flash_decode_paged", LLAVA, f"G 7 B={top} C=1",
               row(fd_lm[LLAVA], f"B={top} C=1")),
        lm_row("decode_view_attend", LLAVA, f"G 7 B={top}",
               row(dv_lm[LLAVA], f"B={top}")),
        lm_row("flash_attention", LLAVA, f"G 7 {fa_l[0]['label']}",
               row(fa_l, fa_l[0]["label"])),
        lm_row("flash_decode", LLAVA, f"G 7 S={sl} length={sl}",
               row(fdb_l, f"S={sl} length={sl} bfloat16")),
    ]
    def tp_row(name, case, numbers):
        """A row of kernel ``name`` at one shard's layout of a TP slice:
        launches are the slice's main-path runs'."""
        base = next(r for r in rows if r["name"] == name)
        return dict(base, case=f"TP {TP} {case}",
                    launches=tp_launches[name], **numbers)

    rows += [
        tp_row("flash_decode_paged", f"qwen2-1.5b shard H 6 KV 1 B={top} C=1",
               row(fd_tq, f"B={top} C=1")),
        tp_row("decode_view_attend", f"qwen2-1.5b shard H 6 KV 1 B={top}",
               row(dv_tq, f"B={top}")),
        tp_row("flash_decode_paged",
               f"recurrentgemma-2b shard H 5 KV 1 hd 256 B={top} C=1",
               row(fd_tr, f"B={top} C=1")),
        tp_row("decode_view_attend",
               f"recurrentgemma-2b shard H 5 KV 1 hd 256 B={top}",
               row(dv_tr, f"B={top}")),
        tp_row("greedy_sample", f"qwen2-1.5b full rows B={top}", gs[top]),
        tp_row("gumbel_sample",
               f"qwen2-1.5b full rows B={top} top_k={SAMPLE_TOP_K}",
               gb[(top, SAMPLE_TOP_K)]),
        tp_row("slot_gather", f"mamba2-370m shard 16 heads state B={top}",
               st_tp[("state", 0, top)]["gather"]),
        tp_row("slot_scatter", f"mamba2-370m shard 16 heads state B={top}",
               st_tp[("state", 0, top)]["scatter"]),
        dict(tp_row("ssd_chunk_bchp", f"mamba2-370m shard 16 heads "
                    f"{SSD_CASES[0][0]}", ssd_tp[SSD_CASES[0][0]]),
             launches=ssd_tp_launches),
        tp_row("mla_decode_views", f"deepseek-v3 shard 64 heads B={top} C=1",
               row(mv_tp, f"B={top} C=1")),
        tp_row("mla_decode_paged", f"deepseek-v3 shard 64 heads B={top} C=1",
               row(mp_tp, f"B={top} C=1")),
    ]
    base5 = next(r for r in rows if r["name"] == "fused_sgd_update")
    rows += [
        dict(base5, case=f"{DBRX} {DBRX_TRAIN_LAYERS} layer training state "
             "(bf16 w, f32 m and g)", launches=train_launches[DBRX],
             **fu_dbrx),
        dict(base5, case=f"{MAMBA} leaves (bf16 w, f32 m and g)",
             launches=train_launches[MAMBA], **fu_sets[MAMBA]),
        dict(base5, case=f"{QWEN2} model-{TP_TRAIN} rank 0 shard (bf16 w, "
             "f32 m and g); launches: both ranks' bf16 run",
             launches=train_launches["tp"], **fu_tp)]
    for c in lms:
        rows += [lm_row("greedy_sample", c.name,
                        f"V {c.vocab_size} B={top}", gs_lm[c.name][top]),
                 lm_row("gumbel_sample", c.name,
                        f"V {c.vocab_size} B={top} top_k={SAMPLE_TOP_K}",
                        gb[(f"V={c.vocab_size}", top, SAMPLE_TOP_K)])]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
