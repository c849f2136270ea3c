"""Data pipeline (a copy of ``repro/data/pipeline.py``, numpy only):
deterministic synthetic shards + a prefetching host loader with a
configurable I/O latency.

The I/O latency knob matters for this paper: LSGD's whole win is hiding
the inter-group all-reduce under data-loading time (paper §4.1, Fig. 2-6),
so the benchmark harness sweeps ``io_latency_s`` to reproduce the
overlap/no-overlap regimes quantitatively.

Data is synthetic but *deterministically partitioned* the way the paper
partitions ImageNet: a global minibatch M_t is a pure function of
(seed, step), and worker i's shard M_t^i is rows [i*B/N, (i+1)*B/N) — the
same partition the equivalence tests feed to Alg. 1/2/3.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    kind: str = "lm"            # lm | image | audio | vlm
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    d_model: int = 0            # for stub-embedding modalities
    encoder_seq_len: int = 0    # audio frames
    num_image_tokens: int = 0   # vlm patches
    image_size: int = 224
    num_classes: int = 1000
    # token distribution: "zipf" gives the CE something to learn (unigram
    # entropy < log V); "uniform" for shape-only workloads
    distribution: str = "zipf"


_ZIPF_CACHE: Dict[int, np.ndarray] = {}


def _zipf_probs(vocab: int) -> np.ndarray:
    if vocab not in _ZIPF_CACHE:
        p = 1.0 / np.arange(3, vocab + 3) ** 1.1
        _ZIPF_CACHE[vocab] = p / p.sum()
    return _ZIPF_CACHE[vocab]


def synth_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The global minibatch M_t — pure function of (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b = cfg.global_batch
    if cfg.kind == "lm":
        if cfg.distribution == "zipf":
            toks = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len),
                              p=_zipf_probs(cfg.vocab_size)).astype(np.int32)
            return {"tokens": toks}
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, cfg.seq_len),
                                       dtype=np.int32)}
    if cfg.kind == "vlm":
        s_txt = cfg.seq_len - cfg.num_image_tokens
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s_txt),
                                       dtype=np.int32),
                "image_embeds": rng.standard_normal(
                    (b, cfg.num_image_tokens, cfg.d_model),
                    dtype=np.float32)}
    if cfg.kind == "audio":
        return {"audio_embeds": rng.standard_normal(
                    (b, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (b, cfg.seq_len),
                                       dtype=np.int32)}
    if cfg.kind == "image":
        return {"images": rng.standard_normal(
                    (b, cfg.image_size, cfg.image_size, 3),
                    dtype=np.float32),
                "labels": rng.integers(0, cfg.num_classes, (b,),
                                       dtype=np.int32)}
    raise ValueError(cfg.kind)


def data_config_for(model_cfg, shape_cfg, seed: int = 0) -> DataConfig:
    kind = {"resnet": "image", "audio": "audio", "vlm": "vlm"}.get(
        model_cfg.family, "lm")
    return DataConfig(
        kind=kind, vocab_size=model_cfg.vocab_size,
        seq_len=shape_cfg.seq_len, global_batch=shape_cfg.global_batch,
        seed=seed, d_model=model_cfg.d_model,
        encoder_seq_len=model_cfg.encoder_seq_len,
        num_image_tokens=model_cfg.num_image_tokens,
        num_classes=model_cfg.vocab_size)


class HostLoader:
    """Background prefetch queue with simulated storage latency.

    ``io_latency_s`` models the per-batch disk/decode time the paper's
    workers spend loading JPEGs — the slack LSGD hides collectives in.
    """

    def __init__(self, cfg: DataConfig, *, prefetch: int = 2,
                 io_latency_s: float = 0.0,
                 transform: Optional[Callable] = None):
        self.cfg = cfg
        self.io_latency_s = io_latency_s
        self.transform = transform
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            if self.io_latency_s:
                time.sleep(self.io_latency_s)
            batch = synth_batch(self.cfg, step)
            if self.transform:
                batch = self.transform(batch)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._stop.is_set():
            raise StopIteration
        return self._q.get()

    def close(self):
        """Idempotent, race-free shutdown.

        The worker may be parked in ``put`` when the stop flag is set, so
        a single drain can land *before* its final put and leave it
        blocked (or leak a batch).  Instead: keep draining until the
        worker has actually observed the flag and exited, then empty
        whatever its last put left behind.
        """
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.02)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "HostLoader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
