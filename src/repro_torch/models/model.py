"""Model interface of the port for the dense family
(``repro/models/model.py``): ``build_model(cfg)`` returns a ``Model``
whose members are plain functions over a nested dict of tensors.

  init(seed, device)                        -> params
  forward(params, tokens, ...)              -> (logits, cache, h)
  init_paged_cache(num_blocks, block_size, device=...) -> K/V pools
  paged_step(params, cache, slot_buf, tokens, block_tables, meta)
  paged_decode_loop(params, cache, slot_buf, block_tables, meta,
                    num_steps=N)
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class PagedSpec:
    """Paged-serving capability record (see the reference).  The dense
    family keeps per-token K/V block pools and no recurrent state.

      reclaim_window  positions after which a block is dead for every
                      layer (the sliding window, when every layer has
                      one), else 0
      kernel_spec     which of the port's kernel wrappers serve each
                      layer kind's hot path: (kind, "view_op/paged_op")
                      pairs, named as in ``repro_torch.kernels``
    """
    has_blocks: bool
    has_state: bool
    reclaim_window: int = 0
    kernel_spec: Tuple[Tuple[str, str], ...] = ()


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_paged_cache: Callable
    paged_step: Callable
    paged_decode_loop: Callable
    paged_spec: PagedSpec


def _init(seed: int, device, *, cfg):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return transformer.init_params(cfg, gen, device)


def build_model(cfg: ModelConfig) -> Model:
    transformer.runs_of(cfg)            # raises for families not ported
    spec = PagedSpec(
        has_blocks=True, has_state=False,
        reclaim_window=cfg.sliding_window,
        kernel_spec=(("attn", "decode_view_attend/flash_decode_paged"),
                     ("sampling", "greedy_sample")))
    return Model(
        cfg=cfg,
        init=functools.partial(_init, cfg=cfg),
        forward=functools.partial(transformer.forward, cfg=cfg),
        init_paged_cache=functools.partial(transformer.init_paged_cache, cfg),
        paged_step=functools.partial(transformer.paged_step, cfg=cfg),
        paged_decode_loop=functools.partial(transformer.paged_decode_loop,
                                            cfg=cfg),
        paged_spec=spec)
