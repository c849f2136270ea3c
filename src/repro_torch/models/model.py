"""Model interface of the port for the dense, MoE (GQA or MLA), ssm and
RG-LRU hybrid families, the vlm backbone, the encoder-decoder (audio)
family and ResNet (``repro/models/model.py``): ``build_model(cfg)``
returns a ``Model`` whose members are plain functions over a nested dict
of tensors.  The vlm family (llava) takes the decoder path: its
``forward`` and ``prefill`` accept ``image_embeds`` and ``loss`` reads
``batch["image_embeds"]``; its paged engine serves text alone, as the
reference's engine (whose requests carry no image) does.
ResNet trains only: its serving members are None, as the reference's
are.  The audio family (whisper) trains and serves through the static
entry point only: its forward and paged members and ``paged_spec`` are
None, as the reference gives it no paged engine; its ``prefill`` takes
a batch {"audio_embeds", "tokens"} in place of the tokens.

  init(seed, device)                        -> params
  forward(params, tokens, ...)              -> (logits, cache, aux, h)
  init_cache(batch, cache_len, device=...)  -> contiguous decode state
  prefill(params, tokens, cache_len[, image_embeds=])
                                            -> (logits, cache)
  decode_step(params, cache, tokens, pos)   -> (logits (B,V), cache)
  init_paged_cache(num_blocks, block_size, num_state_slots=...,
                   device=...)              -> K/V or slot-state pools
  paged_step(params, cache, slot_buf, tokens, block_tables, meta)
  paged_decode_loop(params, cache, slot_buf, block_tables, meta,
                    num_steps=N)
  loss(params, batch)                       -> (loss, metrics)
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, resnet, transformer


@dataclass(frozen=True)
class PagedSpec:
    """Paged-serving capability record (see the reference).  The dense
    family keeps per-token K/V block pools and no recurrent state, the
    MLA family per-token latent block pools (they page alike); the ssm
    family keeps one recurrent-state slot per sequence and no block
    pools (the engine still meters its tokens in host-side blocks); the
    RG-LRU hybrid keeps both, block pools for its local-attention layers
    and state slots for its recurrent ones.

      reclaim_window  positions after which a block is dead for every
                      block-pooled layer (the largest window, when every
                      such layer has one), else 0
      kernel_spec     which of the port's kernel wrappers serve each
                      layer kind's hot path: (kind, "view_op/paged_op")
                      pairs, named as in ``repro_torch.kernels``
    """
    has_blocks: bool
    has_state: bool
    reclaim_window: int = 0
    kernel_spec: Tuple[Tuple[str, str], ...] = ()

    @property
    def width1_mixed(self) -> bool:
        """Whether mixed prefill+decode steps may split prefill chunks
        into width-1 rows.  Recurrent state forbids it: token i+1's state
        depends on token i's within the same call, so a chunk stays one
        row."""
        return not self.has_state


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    paged_step: Optional[Callable] = None
    paged_decode_loop: Optional[Callable] = None
    paged_spec: Optional[PagedSpec] = None   # None: the model does not serve


def seeded_init(seed: int, device, *, cfg, init_params=transformer.init_params,
          **kw):
    """The params of ``cfg`` drawn from ``seed`` on ``device``; on the
    ``meta`` device, their shapes and dtypes only."""
    meta = torch.device(device).type == "meta"
    gen = torch.Generator(device="cpu" if meta else device)
    gen.manual_seed(seed)
    return init_params(cfg, gen, device, **kw)


def paged_spec(cfg: ModelConfig) -> PagedSpec:
    """The reference's rule: block pools for any (local) attention layer,
    state slots for any ssm / rglru layer, and the reclaim window the
    largest window when every block-pooled layer has one."""
    transformer.runs_of(cfg)                       # raises if not ported
    kinds = cfg.layer_kinds()
    windows = [transformer._layer_window(cfg, k) for k in kinds
               if k in transformer._ATTN_KINDS]
    kspec = {"sampling": "greedy_sample/gumbel_sample"}
    for k in set(kinds):
        if k in transformer._ATTN_KINDS:
            kspec[k] = ("mla_decode_views/mla_decode_paged" if cfg.mla
                        else "decode_view_attend/flash_decode_paged")
        else:
            kspec[k] = "slot_gather/slot_scatter"
    return PagedSpec(
        has_blocks=bool(windows),
        has_state=any(k in ("ssm", "rglru") for k in kinds),
        reclaim_window=(max(windows)
                        if windows and all(w > 0 for w in windows) else 0),
        kernel_spec=tuple(sorted(kspec.items())))


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "resnet":
        return Model(cfg=cfg,
                     init=functools.partial(seeded_init, cfg=cfg,
                                            init_params=resnet.init_params),
                     loss=functools.partial(resnet.loss, cfg=cfg))
    if cfg.family == "audio":
        return Model(cfg=cfg,
                     init=functools.partial(seeded_init, cfg=cfg,
                                            init_params=encdec.init_params),
                     loss=functools.partial(encdec.loss, cfg=cfg),
                     init_cache=functools.partial(encdec.init_cache, cfg),
                     prefill=functools.partial(encdec.prefill, cfg=cfg),
                     decode_step=functools.partial(encdec.decode_step,
                                                   cfg=cfg))
    spec = paged_spec(cfg)
    return Model(
        cfg=cfg,
        init=functools.partial(seeded_init, cfg=cfg),
        forward=functools.partial(transformer.forward, cfg=cfg),
        init_cache=functools.partial(transformer.init_cache, cfg),
        prefill=functools.partial(transformer.prefill, cfg=cfg),
        decode_step=functools.partial(transformer.decode_step, cfg=cfg),
        init_paged_cache=functools.partial(transformer.init_paged_cache, cfg),
        paged_step=functools.partial(transformer.paged_step, cfg=cfg),
        paged_decode_loop=functools.partial(transformer.paged_decode_loop,
                                            cfg=cfg),
        paged_spec=spec,
        loss=functools.partial(transformer.lm_loss, cfg=cfg))
