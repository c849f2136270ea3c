"""Config system of the port: ``ModelConfig``, the registry and
``smoke_variant``, field for field as in ``repro/configs/base.py`` so a
config converts between the two packages by ``dataclasses.asdict``.

Dtypes stay strings in the dataclass (so a config compares equal to the
reference's); ``pdtype``/``cdtype`` return ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"
    first_k_dense: int = 0


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0
    conv_kernel: int = 4
    gate_c: float = 8.0
    local_window: int = 2048


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"   # dense | moe | ssm | hybrid | audio | vlm | resnet
    source: str = ""

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0       # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000

    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    activation: str = "swiglu"
    tie_embeddings: bool = False
    max_position_embeddings: int = 1 << 20

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    layer_pattern: Tuple[str, ...] = ()
    mtp_depth: int = 0

    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500

    num_image_tokens: int = 0

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    scan_layers: bool = True
    # kept for field parity with the reference; the port's cache paths
    # always go through its kernel wrappers (plain version on the CPU)
    attn_impl: str = "naive"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    loss_chunk: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def layer_kinds(self) -> Tuple[str, ...]:
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.layer_pattern:
            pat = self.layer_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return ("attn",) * self.num_layers

    def ffn_kinds(self) -> Tuple[str, ...]:
        if self.moe is None:
            return ("dense",) * self.num_layers
        k = self.moe.first_k_dense
        return tuple("dense" if i < k else "moe"
                     for i in range(self.num_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, Any] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available_archs() -> Sequence[str]:
    _load_all()
    return sorted(_REGISTRY)


def get_config(name: str, **overrides) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def _load_all():
    # every arch the reference registers
    from repro_torch.configs import (dbrx_132b,  # noqa: F401
                                     deepseek_v3_671b, h2o_danube_3_4b,
                                     llava_next_34b, mamba2_370m, minicpm_2b,
                                     qwen1_5_0_5b, qwen2_1_5b,
                                     recurrentgemma_2b, resnet50,
                                     whisper_tiny)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (the reference's
    rule: 2 layers, d_model<=256, <=4 heads, vocab<=512, f32)."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.num_heads, 4) or 4
    head_dim = max(d_model // n_heads, 16)
    n_kv = min(cfg.num_kv_heads, n_heads) or n_heads
    if cfg.num_kv_heads == 1:
        n_kv = 1
    kw: Dict[str, Any] = dict(
        num_layers=2 if not cfg.layer_pattern else len(cfg.layer_pattern),
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
        scan_layers=cfg.scan_layers,
        attn_impl="naive",
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        mtp_depth=cfg.mtp_depth,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            num_experts_per_tok=min(cfg.moe.num_experts_per_tok, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 256),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
        kw["head_dim"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, chunk_size=32)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(
            cfg.rglru, lru_width=d_model, local_window=64)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 2
        kw["encoder_seq_len"] = 32
    if cfg.num_image_tokens:
        kw["num_image_tokens"] = 16
    return cfg.replace(name=cfg.name + "-smoke", **kw)
