"""RecurrentGemma-2B [arXiv:2402.19427] — Griffin hybrid: RG-LRU recurrent
blocks and local (2048-window) MQA attention in a 2:1 pattern."""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register


@register("recurrentgemma-2b")
def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", source="arXiv:2402.19427",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        activation="gelu", tie_embeddings=True,
        layer_pattern=("rglru", "rglru", "local_attn"),
        rglru=RGLRUConfig(lru_width=2560, conv_kernel=4, gate_c=8.0,
                          local_window=2048),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, attn_impl="blocked")
