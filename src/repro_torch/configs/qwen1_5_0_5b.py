"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense MHA decoder with QKV bias."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-0.5b")
def qwen1_5_0_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense", source="hf:Qwen/Qwen1.5-0.5B",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=2816, vocab_size=151936,
        qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, attn_impl="blocked")
