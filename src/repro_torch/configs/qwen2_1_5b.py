"""Qwen2-1.5B [arXiv:2407.10671] — dense GQA decoder with QKV bias."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-1.5b")
def qwen2_1_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense", source="arXiv:2407.10671",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        head_dim=128, d_ff=8960, vocab_size=151936,
        qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, attn_impl="blocked")


@register("qwen2-1.5b-swa")
def qwen2_1_5b_swa() -> ModelConfig:
    """Sliding-window variant (the reference's dense->SWA carve-in)."""
    return qwen2_1_5b().replace(name="qwen2-1.5b-swa", sliding_window=4096)
