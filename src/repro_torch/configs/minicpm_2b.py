"""MiniCPM-2B [arXiv:2404.06395] — llama-like dense decoder; its WSD
(warmup-stable-decay) LR schedule is implemented in repro_torch.optim.schedules."""
from repro_torch.configs.base import ModelConfig, register


@register("minicpm-2b")
def minicpm_2b() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense", source="arXiv:2404.06395",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        head_dim=64, d_ff=5760, vocab_size=122753,
        rope_theta=10000.0, tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, attn_impl="blocked")
