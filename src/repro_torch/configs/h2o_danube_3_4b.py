"""H2O-Danube3-4B [arXiv:2401.16818] — llama+mistral mix with sliding-
window attention (window 4096); SWA makes long_500k decode tractable."""
from repro_torch.configs.base import ModelConfig, register


@register("h2o-danube-3-4b")
def h2o_danube_3_4b() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense", source="arXiv:2401.16818",
        num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
        head_dim=120, d_ff=10240, vocab_size=32000,
        rope_theta=10000.0, sliding_window=4096,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, attn_impl="blocked")
