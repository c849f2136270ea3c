"""Mamba2-370M [arXiv:2405.21060] — attention-free SSM with SSD
(state-space duality) chunked training."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("mamba2-370m")
def mamba2_370m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm", source="arXiv:2405.21060",
        num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
        head_dim=64, d_ff=0, vocab_size=50280,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                      conv_kernel=4, chunk_size=256),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True)
