"""DBRX-132B [hf:databricks/dbrx-base] — fine-grained MoE, 16 experts
top-4, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("dbrx-132b")
def dbrx_132b() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe", source="hf:databricks/dbrx-base",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=10752, vocab_size=100352,
        rope_theta=500_000.0,
        moe=MoEConfig(num_experts=16, num_experts_per_tok=4,
                      d_ff_expert=10752, capacity_factor=1.25),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, attn_impl="blocked")
