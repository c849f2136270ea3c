"""DeepSeek-V3-671B [arXiv:2412.19437] — MLA attention, 1 shared + 256
routed experts (top-8), multi-token prediction, first 3 layers dense."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                     register)


@register("deepseek-v3-671b")
def deepseek_v3_671b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", source="arXiv:2412.19437",
        num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
        head_dim=128,
        d_ff=18432,              # dense-FFN width of the first 3 layers
        vocab_size=129280, rope_theta=10000.0,
        moe=MoEConfig(num_experts=256, num_experts_per_tok=8,
                      num_shared_experts=1, d_ff_expert=2048,
                      capacity_factor=1.25, first_k_dense=3),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        mtp_depth=1,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, attn_impl="blocked")
