"""Whisper-tiny [arXiv:2212.04356]: encoder-decoder; the conv/mel audio
frontend is a stub, the encoder reads precomputed frame embeddings (B,
1500, d_model)."""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-tiny")
def whisper_tiny() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio", source="arXiv:2212.04356",
        num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
        head_dim=64, d_ff=1536, vocab_size=51865,
        is_encoder_decoder=True, encoder_layers=4, encoder_seq_len=1500,
        norm="layernorm", activation="gelu", tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16")
