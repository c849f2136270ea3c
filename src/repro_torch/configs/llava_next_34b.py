"""LLaVA-NeXT-34B backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf lineage] —
the language decoder consuming anyres-tiled patch embeddings.  The
ViT/SigLIP vision tower + projector are a STUB per the assignment:
the data pipeline supplies (B, 2880, d_model) patch embeddings
(base tile + 4 anyres sub-tiles x 576 patches).

The widths are those of the published LLaVA-v1.6-34B
(hf:llava-hf/llava-v1.6-34b-hf), whose language model is a Yi-34B
(Nous-Hermes-2-Yi-34B); ``source`` keeps the reference config's string,
which names the 7B Mistral checkpoint of the same family."""
from repro_torch.configs.base import ModelConfig, register


@register("llava-next-34b")
def llava_next_34b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=20480, vocab_size=64000,
        rope_theta=5_000_000.0,
        num_image_tokens=2880,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, attn_impl="blocked")
