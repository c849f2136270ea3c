"""ResNet-50 [He et al. 2016] — the paper's own experimental model
(LSGD/CSGD on ImageNet, paper Section 5)."""
from repro_torch.configs.base import ModelConfig, register


@register("resnet50")
def resnet50() -> ModelConfig:
    return ModelConfig(
        name="resnet50", family="resnet", source="paper §5 / He et al. 2016",
        num_layers=50, d_model=2048, num_heads=0, num_kv_heads=0,
        head_dim=1, d_ff=0, vocab_size=1000,
        param_dtype="float32", compute_dtype="float32")
