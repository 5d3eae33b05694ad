"""Config for phi3-medium-14b (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("phi3-medium-14b")
def phi3_medium_14b() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=1e4,
    )
