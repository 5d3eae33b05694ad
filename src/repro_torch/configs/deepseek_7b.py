"""Config for deepseek-7b (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("deepseek-7b")
def deepseek_7b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11008,
        vocab_size=102400,
        rope_theta=1e4,
    )
