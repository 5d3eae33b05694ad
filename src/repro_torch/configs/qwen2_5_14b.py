"""Config for qwen2.5-14b (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("qwen2.5-14b")
def qwen25_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
    )
