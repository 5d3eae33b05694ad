"""Config for qwen2-1.5b (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("qwen2-1.5b")
def qwen2_15b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1e6,
        tie_embeddings=True,
    )
