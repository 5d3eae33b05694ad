"""Config for qwen3-moe-235b-a22b (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("qwen3-moe-235b-a22b")
def qwen3_moe_235b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,  # per-expert
        vocab_size=151936,
        num_experts=128,
        top_k=8,
        rope_theta=1e6,
        supports_long_context=False,
    )
