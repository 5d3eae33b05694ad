"""Config for llama4-maverick-400b-a17b (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("llama4-maverick-400b-a17b")
def llama4_maverick_400b() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,  # per-expert
        vocab_size=202048,
        num_experts=128,
        top_k=1,
        rope_theta=5e5,
        supports_long_context=False,
    )
