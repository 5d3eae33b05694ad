"""Config for llama-3.2-vision-11b (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("llama-3.2-vision-11b")
def llama32_vision_11b() -> ModelConfig:
    # 40L total = 32 self + 8 cross (one cross layer per 5)
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=5e5,
        cross_attn_every=5,
        num_image_tokens=1601,  # 1 tile of 560px: (560/14)^2 + 1
        frontend_dim=4096,  # stub vision encoder output, pre-projected width
        supports_long_context=False,
    )
