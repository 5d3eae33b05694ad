"""Config for zamba2-2.7b (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("zamba2-2.7b")
def zamba2_27b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,  # mamba2 blocks; shared attention every 6
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        attn_every=6,
        supports_long_context=True,  # SSM backbone; attention is periodic
    )
