"""Config for whisper-base (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("whisper-base")
def whisper_base() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        num_layers=6,  # decoder layers
        encoder_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        use_rope=False,
        norm_type="ln",
        act_type="gelu",
        learned_pos=32768,  # decode_32k drives a 32k-position decoder
        encoder_seq=1500,  # 30 s of 10ms frames after conv stride (stub)
        supports_long_context=False,
    )
