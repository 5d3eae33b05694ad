"""Config for xlstm-350m (exact values from the assignment table)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@register("xlstm-350m")
def xlstm_350m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,  # 12 cycles of (mLSTM, sLSTM)
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        head_dim=256,
        d_ff=0,  # blocks carry their own projections
        vocab_size=50304,
        use_rope=False,
        norm_type="ln",
        tie_embeddings=True,
        mlstm_chunk=256,
        supports_long_context=True,  # recurrent state: O(1) per token
    )
