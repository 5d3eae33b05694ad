"""Model configuration (port of ``repro/models/config.py``).

The same frozen dataclass with the same fields and defaults, so a config
of the port equals the reference's field by field; ``pdtype`` and
``cdtype`` return torch dtypes. Exact per-architecture values live in
``repro_torch.configs.<id>``.

Fields that only steer JAX (``scan_layers``, ``ablate_attn_scores``)
are kept and ignored: the port runs its layers in a Python loop,
eagerly. ``sharding_profile`` names the rules of a mesh
(``distributed/sharding.PROFILES``). ``remat`` means what it means there:
under autograd each layer's activations are recomputed in the backward
(``torch.utils.checkpoint``; ``models/transformer.py``).
``attn_kv_block`` and ``use_blockwise_attn`` were VMEM sizes and a switch
between two renderings of one function; the port's flash kernel computes
that function with its own tiles, so they are kept for field equality and
ignored. ``attn_q_block`` is the query block of attention's backward
(``models/layers.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    norm_type: str = "rms"  # rms | ln
    act_type: str = "swiglu"  # swiglu | gelu
    use_rope: bool = True
    learned_pos: int = 0  # >0: learned absolute positions (whisper)

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "pb"  # pb (counting-sort dispatch) | einsum
    moe_dispatch_method: str = "sort"

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: shared attention block every N ssm blocks
    mlstm_chunk: int = 64  # xlstm chunkwise-parallel width

    # VLM
    cross_attn_every: int = 0  # vision: one cross-attn layer every N layers
    num_image_tokens: int = 0
    frontend_dim: int = 0  # stub frontend embedding width (0 = d_model)

    # enc-dec
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub audio-frame count for whisper

    # numerics / memory
    pb_embedding: bool = True  # PB embedding backward (training only)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    remat: bool = True  # recompute each layer in the backward
    scan_layers: bool = True  # JAX only
    attn_q_block: int = 512  # query rows of one step of attention's backward
    attn_kv_block: int = 1024  # ignored by the port
    use_blockwise_attn: bool = True  # ignored by the port
    attn_tile_f32: bool = True  # score tiles in f32 (False: the compute dtype)
    ablate_attn_scores: bool = False  # JAX probe only
    moe_weight_stationary_decode: bool = False
    sharding_profile: str = "tp_fsdp"  # JAX only
    loss_chunk: int = 512  # sequence chunking of the softmax-xent
    logit_softcap: float = 0.0

    # which shapes this arch supports (long_500k only for sub-quadratic)
    supports_long_context: bool = False
    is_decoder: bool = True

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (tests/CPU)."""
        small = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) or 2,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            vocab_pad_multiple=64,
            num_experts=min(self.num_experts, 8),
            top_k=min(self.top_k, 2),
            capacity_factor=8.0,  # no token drops: decode == train numerics
            ssm_state=min(self.ssm_state, 16),
            num_image_tokens=min(self.num_image_tokens, 16),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            param_dtype="float32",
            compute_dtype="float32",
            attn_q_block=32,
            attn_kv_block=32,
            mlstm_chunk=16,
            remat=False,
        )
        # keep block-pattern periods consistent with reduced layer counts
        if self.attn_every:
            small["attn_every"] = 2
            small["num_layers"] = 4
        if self.cross_attn_every:
            small["cross_attn_every"] = 2
            small["num_layers"] = 4
        if self.family == "ssm":
            small["num_layers"] = 4
        small.update(overrides)
        return dataclasses.replace(self, **small)


def flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS/token ~= 6*N_active (matmul params only)."""
    d, hd = cfg.d_model, cfg.head_dim
    qk = cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd + cfg.num_heads * hd
    attn_proj = d * qk
    if cfg.num_experts:
        ffn = cfg.top_k * 3 * d * cfg.d_ff
    elif cfg.d_ff:
        ffn = 3 * d * cfg.d_ff
    else:  # xlstm-style: in/out projections approx 4*d*d
        ffn = 4 * d * d
    per_layer = attn_proj + ffn
    embed = 2 * d * cfg.padded_vocab  # logits matmul counted once
    n_active = cfg.num_layers * per_layer + embed // 2
    return 6.0 * n_active
