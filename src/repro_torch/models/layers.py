"""Dense-LM layers (port of the dense half of ``repro/models/layers.py``):
norms, RoPE, GQA attention with a KV cache, MLPs, the embedding and the
logits, with the PB embedding backward (``_pb_take``). The GNN half
lives in ``models/gnn.py``; MoE waits for ROADMAP Queue 1 item 2.

Parameters live in small ``nn.Module``s whose attribute names are the
reference's keys (``w``/``b`` of a norm; ``wq``, ``wk``, ``wv``, ``wo`` and
``bq``, ``bk``, ``bv`` of attention; ``w1``, ``w3``, ``w2`` or ``w1``,
``b1``, ``w2``, ``b2`` of an MLP; ``table``, ``unembed``, ``pos`` of the
embedding), in the reference's layouts: a projection is ``x @ w`` with
``w`` of shape ``(in, out)``. The functions take those modules where the
reference takes its parameter dicts. Shapes are the reference's:
activations ``(B, S, d)``, heads ``(B, S, H, hd)``, caches
``(B, S_max, KH, hd)``.

Attention routing. Multi-token causal self-attention of S new tokens
over those tokens' own keys and values (the reference's
``blockwise_attention`` branch, and its ``_direct_attention`` branch with
``q_offset == 0`` and ``Sq > 1``, with or without a cache) runs
``kernels.flash_attention``: the CUDA kernel on the card, its plain
version on the CPU, so the CPU tests cover the routing the card runs.
Decode (one token at ``cache_index`` against the whole cache) stays plain
torch, as ``_direct_attention`` is plain jnp in the reference.
``cfg.attn_kv_block`` / ``use_blockwise_attn`` chose between two
renderings of one function there; the port ignores them (the kernel's
tiles are fixed), so every such call takes the kernel.
``cfg.attn_q_block`` is the query rows of one step of the kernel's
backward (the plain function's gradient, recomputed block by block:
``kernels.flashattn.attention_grads``), as it is the query block of the
reference's differentiated loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.executor import execute_reduce
from repro_torch.kernels.flashattn import MASKED, flash_attention
from repro_torch.models.config import ModelConfig

Cache = Tuple[torch.Tensor, torch.Tensor]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm weight ``w`` (ones at init); LayerNorm adds a bias ``b``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.w = _param((cfg.d_model,), torch.float32, device)
        self.b = _param((cfg.d_model,), torch.float32, device) if cfg.norm_type == "ln" else None


def apply_norm(p: Norm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """In float32, cast back to x's dtype."""
    xf = x.float()
    if cfg.norm_type == "ln":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * p.w + p.b).to(x.dtype)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + cfg.norm_eps) * p.w).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, ..., head_dim); positions: (B, S). Angles in float32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    while ang.ndim < x.ndim:
        ang = ang.unsqueeze(-2)  # broadcast over head dims
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; the flash kernel for multi-token steps, KV-cache decode)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd, H, KH = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        dt = cfg.pdtype
        self.wq = _param((d, H * hd), dt, device)
        self.wk = _param((d, KH * hd), dt, device)
        self.wv = _param((d, KH * hd), dt, device)
        self.wo = _param((H * hd, d), dt, device)
        bias = cfg.qkv_bias
        self.bq = _param((H * hd,), dt, device) if bias else None
        self.bk = _param((KH * hd,), dt, device) if bias else None
        self.bv = _param((KH * hd,), dt, device) if bias else None


def _qkv(p: Attention, x, cfg: ModelConfig, positions):
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.cdtype
    xx = x.to(dt)
    q = xx @ p.wq.to(dt)
    k = xx @ p.wk.to(dt)
    v = xx @ p.wv.to(dt)
    if p.bq is not None:
        q, k, v = q + p.bq.to(dt), k + p.bk.to(dt), v + p.bv.to(dt)
    B, S = x.shape[:2]
    q = q.view(B, S, H, hd)
    k = k.view(B, S, KH, hd)
    v = v.view(B, S, KH, hd)
    if cfg.use_rope and positions is not None:
        # queries only: the reference turns keys by ``kv_positions``, which
        # its self-attention never passes (ROADMAP Queue 3)
        q = rope(q, positions, cfg.rope_theta)
    return q, k, v


def _direct_attention(q, k, v, causal: bool, q_offset=0, tile_f32: bool = True):
    """Plain attention of q: (B, Sq, H, hd) against k, v: (B, Skv, KH, hd)
    with the causal mask on absolute positions (queries from q_offset);
    returns (B, Sq, H * hd). Scores in float32 (``tile_f32``) or q's dtype,
    softmax in float32, weights cast to v's dtype."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, hd)
    sdt = torch.float32 if tile_f32 else q.dtype
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(sdt), k.to(sdt)) * hd**-0.5
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(mask, scores, torch.full((), MASKED, dtype=sdt, device=q.device))
    w = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H * hd)


def blockwise_attention(q, k, v, *, causal, q_block: int = 512):
    """Attention of q: (B, S, H, hd) over k, v: (B, Skv, KH, hd) with both
    position ranges starting at 0, through the flash kernel; returns
    (B, S, H * hd). The reference's online-softmax loop computes the same
    function; the kernel reads the (B, S, heads, hd) layout in place and
    writes its output in that layout. The kernel keeps its scores in
    float32 whatever ``cfg.attn_tile_f32`` says. ``q_block``: the query
    rows of one backward step."""
    B, S, H, hd = q.shape
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, q_block=q_block
    )
    return out.transpose(1, 2).reshape(B, S, H * hd)


def attention_apply(
    p: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
    cache_index: Optional[int] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Self-attention. ``cache``: (k_cache, v_cache) of shape
    (B, S_max, KH, hd), written in place (the reference returns updated
    copies; the port saves the copy) and returned. One token is written at
    ``cache_index`` and attends over the whole cache under the causal mask
    (decode); a multi-token step is written at 0 (prefill). RoPE turns
    the queries by ``positions`` and leaves the keys as they are, which is
    the reference's function (ROADMAP Queue 3)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    new_cache = None
    if cache is not None:
        if cache_index is None:
            raise ValueError("a cache needs a cache_index: cross-attention is not in the dense port")
        kc, vc = cache
        if S == 1:
            # decode. The reference's one-hot write drops a write at or past
            # S_max; so does this one, so that the tokens stay the reference's.
            if cache_index < kc.shape[1]:
                kc[:, cache_index] = k[:, 0]
                vc[:, cache_index] = v[:, 0]
            out = _direct_attention(
                q, kc.to(q.dtype), vc.to(q.dtype), causal=causal,
                q_offset=cache_index, tile_f32=cfg.attn_tile_f32,
            )
        else:
            if cache_index != 0 or S > kc.shape[1]:
                raise ValueError(
                    f"a multi-token step is a prefill: it starts at index 0 and fits the "
                    f"cache; got index {cache_index}, {S} tokens, S_max {kc.shape[1]}"
                )
            kc[:, :S] = k
            vc[:, :S] = v
            # The reference attends over the whole S_max cache here, under the
            # causal mask. Every cache row at or past S is masked for every
            # query (its score is -1e30 and exp(-1e30 - m) is exactly 0 in
            # float32), so attending over the prompt's own k and v gives the
            # same result: that is what the kernel computes.
            out = blockwise_attention(q, k, v, causal=causal, q_block=cfg.attn_q_block)
        new_cache = (kc, vc)
    elif S > 1:
        out = blockwise_attention(q, k, v, causal=causal, q_block=cfg.attn_q_block)
    else:
        out = _direct_attention(q, k, v, causal=causal, tile_f32=cfg.attn_tile_f32)
    dt = cfg.cdtype
    y = out.to(dt) @ p.wo.to(dt)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
        self.w1 = _param((d, f), dt, device)
        self.w2 = _param((f, d), dt, device)
        if cfg.act_type == "swiglu":
            self.w3 = _param((d, f), dt, device)
            self.b1 = self.b2 = None
        else:
            self.w3 = None
            self.b1 = _param((f,), dt, device)
            self.b2 = _param((d,), dt, device)


def mlp_apply(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.cdtype
    xx = x.to(dt)
    if p.w3 is not None:
        h = F.silu(xx @ p.w1.to(dt)) * (xx @ p.w3.to(dt))
        return (h @ p.w2.to(dt)).to(x.dtype)
    h = F.gelu(xx @ p.w1.to(dt) + p.b1.to(dt), approximate="tanh")  # jax.nn.gelu's default
    return (h @ p.w2.to(dt) + p.b2.to(dt)).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        V, d, dt = cfg.padded_vocab, cfg.d_model, cfg.pdtype
        self.table = _param((V, d), dt, device)
        self.pos = _param((cfg.learned_pos, d), dt, device) if cfg.learned_pos else None
        self.unembed = None if cfg.tie_embeddings else _param((d, V), dt, device)


class _PBTake(torch.autograd.Function):
    """``table[ids]`` whose backward is a PB reduction (reference
    ``_pb_take``, ``layers.py:327-352``): the embedding gradient is a
    commutative scatter-add of the (tokens, d) cotangent rows over the
    vocabulary, the canonical fused PB stream (DESIGN.md §8), so it runs
    ``execute_reduce(method="fused")``: the rows kernel
    (``cobra_bin_accumulate_rows``) on CUDA tensors, its plain version on
    CPU ones. Rows accumulate in float32 in token order and the table's
    gradient is cast to its dtype; the ids get none."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat_ids = ids.reshape(-1).to(torch.int32)
        flat_g = g.reshape(-1, g.shape[-1]).float().contiguous()
        dtable = execute_reduce(flat_ids, flat_g, out_size=ctx.vocab, op="add", method="fused")
        return dtable.to(ctx.dtype), None


_pb_take = _PBTake.apply  # (table, ids) -> table[ids]


def embed_apply(p: Embedding, ids: torch.Tensor, cfg: ModelConfig, positions=None):
    """``table[ids]`` in the compute dtype; with ``cfg.pb_embedding`` its
    backward is the PB reduction of ``_pb_take``, else autograd's own."""
    x = _pb_take(p.table, ids) if cfg.pb_embedding else F.embedding(ids, p.table)
    x = x.to(cfg.cdtype)
    if p.pos is not None and positions is not None:
        x = x + F.embedding(positions.clamp(max=cfg.learned_pos - 1), p.pos).to(cfg.cdtype)
    return x


def logits_apply(p: Embedding, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., padded_vocab) float32 logits; tied embeddings use ``table.T``."""
    dt = cfg.cdtype
    w = p.table.to(dt).t() if p.unembed is None else p.unembed.to(dt)
    logits = x.to(dt) @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits.float()
