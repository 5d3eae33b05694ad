"""LM layers (port of the dense and MoE parts of ``repro/models/layers.py``):
norms, RoPE, GQA attention with a KV cache, MLPs, the MoE layer with its
PB dispatch and row-block combine, the embedding and the logits, with the
PB embedding backward (``_pb_take``). The GNN half lives in
``models/gnn.py``. Not ported: the sharded MoE (``moe_combine_sharded``,
``_moe_weight_stationary``; ROADMAP Queue 1 item 3) and MoE training
(the backward of dispatch and combine; Queue 1 item 2).

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

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.executor import dispatch_permutation, execute_reduce
from repro_torch.kernels.flashattn import MASKED, flash_attention
from repro_torch.kernels.scatter_rows import scatter_rows
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
# MoE: PB dispatch (a stable counting sort by expert), Bin-Read, the combine
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """The router ``wr`` (d, E) in float32 and the experts' SwiGLU weights
    ``w1``, ``w3`` (E, d, f) and ``w2`` (E, f, d) in ``cfg.pdtype``
    (reference ``init_moe``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.pdtype
        self.wr = _param((d, E), torch.float32, device)
        self.w1 = _param((E, d, f), dt, device)
        self.w3 = _param((E, d, f), dt, device)
        self.w2 = _param((E, f, d), dt, device)


def moe_route(x2d: torch.Tensor, wr: torch.Tensor, cfg: ModelConfig):
    """The router in float32: the top ``cfg.top_k`` logits of each token,
    largest first, and their softmax. ``jax.lax.top_k`` keeps the lower
    expert on a tie and ``torch.topk`` promises no order there, so tied
    logits may route differently (``moe_topk_ties`` counts them)."""
    logits = x2d.float() @ wr.float()
    gate_w, gate_ids = torch.topk(logits, cfg.top_k, dim=-1)
    return torch.softmax(gate_w, dim=-1), gate_ids


def moe_topk_ties(x2d: torch.Tensor, wr: torch.Tensor, cfg: ModelConfig) -> int:
    """Tokens whose k-th and (k+1)-th largest router logits are equal: the
    only ties that can change which experts a token reaches."""
    logits = x2d.float() @ wr.float()
    k = cfg.top_k
    if k >= logits.shape[-1]:
        return 0
    top = torch.topk(logits, k + 1, dim=-1).values
    return int((top[:, k - 1] == top[:, k]).sum())


def moe_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Rows of each expert's bin (the reference's ``C``)."""
    return max(8, int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts))


class MoEDispatch(NamedTuple):
    """What ``moe_dispatch`` hands to the experts and the combine."""

    xbuf: torch.Tensor  # (E_local * C, d) the binned token rows, cdtype; empty slots zero
    slot_of_assign: torch.Tensor  # (T * k,) int32 slot of each assignment, -1 if dropped
    gate_w: torch.Tensor  # (T, k) float32 router weights
    capacity: int  # C, rows of each expert's bin


def moe_dispatch(x2d, wr, cfg: ModelConfig, e_start: int, E_local: int) -> MoEDispatch:
    """Binning: route all T tokens and write each kept (token, expert)
    assignment's row to its slot ``expert * C + rank``. The assignments,
    keyed by local expert (the rest to the overflow bin ``E_local``), go
    through ``dispatch_permutation`` (``cfg.moe_dispatch_method``); one of
    rank ``>= C`` in its bin is dropped. The rows are written by the
    row-scatter kernel (``scatter_rows``, ``pos = -1`` for a dropped one),
    which is the reference's ``xbuf.at[slot].set(..., mode="drop")``."""
    T, d = x2d.shape
    k = cfg.top_k
    dev = x2d.device
    C = moe_capacity(T, cfg)
    gate_w, gate_ids = moe_route(x2d, wr, cfg)
    local_e = gate_ids.reshape(-1).to(torch.int32) - e_start
    valid = (local_e >= 0) & (local_e < E_local)
    key = torch.where(valid, local_e, E_local)  # others -> the overflow bin
    order, key_s, _, rank = dispatch_permutation(key, E_local, method=cfg.moe_dispatch_method)
    order = order.long()
    keep = (key_s < E_local) & (rank < C)
    slot = torch.where(keep, key_s * C + rank, -1)  # -1: dropped
    token_of = torch.div(order, k, rounding_mode="floor")  # assignment a is token a // k's
    xbuf = scatter_rows(x2d[token_of].to(cfg.cdtype), slot, E_local * C)
    slot_of_assign = torch.empty(T * k, dtype=torch.int32, device=dev)
    slot_of_assign[order] = slot
    return MoEDispatch(xbuf, slot_of_assign, gate_w, C)


def moe_experts(xbuf, w1, w3, w2, cfg: ModelConfig, capacity: int) -> torch.Tensor:
    """Bin-Read: each expert's SwiGLU over its C contiguous rows, as
    batched matrix products (outside any kernel, as in the reference)."""
    dt = cfg.cdtype
    E_local, d = w1.shape[0], xbuf.shape[1]
    xb = xbuf.view(E_local, capacity, d)
    h = F.silu(torch.bmm(xb, w1.to(dt))) * torch.bmm(xb, w3.to(dt))
    return torch.bmm(h, w2.to(dt)).reshape(E_local * capacity, d)


def moe_combine(yb, slot_of_assign, gate_w, cfg: ModelConfig) -> torch.Tensor:
    """Each kept assignment's expert row times its router weight, summed
    into its token: ``execute_reduce(method="fused")`` over the
    token-ordered stream of k rows a token, the rows kernel on the card."""
    T, k = gate_w.shape
    dt = cfg.cdtype
    kept = slot_of_assign >= 0
    rows = yb[slot_of_assign.clamp(min=0).long()].masked_fill_(~kept[:, None], 0)
    w = gate_w.reshape(-1).to(dt)
    tokens = torch.arange(T, dtype=torch.int32, device=yb.device).repeat_interleave(k)
    return execute_reduce(
        tokens, rows * w[:, None], out_size=T, op="add", method="fused",
        sorted_within=1, in_bounds=True,
    )


def _moe_expert_shard(x2d, wr, w1, w3, w2, cfg: ModelConfig, e_start: int, E_local: int):
    """Route all T tokens; run experts ``[e_start, e_start + E_local)``
    (reference ``_moe_expert_shard``). Propagation Blocking written out:
    Binning (``moe_dispatch``), Bin-Read (``moe_experts``) and the
    row-block combine (``moe_combine``)."""
    disp = moe_dispatch(x2d, wr, cfg, e_start, E_local)
    yb = moe_experts(disp.xbuf, w1, w3, w2, cfg, disp.capacity)
    return moe_combine(yb, disp.slot_of_assign, disp.gate_w, cfg)


def _moe_dense_oracle(x2d, wr, w1, w3, w2, cfg: ModelConfig):
    """O(T * E) dense reference: every expert on every token, weighted by
    the router's gates (``moe_dispatch == "dense"``)."""
    dt = cfg.cdtype
    gw, gi = moe_route(x2d, wr, cfg)
    xx = x2d.to(dt)
    h = F.silu(torch.einsum("td,edf->tef", xx, w1.to(dt))) * torch.einsum(
        "td,edf->tef", xx, w3.to(dt)
    )
    y_all = torch.einsum("tef,efd->ted", h, w2.to(dt))  # (T, E, d)
    gates = (F.one_hot(gi, cfg.num_experts).to(dt) * gw[..., None].to(dt)).sum(1)  # (T, E)
    return torch.einsum("te,ted->td", gates, y_all)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MoE layer on (B, S, d) activations on one device (reference
    ``moe_apply`` without a mesh: all experts, ``e_start = 0``); the dense
    oracle under ``cfg.moe_dispatch == "dense"``. MoE over a mesh (expert
    shards, ``moe_combine_sharded``, the weight-stationary decode) is not
    ported (ROADMAP.md, Queue 1, "Sharded PB", item 3). Serving only:
    under autograd it raises, since dispatch and combine have no backward
    yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, p.wr, p.w1, p.w3, p.w2)):
        raise NotImplementedError(
            "MoE training (the backward of dispatch and combine) is not ported yet "
            "(ROADMAP.md, Queue 1 item 2); run the MoE layer under torch.no_grad()"
        )
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    if cfg.moe_dispatch == "dense":
        out = _moe_dense_oracle(x2d, p.wr, p.w1, p.w3, p.w2, cfg)
    else:
        out = _moe_expert_shard(x2d, p.wr, p.w1, p.w3, p.w2, cfg, 0, cfg.num_experts)
    return out.reshape(B, S, d).to(x.dtype)


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
