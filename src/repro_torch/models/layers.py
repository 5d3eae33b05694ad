"""LM layers (port of the dense and MoE parts of ``repro/models/layers.py``):
norms, RoPE, GQA self- and cross-attention with a KV cache, MLPs, the MoE layer with its
PB dispatch and row-block combine, the embedding and the logits, with the
PB embedding backward (``_pb_take``). The GNN half lives in
``models/gnn.py``.

Under an active mesh (``distributed/sharding.py``: each rank holds its
blocks of the weights and its rows of the batch) the dense and MoE layers
run tensor-parallel over ``model`` and FSDP over ``data``: attention with
``H / m`` query and ``KH / m`` key-value heads on each rank (GQA's groups
are contiguous, so the local query heads use the local KV heads), or, when
the heads do not split, every head on every rank from the gathered
``qkv`` columns, as GSPMD replicates them; the MLP column- then
row-parallel (gathered when ``d_ff`` does not split); a vocab-parallel
embedding and logits with the cross entropy's max and sum-exp reduced
over ``model`` (``vocab_parallel_nll_sum``); the MoE's three branches of
the reference (the expert-sharded layer, the weight-stationary decode,
one device's), and ``moe_combine_sharded`` on ``shard_reduce_stream``.
Attention over a cache split by ``spec_for`` (its positions on the axes
the batch leaves, or its KV heads) writes each new key on the rank that
holds its position and combines the ranks' blocks by a distributed
softmax (``_cache_attention``); cross-attention projects its source
as self-attention projects its input.

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
Cross-attention (``kv_src``: keys and values projected from another
sequence, no causal mask, ``Sq != Skv``) runs the kernel with
``causal=False`` in training, and at prefill over the whole cross cache.
Decode (one token at ``cache_index`` against the whole cache, or a
cross-attention query against its cache as it stands) stays plain
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
from repro_torch.distributed import sharding as shd
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


def _head_split(cfg: ModelConfig):
    """(axes the ``qkv`` columns stay split on, local query heads, local KV
    heads) under the active mesh: with the columns split on ``model`` and
    both head counts divisible by its size, this rank's ``H / m`` and
    ``KH / m`` heads (GQA's groups are contiguous, so the local query heads
    use the local KV heads); otherwise, and without a mesh, every head from
    the whole weights, gathered as GSPMD replicates them."""
    d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = shd.tp_axes((d, H * hd), ("embed", "qkv"), 1)
    n = shd.active_mesh().axis_size(tp) if tp else 1
    if (n > 1 and H % n == 0 and KH % n == 0
            and shd.tp_axes((d, KH * hd), ("embed", "qkv"), 1) == tp):
        return tp, H // n, KH // n
    return (), H, KH


def _qkv(p: Attention, x, cfg: ModelConfig, positions, kv_x=None, keep=(), heads=None):
    """q from ``x``; k and v from ``kv_x`` (cross-attention) or ``x``.
    ``keep``, ``heads``: ``_head_split``'s. The weights' dims sharded on
    other axes are gathered (FSDP), and ``x`` enters through ``copy_to``."""
    d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Hl, KHl = heads or (H, KH)
    dt = cfg.cdtype

    def w(t, shape, names):
        return shd.weight(t, shape, names, keep).to(dt)

    xx = shd.copy_to(x.to(dt), keep)
    kx = xx if kv_x is None else shd.copy_to(kv_x.to(dt), keep)
    q = xx @ w(p.wq, (d, H * hd), ("embed", "qkv"))
    k = kx @ w(p.wk, (d, KH * hd), ("embed", "qkv"))
    v = kx @ w(p.wv, (d, KH * hd), ("embed", "qkv"))
    if p.bq is not None:
        q = q + w(p.bq, (H * hd,), ("qkv",))
        k = k + w(p.bk, (KH * hd,), ("qkv",))
        v = v + w(p.bv, (KH * hd,), ("qkv",))
    B, S = x.shape[:2]
    Skv = kx.shape[1]
    q = q.view(B, S, Hl, hd)
    k = k.view(B, Skv, KHl, hd)
    v = v.view(B, Skv, KHl, hd)
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


def _seq_split_attention(q, kc, vc, causal, q_offset, s0, axes, tile_f32):
    """``_direct_attention`` of q (B, Sq, H, hd) over a cache whose key
    axis is split on ``axes``: this rank holds keys ``[s0, s0 + S_l)`` of
    every KV head, masked on those absolute positions, combined over the
    ranks by ``sharding.seq_softmax_attend``; (B, Sq, H * hd) on every
    rank along ``axes``."""
    B, Sq, H, hd = q.shape
    KH = kc.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, hd)
    sdt = torch.float32 if tile_f32 else q.dtype
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(sdt), kc.to(sdt)) * hd**-0.5
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = s0 + torch.arange(kc.shape[1], device=q.device)
        scores = torch.where(qpos[:, None] >= kpos[None, :], scores,
                             torch.full((), MASKED, dtype=sdt, device=q.device))
    out = shd.seq_softmax_attend(scores.float(), vc.permute(0, 2, 1, 3)[:, :, None], axes)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H * hd)  # from (B, KH, G, Sq, hd)


def _cache_attention(q, k, v, cache, cache_index, causal, cfg: ModelConfig, spec, keep):
    """``attention_apply``'s cache branches on this rank's block of the
    cache, whose ``spec`` is (batch, seq_kv, kv_heads, None) (None: the
    whole cache, without a mesh): q, k, v are the rank's rows and its heads
    (``_head_split``'s ``keep``). With a ``cache_index`` the new keys and
    values are written there, several at 0 (prefill), one anywhere
    (decode; a write at or past ``S_max`` is dropped, as the reference's
    one-hot write drops it, so that the tokens stay the reference's);
    without one the cache is read as it stands. Over a mesh, the
    collectives GSPMD generates for the reference, written out:

    - a cache split on its key axis (``seq_kv``; it holds every KV head):
      the new keys and values are gathered over ``keep`` to every head and
      land on the rank whose block holds their positions; the queries are
      gathered to every head and attend over every rank's block on
      absolute positions (``_seq_split_attention``), and the rank keeps
      its heads of the result for ``wo``;
    - a cache split on its KV heads (the axes ``keep`` splits them on) or
      not split: the rank's heads attend over its block as on one device.

    A causal prefill runs the flash kernel over the prompt's own keys and
    values: the reference attends over the whole S_max cache under the
    causal mask, and every cache row at or past the prompt is masked for
    every query (its score is -1e30 and exp(-1e30 - m) is exactly 0 in
    float32), so the result is the same. A non-causal prefill attends over
    the whole cache as it stands after the write, unmasked, the zero rows
    past the new keys included (the reference's cross-attention prefill;
    its key axis gathered). Returns the rank's heads (B, Sq, Hl * hd)."""
    mesh = shd.active_mesh()
    kc, vc = cache
    s_axes, h_axes = ((), ()) if spec is None else (shd.entry_axes(spec[1]),
                                                     shd.entry_axes(spec[2]))
    if h_axes and (s_axes or mesh.axes(h_axes) != mesh.axes(keep)):
        raise ValueError(f"a cache split as {spec} does not follow the heads' split {keep}")
    S_l = kc.shape[1]
    S_max = S_l * (mesh.axis_size(s_axes) if s_axes else 1)
    s0 = shd.block_range(S_max, s_axes)[0]
    B, Sq, Hl, hd = q.shape
    Skv = k.shape[1]
    # the query heads' KV heads in the cache block: all of them, or this rank's
    kh = (0, kc.shape[2]) if h_axes or not keep else shd.block_range(kc.shape[2], keep)
    out = None
    if cache_index is not None and Skv > 1:
        if cache_index != 0 or Skv > S_max:
            raise ValueError(
                f"a multi-token step is a prefill: it starts at index 0 and fits the "
                f"cache; got index {cache_index}, {Skv} tokens, S_max {S_max}")
        if causal:
            out = blockwise_attention(q, k, v, causal=True, q_block=cfg.attn_q_block)
    if not h_axes:  # the cache holds every KV head: gather the rank's new ones
        k, v = shd.all_gather(k, 2, keep), shd.all_gather(v, 2, keep)
    if cache_index is not None:
        lo, hi = max(s0, cache_index), min(s0 + S_l, cache_index + Skv)
        if lo < hi:
            kc[:, lo - s0:hi - s0] = k[:, lo - cache_index:hi - cache_index]
            vc[:, lo - s0:hi - s0] = v[:, lo - cache_index:hi - cache_index]
    if out is not None:
        return out
    if cache_index is not None and Skv > 1:  # unmasked: every row of the cache counts
        kf = shd.all_gather(kc, 1, s_axes)[:, :, kh[0]:kh[1]]
        vf = shd.all_gather(vc, 1, s_axes)[:, :, kh[0]:kh[1]]
        return blockwise_attention(q, kf.to(q.dtype), vf.to(q.dtype), causal=False,
                                   q_block=cfg.attn_q_block)
    # the reference projects k and v at a read-only step too, and drops them
    q_offset = 0 if cache_index is None else cache_index
    if not s_axes:
        return _direct_attention(q, kc[:, :, kh[0]:kh[1]].to(q.dtype),
                                 vc[:, :, kh[0]:kh[1]].to(q.dtype), causal=causal,
                                 q_offset=q_offset, tile_f32=cfg.attn_tile_f32)
    qa = shd.all_gather(q, 2, keep)  # every head attends over every block
    out = _seq_split_attention(qa, kc.to(q.dtype), vc.to(q.dtype), causal, q_offset, s0,
                               s_axes, cfg.attn_tile_f32)
    h0 = shd.block_range(cfg.num_heads, keep)[0] if keep else 0
    return out[..., h0 * hd:(h0 + Hl) * hd]


def attention_apply(
    p: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_src: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
    cache_index: Optional[int] = None,
    causal: bool = True,
    cache_spec=None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Self-attention, or cross-attention over ``kv_src`` (B, Skv, d),
    whose keys and values are projected from it. ``cache``: (k_cache,
    v_cache) of shape (B, S_max, KH, hd), written in place (the reference
    returns updated copies; the port saves the copy) and returned. With a
    ``cache_index``, one new key is written there and the query attends
    over the whole cache on absolute positions (decode); several are
    written at 0 (prefill), and under ``causal=False`` the queries attend
    over the whole cache, unmasked, its rows past the new keys included,
    as the reference does at a cross-attention prefill. Without a
    ``cache_index`` the cache is read as it stands and nothing is written
    (cross-attention's decode). RoPE turns the queries by ``positions``
    and leaves the keys as they are, which is the reference's function
    (ROADMAP Queue 3). Under a mesh the cache is this rank's block by
    ``cache_spec``, its (batch, seq_kv, kv_heads, None) entries
    (``_cache_attention``)."""
    B, S, d = x.shape
    keep, Hl, KHl = _head_split(cfg)
    q, k, v = _qkv(p, x, cfg, positions, kv_src, keep, (Hl, KHl))
    new_cache = None
    if cache is not None:
        out = _cache_attention(q, k, v, cache, cache_index, causal, cfg, cache_spec, keep)
        new_cache = cache
    elif S > 1:
        out = blockwise_attention(q, k, v, causal=causal, q_block=cfg.attn_q_block)
    else:
        out = _direct_attention(q, k, v, causal=causal, tile_f32=cfg.attn_tile_f32)
    dt = cfg.cdtype
    wo = shd.weight(p.wo, (cfg.num_heads * cfg.head_dim, d), ("qkv", "embed"), keep).to(dt)
    return shd.psum(out.to(dt) @ wo, keep), new_cache


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
    """The MLP; under the active mesh ``w1`` / ``w3`` column-parallel and
    ``w2`` row-parallel over the axes ``d_ff`` is split on (a ``psum``
    after ``w2``; gathered weights when it does not split)."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.cdtype
    tp = shd.tp_axes((d, f), ("embed", "mlp"), 1)

    def w(t, shape, names):
        return shd.weight(t, shape, names, tp).to(dt)

    xx = shd.copy_to(x.to(dt), tp)
    if p.w3 is not None:
        w1, w3 = w(p.w1, (d, f), ("embed", "mlp")), w(p.w3, (d, f), ("embed", "mlp"))
        h = F.silu(xx @ w1) * (xx @ w3)
        return shd.psum(h @ w(p.w2, (f, d), ("mlp", "embed")), tp).to(x.dtype)
    # jax.nn.gelu's default
    h = F.gelu(xx @ w(p.w1, (d, f), ("embed", "mlp")) + w(p.b1, (f,), ("mlp",)), approximate="tanh")
    return (shd.psum(h @ w(p.w2, (f, d), ("mlp", "embed")), tp) + p.b2.to(dt)).to(x.dtype)


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


def _kept_rows(buf, slot_of_assign) -> torch.Tensor:
    """(T * k, d): row ``slot_of_assign[a]`` of ``buf`` for every
    assignment, in token order; zero where the assignment was dropped."""
    kept = slot_of_assign >= 0
    return buf[slot_of_assign.clamp(min=0).long()].masked_fill_(~kept[:, None], 0)


def _sum_token_rows(rows, T: int) -> torch.Tensor:
    """The k consecutive rows of each token summed: the row-block PB
    reduce over the token-ordered stream, ``execute_reduce(method="fused")``
    (the rows kernel on the card, its plain version on the CPU)."""
    tokens = torch.arange(T, dtype=torch.int32, device=rows.device)  # assignment t * k + j: t
    return execute_reduce(
        tokens.repeat_interleave(rows.shape[0] // T), rows, out_size=T, op="add",
        # sorted-ok: arange(T) repeated in place  # in-bounds-ok: so in [0, T)
        method="fused", sorted_within=1, in_bounds=True,
    )


class _MoEScatter(torch.autograd.Function):
    """Binning's write, ``xbuf[slot[i]] = x2d[token_of[i]]``, as a PB pair:
    the forward is the row-scatter kernel; the backward gathers the
    cotangent at each kept assignment's slot in token order and sums the
    k rows of each token with the rows kernel (the combine's forward
    stream). The reference's ``xbuf.at[slot].set(x2d[token_of])``
    differentiates to that same sum."""

    @staticmethod
    def forward(ctx, x2d, token_of, slot, slot_of_assign, n_slots: int, dtype):
        ctx.save_for_backward(slot_of_assign)
        ctx.num_tokens, ctx.x_dtype = x2d.shape[0], x2d.dtype
        return scatter_rows(x2d[token_of].to(dtype), slot, n_slots)

    @staticmethod
    def backward(ctx, g_xbuf):
        (slot_of_assign,) = ctx.saved_tensors
        rows = _kept_rows(g_xbuf, slot_of_assign)
        gx = _sum_token_rows(rows, ctx.num_tokens)
        return gx.to(ctx.x_dtype), None, None, None, None, None


def moe_dispatch(x2d, wr, cfg: ModelConfig, e_start: int, E_local: int,
                 route=None) -> MoEDispatch:
    """Binning: route all T tokens and write each kept (token, expert)
    assignment's row to its slot ``expert * C + rank``. The assignments,
    keyed by local expert (the rest to the overflow bin ``E_local``), go
    through ``dispatch_permutation`` (``cfg.moe_dispatch_method``); one of
    rank ``>= C`` in its bin is dropped. The rows are written by the
    row-scatter kernel (``scatter_rows``, ``pos = -1`` for a dropped one),
    which is the reference's ``xbuf.at[slot].set(..., mode="drop")``;
    under autograd its backward is the rows kernel (``_MoEScatter``).
    ``route``: (gate_w, gate_ids) computed by the caller, in place of
    ``moe_route(x2d, wr)``."""
    T, d = x2d.shape
    k = cfg.top_k
    dev = x2d.device
    C = moe_capacity(T, cfg)
    gate_w, gate_ids = moe_route(x2d, wr, cfg) if route is None else route
    local_e = gate_ids.reshape(-1).to(torch.int32) - e_start
    valid = (local_e >= 0) & (local_e < E_local)
    key = torch.where(valid, local_e, E_local)  # others -> the overflow bin
    order, key_s, _, rank = dispatch_permutation(key, E_local, method=cfg.moe_dispatch_method)
    order = order.long()
    keep = (key_s < E_local) & (rank < C)
    slot = torch.where(keep, key_s * C + rank, -1)  # -1: dropped
    token_of = torch.div(order, k, rounding_mode="floor")  # assignment a is token a // k's
    slot_of_assign = torch.empty(T * k, dtype=torch.int32, device=dev)
    slot_of_assign[order] = slot
    xbuf = _MoEScatter.apply(x2d, token_of, slot, slot_of_assign, E_local * C, cfg.cdtype)
    return MoEDispatch(xbuf, slot_of_assign, gate_w, C)


def moe_experts(xbuf, w1, w3, w2, cfg: ModelConfig, capacity: int) -> torch.Tensor:
    """Bin-Read: each expert's SwiGLU over its C contiguous rows, as
    batched matrix products (outside any kernel, as in the reference)."""
    dt = cfg.cdtype
    E_local, d = w1.shape[0], xbuf.shape[1]
    xb = xbuf.view(E_local, capacity, d)
    h = F.silu(torch.bmm(xb, w1.to(dt))) * torch.bmm(xb, w3.to(dt))
    return torch.bmm(h, w2.to(dt)).reshape(E_local * capacity, d)


class _MoECombine(torch.autograd.Function):
    """The combine, ``out[t] = sum_j w[t, j] * yb[slot(t, j)]``, as a PB
    pair: the forward sums the weighted rows with the rows kernel; the
    backward writes each kept assignment's cotangent row ``w * g_out[t]``
    to its slot with the row-scatter kernel (the dispatch's forward
    stream; slots are distinct, unfilled ones zero) and gives the router
    weights the row dot products ``<g_out[t], yb[slot]>`` (plain torch).
    The slots get no gradient."""

    @staticmethod
    def forward(ctx, yb, gate_w, slot_of_assign, dtype):
        T, k = gate_w.shape
        rows = _kept_rows(yb, slot_of_assign)
        w = gate_w.reshape(-1).to(dtype)
        ctx.save_for_backward(yb, gate_w, slot_of_assign)
        ctx.dtype = dtype
        return _sum_token_rows(rows * w[:, None], T)

    @staticmethod
    def backward(ctx, g_out):
        yb, gate_w, slot_of_assign = ctx.saved_tensors
        k = gate_w.shape[1]
        g_tok = g_out.to(ctx.dtype).repeat_interleave(k, dim=0)  # (T * k, d): g_out[token]
        g_yb = None
        if ctx.needs_input_grad[0]:
            w = gate_w.reshape(-1).to(ctx.dtype)
            g_yb = scatter_rows((g_tok * w[:, None]).to(yb.dtype).contiguous(), slot_of_assign,
                                yb.shape[0])
        g_w = None
        if ctx.needs_input_grad[1]:
            rows = _kept_rows(yb, slot_of_assign)
            g_w = (g_tok.float() * rows.float()).sum(-1).reshape(gate_w.shape).to(gate_w.dtype)
        return g_yb, g_w, None, None


def moe_combine(yb, slot_of_assign, gate_w, cfg: ModelConfig) -> torch.Tensor:
    """Each kept assignment's expert row times its router weight, summed
    into its token: ``execute_reduce(method="fused")`` over the
    token-ordered stream of k rows a token, the rows kernel on the card;
    under autograd its backward is the row-scatter kernel
    (``_MoECombine``)."""
    return _MoECombine.apply(yb, gate_w, slot_of_assign, cfg.cdtype)


def _moe_expert_shard(x2d, wr, w1, w3, w2, cfg: ModelConfig, e_start: int, E_local: int):
    """Route all T tokens; run experts ``[e_start, e_start + E_local)``
    (reference ``_moe_expert_shard``). Propagation Blocking written out:
    Binning (``moe_dispatch``), Bin-Read (``moe_experts``) and the
    row-block combine (``moe_combine``). Differentiable in x2d, wr and the
    experts' weights: the router's softmax and top-k and the expert
    products are autograd's own, as they are jnp in the reference; the
    integer routing gets no gradient."""
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


MOE_NAMES = {"wr": ("embed_act", None), "w1": ("experts", "embed", "expert_mlp"),
             "w3": ("experts", "embed", "expert_mlp"), "w2": ("experts", "expert_mlp", "embed")}


def _moe_shapes(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"wr": (d, E), "w1": (E, d, f), "w3": (E, d, f), "w2": (E, f, d)}


def moe_combine_sharded(token_ids, rows, gate_w, num_tokens: int, mesh, axis_name=None,
                        method: str = "fused") -> torch.Tensor:
    """Distributed MoE combine (reference ``moe_combine_sharded``): the
    (token, weighted row) assignment stream, held whole by every rank,
    reduced across the ranks of one mesh axis by ``shard_reduce_stream``:
    each rank takes its block of the stream and sends each row once, to
    the rank that owns its token, which sums it with the rows kernel;
    every rank gets the whole (num_tokens, d) result. ``mesh``: a
    ``sharding.Mesh`` (``axis_name`` picks its axis; a 1-D mesh's only
    axis by default) or a ``StreamMesh``."""
    from repro_torch.core.distributed_pb import shard_reduce_stream

    if isinstance(mesh, shd.Mesh):
        if axis_name is None:
            if len(mesh.axis_names) != 1:
                raise ValueError(f"pass axis_name for mesh axes {mesh.axis_names}")
            axis_name = mesh.axis_names[0]
        mesh = shd.stream_mesh(axis_name, mesh)
    weighted = rows * gate_w[:, None].to(rows.dtype)
    return shard_reduce_stream(token_ids, weighted, out_size=num_tokens, mesh=mesh,
                               axis_name=axis_name, op="add", method=method)


def _moe_weight_stationary(p: MoE, x, cfg: ModelConfig, mesh) -> torch.Tensor:
    """Decode-time MoE (reference ``_moe_weight_stationary``): the weights
    stay where they are, experts over ``model`` and features over the data
    axes, and the tokens move: every token on every rank with this rank's
    block of its features; the router's logits and the experts' ``w1`` /
    ``w3`` products complete their feature sums over the data axes before
    the nonlinearity, ``w2`` gives this rank's feature block of each row,
    the local combine sums them (the rows kernel) and a sum over ``model``
    adds the expert shards. Inference only (no autograd collectives)."""
    B_l, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    m = mesh.shape["model"]
    E_local = E // m
    dt = cfg.cdtype
    data = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dspec = data if len(data) > 1 else data[0]
    if d % mesh.axis_size(data):
        raise ValueError(f"the weight-stationary MoE splits d_model {d} over the data axes "
                         f"{data} of {mesh.axis_size(data)}")
    split = shd.split_axes()
    xa = shd.all_gather(x, 0, split, mesh)  # every token
    T = xa.shape[0] * S
    shapes = _moe_shapes(cfg)

    def block(name, spec_to):
        stored = shd.spec_for(mesh, shapes[name], MOE_NAMES[name])
        return shd.reshard(getattr(p, name), stored, spec_to, mesh)

    x2 = shd.shard_of(xa.reshape(T, d), (None, dspec), mesh).float()
    logits = shd.all_reduce(x2 @ block("wr", (dspec, None)).float(), data, mesh)
    gate_w, gate_ids = torch.topk(logits, k, dim=-1)
    route = (torch.softmax(gate_w, dim=-1), gate_ids)
    e_start = mesh.axis_index("model") * E_local
    disp = moe_dispatch(x2, None, cfg, e_start, E_local, route=route)
    xb = disp.xbuf.view(E_local, disp.capacity, -1)
    h1 = shd.all_reduce(torch.bmm(xb, block("w1", ("model", dspec, None)).to(dt)), data, mesh)
    h3 = shd.all_reduce(torch.bmm(xb, block("w3", ("model", dspec, None)).to(dt)), data, mesh)
    yb = torch.bmm(F.silu(h1) * h3, block("w2", ("model", None, dspec)).to(dt))
    out = moe_combine(yb.reshape(E_local * disp.capacity, -1), disp.slot_of_assign, disp.gate_w,
                      cfg)
    out = shd.all_gather(shd.all_reduce(out, "model", mesh), 1, data, mesh)
    rows = shd.shard_of(out.reshape(-1, S, d), (split or None, None, None), mesh)
    return rows.to(x.dtype)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MoE layer on (B, S, d) activations (reference ``moe_apply``),
    the dense oracle under ``cfg.moe_dispatch == "dense"``. Without a mesh,
    or on a mesh whose ``model`` axis is 1 or does not divide the experts,
    all experts from ``e_start = 0`` (FSDP's gathers first on a mesh).
    On a mesh whose ``model`` axis of m divides them: at decode (S = 1)
    with ``cfg.moe_weight_stationary_decode`` and a data axis, the
    weight-stationary layer; otherwise the expert-sharded layer: each rank
    routes its rows' tokens and runs experts ``[r E/m, (r + 1) E/m)`` with
    the capacity of its own token count (the reference's ``shard_map``
    computes it from the local T as well), and a ``psum`` over ``model``
    adds the shards. Its input and router enter through ``copy_to``: each
    shard computes part of their gradients."""
    B, S, d = x.shape
    mesh = shd.active_mesh()
    E = cfg.num_experts
    m = 1 if mesh is None else mesh.shape.get("model", 1)
    split = m > 1 and E % m == 0
    if (split and cfg.moe_weight_stationary_decode and S == 1
            and any(a in mesh.shape for a in ("pod", "data"))):
        return _moe_weight_stationary(p, x, cfg, mesh)
    shapes = _moe_shapes(cfg)
    sharded = split and cfg.moe_dispatch != "dense"
    if sharded and shd.tp_axes(shapes["w1"], MOE_NAMES["w1"], 0) != ("model",):
        raise ValueError("the expert-sharded MoE needs the experts on 'model' "
                         f"(rules {shd.active_rules()['experts']})")
    if sharded and not shd.split_axes():
        # the reference's shard_map takes the batch split over the batch axes
        # (in_specs P(ba, None, None)): a batch the ranks hold whole, such as
        # the engine's one-row prefill, fails there when it does not divide
        ba = shd.batch_axes(mesh)
        n = mesh.axis_size(ba)
        if n > 1:
            raise ValueError(f"the expert-sharded MoE splits the batch over {ba}: "
                             f"{n} does not evenly divide {B}" if B % n else
                             f"the expert-sharded MoE takes the batch split over {ba}")
    keep = ("model",) if sharded else ()
    w = {n: shd.weight(getattr(p, n), shapes[n], MOE_NAMES[n], keep) for n in MOE_NAMES}
    x2d = shd.copy_to(x.reshape(-1, d), keep)
    if cfg.moe_dispatch == "dense":
        out = _moe_dense_oracle(x2d, w["wr"], w["w1"], w["w3"], w["w2"], cfg)
    else:
        E_local = E // m if sharded else E
        e_start = mesh.axis_index("model") * E_local if sharded else 0
        out = _moe_expert_shard(x2d, shd.copy_to(w["wr"], keep), w["w1"], w["w3"], w["w2"], cfg,
                                e_start, E_local)
    return shd.psum(out, keep).reshape(B, S, d).to(x.dtype)


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
    gradient is cast to its dtype; the ids get none. With ``drop`` an id
    of -1 gives a zero row and adds nothing to the gradient (the rows
    kernel drops it): a vocab-parallel table's ids outside its rows."""

    @staticmethod
    def forward(ctx, table, ids, drop=False):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        if not drop:
            return F.embedding(ids, table)
        return F.embedding(ids.clamp(min=0), table).masked_fill_((ids < 0)[..., None], 0)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat_ids = ids.reshape(-1).to(torch.int32)
        flat_g = g.reshape(-1, g.shape[-1]).float().contiguous()
        dtable = execute_reduce(flat_ids, flat_g, out_size=ctx.vocab, op="add", method="fused")
        return dtable.to(ctx.dtype), None, None


_pb_take = _PBTake.apply  # (table, ids[, drop]) -> table[ids]


def embed_apply(p: Embedding, ids: torch.Tensor, cfg: ModelConfig, positions=None):
    """``table[ids]`` in the compute dtype; with ``cfg.pb_embedding`` its
    backward is the PB reduction of ``_pb_take``, else autograd's own.
    Under the active mesh, with the vocabulary split on ``model``, each
    rank looks up the ids in its rows (the others go to -1: a zero row,
    dropped by the backward's rows kernel) and a ``psum`` adds the ranks'
    rows; the ``embed`` dim is gathered (FSDP)."""
    V, d = cfg.padded_vocab, cfg.d_model
    tp, start = _vocab_split(cfg, tied=True)
    table = shd.weight(p.table, (V, d), ("vocab", "embed"), tp)
    if tp:
        local = ids - start
        ids = torch.where((local >= 0) & (local < table.shape[0]), local, -1)
    if cfg.pb_embedding:
        x = _pb_take(table, ids, bool(tp))
    elif tp:
        x = F.embedding(ids.clamp(min=0), table) * (ids >= 0)[..., None].to(table.dtype)
    else:
        x = F.embedding(ids, table)
    x = shd.psum(x, tp).to(cfg.cdtype)
    if p.pos is not None and positions is not None:
        pos = shd.weight(p.pos, tuple(p.pos.shape[:1]) + (d,), (None, "embed"))
        x = x + F.embedding(positions.clamp(max=cfg.learned_pos - 1), pos).to(cfg.cdtype)
    return x


def _vocab_split(cfg: ModelConfig, tied: bool):
    """(axes the vocabulary is split on, this rank's first row of it);
    ((), 0) without a mesh."""
    V, d = cfg.padded_vocab, cfg.d_model
    tp = (shd.tp_axes((V, d), ("vocab", "embed"), 0) if tied
          else shd.tp_axes((d, V), ("embed", "vocab"), 1))
    if not tp:
        return (), 0
    mesh = shd.active_mesh()
    return tp, mesh.axis_index(tp) * (V // mesh.axis_size(tp))


def vocab_weight(p: Embedding, cfg: ModelConfig):
    """(the (d, V_local) logits weight in the compute dtype, its first
    column of the vocabulary, the axes the vocabulary is split on): this
    rank's block of ``unembed`` (or ``table.T`` when tied), its ``embed``
    dim gathered (FSDP); the whole weight, 0 and () without a mesh."""
    V, d, dt = cfg.padded_vocab, cfg.d_model, cfg.cdtype
    tied = p.unembed is None
    tp, start = _vocab_split(cfg, tied)
    if tied:
        return shd.weight(p.table, (V, d), ("vocab", "embed"), tp).to(dt).t(), start, tp
    return shd.weight(p.unembed, (d, V), ("embed", "vocab"), tp).to(dt), start, tp


def _local_logits(w, x, cfg: ModelConfig, tp):
    """float32 logits of the rank's block of the vocabulary (``vocab_weight``)."""
    logits = shd.copy_to(x.to(cfg.cdtype), tp) @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits.float()


def logits_apply(p: Embedding, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., padded_vocab) float32 logits; tied embeddings use ``table.T``
    (under a mesh: the vocab-parallel blocks, gathered)."""
    w, _, tp = vocab_weight(p, cfg)
    return shd.gather_dim(_local_logits(w, x, cfg, tp), -1, tp)


def vocab_parallel_nll_sum(w, start: int, tp, h, labels, cfg: ModelConfig) -> torch.Tensor:
    """The sum of the next-token NLL over ``label >= 0`` under the active
    mesh, from each rank's block of the logits (``vocab_weight``'s ``w``,
    ``start``, ``tp``): the max over the vocabulary and the sum of
    exponentials are reduced over the axes it is split on, and so is the
    label's logit (held by one rank). Padded-vocab columns are -1e30, as in
    the single-device loss."""
    logits = _local_logits(w, h, cfg, tp)
    Vl = logits.shape[-1]
    col = start + torch.arange(Vl, device=logits.device)
    if cfg.padded_vocab > cfg.vocab_size:
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    mx = shd.all_reduce(logits.detach().amax(-1), tp, op="max")
    se = shd.psum(torch.exp(logits - mx[..., None]).sum(-1), tp)
    local = labels.long() - start
    mine = (local >= 0) & (local < Vl)
    tgt = logits.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0] * mine
    nll = torch.log(se) + mx - shd.psum(tgt, tp)
    return (nll * (labels >= 0)).sum()
