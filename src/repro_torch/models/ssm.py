"""Recurrent blocks (port of ``repro/models/ssm.py``): Mamba2 (SSD,
chunkwise-parallel), xLSTM's mLSTM and sLSTM.

Each block's parameters live in an ``nn.Module`` whose attribute names are
the reference's keys (Mamba2: ``in_proj``, ``conv_w``, ``A_log``, ``D``,
``dt_bias``, ``norm_w``, ``out_proj``; mLSTM: ``in_proj``, ``out_proj``,
``norm_w``; sLSTM: ``w_in``, ``r``, ``b``, ``out_proj``, ``norm_w``), in
the reference's layouts and dtypes: projections in ``cfg.pdtype``, the
per-head scalars, norm weights and the sLSTM bias in float32. Their values
at init follow the reference leaf by leaf (``A_log``, ``dt_bias``, ``b``
zero; ``D``, ``norm_w`` one; ``r`` by ``head_dim ** -0.5``; the rest
fan-in scaled), which ``models/transformer.py::init_params`` applies.

The functions take those modules where the reference takes its parameter
dicts, and return ``(out, new_state)`` with the reference's state tuples:
Mamba2 ``(ssm (B, H, N, P) float32, conv (B, K - 1, d_inner))``, mLSTM
``(S (B, H, hd, hd), n (B, H, hd))``, sLSTM ``(c, n, h)`` each
``(B, H, hd)``, all float32 but the conv history, which keeps the compute
dtype as in the reference. ``decode=True`` takes one token (the recurrent
step); otherwise the chunked path runs, with the last chunk padded (forget
gates padded with 1.0, so the padding leaves the state alone).

The inter-chunk scans are short Python loops over chunks (the reference
scans them with ``lax.scan``). Every contraction of three operands in the
reference is written as two products, so that no (b, k, l, h, n, p)
intermediate is built (at zamba2's prefill it would be gigabytes). The
intra-chunk decays ``exp(lf_t - lf_s)`` are taken with the exponent set
to -inf above the diagonal (``_masked_decay``), where it is positive and
past float32's range over xlstm-350m's 256-position chunk: the
reference's ``exp`` overflows there and ``where`` drops the inf, which
leaves its forward right and its gradient NaN; the port's decays are 0
there, its forward the same and its gradient finite.

Over a mesh each block runs tensor-parallel over its heads on the axes
the ``heads`` rule splits them on (``_heads_tp``): its input enters
through ``copy_to``, the fused projections whose blocks do not fall on
heads (Mamba2's and mLSTM's ``in_proj``) are gathered whole and the rank
takes its heads' columns (their gradient summed over those axes), a norm
over the split width sums its squares over them (``_rms_var``), and
``out_proj`` is row-parallel with a ``psum``. The states hold the rank's
heads.

sLSTM is sequential: the reference scans every position, and so does the
port, one Python step a position (the input projection of all positions
is one product before the loop, so a step holds only the recurrent
product and the cell). There is no TPU kernel behind it; on the card a
prefill is many small launches (ROADMAP, "Beside the kernels").
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _param

State = Tuple[torch.Tensor, ...]


def _heads_tp(H: int, *blocks) -> Tuple[str, ...]:
    """The axes a block's heads run tensor-parallel on under the active
    mesh: the ``heads`` rule's split of its ``H`` heads, when each
    ``(size, names)`` of ``blocks`` (its head-major weight and state dims)
    splits on the same axes; () without a mesh or when one does not (every
    head on every rank, from the gathered weights)."""
    tp = shd.tp_axes((H,), ("heads",), 0)
    if tp and all(shd.tp_axes((n,), names, 0) == tp for n, names in blocks):
        return tp
    return ()


def _rank_heads(H: int, tp) -> Tuple[int, int]:
    """[h0, h1): the heads this rank runs (all of them without ``tp``)."""
    return shd.block_range(H, tp) if tp else (0, H)


def _columns(parts, device) -> torch.Tensor:
    """The column indices of ``[start, stop)`` ranges, in order: a rank's
    columns of a fused projection whose blocks do not fall on its heads."""
    return torch.cat([torch.arange(a, b, device=device) for a, b in parts])


def _rms_var(y: torch.Tensor, n: int, tp) -> torch.Tensor:
    """mean(y^2) over the last dim of ``n`` values, this rank's block of
    them under ``tp``: its sum of squares summed over the axes, where each
    rank scales its own block by the result, so the cotangents are
    partial and are summed too (``copy_to`` under the ``psum``)."""
    if not tp:
        return (y * y).mean(-1, keepdim=True)
    return shd.psum(shd.copy_to((y * y).sum(-1, keepdim=True), tp), tp) / n


def _causal_mask(c: int, device) -> torch.Tensor:
    """(c, c, 1): key s visible to query t when s <= t (the decays' last
    axis is the head)."""
    return torch.ones(c, c, dtype=torch.bool, device=device).tril()[:, :, None]


def _masked_decay(lf: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``exp(lf_t - lf_s)`` (B, nc, t, s, H) from the inclusive log-decay
    sums ``lf`` (B, nc, c, H), 0 where ``mask`` hides the entry (s > t):
    the exponent is set to -inf there, where it is positive and, over a
    long chunk, past float32's range. The reference takes ``exp`` of it
    and drops the inf with ``where``, which keeps the forward but makes
    exp's gradient 0 * inf = NaN (ROADMAP Queue 3); here the hidden
    entries' gradient is 0. Every visible entry is the same."""
    return torch.exp((lf[:, :, :, None, :] - lf[:, :, None, :, :]).masked_fill(~mask, float("-inf")))


def _pad_seq(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``x`` (B, S, ...) with ``pad`` positions of ``value`` appended."""
    if not pad:
        return x
    return torch.cat([x, x.new_full((x.shape[0], pad) + x.shape[2:], value)], dim=1)


# ---------------------------------------------------------------------------
# Mamba2 (SSD with scalar-per-head decay, shared B/C across heads)
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    P = cfg.head_dim  # reuse head_dim as SSD head size
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dt, f32 = cfg.d_model, cfg.pdtype, torch.float32
        d_inner, H, P, N = mamba2_dims(cfg)
        self.in_proj = _param((d, 2 * d_inner + 2 * N + H), dt, device)
        self.conv_w = _param((cfg.ssm_conv, d_inner), dt, device)
        self.A_log = _param((H,), f32, device)
        self.D = _param((H,), f32, device)
        self.dt_bias = _param((H,), f32, device)
        self.norm_w = _param((d_inner,), f32, device)
        self.out_proj = _param((d_inner, d), dt, device)


def _mamba_tp(cfg: ModelConfig):
    """(tensor-parallel axes, this rank's heads [h0, h1)) of a Mamba2
    block: its heads, ``d_inner``'s channels (``conv_w``, ``norm_w``,
    ``out_proj``'s rows, the conv state) split on the same axes."""
    d_inner, H, P, N = mamba2_dims(cfg)
    tp = _heads_tp(H, (d_inner, ("mlp",)))
    return tp, _rank_heads(H, tp)


def _split_inproj(p: Mamba2, x, cfg: ModelConfig, tp=(), heads=None):
    """(z, xs, B, C, dt) in the compute dtype, of heads ``[h0, h1)`` (all
    by default). ``in_proj`` is gathered whole (its ``mlp`` blocks do not
    fall on the five parts) and, under ``tp``, the rank takes its columns:
    its channels of z and xs, B and C whole, its heads of dt."""
    d_inner, H, P, N = mamba2_dims(cfg)
    dt = cfg.cdtype
    h0, h1 = heads or (0, H)
    w = shd.weight(p.in_proj, (cfg.d_model, 2 * d_inner + 2 * N + H), ("embed", "mlp"),
                   partial=tp).to(dt)
    c0, c1 = h0 * P, h1 * P
    if tp:
        w = w[:, _columns([(c0, c1), (d_inner + c0, d_inner + c1),
                           (2 * d_inner, 2 * d_inner + 2 * N),
                           (2 * d_inner + 2 * N + h0, 2 * d_inner + 2 * N + h1)], x.device)]
    xx = shd.copy_to(x.to(dt), tp)
    return torch.split(xx @ w, [c1 - c0, c1 - c0, N, N, h1 - h0], dim=-1)


def _causal_conv(xs, w, conv_state=None):
    """Depthwise causal conv along seq, then SiLU. xs: (B, S, C), w: (K, C);
    conv_state: (B, K - 1, C) history for decode. Returns (out, the last
    K - 1 inputs)."""
    K, S = w.shape[0], xs.shape[1]
    if conv_state is not None:
        xs_full = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
    else:
        xs_full = F.pad(xs, (0, 0, K - 1, 0))
    new_state = xs_full[:, -(K - 1):, :]
    out = w[0] * xs_full[:, :S]
    for k in range(1, K):  # the reference's sum, in its order
        out = out + w[k] * xs_full[:, k:k + S]
    return F.silu(out), new_state


def _ssd_chunked(xdt, a_log, Bm, Cm, h0, chunk: int):
    """Chunked SSD: xdt (B, S, H, P), a_log (B, S, H), Bm and Cm (B, S, N),
    h0 (B, H, N, P), all float32. Returns (y (B, S, H, P), final state)."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    pad = (-S) % c
    xdt, a_log, Bm, Cm = (_pad_seq(t, pad) for t in (xdt, a_log, Bm, Cm))
    nc = (S + pad) // c
    xdt_c = xdt.reshape(B, nc, c, H, P)
    B_c = Bm.reshape(B, nc, c, N)
    C_c = Cm.reshape(B, nc, c, N)
    lf = a_log.reshape(B, nc, c, H).cumsum(2)  # inclusive within a chunk
    # intra-chunk (attention-like), all chunks batched
    scores = C_c @ B_c.transpose(-1, -2)  # (B, nc, t, s)
    w_ts = scores[..., None] * _masked_decay(lf, _causal_mask(c, xdt.device))  # (B, nc, t, s, H)
    y_intra = w_ts.permute(0, 1, 4, 2, 3) @ xdt_c.transpose(2, 3)  # (B, nc, H, t, P)
    # chunk summaries: sum_l B[l, n] end_decay[l, h] xdt[l, h, p]
    end_decay = torch.exp(lf[:, :, -1:, :] - lf)  # (B, nc, c, H)
    weighted = (end_decay[..., None] * xdt_c).reshape(B, nc, c, H * P)
    chunk_state = (B_c.transpose(-1, -2) @ weighted).reshape(B, nc, N, H, P).transpose(2, 3)
    chunk_decay = torch.exp(lf[:, :, -1, :])  # (B, nc, H)
    h, h_prevs = h0, []
    for k in range(nc):  # the previous state enters each chunk
        h_prevs.append(h)
        h = h * chunk_decay[:, k, :, None, None] + chunk_state[:, k]
    h_prev = torch.stack(h_prevs, 1).transpose(2, 3).reshape(B, nc, N, H * P)
    y_inter = (C_c @ h_prev).reshape(B, nc, c, H, P) * torch.exp(lf)[..., None]
    y = (y_intra.transpose(2, 3) + y_inter).reshape(B, nc * c, H, P)[:, :S]
    return y, h


def mamba2_apply(
    p: Mamba2,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[State] = None,
    decode: bool = False,
):
    """x: (B, S, d). state = (ssm_state (B, H, N, P) float32, conv_state
    (B, K - 1, d_inner)). decode=True expects S == 1 and takes the
    recurrent step. Under a mesh x is the rank's rows and the block runs
    tensor-parallel over its heads (``_mamba_tp``): its channels of the
    conv and the gated norm (whose sum of squares is summed over the
    axes), ``out_proj`` row-parallel with a ``psum``; the state is the
    rank's block of heads and channels. Where the heads do not split,
    every rank runs them all from the gathered weights and keeps its
    block of the conv state."""
    B, S, d = x.shape
    d_inner, H, P, N = mamba2_dims(cfg)
    tp, (h0, h1) = _mamba_tp(cfg)
    Hl, C = h1 - h0, (h1 - h0) * P
    z, xs, Bm, Cm, dtr = _split_inproj(p, x, cfg, tp, (h0, h1))
    conv_state = state[1] if state is not None else None
    conv_w = shd.weight(p.conv_w, (cfg.ssm_conv, d_inner), ("conv", "mlp"), tp)
    norm_w = shd.weight(p.norm_w, (d_inner,), ("mlp",), tp)
    out_w = shd.weight(p.out_proj, (d_inner, d), ("mlp", "embed"), tp)
    # replicated, and each rank uses its heads: their gradients sum over tp
    A_log, D, dt_bias = (shd.copy_to(t, tp)[h0:h1] for t in (p.A_log, p.D, p.dt_bias))
    conv_axes = ()
    if not tp:  # every channel here; the state holds the rank's block of them
        conv_axes = shd.tp_axes((d_inner,), ("mlp",), 0)
        if conv_state is not None:
            conv_state = shd.all_gather(conv_state, 2, conv_axes)
    xs, new_conv = _causal_conv(xs, conv_w.to(xs.dtype), conv_state)
    if conv_axes:
        new_conv = shd.shard_of(new_conv, (None, None, conv_axes))
    xh = xs.reshape(B, S, Hl, P).float()
    dt_s = F.softplus(dtr.float() + dt_bias)  # (B, S, H)
    a_log = -dt_s * torch.exp(A_log)  # (B, S, H), negative
    Bm, Cm = Bm.float(), Cm.float()
    xdt = xh * dt_s[..., None]  # (B, S, H, P)
    if state is not None:
        h0_state = state[0].float()
    else:
        h0_state = torch.zeros(B, Hl, N, P, dtype=torch.float32, device=x.device)

    if decode:
        a = torch.exp(a_log[:, 0])  # (B, H)
        upd = Bm[:, 0, None, :, None] * xdt[:, 0, :, None, :]  # (B, H, N, P)
        h_last = h0_state * a[..., None, None] + upd
        y = (Cm[:, 0, None, None, :] @ h_last)[:, None, :, 0]  # (B, 1, H, P)
    else:
        y, h_last = _ssd_chunked(xdt, a_log, Bm, Cm, h0_state, cfg.mlstm_chunk)
    y = y + D[None, None, :, None] * xh

    y = y.reshape(B, S, C)
    # gated RMSNorm (mamba2 style)
    y = y * F.silu(z.float())
    y = y * torch.rsqrt(_rms_var(y, d_inner, tp) + cfg.norm_eps) * norm_w
    dt = cfg.cdtype
    out = shd.psum(y.to(dt) @ out_w.to(dt), tp)
    return out.to(x.dtype), (h_last, new_conv)


def mamba2_init_state(cfg: ModelConfig, batch: int, device=None) -> State:
    d_inner, H, P, N = mamba2_dims(cfg)
    f32 = torch.float32
    return (
        torch.zeros(batch, H, N, P, dtype=f32, device=device),
        torch.zeros(batch, cfg.ssm_conv - 1, d_inner, dtype=f32, device=device),
    )


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, sigmoid gating, chunkwise-parallel)
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """``in_proj`` (d, 4 H hd + 2 H): q, k, v, the o gate and the i, f
    scalars per head."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, H, hd, dt = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.pdtype
        self.in_proj = _param((d, 4 * H * hd + 2 * H), dt, device)
        self.out_proj = _param((H * hd, d), dt, device)
        self.norm_w = _param((H * hd,), torch.float32, device)


def _mlstm_split(p: MLSTM, x, cfg: ModelConfig, tp=(), heads=None):
    """(q * hd^-0.5, k, v, sigmoid(o), sigmoid(i), sigmoid(f)) in float32,
    of heads ``[h0, h1)`` (all by default). ``in_proj`` is gathered whole
    (its ``qkv`` blocks do not fall on the six parts) and, under ``tp``,
    the rank takes its heads' columns of each."""
    H, hd = cfg.num_heads, cfg.head_dim
    dt = cfg.cdtype
    B, S = x.shape[:2]
    h0, h1 = heads or (0, H)
    Hl = h1 - h0
    w = shd.weight(p.in_proj, (cfg.d_model, 4 * H * hd + 2 * H), ("embed", "qkv"),
                   partial=tp).to(dt)
    if tp:
        w = w[:, _columns([(j * H * hd + h0 * hd, j * H * hd + h1 * hd) for j in range(4)]
                          + [(4 * H * hd + h0, 4 * H * hd + h1),
                             (4 * H * hd + H + h0, 4 * H * hd + H + h1)], x.device)]
    proj = shd.copy_to(x.to(dt), tp) @ w
    q, k, v, o, i_raw, f_raw = torch.split(proj, [Hl * hd] * 4 + [Hl] * 2, dim=-1)
    i_raw, f_raw = i_raw.float(), f_raw.float()
    shp = (B, S, Hl, hd)
    return (
        q.reshape(shp).float() * hd**-0.5,
        k.reshape(shp).float(),
        v.reshape(shp).float(),
        torch.sigmoid(o.reshape(shp).float()),
        torch.sigmoid(i_raw),
        torch.sigmoid(f_raw),
    )


def _mlstm_chunked(q, k, v, ig, fg, St, nt, chunk: int):
    """Chunkwise mLSTM: q, k, v (B, S, H, hd), gates (B, S, H), the carried
    (St, nt). Returns (num (B, S, H, hd), den (B, S, H), final St, nt)."""
    B, S, H, hd = q.shape
    c = min(chunk, S)
    pad = (-S) % c
    q, k, v, ig = (_pad_seq(t, pad) for t in (q, k, v, ig))
    fg = _pad_seq(fg, pad, 1.0)
    nc = (S + pad) // c

    def heads_first(t):  # (B, Sp, H, hd) -> (B, nc, H, c, hd)
        return t.reshape(B, nc, c, H, hd).transpose(2, 3)

    qc, kc, vc = heads_first(q), heads_first(k), heads_first(v)
    ic = ig.reshape(B, nc, c, H)
    lf = torch.log(fg.reshape(B, nc, c, H) + 1e-30).cumsum(2)
    # intra-chunk
    w_ts = _masked_decay(lf, _causal_mask(c, q.device)) * ic[:, :, None, :, :]  # (B, nc, t, s, H)
    sw = (qc @ kc.transpose(-1, -2)) * w_ts.permute(0, 1, 4, 2, 3)  # (B, nc, H, t, s)
    num_intra = sw @ vc  # (B, nc, H, t, hd)
    den_intra = sw.sum(-1)  # (B, nc, H, t)
    # chunk summaries
    end_decay = (torch.exp(lf[:, :, -1:, :] - lf) * ic).transpose(2, 3)  # (B, nc, H, s)
    ke = kc * end_decay[..., None]
    cS = ke.transpose(-1, -2) @ vc  # (B, nc, H, hd, hd)
    cn = ke.sum(-2)  # (B, nc, H, hd)
    cdec = torch.exp(lf[:, :, -1, :])  # (B, nc, H)
    S_prevs, n_prevs = [], []
    for j in range(nc):
        S_prevs.append(St)
        n_prevs.append(nt)
        St = St * cdec[:, j, :, None, None] + cS[:, j]
        nt = nt * cdec[:, j, :, None] + cn[:, j]
    S_prev = torch.stack(S_prevs, 1)  # (B, nc, H, hd, hd)
    n_prev = torch.stack(n_prevs, 1)  # (B, nc, H, hd)
    efl = torch.exp(lf).transpose(2, 3)  # (B, nc, H, t)
    num_inter = (qc @ S_prev) * efl[..., None]
    den_inter = (qc * n_prev[:, :, :, None, :]).sum(-1) * efl
    num = (num_intra + num_inter).transpose(2, 3).reshape(B, nc * c, H, hd)[:, :S]
    den = (den_intra + den_inter).transpose(2, 3).reshape(B, nc * c, H)[:, :S]
    return num, den, St, nt


def mlstm_apply(
    p: MLSTM,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[State] = None,
    decode: bool = False,
):
    """state = (S (B, H, hd, hd), n (B, H, hd)). Under a mesh the block
    runs tensor-parallel over its heads (``_heads_tp``): the rank's heads
    of the recurrence and of the norm (its sum of squares summed over the
    axes), ``out_proj`` row-parallel with a ``psum``; the state holds the
    rank's heads (every head where they do not split)."""
    B, S_len, d = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    tp = _heads_tp(H, (H * hd, ("qkv",)))
    h0, h1 = _rank_heads(H, tp)
    q, k, v, o, ig, fg = _mlstm_split(p, x, cfg, tp, (h0, h1))
    if state is None:
        St = torch.zeros(B, h1 - h0, hd, hd, dtype=torch.float32, device=x.device)
        nt = torch.zeros(B, h1 - h0, hd, dtype=torch.float32, device=x.device)
    else:
        St, nt = state

    if decode:
        i0 = ig[:, 0][..., None]  # (B, H, 1)
        f0 = fg[:, 0][..., None]
        St = St * f0[..., None] + k[:, 0, :, :, None] * (v[:, 0] * i0)[:, :, None, :]
        nt = nt * f0 + k[:, 0] * i0
        num = (q[:, 0, :, None, :] @ St)[:, :, 0]  # (B, H, hd)
        den = (q[:, 0] * nt).sum(-1).abs()[..., None] + 1e-6
        y = (o[:, 0] * num / den)[:, None]  # (B, 1, H, hd)
    else:
        num, den, St, nt = _mlstm_chunked(q, k, v, ig, fg, St, nt, cfg.mlstm_chunk)
        y = o * num / (den.abs()[..., None] + 1e-6)

    y = y.reshape(B, S_len, (h1 - h0) * hd)
    norm_w = shd.weight(p.norm_w, (H * hd,), ("qkv",), tp)
    y = y * torch.rsqrt(_rms_var(y, H * hd, tp) + cfg.norm_eps) * norm_w
    dt = cfg.cdtype
    out_w = shd.weight(p.out_proj, (H * hd, d), ("qkv", "embed"), tp)
    out = shd.psum(y.to(dt) @ out_w.to(dt), tp)
    return out.to(x.dtype), (St, nt)


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> State:
    H, hd = cfg.num_heads, cfg.head_dim
    f32 = torch.float32
    return (
        torch.zeros(batch, H, hd, hd, dtype=f32, device=device),
        torch.zeros(batch, H, hd, dtype=f32, device=device),
    )


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent gates; sequential)
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """``w_in`` (d, 4 H hd) and the recurrent ``r`` (H, hd, 4 hd): gates
    interleaved as (hd, 4) = [i, f, z, o] per unit; ``b`` (4 H hd) float32."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, H, hd, dt = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.pdtype
        self.w_in = _param((d, 4 * H * hd), dt, device)
        self.r = _param((H, hd, 4 * hd), dt, device)
        self.b = _param((4 * H * hd,), torch.float32, device)
        self.out_proj = _param((H * hd, d), dt, device)
        self.norm_w = _param((H * hd,), torch.float32, device)


def _slstm_cell(gates, c, n):
    """gates: (B, H, hd, 4) raw [i, f, z, o]. Stabilizer-free sigmoid
    gating. Returns (c, n, h)."""
    sg = torch.sigmoid(gates)
    i, f, o = sg[..., 0], sg[..., 1], sg[..., 3]
    z = torch.tanh(gates[..., 2])
    c_new = f * c + i * z
    n_new = f * n + i
    return c_new, n_new, o * c_new / (n_new + 1e-6)


def slstm_apply(
    p: SLSTM,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[State] = None,
    decode: bool = False,
):
    """state = (c, n, h) each (B, H, hd) float32. Sequential over time;
    decode is the same step on one token. Under a mesh the block runs
    tensor-parallel over its heads (``_heads_tp``): ``w_in``'s and ``b``'s
    blocks are head-major, so they are the rank's heads' gates, ``r`` is
    split by head; the loop runs on the rank's heads with no collective
    in it; the norm's sum of squares is summed over the axes and
    ``out_proj`` is row-parallel with a ``psum``."""
    B, S_len, d = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    dt = cfg.cdtype
    tp = _heads_tp(H, (4 * H * hd, ("qkv",)), (H * hd, ("qkv",)))
    h0, h1 = _rank_heads(H, tp)
    Hl = h1 - h0
    w_in = shd.weight(p.w_in, (d, 4 * H * hd), ("embed", "qkv"), tp)
    b = shd.weight(p.b, (4 * H * hd,), ("qkv",), tp)
    pre = (shd.copy_to(x.to(dt), tp) @ w_in.to(dt)).float() + b
    pre = pre.reshape(B, S_len, Hl, hd, 4)
    if state is not None:
        c, n, h = state
    else:
        c, n, h = (torch.zeros(B, Hl, hd, dtype=torch.float32, device=x.device) for _ in range(3))
    r = shd.weight(p.r, (H, hd, 4 * hd), ("heads", None, None), tp).float()
    ys = []
    for t in range(S_len):
        # "bhd,hdk->bhk" as one batched product over the heads
        rec = torch.bmm(h.transpose(0, 1), r).transpose(0, 1).view(B, Hl, hd, 4)
        c, n, h = _slstm_cell(pre[:, t] + rec, c, n)
        ys.append(h)

    # stacked once: a write of each step into one buffer would make autograd
    # copy the whole buffer's gradient at every step
    y = torch.stack(ys, 1).reshape(B, S_len, Hl * hd)
    norm_w = shd.weight(p.norm_w, (H * hd,), ("qkv",), tp)
    y = y * torch.rsqrt(_rms_var(y, H * hd, tp) + cfg.norm_eps) * norm_w
    out_w = shd.weight(p.out_proj, (H * hd, d), ("qkv", "embed"), tp)
    out = shd.psum(y.to(dt) @ out_w.to(dt), tp)
    return out.to(x.dtype), (c, n, h)


def slstm_init_state(cfg: ModelConfig, batch: int, device=None) -> State:
    H, hd = cfg.num_heads, cfg.head_dim
    return tuple(torch.zeros(batch, H, hd, dtype=torch.float32, device=device) for _ in range(3))
