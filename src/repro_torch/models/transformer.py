"""Dense decoder-only LM (port of the dense family of
``repro/models/transformer.py``): parameters, the KV cache, the backbone
and the logits.

``DenseLM`` holds the parameters as modules named after the reference's
keys: ``embed.table``, ``final_ln.w`` and, per layer ``i``,
``blocks.i.ln1.w``, ``blocks.i.attn.wq`` / ``bq`` / ..., ``blocks.i.ln2.w``,
``blocks.i.mlp.w1`` / ``w3`` / ``w2`` (the reference stacks each of these
along a leading layer axis and scans it; the port loops over an
``nn.ModuleList``). The other families (moe, vlm, ssm, hybrid, encdec)
raise ``NotImplementedError``: they wait for ROADMAP Queue 1 item 2.

The cache is one pair of tensors ``(L, B, S_max, KH, hd)``, layer i's
``(B, S_max, KH, hd)`` view being the reference's per-layer cache, and
``StepState.index`` is a Python int, so that a decode step never waits
for the card to learn its position. Attention writes the cache in place.

Training: ``hidden_forward`` under autograd with ``cfg.remat`` recomputes
each layer in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` scan body), and ``chunked_lm_loss`` recomputes each
sequence chunk's logits, so neither the layers' activations nor the
(B, S, V) logits are held whole.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import winit_


class StepState(NamedTuple):
    """Decode-time state: the stacked (k, v) cache and the next write
    position."""

    caches: Tuple[torch.Tensor, torch.Tensor]  # each (L, B, S_max, KH, hd)
    index: int


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the port runs "
            "the dense family (ROADMAP Queue 1 item 2)"
        )


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, device)


class DenseLM(nn.Module):
    """Parameters of a dense LM, allocated on ``device`` (default: the CUDA
    card) and not yet set: ``init_params`` draws them,
    ``repro_torch.convert.lm_params_from_numpy`` copies the reference's."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _require_dense(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = L.Embedding(cfg, dev)
        self.final_ln = L.Norm(cfg, dev)
        self.blocks = nn.ModuleList(DenseBlock(cfg, dev) for _ in range(cfg.num_layers))


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> DenseLM:
    """A ``DenseLM`` with the reference's init rule (``layers.py`` init_*):
    truncated-normal projections scaled by fan-in (``wo`` by (H hd)^-0.5,
    ``w2`` by d_ff^-0.5, the embedding by 1.0), norm weights one, biases
    zero; drawn from a generator seeded with ``seed`` on the device."""
    model = DenseLM(cfg, device)
    dev = model.embed.table.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, hd, f = cfg.num_heads, cfg.head_dim, cfg.d_ff
    scale = {"wo": (H * hd) ** -0.5, "w2": f**-0.5, "table": 1.0}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w":  # a norm's weight
            p.fill_(1.0)
        elif leaf.startswith("b"):
            p.zero_()
        else:
            winit_(p, gen, scale.get(leaf))
    return model


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> StepState:
    """A zero cache of ``batch`` sequences of ``max_len`` positions in the
    compute dtype, index 0."""
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    k = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
    return StepState(caches=(k, torch.zeros_like(k)), index=0)


def _apply_dense_layer(pl: DenseBlock, x, cfg, positions, cache, cache_index):
    h = L.apply_norm(pl.ln1, x, cfg)
    attn_out, _ = L.attention_apply(
        pl.attn, h, cfg, positions=positions, cache=cache, cache_index=cache_index, causal=True
    )
    x = x + attn_out
    h = L.apply_norm(pl.ln2, x, cfg)
    return x + L.mlp_apply(pl.mlp, h, cfg)


def hidden_forward(
    params: DenseLM,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: Optional[StepState] = None,
    decode: bool = False,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[StepState]]:
    """Backbone only: (final-norm hidden (B, S, d), new state). With a
    state, each layer writes its cache in place and the new state's index
    is the old one plus S. Under autograd, without a state and with
    ``cfg.remat``, each layer keeps only its input and is recomputed in the
    backward."""
    _require_dense(cfg)
    B, S = tokens.shape
    if positions is None:
        base = state.index if (state is not None and decode) else 0
        positions = (base + torch.arange(S, dtype=torch.int32, device=tokens.device)).expand(B, S)
    x = L.embed_apply(params.embed, tokens, cfg, positions=positions)
    index = state.index if state is not None else None
    remat = cfg.remat and state is None and torch.is_grad_enabled()
    for i, blk in enumerate(params.blocks):
        if remat:
            x = checkpoint(_apply_dense_layer, blk, x, cfg, positions, None, None,
                           use_reentrant=False)
        else:
            cache = None if state is None else (state.caches[0][i], state.caches[1][i])
            x = _apply_dense_layer(blk, x, cfg, positions, cache, index)
    new_state = None if state is None else StepState(state.caches, state.index + S)
    return L.apply_norm(params.final_ln, x, cfg), new_state


def forward(params: DenseLM, tokens, cfg: ModelConfig, **kw):
    """Full logits (B, S, V_pad) and the new state."""
    hidden, new_state = hidden_forward(params, tokens, cfg, **kw)
    return L.logits_apply(params.embed, hidden, cfg), new_state


def last_logits(params: DenseLM, hidden, cfg: ModelConfig):
    """Logits of the final position only (prefill)."""
    return L.logits_apply(params.embed, hidden[:, -1:], cfg)[:, 0]


def _masked_nll_sum(logits, labels, vocab_size: int) -> torch.Tensor:
    """Sum of the next-token NLL over positions with ``label >= 0``; the
    padded-vocab logits are set to -1e30 before the float32 softmax."""
    V_pad = logits.shape[-1]
    if V_pad > vocab_size:
        pad = torch.arange(V_pad, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logp = F.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    nll = -logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    return (nll * valid).sum()


def _chunk_nll_sum(embed: L.Embedding, h, labels, cfg: ModelConfig) -> torch.Tensor:
    return _masked_nll_sum(L.logits_apply(embed, h, cfg), labels, cfg.vocab_size)


def chunked_lm_loss(
    params: DenseLM, hidden: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean next-token cross entropy without materialising (B, S, V): a
    loop over sequence chunks of ``chunk`` positions (the last one may be
    shorter; the reference pads it with label -1, which adds nothing),
    each chunk's logits recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's checkpointed scan
    (``transformer.py:471-510``). Labels < 0 are masked; float32."""
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, hidden.shape[1], chunk):
        h, lab = hidden[:, s:s + chunk], labels[:, s:s + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_nll_sum, params.embed, h, lab, cfg, use_reentrant=False)
        else:
            part = _chunk_nll_sum(params.embed, h, lab, cfg)
        tot = tot + part
    return tot / (labels >= 0).sum().clamp(min=1)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Next-token cross entropy; positions with label < 0 are masked;
    padded-vocab logits are excluded from the softmax."""
    valid = (labels >= 0).sum()
    return _masked_nll_sum(logits, labels, vocab_size) / valid.clamp(min=1)
