"""The LM (port of ``repro/models/transformer.py``, all six families:
dense, moe, ssm, hybrid, vlm and encdec): parameters, the caches, the
backbone and the logits.

``LM`` holds the parameters as modules named after the reference's keys:
``embed.table``, ``final_ln.w`` and, per cycle ``i`` (the reference stacks
each leaf along a leading cycle axis and scans it; the port loops over an
``nn.ModuleList``):

- dense: ``blocks.i.ln1.w``, ``blocks.i.attn.wq`` / ``bq`` / ...,
  ``blocks.i.ln2.w``, ``blocks.i.mlp.w1`` / ``w3`` / ``w2``; in the moe
  family ``blocks.i.moe.wr`` / ``w1`` / ``w3`` / ``w2`` in place of ``mlp``
  (``layers.moe_apply``);
- ssm (xLSTM): ``blocks.i.ln_m``, ``blocks.i.mlstm``, ``blocks.i.ln_s``,
  ``blocks.i.slstm`` (``models/ssm.py``), a cycle being two layers;
- hybrid (Zamba2): ``blocks.i.mamba.j.ln`` and ``blocks.i.mamba.j.mamba``
  for ``j < attn_every`` (the reference stacks these twice, (cycles,
  attn_every, ...)), ``blocks.i.attn_ln``, and one ``shared_attn.attn`` /
  ``ln2`` / ``mlp`` that every cycle applies after its Mamba2 blocks;
- vlm (Llama-3.2-Vision): ``blocks.i.self.j`` dense layers for ``j <
  cross_attn_every - 1`` (stacked twice in the reference, (cycles,
  n_self, ...)), then ``blocks.i.cross``, a layer whose cross-attention
  (``lnx``, ``xattn``) takes the place of self-attention (``ln2``,
  ``mlp``; no ``ln1`` or ``attn``); ``img_proj`` (frontend_dim, d) turns
  the image embeddings into the cross layers' source;
- encdec (Whisper): ``enc_blocks.i`` non-causal dense layers, ``enc_ln``
  and ``enc_pos`` (encoder_seq, d) over the frame embeddings, and
  ``dec_blocks.i`` decoder layers, each with self-attention, then
  cross-attention over the encoder's output (``lnx``, ``xattn``), then
  its MLP; LayerNorm, GELU with biases and learned positions
  (``embed.pos``), no RoPE.

A cross layer runs only where it has a source (``img_embed`` or
``enc_embed``) or a cache, as in the reference: training without the
frontend input skips it (and the encoder), and the serving ``Engine``,
which passes prompts only, prefills the cross cache with keys and values
projected from the prompt itself (ROADMAP Queue 3).

Over a mesh (``distributed/sharding.py``) every family runs with each
rank's blocks: ``param_axes`` are the reference's ``Boxed`` axes, and
``init_cache(mesh=)`` gives each cache leaf its ``spec_for`` block of the
reference's names (``cache_specs``), whose specs the state carries to the
layers.

``StepState.caches`` holds the reference's cache tree with the same
leading axes: dense and moe one pair of tensors ``(L, B, S_max, KH, hd)``;
ssm ``{"mlstm": (S, n), "slstm": (c, n, h)}`` with a leading cycle axis;
hybrid ``{"mamba": (ssm, conv), "kv": (k, v)}``, the Mamba2 states with
leading (cycles, attn_every) axes; vlm ``{"self": (k, v), "cross": (k,
v)}``, self ``(cycles, n_self, B, S_max, KH, hd)`` and cross ``(cycles,
B, img_tokens, KH, hd)``; encdec ``{"self": (k, v), "cross": (k, v)}``
with a leading layer axis, the cross rows ``encoder_seq``. Recurrent states are float32 and KV
caches the compute dtype. ``StepState.index`` is a Python int, so that a
decode step never waits for the card to learn its position. Attention
writes its cache in place, and every layer copies its new recurrent state
into its slice of the cache.

Training: ``hidden_forward`` under autograd with ``cfg.remat`` recomputes
each cycle in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` scan body: a dense or moe layer, an xLSTM cycle's
mLSTM and sLSTM, a Zamba2 cycle's ``attn_every`` Mamba2 blocks with the
shared block, a vlm cycle's self layers and cross layer, a Whisper
decoder layer; Whisper's encoder layers are not recomputed, as the
reference's encoder loop is not checkpointed), and ``chunked_lm_loss`` recomputes each
sequence chunk's logits, so neither the layers' activations nor the
(B, S, V) logits are held whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import winit_


class StepState(NamedTuple):
    """Decode-time state: the cache tree (see the module docstring), the
    next write position and, on a mesh, the tree of the leaves' specs
    (``LeafSpec``; each tensor is the rank's block by its spec)."""

    caches: Any  # a tuple or dict of tuples of stacked tensors
    index: int
    specs: Any = None


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A cache leaf's spec (``sharding.spec_for`` entries) and the index
    of its batch dim, in a spec tree; not a tuple, so that ``map_cache``
    takes it for a leaf."""

    entries: tuple
    batch: int

    def inner(self) -> "LeafSpec":
        """The spec of one slice along the leading (stacking) axis."""
        return LeafSpec(self.entries[1:], self.batch - 1)


def rows_entry(state: StepState):
    """The spec entry a mesh state's batch dim is split on (None: whole,
    or a state without a mesh)."""
    if state.specs is None:
        return None
    leaf = cache_leaves(state.specs)[0]
    return leaf.entries[leaf.batch]


def batch_entry(mesh, batch: int, layout_batch: Optional[int] = None, rules=None):
    """The spec entry of ``batch`` rows laid out as for ``layout_batch``
    rows (``cache_specs``): their split when it is the layout's, else
    None (every rank holds them whole, as without a ``mesh``)."""
    if mesh is None:
        return None
    rules = rules or shd.active_rules()
    whole = shd.spec_for(mesh, (batch,), ("batch",), rules)[0]
    return whole if whole == shd.spec_for(mesh, (layout_batch or batch,), ("batch",), rules)[0] \
        else None


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def _num_cycles(cfg: ModelConfig) -> int:
    """Cycles of the stack (decoder layers in the encdec family)."""
    if cfg.family == "vlm":
        if cfg.num_layers % cfg.cross_attn_every:
            raise ValueError(
                f"{cfg.num_layers} layers do not split into cycles of {cfg.cross_attn_every}")
        return cfg.num_layers // cfg.cross_attn_every
    if cfg.family == "hybrid":
        if cfg.num_layers % cfg.attn_every:
            raise ValueError(f"{cfg.num_layers} layers do not split into cycles of {cfg.attn_every}")
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "ssm":
        if cfg.num_layers % 2:
            raise ValueError(f"xLSTM cycles are (mLSTM, sLSTM) pairs, got {cfg.num_layers} layers")
        return cfg.num_layers // 2
    return cfg.num_layers


def attention_layers(cfg: ModelConfig) -> int:
    """Attention applications in one prefill without a frontend input (the
    serving ``Engine``'s): every layer (dense, moe, vlm: its self and its
    cross layers), none (ssm), the shared block once per cycle (hybrid),
    each decoder layer's self- and cross-attention (encdec; the encoder
    runs only on frame embeddings)."""
    return {"ssm": 0, "hybrid": _num_cycles(cfg),
            "encdec": 2 * cfg.num_layers}.get(cfg.family, cfg.num_layers)


class DenseBlock(nn.Module):
    """A transformer layer: ``ln1`` and ``attn`` (self-attention; absent in
    a vlm cross layer), ``lnx`` and ``xattn`` (cross-attention; vlm cross
    and encdec decoder layers), ``ln2`` and ``mlp`` (``moe`` in the moe
    family)."""

    def __init__(self, cfg: ModelConfig, device, cross: bool = False, self_attn: bool = True):
        super().__init__()
        self.ln1 = L.Norm(cfg, device) if self_attn else None
        self.attn = L.Attention(cfg, device) if self_attn else None
        self.ln2 = L.Norm(cfg, device)
        if cfg.family == "moe":
            self.moe = L.MoE(cfg, device)
        else:
            self.mlp = L.MLP(cfg, device)
        self.lnx = L.Norm(cfg, device) if cross else None
        self.xattn = L.Attention(cfg, device) if cross else None


class SSMCycle(nn.Module):
    """An xLSTM cycle: mLSTM then sLSTM, each behind its own norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln_m = L.Norm(cfg, device)
        self.mlstm = SSM.MLSTM(cfg, device)
        self.ln_s = L.Norm(cfg, device)
        self.slstm = SSM.SLSTM(cfg, device)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln = L.Norm(cfg, device)
        self.mamba = SSM.Mamba2(cfg, device)


class HybridCycle(nn.Module):
    """A Zamba2 cycle: ``attn_every`` Mamba2 blocks, then the shared
    attention block behind this cycle's own (unshared) norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.mamba = nn.ModuleList(MambaBlock(cfg, device) for _ in range(cfg.attn_every))
        self.attn_ln = L.Norm(cfg, device)


class VLMCycle(nn.Module):
    """A Llama-3.2-Vision cycle: ``cross_attn_every - 1`` dense layers
    (``self.<j>``), then the cross layer (``cross``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.add_module("self", nn.ModuleList(
            DenseBlock(cfg, device) for _ in range(cfg.cross_attn_every - 1)))
        self.cross = DenseBlock(cfg, device, cross=True, self_attn=False)


class SharedAttn(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, device)


_CYCLES = {"dense": DenseBlock, "moe": DenseBlock, "ssm": SSMCycle, "hybrid": HybridCycle,
           "vlm": VLMCycle}


class LM(nn.Module):
    """Parameters of an LM, allocated on ``device`` (default: the CUDA
    card) and not yet set: ``init_params`` draws them,
    ``repro_torch.convert.lm_params_from_numpy`` copies the reference's.
    The encdec family has ``enc_blocks`` and ``dec_blocks`` and no
    ``blocks``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = L.Embedding(cfg, dev)
        self.final_ln = L.Norm(cfg, dev)
        self.blocks = self.shared_attn = self.img_proj = None
        if cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(
                DenseBlock(cfg, dev) for _ in range(cfg.encoder_layers))
            self.dec_blocks = nn.ModuleList(
                DenseBlock(cfg, dev, cross=True) for _ in range(cfg.num_layers))
            self.enc_ln = L.Norm(cfg, dev)
            self.enc_pos = L._param((cfg.encoder_seq or 1500, cfg.d_model), cfg.pdtype, dev)
            return
        cycle = _CYCLES[cfg.family]
        self.blocks = nn.ModuleList(cycle(cfg, dev) for _ in range(_num_cycles(cfg)))
        if cfg.family == "hybrid":
            self.shared_attn = SharedAttn(cfg, dev)
        if cfg.family == "vlm":
            self.img_proj = L._param((cfg.frontend_dim or cfg.d_model, cfg.d_model), cfg.pdtype,
                                     dev)


MESH_FAMILIES = PORTED_FAMILIES  # every family runs over a mesh

# the reference's logical axis names of a leaf (its ``Boxed`` axes), by the
# module that holds it and the leaf's name; a norm's w and b are
# ("embed_act",), as is every other leaf not named here
_ATTN_AXES = {"wq": ("embed", "qkv"), "wk": ("embed", "qkv"), "wv": ("embed", "qkv"),
              "wo": ("qkv", "embed"), "bq": ("qkv",), "bk": ("qkv",), "bv": ("qkv",)}
_AXES = {
    "attn": _ATTN_AXES,
    "xattn": _ATTN_AXES,
    "mlp": {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"), "w2": ("mlp", "embed"),
            "b1": ("mlp",), "b2": ("embed_act",)},
    "moe": dict(L.MOE_NAMES),
    "embed": {"table": ("vocab", "embed"), "unembed": ("embed", "vocab"),
              "pos": (None, "embed")},
    "mamba": {"in_proj": ("embed", "mlp"), "conv_w": ("conv", "mlp"), "A_log": ("state",),
              "D": ("state",), "dt_bias": ("state",), "norm_w": ("mlp",),
              "out_proj": ("mlp", "embed")},
    "mlstm": {"in_proj": ("embed", "qkv"), "out_proj": ("qkv", "embed"), "norm_w": ("qkv",)},
    "slstm": {"w_in": ("embed", "qkv"), "r": ("heads", None, None), "b": ("qkv",),
              "out_proj": ("qkv", "embed"), "norm_w": ("qkv",)},
}
_TOP_AXES = {"img_proj": (None, "embed"), "enc_pos": (None, "embed")}


def param_axes(cfg: ModelConfig) -> dict:
    """Every parameter's logical axis names (the reference's ``Boxed``
    axes), keyed by the port's parameter names; a ``blocks.<i>`` leaf has
    one layer's names (the reference's stacked leaf adds ``layers`` in
    front, once a stacking axis, which no rule shards)."""
    out = {}
    for name, _ in LM(cfg, "meta").named_parameters():
        parts = name.split(".")
        table = _AXES.get(parts[-2], {}) if len(parts) > 1 else _TOP_AXES
        out[name] = table.get(parts[-1], ("embed_act",))
    return out


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's whole shape (one layer's for ``blocks.<i>``)."""
    return {n: tuple(p.shape) for n, p in LM(cfg, "meta").named_parameters()}


def param_specs(cfg: ModelConfig, mesh, rules=None) -> dict:
    """Every parameter's spec on ``mesh`` (``spec_for`` of its whole
    shape and names under ``rules``, default the active ones)."""
    axes, shapes = param_axes(cfg), param_shapes(cfg)
    return {n: shd.spec_for(mesh, shapes[n], axes[n], rules) for n in axes}


def set_param(model: nn.Module, name: str, t: torch.Tensor) -> None:
    """Replace parameter ``name`` of ``model`` by a new one holding ``t``."""
    mod_name, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(mod_name), leaf, nn.Parameter(t, requires_grad=True))


_INIT_ONES = ("w", "D", "norm_w")  # norm weights and Mamba2's skip D
_INIT_ZEROS = ("A_log", "dt_bias")  # and every leaf whose name starts with "b": biases


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device=None, mesh=None) -> LM:
    """An ``LM`` with the reference's init rule, leaf by leaf (``layers.py``
    and ``ssm.py`` init_*): truncated-normal projections scaled by fan-in,
    the leading axis (so an expert's ``w1`` / ``w3`` (E, d, f) by E^-0.5,
    and a Mamba2 ``conv_w`` (K, d_inner) by K^-0.5, as in the reference;
    ``wo`` by (H hd)^-0.5, ``w2`` by d_ff^-0.5, the sLSTM's ``r`` by
    hd^-0.5, the embedding by 1.0; the vlm's ``img_proj`` by
    frontend_dim^-0.5, Whisper's ``enc_pos`` by encoder_seq^-0.5 and
    ``embed.pos`` by learned_pos^-0.5), norm weights and Mamba2's ``D`` one,
    biases, ``A_log`` and ``dt_bias`` zero; drawn from a generator seeded
    with ``seed`` on the device. On a ``mesh`` (the rank's) each leaf is
    drawn whole, in the same order, and the rank keeps its block by
    ``param_specs`` under the config's profile: the weights are the
    single-device ones, and the transient is one leaf."""
    dev = resolve_device(device)
    if mesh is None:
        model = LM(cfg, dev)
        for _ in init_leaves(cfg, seed, dev, model):
            pass
        return model
    model = LM(cfg, "meta")
    specs = param_specs(cfg, mesh, shd.rules_for_profile(cfg.sharding_profile))
    for name, p in init_leaves(cfg, seed, dev):
        set_param(model, name, shd.shard_of(p, specs[name], mesh).clone())
        del p
    return model


@torch.no_grad()
def init_leaves(cfg: ModelConfig, seed: int = 0, device=None, model: Optional[LM] = None):
    """Yield (name, whole initial value) of every parameter in order, by
    ``init_params``'s rule, one leaf at a time; into ``model``'s own
    tensors when given (else each is a new tensor on ``device``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, hd, f = cfg.num_heads, cfg.head_dim, cfg.d_ff
    scale = {"wo": (H * hd) ** -0.5, "table": 1.0, "r": hd**-0.5}
    if f:  # xLSTM has no MLP (d_ff 0)
        scale["w2"] = f**-0.5
    for name, p in list((model or LM(cfg, "meta")).named_parameters()):
        if model is None:
            p = torch.empty(p.shape, dtype=p.dtype, device=dev)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _INIT_ONES:
            p.fill_(1.0)
        elif leaf in _INIT_ZEROS or leaf.startswith("b"):
            p.zero_()
        else:
            winit_(p, gen, scale.get(leaf))
        yield name, p


_KV = ("batch", "seq_kv", "kv_heads", None)  # the reference's cache axes (transformer.py:159-187)
_HEADS4 = ("batch", "heads", None, None)
_HEADS3 = ("batch", "heads", None)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A cache leaf to be: its shape, logical names and dtype (not a tuple,
    so that ``map_cache`` takes it for a leaf)."""

    shape: tuple
    names: tuple
    dtype: torch.dtype


def _cache_tree(cfg: ModelConfig, batch: int, max_len: int, img_tokens: int = 0):
    """The cache tree as ``_Leaf``s (shape, logical names, dtype); the
    stacking axes in front are named ``layers``, as ``stack_boxed`` names
    them."""
    nc = _num_cycles(cfg)
    f32 = torch.float32

    def leaf(lead, shape, names, dtype=f32):
        return _Leaf(tuple(lead) + tuple(shape), ("layers",) * len(lead) + tuple(names), dtype)

    def kv(lead, rows=max_len):
        k = leaf(lead, (batch, rows, cfg.num_kv_heads, cfg.head_dim), _KV, cfg.cdtype)
        return (k, k)

    if cfg.family == "ssm":
        H, hd = cfg.num_heads, cfg.head_dim
        return {"mlstm": (leaf((nc,), (batch, H, hd, hd), _HEADS4),
                          leaf((nc,), (batch, H, hd), _HEADS3)),
                "slstm": tuple(leaf((nc,), (batch, H, hd), _HEADS3) for _ in range(3))}
    if cfg.family == "hybrid":
        d_inner, H, P, N = SSM.mamba2_dims(cfg)
        lead = (nc, cfg.attn_every)
        return {"mamba": (leaf(lead, (batch, H, N, P), _HEADS4),
                          leaf(lead, (batch, cfg.ssm_conv - 1, d_inner), ("batch", None, "mlp"))),
                "kv": kv((nc,))}
    if cfg.family == "vlm":
        return {"self": kv((nc, cfg.cross_attn_every - 1)),
                "cross": kv((nc,), img_tokens or cfg.num_image_tokens)}
    if cfg.family == "encdec":
        return {"self": kv((nc,)), "cross": kv((nc,), cfg.encoder_seq or 1500)}
    return kv((nc,))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh, img_tokens: int = 0,
                layout_batch: Optional[int] = None, rules=None):
    """The tree of every cache leaf's spec (``LeafSpec``) on ``mesh``:
    ``spec_for`` of its shape and the reference's names under ``rules``
    (default the active ones). ``layout_batch``: lay the leaves out as for
    that many rows (an engine's slots) and hold the ``batch`` rows whole on
    every rank unless they split the same way: the one-row prefill the
    engine splices into its slots."""
    rules = rules or shd.active_rules()
    tree = _cache_tree(cfg, layout_batch or batch, max_len, img_tokens)
    rows = batch_entry(mesh, batch, layout_batch, rules)

    def spec(leaf):
        entries = list(shd.spec_for(mesh, leaf.shape, leaf.names, rules))
        b = leaf.names.index("batch")
        entries[b] = rows
        return LeafSpec(tuple(entries), b)

    return map_cache(spec, tree)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               img_tokens: int = 0, mesh=None, layout_batch: Optional[int] = None,
               rules=None) -> StepState:
    """A zero cache of ``batch`` sequences of ``max_len`` positions, index
    0: the KV caches in the compute dtype, the recurrent states in float32
    (the reference's ``init_cache``). The vlm's cross caches hold
    ``img_tokens`` rows (default ``num_image_tokens``), Whisper's
    ``encoder_seq``. On a ``mesh`` each leaf is the rank's block by
    ``cache_specs`` (``layout_batch``, ``rules``: its), and the state holds
    the specs."""
    dev = resolve_device(device)
    tree = _cache_tree(cfg, batch, max_len, img_tokens)
    if mesh is None:
        return StepState(map_cache(lambda lf: torch.zeros(lf.shape, dtype=lf.dtype, device=dev),
                                     tree), 0)
    specs = cache_specs(cfg, batch, max_len, mesh, img_tokens, layout_batch, rules)
    leaves = iter(cache_leaves(specs))

    def zeros(lf):
        return torch.zeros(shd.shard_shape(lf.shape, next(leaves).entries, mesh), dtype=lf.dtype,
                           device=dev)

    return StepState(map_cache(zeros, tree), 0, specs)


def map_cache(fn, caches):
    """``caches`` with ``fn`` applied to each tensor, in the same tuple and
    dict structure."""
    if isinstance(caches, dict):
        return {k: map_cache(fn, v) for k, v in caches.items()}
    if isinstance(caches, (tuple, list)):
        return tuple(map_cache(fn, v) for v in caches)
    return fn(caches)


def cache_leaves(caches) -> list:
    """The tensors of a cache tree, in its order."""
    out = []
    map_cache(out.append, caches)
    return out


def _store(dst, src) -> None:
    """Copy a new recurrent state tuple into its slice of the cache."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _kv_spec(spec):
    """A (k, v) pair's spec tree as ``attention_apply``'s ``cache_spec``."""
    return None if spec is None else spec[0].entries


def _apply_dense_layer(pl: DenseBlock, x, cfg, positions, cache, cache_index, causal=True,
                       cross_src=None, cross_cache=None, decode=False, spec=None,
                       cross_spec=None):
    """One layer (reference ``_apply_dense_layer``). ``cross_src``: the
    source to project the cross keys and values from (train, prefill);
    ``cross_cache``: the cross cache, written at 0 (prefill) or read as it
    stands (``decode``). Without either, a cross layer skips its
    cross-attention. ``spec``, ``cross_spec``: the caches' spec trees on a
    mesh."""
    if pl.attn is not None:
        h = L.apply_norm(pl.ln1, x, cfg)
        attn_out, _ = L.attention_apply(
            pl.attn, h, cfg, positions=positions, cache=cache, cache_index=cache_index,
            causal=causal, cache_spec=_kv_spec(spec),
        )
        x = x + attn_out
    if pl.xattn is not None and (cross_src is not None or cross_cache is not None):
        h = L.apply_norm(pl.lnx, x, cfg)
        read_only = decode and cross_cache is not None  # k and v were projected at prefill
        xo, _ = L.attention_apply(
            pl.xattn, h, cfg, kv_src=None if read_only else cross_src, cache=cross_cache,
            cache_index=None if read_only or cross_cache is None else 0, causal=False,
            cache_spec=_kv_spec(cross_spec),
        )
        x = x + xo
    h = L.apply_norm(pl.ln2, x, cfg)
    if cfg.family == "moe":
        return x + L.moe_apply(pl.moe, h, cfg)
    return x + L.mlp_apply(pl.mlp, h, cfg)


def _apply_ssm_cycle(pc: SSMCycle, x, cfg, cache, decode):
    h = L.apply_norm(pc.ln_m, x, cfg)
    st = cache["mlstm"] if cache is not None else None
    out, new_m = SSM.mlstm_apply(pc.mlstm, h, cfg, state=st, decode=decode)
    x = x + out
    h = L.apply_norm(pc.ln_s, x, cfg)
    st = cache["slstm"] if cache is not None else None
    out, new_s = SSM.slstm_apply(pc.slstm, h, cfg, state=st, decode=decode)
    if cache is not None:
        _store(cache["mlstm"], new_m)
        _store(cache["slstm"], new_s)
    return x + out


def _apply_hybrid_cycle(pc: HybridCycle, shared: SharedAttn, x, cfg, positions, cache, index,
                        decode, spec=None):
    for j, blk in enumerate(pc.mamba):
        st = None if cache is None else tuple(a[j] for a in cache["mamba"])
        h = L.apply_norm(blk.ln, x, cfg)
        out, new_st = SSM.mamba2_apply(blk.mamba, h, cfg, state=st, decode=decode)
        x = x + out
        if cache is not None:
            _store(st, new_st)
    # the shared attention block (weights shared; the cycle's own norm)
    h = L.apply_norm(pc.attn_ln, x, cfg)
    kv = cache["kv"] if cache is not None else None
    attn_out, _ = L.attention_apply(
        shared.attn, h, cfg, positions=positions, cache=kv, cache_index=index, causal=True,
        cache_spec=None if spec is None else _kv_spec(spec["kv"]),
    )
    x = x + attn_out
    h = L.apply_norm(shared.ln2, x, cfg)
    return x + L.mlp_apply(shared.mlp, h, cfg)


def _apply_vlm_cycle(pc: VLMCycle, x, cfg, positions, cache, index, kv_src, decode, spec=None):
    for j, blk in enumerate(pc.self):
        kv = None if cache is None else tuple(a[j] for a in cache["self"])
        sp = None if spec is None else tuple(a.inner() for a in spec["self"])
        x = _apply_dense_layer(blk, x, cfg, positions, kv, index, spec=sp)
    return _apply_dense_layer(pc.cross, x, cfg, positions, None, None, cross_src=kv_src,
                              cross_cache=None if cache is None else cache["cross"],
                              decode=decode, cross_spec=None if spec is None else spec["cross"])


def _apply_cycle(pc, shared, x, cfg, positions, cache, index, decode, kv_src=None, spec=None):
    """One cycle of ``cfg.family`` (a decoder layer in the encdec family);
    ``cache`` is this cycle's slice of the cache tree (or None), updated
    in place, ``spec`` its spec tree on a mesh; ``kv_src`` the cross
    layers' source."""
    if cfg.family == "ssm":
        return _apply_ssm_cycle(pc, x, cfg, cache, decode)
    if cfg.family == "hybrid":
        return _apply_hybrid_cycle(pc, shared, x, cfg, positions, cache, index, decode, spec)
    if cfg.family == "vlm":
        return _apply_vlm_cycle(pc, x, cfg, positions, cache, index, kv_src, decode, spec)
    if cfg.family == "encdec":
        return _apply_dense_layer(pc, x, cfg, positions,
                                  None if cache is None else cache["self"], index,
                                  cross_src=kv_src,
                                  cross_cache=None if cache is None else cache["cross"],
                                  decode=decode, spec=None if spec is None else spec["self"],
                                  cross_spec=None if spec is None else spec["cross"])
    return _apply_dense_layer(pc, x, cfg, positions, cache, index, spec=spec)


def _encode(params: LM, enc_embed, cfg: ModelConfig):
    """Whisper's encoder over frame embeddings (B, T, d): learned positions,
    ``encoder_layers`` non-causal dense layers (not recomputed under
    remat, as in the reference), then ``enc_ln``."""
    dt = cfg.cdtype
    enc = enc_embed.to(dt)
    pos = shd.weight(params.enc_pos, (cfg.encoder_seq or 1500, cfg.d_model), _TOP_AXES["enc_pos"])
    enc = enc + pos[:enc.shape[1]].to(dt)[None]
    for blk in params.enc_blocks:
        enc = _apply_dense_layer(blk, enc, cfg, None, None, None, causal=False)
    return L.apply_norm(params.enc_ln, enc, cfg)


def hidden_forward(
    params: LM,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    img_embed: Optional[torch.Tensor] = None,
    enc_embed: Optional[torch.Tensor] = None,
    state: Optional[StepState] = None,
    decode: bool = False,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[StepState]]:
    """Backbone only: (final-norm hidden (B, S, d), new state). With a
    state, each cycle writes its caches in place and the new state's index
    is the old one plus S. ``decode`` takes the recurrent layers' one-token
    step (S must be 1 there) and reads the cross caches as they stand.
    ``img_embed`` (B, img_tokens, frontend_dim; vlm) and ``enc_embed`` (B,
    frames, d; encdec) are the frontends' outputs, the cross layers'
    sources. Under autograd, without a state and with ``cfg.remat``, each
    cycle keeps only its input (and the cross source) and is recomputed in
    the backward."""
    B, S = tokens.shape
    if shd.active_mesh() is not None and state is not None and state.specs is None:
        raise ValueError("a state over a mesh holds its leaves' specs (init_cache(mesh=))")
    if positions is None:
        base = state.index if (state is not None and decode) else 0
        positions = (base + torch.arange(S, dtype=torch.int32, device=tokens.device)).expand(B, S)
    x = L.embed_apply(params.embed, tokens, cfg, positions=positions)
    index = state.index if state is not None else None
    remat = cfg.remat and state is None and torch.is_grad_enabled()
    shared = params.shared_attn
    kv_src = None
    if cfg.family == "vlm" and img_embed is not None:
        img_proj = shd.weight(params.img_proj, (cfg.frontend_dim or cfg.d_model, cfg.d_model),
                              _TOP_AXES["img_proj"])
        kv_src = img_embed.to(cfg.cdtype) @ img_proj.to(cfg.cdtype)
    blocks = params.blocks
    if cfg.family == "encdec":
        if enc_embed is not None:
            kv_src = _encode(params, enc_embed, cfg)
        blocks = params.dec_blocks
    for i, blk in enumerate(blocks):
        if remat:
            x = checkpoint(_apply_cycle, blk, shared, x, cfg, positions, None, None, decode,
                           kv_src, use_reentrant=False)
        else:
            cache = None if state is None else map_cache(lambda a: a[i], state.caches)
            spec = None if state is None or state.specs is None else map_cache(
                LeafSpec.inner, state.specs)
            x = _apply_cycle(blk, shared, x, cfg, positions, cache, index, decode, kv_src, spec)
    new_state = None if state is None else StepState(state.caches, state.index + S, state.specs)
    return L.apply_norm(params.final_ln, x, cfg), new_state


def forward(params: LM, tokens, cfg: ModelConfig, **kw):
    """Full logits (B, S, V_pad) and the new state."""
    hidden, new_state = hidden_forward(params, tokens, cfg, **kw)
    return L.logits_apply(params.embed, hidden, cfg), new_state


def last_logits(params: LM, hidden, cfg: ModelConfig) -> torch.Tensor:
    """float32 logits (B, V_pad) of the final position only (prefill)."""
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
    params: LM, hidden: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean next-token cross entropy without materialising (B, S, V): a
    loop over sequence chunks of ``chunk`` positions (the last one may be
    shorter; the reference pads it with label -1, which adds nothing),
    each chunk's logits recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's checkpointed scan
    (``transformer.py:471-510``). Labels < 0 are masked; float32. Under a
    mesh, ``hidden`` and ``labels`` are the rank's rows, the chunks' NLL
    comes from the vocab-parallel logits, and the sum is divided by the
    count of labelled tokens over all rows of the batch: the ranks' losses
    add up to the global mean. The vocabulary's weight is gathered once
    for all chunks there."""
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    fn, lead = _chunk_nll_sum, (params.embed,)
    if shd.active_mesh() is not None:
        fn, lead = L.vocab_parallel_nll_sum, L.vocab_weight(params.embed, cfg)
    for s in range(0, hidden.shape[1], chunk):
        h, lab = hidden[:, s:s + chunk], labels[:, s:s + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(fn, *lead, h, lab, cfg, use_reentrant=False)
        else:
            part = fn(*lead, h, lab, cfg)
        tot = tot + part
    count = (labels >= 0).sum()
    if shd.active_mesh() is not None:
        count = shd.all_reduce(count, shd.split_axes())
    return tot / count.clamp(min=1)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Next-token cross entropy; positions with label < 0 are masked;
    padded-vocab logits are excluded from the softmax."""
    valid = (labels >= 0).sum()
    return _masked_nll_sum(logits, labels, vocab_size) / valid.clamp(min=1)
