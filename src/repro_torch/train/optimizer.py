"""Optimizers (port of ``repro/train/optimizer.py:16-138``): AdamW and
Adafactor, written out by hand as in the reference.

Moments are kept in ``moment_dtype`` (float32); each update is computed
in float32 from the gradient scaled by the global-norm clip, weight decay
inside the step, and cast back to the parameter's dtype.
``torch.optim.AdamW`` is a different function: it keeps bf16 moments for
bf16 parameters and has neither the clip nor the schedule.

Parameters, gradients and AdamW's moments are dicts keyed like the
model's ``named_parameters()``. Adafactor factors a leaf's last two axes,
and the reference's leaves are the layer-stacked ones: its ``blocks``
norm weight is one (L, d) leaf, factored into L rows and d columns across
the layers. So Adafactor's second moments are keyed by the reference's
leaf: ``blocks.ln1.w`` for the ``blocks.<i>.ln1.w`` of every layer i, its
factors over the stacked (L, ...) shape; the hybrid family's Mamba2
leaves are stacked twice, (cycles, attn_every, ...), as
``blocks.<c>.mamba.<j>.<rest>``, and so are the vlm's self layers,
``blocks.<c>.self.<j>.<rest>``; Whisper's ``enc_blocks`` and
``dec_blocks`` are stacked once like ``blocks``; other names keep their
own key (``reference_leaf``), ``shared_attn.*`` and ``img_proj`` among
them. A stack of matrices
(the MoE's (L, E, d, f) experts too) factors each tensor's own last two
axes, so its tensors update one at a time with their slices of the
moments; a stack of vectors is stacked whole.

``apply_updates`` writes the new parameters and moments into the tensors
it is given (the reference's launcher donates its state to the step, so
the old one is gone there as well) and returns the state with the step
advanced. The step is a Python int and the learning rate a Python float,
computed in float32 on the host as the reference computes them.

On a mesh every tensor is the rank's block (``distributed/sharding.py``),
and the moments are blocked like their parameters (Adafactor's factors
like the parameter's dims they keep), which is the reference's ZeRO
layout: the global norm sums the blocks' squares over the axes each
parameter is sharded on, and Adafactor's row and column means over a
sharded dim are summed over its axes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding as shd


class OptState(NamedTuple):
    step: int
    m: Optional[Dict[str, torch.Tensor]]  # first moment (None for adafactor)
    v: Dict[str, Any]  # second moment: a tensor, or Adafactor's (rows, cols)


class OptConfig(NamedTuple):
    kind: str = "adamw"  # adamw | adafactor
    lr_peak: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def lr_schedule(oc: OptConfig, step) -> np.float32:
    """Linear warmup -> cosine decay to 10% of peak, in float32 (``step``
    an int or an integer array)."""
    f32 = np.float32
    step = np.asarray(step).astype(f32)
    warm = np.minimum(step / f32(max(oc.warmup_steps, 1)), f32(1.0))
    t = np.clip(
        (step - f32(oc.warmup_steps)) / f32(max(oc.total_steps - oc.warmup_steps, 1)),
        f32(0.0), f32(1.0),
    )
    cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t))
    return f32(oc.lr_peak) * warm * (f32(0.1) + f32(0.9) * cos)


def _factored_shape(shape):
    """Adafactor factors the last two dims when both >= 2."""
    if len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2:
        return shape[:-1], shape[:-2] + shape[-1:]
    return None


_STACKS = ("blocks", "enc_blocks", "dec_blocks")  # the reference's layer-stacked subtrees


def reference_leaf(name: str) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """(the reference's leaf, the index of ``name`` in it): the numeric
    parts of a ``blocks``, ``enc_blocks`` or ``dec_blocks`` name index the
    reference's stacked leaf, so ``blocks.3.attn.wq`` is
    ``blocks.attn.wq[3]``, the hybrid family's ``blocks.2.mamba.1.ln.w``
    is ``blocks.mamba.ln.w[2, 1]`` (stacked by cycle, then by block), the
    vlm's ``blocks.2.self.1.attn.wq`` is ``blocks.self.attn.wq[2, 1]`` and
    ``blocks.2.cross.xattn.wq`` is ``blocks.cross.xattn.wq[2]``, and
    Whisper's ``dec_blocks.4.xattn.wq`` is ``dec_blocks.xattn.wq[4]``; any
    other name (``shared_attn.*``, ``img_proj``, ``enc_ln.*``,
    ``enc_pos``) is its own leaf (index None)."""
    parts = name.split(".")
    if parts[0] not in _STACKS:
        return name, None
    return (".".join(k for k in parts if not k.isdigit()),
            tuple(int(k) for k in parts if k.isdigit()))


def _leaf_groups(names) -> Dict[str, List[str]]:
    """The reference's leaves, each with its names in stacking order."""
    groups: Dict[str, List[str]] = {}
    for n in names:
        groups.setdefault(reference_leaf(n)[0], []).append(n)
    return groups


def _leaf_shape(tensors: Dict[str, torch.Tensor], names: List[str]) -> Tuple[int, ...]:
    """The reference leaf's shape: the stacking axes, then the tensor's."""
    index = [reference_leaf(n)[1] for n in names]
    shape = tuple(tensors[names[0]].shape)
    if index[0] is None:
        return shape
    lead = tuple(max(i[a] for i in index) + 1 for a in range(len(index[0])))
    if math.prod(lead) != len(names):
        raise ValueError(f"{names[0]}: {len(names)} tensors do not fill a stack of {lead}")
    return lead + shape


def _stacked(tensors: Dict[str, torch.Tensor], names: List[str]) -> torch.Tensor:
    """The reference's float32 leaf: the tensors stacked for a ``blocks``
    leaf (in named order, which is the stack's row-major order), the
    tensor itself otherwise."""
    if reference_leaf(names[0])[1] is None:
        return tensors[names[0]].float()
    t0 = tensors[names[0]]
    out = torch.empty(_leaf_shape(tensors, names), dtype=torch.float32, device=t0.device)
    flat = out.view((len(names),) + tuple(t0.shape))
    for i, n in enumerate(names):
        flat[i].copy_(tensors[n])
    return out


def init_opt_state(params: Dict[str, torch.Tensor], oc: OptConfig) -> OptState:
    """Zero moments beside ``params`` (name -> tensor), on their devices."""
    mdt = getattr(torch, oc.moment_dtype)
    if oc.kind == "adamw":
        m = {n: torch.zeros_like(p, dtype=mdt) for n, p in params.items()}
        v = {n: torch.zeros_like(p, dtype=mdt) for n, p in params.items()}
        return OptState(0, m, v)
    if oc.kind == "adafactor":
        v = {}
        for key, names in _leaf_groups(params).items():
            p = params[names[0]]
            shape = _leaf_shape(params, names)
            fs = _factored_shape(shape)
            if fs is None:
                v[key] = torch.zeros(shape, dtype=mdt, device=p.device)
            else:
                v[key] = (torch.zeros(fs[0], dtype=mdt, device=p.device),
                          torch.zeros(fs[1], dtype=mdt, device=p.device))
        return OptState(0, None, v)
    raise ValueError(oc.kind)


def adafactor_specs(specs: Dict[str, tuple], names) -> Dict[str, Any]:
    """The spec of each Adafactor second moment (keyed by the reference's
    leaf, as ``init_opt_state``) from the parameters' ``specs``: a stack's
    leading axes unsharded, then the parameter's; a factored pair keeps the
    dims each factor keeps (rows: all but the last; columns: all but the
    second to last)."""
    out = {}
    params = {n: None for n in names}
    for key, group in _leaf_groups(params).items():
        index = reference_leaf(group[0])[1]
        spec = (None,) * (0 if index is None else len(index)) + tuple(specs[group[0]])
        out[key] = spec
    return out


def moment_spec(spec: tuple, v) -> Any:
    """A second moment's spec (or pair of specs, for factors) from its leaf's."""
    if isinstance(v, tuple):
        return spec[:-1], spec[:-2] + spec[-1:]
    return spec


def global_norm(tensors, axes=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (0-d). On a
    ``mesh`` the tensors are blocks and ``axes`` gives, for each, the axes
    it is sharded on: the block sums of squares are summed over those axes
    (a replicated tensor counts once), in a fixed order of axis sets."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))
    by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
    for x, ax in zip(tensors, axes):
        sq = torch.sum(torch.square(x.float()))
        by_axes[ax] = by_axes[ax] + sq if ax in by_axes else sq
    return torch.sqrt(sum(shd.all_reduce(by_axes[ax], ax, mesh) for ax in sorted(by_axes)))


def _mean(t: torch.Tensor, dim: int, axes, mesh, keepdim: bool = False) -> torch.Tensor:
    """``t.mean(dim)`` of the whole tensor whose block ``t`` is, when
    ``dim`` is sharded on ``axes``."""
    if not axes:
        return t.mean(dim, keepdim=keepdim)
    n = t.shape[dim] * mesh.axis_size(axes)
    return shd.all_reduce(t.sum(dim, keepdim=keepdim), axes, mesh) / n


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  state: OptState, oc: OptConfig, mesh=None, specs=None):
    """One optimizer step, in place (module docstring). Returns (params,
    new state, {"lr", "grad_norm"}); ``grad_norm`` is a 0-d float32 tensor
    on the gradients' device, taken before the clip. On a ``mesh`` the
    tensors are the rank's blocks and ``specs`` maps each parameter to its
    spec: the norm is taken over the shards, AdamW runs on the blocks, and
    Adafactor's factored means over a sharded dim are summed over its axes."""
    step = state.step + 1
    lr = float(lr_schedule(oc, step))
    if mesh is None:
        gnorm = global_norm(grads[n] for n in params)
    else:
        gnorm = global_norm([grads[n] for n in params],
                            [shd.spec_axes(specs[n]) for n in params], mesh)
    scale = torch.clamp(oc.clip_norm / (gnorm + 1e-9), max=1.0)

    def dim_axes(name, stacked=0):
        if mesh is None:
            return None
        return ((),) * stacked + tuple(shd.entry_axes(e) for e in specs[name])

    if oc.kind == "adamw":
        f32 = np.float32
        b1c = float(f32(1) - f32(oc.b1) ** f32(step))
        b2c = float(f32(1) - f32(oc.b2) ** f32(step))
        for n, p in params.items():
            g = grads[n].float() * scale
            m, v = state.m[n], state.v[n]
            m2 = oc.b1 * m.float() + (1 - oc.b1) * g
            v2 = oc.b2 * v.float() + (1 - oc.b2) * g * g
            delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + oc.eps)
            delta = delta + oc.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m2)
            v.copy_(v2)
        return params, OptState(step, state.m, state.v), {"lr": lr, "grad_norm": gnorm}

    if oc.kind == "adafactor":
        for key, names in _leaf_groups(params).items():
            v = state.v[key]
            if reference_leaf(names[0])[1] is None or params[names[0]].ndim >= 2:
                # one leaf, or a stack whose factored (or elementwise) axes are
                # each tensor's own: the stacking axes are batch axes, so each
                # tensor updates alone with its slice of the moments
                for n in names:
                    i = reference_leaf(n)[1]
                    vi = v if i is None else (tuple(t[i] for t in v) if isinstance(v, tuple)
                                              else v[i])
                    params[n].copy_(_adafactor_leaf(params[n].float(), grads[n].float() * scale,
                                                    vi, lr, oc, dim_axes(n), mesh))
            else:
                # a stack of vectors: its factors mix the stacked tensors
                stack = len(reference_leaf(names[0])[1])
                p2 = _adafactor_leaf(_stacked(params, names), _stacked(grads, names) * scale,
                                     v, lr, oc, dim_axes(names[0], stack), mesh)
                for n, row in zip(names, p2.view((len(names),) + tuple(params[names[0]].shape))):
                    params[n].copy_(row)
        return params, OptState(step, None, state.v), {"lr": lr, "grad_norm": gnorm}

    raise ValueError(oc.kind)


def _adafactor_leaf(p, g, v, lr: float, oc: OptConfig, axes=None, mesh=None) -> torch.Tensor:
    """The reference's Adafactor update of one float32 leaf ``p`` from its
    clipped gradient ``g``: the second moment ``v`` (a tensor, or the
    factored (rows, cols) pair) is updated in place; returns the new
    parameters in float32. On a ``mesh``, ``axes`` gives each dim's axes:
    the factored means over a sharded dim are reduced over them."""
    d = 1e-30
    g2 = g * g + d
    if isinstance(v, tuple):
        vr, vc = v
        a_row, a_col = (None, None) if axes is None else (axes[-1], axes[-2])
        vr.copy_(oc.b2 * vr + (1 - oc.b2) * _mean(g2, -1, a_row, mesh))
        vc.copy_(oc.b2 * vc + (1 - oc.b2) * _mean(g2, -2, a_col, mesh))
        del g2
        rfac = vr / torch.clamp(_mean(vr, -1, a_col, mesh, keepdim=True), min=d)
        precond = g / (torch.sqrt(rfac[..., None] * vc[..., None, :]) + oc.eps)
    else:
        v.copy_(oc.b2 * v + (1 - oc.b2) * g2)
        del g2
        precond = g / (torch.sqrt(v) + oc.eps)
    del g
    return p - lr * (precond + oc.weight_decay * p)
