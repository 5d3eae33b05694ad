"""Carrying state across from numpy (and so from the reference package).

In this system the "weights" are the graph, the plan and, for the GNN
layer, its three parameters; for the LM, its parameter tree and, for
training, the optimizer state. The tests take the reference's outputs
through ``np.asarray`` and these functions, and compare like with like:
index layouts are int32 on both sides.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.graph import COO, CSR
from repro_torch.core.plan import CobraPlan, HardwareModel
from repro_torch.device import resolve_device


def _int32(a, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a), dtype=np.int32)
    return torch.from_numpy(arr).to(resolve_device(device))


def coo_from_numpy(src, dst, num_nodes: int, device=None) -> COO:
    return COO(_int32(src, device), _int32(dst, device), int(num_nodes))


def csr_from_numpy(offsets, neighs, num_nodes: int, device=None) -> CSR:
    return CSR(_int32(offsets, device), _int32(neighs, device), int(num_nodes))


def plan_from_fields(
    num_indices: int, final_bin_range: int, level_fanouts: Sequence[int]
) -> CobraPlan:
    return CobraPlan(int(num_indices), int(final_bin_range), tuple(int(y) for y in level_fanouts))


def hardware_from_fields(
    name: str,
    fast_levels: Sequence[int],
    cbuffer_bytes: int,
    dram_bandwidth: float,
    fast_bandwidth: float,
) -> HardwareModel:
    return HardwareModel(
        name, tuple(int(x) for x in fast_levels), int(cbuffer_bytes),
        float(dram_bandwidth), float(fast_bandwidth),
    )


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def gnn_layer_from_numpy(params, device=None):
    """A ``GNNLayer`` holding the reference's unboxed ``init_gnn_layer``
    weights (``w_msg``, ``w_self``, ``b`` as numpy arrays)."""
    from repro_torch.models.gnn import GNNLayer

    dev = resolve_device(device)
    w_msg = np.asarray(params["w_msg"], dtype=np.float32)
    layer = GNNLayer(w_msg.shape[0], w_msg.shape[1], device=dev)
    with torch.no_grad():
        for name in ("w_msg", "w_self", "b"):
            arr = np.array(params[name], dtype=np.float32)  # a writable copy
            getattr(layer, name).copy_(torch.from_numpy(arr))
    return layer


def _torch_from_numpy(a) -> torch.Tensor:
    """A CPU tensor of ``a``'s values. numpy has no bfloat16: the
    reference's bf16 arrays arrive as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses, so their bits go across as int16."""
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _tree_node(tree, dotted: str):
    node = tree
    for key in dotted.split("."):
        node = node[key]
    return node


def _leaf_tensor(tree, name: str, device) -> torch.Tensor:
    """The leaf of the reference's tree for the port's parameter ``name``:
    layer i of the stacked leaf for ``blocks.<i>.<rest>``,
    ``enc_blocks.<i>.<rest>`` or ``dec_blocks.<i>.<rest>`` (block (c, j)
    for the hybrid's ``blocks.<c>.mamba.<j>.<rest>`` and the vlm's
    ``blocks.<c>.self.<j>.<rest>``; ``reference_leaf``)."""
    from repro_torch.train.optimizer import reference_leaf

    key, index = reference_leaf(name)
    node = _tree_node(tree, key)
    return _torch_from_numpy(node if index is None else np.asarray(node)[index]).to(device)


def train_state_from_numpy(params, opt, cfg, device=None, mesh=None):
    """A ``TrainState`` holding the reference's: ``params`` its unboxed
    parameter tree (as for ``lm_params_from_numpy``), ``opt`` its
    ``OptState`` (``step``, ``m``, ``v``: AdamW's moments trees like the
    parameters; Adafactor's ``m`` None and ``v`` a tree whose factored
    leaves are (rows, cols) pairs). AdamW's moments are split by layer
    like the parameters; Adafactor's stay the reference's stacked leaves,
    keyed ``blocks.<rest>``, ``enc_blocks.<rest>`` or ``dec_blocks.<rest>``
    (two stacking axes for the hybrid family's Mamba2 blocks and the vlm's
    self layers; ``train/optimizer.py``). On a ``mesh`` every tensor is
    the rank's block (``lm_params_from_numpy``; a moment is blocked like
    its parameter, ``optimizer.adafactor_specs`` for the factors)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.optimizer import OptState, adafactor_specs, moment_spec, reference_leaf
    from repro_torch.train.steps import TrainState

    dev = resolve_device(device)
    model = lm_params_from_numpy(params, cfg, device=dev, mesh=mesh)
    names = [n for n, _ in model.named_parameters()]
    specs = _mesh_specs(cfg, mesh)

    def block(t, spec):
        return t if mesh is None else shd.shard_of(t, spec, mesh).clone()

    step = int(np.asarray(opt.step))
    if opt.m is not None:
        m = {n: block(_leaf_tensor(opt.m, n, dev), specs and specs[n]) for n in names}
        v = {n: block(_leaf_tensor(opt.v, n, dev), specs and specs[n]) for n in names}
        return TrainState(model, OptState(step, m, v))
    v = {}
    vspecs = adafactor_specs(specs, names) if mesh is not None else {}
    for key in dict.fromkeys(reference_leaf(n)[0] for n in names):
        node = _tree_node(opt.v, key)
        if isinstance(node, (tuple, list)):
            sp = moment_spec(vspecs[key], tuple(node)) if mesh is not None else (None, None)
            v[key] = tuple(block(_torch_from_numpy(x).to(dev), s) for x, s in zip(node, sp))
        else:
            v[key] = block(_torch_from_numpy(node).to(dev), vspecs.get(key))
    return TrainState(model, OptState(step, None, v))


def _mesh_specs(cfg, mesh):
    """The parameters' specs on ``mesh`` under the config's profile (None
    without a mesh)."""
    if mesh is None:
        return None
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import param_specs

    return param_specs(cfg, mesh, shd.rules_for_profile(cfg.sharding_profile))


def load_from_numpy(module: torch.nn.Module, tree, specs=None, mesh=None,
                    device=None) -> torch.nn.Module:
    """Copy the reference's unboxed parameter tree (nested dicts of arrays)
    into ``module``, in place. Each parameter takes the leaf of its path
    with the numeric parts left out, indexed by those numbers in order: the
    reference stacks a layer's leaves along leading axes, so
    ``blocks.i.attn.wq`` is ``tree["blocks"]["attn"]["wq"][i]``, the
    hybrid family's ``blocks.i.mamba.j.mamba.in_proj`` is
    ``tree["blocks"]["mamba"]["mamba"]["in_proj"][i, j]`` and the vlm's
    ``blocks.i.self.j.attn.wq`` is ``tree["blocks"]["self"]["attn"]["wq"][i, j]``. Shapes and dtypes
    must agree, and every leaf of the tree must be used. With ``specs``
    and a ``mesh`` (the module's parameters on the meta device), each
    parameter becomes this rank's block of its leaf, on ``device``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import set_param

    used = set()
    with torch.no_grad():
        for name, p in list(module.named_parameters()):
            parts = name.split(".")
            path = tuple(k for k in parts if not k.isdigit())
            index = tuple(int(k) for k in parts if k.isdigit())
            node = tree
            for key in path:
                node = node[key]
            t = _torch_from_numpy(np.asarray(node)[index])
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(
                    f"{name}: the tree holds {tuple(t.shape)} {t.dtype}, the model wants "
                    f"{tuple(p.shape)} {p.dtype}"
                )
            if specs is None:
                p.copy_(t)
            else:
                set_param(module, name, shd.shard_of(t, specs[name], mesh).to(device).clone())
            used.add(path)

    def leaves(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, path + (k,))
        else:
            yield path

    unused = sorted(set(leaves(tree)) - used)
    if unused:
        raise ValueError(f"leaves of the tree the model has no place for: {unused}")
    return module


def lm_params_from_numpy(params, cfg, device=None, mesh=None):
    """An ``LM`` holding the reference's unboxed ``init_params`` tree, every
    ``blocks`` leaf with a leading cycle axis (two in the hybrid family's
    Mamba2 blocks and the vlm's self layers), every ``enc_blocks`` and
    ``dec_blocks`` leaf with a leading layer axis, ``shared_attn``,
    ``img_proj``, ``enc_ln`` and ``enc_pos`` with none (``load_from_numpy``; in the
    moe family ``blocks.i.moe.w1`` is ``params["blocks"]["moe"]["w1"][i]``,
    (E, d, f)). On a ``mesh`` (the rank's) each
    parameter is the rank's block by ``param_specs`` under the config's
    profile, and its local shape is the reference's
    ``NamedSharding(mesh, spec).shard_shape``."""
    from repro_torch.models.transformer import LM

    if mesh is None:
        return load_from_numpy(LM(cfg, device=device), params)
    return load_from_numpy(LM(cfg, device="meta"), params, _mesh_specs(cfg, mesh), mesh,
                           resolve_device(device))
