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
    layer i of the stacked leaf for ``blocks.<i>.<rest>``."""
    from repro_torch.train.optimizer import reference_leaf

    key, layer = reference_leaf(name)
    node = _tree_node(tree, key)
    return _torch_from_numpy(node if layer is None else np.asarray(node)[layer]).to(device)


def train_state_from_numpy(params, opt, cfg, device=None):
    """A ``TrainState`` holding the reference's: ``params`` its unboxed
    parameter tree (as for ``lm_params_from_numpy``), ``opt`` its
    ``OptState`` (``step``, ``m``, ``v``: AdamW's moments trees like the
    parameters; Adafactor's ``m`` None and ``v`` a tree whose factored
    leaves are (rows, cols) pairs). AdamW's moments are split by layer
    like the parameters; Adafactor's stay the reference's stacked leaves,
    keyed ``blocks.<rest>`` (``train/optimizer.py``)."""
    from repro_torch.train.optimizer import OptState, reference_leaf
    from repro_torch.train.steps import TrainState

    dev = resolve_device(device)
    model = lm_params_from_numpy(params, cfg, device=dev)
    names = [n for n, _ in model.named_parameters()]
    step = int(np.asarray(opt.step))
    if opt.m is not None:
        m = {n: _leaf_tensor(opt.m, n, dev) for n in names}
        v = {n: _leaf_tensor(opt.v, n, dev) for n in names}
        return TrainState(model, OptState(step, m, v))
    v = {}
    for key in dict.fromkeys(reference_leaf(n)[0] for n in names):
        node = _tree_node(opt.v, key)
        if isinstance(node, (tuple, list)):
            v[key] = tuple(_torch_from_numpy(x).to(dev) for x in node)
        else:
            v[key] = _torch_from_numpy(node).to(dev)
    return TrainState(model, OptState(step, None, v))


def lm_params_from_numpy(params, cfg, device=None):
    """A ``DenseLM`` holding the reference's unboxed ``init_params`` tree:
    nested dicts of arrays, every ``blocks`` leaf with a leading layer axis.
    Each of the model's parameters takes the leaf of the same path
    (``blocks.i.attn.wq`` is ``params["blocks"]["attn"]["wq"][i]``; in the
    moe family ``blocks.i.moe.w1`` is ``params["blocks"]["moe"]["w1"][i]``,
    (E, d, f)), with its dtype; every leaf of the tree must be used."""
    from repro_torch.models.transformer import DenseLM

    model = DenseLM(cfg, device=device)
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "blocks":
                layer, path = int(parts[1]), ("blocks",) + tuple(parts[2:])
            else:
                layer, path = None, tuple(parts)
            node = params
            for key in path:
                node = node[key]
            t = _torch_from_numpy(node if layer is None else np.asarray(node)[layer])
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(
                    f"{name}: the tree holds {tuple(t.shape)} {t.dtype}, the model wants "
                    f"{tuple(p.shape)} {p.dtype}"
                )
            p.copy_(t)
            used.add(path)

    def leaves(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, path + (k,))
        else:
            yield path

    unused = sorted(set(leaves(params)) - used)
    if unused:
        raise ValueError(f"leaves of the tree the dense model has no place for: {unused}")
    return model
