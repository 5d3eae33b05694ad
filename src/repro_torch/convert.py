"""Carrying state across from numpy (and so from the reference package).

In this system the "weights" are the graph and the plan. The tests take
the reference's outputs through ``np.asarray`` and these functions, and
compare like with like: index layouts are int32 on both sides.
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
