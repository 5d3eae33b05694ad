"""Lightweight graph reordering (port of ``repro/core/reorder.py``).

Reordering relabels vertices so hot vertices share cache lines; the
expensive part is rebuilding the CSR under the new ids, which is
Neighbor-Populate again. The mapping is a registry of variants:

  ``identity``     no-op control;
  ``random``       seeded random permutation control;
  ``degree_sort``  full descending-degree sort (stable);
  ``hub_sort``     hubs (degree > average) first in degree order, the
                   tail in its original order;
  ``dbg``          degree-based grouping: log2-degree buckets, hot
                   buckets first, original order within a bucket.

Each maps a degree tensor to ``new_id[old_id]`` (int32) on the degrees'
device; the degree count is an ``add`` reduce through the executor.

Two variants cannot equal the reference bit for bit:

* ``random`` draws with ``torch.randperm`` from a CPU ``torch.Generator``
  seeded by ``seed`` (the same draw on every device); the reference's
  ``jax.random.permutation`` has no torch counterpart.
* ``dbg`` computes the bucket ``floor(log2(deg + 1))`` exactly from the
  integer (the float64 exponent of ``deg + 1``). The reference takes
  ``log2`` of a float32, which XLA's CPU rounds below the integer at
  8192 and 32768 (vertices of degree 8191 and 32767 land one bucket low
  there) and, from 2^21 - 2 up, rounds a few degrees just below 2^k - 1
  up to k (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.graph import COO, CSR

_INT32_MAX = 2**31 - 1


def _ids_from_order(order: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``order`` holds old ids in new-id order; invert to new_id[old_id]."""
    dev = order.device
    ids = torch.zeros(num_nodes, dtype=torch.int32, device=dev)
    ids[order.long()] = torch.arange(num_nodes, dtype=torch.int32, device=dev)
    return ids


def _identity_ids(deg, num_nodes, seed):
    return torch.arange(num_nodes, dtype=torch.int32, device=deg.device)


def _random_ids(deg, num_nodes, seed):
    gen = torch.Generator().manual_seed(int(seed))
    order = torch.randperm(num_nodes, generator=gen).to(deg.device)
    return _ids_from_order(order, num_nodes)


def _degree_sort_ids(deg, num_nodes, seed):
    order = torch.argsort(-deg, stable=True)  # old ids in new order
    return _ids_from_order(order, num_nodes)


def _hub_sort_ids(deg, num_nodes, seed):
    """Hubs (degree > average) first, by descending degree; every non-hub
    shares one key, so the stable sort keeps the tail's order. The sum is
    int64 here and int32 in the reference: equal while m < 2^31."""
    avg = torch.sum(deg) // max(num_nodes, 1)
    key = torch.where(deg > avg, -deg, _INT32_MAX)
    order = torch.argsort(key, stable=True)
    return _ids_from_order(order, num_nodes)


def dbg_bucket(deg: torch.Tensor) -> torch.Tensor:
    """``floor(log2(deg + 1))`` exactly: ``deg + 1`` is exact in float64,
    and ``frexp`` gives its binary exponent e with 2^(e-1) <= x < 2^e."""
    _, e = torch.frexp(deg.to(torch.float64) + 1.0)
    return e - 1


def _dbg_ids(deg, num_nodes, seed):
    """Degree-based grouping: hot buckets first; within a bucket, the
    original order (stable sort on the bucket key only)."""
    order = torch.argsort(-dbg_bucket(deg), stable=True)
    return _ids_from_order(order, num_nodes)


# name -> mapping fn(deg, num_nodes, seed) -> new_ids
REORDER_VARIANTS: Dict[str, Callable] = {
    "identity": _identity_ids,
    "random": _random_ids,
    "degree_sort": _degree_sort_ids,
    "hub_sort": _hub_sort_ids,
    "dbg": _dbg_ids,
}


def reorder_mapping(
    variant: str, src: torch.Tensor, num_nodes: int, *, seed: int = 0,
    degrees: torch.Tensor | None = None,
) -> torch.Tensor:
    """``new_id[old_id]`` for a registered variant. The degree histogram
    is an ``add`` reduce the default executor decides; ``degrees`` reuses
    one already computed (the preprocessing pipeline's stage 1)."""
    if variant not in REORDER_VARIANTS:
        raise ValueError(
            f"unknown reorder variant: {variant!r} (want one of {tuple(REORDER_VARIANTS)})"
        )
    if degrees is None:
        from repro_torch.core.executor import get_default_executor

        degrees = get_default_executor().reduce_stream(
            src, torch.ones(src.shape, dtype=torch.int32, device=src.device),
            out_size=num_nodes, op="add",
        )
    return REORDER_VARIANTS[variant](degrees, num_nodes, seed)


def degree_sort_mapping(src: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """new_id[old_id]: descending-degree relabelling (stable)."""
    return reorder_mapping("degree_sort", src, num_nodes)


def relabel_coo(coo: COO, new_ids: torch.Tensor) -> COO:
    return COO(
        src=new_ids[coo.src.long()],
        dst=new_ids[coo.dst.long()],
        num_nodes=coo.num_nodes,
    )


def reorder_rebuild(
    coo: COO,
    variant: str = "degree_sort",
    method: str = "baseline",
    bin_range: int | None = None,
    seed: int = 0,
) -> Tuple[CSR, torch.Tensor]:
    """Mapping + relabel + CSR rebuild for one variant (any
    ``neighbor_populate.build_csr`` method); the staged, reported form is
    ``core/preprocess.py``."""
    from repro_torch.core.neighbor_populate import build_csr

    new_ids = reorder_mapping(variant, coo.src, coo.num_nodes, seed=seed)
    csr = build_csr(relabel_coo(coo, new_ids), method=method, bin_range=bin_range)
    return csr, new_ids


def degree_sort_rebuild(
    coo: COO, method: str = "baseline", bin_range: int | None = None
) -> Tuple[CSR, torch.Tensor]:
    """``reorder_rebuild`` at variant=degree_sort."""
    return reorder_rebuild(coo, "degree_sort", method=method, bin_range=bin_range)
