"""Radii estimation by k-source BFS (port of ``repro/core/radii.py``), the
downstream kernel of the paper's Fig. 2b.

The radius estimate is the largest eccentricity seen from ``k`` sampled
sources, each a frontier-driven ``traversal.bfs`` whose levels are
``op="min"`` reduce streams through the executor. ``k`` is clamped to the
vertex count (sources are drawn without replacement), and ``converged``
is False when some BFS hit ``max_iters``: the eccentricities are then
lower bounds.

The reference draws its sources with ``jax.random.choice(PRNGKey(seed))``,
a stream the port cannot reproduce; the port draws them with a seeded
``torch.Generator`` (``torch.randperm`` on the CPU, so every device gets
the same sources). Everything after the draw is ``_radii_from_sources``,
which the parity tests feed the reference's sources. ``mesh=`` routes
every BFS level as ``traversal.bfs`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import CSR
from repro_torch.core.traversal import _INT_MAX, _resolve, bfs


class RadiiResult(NamedTuple):
    """Per-source eccentricities and how the BFS runs ended."""

    ecc: torch.Tensor  # (k,) int32, the largest finite BFS level per source
    iters: int  # levels actually run (max over sources)
    converged: bool  # every frontier drained before max_iters
    decisions: Tuple[dict, ...] = ()  # executor decisions across all BFS


def radii(
    csr: CSR,
    k: int = 8,
    max_iters: int = 512,
    seed: int = 0,
    *,
    executor=None,
    method: str = "auto",
    mesh=None,
    axis_name: Optional[str] = None,
) -> RadiiResult:
    """Eccentricities of ``k`` sources drawn without replacement from a
    ``torch.Generator`` seeded with ``seed``; check ``converged`` before
    trusting them. ``method`` routes every level as ``traversal.bfs``
    does (``mesh``: through ``shard_reduce_stream``)."""
    _resolve(method)
    k = max(1, min(k, csr.num_nodes))
    gen = torch.Generator().manual_seed(seed)
    sources = torch.randperm(csr.num_nodes, generator=gen)[:k].numpy()
    return _radii_from_sources(csr, sources, max_iters, executor=executor, method=method,
                               mesh=mesh, axis_name=axis_name)


def _radii_from_sources(
    csr: CSR,
    sources: Sequence[int],
    max_iters: int = 512,
    *,
    executor=None,
    method: str = "auto",
    mesh=None,
    axis_name: Optional[str] = None,
) -> RadiiResult:
    """The reference's loop after its draw: one BFS (no parents) per
    source, the largest finite level of each, the deepest run's levels,
    and whether every run converged."""
    eccs = np.zeros(len(sources), np.int32)
    iters, converged, decisions = 0, True, []
    for i, s in enumerate(sources):
        r = bfs(csr, int(s), executor=executor, method=method, mesh=mesh, axis_name=axis_name,
                max_iters=max_iters, with_parents=False)
        finite = r.dist[r.dist != _INT_MAX]
        eccs[i] = int(finite.max()) if finite.numel() else 0
        iters = max(iters, r.levels)
        converged = converged and r.converged
        decisions.extend(r.decisions)
    return RadiiResult(torch.from_numpy(eccs).to(csr.offsets.device), iters, converged,
                       tuple(decisions))
