"""Graph containers and synthetic generators (port of ``repro/core/graph.py``).

The five generators are the reference's numpy code, seeded by
``default_rng``, so the COO arrays are bit-identical to the reference's;
only the final hand-over makes int32 torch tensors on ``device``
(``None`` = the card, see ``repro_torch.device``).
"""
from __future__ import annotations

import functools
import os
import warnings
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class COO(NamedTuple):
    """Edgelist. src/dst are int32 tensors of equal length (num_edges)."""

    src: torch.Tensor
    dst: torch.Tensor
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


class CSR(NamedTuple):
    """Compressed sparse row. offsets has length num_nodes+1."""

    offsets: torch.Tensor
    neighs: torch.Tensor
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.neighs.shape[0])


def degrees_from_coo(coo: COO, *, by: str = "src") -> torch.Tensor:
    key = coo.src if by == "src" else coo.dst
    return torch.bincount(key, minlength=coo.num_nodes).to(torch.int32)


def offsets_from_degrees(degrees: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum with a trailing total: shape (n+1,)."""
    z = torch.zeros(1, dtype=torch.int32, device=degrees.device)
    return torch.cat([z, torch.cumsum(degrees, 0, dtype=torch.int32)])


def segment_ids_from_offsets(offsets: torch.Tensor, num_edges: int) -> torch.Tensor:
    """Edge -> owning row, given CSR offsets."""
    e = torch.arange(num_edges, dtype=torch.int32, device=offsets.device)
    return torch.searchsorted(offsets[1:], e, right=True, out_int32=True)


def transpose_coo(coo: COO) -> COO:
    return COO(src=coo.dst, dst=coo.src, num_nodes=coo.num_nodes)


# ---------------------------------------------------------------------------
# Synthetic generators (numpy on host; deterministic by seed).
# ---------------------------------------------------------------------------


def _to_coo(src: np.ndarray, dst: np.ndarray, n: int, device) -> COO:
    dev = resolve_device(device)
    return COO(
        src=torch.from_numpy(np.ascontiguousarray(src, dtype=np.int32)).to(dev),
        dst=torch.from_numpy(np.ascontiguousarray(dst, dtype=np.int32)).to(dev),
        num_nodes=int(n),
    )


def _uniform_np(num_nodes: int, avg_degree: int, seed: int):
    rng = np.random.default_rng(seed)
    m = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, size=m, dtype=np.int32)
    dst = rng.integers(0, num_nodes, size=m, dtype=np.int32)
    return src, dst, num_nodes


def _kron_np(scale: int, avg_degree: int, seed: int):
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * avg_degree
    a, b, c = 0.57, 0.19, 0.19
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        go_right_src = r >= a + b
        r2 = rng.random(m)
        p_right_dst = np.where(go_right_src, c / (c + (1 - a - b - c)), a / (a + b))
        go_right_dst = r2 >= p_right_dst
        src |= go_right_src.astype(np.int64) << bit
        dst |= go_right_dst.astype(np.int64) << bit
    perm = rng.permutation(n)
    return perm[src].astype(np.int32), perm[dst].astype(np.int32), n


def _powerlaw_np(num_nodes: int, avg_degree: int, seed: int, alpha: float):
    rng = np.random.default_rng(seed)
    m = num_nodes * avg_degree
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    perm = rng.permutation(num_nodes).astype(np.int32)
    dst = perm[rng.choice(num_nodes, size=m, p=probs)]
    src = rng.integers(0, num_nodes, size=m, dtype=np.int32)
    return src, dst, num_nodes


def _road_np(side: int, seed: int):
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).astype(np.int64)
    edges = []
    right = vid[:, :-1].ravel(), vid[:, 1:].ravel()
    down = vid[:-1, :].ravel(), vid[1:, :].ravel()
    for s, d in (right, down):
        edges.append((s, d))
        edges.append((d, s))
    src = np.concatenate([e[0] for e in edges])
    dst = np.concatenate([e[1] for e in edges])
    perm = rng.permutation(n)
    order = rng.permutation(src.shape[0])
    return perm[src][order].astype(np.int32), perm[dst][order].astype(np.int32), n


def _bubbles_np(side: int, seed: int):
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).astype(np.int64)
    pairs = [
        (vid[:, :-1].ravel(), vid[:, 1:].ravel()),
        (vid[:-1, :].ravel(), vid[1:, :].ravel()),
        (vid[:-1, :-1].ravel(), vid[1:, 1:].ravel()),
    ]
    src = np.concatenate([p[0] for p in pairs] + [p[1] for p in pairs])
    dst = np.concatenate([p[1] for p in pairs] + [p[0] for p in pairs])
    perm = rng.permutation(n)
    order = rng.permutation(src.shape[0])
    return perm[src][order].astype(np.int32), perm[dst][order].astype(np.int32), n


def gen_uniform(num_nodes: int, avg_degree: int, seed: int = 0, device=None) -> COO:
    """URND analogue: uniform random endpoints (normal degree dist)."""
    resolve_device(device)
    return _to_coo(*_uniform_np(num_nodes, avg_degree, seed), device)


def gen_kron(scale: int, avg_degree: int, seed: int = 0, device=None) -> COO:
    """KRON analogue: RMAT/Kronecker with Graph500 parameters."""
    resolve_device(device)
    return _to_coo(*_kron_np(scale, avg_degree, seed), device)


def gen_powerlaw(
    num_nodes: int, avg_degree: int, seed: int = 0, alpha: float = 1.8, device=None
) -> COO:
    """DBP analogue: Zipf-distributed destination popularity."""
    resolve_device(device)
    return _to_coo(*_powerlaw_np(num_nodes, avg_degree, seed, alpha), device)


def gen_road(side: int, seed: int = 0, device=None) -> COO:
    """EURO analogue: 2D grid (bounded degree ~4), ids and edge order shuffled."""
    resolve_device(device)
    return _to_coo(*_road_np(side, seed), device)


def gen_bubbles(side: int, seed: int = 0, device=None) -> COO:
    """HBUBL analogue: triangulated mesh (degree ~3) — grid + one diagonal."""
    resolve_device(device)
    return _to_coo(*_bubbles_np(side, seed), device)


# Version of the generators + npz layout above; part of every cache entry.
GRAPH_GEN_VERSION = 2


def _graph_cache_dir() -> str:
    """The port's own cache (never the reference's ``~/.cache/repro_pb``):
    ``REPRO_TORCH_CACHE_DIR`` overrides ``~/.cache/repro_torch``."""
    base = os.environ.get("REPRO_TORCH_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch"
    )
    return os.path.join(base, "graphs")


_SAVE_WARNED: set = set()


def cached_graph(key: str, maker, device=None) -> COO:
    """Load a generated graph from the npz cache, or make and save it.

    ``maker()`` returns numpy ``(src, dst, num_nodes)``; ``key`` encodes
    generator + parameters + seed, and every entry embeds
    ``GRAPH_GEN_VERSION``, so a hit is bit-identical to regeneration. A
    corrupt entry regenerates; an unwritable cache dir warns once.
    """
    resolve_device(device)
    path = os.path.join(_graph_cache_dir(), f"{key}.npz")
    try:
        with np.load(path) as z:
            if "gen_version" in z.files and int(z["gen_version"]) == GRAPH_GEN_VERSION:
                return _to_coo(z["src"], z["dst"], int(z["num_nodes"]), device)
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        pass  # missing/corrupt/truncated cache entry: regenerate below
    src, dst, n = maker()
    try:
        os.makedirs(_graph_cache_dir(), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(
                f,
                src=src,
                dst=dst,
                num_nodes=np.int64(n),
                gen_version=np.int64(GRAPH_GEN_VERSION),
            )
        os.replace(tmp, path)
    except OSError as e:
        d = _graph_cache_dir()
        if d not in _SAVE_WARNED:
            _SAVE_WARNED.add(d)
            warnings.warn(
                f"graph cache save failed under {d!r} ({e}); graphs will "
                "regenerate every run (set REPRO_TORCH_CACHE_DIR to a "
                "writable directory)",
                RuntimeWarning,
                stacklevel=2,
            )
    return _to_coo(src, dst, n, device)


def graph_suite(scale: str = "bench", device=None) -> dict:
    """The 5-graph suite mirroring the paper's inputs, on ``device``.

    ``bench``: 2^18-vertex graphs (about 2M edges), npz-cached;
    ``smoke``: the small test graphs, generated once per process.
    """
    dev = resolve_device(device)
    if scale == "bench":
        v = f"v{GRAPH_GEN_VERSION}"
        return {
            "DBP": cached_graph(
                f"powerlaw_n18_d8_s1_{v}", lambda: _powerlaw_np(1 << 18, 8, 1, 1.8), dev
            ),
            "KRON": cached_graph(f"kron_s18_d8_s2_{v}", lambda: _kron_np(18, 8, 2), dev),
            "URND": cached_graph(
                f"uniform_n18_d8_s3_{v}", lambda: _uniform_np(1 << 18, 8, 3), dev
            ),
            "EURO": cached_graph(f"road_512_s4_{v}", lambda: _road_np(512, 4), dev),
            "HBUBL": cached_graph(f"bubbles_512_s5_{v}", lambda: _bubbles_np(512, 5), dev),
        }
    return {name: _to_coo(*arrs, dev) for name, arrs in _smoke_suite_np().items()}


@functools.lru_cache(maxsize=1)
def _smoke_suite_np() -> dict:
    """The 5 smoke graphs as numpy arrays, generated once per process;
    ``graph_suite`` hands out fresh tensors on the requested device."""
    return {
        "DBP": _powerlaw_np(1 << 10, 4, 1, 1.8),
        "KRON": _kron_np(10, 4, 2),
        "URND": _uniform_np(1 << 10, 4, 3),
        "EURO": _road_np(32, 4),
        "HBUBL": _bubbles_np(32, 5),
    }
