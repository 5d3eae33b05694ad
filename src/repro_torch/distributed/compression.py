"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (port of ``repro/distributed/compression.py``).

Each rank quantises ``g + r`` (its gradient plus the residual it carried)
to int8 with one scale per tensor, ``max |g + r| / 127 + 1e-12``; the
ranks along ``axes`` sum the int32 codes and the scales, and each gets
``summed * mean_scale / n``; the new residual is what quantisation lost,
``g + r - q * scale``, so the compression's bias vanishes over steps
(Karimireddy et al., 2019). With the same gradient on every rank the
result is that gradient within one quantisation step; with different
ones, the mean within the rounding of each rank's codes. The formulas
and their order of operations are the reference's; the sums run over the
axes' process group. Nothing in the launcher calls it, as in the
reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed import sharding as shd


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)  # half to even, as jnp
    return q, scale


def _zip_map(fn, g, r):
    """``fn(g_leaf, r_leaf) -> (a, b)`` over two trees of dicts, tuples and
    lists of tensors; returns the tree of a's and the tree of b's."""
    if isinstance(g, dict):
        pairs = {k: _zip_map(fn, g[k], r[k]) for k in g}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    if isinstance(g, (tuple, list)):
        pairs = [_zip_map(fn, a, b) for a, b in zip(g, r)]
        return type(g)(p[0] for p in pairs), type(g)(p[1] for p in pairs)
    return fn(g, r)


def compressed_psum_tree(grads, residuals, mesh, axes=("data",)):
    """All-reduce ``grads`` over ``axes`` with int8 error-feedback
    compression, leaf by leaf (a tree of dicts, tuples and lists of
    tensors). Returns (reduced grads, new residuals), float32."""
    n = mesh.axis_size(axes)

    def one(g, r):
        gq = g.float() + r
        q, scale = _quantize(gq)
        summed = shd.all_reduce(q.to(torch.int32), axes, mesh)
        scale_sum = shd.all_reduce(scale, axes, mesh)  # scales averaged below
        mean_scale = scale_sum / n
        out = summed.float() * mean_scale / n
        return out, gq - q.float() * scale

    return _zip_map(one, grads, residuals)


def init_residuals(params):
    """Zero float32 residuals shaped like ``params`` (a tree as above)."""
    if isinstance(params, dict):
        return {k: init_residuals(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(init_residuals(v) for v in params)
    return torch.zeros(params.shape, dtype=torch.float32, device=params.device)
