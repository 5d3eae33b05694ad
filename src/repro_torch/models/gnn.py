"""GNN neighbour aggregation as PB row-block SpMM (port of
``repro/models/layers.py:392-525``).

``out[v] = reduce_{u in N_in(v)} h[u]`` is a PB reduction whose values are
feature rows: gather each in-edge's source row in CSC order (edges sorted
by destination, every index in range) and reduce by destination with the
fused row-block reduce (``execute_reduce(method="fused")``: the rows
kernel on CUDA tensors, its plain version on CPU tensors). The backward
of the sum is the same kind of stream over the transpose layout, the CSR
of the same graph: ``dh[u] = sum_{(u, v)} g[v]``, reduced by source. So
both directions run the rows kernel, as in the reference's custom VJPs,
here two ``torch.autograd.Function``s.

The max backward gives every attaining in-neighbour the full ``g[v]``
(ties included: a valid subgradient, the reference's choice). Unlike the
reference it builds the equality mask before it gathers ``g`` and masks
in place, so it holds three (E, F) tensors at once where the reference
holds four.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.executor import execute_reduce
from repro_torch.core.graph import CSR, segment_ids_from_offsets
from repro_torch.device import resolve_device

AGG_OPS = ("sum", "mean", "max")


def _spmm_stream(x, seg, neighs, n, op):
    """One PB row-block sweep: gather x rows at ``neighs``, reduce by the
    sorted segment ids ``seg`` into (n, F)."""
    rows = x.index_select(0, neighs)
    return execute_reduce(
        # sorted-ok: a CSR's segment ids  # in-bounds-ok: each in [0, n)
        seg, rows, out_size=n, op=op, method="fused", sorted_within=1, in_bounds=True
    )


class _PBNeighborSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, csc_seg, csc_neighs, csr_seg, csr_neighs):
        ctx.save_for_backward(csr_seg, csr_neighs)
        ctx.n, ctx.dtype = h.shape[0], h.dtype
        return _spmm_stream(h, csc_seg, csc_neighs, h.shape[0], "add")

    @staticmethod
    def backward(ctx, g):
        csr_seg, csr_neighs = ctx.saved_tensors
        # transpose stream: per CSR edge (u -> v), dh[u] += g[v]; csr_seg
        # is sorted by source, so this is another fused sweep
        dh = _spmm_stream(g.float(), csr_seg, csr_neighs, ctx.n, "add")
        return dh.to(ctx.dtype), None, None, None, None


class _PBNeighborMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, csc_seg, csc_neighs, csr_seg, csr_neighs):
        out = _spmm_stream(h, csc_seg, csc_neighs, h.shape[0], "max")
        ctx.save_for_backward(h, out, csr_seg, csr_neighs)
        return out

    @staticmethod
    def backward(ctx, g):
        h, out, csr_seg, csr_neighs = ctx.saved_tensors
        # per transpose edge (u -> v): does h[u] attain the max at v?
        lost = h.index_select(0, csr_seg) != out.index_select(0, csr_neighs)
        contrib = g.index_select(0, csr_neighs).float()
        contrib.masked_fill_(lost, 0.0)
        del lost
        dh = execute_reduce(
            csr_seg, contrib, out_size=h.shape[0], op="add", method="fused",
            # sorted-ok: the CSR's segment ids  # in-bounds-ok: each in [0, n)
            sorted_within=1, in_bounds=True,
        )
        return dh.to(h.dtype), None, None, None, None


def gnn_aggregate(h: torch.Tensor, csc: CSR, csr: CSR, *, op: str = "sum") -> torch.Tensor:
    """Neighbour aggregation over in-edges: (n, F) features -> (n, F).

    ``csc``/``csr`` are the dual layouts of one graph (``build_csr_csc``):
    the CSC drives the forward pull, the CSR is the transpose stream the
    backward runs. ``op``: ``sum`` | ``mean`` (sum / max(in_degree, 1)) |
    ``max`` (0 at vertices without in-edges).
    """
    if op not in AGG_OPS:
        raise ValueError(f"gnn_aggregate op must be sum|mean|max, got {op!r}")
    n = csc.num_nodes
    E = csc.num_edges
    if h.ndim != 2 or h.shape[0] != n:
        raise ValueError(f"features must be (num_nodes, F) = ({n}, F); got {tuple(h.shape)}")
    if E == 0:
        return torch.zeros_like(h)
    csc_seg = segment_ids_from_offsets(csc.offsets, E)
    csr_seg = segment_ids_from_offsets(csr.offsets, E)
    indeg = csc.offsets[1:] - csc.offsets[:-1]
    if op == "max":
        out = _PBNeighborMax.apply(h, csc_seg, csc.neighs, csr_seg, csr.neighs)
        return torch.where((indeg > 0)[:, None], out, 0)
    out = _PBNeighborSum.apply(h, csc_seg, csc.neighs, csr_seg, csr.neighs)
    if op == "mean":
        out = out / indeg.clamp(min=1).to(out.dtype)[:, None]
    return out


def _winit(shape, generator: torch.Generator, dtype) -> torch.Tensor:
    """Truncated normal on [-2, 2], scaled by fan-in ** -0.5, as the
    reference's ``params.winit``; drawn on the CPU so a seed gives the
    same weights on every device."""
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * shape[0] ** -0.5).to(dtype)


class GNNLayer(nn.Module):
    """One message-passing layer: ``h' = act(agg(h W_msg) + h W_self + b)``;
    its ``forward`` is the reference's ``gnn_layer_apply``.

    Messages are transformed before aggregation, so the aggregate is the
    row-block SpMM at F = d_out, forward and backward. ``generator`` is a
    CPU ``torch.Generator`` (default: seeded with 0); ``device=None`` means
    the card.
    """

    def __init__(
        self,
        d_in: int,
        d_out: int,
        *,
        generator: torch.Generator | None = None,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.w_msg = nn.Parameter(_winit((d_in, d_out), gen, dtype).to(dev))
        self.w_self = nn.Parameter(_winit((d_in, d_out), gen, dtype).to(dev))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=dev))

    def forward(self, h, csc: CSR, csr: CSR, *, agg: str = "mean", act=torch.relu):
        msg = h @ self.w_msg.to(h.dtype)
        agg_out = gnn_aggregate(msg, csc, csr, op=agg)
        y = agg_out + h @ self.w_self.to(h.dtype) + self.b.to(h.dtype)
        return act(y) if act is not None else y

