"""Sharded PB over ``torch.distributed`` (port of ``repro/core/distributed_pb.py``):
the interconnect as the top C-Buffer level.

The coarsest bin of a tuple is the rank that owns its output index, and
that level's eviction path is a collective, not device memory.
``shard_reduce_stream`` runs, on every rank of a 1-D mesh:

  1. **owner histogram + stable local partition**: the rank's block of the
     stream is binned by owner (``index // shard_range``) with the stable
     counting permutation every other binning path uses
     (``pb.counting_permutation``), so stream order survives within a block;
  2. **capacity-padded all_to_all**: per-destination segments are padded
     to a fixed capacity and exchanged by ``all_to_all_single``. With a
     4-byte value dtype, index and value ride one int32 buffer (the value
     reinterpreted by ``.view``, the index in one extra lane): one
     collective instead of two. Padding carries the sentinel index
     ``out_size`` and the op identity. A segment longer than the capacity
     raises the overflow flag, which is reduced across the ranks, so
     every rank reruns at the always-safe capacity together;
  3. **rank-local reduce**: the received stream, all owned by this rank,
     runs through ``execute_reduce`` over the ``shard_range``-sized local
     domain (on the card, the fused kernel for ``fused``, the rows kernel
     for row values, histogram and positions for ``pallas``).

**The SPMD form.** The reference traces one program under ``shard_map``;
here every rank of a process group runs the entry point with the same
global tensors, as the reference's single controller does. Rank ``r``
takes the ``r``-th contiguous block of the padded stream (``shard_map``'s
``P(axis)`` split), and every rank returns the whole result: the owned
slices come back by ``all_gather``. Each choice that decides which
collectives run next (the overflow rerun, the measured pipeline depth) is
made from values reduced across the group, so no rank takes another
branch. Collectives move ``uint8`` views of values whose dtype gloo does
not take (it refuses int16), so any dtype crosses unchanged.

**The mesh.** ``StreamMesh`` is a group, an axis name and a size. The
card's ranks share one device under a gloo group, which
``torch.distributed.device_mesh.DeviceMesh`` does not model (its CUDA
meshes place one rank on each card), so the port keeps its own small
type. gloo takes CUDA tensors for ``all_to_all_single``, ``all_gather``
and ``all_reduce`` (staging them through host memory itself), so no
collective here copies to the host by hand.

**Pipelining.** ``pipelined_owner_reduce`` cuts the rank's block into K
chunks and starts chunk *i+1*'s ``all_to_all_single`` (``async_op=True``)
before chunk *i*'s local reduce; K comes from the executor's decision
(``BinningDecision.pipeline_chunks``), and K = 1 is the monolithic
schedule. Order across ranks and chunks: ``all_to_all_single``
concatenates received segments by source rank, source ranks hold
contiguous blocks of the stream and the partition is stable, so a rank
receives its tuples in stream order; the ordered exchange stacks the K
received buffers ``(K, n_dev, cap)`` and transposes them to ``(n_dev, K,
cap)``, which restores that order across chunks. ``shard_build_csr``
therefore equals ``build_csr_oracle`` bit for bit at any K.

Results: integer ops, ``min`` and ``max`` equal the single-device
``execute_reduce`` exactly; float ``add`` sums in per-rank and per-chunk
trees and agrees to a tolerance. With one rank, or ``mesh=None``, every
entry point is the single-device path. The reference's ``block`` (its
counting sort's block size) has no counterpart: the port's counting
permutation needs none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import pb
from repro_torch.core.executor import REDUCE_OPS, execute_reduce
from repro_torch.core.graph import COO, CSR, offsets_from_degrees
from repro_torch.device import resolve_device

# Default mesh axis name for stream sharding: one axis, since a tuple has
# one owner rank.
STREAM_AXIS = "shard"

# Value dtypes whose itemsize lets a value ride an int32 lane beside its
# index: the packed one-collective exchange. Others take two collectives.
_PACK_ITEMSIZE = 4


@dataclass(frozen=True, eq=False)
class StreamMesh:
    """A 1-D mesh of ranks: the group its collectives run in (``None`` for
    a mesh of one rank, which runs none), the axis name, its size, this
    process's rank in it and the device its tensors live on."""

    group: Optional[object]
    axis_name: str
    size: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> dict:
        """``{axis_name: size}``, as a ``jax.sharding.Mesh``'s ``shape``."""
        return {self.axis_name: self.size}


def make_stream_mesh(
    num_devices: Optional[int] = None, axis_name: str = STREAM_AXIS, device=None
) -> StreamMesh:
    """A 1-D mesh over the default process group (every rank by default),
    or over this rank alone with ``num_devices=1`` or when no group is
    initialised. ``device=None`` is the card; the CPU tests pass "cpu".
    A mesh over some but not all ranks is refused: every rank runs every
    entry point, so each must belong to the mesh."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"need 1..{world} ranks, got {n}")
    if n == 1:
        return StreamMesh(None, axis_name, 1, 0, dev)
    if n != world:
        raise ValueError(
            f"a stream mesh spans 1 rank or all {world} of the process group, got {n}"
        )
    return StreamMesh(dist.group.WORLD, axis_name, n, rank, dev)


def resolve_stream_axis(mesh: StreamMesh, axis_name: Optional[str] = None) -> str:
    """The mesh axis tuples shard over: explicit, else ``shard`` when
    present, else the only axis of a 1-D mesh."""
    if axis_name is not None:
        if axis_name not in mesh.shape:
            raise ValueError(f"axis {axis_name!r} not in mesh axes {tuple(mesh.shape)}")
        return axis_name
    if STREAM_AXIS in mesh.shape:
        return STREAM_AXIS
    if len(mesh.shape) == 1:
        return next(iter(mesh.shape))
    raise ValueError(f"ambiguous stream axis for mesh axes {tuple(mesh.shape)}; pass axis_name")


def mesh_size(mesh: Optional[StreamMesh], axis_name: Optional[str] = None) -> int:
    """Ranks along the stream axis: 1 without a mesh."""
    return 1 if mesh is None else int(mesh.shape[resolve_stream_axis(mesh, axis_name)])


def mesh_shape(mesh: StreamMesh) -> Tuple[Tuple[str, int], ...]:
    """The sorted ``(axis, size)`` pairs that key sharded decisions."""
    return tuple(sorted(mesh.shape.items()))


def shard_range_for(out_size: int, n_dev: int) -> int:
    """Indices per owner rank (the coarsest bin range). The last rank may
    own a short range; with ``out_size < n_dev`` some ranks own nothing
    and only forward identities."""
    return max(1, -(-out_size // n_dev))


def can_pack(val_dtype) -> bool:
    """True when a value can ride an int32 lane beside its index: the
    one-collective exchange."""
    if isinstance(val_dtype, torch.dtype):
        return val_dtype.itemsize == _PACK_ITEMSIZE
    return np.dtype(val_dtype).itemsize == _PACK_ITEMSIZE


def _pad_to(x: torch.Tensor, length: int, fill) -> torch.Tensor:
    """``x`` (at most ``length`` long) padded with ``fill`` to ``length``."""
    if x.shape[0] == length:
        return x
    pad = torch.full((length - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def _pad_to_multiple(x: torch.Tensor, mult: int, fill) -> torch.Tensor:
    return _pad_to(x, x.shape[0] + (-x.shape[0]) % mult, fill)


def _rank_block(x: torch.Tensor, rank: int, length: int, fill) -> torch.Tensor:
    """Rank ``rank``'s contiguous block of ``length`` tuples of ``x``, the
    stream's tail padded with ``fill`` (the block ``shard_map`` hands it)."""
    return _pad_to(x[rank * length:(rank + 1) * length], length, fill)


# -- collectives ---------------------------------------------------------------


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A ``uint8`` view of ``t`` (last axis widened by the itemsize): gloo
    moves bytes of any dtype this way, and the bits come back unchanged."""
    t = t.contiguous()
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


def _all_to_all(buf: torch.Tensor, mesh: StreamMesh):
    """Start ``all_to_all_single`` of ``buf`` (row ``d`` of dimension 0 goes
    to rank ``d``); returns the receive buffer and the work handle."""
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    work = dist.all_to_all_single(out, buf, group=mesh.group, async_op=True)
    return out, work


def all_gather_cat(t: torch.Tensor, mesh: StreamMesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dimension 0 in
    rank order, on every rank."""
    b = _as_bytes(t)
    parts = [torch.empty_like(b) for _ in range(mesh.size)]
    dist.all_gather(parts, b, group=mesh.group)
    return torch.cat(parts).view(t.dtype)


def any_across(flag: torch.Tensor, mesh: StreamMesh) -> torch.Tensor:
    """The OR of a boolean over the ranks (the reference's ``psum > 0``)."""
    t = flag.to(torch.int32).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t[0] > 0


def agree_max(values, mesh: Optional[StreamMesh]) -> list:
    """The elementwise largest of a list of host floats over the ranks, so
    that every rank takes a decision from the same numbers (measured
    timings: the slowest rank's time counts)."""
    if mesh is None or mesh.size == 1:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.tolist()


def barrier(mesh: Optional[StreamMesh]) -> None:
    """Wait until every rank of the mesh arrives (nothing without one)."""
    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.group)


def _exchange_buffers(
    send_idx: torch.Tensor, send_val: torch.Tensor, mesh: StreamMesh, packed: bool
) -> Callable[[], Tuple[torch.Tensor, torch.Tensor]]:
    """Start the all_to_all of the ``(n_dev, capacity[, ...])`` send
    buffers; the returned function waits for it and unpacks.

    ``packed`` (with a 4-byte value dtype) sends one int32 buffer: the
    values reinterpreted by ``.view(int32)``, the index in one extra lane.
    No floating-point operation ever reads a packed lane (an int32 index
    below 2^23 read as float32 is a denormal, which flush-to-zero would
    erase), so the bits round-trip exactly. Otherwise two collectives: the
    int32 indices and the values' bytes."""
    if packed and can_pack(send_val.dtype):
        lanes = send_val.contiguous().view(torch.int32)
        if send_val.ndim == 2:  # scalar values: (n_dev, cap) -> (n_dev, cap, 2)
            buf = torch.stack([lanes, send_idx.to(torch.int32)], dim=-1)
        else:  # row values: (n_dev, cap, D) -> one extra column
            buf = torch.cat([lanes, send_idx.to(torch.int32)[..., None]], dim=-1)
        recv, work = _all_to_all(buf, mesh)

        def done():
            work.wait()
            rv = recv[..., 0] if send_val.ndim == 2 else recv[..., :-1]
            return recv[..., -1].contiguous(), rv.contiguous().view(send_val.dtype)

        return done
    ri, wi = _all_to_all(send_idx.to(torch.int32), mesh)
    rv, wv = _all_to_all(_as_bytes(send_val), mesh)

    def done():
        wi.wait()
        wv.wait()
        return ri, rv.view(send_val.dtype)

    return done


# -- the owner exchange --------------------------------------------------------


def _start_owner_exchange(idx, val, *, out_size, shard_range, mesh, capacity, fill_val, packed):
    """Partition this rank's block by owner, pack the capacity-padded
    segments and start their exchange; returns ``(finish, overflow)``, where
    ``finish()`` waits and returns ``(local_idx, val)`` and ``overflow`` is
    this rank's flag (a device bool, not yet reduced across ranks)."""
    n_dev = mesh.size
    m_local = idx.shape[0]
    dev = idx.device
    valid = (idx >= 0) & (idx < out_size)
    owner = torch.where(valid, torch.div(idx, shard_range, rounding_mode="floor"), n_dev)
    # padding routes to overflow bin n_dev; the stable partition keeps it last
    dest, counts = pb.counting_permutation(owner.to(torch.int32), n_dev + 1)
    inv = pb.inverse_permutation(dest)
    starts = pb.starts_from_counts(counts)  # (n_dev + 2,)
    overflow = (counts[:n_dev] > capacity).any()

    # the per-destination segments as fixed (n_dev, capacity) rows
    j = torch.arange(capacity, dtype=torch.int32, device=dev)
    pos = starts[:n_dev, None] + j[None, :]
    in_seg = j[None, :] < counts[:n_dev, None]
    perm = inv[pos.clamp(max=m_local - 1).reshape(-1).long()].long()
    tail = tuple(val.shape[1:])
    send_idx = torch.where(in_seg, idx[perm].reshape(n_dev, capacity).to(torch.int32), out_size)
    mask = in_seg.reshape((n_dev, capacity) + (1,) * len(tail))
    fill = torch.full((), fill_val, dtype=val.dtype, device=dev)
    send_val = torch.where(mask, val[perm].reshape((n_dev, capacity) + tail), fill)

    # row d of the send buffers becomes row (this rank) of rank d's receive
    # buffers: the interconnect eviction path
    wait = _exchange_buffers(send_idx, send_val, mesh, packed)
    base = mesh.rank * shard_range

    def finish():
        recv_idx, recv_val = wait()
        flat = recv_idx.reshape(-1)
        local = torch.where(flat < out_size, flat - base, shard_range).to(torch.int32)
        return local, recv_val.reshape((n_dev * capacity,) + tail)

    return finish, overflow


def owner_exchange(
    idx: torch.Tensor,
    val: torch.Tensor,
    *,
    out_size: int,
    shard_range: int,
    mesh: StreamMesh,
    capacity: int,
    fill_val=0,
    packed: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rank level of the binning hierarchy, on this rank's block.

    ``idx`` is the rank's ``(m_local,)`` block of global indices (sentinel
    ``out_size`` marks padding), ``val`` its values, 1-D or rows. Returns
    ``(local_idx, val, overflow)``: ``n_dev * capacity`` tuples owned by
    this rank, indices rebased to the local range with every padding slot
    at the sentinel ``shard_range``, and a bool tensor that is True when
    one of THIS rank's segments exceeded ``capacity`` (tuples beyond it do
    not ship; reduce it across ranks with ``any_across`` before acting on
    it, as ``shard_reduce_stream`` does). ``capacity`` is the segment size
    of the padded exchange; the always-safe value is the block length."""
    finish, overflow = _start_owner_exchange(
        idx, val, out_size=out_size, shard_range=shard_range, mesh=mesh,
        capacity=capacity, fill_val=fill_val, packed=packed,
    )
    local, v = finish()
    return local, v, overflow


def clamp_for_local_reduce(local_idx: torch.Tensor, shard_range: int) -> torch.Tensor:
    """Make an exchanged stream legal for any local reduce method: sentinel
    slots (``shard_range``) carry the op identity, so moving them onto the
    last owned index changes nothing and keeps every bin id in range."""
    return torch.clamp(local_idx, max=shard_range - 1)


# -- the chunked, double-buffered pipeline ----------------------------------------


def default_pipeline_chunks(
    num_tuples: int, num_indices: int, n_dev: int, max_chunks: int = 4
) -> int:
    """K from the roofline overlap model (H100 rates): the K that minimises
    modeled pipelined time plus a launch cost per chunk; 1 for streams too
    small to pay for more collective launches."""
    if n_dev <= 1 or num_tuples <= 0:
        return 1
    from repro_torch.roofline import ShardedPBStreamRoofline

    rl = ShardedPBStreamRoofline(
        num_tuples=num_tuples, num_indices=max(1, num_indices), n_dev=n_dev)
    return rl.best_pipeline_chunks(max_chunks=max_chunks)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def estimate_capacity(
    indices,
    *,
    out_size: int,
    n_dev: int,
    chunks: int = 1,
    sample: int = 1 << 16,
    slack: float = 1.3,
    floor: int = 64,
) -> int:
    """Per-destination capacity from owner skew: a strided host sample of
    the index stream, its per-owner histogram, the heaviest owner's share
    of one chunk with ``slack`` headroom plus ``floor`` for sampling
    noise, clamped to the always-safe chunk length. The overflow flag
    guards an under-estimate. Every rank samples the same global stream,
    so every rank gets the same capacity."""
    m = int(indices.shape[0])
    chunks = max(1, int(chunks))
    if m == 0 or n_dev <= 1:
        return 1
    shard_range = shard_range_for(out_size, n_dev)
    m_local = -(-m // n_dev)
    chunk_len = -(-m_local // chunks)
    stride = max(1, m // int(sample))
    h = _host(indices[::stride]).astype(np.int64)
    h = h[(h >= 0) & (h < out_size)]
    if h.size == 0:
        return chunk_len
    counts = np.bincount(h // shard_range, minlength=n_dev)
    top_frac = counts.max() / h.size
    est = int(math.ceil(top_frac * chunk_len * slack)) + floor
    return max(1, min(chunk_len, est))


def _chunk_layout(m_local: int, chunks: int) -> Tuple[int, int]:
    """Clamp K to the local stream and size its chunks: K never exceeds
    m_local (a chunk holds at least one tuple slot)."""
    k = max(1, min(int(chunks), max(1, m_local)))
    return k, -(-max(1, m_local) // k)


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == "add":
        return a + b
    return torch.minimum(a, b) if op == "min" else torch.maximum(a, b)


def pipelined_owner_reduce(
    idx: torch.Tensor,
    val: torch.Tensor,
    *,
    out_size: int,
    shard_range: int,
    mesh: StreamMesh,
    capacity: int,
    chunks: int = 1,
    op: str = "add",
    method: str = "fused",
    bin_range: Optional[int] = None,
    plan=None,
    packed: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked exchange + reduce on this rank's ``(m_local,)`` block.

    Chunk *i+1*'s ``all_to_all_single`` is started (``async_op=True``)
    before chunk *i*'s local reduce runs, so the exchange of the next chunk
    proceeds while this one is reduced (two chunks' receive buffers live at
    once). ``capacity`` is per chunk and destination. Returns ``(acc,
    overflow)``: the ``(shard_range, ...)`` local accumulator and a bool
    tensor, the same on every rank, True when any rank overflowed on any
    chunk.

    K = 1 is the monolithic schedule: one exchange, one reduce, no partial
    combine. For K > 1 integer ops, min and max stay exact; float ``add``
    gains a chunk-major partials tree and agrees to a tolerance."""
    k, chunk_len = _chunk_layout(idx.shape[0], chunks)
    fill = pb.reduce_identity(op, val.dtype)
    idx, val = _pad_to(idx, k * chunk_len, out_size), _pad_to(val, k * chunk_len, 0)

    def start(i):
        sl = slice(i * chunk_len, (i + 1) * chunk_len)
        return _start_owner_exchange(
            idx[sl], val[sl], out_size=out_size, shard_range=shard_range, mesh=mesh,
            capacity=capacity, fill_val=fill, packed=packed,
        )

    def local_reduce(li, lv):
        return execute_reduce(
            clamp_for_local_reduce(li, shard_range), lv, out_size=shard_range, op=op,
            method=method, bin_range=bin_range, plan=plan,
        )

    finish, of = start(0)
    if k == 1:
        acc = local_reduce(*finish())
    else:
        acc = torch.full((shard_range,) + tuple(val.shape[1:]), fill, dtype=val.dtype,
                         device=val.device)
        for i in range(1, k):
            nxt, nof = start(i)  # in flight while chunk i - 1 reduces
            acc = _combine(op, acc, local_reduce(*finish()))
            finish, of = nxt, of | nof
        acc = _combine(op, acc, local_reduce(*finish()))
    return acc, any_across(of, mesh)


def pipelined_owner_exchange_ordered(
    idx: torch.Tensor,
    val: torch.Tensor,
    *,
    out_size: int,
    shard_range: int,
    mesh: StreamMesh,
    capacity: int,
    chunks: int = 1,
    fill_val=0,
    packed: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked exchange that keeps global stream order for order-aware
    consumers (``shard_build_csr``).

    Chunk *i*'s receive buffer arrives in (source, slot) order, so
    concatenating chunks would interleave (chunk, source, slot). Stacking
    the K received ``(n_dev, capacity)`` buffers and transposing them to
    ``(n_dev, K, capacity)`` restores source-major order, which is global
    stream order. Sentinel slots (``shard_range``) lie between; a stable
    grouping drops them. Returns ``(local_idx, val, overflow)`` of length
    ``chunks * n_dev * capacity``, ``overflow`` reduced across the ranks.
    Every chunk's exchange is started before the first is awaited."""
    n_dev = mesh.size
    k, chunk_len = _chunk_layout(idx.shape[0], chunks)
    idx, val = _pad_to(idx, k * chunk_len, out_size), _pad_to(val, k * chunk_len, fill_val)
    tail = tuple(val.shape[1:])
    pending, of = [], None
    for i in range(k):
        sl = slice(i * chunk_len, (i + 1) * chunk_len)
        finish, ofi = _start_owner_exchange(
            idx[sl], val[sl], out_size=out_size, shard_range=shard_range, mesh=mesh,
            capacity=capacity, fill_val=fill_val, packed=packed,
        )
        pending.append(finish)
        of = ofi if of is None else (of | ofi)
    got = [f() for f in pending]
    # (K, n_dev, cap) -> (n_dev, K, cap): source-major = global order
    li = torch.stack([g[0].reshape(n_dev, capacity) for g in got]).transpose(0, 1).reshape(-1)
    lv = torch.stack([g[1].reshape((n_dev, capacity) + tail) for g in got]).transpose(0, 1)
    return li, lv.reshape((k * n_dev * capacity,) + tail), any_across(of, mesh)


def _check_device(t: torch.Tensor, mesh: StreamMesh, name: str) -> None:
    if t.device.type != mesh.device.type:
        raise ValueError(
            f"{name} lies on {t.device} but the mesh's ranks run on {mesh.device}"
        )


def shard_reduce_stream_info(
    indices: torch.Tensor,
    values: torch.Tensor,
    *,
    out_size: int,
    mesh: Optional[StreamMesh] = None,
    op: str = "add",
    axis_name: Optional[str] = None,
    method: str = "fused",
    bin_range: Optional[int] = None,
    capacity: Optional[int] = None,
    plan=None,
    pipeline_chunks: Optional[int] = None,
    packed: bool = True,
) -> Tuple[torch.Tensor, dict]:
    """``shard_reduce_stream`` plus an info dict: ``{"capacity",
    "pipeline_chunks", "overflow", "fallback", "packed",
    "safe_capacity"}``. ``capacity`` is the per-destination budget over
    the whole stream; each chunk gets ``ceil(capacity / K)``. ``None``
    estimates it from owner skew (``estimate_capacity``); on overflow the
    reduce reruns once, on every rank, at the always-safe chunk length."""
    if op not in REDUCE_OPS:
        raise ValueError(
            f"shard_reduce_stream serves commutative reductions {REDUCE_OPS}; got op={op!r}"
        )
    n_dev = mesh_size(mesh, axis_name)
    info = {
        "capacity": 0, "pipeline_chunks": 1, "overflow": False,
        "fallback": False, "packed": False, "safe_capacity": 0,
    }
    if n_dev == 1:
        out = execute_reduce(
            indices, values, out_size=out_size, op=op, method=method, bin_range=bin_range,
            plan=plan,
        )
        return out, info
    _check_device(indices, mesh, "indices")
    m = int(indices.shape[0])
    ident = pb.reduce_identity(op, values.dtype)
    if m == 0:
        return torch.full((out_size,) + tuple(values.shape[1:]), ident, dtype=values.dtype,
                          device=values.device), info
    r = shard_range_for(out_size, n_dev)
    m_local = -(-m // n_dev)
    k = pipeline_chunks if pipeline_chunks is not None else default_pipeline_chunks(
        m, out_size, n_dev)
    k, chunk_len = _chunk_layout(m_local, k)
    if capacity is not None:
        cap = max(1, min(chunk_len, -(-int(capacity) // k)))
    else:
        cap = estimate_capacity(indices, out_size=out_size, n_dev=n_dev, chunks=k)
    pk = packed and can_pack(values.dtype)
    info.update(capacity=cap, pipeline_chunks=k, packed=bool(pk), safe_capacity=chunk_len)
    # this rank's block of the stream padded to n_dev * K * chunk_len; the
    # sentinel index out_size marks padding all the way down
    per_dev = k * chunk_len
    idx_l = _rank_block(indices, mesh.rank, per_dev, out_size)
    val_l = _rank_block(values, mesh.rank, per_dev, 0)

    def run(c):
        return pipelined_owner_reduce(
            idx_l, val_l, out_size=out_size, shard_range=r, mesh=mesh, capacity=c, chunks=k,
            op=op, method=method, bin_range=bin_range, plan=plan, packed=pk,
        )

    acc, overflow = run(cap)
    if cap < chunk_len and bool(overflow):
        # the estimated capacity lost tuples on some rank: every rank reruns
        # at the always-safe per-chunk capacity (the flag is the same on all)
        info.update(overflow=True, fallback=True, capacity=chunk_len)
        acc, _ = run(chunk_len)
    return all_gather_cat(acc, mesh)[:out_size], info


def shard_reduce_stream(
    indices: torch.Tensor,
    values: torch.Tensor,
    *,
    out_size: int,
    mesh: Optional[StreamMesh] = None,
    op: str = "add",
    axis_name: Optional[str] = None,
    method: str = "fused",
    bin_range: Optional[int] = None,
    capacity: Optional[int] = None,
    plan=None,
    pipeline_chunks: Optional[int] = None,
    packed: bool = True,
) -> torch.Tensor:
    """Reduce one commutative (indices, values) stream to a dense
    ``(out_size, ...)`` tensor across the mesh's ranks.

    The coarsest binning pass routes tuples between ranks
    (``owner_exchange``) in ``pipeline_chunks`` double-buffered pieces
    (default: the roofline overlap model's pick); each rank then runs the
    single-device reduce (``method``, default the fused sweep) over its
    owned range, and the owned slices gather to the whole output on every
    rank. Exact for integer ops, min and max; float ``add`` to a
    tolerance. ``mesh=None`` or one rank is ``execute_reduce``."""
    out, _ = shard_reduce_stream_info(
        indices, values, out_size=out_size, mesh=mesh, op=op, axis_name=axis_name,
        method=method, bin_range=bin_range, capacity=capacity, plan=plan,
        pipeline_chunks=pipeline_chunks, packed=packed,
    )
    return out


# -- distributed pre-processing: sharded Neighbor-Populate (EL -> CSR) ----------


def _gather_ragged(x: torch.Tensor, count: int, mesh: StreamMesh) -> torch.Tensor:
    """Every rank's ``x[:count]`` (counts differ) concatenated in rank order:
    the counts first, then a gather padded to the largest, then a trim."""
    counts = all_gather_cat(torch.tensor([count], dtype=torch.int64, device=x.device), mesh)
    counts = counts.cpu().tolist()
    width = max(1, max(counts))
    padded = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    padded[:count] = x[:count]
    parts = all_gather_cat(padded, mesh).reshape((mesh.size, width) + tuple(x.shape[1:]))
    return torch.cat([parts[d, :c] for d, c in enumerate(counts)])


def shard_build_csr(
    coo: COO,
    mesh: Optional[StreamMesh] = None,
    axis_name: Optional[str] = None,
    capacity: Optional[int] = None,
    pipeline_chunks: Optional[int] = None,
    packed: bool = True,
) -> CSR:
    """Distributed Neighbor-Populate (paper Algorithm 2 at mesh scale):
    edges are owner-routed by source vertex between the ranks (in
    ``pipeline_chunks`` double-buffered pieces), each rank stably groups
    its owned vertex range, and the owned neighbour slices concatenate in
    rank order (= vertex order). Degree counting is the executor's sharded
    reduce. The stable partition, the source-ordered all_to_all and the
    chunk transpose keep Edgelist order within each vertex, so the CSR
    equals ``build_csr_oracle`` bit for bit. An overflowing estimated
    capacity reruns the exchange once at the always-safe chunk length."""
    n, m = coo.num_nodes, coo.num_edges
    n_dev = mesh_size(mesh, axis_name)
    if n_dev == 1 or m == 0:
        from repro_torch.core.neighbor_populate import build_csr_pb

        return build_csr_pb(coo, method="auto")
    _check_device(coo.src, mesh, "coo.src")
    axis = resolve_stream_axis(mesh, axis_name)
    # degree counting through the executor's sharded reduce: the local
    # method is decided at the per-rank shape under the topology key
    from repro_torch.core.executor import get_default_executor

    degrees = get_default_executor().shard_reduce_stream(
        coo.src, torch.ones(m, dtype=torch.int32, device=coo.src.device), out_size=n,
        mesh=mesh, op="add", axis_name=axis, capacity=capacity, pipeline_chunks=pipeline_chunks,
    )
    offsets = offsets_from_degrees(degrees)
    r = shard_range_for(n, n_dev)
    m_local = -(-m // n_dev)
    k = pipeline_chunks if pipeline_chunks is not None else default_pipeline_chunks(m, n, n_dev)
    k, chunk_len = _chunk_layout(m_local, k)
    if capacity is not None:
        cap = max(1, min(chunk_len, -(-int(capacity) // k)))
    else:
        cap = estimate_capacity(coo.src, out_size=n, n_dev=n_dev, chunks=k)
    pk = packed and can_pack(coo.dst.dtype)
    per_dev = k * chunk_len
    src_l = _rank_block(coo.src, mesh.rank, per_dev, n)  # sentinel src = n
    dst_l = _rank_block(coo.dst, mesh.rank, per_dev, 0)

    def run(c):
        return pipelined_owner_exchange_ordered(
            src_l, dst_l, out_size=n, shard_range=r, mesh=mesh, capacity=c, chunks=k, packed=pk)

    local_src, dst_r, overflow = run(cap)
    if cap < chunk_len and bool(overflow):
        local_src, dst_r, _ = run(chunk_len)
    # Bin-Read over the owned vertex range: a stable grouping by local
    # source; sentinels (shard_range) sort last and are trimmed by count
    order = torch.argsort(local_src, stable=True)
    dst_sorted = dst_r[order]
    count = int((local_src < r).sum())
    neighs = _gather_ragged(dst_sorted, count, mesh)
    return CSR(offsets, neighs.to(torch.int32), n)
