"""Logical-axis sharding over a mesh of ``torch.distributed`` ranks (port
of ``repro/distributed/sharding.py``).

Weights and activations carry *logical* axis names; a rule table maps
each name to candidate mesh axes. A dim is sharded on an axis only if
(a) the axis exists in the mesh, (b) the dim size is divisible by the
axis size, and (c) no other dim of the same tensor already uses the axis;
otherwise that dim is replicated (``spec_for``: the same rules, the same
tables, the same specs as the reference's ``PartitionSpec``).

**A layout, written out.** In the reference GSPMD reads the specs and
inserts the collectives. Here every rank holds only its blocks
(``shard_of``) and the code that uses a tensor says what moves: a
weight's data-sharded ``embed`` dim is all-gathered at its use (FSDP,
``weight``), a tensor-parallel product's input passes ``copy_to`` and its
output ``psum``, and a dim whose size does not split falls back to the
gathered tensor, as GSPMD's replication does. ``logical`` is therefore
the identity. Under autograd each collective has its adjoint:

- ``psum`` (all-reduce forward) passes its cotangent through unchanged:
  the tensor it makes is replicated, and so is that tensor's gradient;
- ``copy_to`` (identity forward) all-reduces its cotangent: the ranks
  that share the input each computed part of its gradient;
- ``weight``'s all-gather of a dim sums the gathered gradient over the
  axes the batch is split on (the ranks saw different rows: a
  reduce-scatter) and over its ``partial`` axes (the ranks used
  different columns of it), and takes this rank's block along the others
  (the ranks computed the same thing).

Serving adds two collectives GSPMD generates for the reference, without
autograd: ``seq_softmax_attend``, a softmax over keys split on an axis
(max, sum of exponentials, weighted values), and ``vocab_argmax``, the
greedy token of vocab-parallel logits with ``torch.argmax``'s tie rule.

**The mesh.** ``Mesh`` names the axes of a process group (ranks laid out
row-major over the axes in order, as ``jax.make_mesh`` lays out devices)
and holds one subgroup for every set of axes, made on every rank in the
same order. A mesh of one rank, or an axis set of size 1, runs no
collective. ``stream_mesh`` gives ``core/distributed_pb.py`` a 1-D view
of one axis. Collectives move and sum a tensor in its own dtype (a
bfloat16 sum rounds at each addition, as the reference's bfloat16
``psum`` does).
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# logical axis -> mesh axes to try (joined as a tuple spec entry if all fit)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "seq_kv": ("data", "model"),
    "embed": ("data",),  # FSDP: weight embed dim over data axis
    "embed_act": (),  # activation feature dim stays replicated
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv": ("model",),  # fused head*head_dim projections
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "layers": (),
    "conv": (),
    "state": (),
}

# "tp_fsdp": TP over model x FSDP over data. "ddp": every weight replicated
# and the batch split over every mesh axis.
PROFILES: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "tp_fsdp": DEFAULT_RULES,
    "ddp": {
        **DEFAULT_RULES,
        "batch": ("pod", "data", "model"),
        "embed": (),
        "heads": (),
        "kv_heads": (),
        "qkv": (),
        "mlp": (),
        "vocab": (),
        "experts": (),
        "seq_kv": ("data", "model"),
    },
}

Spec = Tuple[object, ...]  # entries: None, an axis name, or a tuple of names


class Mesh:
    """Named axes over the ranks of a process group. ``shape`` maps each
    axis to its size, in order; ``rank`` is this process's rank (row-major
    over the axes); ``groups`` maps each tuple of axes (in mesh order) to
    the process group of the ranks that differ from this one only along
    those axes (None where the tuple's size is 1, or for a mesh that runs
    no collective: the specs and blocks of any rank can be computed with
    ``Mesh(shape, rank=r)``)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, device=None):
        self.shape = {a: int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.global_ranks = list(range(self.size))  # the process group's rank of each
        self.groups: Dict[Tuple[str, ...], object] = {}  # make_mesh fills it
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.coords: Dict[str, int] = {}
        r = rank
        for a in reversed(self.axis_names):
            self.coords[a] = r % self.shape[a]
            r //= self.shape[a]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple, or None) as a tuple in mesh order."""
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in mesh axes {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes``: its block along a dim
        sharded on them."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group over ``axes`` (None when its size is 1)."""
        axes = self.axes(axes)
        if self.axis_size(axes) == 1:
            return None
        if axes not in self.groups:
            raise ValueError(f"{self} holds no process group over {axes}")
        return self.groups[axes]


def make_mesh(shape: Dict[str, int], device=None, ranks: Optional[Sequence[int]] = None
              ) -> Optional[Mesh]:
    """A ``Mesh`` of ``shape`` over the default process group, or over the
    group's ``ranks`` (in mesh order; the others get None: a job whose
    survivors continue on a smaller mesh). Its size must be the mesh's (a
    mesh of one rank needs no group). Every rank of the group must call
    it, in the same order as its other groups: it makes one subgroup per
    set of axes and coordinates of the others."""
    dev = resolve_device(device)
    size = math.prod(shape.values())
    if dist.is_available() and dist.is_initialized():
        world, grank = dist.get_world_size(), dist.get_rank()
    else:
        world, grank = 1, 0
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if size != len(ranks) or ranks != sorted(set(ranks)) or not set(ranks) <= set(range(world)):
        raise ValueError(f"a mesh of {dict(shape)} needs {size} ranks; got {ranks} of {world}")
    member = grank in ranks
    mesh = Mesh(shape, ranks.index(grank) if member else 0, device=dev)
    mesh.global_ranks = ranks
    if size == 1:
        return mesh if member else None
    names = mesh.axis_names
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if mesh.axis_size(axes) == 1:
                continue
            others = [a for a in names if a not in axes]
            for fixed in itertools.product(*(range(shape[a]) for a in others)):
                coord = dict(zip(others, fixed))
                members = []
                for free in itertools.product(*(range(shape[a]) for a in axes)):
                    coord.update(zip(axes, free))
                    r = 0
                    for a in names:
                        r = r * shape[a] + coord[a]
                    members.append(ranks[r])
                g = dist.new_group(sorted(members))
                if member and grank in members:
                    mesh.groups[axes] = g
    return mesh if member else None


def make_rank_mesh(data: int = 2, model: int = 2, pod: int = 0, device=None, ranks=None
                   ) -> Optional[Mesh]:
    """The (pod,) data x model mesh over the process group, or over its
    ``ranks`` (the counterpart of ``repro.launch.mesh.make_host_mesh``)."""
    shape = {"pod": pod} if pod else {}
    shape.update(data=data, model=model)
    return make_mesh(shape, device=device, ranks=ranks)


# -- the active mesh ----------------------------------------------------------


class _Ctx:
    # one per process, not per thread: autograd runs a CUDA graph's backward
    # (and the layers' recomputation under remat) on its own device thread
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, Tuple[str, ...]] = dict(DEFAULT_RULES)
        self.split: Optional[Tuple[str, ...]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    prev = _CTX.mesh, _CTX.rules, _CTX.split
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    _CTX.split = None
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules, _CTX.split = prev


@contextlib.contextmanager
def batch_split(axes: Sequence[str]):
    """Declare the axes the activations' batch is split on (default: the
    ``batch`` rule's axes in the mesh): the axes over which a weight's
    gradient is a partial sum."""
    prev = _CTX.split
    _CTX.split = tuple(axes)
    try:
        yield
    finally:
        _CTX.split = prev


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def active_rules() -> Dict[str, Tuple[str, ...]]:
    return _CTX.rules


def split_axes() -> Tuple[str, ...]:
    """The axes the batch is split on under the active mesh."""
    mesh = _CTX.mesh
    if mesh is None:
        return ()
    if _CTX.split is not None:
        return mesh.axes(_CTX.split)
    return mesh.axes([a for a in _CTX.rules.get("batch", ()) if a in mesh.shape])


def mesh_axis_size(mesh: Mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def spec_for(
    mesh: Mesh,
    dim_sizes: Sequence[int],
    names: Sequence[Optional[str]],
    rules: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> Spec:
    """The spec of a tensor with these logical names, with fallback: its
    entries are what the reference's ``PartitionSpec`` holds."""
    rules = rules or _CTX.rules
    used: set = set()
    entries = []
    for size, name in zip(dim_sizes, names):
        if not name:
            entries.append(None)
            continue
        cand = [a for a in rules.get(name, ()) if a in mesh.shape and a not in used]
        # largest prefix of candidate axes that divides the dim
        chosen: Tuple[str, ...] = ()
        for k in range(len(cand), 0, -1):
            axes = tuple(cand[:k])
            if size % mesh_axis_size(mesh, axes) == 0:
                chosen = axes
                break
        if chosen:
            used.update(chosen)
            entries.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            entries.append(None)
    return tuple(entries)


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec shards on."""
    return tuple(a for e in spec for a in entry_axes(e))


def shard_shape(shape: Sequence[int], spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """A block's shape (``NamedSharding.shard_shape``)."""
    return tuple(n // mesh.axis_size(entry_axes(e)) for n, e in zip(shape, spec))


def logical(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """The identity: the port's tensors are each rank's blocks, and the
    code that uses them moves what must move (module docstring)."""
    return x


def rules_for_profile(profile: str) -> Dict[str, Tuple[str, ...]]:
    return PROFILES[profile]


def batch_axes(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def model_axis(mesh: Optional[Mesh] = None) -> Optional[str]:
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return None
    return "model" if "model" in mesh.shape else None


# -- blocks ---------------------------------------------------------------------


def shard_of(full: torch.Tensor, spec: Spec, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's block of ``full`` (a view; ``full`` without a mesh)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return full
    out = full
    for dim, e in enumerate(spec):
        axes = entry_axes(e)
        n = mesh.axis_size(axes)
        if n > 1:
            b = full.shape[dim] // n
            out = out.narrow(dim, mesh.axis_index(axes) * b, b)
    return out


_COLLECTIVE_RECORDERS: list = []


@contextlib.contextmanager
def record_collectives(rec: dict):
    """Add the result bytes of every collective run inside the block to
    ``rec`` by kind (``all-reduce``, ``reduce-scatter``, ``all-gather``),
    the convention of the reference's HLO count: the dry run's collective
    term (``launch/dryrun.py``)."""
    _COLLECTIVE_RECORDERS.append(rec)
    try:
        yield rec
    finally:
        for i, r in enumerate(_COLLECTIVE_RECORDERS):  # by identity
            if r is rec:
                del _COLLECTIVE_RECORDERS[i]
                break


def _note(kind: str, result: torch.Tensor, parts: int = 1) -> None:
    nbytes = result.numel() * result.element_size() * parts
    for rec in _COLLECTIVE_RECORDERS:
        rec[kind] = rec.get(kind, 0) + nbytes


def all_reduce(t: torch.Tensor, axes, mesh: Optional[Mesh] = None, op: str = "sum"
               ) -> torch.Tensor:
    """``t`` reduced (sum or max) over ``axes`` (a new tensor; ``t`` itself
    over axes of size 1); no autograd."""
    mesh = mesh or _CTX.mesh
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return t
    buf = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=group)
    _note("all-reduce", buf)
    return buf


def reduce_scatter(t: torch.Tensor, dim: int, axes, mesh: Optional[Mesh] = None
                   ) -> torch.Tensor:
    """This rank's block along ``dim`` of ``t`` summed over ``axes``; no
    autograd."""
    mesh = mesh or _CTX.mesh
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // mesh.axis_size(axes),) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    _note("reduce-scatter", out)
    return out.movedim(0, dim).contiguous()


def all_gather(t: torch.Tensor, dim: int, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The blocks of every rank along ``axes`` concatenated along ``dim``
    in block order; no autograd."""
    mesh = mesh or _CTX.mesh
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return t
    b = t.contiguous().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(b) for _ in range(mesh.axis_size(axes))]
    dist.all_gather(parts, b, group=group)
    _note("all-gather", b, len(parts))
    return torch.cat([p.view(t.dtype).view(t.shape) for p in parts], dim=dim)


def gather(local: torch.Tensor, spec: Spec, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The whole tensor from each rank's block of it; no autograd."""
    mesh = mesh or _CTX.mesh
    out = local
    for dim, e in enumerate(spec):
        out = all_gather(out, dim, entry_axes(e), mesh)
    return out


def reshard(local: torch.Tensor, spec_from: Spec, spec_to: Spec,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's block under ``spec_to`` of a tensor held under
    ``spec_from``; no autograd."""
    if tuple(spec_from) == tuple(spec_to):
        return local
    mesh = mesh or _CTX.mesh
    return shard_of(gather(local, spec_from, mesh), spec_to, mesh)


# -- collectives under autograd ---------------------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return all_reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, ctx.mesh), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, summed, mesh):
        ctx.dim, ctx.axes, ctx.summed, ctx.mesh = dim, axes, summed, mesh
        ctx.block = x.shape[dim]
        return all_gather(x, dim, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return reduce_scatter(g, ctx.dim, ctx.axes, ctx.mesh), None, None, None, None
        i = ctx.mesh.axis_index(ctx.axes)
        # a copy: a view would hold the whole gathered gradient alive
        return g.narrow(ctx.dim, i * ctx.block, ctx.block).clone(), None, None, None, None


def psum(x: torch.Tensor, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum over the ranks along ``axes``; the cotangent passes unchanged."""
    mesh = mesh or _CTX.mesh
    if mesh is None or mesh.axis_size(mesh.axes(axes)) == 1:
        return x
    return _Psum.apply(x, mesh.axes(axes), mesh)


def copy_to(x: torch.Tensor, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The identity; the cotangent is summed over the ranks along ``axes``."""
    mesh = mesh or _CTX.mesh
    if mesh is None or mesh.axis_size(mesh.axes(axes)) == 1:
        return x
    return _CopyTo.apply(x, mesh.axes(axes), mesh)


def gather_dim(x: torch.Tensor, dim: int, axes, mesh: Optional[Mesh] = None,
               partial: Sequence[str] = ()) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``axes``. Backward: the cotangent
    summed over the batch-split axes among them and the ``partial`` ones
    (whose ranks each use a different part of the gathered tensor), then
    this rank's block."""
    mesh = mesh or _CTX.mesh
    axes = () if mesh is None else mesh.axes(axes)
    if not axes or mesh.axis_size(axes) == 1:
        return x
    split = tuple(split_axes()) + tuple(partial)
    summed = any(a in split for a in axes)
    if summed and not all(a in split for a in axes):
        raise ValueError(f"a gather over {axes} mixes batch-split axes {split} with others")
    return _Gather.apply(x, dim, axes, summed, mesh)


def weight(local: torch.Tensor, full_shape: Sequence[int], names: Sequence[Optional[str]],
           keep: Sequence[str] = (), partial: Sequence[str] = ()) -> torch.Tensor:
    """A weight as its use needs it: every dim of its spec sharded on axes
    outside ``keep`` all-gathered (FSDP's gather; a fallback's replication),
    the dims on ``keep`` left as this rank's block. ``partial``: axes whose
    ranks each compute with a different part of the gathered weight (a
    fused projection's columns), so its gradient is summed over them."""
    mesh = _CTX.mesh
    if mesh is None:
        return local
    out = local
    for dim, e in enumerate(spec_for(mesh, full_shape, names)):
        axes = entry_axes(e)
        if axes and not set(axes) <= set(keep):
            out = gather_dim(out, dim, axes, mesh, partial)
    return out


def block_range(n: int, axes, mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """[start, stop) of this rank's block of a dim of ``n`` split on
    ``axes`` (the whole dim without a mesh or axes)."""
    mesh = mesh or _CTX.mesh
    k = 1 if mesh is None else mesh.axis_size(axes)
    if k == 1:
        return 0, n
    b = n // k
    i = mesh.axis_index(axes)
    return i * b, (i + 1) * b


def vocab_argmax(logits: torch.Tensor, start: int, axes, mesh: Optional[Mesh] = None
                 ) -> torch.Tensor:
    """``torch.argmax`` over the last dim of logits whose columns are split
    on ``axes`` (this rank's block starts at column ``start``), as int64 on
    every rank: the max all-reduced, then the least index among the ranks
    that hold it, so a tie keeps the first index, as ``torch.argmax`` does
    on the whole row."""
    mesh = mesh or _CTX.mesh
    mx, idx = logits.max(-1)  # the first index of the local max
    idx = idx + start
    if mesh is None or mesh.axis_size(axes) == 1:
        return idx
    top = all_reduce(mx, axes, mesh, op="max")
    big = torch.iinfo(torch.int64).max
    cand = torch.where(mx == top, idx, torch.full_like(idx, big))
    return -all_reduce(-cand, axes, mesh, op="max")


def seq_softmax_attend(scores: torch.Tensor, v: torch.Tensor, axes,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """softmax(scores) @ v over a key axis split on ``axes``: ``scores``
    (..., Skv_local) float32 and ``v`` (..., Skv_local, hd) this rank's
    keys. The row max is all-reduced with max, the sum of exponentials
    with sum, and the weights (cast to v's dtype, as the one-device
    softmax's are) times the values with sum, in float32; no autograd."""
    mesh = mesh or _CTX.mesh
    m = all_reduce(scores.amax(-1, keepdim=True), axes, mesh, op="max")
    p = torch.exp(scores - m)
    w = (p / all_reduce(p.sum(-1, keepdim=True), axes, mesh)).to(v.dtype)
    return all_reduce((w @ v).float(), axes, mesh).to(v.dtype)


def tp_axes(full_shape: Sequence[int], names: Sequence[Optional[str]], dim: int
            ) -> Tuple[str, ...]:
    """The axes dim ``dim`` of a weight is sharded on under the active mesh."""
    mesh = _CTX.mesh
    if mesh is None:
        return ()
    return entry_axes(spec_for(mesh, full_shape, names)[dim])


def stream_mesh(axis: str, mesh: Optional[Mesh] = None):
    """A ``StreamMesh`` over one axis's subgroup, for ``distributed_pb``."""
    from repro_torch.core.distributed_pb import StreamMesh

    mesh = mesh or _CTX.mesh
    return StreamMesh(mesh.group(axis), axis, mesh.axis_size(axis), mesh.axis_index(axis),
                      mesh.device)
