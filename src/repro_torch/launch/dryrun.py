"""Dry run of every production cell for the H100, traced on the ``meta``
device (port of ``repro/launch/dryrun.py``).

For each (arch x shape) cell on the ``16x16`` (256 ranks) and
``2x16x16`` (512 ranks) meshes (``launch/train.py``'s ``prod`` and
``prod-multipod``), rank 0 answers the reference's three questions
without a card and without XLA:

* **State bytes per rank, exact**: the parameters' blocks by
  ``param_specs`` / ``shard_shape``, the optimizer state of
  ``default_opt_config`` (AdamW's two moments, or Adafactor's ``v``
  factored per reference leaf), and for decode the caches' blocks.
* **Does the step fit, and at which accumulation factor**: the port's own
  ``make_train_step`` / prefill / decode step runs at full depth on
  ``meta`` tensors in rank 0's blocks, with a ``fake`` process group of
  ``chips`` ranks under ``make_mesh`` (the collectives run and move
  nothing). ``_Account``, a ``TorchDispatchMode``, tracks the live
  storage bytes (a storage counts from the op that makes it until its
  weakref finaliser runs) and adds up every op's input and output bytes.
  For train cells ``accum_steps`` is searched over 1, 2, 4, 8, 16, as the
  reference does, for the smallest whose peak stays under 0.94 x the
  card's 80 GB (``HardwareModel.h100().device_memory``).
* **The roofline terms**: FLOPs from ``FlopCounterMode`` plus the
  hand-written kernels' own (their ``meta`` route reports FLOPs and bytes
  to ``kernels/_lib.record_meta``: ``FlopCounterMode`` cannot see a
  ctypes launch), bytes from ``_Account``, collective result bytes by
  kind from ``distributed/sharding.record_collectives``; ``Roofline``
  with the H100 defaults. Every mesh axis is priced at NVLink's 900 GB/s,
  although a 16-way model axis spans two 8-GPU NVLink domains.

The port's layers are eager Python, so the full-depth trace counts every
layer. ``probe_layers`` and ``extrapolate`` are kept as a check (on the
single-pod mesh, as the reference runs its probes there): the FLOPs
extrapolated from two probe depths must equal the full-depth count. The
reference's CPU-float32 corrections (``dtype_scale``,
``cpu_bf16_inflation_est``, ``live_bytes_tpu_corrected``) correct XLA's
CPU backend, which the port does not have, and have no twin.

A cell that fails is recorded with its error; the run exits 1 unless
every cell passed. Nothing is allocated: a ``meta`` tensor holds no
data, so an ``.item()`` or ``int(tensor)`` on a step's path fails here
(and is a host sync on the card).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --jobs 7 --out dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.report dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import SHAPES, ShapeSpec, cells, get_config
from repro_torch.core.plan import HardwareModel
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import _lib
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, flops_per_token
from repro_torch.roofline import CellCost, Roofline, extrapolate
from repro_torch.serving.graph_frontend import Clock
from repro_torch.train import steps as steps_mod
from repro_torch.train.optimizer import (OptConfig, _factored_shape, _leaf_groups,
                                         adafactor_specs, init_opt_state, moment_spec,
                                         reference_leaf)

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
HBM_BYTES = HardwareModel.h100().device_memory  # 80 GB
FIT_SHARE = 0.94  # the reference's runtime headroom
ACCUM_CHOICES = (1, 2, 4, 8, 16)
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

_CLOCK = Clock()  # monotonic: trace times survive wall-clock steps


# ---------------------------------------------------------------------------
# The fake world and rank 0's abstract state.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks with this process as
    rank 0: collectives are accepted and move nothing. Torn down on exit.
    The backend lives in ``torch.testing._internal``; without it the dry
    run stops (there is no other route)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg)") from e
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; one is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def param_bytes(cfg: ModelConfig, mesh: shd.Mesh, rules) -> int:
    """Exact bytes of rank 0's parameter blocks."""
    specs = T.param_specs(cfg, mesh, rules)
    return sum(_nbytes(shd.shard_shape(p.shape, specs[n], mesh), p.dtype)
               for n, p in T.LM(cfg, "meta").named_parameters())


def opt_bytes(cfg: ModelConfig, mesh: shd.Mesh, rules, oc: OptConfig) -> int:
    """Exact bytes of rank 0's blocks of the optimizer state: AdamW's two
    moments like the parameters, or Adafactor's second moment factored by
    the reference's rule on each reference leaf's whole shape (the stack,
    then the tensor), each factor sharded as its leaf."""
    mdt = getattr(torch, oc.moment_dtype)
    specs = T.param_specs(cfg, mesh, rules)
    shapes = T.param_shapes(cfg)
    if oc.kind == "adamw":
        return 2 * sum(_nbytes(shd.shard_shape(shapes[n], specs[n], mesh), mdt) for n in specs)
    vspecs = adafactor_specs(specs, list(specs))
    total = 0
    for key, names in _leaf_groups(specs).items():
        index = [reference_leaf(n)[1] for n in names]
        lead = () if index[0] is None else tuple(
            max(i[a] for i in index) + 1 for a in range(len(index[0])))
        whole = lead + shapes[names[0]]
        fs = _factored_shape(whole)
        if fs is None:
            total += _nbytes(shd.shard_shape(whole, vspecs[key], mesh), mdt)
        else:
            sp = moment_spec(vspecs[key], fs)
            total += sum(_nbytes(shd.shard_shape(f, s, mesh), mdt) for f, s in zip(fs, sp))
    return total


def abstract_model(cfg: ModelConfig, mesh: Optional[shd.Mesh], rules) -> T.LM:
    """An ``LM`` whose parameters are rank 0's blocks (the whole tensors
    without a mesh), on ``meta``."""
    model = T.LM(cfg, "meta")
    if mesh is None:
        return model
    specs = T.param_specs(cfg, mesh, rules)
    for name, p in list(model.named_parameters()):
        T.set_param(model, name, torch.empty(shd.shard_shape(p.shape, specs[name], mesh),
                                             dtype=p.dtype, device="meta"))
    return model


def abstract_cache(cfg: ModelConfig, shape: ShapeSpec, mesh: Optional[shd.Mesh], rules
                   ) -> T.StepState:
    """Rank 0's decode state at the cache's last position: every leaf its
    block on ``meta``, the index ``seq_len - 1`` (a full-depth read)."""
    st = T.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta", mesh=mesh,
                      rules=rules)
    return st._replace(index=shape.seq_len - 1)


def tensors_of(tree) -> list:
    """Every tensor of a nest of dicts, lists, tuples and modules."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


# ---------------------------------------------------------------------------
# The accounting of a traced step.
# ---------------------------------------------------------------------------


class _Account(TorchDispatchMode):
    """Adds up every op's input and output bytes (views and the process
    group's ops excluded) and tracks live storage bytes: a storage counts
    from the op that first returns it (or ``hold``) until its weakref
    finaliser runs. ``peak`` is the most live at once."""

    SKIP_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in self.SKIP_NAMESPACES:
            return out
        outs = [t for t in _flat(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.hold(t)
        if not func.is_view:
            ins = [t for t in _flat((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def _flat(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _flat(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _flat(v)
    else:
        yield x


@dataclasses.dataclass
class Trace:
    """One traced step on rank 0: FLOPs (``FlopCounterMode`` plus the
    kernels'), bytes, collective result bytes by kind, peak live bytes,
    and the kernels' meta-route record."""

    flops: float
    bytes_accessed: float
    collective: Dict[str, float]
    peak_bytes: int
    kernels: Dict[str, dict]
    aten_flops: float


def trace_step(fn, held) -> Trace:
    """Run ``fn()`` under the accounting; ``held`` are the tensors that
    live before it (state, batch), counted from the start."""
    acct = _Account()
    kern: Dict[str, dict] = {}
    coll: Dict[str, float] = {}
    fc = FlopCounterMode(display=False)
    with fc, acct, _lib.record_meta(kern), shd.record_collectives(coll):
        for t in held:
            acct.hold(t)
        result = fn()
        del result
    kflops = sum(e["flops"] for e in kern.values())
    kbytes = sum(e["bytes"] for e in kern.values())
    aten = float(fc.get_total_flops())
    coll = {k: float(coll.get(k, 0.0)) for k in COLLECTIVE_KINDS}
    coll["total"] = sum(coll.values())
    return Trace(aten + kflops, acct.bytes + kbytes, coll, acct.peak, kern, aten)


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Optional[shd.Mesh] = None,
               accum_steps: int = 1) -> Trace:
    """The trace of a cell's step on rank 0 of ``mesh`` (one device
    without): the port's train, prefill or decode step on ``meta`` state
    and batch, the state counted live from the start."""
    rules = shd.rules_for_profile(cfg.sharding_profile)
    model = abstract_model(cfg, mesh, rules)
    batch = steps_mod.batch_struct(cfg, shape)
    if shape.kind == "train":
        oc = steps_mod.default_opt_config(cfg)
        state = steps_mod.TrainState(model, init_opt_state(dict(model.named_parameters()), oc))
        step = steps_mod.make_train_step(cfg, oc, accum_steps=accum_steps, mesh=mesh)
        return trace_step(lambda: step(state, batch),
                          tensors_of((model, state.opt.m, state.opt.v, batch)))
    if shape.kind == "prefill":
        step = steps_mod.make_prefill_step(cfg, max_len=shape.seq_len, mesh=mesh)
        return trace_step(lambda: step(model, batch), tensors_of((model, batch)))
    if shape.kind == "decode":
        st = abstract_cache(cfg, shape, mesh, rules)
        step = steps_mod.make_decode_step(cfg, mesh=mesh)
        return trace_step(lambda: step(model, st, batch["tokens"]),
                          tensors_of((model, st.caches, batch)))
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Probes (a check of the full-depth count).
# ---------------------------------------------------------------------------


def probe_layers(cfg: ModelConfig):
    """(L_a, L_b) probe depths respecting family periodicity."""
    if cfg.family == "vlm":
        return cfg.cross_attn_every, 2 * cfg.cross_attn_every
    if cfg.family == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every
    return 2, 4


def probe_cost(cfg: ModelConfig, shape: ShapeSpec, mesh: shd.Mesh, n_layers: int) -> CellCost:
    t = trace_cell(dataclasses.replace(cfg, num_layers=n_layers), shape, mesh)
    return CellCost(flops=t.flops, bytes_accessed=t.bytes_accessed, collective=t.collective,
                    num_layers=n_layers)


# ---------------------------------------------------------------------------
# One cell.
# ---------------------------------------------------------------------------


def batch_ways(mesh: shd.Mesh) -> int:
    return math.prod(mesh.shape[a] for a in ("pod", "data") if a in mesh.shape)


def analyze_cell(
    arch: str,
    shape_name: str,
    mesh_name: str,
    mesh: shd.Mesh,
    skip_probes: bool = False,
    overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The record of one cell on rank 0 of ``mesh`` (its fake world up)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    chips = mesh.size
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "chips": chips, "ok": False}
    t0 = _CLOCK.now()
    rules = shd.rules_for_profile(cfg.sharding_profile)
    state_b = param_bytes(cfg, mesh, rules)
    if shape.kind == "train":
        state_b += opt_bytes(cfg, mesh, rules, steps_mod.default_opt_config(cfg))
    if shape.kind == "decode":
        st = abstract_cache(cfg, shape, mesh, rules)
        state_b += sum(t.numel() * t.element_size() for t in T.cache_leaves(st.caches))
    rec["state_bytes_per_device"] = int(state_b)

    accum_opts = [a for a in (ACCUM_CHOICES if shape.kind == "train" else (1,))
                  if shape.global_batch % (a * batch_ways(mesh)) == 0] or [1]
    for accum in accum_opts:
        tr = trace_cell(cfg, shape, mesh, accum)
        if tr.peak_bytes < HBM_BYTES * FIT_SHARE:
            break
    rec["trace_s"] = round(_CLOCK.now() - t0, 1)
    rec["accum_steps"] = accum
    live = tr.peak_bytes
    rec["memory_per_device"] = {
        "live_bytes": int(live),
        "state_bytes": int(state_b),
        "fits_80GB_hbm": bool(live < HBM_BYTES * FIT_SHARE),
    }
    rec["kernels"] = tr.kernels
    rec["aten_flops_per_device"] = tr.aten_flops
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = flops_per_token(cfg) * tokens
    if shape.kind != "train":
        mf /= 3.0  # forward only: 2*N*D
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops=tr.flops * chips, bytes_accessed=tr.bytes_accessed * chips,
        collective_bytes=tr.collective["total"] * chips, model_flops=mf,
        memory_fit=f"{live / 1e9:.2f} GB/device",
        collective_detail={k: v * chips for k, v in tr.collective.items()},
    )
    rec["roofline"] = rl.row()
    rec["ok"] = True
    if skip_probes:
        return rec
    La, Lb = probe_layers(cfg)
    ca = probe_cost(cfg, shape, mesh, La)
    cb = probe_cost(cfg, shape, mesh, Lb)
    full = extrapolate(ca, cb, cfg.num_layers)
    rec["probe_costs"] = {
        "La": La, "Lb": Lb, "flops_a": ca.flops, "flops_b": cb.flops,
        "bytes_a": ca.bytes_accessed, "bytes_b": cb.bytes_accessed,
        "coll_a": ca.collective["total"], "coll_b": cb.collective["total"],
        "flops_extrapolated": full.flops, "flops_full_depth": tr.flops,
    }
    if not math.isclose(full.flops, tr.flops, rel_tol=1e-9):
        rec["ok"] = False
        rec["error"] = (f"probe extrapolation {full.flops:.6e} FLOPs != full-depth trace "
                        f"{tr.flops:.6e}")
    return rec


def run_cell(job) -> Dict[str, Any]:
    """One cell, ``(arch, shape, mesh name, skip_probes, overrides)``, in a
    fake world of its own; a failing cell is recorded with its error."""
    arch, sname, mesh_name, skip_probes, overrides = job
    tag = f"{arch} x {sname} x {mesh_name}"
    shape = MESHES[mesh_name]
    t0 = _CLOCK.now()
    with fake_world(math.prod(shape.values())):
        mesh = shd.make_mesh(shape, device="meta")
        try:
            rec = analyze_cell(arch, sname, mesh_name, mesh, skip_probes=skip_probes,
                               overrides=overrides)
            rl = rec["roofline"]
            print(f"[{'OK' if rec['ok'] else 'FAIL'}] {tag} ({_CLOCK.now() - t0:.0f}s) "
                  f"mem={rec['memory_per_device']['live_bytes'] / 1e9:.2f}GB "
                  f"accum={rec['accum_steps']} bottleneck={rl['bottleneck']} "
                  f"frac={rl['roofline_fraction']:.3f}"
                  + (f" {rec['error']}" if not rec["ok"] else ""), flush=True)
        except Exception as e:  # recorded below, with its traceback
            rec = {"arch": arch, "shape": sname, "mesh": mesh_name, "chips": mesh.size,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:200]}", flush=True)
    return rec


def run_cells(todo, mesh_names, skip_probes: bool = False, overrides=None, out=None,
              jobs: int = 1) -> list:
    """Every (arch, shape) of ``todo`` on each mesh, in order; the probe
    check on the single-pod mesh only, as the reference runs it. ``jobs >
    1`` traces that many cells at once in spawned processes (a trace is
    one core's Python; the recurrent families' token loops take the
    longest). The records are written to ``out`` as they come."""
    work = [(arch, sname, mesh_name, skip_probes or mesh_name != "16x16", overrides)
            for mesh_name in mesh_names for arch, sname in todo]
    results = []
    with contextlib.ExitStack() as stack:
        if jobs > 1:
            import multiprocessing

            pool = stack.enter_context(multiprocessing.get_context("spawn").Pool(jobs))
            recs = pool.imap(run_cell, work)
        else:
            recs = map(run_cell, work)
        for rec in recs:
            results.append(rec)
            if out:
                with open(out, "w") as f:
                    json.dump(results, f, indent=1, default=str)
    return results


def parse_override(items) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for ov in items:
        k, v = ov.split("=", 1)
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        elif v.isdigit():
            v = int(v)
        overrides[k] = v
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--skip-probes", action="store_true",
                    help="no probe check (the multi-pod pass never runs it)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value, e.g. --override sharding_profile=ddp")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)
    if args.all:
        todo = [(a, s) for a, s, skip in cells() if skip is None]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = {"single": ["16x16"], "multi": ["2x16x16"], "both": ["16x16", "2x16x16"]}[args.mesh]
    results = run_cells(todo, meshes, args.skip_probes, parse_override(args.override), args.out,
                        args.jobs)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells traced OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
