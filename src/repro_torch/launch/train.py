"""Training launcher (port of ``repro/launch/train.py``), on one card or
over a (data, model) mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --preset full --seq-len 4096 --batch 4 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --preset smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --preset smoke --steps 3 --mesh host:2x2 --device cpu

``--arch`` takes every family: dense, moe (``qwen3-moe-235b-a22b``), ssm
(``xlstm-350m``), hybrid (``zamba2-2.7b``), vlm (``llama-3.2-vision-11b``)
and encdec (``whisper-base``). As in the reference, the data pipeline
yields tokens and labels only, so the vlm and encdec families train with
their cross layers (and Whisper's encoder) skipped and their gradients
zero (ROADMAP Queue 3). It runs on the CUDA card unless
``--device`` names another. Wired in, as
in the reference: the deterministic restartable data pipeline
(``data/pipeline.py``), async checkpoints with auto-resume
(``checkpoint/manager.py``), the straggler detector and the heartbeat
watchdog (``ft/resilience.py``). The weights start from ``init_params``
with seed 0.

``--mesh host:DxM`` trains every family over a D x M mesh
of ranks (``distributed/sharding.py``: tensor-parallel over ``model``,
FSDP over ``data``, each data rank on its block of the global batch's
rows). Without a process group it spawns D*M gloo ranks
(``launch/ranks.spawn_ranks``) and returns rank 0's losses, having
checked that every rank's agree (its ``TrainRun`` holds no state: the
ranks held it); inside a group of D*M ranks (torchrun's, or a caller's)
it runs as this rank of it. On the card every rank uses ``cuda:0`` (NCCL
refuses two ranks on one device; gloo stages through host memory).
``prod`` and ``prod-multipod`` are the reference's 16 x 16 and 2 x 16 x 16
meshes and need a group of 256 or 512 ranks. Rank 0 prints. A checkpoint
is saved in blocks: every rank writes its own ``shard-<rank>.npz`` and
``part-<rank>.json`` and rank 0 publishes the manifest
(``CheckpointManager``); a resume on another mesh assembles each rank's
new blocks from the saved blocks they overlap. Gradient compression is
not wired in, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
from typing import List, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import SHAPES, ShapeSpec, get_config
from repro_torch.data.pipeline import make_data
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.ft.resilience import Heartbeat, StragglerDetector
from repro_torch.models import transformer as T
from repro_torch.serving.graph_frontend import Clock
from repro_torch.train import steps as steps_mod
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.steps import TrainState, default_opt_config


class TrainRun(NamedTuple):
    """What one run did: the final state, the step it started from, and
    per step run its loss, grad norm, learning rate and wall seconds (each
    step ends in a wait for the card: its loss is read)."""

    state: TrainState
    start_step: int
    losses: List[float]
    grad_norms: List[float]
    lrs: List[float]
    step_seconds: List[float]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--preset", choices=["full", "smoke"], default="smoke",
                    help="smoke: reduced config of the same family (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="none",
                    help="none | host:DxM (D*M ranks) | prod (16x16) | prod-multipod (2x16x16)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation (microbatching) factor")
    ap.add_argument("--ckpt-final", action=argparse.BooleanOptionalAction, default=True,
                    help="save a checkpoint after the last step")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def mesh_shape(spec: str):
    """The mesh of a ``--mesh`` value as {axis: size}; None for ``none``."""
    if spec == "none":
        return None
    if spec == "prod":
        return {"data": 16, "model": 16}
    if spec == "prod-multipod":
        return {"pod": 2, "data": 16, "model": 16}
    if spec.startswith("host:"):
        try:
            D, M = (int(x) for x in spec[5:].lower().split("x"))
        except ValueError:
            raise ValueError(f"--mesh {spec!r}: expected host:DxM") from None
        return {"data": D, "model": M}
    raise ValueError(f"--mesh {spec!r}: expected none, host:DxM, prod or prod-multipod")


def _mesh_rank(rank: int, world: int, args: dict, outdir: str) -> None:
    """A spawned rank of ``--mesh host:DxM``: train; rank 0 writes its run."""
    run = train(argparse.Namespace(**args))
    if rank == 0:
        with open(os.path.join(outdir, "rank0.json"), "w") as f:
            json.dump({k: getattr(run, k) for k in ("start_step", "losses", "grad_norms", "lrs",
                                                    "step_seconds")}, f)


RANK_TIMEOUT = 24 * 3600.0  # seconds spawned ranks may take, spawn to join


def _spawn_mesh(args: argparse.Namespace, world: int) -> TrainRun:
    """Run ``train`` on ``world`` spawned gloo ranks (each checks that the
    ranks' losses agree); rank 0's run, without its state."""
    from repro_torch.launch.ranks import spawn_ranks

    with tempfile.TemporaryDirectory() as td:
        spawn_ranks(_mesh_rank, world, store_dir=td, timeout=RANK_TIMEOUT, args=(vars(args), td))
        with open(os.path.join(td, "rank0.json")) as f:
            r0 = json.load(f)
    return TrainRun(None, r0["start_step"], r0["losses"], r0["grad_norms"], r0["lrs"],
                    r0["step_seconds"])


def train(args: argparse.Namespace) -> TrainRun:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    shape_of_mesh = mesh_shape(args.mesh)
    mesh = None
    if shape_of_mesh is not None:
        world = math.prod(shape_of_mesh.values())
        grouped = dist.is_available() and dist.is_initialized()
        if not grouped and args.mesh.startswith("host:") and world > 1:
            return _spawn_mesh(args, world)
        have = dist.get_world_size() if grouped else 1
        if have != world:
            raise ValueError(f"--mesh {args.mesh} needs a process group of {world} ranks; "
                             f"there are {have}")
        mesh = shd.make_mesh(shape_of_mesh, device=dev)
    lead = mesh is None or mesh.rank == 0
    if args.preset == "smoke":
        cfg = cfg.reduced()
    shape = SHAPES.get(args.shape)
    if shape is None or args.preset == "smoke":
        shape = ShapeSpec("custom", args.seq_len or 128, args.batch or 8, "train")
    if args.seq_len or args.batch:
        shape = dataclasses.replace(
            shape, seq_len=args.seq_len or shape.seq_len,
            global_batch=args.batch or shape.global_batch,
        )

    oc = default_opt_config(cfg, total_steps=args.steps)
    train_step = steps_mod.make_train_step(cfg, oc, accum_steps=args.accum, mesh=mesh)
    data = make_data(cfg, shape, host_index=0, host_count=1)  # every rank: the global batch
    model = T.init_params(cfg, seed=0, device=dev, mesh=mesh)
    state = TrainState(model, init_opt_state(dict(model.named_parameters()), oc))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    on_mesh = {}
    if mesh is not None:
        specs, shapes = steps_mod.state_specs(state, cfg, mesh)
        on_mesh = {"mesh": mesh, "specs": specs}
    start_step = 0
    if ckpt and args.resume:
        restored, at = ckpt.restore(state, **on_mesh)
        if restored is not None:
            state, start_step = restored, at
            if lead:
                print(f"[train] resumed from step {at}")
    if mesh is not None:
        on_mesh["shapes"] = shapes

    hb = Heartbeat(timeout_s=600, on_timeout=lambda: print("[ft] WATCHDOG FIRED")).start()
    sd = StragglerDetector()
    clock = Clock()  # monotonic: step times survive NTP wall-clock steps
    run = TrainRun(state, start_step, [], [], [], [])
    try:
        t_log = t_last = clock.now()
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}
            state, metrics = train_step(state, batch)
            run.losses.append(float(metrics["loss"]))  # waits for the step
            run.grad_norms.append(float(metrics["grad_norm"]))
            run.lrs.append(metrics["lr"])
            now = clock.now()
            run.step_seconds.append(now - t_last)
            t_last = now
            hb.beat()
            if (step + 1) % args.log_every == 0 or step == start_step:
                dt, t_log = now - t_log, now
                n = 1 if step == start_step else args.log_every
                slow = sd.observe("host0", dt / n)
                tok_s = shape.global_batch * shape.seq_len * n / max(dt, 1e-9)
                if lead:
                    print(f"[train] step={step + 1} loss={run.losses[-1]:.4f} "
                          f"{tok_s:,.0f} tok/s{' STRAGGLER' if slow else ''}", flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state, **on_mesh)  # async
        if ckpt and args.ckpt_final:
            ckpt.save(args.steps, state, blocking=True, **on_mesh)
    finally:
        hb.stop()
        if ckpt:
            ckpt.wait()
    if mesh is not None:
        _check_agree(run.losses, mesh)
    final = run.losses[-1] if run.losses else math.nan
    if lead:
        print(f"[train] done: {args.steps} steps, final loss {final:.4f}")
    return run._replace(state=state)


def _check_agree(losses: List[float], mesh) -> None:
    """Raise unless every rank of the mesh saw the same losses."""
    t = torch.tensor(losses, dtype=torch.float64)
    lo = shd.all_reduce(t, mesh.axis_names, mesh, op="max")
    hi = -shd.all_reduce(-t, mesh.axis_names, mesh, op="max")
    if not torch.equal(lo, hi):
        raise RuntimeError(f"the ranks' losses differ: {lo.tolist()} vs {hi.tolist()}")


def main(argv=None) -> float:
    """Train as the flags say; returns the last step's loss (nan when the
    checkpoint already holds ``--steps``)."""
    run = train(parse_args(argv))
    return run.losses[-1] if run.losses else math.nan


if __name__ == "__main__":
    main()
