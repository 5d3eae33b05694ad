"""Training launcher (port of ``repro/launch/train.py``) on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --preset full --seq-len 4096 --batch 4 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --preset smoke --steps 20 --device cpu

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
with seed 0. ``--mesh`` takes only ``none``: the sharded path waits for
ROADMAP Queue 1 item 3 (Sharded PB), and gradient compression with it.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from typing import List, NamedTuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import SHAPES, ShapeSpec, get_config
from repro_torch.data.pipeline import make_data
from repro_torch.device import resolve_device
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
    ap.add_argument("--mesh", default="none", help="none (the sharded path is not ported)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation (microbatching) factor")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> TrainRun:
    if args.mesh != "none":
        raise ValueError(
            f"--mesh {args.mesh!r}: the port trains on one card; meshes wait for the "
            "sharded path (ROADMAP Queue 1 item 3, Sharded PB)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
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
    train_step = steps_mod.make_train_step(cfg, oc, accum_steps=args.accum)
    data = make_data(cfg, shape, host_index=0, host_count=1)
    model = T.init_params(cfg, seed=0, device=dev)
    state = TrainState(model, init_opt_state(dict(model.named_parameters()), oc))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume:
        restored, at = ckpt.restore(state)
        if restored is not None:
            state, start_step = restored, at
            print(f"[train] resumed from step {at}")

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
                print(f"[train] step={step + 1} loss={run.losses[-1]:.4f} "
                      f"{tok_s:,.0f} tok/s{' STRAGGLER' if slow else ''}", flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state)  # async
        if ckpt:
            ckpt.save(args.steps, state, blocking=True)
    finally:
        hb.stop()
        if ckpt:
            ckpt.wait()
    final = run.losses[-1] if run.losses else math.nan
    print(f"[train] done: {args.steps} steps, final loss {final:.4f}")
    return run._replace(state=state)


def main(argv=None) -> float:
    """Train as the flags say; returns the last step's loss (nan when the
    checkpoint already holds ``--steps``)."""
    run = train(parse_args(argv))
    return run.losses[-1] if run.losses else math.nan


if __name__ == "__main__":
    main()
