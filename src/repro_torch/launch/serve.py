"""Serving launcher: the continuous-batching engine on one card or over a
(data, model) mesh of ranks (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --device cpu \\
      --mesh host:2x2

It runs on the CUDA card unless ``--device`` names another; the weights
are random (``init_params`` with seed 0) and the prompts are drawn from
``numpy.random.default_rng(0)`` as in the reference, their lengths from
``[--min-prompt, --max-len // 4)`` (the reference's 8 by default).

Every family serves: dense, moe, ssm (``--arch xlstm-350m``), hybrid
(``--arch zamba2-2.7b``), vlm (``--arch llama-3.2-vision-11b``) and encdec
(``--arch whisper-base``), each with ``--preset full`` on the card and
``--preset smoke`` on the card or with ``--device cpu``. As in the
reference, requests are prompts only: the vlm and Whisper prefill their
cross caches from the prompt, which must fit them (1,601 rows for the
vlm, 1,500 for Whisper; 16 and 32 at ``--preset smoke``, so ``--max-len
64`` there, whose prompts are at most 15 tokens). The
recurrent families keep their states in the cache beside (hybrid) or in
place of (ssm) the KV cache; the hybrid family's prefill runs the flash
kernel at head_dim 80. ``--preset full`` of the moe family does not fit
one card: ``qwen3-moe-235b-a22b``'s 94 layers hold about 235 billion
parameters, about 470 GB in bfloat16, against the H100's 80 GB (nor does
it fit one chip of the reference). ``chip_smoke.py`` serves it at full
width with 8 of its layers.

``--mesh host:DxM`` serves over a D x M mesh of ranks
(``serving/server.py``: each rank holds its ``spec_for`` blocks of the
weights and the caches, every rank runs the same admissions and ticks and
agrees on every token). Without a process group it spawns D*M gloo ranks
(``launch/ranks.spawn_ranks``; on the card all on ``cuda:0``) and
returns rank 0's count, having checked that every rank's tokens agree;
inside a group of D*M ranks it runs as this rank. ``prod`` and
``prod-multipod`` need 256 and 512 ranks, as in ``launch/train.py``.
Rank 0 prints. The moe family's expert-sharded layer takes the batch
split over the batch axes, so an engine's one-row prefill raises on a
mesh whose ``data`` axis is above 1, as the reference fails there
(ROADMAP Queue 3); ``host:1xM`` serves it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch.train import mesh_shape
from repro_torch.models import transformer as T
from repro_torch.serving.server import Engine, Request

RANK_TIMEOUT = 24 * 3600.0  # seconds spawned ranks may take, spawn to join


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["full", "smoke"], default="smoke")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--min-prompt", type=int, default=8,
                    help="shortest prompt; lengths are drawn from [min-prompt, max-len // 4)")
    ap.add_argument("--mesh", default="none",
                    help="none | host:DxM (D*M ranks) | prod (16x16) | prod-multipod (2x16x16)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _serve_rank(rank: int, world: int, args: dict, outdir: str) -> None:
    """A spawned rank of ``--mesh host:DxM``: serve; rank 0 writes its count."""
    n = serve(argparse.Namespace(**args))
    if rank == 0:
        with open(os.path.join(outdir, "rank0.json"), "w") as f:
            json.dump({"done": n}, f)


def serve(args: argparse.Namespace) -> int:
    """Serve ``args.requests`` prompts; the count of finished requests."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    shape = mesh_shape(args.mesh)
    mesh = None
    if shape is not None:
        world = math.prod(shape.values())
        grouped = dist.is_available() and dist.is_initialized()
        if not grouped and args.mesh.startswith("host:") and world > 1:
            from repro_torch.launch.ranks import spawn_ranks

            with tempfile.TemporaryDirectory() as td:
                spawn_ranks(_serve_rank, world, store_dir=td, timeout=RANK_TIMEOUT,
                            args=(vars(args), td))
                with open(os.path.join(td, "rank0.json")) as f:
                    return json.load(f)["done"]
        have = dist.get_world_size() if grouped else 1
        if have != world:
            raise ValueError(f"--mesh {args.mesh} needs a process group of {world} ranks; "
                             f"there are {have}")
        mesh = shd.make_mesh(shape, device=dev)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    params = T.init_params(cfg, seed=0, device=dev, mesh=mesh)
    eng = Engine(cfg, params, slots=args.slots, max_len=args.max_len, mesh=mesh)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        plen = int(rng.integers(args.min_prompt, args.max_len // 4))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        eng.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    if mesh is not None:
        _check_agree(done, mesh)
    tok = sum(len(r.out) for r in done)
    if mesh is None or mesh.rank == 0:
        print(f"[serve] {len(done)} requests, {tok} tokens, {tok/max(dt,1e-9):.1f} tok/s")
    return len(done)


def _check_agree(done, mesh) -> None:
    """Raise unless every rank of the mesh finished the same requests with
    the same tokens."""
    toks = [t for r in sorted(done, key=lambda r: r.rid) for t in [r.rid, len(r.out)] + r.out]
    t = torch.tensor(toks or [0], dtype=torch.int64, device=mesh.device)
    n = shd.all_reduce(torch.tensor([t.numel(), -t.numel()], device=mesh.device),
                       mesh.axis_names, mesh, op="max")
    if int(n[0]) != -int(n[1]):
        raise RuntimeError("the ranks finished different requests")
    hi = shd.all_reduce(t, mesh.axis_names, mesh, op="max")
    lo = -shd.all_reduce(-t, mesh.axis_names, mesh, op="max")
    if not torch.equal(hi, lo):
        raise RuntimeError("the ranks' tokens differ")


def main(argv=None) -> int:
    return serve(parse_args(argv))


if __name__ == "__main__":
    main()
