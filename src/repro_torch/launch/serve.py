"""Serving launcher: the continuous-batching engine on one card (port of
``repro/launch/serve.py``; the reference's ``--mesh`` has no counterpart).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --device cpu

It runs on the CUDA card unless ``--device`` names another; the weights
are random (``init_params`` with seed 0) and the prompts are drawn from
``numpy.random.default_rng(0)`` as in the reference.

The moe family serves too (``--arch qwen3-moe-235b-a22b --preset smoke``,
on the card or with ``--device cpu``). ``--preset full`` of that model
does not fit one card: its 94 layers hold about 235 billion parameters,
about 470 GB in bfloat16, against the H100's 80 GB (nor does it fit one
chip of the reference). ``chip_smoke.py`` serves it at full width with 8
of its layers.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serving.server import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["full", "smoke"], default="smoke")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    params = T.init_params(cfg, seed=0, device=args.device)
    eng = Engine(cfg, params, slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        plen = int(rng.integers(8, args.max_len // 4))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        eng.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {tok} tokens, {tok/max(dt,1e-9):.1f} tok/s")
    return len(done)


if __name__ == "__main__":
    main()
