#!/usr/bin/env python3
"""Time and trace the port's PB binning kernels on one NVIDIA card.

    python3 scripts/torch_pb_kernels.py [--src DIR] [--rounds 5] [--reps 20]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so that two trees (a parent commit unpacked beside this one, and this
one) can be measured in one call, in turns. Every number comes from the
card: CUDA events around ``reps`` back-to-back launches, and
``torch.profiler`` for the device time of each sub-kernel of one call.
Prints one JSON object per line:

- ``profile``: one call each of ``counting_positions`` and
  ``cobra_bin_accumulate`` at S2 (``gen_uniform(2^22, 8, seed=3)``: fig5's
  PageRank stream, m = 33,554,432 edges into n = 4,194,304 vertices, keys
  binned at 512 bins), kernel by kernel.
- ``interleaved``: each kernel and its yardstick timed in ``rounds``
  alternating rounds of ``reps`` launches: the fused accumulate against
  ``index_add_`` at S2 and at the S1 KRON and DBP graphs (the bench
  suite's 2^18-vertex graphs, the shapes of most fused launches of fig5),
  positions at S2, and the histogram against ``torch.bincount`` at S2.
  For each: the per-round means and their spread (min, max).
- ``designs``: where the wrapper takes ``design=``, each design of the
  fused accumulate and of positions at the same shapes, interleaved, and
  traced; ``crossover``: both fused designs on uniform streams of 2^21
  to 2^25 tuples into m / 8 indices, interleaved.

The card's name and power limit (``nvidia-smi``) come first. Exits
non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def say(tag: str, rec) -> None:
    print(tag, json.dumps(rec), flush=True)


def interleaved(fns: dict, rounds: int, reps: int) -> dict:
    """Mean ms per launch of each function, over ``rounds`` rounds that
    take the functions in turn (``reps`` launches each, CUDA events)."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
        fn()
    per = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            per[k].append(start.elapsed_time(end) / reps)
    return {k: {"mean_ms": sum(v) / len(v), "min_ms": min(v), "max_ms": max(v), "rounds": v}
            for k, v in per.items()}


def kernel_profile(fn) -> dict:
    """Device time of each CUDA kernel (and memset) of one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {
        "device_ms": sum(e.self_device_time_total for e in rows) / 1e3,
        "kernels": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                    for e in sorted(rows, key=lambda e: -e.self_device_time_total)],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("torch_pb_kernels: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    import repro_torch.core as T
    import repro_torch.kernels as K
    from repro_torch.core.pb import bin_ids, starts_from_counts
    from repro_torch.kernels import _lib, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    say("card", {"nvidia-smi": smi, "src": os.path.abspath(args.src), "torch": torch.__version__})
    _lib.load()
    dev = torch.device("cuda")
    hw = T.HardwareModel.h100()
    R, N = args.rounds, args.reps

    def fused_inputs(g):
        n = g.num_nodes
        br = min(max(64, T.compromise_bin_range(n, hw)), n)
        outdeg = T.degrees_from_coo(g, by="src").clamp(min=1).float()
        contrib = (torch.full((n,), 1.0 / n, device=dev) / outdeg)[g.src]
        return n, br, -(-n // br), contrib

    s2 = T.gen_uniform(1 << 22, 8, seed=3, device=dev)
    n2, br2, nb2, contrib2 = fused_inputs(s2)
    keys = bin_ids(s2.dst, br2)
    starts = starts_from_counts(ref.histogram_ref(keys, nb2))[:-1].contiguous()
    shape = {"m": s2.num_edges, "n": n2, "bin_range": br2, "num_bins": nb2}

    def fused2():
        return K.cobra_bin_accumulate(s2.dst, contrib2, n2, br2, nb2)

    def positions2():
        return K.counting_positions(keys, starts, nb2)

    say("profile", {"kernel": "counting_positions", **shape, **kernel_profile(positions2)})
    say("profile", {"kernel": "cobra_bin_accumulate", **shape, **kernel_profile(fused2)})

    def add2():
        return torch.zeros(n2, device=dev).index_add_(0, s2.dst, contrib2)

    say("interleaved", {"at": "S2", **shape, **interleaved(
        {"fused": fused2, "index_add_": add2, "positions": positions2}, R, N)})
    say("interleaved", {"at": "S2", **shape, **interleaved(
        {"histogram": lambda: K.histogram(keys, nb2),
         "bincount": lambda: torch.bincount(keys, minlength=nb2)}, R, N)})

    suite = T.graph_suite("bench", device=dev)
    s1 = {}
    for name in ("KRON", "DBP"):
        g = suite[name]
        n, br, nb, contrib = fused_inputs(g)
        s1[name] = (g, n, br, nb, contrib)
        say("interleaved", {"at": f"S1 {name}", "m": g.num_edges, "n": n, "bin_range": br,
                            "num_bins": nb, **interleaved({
                                "fused": lambda g=g, n=n, br=br, nb=nb, c=contrib:
                                    K.cobra_bin_accumulate(g.dst, c, n, br, nb),
                                "index_add_": lambda g=g, n=n, c=contrib:
                                    torch.zeros(n, device=dev).index_add_(0, g.dst, c)}, R, N)})

    params = inspect.signature(K.cobra_bin_accumulate).parameters
    if "design" in params:
        from repro_torch.kernels.fused import FUSED_DESIGNS

        for tag, (g, n, br, nb, c) in [("S2", (s2, n2, br2, nb2, contrib2))] + [
                (f"S1 {k}", v) for k, v in s1.items()]:
            say("designs", {"kernel": "cobra_bin_accumulate", "at": tag, "m": g.num_edges,
                            "n": n, **interleaved({
                                d: lambda d=d, g=g, n=n, br=br, nb=nb, c=c:
                                    K.cobra_bin_accumulate(g.dst, c, n, br, nb, design=d)
                                for d in FUSED_DESIGNS}, R, N)})
    if "design" in inspect.signature(K.counting_positions).parameters:
        from repro_torch.kernels.binning import POSITIONS_DESIGNS

        say("designs", {"kernel": "counting_positions", "at": "S2", **shape, **interleaved({
            d: lambda d=d: K.counting_positions(keys, starts, nb2, design=d)
            for d in POSITIONS_DESIGNS}, R, N)})
        for d in POSITIONS_DESIGNS:
            say("profile", {"kernel": "counting_positions", "design": d, **shape,
                            **kernel_profile(lambda d=d: K.counting_positions(
                                keys, starts, nb2, design=d))})
    if "design" in params:
        for d in FUSED_DESIGNS:
            say("profile", {"kernel": "cobra_bin_accumulate", "design": d, **shape,
                            **kernel_profile(lambda d=d: K.cobra_bin_accumulate(
                                s2.dst, contrib2, n2, br2, nb2, design=d))})
            g, n, br, nb, c = s1["KRON"]
            say("profile", {"kernel": "cobra_bin_accumulate", "design": d, "at": "S1 KRON",
                            "m": g.num_edges, "n": n, **kernel_profile(
                                lambda d=d: K.cobra_bin_accumulate(g.dst, c, n, br, nb, design=d))})
        # where the two designs cross: uniform streams of m tuples into m / 8
        # indices (fig5's average degree), m from S1's 2^21 to S2's 2^25
        gen = torch.Generator(device=dev).manual_seed(4)
        for lg in range(21, 26):
            m, n = 1 << lg, 1 << (lg - 3)
            idx = torch.randint(0, n, (m,), device=dev, generator=gen, dtype=torch.int32)
            v = torch.rand(m, device=dev, generator=gen)
            say("crossover", {"kernel": "cobra_bin_accumulate", "m": m, "n": n, **interleaved({
                d: lambda d=d, idx=idx, v=v, n=n: K.cobra_bin_accumulate(
                    idx, v, n, 512, -(-n // 512), design=d)
                for d in FUSED_DESIGNS}, R, N)})
    say("card", {"nvidia-smi": smi})


if __name__ == "__main__":
    main()
