#!/usr/bin/env python3
"""Time and trace the port's PB binning kernels on one NVIDIA card.

    python3 scripts/torch_pb_kernels.py [--src DIR] [--base DIR] [--rounds 5] [--reps 20]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``). ``--base`` names another tree's ``src`` (a parent commit
unpacked beside this one): its histogram, positions and COBRA pass are
imported into the same process and timed in the same rounds as this
tree's, as ``base:<name>``, and traced beside them. Every number comes
from the card: CUDA events around ``reps`` back-to-back launches, and
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
- ``histogram``: the histogram against ``torch.bincount`` at every shape
  it is launched at on ``chip_smoke.py``'s paths: the five S1 graphs'
  destinations at 128 bins (``bin_range`` 2049) and 19 bins (the plan's
  final range, 14528), S2's keys at 512 and 289 bins, S3's keys
  (``gen_uniform(32M, 4, seed=3)``, 128M edges) at the 735 and 2,203
  bins of its two COBRA levels, the embedding gradient's zipf ids at
  ``bin_range`` 4096 (13 bins); and 2^25 copies of one key; interleaved
  and traced.
- ``cobra_pass``: the COBRA pass at every level of S2's and S3's H100
  plan (289; 735 and 2,203 bins) with int32 and float32 values, each
  design of the wrapper, interleaved and traced; the second S3 level both
  on raw keys and on the first level's output (what ``cobra_binning``
  gives it); ``cobra_binning``: ``ops.cobra_binning`` (every pass with
  its histogram and bin starts) at S2 and S3, interleaved.
- ``sass`` (with ``--base``): positions' and the fused binning's kernels
  of the two trees compared opcode by opcode (they share the look-back
  core), after every trace.

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
    take the functions in turn (``reps`` launches each, CUDA events), in
    the reverse order every other round (A B, B A, ...)."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
        fn()
    per = {k: [] for k in fns}
    for r in range(rounds):
        for k, fn in list(fns.items())[::-1 if r % 2 else 1]:
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


def import_kernels(src: str):
    """``repro_torch.kernels`` of the tree ``src``, built and loaded. A tree
    imported before is set aside (its functions keep their own modules and
    library), so two trees' kernels can run in one process."""
    for name in [n for n in sys.modules if n == "repro_torch" or n.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(src))
    try:
        import repro_torch.kernels as K

        K._lib.load()
        return K
    finally:
        sys.path.remove(os.path.abspath(src))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--base", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_pb_kernels: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    KB = import_kernels(args.base) if args.base else None
    K = import_kernels(args.src)
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch.core as T
    from repro_torch.core.pb import bin_ids, starts_from_counts
    from repro_torch.kernels import _lib, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    say("card", {"nvidia-smi": smi, "src": os.path.abspath(args.src),
                 "base": args.base and os.path.abspath(args.base), "torch": torch.__version__})

    def with_base(fns: dict, call) -> dict:
        """``fns`` plus, under ``--base``, ``base:<name>`` for each ``call(KB)``."""
        if KB is not None:
            fns[f"base:{call.__name__}"] = lambda: call(KB)
        return fns
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

    def positions(kk):
        return kk.counting_positions(keys, starts, nb2)

    say("interleaved", {"at": "S2", **shape, **interleaved(with_base(
        {"fused": fused2, "index_add_": add2, "positions": positions2}, positions), R, N)})

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
    histogram_and_cobra(K, KB, T, ref, bin_ids, starts_from_counts, with_base, R, N, dev, hw,
                        s2, keys, nb2, suite)
    # last: profiles taken after cuobjdump has run came back empty
    if KB is not None:  # the look-back core's other kernels in the two trees, opcode by opcode
        for name in ("positions_onesweep_kernel", "slab_bin_kernel"):
            ops = [{n[-40:]: [ln.split(";")[0].split("*/")[-1].split()[:1]
                              for ln in body.splitlines() if ln.strip().startswith("/*")]
                    for n, body in mod._lib.kernel_sass(name).items()} for mod in (K, KB)]
            say("sass", {"kernel": name, **{k: {"instructions": len(v),
                                               "base_instructions": len(ops[1].get(k, [])),
                                               "same_opcodes": v == ops[1].get(k)}
                                           for k, v in ops[0].items()}})
    say("card", {"nvidia-smi": smi})


def histogram_and_cobra(K, KB, T, ref, bin_ids, starts_from_counts, with_base, R, N, dev, hw,
                        s2, keys2, nb2, suite) -> None:
    """The ``histogram`` and ``cobra_pass`` lines (module docstring)."""
    import numpy as np
    import torch

    from repro_torch.kernels.binning import cobra_pass_design

    s3 = T.gen_uniform(32_000_000, 4, seed=3, device=dev)
    plans = {tag: T.CobraPlan.from_hardware(g.num_nodes, hw).level_ranges()
             for tag, g in (("S2", s2), ("S3", s3))}
    rng = np.random.default_rng(0)  # benchmarks/embed_grad.py's zipf ids at full scale
    zipf = np.minimum((rng.pareto(1.2, 262_144) * 50).astype(np.int64), 50_303)
    streams = []
    for name, g in suite.items():
        for r in (2049, 14528):  # fig5's S1 bin_range and the plan's final range
            streams.append((f"S1 {name}", bin_ids(g.dst, r), -(-g.num_nodes // r)))
    streams.append(("S2", keys2, nb2))
    r2 = plans["S2"][-1]
    streams.append(("S2", bin_ids(s2.dst, r2), -(-s2.num_nodes // r2)))
    for r in plans["S3"]:
        nb = -(-s3.num_nodes // r)
        streams.append((f"S3 {nb} bins", bin_ids(s3.dst, r), nb))
    streams.append(("zipf ids, bin_range 4096",
                    torch.from_numpy(zipf.astype(np.int32) // 4096).to(dev), 13))
    streams.append(("one key", torch.full((1 << 25,), 7, dtype=torch.int32, device=dev), 512))
    for tag, kk, nb in streams:
        def histogram(mod, kk=kk, nb=nb):
            return mod.histogram(kk, nb)

        rec = {"at": tag, "m": kk.shape[0], "num_bins": nb,
               "bound_ms": (4 * kk.shape[0] + 4 * nb) / 3.35e12 * 1e3}
        say("histogram", {**rec, **interleaved(with_base({
            "histogram": lambda: histogram(K),
            "bincount": lambda kk=kk, nb=nb: torch.bincount(kk, minlength=nb)}, histogram), R, N)})
        say("profile", {"kernel": "histogram", **rec, **kernel_profile(lambda: histogram(K))})
        if KB is not None:
            say("profile", {"kernel": "base:histogram", **rec,
                            **kernel_profile(lambda: histogram(KB))})
    del streams

    gen = torch.Generator(device=dev).manual_seed(5)
    for tag, g in (("S2", s2), ("S3", s3)):
        src, dst = g.src, g.dst
        for level, r in enumerate(plans[tag]):
            nb = -(-g.num_nodes // r)
            inputs = [("raw keys", dst, src)]
            if level > 0:  # what cobra_binning hands this level: the previous one's output
                prev = plans[tag][level - 1]
                pk = bin_ids(dst, prev)
                ps = starts_from_counts(ref.histogram_ref(pk, -(-g.num_nodes // prev)))[:-1]
                inputs.append(("previous level's output", *K.cobra_binning_pass(
                    pk, dst, src, ps.contiguous(), -(-g.num_nodes // prev))))
            for what, idx, val_i in inputs:
                kk = bin_ids(idx, r)
                st = starts_from_counts(ref.histogram_ref(kk, nb))[:-1].contiguous()
                val_f = torch.randn(idx.shape[0], device=dev, generator=gen)
                for val in (val_i, val_f):
                    want = ref.binned_stream_ref(kk, idx, val, nb)
                    got = K.cobra_binning_pass(kk, idx, val, st, nb)
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise SystemExit(f"COBRA pass differs from plain at {tag} {nb} bins")
                    del want, got

                    def cobra_pass(mod, kk=kk, idx=idx, val=val, st=st, nb=nb):
                        return mod.cobra_binning_pass(kk, idx, val, st, nb)

                    fns = {"cobra_pass": lambda: cobra_pass(K)}
                    for d in ("onesweep", "three-phase"):
                        if d != cobra_pass_design(nb):
                            fns[d] = lambda d=d, kk=kk, idx=idx, val=val, st=st, nb=nb: \
                                K.cobra_binning_pass(kk, idx, val, st, nb, design=d)
                    m = idx.shape[0]
                    rec = {"at": tag, "input": what, "m": m, "num_bins": nb, "bin_range": r,
                           "dtype": str(val.dtype), "design": cobra_pass_design(nb),
                           "bound_ms": (20 * m + 4 * nb) / 3.35e12 * 1e3}
                    say("cobra_pass", {**rec, **interleaved(with_base(fns, cobra_pass), R,
                                                             max(2, N // 4))})
                    if val.dtype == torch.int32:
                        say("profile", {"kernel": "cobra_pass", **rec,
                                        **kernel_profile(lambda: cobra_pass(K))})
                        if KB is not None:
                            say("profile", {"kernel": "base:cobra_pass", **rec,
                                            **kernel_profile(lambda: cobra_pass(KB))})
        plan = T.CobraPlan.from_hardware(g.num_nodes, hw)

        def cobra_binning(mod, plan=plan, dst=dst, src=src):
            return mod.ops.cobra_binning(dst, src, plan)

        say("cobra_binning", {"at": tag, "m": g.num_edges, "pass_bins": [
            -(-g.num_nodes // r) for r in plans[tag]], **interleaved(with_base(
                {"cobra_binning": lambda: cobra_binning(K)}, cobra_binning), R, max(2, N // 4))})


if __name__ == "__main__":
    main()
