#!/usr/bin/env python3
"""Time and trace the port's PB binning kernels on one NVIDIA card.

    python3 scripts/torch_pb_kernels.py [--src DIR] [--base DIR] [--rounds 5] [--reps 20]
                                        [--sections binning,binread,rows,flash,fused]
                                        [--fused-variants NAME,...]

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
- ``fused`` (also with ``--sections fused`` alone): the two-pass fused
  accumulate (float32 add) at row 4's S2 PageRank stream, row 4c's (rank
  0's local reduce after phase 16's owner exchange of S2, rebuilt without
  a process group), S2 with half the tuples on one hub, S2 all on one key,
  and row 4d's S3 (``gen_uniform(32M, 4, seed=3)``, 128M tuples into 32M
  indices); interleaved: the kernel, the base tree's, ``index_add_``, the
  variants of ``FUSED_VARIANTS`` (``--fused-variants`` picks some) built
  from this tree's ``fused.cu`` into ``_build/variants/fused/`` and called
  through ctypes, ``plan:slabs_x2`` (slabs twice the plan's, chunks of
  twice their mean) and ``plan:slabs_x2_chunk1.25`` (chunks of 1.25
  means); each
  checked against the plain version first (a variant that refuses a shape
  is listed in ``fused_refused``). Then ``profile`` (device ms by kernel
  of one call, both trees), ``fused_phases`` at S2 and S3 (``%globaltimer``
  stamps at the end of each phase of the binning and reduce loops, summed
  over blocks, from a stamped copy), ``fused_onchip`` (the on-chip
  variant's barrier wait and run time a block; not run on the skewed
  streams, where one block owns the hot slab), ``fused_sass`` (bulk
  copies, MATCH and every atomic opcode of the binning and reduce kernels
  of both trees) and ``fused_sass_variants`` (the same for every
  variant's float32-add reduce).
- ``sass`` (with ``--base``): positions' onesweep kernel of the two
  trees compared opcode by opcode (``pb_onesweep.cuh`` is shared), after
  every trace.

``--sections`` picks among ``binning`` (every line above), ``binread``,
``rows`` (default: those three), ``fused`` (the ``fused`` lines alone) and
``flash``:

- ``binread``: Bin-Read at ``benchmarks/embed_grad.py``'s full shapes
  (T 262,144 rows of d 256, ``bin_range`` 4096, 13 bins) on its zipf ids
  (L 260,808) and uniform ids (L 21,568), float32 and bfloat16, laid out
  as ``ops.pb_scatter_add_full`` lays them out. Interleaved: the kernel,
  the same kernel on the same rows sorted by index within each bin
  (``sorted``), ``index_add_`` of the compact stream into the same
  (B * bin_range, d) output (``compact_index_add_``), the variants below
  and, with ``--base``, the base tree's kernel; each checked against the
  plain version first. Then a ``torch.profiler`` breakdown of one call
  (kernel, ``bf16_store_kernel``, the zeroing memset) in each tree, and
  ``ops.pb_scatter_add_full`` at the zipf shape in both trees.
  Variants, built from this tree's ``binread.cu`` when it has a
  ``kBrTile`` constant: tiles of 2048 and 8192 positions, blocks of 1024
  threads, and 8 or 16 rows gathered before they are folded (4 kept).
- ``rows``: the row-block reduce (add) at every fig9 shape: the KRON,
  EURO and HBUBL graphs of the bench suite (m 2,097,152, 1,046,528 and
  1,568,770 edges, n 262,144, destination-sorted) at F in {1, 8, 32,
  128}; S2 (``gen_uniform(2^22, 8, seed=3)``) at F = 64 (PERF.md row 5);
  row 5d's stream, rank 0's local rows after the owner exchange of S2's
  first 2^24 tuples over four ranks (``chip_smoke.py`` phase 16),
  rebuilt without a process group; the embedding backwards' token
  streams (``SyntheticLM``): 5b (qwen2-1.5b, 16,384 x 1536 into
  152,064), 5f (the vlm, 4,096 x 4096 into 128,256) and 5g (a 2x2
  rank's vocabulary half, 4,096 x 1536 into 76,032, the ids outside it
  -1); zipf token ids at 5b's shape; and 5c (the MoE combine, 972
  tokens x top-8 in token order, 4096 bfloat16 columns into 972; 5e has
  its shape). Interleaved: the
  kernel, ``torch.zeros(n, F).index_add_(0, idx, val)`` over the kept
  rows, the base tree's kernel, and, where the tile walk runs, variants
  built from this tree's ``pb_rows.cuh``: ``unroll8`` (8 rows gathered
  a lane), ``tile1024`` (1,024-row tiles) and ``nosort`` (tiles never
  sorted; streams without dropped rows only), and where the narrow walk
  runs, ``tile_all`` (the tile walk at F <= 16 too). Each is checked
  against the plain version first; min, max and int32 are checked, not
  timed, at the float32 shapes but 5d. A
  ``torch.profiler`` breakdown at S1 KRON F = 1 and 8, S2, 5d and 5b in
  each tree, and ``enqueue`` (the host time of one call) at KRON. With
  ``--base``: the narrow walk's SASS (``rows_seg_kernel``) in both
  trees, opcode by opcode; the REDG.E.ADD.F32x4 count of every tile-walk
  instantiation.
- ``flash``: the bfloat16 flash-attention forward at the shapes of
  PERF.md's rows 8-8g (``chip_smoke.py``'s ``flash_row`` shapes: qwen2's
  S 4096 prefill, qwen3-moe's 972-token one, zamba2's 453 at head_dim 80,
  the vlm's cross prefill against 1601 image tokens, Whisper's encoder, a
  2x2 rank's heads at S 2048 and at a 450-token serve prefill). Each
  tree's kernel and each variant (``FLASH_VARIANTS``: 128-key tiles; the
  producer a warpgroup, without and with ``setmaxnreg``; built from this
  tree's ``flashattn.cu`` into ``_build/variants/flash/`` and called
  through ctypes, without the wrapper's host work) is checked against the
  plain version first (one bfloat16 step); then interleaved: the kernel,
  the base tree's, the variants, and ``scaled_dot_product_attention``
  (``enable_gqa=True``, the yardstick);
  per row the ``torch.profiler`` device ms of one call in each tree, the
  host ms a call takes to enqueue, and TFLOP/s on the device time, useful
  (``flash_flops``) and executed (x 1.5: P V runs twice, hi and lo). Then
  ``flash_build``: the registers and spills nvcc gave each bf16
  instantiation of each tree and variant, and the kernel's dynamic
  shared memory (its ``Geo``);
  ``flash_host``: the host ms a call takes at a launch-bound shape (B 1,
  2 heads, 64 positions), bfloat16 and float32, hd 80 and 128, in each
  tree, in rounds that alternate.

Variants go to ``_build/variants/`` beside the kernels' own build, one
``nvcc`` each, all started together. The card's name and power limit
(``nvidia-smi``) come first. Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import shutil
import subprocess
import sys
import time

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


def enqueue_ms(fns: dict, calls: int = 200) -> dict:
    """Host milliseconds a call of each function takes to enqueue its work
    (host clock over ``calls`` calls, no synchronise between them): where
    it exceeds the device time, an event-timed loop measures the host."""
    import torch

    out = {}
    for k, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        out[k] = (time.perf_counter() - t) / calls * 1e3
        torch.cuda.synchronize()
    return out


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
    ap.add_argument("--sections", default="binning,binread,rows")
    ap.add_argument("--fused-variants", default=None,
                    help="comma-separated names of FUSED_VARIANTS to build (default: all)")
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

    sections = set(args.sections.split(","))
    if sections & {"binning", "fused"}:
        fused_section(K, KB, T, ref, R, N, dev, hw, smi, args.fused_variants)
    if "binning" in sections:
        binning_section(K, KB, T, ref, bin_ids, starts_from_counts, with_base, R, N, dev, hw)
    if "binread" in sections:
        binread_section(K, KB, ref, bin_ids, starts_from_counts, with_base, R, N, dev, _lib,
                        args.src)
    if "rows" in sections:
        rows_section(K, KB, T, ref, with_base, R, N, dev, _lib, args.src)
    if "flash" in sections:
        flash_section(K, KB, R, N, dev, smi)
    # last: profiles taken after cuobjdump has run came back empty
    if KB is not None:  # kernels that share a changed header, in the two trees, opcode by opcode
        names = (["positions_onesweep_kernel"] if "binning" in sections
                 else []) + (["rows_seg_kernel"] if "rows" in sections else [])
        for name in names:
            ops = [{n[-48:]: [ln.split(";")[0].split("*/")[-1].split()[:1]
                              for ln in body.splitlines() if ln.strip().startswith("/*")]
                    for n, body in mod._lib.kernel_sass(name).items()} for mod in (K, KB)]
            say("sass", {"kernel": name, **{k: {"instructions": len(v),
                                               "base_instructions": len(ops[1].get(k, [])),
                                               "same_opcodes": v == ops[1].get(k)}
                                           for k, v in ops[0].items()}})
    if "rows" in sections:  # the tile walk's float4 reductions
        say("sass", {"kernel": "rows_tile_kernel", "REDG.E.ADD.F32x4": {
            n[-48:]: body.count("REDG.E.ADD.F32x4")
            for n, body in K._lib.kernel_sass("rows_tile_kernel").items()}})
    say("card", {"nvidia-smi": smi})


def binning_section(K, KB, T, ref, bin_ids, starts_from_counts, with_base, R, N, dev, hw) -> None:
    """The positions, fused, histogram and COBRA-pass lines (module docstring)."""
    import torch

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
        fns = {"fused": lambda g=g, n=n, br=br, nb=nb, c=contrib:
                   K.cobra_bin_accumulate(g.dst, c, n, br, nb),
               "index_add_": lambda g=g, n=n, c=contrib:
                   torch.zeros(n, device=dev).index_add_(0, g.dst, c)}
        if KB is not None:
            fns["base:fused"] = lambda g=g, n=n, br=br, nb=nb, c=contrib: \
                KB.cobra_bin_accumulate(g.dst, c, n, br, nb)
        say("interleaved", {"at": f"S1 {name}", "m": g.num_edges, "n": n, "bin_range": br,
                            "num_bins": nb, **interleaved(fns, R, N)})

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


EMB_T, EMB_VOCAB, EMB_D, EMB_BIN_RANGE = 262_144, 50_304, 256, 4096  # benchmarks/embed_grad.py
F_GRID = (1, 8, 32, 128)  # benchmarks/fig9_spmm.py
SHARD_ROWS_M = 1 << 24  # chip_smoke.py phase 16: the row-valued stream's first tuples
# variants of the tile walk, built from this tree's pb_rows.cuh
ROW_VARIANTS = {
    "unroll8": [("pb_rows.cuh", "constexpr int kTileUnroll = 4;",
                 "constexpr int kTileUnroll = 8;")],
    "tile1024": [("pb_rows.cuh", "constexpr int kTileItems = 2;",
                  "constexpr int kTileItems = 4;")],
    "nosort": [("pb_rows.cuh", "if (!__syncthreads_and(ordered)) {",
                "if (!__syncthreads_and(ordered) && false) {")],
    # the narrow walk's rows (F <= 16) through the tile walk too
    "tile_all": [("pb_rows.cuh", "  if (lpr <= kSegMaxLpr)\n    return vec4 ? launch_seg_lpr",
                  "  if (false)\n    return vec4 ? launch_seg_lpr")],
}


def build_variants(_lib, csrc: str, entry: str, variants: dict, root: str) -> dict:
    """Compile each variant of ``csrc/entry`` (with every header of
    ``csrc``) into ``root/<name>/lib.so``, one nvcc each, all started
    together, nvcc's ``-Xptxas -v`` output in ``root/<name>/build.log``.
    ``variants``: name -> [(file, old, new)] text patches; a patch whose
    ``old`` text is missing stops the script. Returns name -> ctypes
    library."""
    procs = {}
    for name, patches in variants.items():
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in os.listdir(csrc):
            if f == entry or f.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, f), d)
        for f, old, new in patches:
            with open(os.path.join(d, f)) as fh:
                text = fh.read()
            if old not in text:
                raise SystemExit(f"torch_pb_kernels: variant {name}: {f} has no {old!r}")
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text.replace(old, new))
        lib = os.path.join(d, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [_lib.nvcc_path(), *_lib.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas", "-v", "-o", lib, os.path.join(d, entry)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        with open(os.path.join(root, name, "build.log"), "w") as fh:
            fh.write(log)
        out[name] = ctypes.CDLL(lib)
    return out



# variants of csrc/fused.cu's two-pass design, built from this tree's source.
# The float32 add in shared memory: the shipped design adds by two exchanges
# (exch_add); ``cas`` by atomicAdd(float*), the compare-and-swap loop;
# ``cluster_red`` by red.shared::cluster.add.f32 on the block's own address
# (ptxas keeps a compare-and-swap loop for a local address beside the native
# remote add); two sorts that need no atomic on the accumulator, at 512
# threads, where their queues fit beside S2's slabs: per-thread queues
# (``queues``: thread q owns the entries q + 512 r, all in its own bank; a
# counting sort of the stage by the offset's low bits, then plain loads and
# stores; a queue takes 16 tuples a round; ``queues_hot``: a split slab's
# items by exch_add instead) and owner warps (``owner_warps``: warp w owns a
# sixteenth of the slab, fed by a split of the stage; __match_any_sync finds
# the lanes of one offset); ``onchip`` (fused_onchip_variant.cuh); then
# other block sizes, stages and ring depths.
_COMBINE_HUB = """\
// In a hot item (a hub's slab) a float add first sums, in each warp, the
// lanes of lane 0's offset and then those of the next offset left, each
// into one lane (butterfly sums): a hub costs its queue a tuple a warp.
template <typename V>
__device__ __forceinline__ void combine_hub(int& o, V& x) {
  const int lane = threadIdx.x & 31;
  bool done = o < 0;
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    const unsigned live = __ballot_sync(PB_FULL_MASK, !done);
    if (!live) return;
    const int lead = __ffs(live) - 1;
    const int c = __shfl_sync(PB_FULL_MASK, o, lead);
    const bool mine = !done && o == c;
    V y = mine ? x : V(0);
#pragma unroll
    for (int d = 16; d; d >>= 1) y += __shfl_xor_sync(PB_FULL_MASK, y, d);
    if (mine) {
      done = true;
      if (lane == lead) x = y;
      else o = -1;
    }
  }
}

"""
_Q_COMMON = [
    ("fused.cu", "constexpr int kRedThreads = 1024;", "constexpr int kRedThreads = 512;"),
    ("fused.cu", "#include <limits>\n", "#include <limits>\n#include <type_traits>\n"),
    ("fused.cu", "constexpr int kRedStages = 3;\n",
     "constexpr int kRedStages = 3;\nconstexpr int kQueueCap = 16;\n"),
    ("fused.cu", "  return (size_t)kRedStages * kRedStageBytes + (sizeof(T) << shift);\n",
     "  return (size_t)kRedStages * kRedStageBytes + (sizeof(T) << shift) +\n"
     "         (std::is_same<T, float>::value ? (size_t)kQueueCap * kRedThreads * (2 + sizeof(T))"
     " : 0);\n"),
    ("fused.cu", "  T* acc = reinterpret_cast<T*>(sh_raw + kRedStages * kRedStageBytes);\n",
     "  T* acc = reinterpret_cast<T*>(sh_raw + kRedStages * kRedStageBytes);\n"
     "  unsigned short* q_off = reinterpret_cast<unsigned short*>(acc + (1 << shift));\n"
     "  T* q_val = reinterpret_cast<T*>(q_off + kQueueCap * kRedThreads);\n"
     "  __shared__ int s_qlen[kRedThreads];\n  s_qlen[threadIdx.x] = 0;\n"
     "  constexpr bool kOwn = OP == kAdd && std::is_same<T, float>::value;\n"),
    ("fused.cu", "// Persistent blocks take work items by ticket.",
     _COMBINE_HUB + "// Persistent blocks take work items by ticket."),
]
_QUEUE_BLOCK = """\
        // thread q owns the slab's entries q + r kRedThreads (all in its own
        // bank): each tuple goes to its owner's queue (a counting sort by the
        // offset's low bits) and each thread adds its queue's tuples with
        // plain loads and stores, which no other thread makes to those
        // entries. A queue takes kQueueCap tuples a round; the rest wait
        // for the next round.
        int ko[kRedItems];
        T kv[kRedItems];
        unsigned pend = 0;
#pragma unroll
        for (int i = 0; i < kRedItems; ++i) {
          const int j = i * kRedThreads + threadIdx.x;
          ko[i] = j < cnt ? (int)s_off[j] : -1;
          kv[i] = j < cnt ? s_val[j] : T(0);
          if (hot) combine_hub(ko[i], kv[i]);
          if (ko[i] >= 0) pend |= 1u << i;
        }
        for (int round = 0;; ++round) {
#pragma unroll
          for (int i = 0; i < kRedItems; ++i)
            if (pend >> i & 1) {
              const int q = ko[i] & (kRedThreads - 1);
              const int r = atomicAdd(&s_qlen[q], 1);
              if (r < kQueueCap) {
                q_off[r * kRedThreads + q] = (unsigned short)ko[i];
                q_val[r * kRedThreads + q] = kv[i];
                pend &= ~(1u << i);
              }
            }
          __syncthreads();  // the queues are full, and the stage is read: refill it
          if (round == 0 && threadIdx.x == 0 && k + kRedStages < stages) issue(k + kRedStages);
          const int ql = min(s_qlen[threadIdx.x], kQueueCap);
          s_qlen[threadIdx.x] = 0;
          for (int r = 0; r < ql; ++r) {
            const int o = q_off[r * kRedThreads + threadIdx.x];
            acc[o] += q_val[r * kRedThreads + threadIdx.x];
          }
          if (!__syncthreads_or(pend != 0)) break;
        }
"""
_OWNER_BLOCK = """\
        __shared__ int s_cnt[16], s_bstart[17];
        const int warp = threadIdx.x >> 5, osh = shift - 4;
        if (u0 + k == 0) {
          if (threadIdx.x < 16) s_cnt[threadIdx.x] = 0;
          __syncthreads();
        }
        int ko[kRedItems];
        T kv[kRedItems];
        int ks[kRedItems];
#pragma unroll
        for (int i = 0; i < kRedItems; ++i) {
          const int j = i * kRedThreads + threadIdx.x;
          int o = j < cnt ? (int)s_off[j] : -1;
          T x = j < cnt ? s_val[j] : T(0);
          if (hot) combine_hub(o, x);
          const int ow = o >= 0 ? o >> osh : 16;
          unsigned peers = PB_FULL_MASK;
#pragma unroll
          for (int bit = 0; bit < 5; ++bit) {
            const bool set = (ow >> bit) & 1;
            const unsigned bal = __ballot_sync(PB_FULL_MASK, set);
            peers &= set ? bal : ~bal;
          }
          const int first = __ffs(peers) - 1;
          int base = 0;
          if (lane == first && ow < 16) base = atomicAdd(&s_cnt[ow], __popc(peers));
          ko[i] = o;
          kv[i] = x;
          ks[i] = __shfl_sync(PB_FULL_MASK, base, first) + __popc(peers & pb_lanemask_lt());
        }
        __syncthreads();
        if (threadIdx.x == 0 && k + kRedStages < stages) issue(k + kRedStages);
        if (warp == 0) {
          const int cn = lane < 16 ? s_cnt[lane] : 0;
          int x = cn;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(PB_FULL_MASK, x, d);
            if (lane >= d) x += y;
          }
          if (lane <= 16) s_bstart[lane] = x - cn;
          if (lane < 16) s_cnt[lane] = 0;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kRedItems; ++i)
          if (ko[i] >= 0) {
            const int p = s_bstart[ko[i] >> osh] + ks[i];
            q_off[p] = (unsigned short)ko[i];
            q_val[p] = kv[i];
          }
        __syncthreads();
        const int g1 = s_bstart[warp + 1];
        for (int g = s_bstart[warp]; g < g1; g += 32) {
          const int j = g + lane;
          const int o = j < g1 ? (int)q_off[j] : -1 - lane;
          const unsigned peers = __match_any_sync(PB_FULL_MASK, o);
          if (j < g1 && (peers & pb_lanemask_lt()) == 0) {
            T y = q_val[j];
            for (unsigned r = peers & (peers - 1); r; r &= r - 1) y += q_val[g + __ffs(r) - 1];
            acc[o] += y;
          }
          __syncwarp();
        }
"""


def _float_add_block(block: str, text: str) -> tuple:
    """The patch that puts ``block`` before the shipped per-stage apply as
    the float add's branch."""
    a = text.index("#pragma unroll\n      for (int i = 0; i < kRedItems; ++i) {\n        const int j")
    end = "      if (threadIdx.x == 0 && k + kRedStages < stages) issue(k + kRedStages);\n"
    b = text.index(end, a) + len(end)
    old = text[a:b]
    shifted = "".join("  " + ln if ln.strip() else ln for ln in old.splitlines(True))
    return ("fused.cu", old, "      if constexpr (kOwn) {\n" + block + "      } else {\n" + shifted
            + "      }\n")


_ONCHIP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fused_onchip_variant.cuh")
FUSED_VARIANTS = {
    # the float add through atomicAdd(float*), the compare-and-swap loop
    "cas": [("fused.cu", "  if constexpr (OP == kAdd && std::is_same<T, float>::value)\n    exch_add",
             "  if constexpr (false)\n    exch_add")],
    # the distributed-shared-memory reduction on the block's own address
    "cluster_red": [("fused.cu", "    exch_add(p, v);\n", "    asm volatile(\"red.shared::cluster"
                     ".add.f32 [%0], %1;\\n\" ::\"r\"(smem_u32(p)), \"f\"(v) : \"memory\");\n")],
    "queues": _Q_COMMON + [("queues", None, None)],
    # the queues outside a split slab's items only: a hub's goes by exch_add
    "queues_hot": _Q_COMMON + [("queues", None, None),
                               ("fused.cu", "      if constexpr (kOwn) {\n",
                                "      if (kOwn && !hot) {\n")],
    "owner_warps": _Q_COMMON + [("owner_warps", None, None)],
    # item 5 of the design: every slab on chip for the whole call, the
    # stream binned in chunks that stay in the L2 (fused_onchip_variant.cuh)
    "onchip": [("fused.cu", "}  // namespace\n\n// Bytes of scratch",
                open(_ONCHIP).read() + "}  // namespace\n\n// Bytes of scratch"),
               ("fused.cu", "  return (long long)layout_for(m, (int)slabs).total;",
                "  const size_t a = layout_for(m, (int)slabs).total, b = onchip_scratch(m, (int)slabs);\n"
                "  return (long long)(a > b ? a : b);"),
               ("fused.cu", "  if (design == 1)\n    return two_pass(",
                "  if (design == 1)\n    return onchip(")],
    # no warp combine outside a split slab's items
    "nocombine": [("fused.cu", "        if (__popc(__ballot_sync(PB_FULL_MASK, mine)) > 1) {",
                   "        if (__popc(__ballot_sync(PB_FULL_MASK, mine)) > 1 && hot) {")],
    "bin_stages3": [("fused.cu", "constexpr int kBinStages = 2;", "constexpr int kBinStages = 3;")],
    "red_stages2": [("fused.cu", "constexpr int kRedStages = 3;", "constexpr int kRedStages = 2;")],
    "red_threads512": [("fused.cu", "constexpr int kRedThreads = 1024;",
                        "constexpr int kRedThreads = 512;")],
    "red_items2": [("fused.cu", "constexpr int kRedItems = 4;", "constexpr int kRedItems = 2;")],
}

# %globaltimer stamps at the end of each phase of the binning and reduce
# kernels' loops (thread 0 of every block; summed over blocks and tiles or
# stages): (anchor, phase index) after which a stamp goes
_PHASES_BIN = [
    ("    if (tile >= tiles) break;  // the ring's later tiles are higher still\n", 0),
    ("    __syncthreads();  // the tile's slab counts are zero\n", 1),
    ("      rank[j] = slab_atomic(s_tot, (unsigned)id[j] < (unsigned)n ? id[j] >> shift : B, B);\n"
     "    __syncthreads();\n", 2),
    ("    const int staged = os::block_exclusive_scan(s_cur, B, s_warp);\n", 3),
    ("      if (b < B) s_tot[b] = s_base[b] + claim[r] - first[r];\n    }\n    __syncthreads();\n", 4),
    ("    __syncthreads();  // the stage is free\n", 5),
]
PHASE_NAMES = {0: "bin: wait for the stage", 1: "bin: load, zero", 2: "bin: count",
               3: "bin: claim, scan", 4: "bin: stage", 5: "bin: write out",
               8: "reduce: wait for the stage", 9: "reduce: apply"}
_PHASES_RED = [
    ("      bar_wait(smem_u32(&s_full[slot]), ((u0 + k) / kRedStages) & 1);\n", 8),
    ("      __syncthreads();  // the stage is read: refill it\n", 9),
]


def fused_variant_patches(csrc: str) -> dict:
    """FUSED_VARIANTS with the float add's blocks placed in ``csrc/fused.cu``'s
    per-stage apply, plus ``phases``: the stamped copy (``fused_phases``)."""
    with open(os.path.join(csrc, "fused.cu")) as fh:
        text = fh.read()
    blocks = {"queues": _QUEUE_BLOCK, "owner_warps": _OWNER_BLOCK}
    out = {k: [_float_add_block(blocks[f], text) if old is None else (f, old, new)
               for f, old, new in v] for k, v in FUSED_VARIANTS.items()}
    stamp = ("if (threadIdx.x == 0) {{ const unsigned long long now_ = globaltimer(); "
             "atomicAdd(&pb_phase_ns[{k}], now_ - last_); last_ = now_; }}\n")
    phases = [("fused.cu", "__global__ void __launch_bounds__(kCountThreads)\n",
               "__device__ unsigned long long pb_phase_ns[16];\n\n"
               "__global__ void __launch_bounds__(kCountThreads)\n"),
              ("fused.cu", "  const int mask = (1 << shift) - 1;\n  for (int use = 0;; ++use) {\n",
               "  const int mask = (1 << shift) - 1;\n  unsigned long long last_ = globaltimer();\n"
               "  for (int use = 0;; ++use) {\n"),
              ("fused.cu", "  int used = 0;  // ring stages this block has consumed\n",
               "  int used = 0;  // ring stages this block has consumed\n"
               "  unsigned long long last_ = globaltimer();\n"),
              ("fused.cu", "// Bytes of scratch the two-pass design needs",
               "extern \"C\" int pb_fused_phases(unsigned long long* host) {\n"
               "  cudaMemcpyFromSymbol(host, pb_phase_ns, sizeof(pb_phase_ns));\n"
               "  const unsigned long long zero[16] = {};\n"
               "  cudaMemcpyToSymbol(pb_phase_ns, zero, sizeof(zero));\n"
               "  return (int)cudaGetLastError();\n}\n\n// Bytes of scratch the two-pass design needs")]
    phases += [("fused.cu", anchor, anchor + stamp.format(k=k)) for anchor, k in
               _PHASES_BIN + _PHASES_RED]
    phases.append(("fused.cu", "    if (threadIdx.x == 0) fill(use + kBinStages);\n",
                   "    if (threadIdx.x == 0) fill(use + kBinStages);\n    if (threadIdx.x == 0) "
                   "atomicAdd(&pb_phase_ns[15], 1ull);\n"))
    out["phases"] = phases
    return out


def _sass_of(_lib, lib_path: str, name_part: str) -> dict:
    """``cuobjdump -sass`` of one built library: mangled name -> SASS of
    every kernel whose name holds ``name_part``."""
    tool = os.path.join(os.path.dirname(_lib.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    return {name.strip(): body for name, _, body in
            (b.partition("\n") for b in text.split("Function : ")[1:]) if name_part in name}


def _sass_counts(body: str) -> dict:
    """Bulk copies, MATCH, and every atomic or reduction opcode with its
    modifiers (ATOMS.CAS is the float add's compare-and-swap loop)."""
    ops = [ln.split(";")[0].split("*/")[-1].split() for ln in body.splitlines() if "*/" in ln]
    ops = [o[1] if o and o[0].startswith("@") and len(o) > 1 else (o[0] if o else "") for o in ops]
    out = {k: sum(o.startswith(k) for o in ops) for k in ("UBLKCP", "MATCH", "ATOMS.CAS")}
    for o in ops:
        if o.startswith(("ATOM", "RED")):
            out[o] = out.get(o, 0) + 1
    return out


def _fused_call(lib, _lib, idx, val, n, op, sms, shift_add=0, chunk_of_mean=2.0):
    """What ``cobra_bin_accumulate`` does in the two-pass design, with a
    variant's library, in slabs ``2^shift_add`` times the plan's, a slab
    cut into chunks of ``chunk_of_mean`` times its mean count (the plan:
    2)."""
    import torch

    from repro_torch.kernels.fused import CHUNK_MIN, _DTYPE_CODE, _OP_CODE, fused_plan

    m = idx.shape[0]
    shift, slabs, chunk = fused_plan(m, n, sms)
    if shift_add:
        shift += shift_add
        chunk = max(int(chunk_of_mean * -(-m // -(-n // (1 << shift)))), CHUNK_MIN)
    out = torch.empty(n, dtype=val.dtype, device=val.device)
    scratch = torch.empty(lib.pb_fused_scratch(m, n, shift), dtype=torch.uint8, device=val.device)
    _lib.check(lib.pb_fused_accumulate(
        idx.data_ptr(), val.data_ptr(), m, out.data_ptr(), n, 512, -(-n // 512), _OP_CODE[op],
        _DTYPE_CODE[val.dtype], 1, shift, chunk, scratch.data_ptr(), _lib.stream(idx)),
        "fused variant")
    return out


def _rank_local_stream(T, s2, vals, dev, world=4):
    """Row 4c's stream: what rank 0 of ``world`` reduces after the owner
    exchange of S2's PageRank stream (``chip_smoke.py`` phase 16), rebuilt
    without a process group: each source rank's block of tuples of [0, r)
    in source order, padded to the capacity with index r - 1 and value 0."""
    import torch

    from repro_torch.core import distributed_pb as dpb

    n2, m2 = s2.num_nodes, s2.num_edges
    r = dpb.shard_range_for(n2, world)
    cap = dpb.estimate_capacity(s2.dst, out_size=n2, n_dev=world)
    blk = -(-m2 // world)
    parts, vparts = [], []
    for j in range(world):
        b, v = s2.dst[j * blk:(j + 1) * blk], vals[j * blk:(j + 1) * blk]
        keep = b < r
        own, ov = b[keep][:cap], v[keep][:cap]
        pad = cap - own.shape[0]
        parts.append(torch.cat([own, torch.full((pad,), r - 1, dtype=own.dtype, device=dev)]))
        vparts.append(torch.cat([ov, torch.zeros(pad, device=dev)]))
    return torch.cat(parts), torch.cat(vparts), r


def fused_section(K, KB, T, ref, R, N, dev, hw, smi, only=None) -> None:
    """The ``fused`` lines (module docstring); ``only``: the variants to
    build, comma-separated (default: every one)."""
    import torch

    csrc = str(K._lib.CSRC)
    patches = fused_variant_patches(csrc)
    if only is not None:
        keep = set(only.split(",")) | {"phases"}
        patches = {k: v for k, v in patches.items() if k in keep}
    libs = build_variants(K._lib, csrc, "fused.cu", patches,
                          os.path.join(str(K._lib.BUILD_ROOT), "variants", "fused"))
    for lib in libs.values():
        for name in ("pb_fused_accumulate", "pb_fused_scratch"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = K._lib.SIGNATURES[name]
    phase_lib = libs.pop("phases")
    phase_lib.pb_fused_phases.argtypes = [ctypes.c_void_p]
    phase_lib.pb_fused_phases.restype = ctypes.c_int
    if "onchip" in libs:
        libs["onchip"].pb_fused_onchip_stats.argtypes = [ctypes.c_void_p]
        libs["onchip"].pb_fused_onchip_stats.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    def inputs(g):
        n = g.num_nodes
        outdeg = T.degrees_from_coo(g, by="src").clamp(min=1).float()
        return (torch.full((n,), 1.0 / n, device=dev) / outdeg)[g.src]

    s2 = T.gen_uniform(1 << 22, 8, seed=3, device=dev)
    c2 = inputs(s2)
    li, lv, r2 = _rank_local_stream(T, s2, c2, dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    hub = s2.dst.clone()
    hub[torch.rand(hub.shape[0], device=dev, generator=gen) < 0.5] = 12_345
    streams = [("4 (S2)", s2.dst, c2, s2.num_nodes), ("4c (a rank's local reduce)", li, lv, r2),
               ("S2 hub", hub, torch.randn(hub.shape[0], device=dev, generator=gen), s2.num_nodes),
               ("S2 one key", torch.full_like(s2.dst, (1 << 22) // 3 + 5),
                torch.randn(hub.shape[0], device=dev, generator=gen), s2.num_nodes)]
    del hub
    for at, idx, val, n in streams + [("4d (S3)", None, None, None)]:
        if idx is None:  # S3 last: the others' tensors are freed first
            del streams, s2, c2, li, lv
            torch.cuda.empty_cache()
            s3 = T.gen_uniform(32_000_000, 4, seed=3, device=dev)
            idx, val, n = s3.dst, inputs(s3), s3.num_nodes
            del s3
        m = idx.shape[0]
        br = min(max(64, T.compromise_bin_range(n, hw)), n)
        nb = -(-n // br)

        def fused(mod, idx=idx, val=val, n=n, br=br, nb=nb):
            return mod.cobra_bin_accumulate(idx, val, n, br, nb)

        fns = {"fused": lambda: fused(K)}
        if KB is not None:
            fns["base:fused"] = lambda: fused(KB)
        fns["index_add_"] = lambda idx=idx, val=val, n=n: torch.zeros(
            n, device=dev).index_add_(0, idx, val)
        fns.update({f"variant:{k}": (lambda lib=lib, idx=idx, val=val, n=n: _fused_call(
            lib, K._lib, idx, val, n, "add", sms)) for k, lib in libs.items()
            if not (k == "onchip" and at.startswith(("S2 hub", "S2 one key")))})
        if K.fused.fused_plan(m, n, sms)[0] < 15:  # slabs twice the plan's
            fns["plan:slabs_x2"] = lambda idx=idx, val=val, n=n: _fused_call(
                K._lib.load(), K._lib, idx, val, n, "add", sms, shift_add=1)
            # the same with chunks of 1.25 means: a hot slab in as many items as the plan's
            fns["plan:slabs_x2_chunk1.25"] = lambda idx=idx, val=val, n=n: _fused_call(
                K._lib.load(), K._lib, idx, val, n, "add", sms, shift_add=1, chunk_of_mean=1.25)
        want = ref.scatter_reduce_ref(idx, val, n)
        scale = ref.scatter_reduce_ref(idx, val.abs(), n)
        refused = {}
        for k, fn in list(fns.items()):
            try:
                got = fn()
            except RuntimeError as e:  # a variant whose shared memory does not fit this plan
                refused[k] = str(e)
                del fns[k]
                continue
            if not bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all()):
                raise SystemExit(f"fused {k} differs from plain at {at}")
        if refused:
            say("fused_refused", {"at": at, **refused})
        del want, scale
        rec = {"at": at, "m": m, "n": n, "design": K.fused.fused_design(m, n),
               "bound_ms": (8 * m + 4 * n) / 3.35e12 * 1e3,
               "design_floor_ms": (24 * m + 4 * n) / 3.35e12 * 1e3, "card": smi}
        say("fused", {**rec, **interleaved(fns, R, max(2, N // 4) if m > 1 << 26 else N)})
        for tree, mod in (("kernel", K), ("base", KB)):
            if mod is not None:
                say("profile", {"kernel": f"{tree}:cobra_bin_accumulate", **rec,
                                **kernel_profile(lambda mod=mod: fused(mod))})
        if "variant:onchip" in fns:  # its barriers' cost
            oc = (ctypes.c_ulonglong * 4)()
            libs["onchip"].pb_fused_onchip_stats(oc)  # zero
            _fused_call(libs["onchip"], K._lib, idx, val, n, "add", sms)
            torch.cuda.synchronize()
            libs["onchip"].pb_fused_onchip_stats(oc)
            say("fused_onchip", {**rec, "blocks": sms, "chunks_per_block": oc[2] / sms,
                                 "barrier_wait_ms_per_block": oc[0] / 1e6 / sms,
                                 "kernel_ms_per_block": oc[1] / 1e6 / sms,
                                 **kernel_profile(lambda: _fused_call(
                                     libs["onchip"], K._lib, idx, val, n, "add", sms))})
        if at.startswith(("4 ", "4d")):
            ns = (ctypes.c_ulonglong * 16)()
            phase_lib.pb_fused_phases(ns)  # zero
            _fused_call(phase_lib, K._lib, idx, val, n, "add", sms)
            torch.cuda.synchronize()
            phase_lib.pb_fused_phases(ns)
            tiles = max(1, ns[15])
            say("fused_phases", {**rec, "tiles": int(ns[15]), "ms_summed_over_blocks": {
                PHASE_NAMES[k]: ns[k] / 1e6 for k in PHASE_NAMES},
                "bin_us_per_tile": {PHASE_NAMES[k]: ns[k] / 1e3 / tiles for k in range(6)}})
        del fns
        torch.cuda.empty_cache()
    # last: profiles taken after cuobjdump has run came back empty
    for name in ("slab_bin_kernel", "slab_reduce_kernel"):  # bulk copies, and the CAS loop
        say("fused_sass", {"kernel": name, "card": smi, **{
            tree: {n[-48:]: _sass_counts(body) for n, body in mod._lib.kernel_sass(name).items()}
            for tree, mod in (("kernel", K), ("base", KB)) if mod is not None}})
    # the float32 add's reduce in every variant: its atomics, by SASS opcode
    root = os.path.join(str(K._lib.BUILD_ROOT), "variants", "fused")
    say("fused_sass_variants", {"card": smi, **{
        name: {n[-48:]: _sass_counts(body)
               for n, body in _sass_of(K._lib, os.path.join(root, name, "lib.so"), "IfLi0E").items()
               if "reduce" in n or "onchip" in n}
        for name in sorted(libs)}})


def binread_section(K, KB, ref, bin_ids, starts_from_counts, with_base, R, N, dev, _lib,
                    src) -> None:
    """The ``binread`` and ``pb_scatter_add_full`` lines (module docstring)."""
    import numpy as np
    import torch

    from repro_torch.core import pb

    csrc = os.path.join(os.path.abspath(src), "repro_torch", "kernels", "csrc")
    tile = "constexpr int kBrTile = 4096;"
    threads = "constexpr int kBrThreads = 512;"
    unroll = "constexpr int kBrUnroll = 4;"
    with open(os.path.join(csrc, "binread.cu")) as fh:
        libs = {} if tile not in fh.read() else build_variants(_lib, csrc, "binread.cu", {
            **{f"tile{t}": [("binread.cu", tile, f"constexpr int kBrTile = {t};")]
               for t in (2048, 8192)},
            "threads1024": [("binread.cu", threads, "constexpr int kBrThreads = 1024;")],
            **{f"unroll{u}": [("binread.cu", unroll, f"constexpr int kBrUnroll = {u};")]
               for u in (8, 16)}},
            os.path.join(str(_lib.BUILD_ROOT), "variants", "binread"))
    for lib in libs.values():
        fn = lib.pb_binread_scatter_add
        fn.argtypes, fn.restype = _lib.SIGNATURES["pb_binread_scatter_add"]
    B, RB, d = -(-EMB_VOCAB // EMB_BIN_RANGE), EMB_BIN_RANGE, EMB_D

    def variant(lib, idx_p, val_p):
        """What ``binread_scatter_add`` does, with a variant's library."""
        L = idx_p.shape[1]
        acc = torch.zeros((B * RB, d), dtype=torch.float32, device=dev)
        out = acc if val_p.dtype == torch.float32 else torch.empty(
            (B * RB, d), dtype=val_p.dtype, device=dev)
        _lib.check(lib.pb_binread_scatter_add(
            idx_p.data_ptr(), val_p.data_ptr(), B, L, d, RB, acc.data_ptr(), out.data_ptr(),
            0 if val_p.dtype == torch.float32 else 1, _lib.stream(idx_p)), "binread variant")
        return out

    rng = np.random.default_rng(0)  # embed_grad.py's zipf ids; uniform ids from seed 1
    ids_np = {"zipf": np.minimum((rng.pareto(1.2, EMB_T) * 50).astype(np.int64), EMB_VOCAB - 1),
              "uniform": np.random.default_rng(1).integers(0, EMB_VOCAB, EMB_T)}
    g32 = torch.randn(EMB_T, d, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    for name, ids_n in ids_np.items():
        ids = torch.from_numpy(ids_n.astype(np.int32)).to(dev)
        keys = bin_ids(ids, RB)
        counts = ref.histogram_ref(keys, B)
        starts = starts_from_counts(counts)
        pos = ref.counting_positions_ref(keys, starts[:-1].contiguous(), B).long()
        L = max(8, -(-int(counts.max()) // 8) * 8)  # as ops.pb_scatter_add_full sizes it
        bidx = torch.empty_like(ids)
        bidx[pos] = ids
        brows = torch.empty_like(g32)
        brows[pos] = g32
        idx_p, val_p32 = K.ops.padded_bin_layout(pb.Bins(bidx, brows, starts, RB), B, L)
        del brows
        # the same rows sorted by index within each bin, padding last
        order = torch.argsort(torch.where(idx_p < 0, torch.iinfo(torch.int32).max, idx_p),
                              dim=1, stable=True)
        idx_s = torch.gather(idx_p, 1, order)
        flat = (order + torch.arange(B, device=dev)[:, None] * L).reshape(-1)
        for dt in (torch.float32, torch.bfloat16):
            val_p = val_p32 if dt == torch.float32 else val_p32.to(dt)
            val_s = val_p.reshape(B * L, d)[flat].reshape(B, L, d)
            g = g32.to(dt)

            def binread(mod, idx_p=idx_p, val_p=val_p):
                return mod.binread_scatter_add(idx_p, val_p, RB)

            fns = {"binread": lambda: binread(K),
                   "sorted": lambda val_s=val_s: K.binread_scatter_add(idx_s, val_s, RB),
                   "compact_index_add_": lambda g=g, dt=dt: torch.zeros(
                       (B * RB, d), dtype=dt, device=dev).index_add_(0, ids, g)}
            fns.update({v: lambda lib=lib, val_p=val_p: variant(lib, idx_p, val_p)
                        for v, lib in libs.items()})
            fns = with_base(fns, binread)
            want = ref.binread_scatter_add_ref(idx_p, val_p, RB)
            scale = ref.binread_scatter_add_ref(idx_p, val_p.abs(), RB).float()
            for k, fn in fns.items():
                if k == "compact_index_add_":
                    continue
                err = (fn().float() - want.float()).abs()
                ok = bool((err <= 1e-5 * scale + 1e-6).all()) if dt == torch.float32 \
                    else float(err.max()) <= 1e-1
                if not ok:
                    raise SystemExit(f"binread {k} differs from plain at {name} {dt} "
                                     f"({float(err.max())})")
            del want, scale, err
            esize = 4 if dt == torch.float32 else 2
            rec = {"ids": name, "dtype": str(dt), "B": B, "L": L, "d": d, "bin_range": RB,
                   "real_rows": EMB_T,
                   "bound_ms": (4 * B * L + esize * EMB_T * d + esize * B * RB * d) / 3.35e12 * 1e3}
            say("binread", {**rec, **interleaved(fns, R, max(2, N // 4))})
            say("profile", {"kernel": "binread", **rec, **kernel_profile(lambda: binread(K))})
            say("profile", {"kernel": "binread", "input": "sorted", **rec,
                            **kernel_profile(fns["sorted"])})
            if KB is not None:
                say("profile", {"kernel": "base:binread", **rec,
                                **kernel_profile(lambda: binread(KB))})
            del fns, val_s, val_p
        del idx_p, val_p32, idx_s, order, flat
        if name == "zipf":  # the caller: ops.pb_scatter_add_full at embed_grad's full shapes
            def pb_scatter_add_full(mod):
                return mod.ops.pb_scatter_add_full(ids, g32, EMB_VOCAB, bin_range=RB)

            want = torch.zeros(EMB_VOCAB, d, dtype=torch.float64, device=dev).index_add_(
                0, ids, g32.double())
            err = float((pb_scatter_add_full(K).double() - want).abs().max())
            if err > 1e-3:
                raise SystemExit(f"pb_scatter_add_full differs from float64 index_add_ ({err})")
            say("pb_scatter_add_full", {"ids": name, "T": EMB_T, "d": d, "max_abs_err": err,
                                        **interleaved(with_base({
                                            "pb_scatter_add_full": lambda: pb_scatter_add_full(K)},
                                            pb_scatter_add_full),
                                            R, max(2, N // 4))})
            del want
        torch.cuda.empty_cache()


def _rows_cases(T, dev, gen):
    """(tag, idx, n, F, dtype, row values or None for randn) of every timed
    shape of the rows kernel (module docstring), one at a time."""
    import numpy as np
    import torch

    from repro_torch.core import distributed_pb as dpb
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    suite = T.graph_suite("bench", device=dev)
    for name in ("KRON", "EURO", "HBUBL"):
        g = suite[name]
        idx = torch.sort(g.dst, stable=True).values
        for F in F_GRID:
            yield f"S1 {name}", idx, g.num_nodes, F, torch.float32, None
    del suite
    s2 = T.gen_uniform(1 << 22, 8, seed=3, device=dev)
    n2 = s2.num_nodes
    yield "S2", torch.sort(s2.dst, stable=True).values, n2, 64, torch.float32, None
    # 5d: rank 0's local stream after the owner exchange of S2's first 2^24
    # tuples over 4 ranks (chip_smoke.py phase 16): each source block's
    # tuples of [0, r2) in source order, padded to the capacity with the
    # last owned index (zero rows)
    ridx = s2.dst[:SHARD_ROWS_M]
    r2 = dpb.shard_range_for(n2, 4)
    cap = dpb.estimate_capacity(ridx, out_size=n2, n_dev=4)
    blk = SHARD_ROWS_M // 4
    parts, vparts = [], []
    for j in range(4):
        b = ridx[j * blk:(j + 1) * blk]
        own = b[b < r2][:cap]
        parts.append(torch.cat([own, torch.full((cap - own.shape[0],), r2 - 1, dtype=own.dtype,
                                                device=dev)]))
        vparts.append(torch.cat([torch.randn(own.shape[0], 64, device=dev, generator=gen),
                                 torch.zeros(cap - own.shape[0], 64, device=dev)]))
    del s2, ridx
    yield "5d", torch.cat(parts), r2, 64, torch.float32, torch.cat(vparts)
    del parts, vparts
    # the embedding backwards: _pb_take's stream at the training shapes
    for tag, arch, B, S, block in (("5b", "qwen2-1.5b", 4, 4096, None),
                                   ("5f", "llama-3.2-vision-11b", 2, 2048, None),
                                   ("5g", "qwen2-1.5b", 2, 2048, (0, 2))):
        cfg = get_config(arch)
        ids = torch.from_numpy(SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).batch_at(0)["tokens"])
        n = cfg.padded_vocab
        if block is not None:  # a vocab-parallel rank's block: ids outside it -1
            n //= block[1]
            local = ids - block[0] * n
            ids = torch.where((local >= 0) & (local < n), local, -1)
        yield tag, ids.reshape(-1).to(dev), n, cfg.d_model, torch.float32, None
    # zipf token ids at 5b's shape (binread's embedding stream's skew)
    rng = np.random.default_rng(0)
    zipf = np.minimum((rng.pareto(1.2, 16_384) * 50).astype(np.int64), 152_063)
    yield "zipf", torch.from_numpy(zipf.astype(np.int32)).to(dev), 152_064, 1536, torch.float32, None
    # 5c / 5e: the MoE combine, 972 tokens x top-8 in token order, bfloat16
    yield ("5c", torch.arange(972, dtype=torch.int32, device=dev).repeat_interleave(8), 972, 4096,
           torch.bfloat16, None)


def rows_section(K, KB, T, ref, with_base, R, N, dev, _lib, src) -> None:
    """The ``rows`` lines (module docstring)."""
    import torch

    csrc = os.path.join(os.path.abspath(src), "repro_torch", "kernels", "csrc")
    libs = build_variants(_lib, csrc, "fused_rows.cu", ROW_VARIANTS,
                          os.path.join(str(_lib.BUILD_ROOT), "variants", "rows"))
    for lib in libs.values():
        for name in ("pb_fused_accumulate_rows", "pb_fused_accumulate_rows_bf16"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _lib.SIGNATURES[name]

    def variant(lib, idx, val, n):
        F = val.shape[1]
        if val.dtype == torch.bfloat16:
            acc = torch.zeros(n, F, device=dev)
            out = torch.empty(n, F, dtype=torch.bfloat16, device=dev)
            st = lib.pb_fused_accumulate_rows_bf16(idx.data_ptr(), val.data_ptr(), idx.shape[0],
                                                   F, acc.data_ptr(), out.data_ptr(), n, 0,
                                                   _lib.stream(idx))
        else:
            out = torch.zeros(n, F, device=dev)  # add's identity
            st = lib.pb_fused_accumulate_rows(idx.data_ptr(), val.data_ptr(), idx.shape[0], F,
                                              out.data_ptr(), n, 0, 0, _lib.stream(idx))
        _lib.check(st, "rows variant")
        return out

    gen = torch.Generator(device=dev).manual_seed(7)
    for tag, idx, n, F, dt, val in _rows_cases(T, dev, gen):
        m = idx.shape[0]
        br = min(512, n)
        nb = -(-n // br)
        if dt == torch.float32 and tag != "5d":  # every op and dtype, once, against plain
            for vdt, op in ((torch.float32, "min"), (torch.float32, "max"), (torch.int32, "add"),
                            (torch.int32, "min"), (torch.int32, "max")):
                v = torch.randn(m, F, device=dev, generator=gen) if vdt == torch.float32 else \
                    torch.randint(-50, 50, (m, F), device=dev, generator=gen, dtype=torch.int32)
                if not torch.equal(K.cobra_bin_accumulate_rows(idx, v, n, br, nb, op),
                                   ref.scatter_reduce_ref(idx, v, n, op)):
                    raise SystemExit(f"rows {op} {vdt} differs from plain at {tag} F={F}")
                del v
        if val is None:
            val = torch.randn(m, F, device=dev, generator=gen).to(dt)
        keep = (idx >= 0) & (idx < n)
        kidx, kval = idx[keep], val[keep]
        kept = int(kidx.shape[0])

        def rows(mod, idx=idx, val=val, n=n, br=br, nb=nb):
            return mod.cobra_bin_accumulate_rows(idx, val, n, br, nb, "add")

        fns = {"rows": lambda: rows(K),
               "index_add_": lambda: torch.zeros(n, F, dtype=dt, device=dev).index_add_(
                   0, kidx, kval)}
        narrow = K.fused.rows_design(F) == "narrow"
        fns.update({k: lambda lib=lib: variant(lib, idx, val, n) for k, lib in libs.items()
                    if (k == "tile_all") == narrow  # tile_all: the narrow walk's rows only
                    and (k != "nosort" or kept == m)})  # nosort: no dropped rows, none last
        fns = with_base(fns, rows)
        want = ref.scatter_reduce_ref(idx, val, n, "add").float()
        scale = ref.scatter_reduce_ref(idx, val.float().abs(), n, "add")
        tol = 1e-5 * scale + 1e-6 + (2.0**-7 * want.abs() if dt == torch.bfloat16 else 0)
        for k, fn in fns.items():  # index_add_ sums bfloat16 rows in bfloat16: not held
            if k != "index_add_" and not bool(((fn().float() - want).abs() <= tol).all()):
                raise SystemExit(f"rows {k} (add) differs from plain at {tag} F={F}")
        del want, scale, tol
        es = val.element_size()
        rec = {"at": tag, "m": m, "kept": kept, "n": n, "F": F, "dtype": str(dt), "op": "add",
               "design": K.fused.rows_design(F),
               "bound_ms": (4 * m + es * kept * F + es * n * F) / 3.35e12 * 1e3}
        say("rows", {**rec, **interleaved(fns, R, N)})
        if (tag == "S1 KRON" and F in (1, 8)) or tag in ("S2", "5d", "5b"):
            say("profile", {"kernel": "rows", **rec, **kernel_profile(lambda: rows(K))})
            if KB is not None:
                say("profile", {"kernel": "base:rows", **rec, **kernel_profile(lambda: rows(KB))})
        if tag == "S1 KRON" and F in (1, 8):
            say("enqueue", {**rec, **enqueue_ms(fns)})
        del fns, val, kidx, kval, idx
        torch.cuda.empty_cache()


# rows 8-8g of PERF.md's kernel table: (B, H, KH, Sq, Skv, hd, causal)
FLASH_ROWS = {
    "8": (1, 12, 2, 4096, 4096, 128, True), "8b": (1, 64, 4, 972, 972, 128, True),
    "8c": (1, 32, 32, 453, 453, 80, True), "8d": (1, 32, 8, 1024, 1601, 128, False),
    "8e": (1, 8, 8, 1500, 1500, 64, False), "8f": (2, 6, 1, 2048, 2048, 128, True),
    "8g": (1, 6, 1, 450, 450, 128, True),
}


# csrc/flashattn.cu as the design's alternatives would have built it: 128-key
# tiles where a consumer could hold them (two warpgroups, or hd <= 64), and the
# producer as a warpgroup (warps 0-3, consumers after it), without and with
# setmaxnreg moving its registers to the consumers (24; 240 or 232)
_PRODUCER_WARPGROUP = [
    ("flashattn.cu", "  static constexpr int kThreads = 128 * NWG + 32;",
     "  static constexpr int kThreads = 128 * (NWG + 1);"),
    ("flashattn.cu", "  if (warp == 4 * NWG) {  // the producer warp: one lane issues every load\n"
     "    if (lane == 0) {", "  if (warp < 4) {\n    if (threadIdx.x == 0) {"),
    ("flashattn.cu", "    const int cw = warp / 4;\n", "    const int cw = warp / 4 - 1;\n"),
]
def _wgmma_ss(n: int) -> str:
    """The source of the kernel's ``wgmma_ss`` for m64n{n}k16, which the
    128-key variant needs beside the kernel's own n64."""
    d = n // 2
    regs = ", ".join(f"%{i}" for i in range(d))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(d))
    return (f"template <int ScaleD>\n__device__ __forceinline__ void wgmma_ss(float (&d)[{d}], "
            f"uint64_t a, uint64_t b) {{\n  asm volatile(\"{{\\n.reg .pred p;\\n"
            f"setp.ne.b32 p, %{d + 2}, 0;\\nwgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16"
            f" {{{regs}}}, %{d}, %{d + 1}, p, 1, 1, 0, 0;\\n}}\\n\"\n"
            f"      : {outs}\n      : \"l\"(a), \"l\"(b), \"r\"(ScaleD));\n}}\n\n")


_SS_ANCHOR = "// d (m64n16k16, f32) += a b, A in registers, B MN-major in shared memory."
FLASH_VARIANTS = {
    "keys128": [("flashattn.cu", "  static constexpr int kKeys = 64;",
                 "  static constexpr int kKeys = NWG == 2 || HD <= 64 ? 128 : 64;"),
                ("flashattn.cu", _SS_ANCHOR, _wgmma_ss(128) + _SS_ANCHOR)],
    "producer_warpgroup": _PRODUCER_WARPGROUP,
    "producer_warpgroup_setmaxnreg": [
        _PRODUCER_WARPGROUP[0],
        (_PRODUCER_WARPGROUP[1][0], _PRODUCER_WARPGROUP[1][1],
         '  if (warp < 4) {\n    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");\n'
         "    if (threadIdx.x == 0) {"),
        (_PRODUCER_WARPGROUP[2][0], _PRODUCER_WARPGROUP[2][1],
         "    const int cw = warp / 4 - 1;\n"
         '    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(NWG == 2 ? 240 : 232));\n'),
    ],
}


def _ptxas_bf16(log: str) -> dict:
    """Registers and spills of each bf16 flash instantiation in nvcc's
    ``-Xptxas -v`` output, keyed hd<d>[_nwg<n>]."""
    import re

    build = {}
    for entry in log.split("Compiling entry function")[1:]:
        m = re.search(r"flash_fwd_bf16_kernelILi(\d+)E(?:Li(\d+)E)?", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        if m and regs:
            key = f"hd{m.group(1)}" + (f"_nwg{m.group(2)}" if m.group(2) else "")
            build[key] = {"registers": int(regs.group(1)),
                          "spill_stores": int(spill.group(1)) if spill else None,
                          "spill_loads": int(spill.group(2)) if spill else None}
    return build


def flash_smem(hd, nwg) -> int:
    """Dynamic shared memory of a bf16 flash block (``Geo<HD, NWG>`` in
    csrc/flashattn.cu): Q, the stages of 64-key K and V tiles (as many, up
    to four, as fit a block and, at one warpgroup, two blocks an SM), a
    barrier for Q and three a stage, and the base's alignment."""
    def smem(stages):
        return 64 * nwg * hd * 2 + 2 * stages * 64 * hd * 2 + 8 * (1 + 3 * stages) + 1024

    blocks = 2 if nwg == 1 else 1
    return smem(next(n for n in (4, 3, 2)
                     if smem(n) <= 232_448 and blocks * (smem(n) + 1024) <= 233_472))


def flash_section(K, KB, R, N, dev, smi) -> None:
    """The ``flash`` lines (module docstring)."""
    import torch
    import torch.nn.functional as F

    trees = {"kernel": K} | ({"base": KB} if KB is not None else {})
    variants = build_variants(K._lib, str(K._lib.CSRC), "flashattn.cu", FLASH_VARIANTS,
                              os.path.join(str(K._lib.BUILD_ROOT), "variants", "flash"))
    argtypes, restype = K._lib.SIGNATURES["pb_flash_attention"]
    for lib in variants.values():
        lib.pb_flash_attention.argtypes, lib.pb_flash_attention.restype = argtypes, restype

    def variant(lib, q, k, v, causal):  # the wrapper's call, on a variant's library
        out = torch.empty_like(q)
        B, H, Sq, hd = q.shape
        st = [x for t in (q, k, v, out) for x in t.stride()[:3]]
        K._lib.check(lib.pb_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, k.shape[1], Sq,
            k.shape[2], hd, 1, int(causal), hd**-0.5, *st, K._lib.stream(q)), "flash variant")
        return out

    gen = torch.Generator(device=dev).manual_seed(30)
    for row, (B, H, KH, Sq, Skv, hd, causal) in FLASH_ROWS.items():
        q, k, v = (torch.randn(B, h, S, hd, device=dev, generator=gen).bfloat16()
                   for h, S in ((H, Sq), (KH, Skv), (KH, Skv)))
        want = K.flashattn.flash_attention_ref(q, k, v, causal=causal).float()
        fns, errs = {}, {}
        calls = {name: (lambda mod=mod: mod.flash_attention(q, k, v, causal=causal))
                 for name, mod in trees.items()}
        calls |= {f"variant:{name}": (lambda lib=lib: variant(lib, q, k, v, causal))
                  for name, lib in variants.items()}
        for name, call in calls.items():
            diff = (call().float() - want).abs()
            errs[name] = float(diff.max())
            if not bool((diff <= 2.0**-7 * want.abs() + 1e-4).all()):
                raise SystemExit(f"flash {name} at row {row} differs from plain: {errs[name]}")
            fns[name] = call
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                               enable_gqa=True)
        flop = K.flashattn.flash_flops(B, H, Sq, Skv, hd, causal)
        times = interleaved(fns, R, N)
        device = {name: kernel_profile(fn)["device_ms"] for name, fn in fns.items()}
        say("flash", {"row": row, "shape": [B, H, KH, Sq, Skv, hd], "causal": causal,
                      "max_abs_err": errs, "interleaved": times, "device_ms": device,
                      "enqueue_ms": enqueue_ms({n: fns[n] for n in trees}),
                      "useful_tflops": {n: flop / ms / 1e9 for n, ms in device.items() if ms},
                      "executed_tflops": {n: 1.5 * flop / device[n] / 1e9
                                          for n in calls if device[n]},
                      "bound_ms": flop / 989e12 * 1e3, "card": smi})
        del q, k, v, want
    # host ms a call at a launch-bound shape, rounds alternating between the trees
    # and dtypes (no sync between calls; the device work is a few microseconds)
    host = {}
    for dt in (torch.bfloat16, torch.float32):
        for hd in (80, 128):
            q = torch.randn(1, 2, 64, hd, device=dev, generator=gen).to(dt)
            k = torch.randn(1, 1, 64, hd, device=dev, generator=gen).to(dt)
            for name, mod in trees.items():
                host[f"{name}:{str(dt)[6:]}:hd{hd}"] = (lambda mod=mod, q=q, k=k:
                                                        mod.flash_attention(q, k, k))
    per = {n: [] for n in host}
    for r in range(R):
        for n, ms in enqueue_ms(dict(list(host.items())[::-1 if r % 2 else 1]), 500).items():
            per[n].append(ms)
    say("flash_host", {"ms": {n: {"mean": sum(v) / len(v), "min": min(v), "max": max(v)}
                              for n, v in per.items()}, "card": smi})
    logs = {name: mod._lib.build_log().split("== flashattn.cu")[1].split("\n== ")[0]
            for name, mod in trees.items()}
    for name in variants:
        with open(os.path.join(str(K._lib.BUILD_ROOT), "variants", "flash", name,
                               "build.log")) as fh:
            logs[f"variant:{name}"] = fh.read()
    for name, log in logs.items():
        build = _ptxas_bf16(log)
        if name == "kernel":
            for key, rec in build.items():
                hd, nwg = (int(x) for x in key[2:].split("_nwg"))
                rec["dynamic_smem"] = flash_smem(hd, nwg)
        say("flash_build", {"tree": name, "bf16": build, "card": smi})


if __name__ == "__main__":
    main()
