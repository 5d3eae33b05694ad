#!/usr/bin/env python3
"""Measure the port's binning fallback table on a CUDA card.

    python3 scripts/torch_autotune_table.py [--reps 3] [--rounds 3]

Runs ``PBExecutor.measure_methods`` (the port's autotuner: a synthetic
stream of uniform int32 indices and int32 values, each candidate warmed
once and timed ``--reps`` times between device synchronisations) at
``(2^a, 2^b)`` for every ``(a, b)`` bucket of the reference's
``_FALLBACK_TABLE`` and at the buckets of ``chip_smoke.py``'s sizes: S1
(2^18 vertices; 2^19, 2^20 and 2^21 edges), S2 (2^22, 2^25) and S3
(32M -> 2^24, 128M -> 2^26). Once with ``use_pallas`` off (sort,
counting, hierarchical) and once on (pallas too), each ``--rounds``
times; a bucket's method is the one fastest in most rounds (ties: the
smallest summed time). Prints a JSON line per bucket and round, the card's
name and power limit, and the two tables in the form of
``executor._FALLBACK_TABLE_H100``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import Counter

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

S_BUCKETS = [(18, 19), (18, 20), (18, 21), (22, 25), (24, 26)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_autotune_table.py measures the card: CUDA is not available")
    from repro_torch.core import executor as ex_mod
    from repro_torch.kernels import _lib

    _lib.load()  # build the kernels before any timing
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    buckets = sorted(set(ex_mod._FALLBACK_TABLE) | set(S_BUCKETS))
    dev = torch.device("cuda")
    tables = {}
    for use_pallas in (False, True):
        ex = ex_mod.PBExecutor(use_pallas=use_pallas, cache_dir=os.devnull)
        table = {}
        for a, b in buckets:
            wins, total = Counter(), Counter()
            for rnd in range(args.rounds):
                res = ex.measure_methods(1 << a, 1 << b, torch.int32, reps=args.reps, device=dev)
                wins[res["method"]] += 1
                total.update(res["timings_us"])
                print(json.dumps({"use_pallas": use_pallas, "bucket": [a, b], "round": rnd,
                                  **res}), flush=True)
            table[(a, b)] = max(wins, key=lambda m: (wins[m], -total[m]))
        tables[use_pallas] = table
    print(smi)
    print("_FALLBACK_TABLE_H100 = {")
    for use_pallas, table in tables.items():
        print(f"    {use_pallas}: {{")
        for k, m in sorted(table.items()):
            print(f"        {k}: {m!r},")
        print("    },")
    print("}")


if __name__ == "__main__":
    main()
