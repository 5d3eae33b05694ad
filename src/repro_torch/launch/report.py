"""Render the dry run's JSON records as a markdown table (port of
``repro/launch/report.py``).

The reference's table row for row. Two columns follow the port's
records: ``mem/dev`` is the traced peak of live bytes per rank (the
reference's CPU-bf16 corrected figure has no twin), and the fit column
is ``fits 80GB``, the H100's HBM at the dry run's 0.94 headroom.

  PYTHONPATH=src python -m repro_torch.launch.report dryrun.json
"""
from __future__ import annotations

import argparse
import json


def fmt_bytes(b):
    return f"{b/1e9:.2f}GB"


def render(records):
    lines = [
        "| arch | shape | mesh | accum | t_compute | t_memory | t_collective | "
        "bottleneck | useful | roofline_frac | mem/dev | fits 80GB |",
        "|" + "---|" * 12,
    ]
    for r in records:
        if not r.get("ok"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - | - | "
                f"FAILED: {r.get('error', '?')[:60]} | - | - | - | - |"
            )
            continue
        rl = r.get("roofline")
        m = r.get("memory_per_device", {})
        mem = f"{m.get('live_bytes', 0)/1e9:.1f}"
        fits = "Y" if m.get("fits_80GB_hbm") else "N"
        if rl:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('accum_steps', '-')} "
                f"| {rl['t_compute_s']*1e3:.1f}ms | {rl['t_memory_s']*1e3:.1f}ms "
                f"| {rl['t_collective_s']*1e3:.1f}ms | {rl['bottleneck']} "
                f"| {rl['useful_ratio']:.2f} | {rl['roofline_fraction']:.3f} "
                f"| {mem} | {fits} |"
            )
        else:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('accum_steps', '-')} "
                f"| - | - | - | (validity+memory pass) | - | - | {mem} | {fits} |"
            )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("json_files", nargs="+")
    args = ap.parse_args(argv)
    for f in args.json_files:
        with open(f) as fh:
            recs = json.load(fh)
        print(f"\n### {f} ({sum(r.get('ok', False) for r in recs)}/{len(recs)} OK)\n")
        print(render(recs))


if __name__ == "__main__":
    main()
