#!/usr/bin/env python3
"""Where the onesweep COBRA pass spends its time, on one NVIDIA card.

    python3 scripts/torch_cobra_phases.py [--reps 10]

Builds variants of ``src/repro_torch/kernels/csrc/cobra_pass.cu`` (with
``pb_onesweep.cuh``), each a text patch of the checkout's sources, into
``_build/cobra_phases/`` beside the kernels' own build, one ``nvcc`` per
variant, all started together, and times each on the same inputs in one
process (CUDA events, three runs of ``reps`` launches):

- ``kept``: the sources as they are (two blocks an SM);
- ``compiler``: ``__launch_bounds__`` without a block count;
- ``one_block``: ``__launch_bounds__(512, 1)`` (up to 128 registers);
- ``late_loads``: idx and val loaded after the rank instead of with the keys;
- ``stamps``: ``kept`` plus a ``%globaltimer`` stamp at the end of each
  phase of every tile (load and rank; warp scan and publish; slots and
  staging; look-back; eviction) and a count of the look-back's windows.

Inputs: the passes ``ops.cobra_binning`` makes with the H100 plan at S2
(``gen_uniform(2^22, 8, seed=3)``, 289 bins) and S3 (``gen_uniform(32M,
4, seed=3)``, 735 bins on raw keys, 2,203 bins on raw keys and on the
first level's output). Every variant's output must equal
``binned_stream_ref``. Prints ``ptxas`` lines (registers, spills) per
variant, then one JSON line per input: times, each phase's mean and 90th
percentile in microseconds, tiles in flight, windows walked a bin. Exits
non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

KERNEL = "__global__ void __launch_bounds__(os::kThreads, 2)\ncobra_onesweep_kernel"
LOADS = """    packed[j] = (unsigned)k < (unsigned)B ? k : os::kNoBin;
    id[j] = in ? __ldcs(idx + i) : 0;
    v[j] = in ? __ldcs(val + i) : 0u;
  }"""
RANK = "  os::rank_warp<kOsItems, NBITS>(packed, row, B);\n"
LATE = """#pragma unroll
  for (int j = 0; j < kOsItems; ++j) {
    const long long i = base + j * 32;
    id[j] = i < m ? __ldcs(idx + i) : 0;
    v[j] = i < m ? __ldcs(val + i) : 0u;
  }
"""
STAMP = "  if (threadIdx.x == 0 && g_stamps) g_stamps[tile * 8 + {}] = stamp();\n"
PROBE = """__device__ unsigned long long* g_stamps;
extern "C" void pb_set_probe(void* t, void* w) {
  cudaMemcpyToSymbol(g_stamps, &t, sizeof(t));
  cudaMemcpyToSymbol(pb::onesweep::g_windows, &w, sizeof(w));
}
__device__ __forceinline__ unsigned long long stamp() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""


def patch(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"torch_cobra_phases: the sources changed; cannot find {old!r}")
        text = text.replace(old, new)
    return text


def variants() -> dict:
    """name -> (cobra_pass.cu patches, pb_onesweep.cuh patches)."""
    stamps_cu = [
        ('#include "pb_tiles.cuh"\n', '#include "pb_tiles.cuh"\n' + PROBE),
        ("  const int lane = threadIdx.x & 31;\n  const int warp = threadIdx.x >> 5;\n"
         "  const long long base = tile * kOsTile",
         STAMP.format(0) + "  const int lane = threadIdx.x & 31;\n"
         "  const int warp = threadIdx.x >> 5;\n  const long long base = tile * kOsTile"),
        (RANK + "  __syncthreads();\n", RANK + "  __syncthreads();\n" + STAMP.format(1)),
        ("s_warp);  // the tile's in-range tuples\n",
         "s_warp);  // the tile's in-range tuples\n" + STAMP.format(2)),
        ("  os::look_back(status, tile, s_tot, starts, s_tot, B);\n",
         "  __syncthreads();\n" + STAMP.format(3)
         + "  os::look_back(status, tile, s_tot, starts, s_tot, B);\n"),
        ("    __stcs(out_val + d, st_val[s]);\n  }\n}\n",
         "    __stcs(out_val + d, st_val[s]);\n  }\n  __syncthreads();\n" + STAMP.format(5)
         + "}\n"),
        ("  for (int b = threadIdx.x; b < B; b += os::kThreads) s_tot[b] -= s_first[b];\n"
         "  __syncthreads();\n",
         "  for (int b = threadIdx.x; b < B; b += os::kThreads) s_tot[b] -= s_first[b];\n"
         "  __syncthreads();\n" + STAMP.format(4)),
    ]
    stamps_h = [
        ("constexpr int kWindow = 8;\n", "constexpr int kWindow = 8;\n__device__ int* g_windows;\n"),
        ("  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {\n    unsigned run = 0;",
         "  int windows = 0;\n"
         "  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {\n    unsigned run = 0;"),
        ("      for (long long t = tile - 1;; t -= kWindow) {\n",
         "      for (long long t = tile - 1;; t -= kWindow) {\n        ++windows;\n"),
        ("    s_pre[b] = (int)run;\n  }\n}",
         "    s_pre[b] = (int)run;\n  }\n  if (g_windows) atomicAdd(&g_windows[tile], windows);\n}"),
    ]
    return {
        "kept": ([], []),
        "compiler": ([(KERNEL, KERNEL.replace("os::kThreads, 2", "os::kThreads"))], []),
        "one_block": ([(KERNEL, KERNEL.replace("os::kThreads, 2", "os::kThreads, 1"))], []),
        "late_loads": ([(LOADS, LOADS.split("\n")[0] + "\n  }"), (RANK, RANK + LATE)], []),
        "stamps": (stamps_cu, stamps_h),
    }


def build(nvcc: str, csrc: str, root: str) -> dict:
    """Write and compile every variant; returns name -> (library path, ptxas lines)."""
    procs = {}
    for name, (cu, h) in variants().items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for f, pairs in (("cobra_pass.cu", cu), ("pb_onesweep.cuh", h),
                         ("pb_common.cuh", []), ("pb_tiles.cuh", [])):
            with open(os.path.join(csrc, f)) as src, open(os.path.join(d, f), "w") as dst:
                dst.write(patch(src.read(), pairs))
        lib = os.path.join(d, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", "-Xptxas", "-v", "-o", lib, os.path.join(d, "cobra_pass.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0].splitlines()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n" + "\n".join(log))
        at = [i for i, ln in enumerate(log) if "cobra_onesweep_kernelILi10" in ln and "Compiling" in ln]
        out[name] = (lib, [ln.strip() for ln in log[at[0] + 2:at[0] + 4]] if at else [])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_cobra_phases: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    import repro_torch.core as T
    import repro_torch.kernels as K
    from repro_torch.core.pb import bin_ids, starts_from_counts
    from repro_torch.kernels import _lib, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card", json.dumps({"nvidia-smi": smi}), flush=True)
    built = build(_lib.nvcc_path(), str(_lib.CSRC), os.path.join(str(_lib.BUILD_ROOT), "cobra_phases"))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    libs = {}
    for name, (path, ptxas) in built.items():
        print("ptxas", json.dumps({"variant": name, "cobra_onesweep_kernel<10>": ptxas}), flush=True)
        lib = ctypes.CDLL(path)
        lib.pb_cobra_pass_scratch.argtypes, lib.pb_cobra_pass_scratch.restype = [L, I, I], L
        lib.pb_cobra_pass.argtypes, lib.pb_cobra_pass.restype = [P, P, P, L, P, I, P, P, P, I, P], I
        libs[name] = lib
    libs["stamps"].pb_set_probe.argtypes = [P, P]
    dev = torch.device("cuda")
    hw = T.HardwareModel.h100()

    def run(lib, keys, idx, val, starts, nb):
        m = keys.shape[0]
        oi, ov = torch.empty_like(idx), torch.empty_like(val)
        scratch = torch.empty(lib.pb_cobra_pass_scratch(m, nb, 1), dtype=torch.int32, device=dev)
        _lib.check(lib.pb_cobra_pass(keys.data_ptr(), idx.data_ptr(), val.data_ptr(), m,
                                     starts.data_ptr(), nb, oi.data_ptr(), ov.data_ptr(),
                                     scratch.data_ptr(), 1, torch.cuda.current_stream().cuda_stream),
                   "cobra pass variant")
        return oi, ov

    def ms(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    inputs = []
    for tag, g in (("S2", T.gen_uniform(1 << 22, 8, seed=3, device=dev)),
                   ("S3", T.gen_uniform(32_000_000, 4, seed=3, device=dev))):
        levels = T.CobraPlan.from_hardware(g.num_nodes, hw).level_ranges()
        for i, r in enumerate(levels):
            nb = -(-g.num_nodes // r)
            inputs.append((f"{tag} {nb} bins, raw keys", bin_ids(g.dst, r), g.dst, g.src, nb))
            if i > 0:  # what cobra_binning hands this level
                pr = levels[i - 1]
                pk, pnb = bin_ids(g.dst, pr), -(-g.num_nodes // pr)
                ps = starts_from_counts(ref.histogram_ref(pk, pnb))[:-1].contiguous()
                oi, ov = K.cobra_binning_pass(pk, g.dst, g.src, ps, pnb)
                inputs.append((f"{tag} {nb} bins, level {i}'s output", bin_ids(oi, r), oi, ov, nb))
    for name, keys, idx, val, nb in inputs:
        starts = starts_from_counts(ref.histogram_ref(keys, nb))[:-1].contiguous()
        want = ref.binned_stream_ref(keys, idx, val, nb)
        rec = {"input": name, "m": keys.shape[0], "num_bins": nb, "ms": {}}
        for v, lib in libs.items():
            got = run(lib, keys, idx, val, starts, nb)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise SystemExit(f"variant {v} differs from binned_stream_ref on {name}")
            rec["ms"][v] = [ms(lambda lib=lib: run(lib, keys, idx, val, starts, nb)) for _ in range(3)]
        tiles = -(-keys.shape[0] // 8192)  # csrc/cobra_pass.cu kOsTile
        stamps = torch.zeros(tiles * 8, dtype=torch.int64, device=dev)
        windows = torch.zeros(tiles, dtype=torch.int32, device=dev)
        libs["stamps"].pb_set_probe(stamps.data_ptr(), windows.data_ptr())
        run(libs["stamps"], keys, idx, val, starts, nb)
        torch.cuda.synchronize()
        libs["stamps"].pb_set_probe(None, None)
        t = stamps.view(tiles, 8)[:, :6].double()
        phase = (t[:, 1:] - t[:, :-1]) / 1e3
        mid = (t[:, 0].min() + t[:, 5].max()) / 2
        rec.update({
            "phases": ["load and rank", "warp scan and publish", "slots and staging", "look-back",
                       "eviction"],
            "phase_us_mean": phase.mean(0).tolist(),
            "phase_us_p90": phase.quantile(0.9, dim=0).tolist(),
            "tile_us_mean": float((t[:, 5] - t[:, 0]).mean() / 1e3),
            "tiles_in_flight_mid": int(((t[:, 0] <= mid) & (t[:, 5] >= mid)).sum()),
            "windows_per_bin_mean": float(windows.double().mean() / nb),
        })
        print("phases", json.dumps(rec), flush=True)
    print("card", json.dumps({"nvidia-smi": smi}), flush=True)


if __name__ == "__main__":
    main()
