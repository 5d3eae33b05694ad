#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and ``nvcc``, and
imports only ``repro_torch`` (never JAX or ``repro``). It exits non-zero,
without a result line, when CUDA is unavailable, when the package is not
beside it, or on any mismatch. Phases:

1. Device: ``nvidia-smi`` name and power limit, the device properties
   beside ``HardwareModel.h100()``, then the kernels' build (nvcc, sm_90a).
2. Each kernel against its plain version on the card: histogram and
   positions at m in {1, 17, 5000, 2^25} x B in {2, 257, 908, 65536}
   (random and all-one-key streams); the fused accumulate for
   {add, min, max} x {float32, int32} at n = 2^22, m = 2^25, plus the
   skewed KRON edge stream.
3. The main path, fig5's arms A-E (``benchmarks/fig5_end2end.py``) through
   the port's entry points with the default executor, at S1 (the five
   ``graph_suite("bench")`` graphs, checked against the port on the CPU),
   S2 (``gen_uniform(2^22, 8)``) and S3 (``gen_uniform(32M, 4)``, the
   paper's scale). PB and COBRA CSRs must equal the baseline CSR; arms
   C-E must agree with arm B.
4. The same arms with ``PBExecutor(use_pallas=True)`` plus
   ``build_csr_pb(method="pallas")`` at S1 and S2: CSRs and binned
   streams identical to phase 3's, ranks within tolerance.
5. The ``kernels`` JSON line (launches on the main path of phases 3-4,
   times at S2's main-path shapes) and the result line.

Tolerances: integer outputs, CSRs, binned streams and min/max results
must be equal. Float32 PageRank sums run in an order that differs between
arms, devices and runs (atomics). The hub of the DBP graph receives about
half of all edges (1.1M at S1), and adding a million contributions of
similar size to one float32 sum rounds with a bias that can reach a
fraction of an ulp of the sum per addition. The hub holds about half of
the rank mass, so its error spreads to every vertex (on an H100 the arms
differ there by up to about 2e-3 elementwise and 1e-3 in relative L1
norm; PERF.md).
So ranks agree within rtol 1e-2 elementwise (plus atol 1e-6 of the
largest rank) and within 5e-3 in relative L1 norm; each size also
prints every arm's L1 distance to a float64 PageRank. A fused float32
add differs from the plain sum by at most about (k - 1) * 2^-24 * sum|v|
at an index that receives k tuples; it is held to 1e-5 * sum|v| + 1e-6
per index.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ITERS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PR_RTOL = 1e-2  # elementwise, see the module docstring
PR_L1 = 5e-3  # sum |x - y| / sum |y|
ADD_TOL = 1e-5  # times the sum of |v| reaching an index


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        fail("src/repro_torch is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke.py drives the port on an NVIDIA card")
    os.environ.setdefault("REPRO_TORCH_CACHE_DIR", os.path.join(HERE, ".torch_cache"))

    import repro_torch.core as T
    import repro_torch.kernels as K
    from repro_torch.core.pb import bin_ids, reduce_identity, starts_from_counts
    from repro_torch.kernels import _lib, ref
    from repro_torch.timing import cuda_ms, time_fn

    dev = torch.device("cuda")
    hw = T.HardwareModel.h100()

    # -- phase 1: device and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    say(f"phase1 nvidia-smi: {smi}")
    say(
        "phase1 device:",
        json.dumps({
            "name": props.name,
            "L2_cache_size": getattr(props, "L2_cache_size", None),
            "shared_memory_per_block_optin": getattr(props, "shared_memory_per_block_optin", None),
            "multi_processor_count": props.multi_processor_count,
            "total_memory": props.total_memory,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }),
    )
    say("phase1 model:", hw)
    t0 = time.perf_counter()
    _lib.load()
    say(f"phase1 kernels built in {time.perf_counter() - t0:.2f} s into {_lib.load().build_dir.name}")
    for line in _lib.build_log().splitlines():
        if line.startswith("==") or "registers" in line:
            say("phase1 nvcc:", line.strip())

    # -- phase 2: kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"histogram": 0, "counting_positions": 0, "cobra_bin_accumulate": 0.0}
    for m in (1, 17, 5000, 1 << 25):
        for B in (2, 257, 908, 65536):
            for stream in ("random", "one-key"):
                keys = torch.randint(0, B, (m,), device=dev, generator=gen, dtype=torch.int32)
                if stream == "one-key":
                    keys.fill_(B // 3)
                h = K.histogram(keys, B)
                hr = ref.histogram_ref(keys, B)
                starts = starts_from_counts(hr)[:-1].contiguous()
                p = K.counting_positions(keys, starts, B)
                pr = ref.counting_positions_ref(keys, starts, B)
                torch.cuda.synchronize()
                eh = int((h - hr).abs().max())
                ep = int((p - pr).abs().max()) if m else 0
                worst["histogram"] = max(worst["histogram"], eh)
                worst["counting_positions"] = max(worst["counting_positions"], ep)
                reps = 10 if m > 5000 else 50
                say(
                    "phase2",
                    json.dumps({
                        "m": m, "B": B, "stream": stream,
                        "histogram": {
                            "max_abs_err": eh,
                            "kernel_ms": cuda_ms(K.histogram, keys, B, reps=reps),
                            "plain_ms": cuda_ms(ref.histogram_ref, keys, B, reps=reps),
                            "library_ms": cuda_ms(torch.bincount, keys, None, B, reps=reps),
                            "bound_ms": bound_ms(4 * m + 4 * B),
                        },
                        "counting_positions": {
                            "max_abs_err": ep,
                            "kernel_ms": cuda_ms(K.counting_positions, keys, starts, B, reps=reps),
                            "plain_ms": cuda_ms(ref.counting_positions_ref, keys, starts, B, reps=reps),
                            "library_ms": None,
                            "bound_ms": bound_ms(8 * m + 4 * B),
                        },
                    }),
                )
                require(eh == 0 and ep == 0, f"histogram/positions differ from plain at m={m} B={B} {stream}")

    n, m = 1 << 22, 1 << 25
    r = min(max(64, T.compromise_bin_range(n, hw)), n)
    idx_u = torch.randint(0, n, (m,), device=dev, generator=gen, dtype=torch.int32)
    kron = T.gen_kron(18, 8, seed=2, device=dev)
    streams = [("uniform", idx_u, n, r), ("kron-dst", kron.dst, kron.num_nodes,
                                          min(max(64, T.compromise_bin_range(kron.num_nodes, hw)), kron.num_nodes))]
    for sname, idx, nn, rr in streams:
        mm = idx.shape[0]
        for dt in (torch.float32, torch.int32):
            if dt == torch.float32:
                val = torch.randn(mm, device=dev, generator=gen)
            else:
                val = torch.randint(-50, 50, (mm,), device=dev, generator=gen, dtype=torch.int32)
            for op in ("add", "min", "max"):
                nb = -(-nn // rr)
                got = K.cobra_bin_accumulate(idx, val, nn, rr, nb, op)
                want = ref.scatter_reduce_ref(idx, val, nn, op)
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                if dt == torch.float32 and op == "add":
                    scale = ref.scatter_reduce_ref(idx, val.abs(), nn, "add")
                    ok = bool(((got - want).abs() <= ADD_TOL * scale + 1e-6).all())
                else:
                    ok = torch.equal(got, want)
                worst["cobra_bin_accumulate"] = max(worst["cobra_bin_accumulate"], err)

                def lib_call(i=idx, v=val, o=op, n_=nn, d=dt):
                    out = torch.full((n_,), reduce_identity(o, d), dtype=d, device=dev)
                    if o == "add":
                        return out.index_add_(0, i, v)
                    return out.scatter_reduce_(0, i.long(), v, "amin" if o == "min" else "amax")

                say(
                    "phase2",
                    json.dumps({
                        "fused": sname, "n": nn, "m": mm, "bin_range": rr, "dtype": str(dt),
                        "op": op, "max_abs_err": err, "ok": bool(ok),
                        "kernel_ms": cuda_ms(K.cobra_bin_accumulate, idx, val, nn, rr, nb, op, reps=10),
                        "plain_ms": cuda_ms(ref.scatter_reduce_ref, idx, val, nn, op, reps=10),
                        "library_ms": cuda_ms(lib_call, reps=10),
                        "bound_ms": bound_ms(8 * mm + 4 * nn),
                    }),
                )
                require(ok, f"fused {op} {dt} on {sname} differs from plain (max err {err})")
    del idx_u, val, got, want

    # -- phases 3 and 4: the main path ----------------------------------------
    def arms(g):
        nn = g.num_nodes
        br = min(max(64, T.compromise_bin_range(nn, hw)), nn)
        plan = T.CobraPlan.from_hardware(nn, hw)
        outdeg = T.degrees_from_coo(g, by="src")
        return br, plan, {
            "A": lambda: T.pagerank_coo_scatter(g, iters=ITERS).ranks,
            "B": lambda: T.pagerank_csr_pull(
                T.build_csr_baseline(T.transpose_coo(g)), outdeg, iters=ITERS).ranks,
            "C": lambda: (T.build_csr_pb(T.transpose_coo(g), br),
                          T.pagerank_pb(g, iters=ITERS, bin_range=br).ranks)[1],
            "D": lambda: (T.build_csr_cobra(T.transpose_coo(g), plan),
                          T.pagerank_pb(g, iters=ITERS, bin_range=plan.final_bin_range).ranks)[1],
            "E": lambda: T.pagerank_fused(g, iters=ITERS).ranks,
        }

    def builds(g, br, plan, pallas=False):
        gt = T.transpose_coo(g)
        out = {
            "baseline": T.build_csr_baseline(gt),
            "pb": T.build_csr_pb(gt, br),
            "cobra": T.build_csr_cobra(gt, plan),
        }
        if pallas:
            out["pb_pallas"] = T.build_csr_pb(gt, br, method="pallas")
        return out

    def same_csr(a, b):
        return torch.equal(a.offsets.cpu(), b.offsets.cpu()) and torch.equal(
            a.neighs.cpu(), b.neighs.cpu()
        )

    def pagerank64(g):
        """Arm A's algorithm in float64, the yardstick of float32 drift."""
        nn = g.num_nodes
        od = torch.bincount(g.src, minlength=nn).clamp(min=1).double()
        rk = torch.full((nn,), 1.0 / nn, dtype=torch.float64, device=g.src.device)
        for _ in range(ITERS):
            inc = torch.zeros_like(rk).index_add_(0, g.dst, (rk / od)[g.src])
            rk = 0.15 / nn + 0.85 * inc
        return rk

    def close(x, y):
        x, y = x.double().cpu(), y.double().cpu()
        rel = float(((x - y).abs() / y.abs().clamp(min=1e-30)).max())
        l1 = float((x - y).abs().sum() / y.abs().sum())
        ok = torch.allclose(x, y, rtol=PR_RTOL, atol=1e-6 * float(y.abs().max())) and l1 <= PR_L1
        return ok, {"max_rel": rel, "l1_rel": l1}

    def run_size(tag, g, reps, warmup, ref_cpu=None, pallas=False):
        br, plan, fns = arms(g)
        log0 = len(T.get_default_executor().decision_log)
        times = {a: time_fn(f, reps=reps, warmup=warmup) for a, f in fns.items()}
        ranks = {a: f() for a, f in fns.items()}
        csrs = builds(g, br, plan, pallas=pallas)
        torch.cuda.synchronize()
        for k, c in csrs.items():
            require(same_csr(c, csrs["baseline"]), f"{tag}: {k} CSR differs from the baseline CSR")
        rels = {}
        indeg = torch.bincount(g.dst, minlength=g.num_nodes).cpu()
        for a in "ACDE":
            ok, rel = close(ranks[a], ranks["B"])
            v = int(((ranks[a] - ranks["B"]).abs() / ranks["B"].abs()).argmax())
            rels[a] = dict(rel, worst_vertex_indegree=int(indeg[v]))
            require(ok, f"{tag}: arm {a} disagrees with arm B ({rels[a]})")
        exact = pagerank64(g)
        l1_vs_f64 = {a: float((ranks[a].double() - exact).abs().sum() / exact.abs().sum())
                     for a in "ABCDE"}
        bins = T.pb_bin_edges(g, br)
        decisions = sorted({
            f"{e['kind']}:{e['method']}@r{e['bin_range']}"
            for e in T.get_default_executor().decision_log[log0:]
        })
        say(
            tag,
            json.dumps({
                "n": g.num_nodes, "m": g.num_edges, "bin_range": br,
                "plan": [plan.final_bin_range, list(plan.level_fanouts)],
                "arm_s": times, "vs_B": rels, "l1_vs_f64": l1_vs_f64,
                "decisions": decisions,
            }),
        )
        if ref_cpu is not None:
            rc_ranks, rc_csrs = ref_cpu
            for k in rc_csrs:
                require(same_csr(csrs[k], rc_csrs[k]), f"{tag}: {k} CSR differs from the CPU run")
            for a in "ABCDE":
                ok, rel = close(ranks[a], rc_ranks[a])
                require(ok, f"{tag}: arm {a} differs from the CPU run ({rel})")
        return ranks, csrs, bins

    def cpu_reference(g_cpu):
        br, plan, fns = arms(g_cpu)
        return {a: f() for a, f in fns.items()}, builds(g_cpu, br, plan)

    cache = os.environ["REPRO_TORCH_CACHE_DIR"]
    T.set_default_executor(T.PBExecutor(cache_dir=cache))
    suite = T.graph_suite("bench", device=dev)
    suite_cpu = T.graph_suite("bench", device="cpu")
    refs_cpu = {name: cpu_reference(g) for name, g in suite_cpu.items()}
    s2 = T.gen_uniform(1 << 22, 8, seed=3, device=dev)

    K.reset_launch_counts()  # the main path starts here
    out3 = {}
    for name, g in suite.items():
        out3[name] = run_size(f"phase3 S1 {name}", g, 5, 2, ref_cpu=refs_cpu[name])
    before = K.launch_counts()
    out3["S2"] = run_size("phase3 S2", s2, 5, 2)
    s2_fused = K.launch_counts()["cobra_bin_accumulate"] - before["cobra_bin_accumulate"]
    say(f"phase3 S2 fused launches: {s2_fused}")
    require(s2_fused > 0, "S2: the fused kernel was not launched on the main path")
    s3 = T.gen_uniform(32_000_000, 4, seed=3, device=dev)
    run_size("phase3 S3", s3, 3, 1)
    del s3
    torch.cuda.empty_cache()

    T.set_default_executor(T.PBExecutor(cache_dir=cache, use_pallas=True))
    before = K.launch_counts()
    for name, g in list(suite.items()) + [("S2", s2)]:
        ranks, csrs, bins = run_size(f"phase4 {name}", g, 3, 1, pallas=True)
        r3, c3, b3 = out3[name]
        for k in c3:
            require(same_csr(csrs[k], c3[k]), f"phase4 {name}: {k} CSR differs from phase 3")
        require(all(torch.equal(x, y) for x, y in zip(bins, b3)),
                f"phase4 {name}: binned edges differ from phase 3")
        for a in "ABCDE":
            ok, rel = close(ranks[a], r3[a])
            require(ok, f"phase4 {name}: arm {a} differs from phase 3 ({rel})")
    after = K.launch_counts()  # the main path ends here
    p4 = {k: after[k] - before[k] for k in after}
    say("phase4 launches:", json.dumps(p4))
    require(p4["histogram"] > 0 and p4["counting_positions"] > 0,
            "phase 4 did not launch the histogram and positions kernels")
    require(all(v > 0 for v in after.values()), f"a kernel of the path never launched: {after}")

    # -- phase 5: the kernels line at S2's main-path shapes --------------------
    T.set_default_executor(None)
    n2, br2 = s2.num_nodes, min(max(64, T.compromise_bin_range(s2.num_nodes, hw)), s2.num_nodes)
    nb2 = -(-n2 // br2)
    keys = bin_ids(s2.dst, br2)
    starts = starts_from_counts(ref.histogram_ref(keys, nb2))[:-1].contiguous()
    outdeg = T.degrees_from_coo(s2, by="src").clamp(min=1).float()
    contrib = (torch.full((n2,), 1.0 / n2, device=dev) / outdeg)[s2.src]
    m2 = s2.num_edges

    def lib_add():
        return torch.zeros(n2, device=dev).index_add_(0, s2.dst, contrib)

    # the three kernels once more against their plain versions, at these shapes
    hist_err = int((K.histogram(keys, nb2) - ref.histogram_ref(keys, nb2)).abs().max())
    pos_err = int((K.counting_positions(keys, starts, nb2)
                   - ref.counting_positions_ref(keys, starts, nb2)).abs().max())
    got = K.cobra_bin_accumulate(s2.dst, contrib, n2, br2, nb2)
    want = ref.scatter_reduce_ref(s2.dst, contrib, n2)
    fused_err = float((got - want).abs().max())
    fused_ok = bool(((got - want).abs() <= ADD_TOL * want.abs() + 1e-6).all())  # contrib > 0
    require(hist_err == 0 and pos_err == 0 and fused_ok,
            f"S2 shapes: kernel vs plain: histogram {hist_err}, positions {pos_err}, fused {fused_err}")
    rows = [
        ("histogram", "src/repro_torch/kernels/csrc/histogram.cu",
         "src/repro/kernels/histogram.py:37", max(worst["histogram"], hist_err),
         lambda: K.histogram(keys, nb2), lambda: ref.histogram_ref(keys, nb2),
         lambda: torch.bincount(keys, minlength=nb2), 4 * m2 + 4 * nb2),
        ("counting_positions", "src/repro_torch/kernels/csrc/positions.cu",
         "src/repro/kernels/binning.py:62", max(worst["counting_positions"], pos_err),
         lambda: K.counting_positions(keys, starts, nb2),
         lambda: ref.counting_positions_ref(keys, starts, nb2), None, 8 * m2 + 4 * nb2),
        ("cobra_bin_accumulate", "src/repro_torch/kernels/csrc/fused.cu",
         "src/repro/kernels/fused.py:344", max(worst["cobra_bin_accumulate"], fused_err),
         lambda: K.cobra_bin_accumulate(s2.dst, contrib, n2, br2, nb2),
         lambda: ref.scatter_reduce_ref(s2.dst, contrib, n2), lib_add, 8 * m2 + 4 * n2),
    ]
    kernels = []
    for name, source, replaces, err, kfn, pfn, lfn, nbytes in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": after[name], "checked_against_plain": True, "max_abs_err": err,
            "ms": cuda_ms(kfn), "plain_ms": cuda_ms(pfn),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": cuda_ms(lfn) if lfn is not None else None,
        })
    say(f"phase5 shapes: S2 m={m2} n={n2} bin_range={br2} num_bins={nb2}")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
