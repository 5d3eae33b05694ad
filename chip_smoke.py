#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and ``nvcc``, and
imports only ``repro_torch`` (never JAX or ``repro``). It exits non-zero,
without a result line, when CUDA is unavailable, when the package is not
beside it, or on any mismatch. Each phase prints its seconds. Phases:

1. Device: ``nvidia-smi`` name and power limit, the device properties
   beside ``HardwareModel.h100()``, then the kernels' build (nvcc, sm_90a),
   and the HMMA (tensor-core) instructions that ``cuobjdump -sass`` finds
   in each flash kernel: every bfloat16 one must have them.
2. The first slice's kernels against their plain versions on the card:
   histogram and positions at m in {1, 17, 5000, 2^25} x B in
   {2, 257, 908, 65536} (random and all-one-key streams), and positions
   at m = T - 1, T, T + 1 for the onesweep tile T = 16384 x B in
   {2, 512, 2048, 2049} (both sides of the design switch); the fused
   accumulate for {add, min, max} x {float32, int32} at n = 2^22, m = 2^25
   on uniform indices, the skewed KRON edge stream, a hub stream (half of
   the tuples to one index) and a one-key stream, the last two in both
   designs. Each line names the design that ran (``positions_design``,
   ``fused_design``).
3. The main path, fig5's arms A-E (``benchmarks/fig5_end2end.py``) through
   the port's entry points with the default executor, at S1 (the five
   ``graph_suite("bench")`` graphs, checked against the port on the CPU),
   S2 (``gen_uniform(2^22, 8)``) and S3 (``gen_uniform(32M, 4)``, the
   paper's scale). PB and COBRA CSRs must equal the baseline CSR; arms
   C-E must agree with arm B.
4. The same arms with ``PBExecutor(use_pallas=True)`` plus
   ``build_csr_pb(method="pallas")`` at S1 and S2: CSRs and binned
   streams identical to phase 3's, ranks within tolerance.
5. The second slice's kernels against their plain versions: the rows
   reduce for {add, min, max} x {float32, int32} on S1 KRON's
   destination-sorted stream at F in {1, 8, 32, 128} (and in COO order at
   F = 32) and at S2 with F = 64 (m * F = 2^31); the COBRA pass at every
   level of S2's and S3's ``CobraPlan`` with int32 and float32 values;
   ``scatter_rows`` (float32, bfloat16, int32) and ``binread_scatter_add``
   (float32, bfloat16) at ``benchmarks/embed_grad.py``'s full shapes with
   uniform and zipf ids.
6. The GNN/SpMM path: fig9's three arms (``benchmarks/fig9_spmm.py``:
   the fused row-block reduce on the destination-sorted stream, two-phase
   sort binning + Bin-Read, ``index_add_`` in COO order) on the five S1
   graphs at F in {1, 8, 32, 128}, 8 chained reduce -> gather rounds; the
   arms must agree, and the fused arm with the port on the CPU. Then one
   ``GNNLayer`` (64 -> 64) at S2 for agg in {sum, mean, max}: forward and
   backward to every parameter, held against a float64 version written
   with ``index_add_`` / ``scatter_reduce_``; peak device memory printed.
7. The ``ops`` entry points: ``cobra_binning`` on S2's and S3's edges
   with the H100 plan must equal ``binned_stream_ref`` at the final range;
   ``pb_scatter_add_full`` at embed_grad's full shapes (zipf ids,
   bin_range 4096) against a float64 ``index_add_``.
8. The flash-attention kernels against their plain version: float32 and
   bfloat16, causal and not, at the JAX test's shapes (B, H, KH, S, hd) =
   (1, 2, 1, 128, 16) and (2, 4, 2, 256, 32), at qwen2-1.5b's heads
   (1, 12, 2, S, 128) for S in {1, 7, 500, 513, 2048, 4096}, at
   Sq = 256 against Skv = 512, at qwen-like grouping (2, 12, 2, 300, hd)
   for hd in {16, 32, 64}, and at every Sq, Skv in {1, 15, 63, 65, 127,
   129} (around the 64-row tiles); then where outputs nearly cancel
   (v = +-1 alternating by key), which a bfloat16-rounded P would fail.
   The largest |diff| and share of the tolerance are printed per dtype.
9. The LM serving path: full-size ``qwen2-1.5b`` (28 layers, bf16, random
   weights from seed 0) served by ``Engine`` with 4 slots and 4096
   positions, 8 requests with prompts of 100-2048 tokens (numpy seed 0)
   and 16 new tokens each. Every request must finish, and the flash
   kernel must run once per layer per prefill; tokens/s, decode tokens/s,
   each request's TTFT and the peak device memory are printed. The
   longest prefill and one 4-slot decode tick then run once more under
   ``torch.profiler``: wall time, device busy time, the kernels that take
   it. Then one request served alone must give the tokens and the cache
   of a manual prefill + decode loop.
10. The same model at full width with 2 layers in float32 on the card
   against its copy on the CPU (plain versions): a 300-token prefill's
   last logits and 8 greedy decode steps.
11. The ``kernels`` JSON line: each kernel's launches on the paths of
   phases 3-4, 6, 7 and 9 (counts set to 0 before each path, read after
   it; the checks of phases 2, 5, 8, 10 and 11 do not count), its largest
   error against its plain version, and times at a path's shapes; then
   the result line. Before it: the same launches split by shape, the
   fused accumulate and ``index_add_`` timed at the S1 KRON and DBP
   streams (fig5's S1 PageRank shapes), and a ``torch.profiler`` listing
   of one call of positions and of the fused accumulate at S2, kernel by
   kernel.

Tolerances: integer outputs, CSRs, binned streams, COBRA passes, row
scatters and min/max results must be equal. Float32 PageRank sums run in
an order that differs between arms, devices and runs (atomics). The hub
of the DBP graph receives about half of all edges (1.1M at S1), and
adding a million contributions of similar size to one float32 sum rounds
with a bias that can reach a fraction of an ulp of the sum per addition.
The hub holds about half of the rank mass, so its error spreads to every
vertex (on an H100 the arms differ there by up to about 2e-3 elementwise
and 1e-3 in relative L1 norm; PERF.md).
So ranks agree within rtol 1e-2 elementwise (plus atol 1e-6 of the
largest rank) and within 5e-3 in relative L1 norm; each size also
prints every arm's L1 distance to a float64 PageRank. A float32 add
(fused, rows, Bin-Read) differs from the plain sum by at most about
(k - 1) * 2^-24 * sum|v| at an index that receives k tuples; it is held
to 1e-5 * sum|v| + 1e-6 per entry; ``pb_scatter_add_full`` to that plus
atol 1e-4 (``tests/test_kernels.py:191``), bfloat16 Bin-Read to atol 1e-1
(``tests/test_kernels.py:139``). fig9's arms sum the same rows in other
orders, and the DBP hub sums 1.1M of them into one float32 value, so
arms agree within 1e-2 of the largest output (max |a - b| / max |b|),
for the PageRank reason. The GNN layer is float32 products and sums:
its output is held to 1e-5 and its gradients to 1e-4 times the same
quantity computed on absolute values (the scale of float32 rounding in a
sum, whatever the signs cancel), plus 1e-6. Flash attention against its
plain version, elementwise: float32 atol 1e-4 (``tests/test_kernels.py:217``);
bfloat16 within one bfloat16 rounding step of the plain output,
|got - want| <= 2^-7 |want| + 1e-4, since both round one float32 value
(the floor covers float32 summation order near 0). The reference test's
flat 5e-2 would be as large as a causal output at S = 2048 (about
sqrt(e / S) for unit-normal inputs), so it could not see a dropped key
tile there. The float32 model on the card against
the CPU: logits within 1e-4 of max |logit| per step (sums of 1536 to
8960 float32 products in another order), greedy tokens equal.
"""
from __future__ import annotations

import dataclasses
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
POS_TILE = 16384  # csrc/positions.cu kPosTile: the onesweep tile
F_GRID = (1, 8, 32, 128)  # benchmarks/fig9_spmm.py
ITERS9 = 8  # fig9's chained reduce -> gather rounds at bench scale
SPMM_TOL = 1e-2  # fig9 arms: max |a - b| / max |b|, see the module docstring
GNN_D = 64  # the GNN layer's d_in = d_out at S2
FWD_TOL = 1e-5  # GNN output: times the same sum on absolute values
GRAD_TOL = 1e-4  # GNN gradients: times the same sums on absolute values
EMB_T, EMB_VOCAB, EMB_D = 262_144, 50_304, 256  # benchmarks/embed_grad.py, full scale
EMB_BIN_RANGE = 4096
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor-core rate
FLASH_SHAPES = (  # (B, H, KH, Sq, Skv, hd): the JAX test's, then qwen2-1.5b's heads
    [(1, 2, 1, 128, 128, 16), (2, 4, 2, 256, 256, 32)]
    + [(1, 12, 2, s, s, 128) for s in (1, 7, 500, 513, 2048, 4096)]
    + [(1, 12, 2, 256, 512, 128)]
    # qwen-like grouping at the smaller head dims, lengths around the 64-row
    # tiles (Sq < Skv and Sq > Skv among them)
    + [(2, 12, 2, 300, 300, hd) for hd in (16, 32, 64)]
    + [(1, 12, 2, sq, skv, 128) for sq in (1, 15, 63, 65, 127, 129)
       for skv in (1, 15, 63, 65, 127, 129)]
)
FLASH_CANCEL_SHAPES = [(1, 2, 2, 128, 128, 16), (1, 12, 2, 512, 512, 128),
                       (1, 12, 2, 2048, 2048, 128), (1, 12, 2, 100, 1000, 64)]
FLASH_F32_ATOL = 1e-4  # flash kernel vs plain, float32 (see flash_close)
FLASH_BF16_REL, FLASH_BF16_FLOOR = 2.0**-7, 1e-4  # bfloat16: times |plain| plus the floor
LM_ARCH = "qwen2-1.5b"
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_MAX_NEW = 4, 4096, 8, 16
LM_PROMPT_LENS = (100, 2048)
LM_SEED = 0
LM_TOL = 1e-4  # float32 logits: times max |logit| (tests/test_torch_lm.py)
LM_CPU_PROMPT, LM_CPU_STEPS = 300, 8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def flash_close(got, want, dt):
    """Kernel against plain, elementwise: float32 within atol 1e-4
    (tests/test_kernels.py:217); bfloat16 within one rounding step of the
    plain output, |got - want| <= 2^-7 |want| + 1e-4 (both round one
    float32 value to bfloat16; the floor covers float32 summation order
    near 0). Returns (max |got - want|, the largest share of its
    tolerance that an entry uses, ok)."""
    import torch

    diff = (got.float() - want.float()).abs()
    if dt == torch.float32:
        tol = torch.full_like(diff, FLASH_F32_ATOL)
    else:
        tol = FLASH_BF16_REL * want.float().abs() + FLASH_BF16_FLOOR
    if not diff.numel():
        return 0.0, 0.0, True
    share = float((diff / tol).max())
    return float(diff.max()), share, bool((diff <= tol).all())


def say(*parts) -> None:
    print(*parts, flush=True)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# -- the LM serving path (phases 8-10) -------------------------------------------


def flash_checks(dev, shapes, cancel=False):
    """Phase 8: the flash kernel against its plain version at ``shapes``
    (B, H, KH, Sq, Skv, hd) for float32 and bfloat16, causal and not. With
    ``cancel``, v = +-1 alternating by key, so that every output nearly
    cancels: a kernel that rounded P to bfloat16 once would fail there.
    Returns {dtype: (largest |diff|, largest share of the tolerance)}."""
    import torch

    from repro_torch.kernels.flashattn import flash_attention, flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(8)
    worst = {}
    for B, H, KH, Sq, Skv, hd in shapes:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, Sq, hd, device=dev, generator=gen).to(dt)
            k = torch.randn(B, KH, Skv, hd, device=dev, generator=gen).to(dt)
            if cancel:
                sign = 1.0 - 2.0 * (torch.arange(Skv, device=dev) % 2)
                v = sign[None, None, :, None].expand(B, KH, Skv, hd).to(dt).contiguous()
            else:
                v = torch.randn(B, KH, Skv, hd, device=dev, generator=gen).to(dt)
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                want = flash_attention_ref(q, k, v, causal=causal)
                err, share, close = flash_close(got, want, dt)
                ok = got.shape == q.shape and got.dtype == dt and close
                w = worst.get(str(dt), (0.0, 0.0))
                worst[str(dt)] = (max(w[0], err), max(w[1], share))
                say("phase8", json.dumps({"flash": [B, H, KH, Sq, Skv, hd], "dtype": str(dt),
                                          "causal": causal, "cancel": cancel,
                                          "max_abs_err": err, "tolerance_share": share,
                                          "ok": ok}))
                require(ok, f"flash {dt} causal={causal} cancel={cancel} at "
                            f"{(B, H, KH, Sq, Skv, hd)} differs from plain (max |diff| {err}; "
                            f"see flash_close)")
            del q, k, v, got, want
    return worst


def lm_prompts(cfg, n, lo, hi, seed):
    """``n`` prompts of lengths drawn from [lo, hi], tokens from the vocab."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, cfg.vocab_size, int(s)).astype(np.int32) for s in lens]


def serve_lm(cfg, model, prompts, slots, max_len, max_new):
    """Phase 9: serve ``prompts`` through ``Engine``; flash launches are
    counted over the run alone (the main path), which must prefill each
    prompt once through every layer's kernel. Returns the launch counts
    and the record printed."""
    import torch

    import repro_torch.kernels as K
    from repro_torch.serving.server import Engine, Request
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    dev = model.embed.table.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # warm-up: the first calls of cuBLAS and the allocator, outside the counts
    warm = torch.from_numpy(prompts[0][None, :64]).to(dev)
    _, st = make_prefill_step(cfg, 128)(model, {"tokens": warm})
    make_decode_step(cfg)(model, st, warm[:, :1])
    del st
    sync()
    eng = Engine(cfg, model, slots=slots, max_len=max_len)
    times = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def run(*a):
            sync()
            t0 = time.perf_counter()
            out = fn(*a)
            sync()
            times[kind].append(time.perf_counter() - t0)
            return out
        return run

    eng._prefill = timed("prefill", eng._prefill)
    eng._decode = timed("decode", eng._decode)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()  # the serving path starts here
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=max_new))
    done = eng.run_until_drained()
    sync()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()  # the serving path ends here
    shapes = K.launch_shapes()
    tokens = sum(len(r.out) for r in done)
    decoded = tokens - len(done)  # each request's first token comes from its prefill
    rec = {
        "requests": len(done), "prompt_lens": [len(p) for p in prompts], "tokens": tokens,
        "seconds": secs, "tokens_per_s": tokens / secs,
        "decode_tokens_per_s": decoded / sum(times["decode"]),
        "decode_ticks": len(times["decode"]), "decode_ms_per_tick": [
            1e3 * min(times["decode"]), 1e3 * sum(times["decode"]) / len(times["decode"])],
        "prefill_ms": [1e3 * t for t in times["prefill"]],
        "ttft_s": {r.rid: r.t_first - r.t_submit for r in sorted(done, key=lambda r: r.rid)},
        "max_memory_allocated": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
        "flash_launches": counts["flash_attention"], "final_index": eng.state.index,
        "launch_shapes": shapes,
    }
    require(len(done) == len(prompts) and all(len(r.out) == max_new for r in done),
            f"serving finished {len(done)} of {len(prompts)} requests")
    require(counts["flash_attention"] == cfg.num_layers * len(prompts),
            f"flash launches {counts['flash_attention']} != {cfg.num_layers} layers x "
            f"{len(prompts)} prefills")
    return counts, rec


def device_profile(fn, dev):
    """One call of ``fn`` under ``torch.profiler``: its wall ms (which the
    profiler's own bookkeeping lengthens), the device's busy ms (the sum
    of its kernels' times; one stream, so they do not overlap), the
    number of kernels and the six that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall, "device_busy_ms": busy, "busy_share": busy / wall,
            "kernels": sum(e.count for e in kernels),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top]}


def kernel_profile(fn):
    """Device ms of each kernel (and memset) of one call of ``fn`` under
    ``torch.profiler``, after one call outside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"device_ms": sum(e.self_device_time_total for e in rows) / 1e3,
            "kernels": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                        for e in sorted(rows, key=lambda e: -e.self_device_time_total)]}


def engine_equals_manual_loop(cfg, model, prompt, max_len, max_new):
    """One request served alone (one slot) gives the tokens of a prefill +
    greedy decode loop, token for token (tests/test_serving.py:33-54), and
    leaves the same cache, bit for bit: a random model's greedy tokens
    often repeat, the cache holds every step's keys and values."""
    import torch

    from repro_torch.serving.server import Engine, Request
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    dev = model.embed.table.device
    logits, st = make_prefill_step(cfg, max_len)(model, {"tokens": torch.from_numpy(prompt[None]).to(dev)})
    want = [int(torch.argmax(logits[0]))]
    tok = torch.tensor([[want[-1]]], dtype=torch.int32, device=dev)
    decode = make_decode_step(cfg)
    for _ in range(max_new - 1):
        _, nxt, st = decode(model, st, tok)
        want.append(int(nxt[0]))
        tok = nxt[:, None]
    eng = Engine(cfg, model, slots=1, max_len=max_len)
    eng.submit(Request(rid=0, prompt=prompt, max_new=max_new))
    (r,) = eng.run_until_drained()
    same_cache = all(torch.equal(a, b) for a, b in zip(eng.state.caches, st.caches))
    return r.out, want, same_cache


def lm_vs_cpu(cfg, model, prompt, max_len, steps):
    """Phase 10: the model on its device against a copy on the CPU (plain
    versions): the prefill's last logits and ``steps`` greedy decode steps,
    each side feeding its own tokens. Returns the largest logit error as a
    share of max |logit| and whether every greedy token agreed."""
    import torch

    from repro_torch.models.transformer import DenseLM
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    dev = model.embed.table.device
    cpu = DenseLM(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    prefill, decode = make_prefill_step(cfg, max_len), make_decode_step(cfg)
    toks = torch.from_numpy(prompt[None])
    out = {}
    for name, m, d in (("device", model, dev), ("cpu", cpu, torch.device("cpu"))):
        logits, st = prefill(m, {"tokens": toks.to(d)})
        seq = [logits[0].float().cpu()]
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        toks_out = [int(tok[0, 0])]
        for _ in range(steps):
            lg, nxt, st = decode(m, st, tok)
            seq.append(lg[0].float().cpu())
            tok = nxt[:, None]
            toks_out.append(int(nxt[0]))
        out[name] = (torch.stack(seq), toks_out)
    (a, ta), (b, tb) = out["device"], out["cpu"]
    share = float(((a - b).abs().max(dim=1).values / b.abs().max(dim=1).values).max())
    return share, ta == tb, ta


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        fail("src/repro_torch is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke.py drives the port on an NVIDIA card")
    os.environ.setdefault("REPRO_TORCH_CACHE_DIR", os.path.join(HERE, ".torch_cache"))
    # float32 products in full float32 on the card, as on the CPU (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    import repro_torch.core as T
    import repro_torch.kernels as K
    from repro_torch.core import pb
    from repro_torch.core.executor import execute_reduce
    from repro_torch.core.pb import bin_ids, reduce_identity, starts_from_counts
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels.binning import positions_design
    from repro_torch.kernels.fused import FUSED_DESIGNS, fused_design
    from repro_torch.models import GNNLayer
    from repro_torch.timing import cuda_ms, time_fn

    T0 = time.perf_counter()
    dev = torch.device("cuda")
    hw = T.HardwareModel.h100()

    # -- the GNN/SpMM path's pieces (phase 6) and the embedding inputs -------
    def indeg_of(g):
        return torch.bincount(g.dst, minlength=g.num_nodes).clamp(min=1).float()[:, None]

    def fused_arm(n):
        return lambda idx, v: execute_reduce(
            idx, v, out_size=n, op="add", method="fused", sorted_within=1, in_bounds=True)

    def two_phase_arm(n, r):
        nb = -(-n // r)
        return lambda idx, v: pb.bin_read_scatter_add(
            pb.binning(idx, v, r, nb, method="sort"), n)

    def index_add_arm(n, F):
        return lambda idx, v: torch.zeros(n, F, device=v.device).index_add_(0, idx, v)

    def chained(reduce_fn, idx, v, indeg):
        """fig9's ITERS9 dependent rounds out = reduce(v); v' = out[idx], each
        out divided by the in-degree so values stay finite at the hubs."""
        for _ in range(ITERS9):
            out = reduce_fn(idx, v) / indeg
            v = out.index_select(0, idx)
        return out

    def fig9_values(m):
        gen9 = torch.Generator().manual_seed(9)  # on the CPU: the same rows everywhere
        return {F: torch.randn(m, F, generator=gen9) for F in F_GRID}

    def spread(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    def gnn_layer64(layer, h, rw, csc, agg, chunk=1 << 22):
        """The layer's output and parameter gradients for loss sum(y * rw),
        in float64, by hand: index_add_ / scatter_reduce_ over the CSC's
        edges in chunks, no autograd. Each also on absolute values: the
        scale of its float32 rounding. The max takes the layer's own
        float32 messages (cast up), so that its argmax sets are the port's."""
        f64 = torch.float64
        n, F = h.shape[0], layer.w_msg.shape[1]
        h64 = h.double()
        Wm, Ws, b = (p.detach().double() for p in (layer.w_msg, layer.w_self, layer.b))
        msg = (h @ layer.w_msg).detach().double() if agg == "max" else h64 @ Wm
        E = csc.num_edges
        dst = T.segment_ids_from_offsets(csc.offsets, E)
        src = csc.neighs
        indeg = (csc.offsets[1:] - csc.offsets[:-1]).double()[:, None]
        has = indeg > 0
        spans = [slice(s, min(s + chunk, E)) for s in range(0, E, chunk)]
        if agg == "max":
            aggv = torch.full((n, F), -torch.inf, dtype=f64, device=dev)
            for s in spans:
                aggv.scatter_reduce_(0, dst[s].long()[:, None].expand(-1, F),
                                     msg.index_select(0, src[s]), "amax")
            aggm = torch.where(has, aggv, 0.0)
            agg_abs = aggm.abs()  # a max is exact
        else:
            aggm = torch.zeros(n, F, dtype=f64, device=dev)
            agg_abs = torch.zeros_like(aggm)
            for s in spans:
                rows = msg.index_select(0, src[s])
                aggm.index_add_(0, dst[s], rows)
                agg_abs.index_add_(0, dst[s], rows.abs())
            if agg == "mean":
                aggm /= indeg.clamp(min=1)
                agg_abs /= indeg.clamp(min=1)
        pre = aggm + h64 @ Ws + b
        dy = rw.double() * (pre > 0)
        dagg = dy / indeg.clamp(min=1) if agg == "mean" else dy * has
        dmsg = torch.zeros(n, F, dtype=f64, device=dev)
        dmsg_abs = torch.zeros_like(dmsg)
        for s in spans:
            c = dagg.index_select(0, dst[s])
            if agg == "max":  # every attaining in-neighbour gets the full cotangent
                c *= msg.index_select(0, src[s]) == aggv.index_select(0, dst[s])
            dmsg.index_add_(0, src[s], c)
            dmsg_abs.index_add_(0, src[s], c.abs())
        want = {"y": pre.clamp(min=0), "w_msg": h64.T @ dmsg, "w_self": h64.T @ dy,
                "b": dy.sum(0)}
        scale = {"y": agg_abs + h64.abs() @ Ws.abs() + b.abs(),
                 "w_msg": h64.abs().T @ dmsg_abs, "w_self": h64.abs().T @ dy.abs(),
                 "b": dy.abs().sum(0)}
        return want, scale

    def embed_inputs():
        """embed_grad.py's draws at full scale (seed 0: zipf-like ids, then
        normal rows) and uniform ids (seed 1), on the card."""
        rng = np.random.default_rng(0)
        zipf = np.minimum((rng.pareto(1.2, EMB_T) * 50).astype(np.int64), EMB_VOCAB - 1)
        rows = rng.normal(size=(EMB_T, EMB_D)).astype(np.float32)
        uni = np.random.default_rng(1).integers(0, EMB_VOCAB, EMB_T)
        return {
            "zipf": torch.from_numpy(zipf.astype(np.int32)).to(dev),
            "uniform": torch.from_numpy(uni.astype(np.int32)).to(dev),
            "g": torch.from_numpy(rows).to(dev),
            "bins": -(-EMB_VOCAB // EMB_BIN_RANGE),
        }

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
        if line.startswith("==") or "registers" in line or "spill" in line:
            say("phase1 nvcc:", line.strip())
    # which flash kernels run on the tensor cores: HMMA lines in their SASS
    hmma = {name: body.count("HMMA") for name, body in _lib.kernel_sass("flash_fwd_").items()}
    say("phase1 flash SASS HMMA count:", json.dumps(hmma))
    bf16_hmma = [n for name, n in hmma.items() if "flash_fwd_bf16_kernel" in name]
    require(len(bf16_hmma) == 4 and min(bf16_hmma) > 0,
            f"the bf16 flash kernels do not all run on the tensor cores: {hmma}")

    # -- phase 2: kernels against their plain versions -------------------------
    t2 = time.perf_counter()
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
                            "design": positions_design(B), "max_abs_err": ep,
                            "kernel_ms": cuda_ms(K.counting_positions, keys, starts, B, reps=reps),
                            "plain_ms": cuda_ms(ref.counting_positions_ref, keys, starts, B, reps=reps),
                            "library_ms": None,
                            "bound_ms": bound_ms(8 * m + 4 * B),
                        },
                    }),
                )
                require(eh == 0 and ep == 0, f"histogram/positions differ from plain at m={m} B={B} {stream}")
    for m in (POS_TILE - 1, POS_TILE, POS_TILE + 1):  # around the onesweep tile
        for B in (2, 512, 2048, 2049):  # 2049: the first B of the three-phase design
            keys = torch.randint(-1, B + 1, (m,), device=dev, generator=gen, dtype=torch.int32)
            starts = starts_from_counts(ref.histogram_ref(keys, B))[:-1].contiguous()
            ep = int((K.counting_positions(keys, starts, B)
                      - ref.counting_positions_ref(keys, starts, B)).abs().max())
            worst["counting_positions"] = max(worst["counting_positions"], ep)
            say("phase2", json.dumps({"positions_tile_edge": m, "B": B,
                                      "design": positions_design(B), "max_abs_err": ep}))
            require(ep == 0, f"positions differ from plain at the tile edge m={m} B={B}")

    n, m = 1 << 22, 1 << 25
    r = min(max(64, T.compromise_bin_range(n, hw)), n)
    idx_u = torch.randint(0, n, (m,), device=dev, generator=gen, dtype=torch.int32)
    kron = T.gen_kron(18, 8, seed=2, device=dev)
    idx_hub = idx_u.clone()
    idx_hub[torch.rand(m, device=dev, generator=gen) < 0.5] = 12_345
    streams = [("uniform", idx_u, n, r, [None]),
               ("kron-dst", kron.dst, kron.num_nodes,
                min(max(64, T.compromise_bin_range(kron.num_nodes, hw)), kron.num_nodes), [None]),
               ("hub", idx_hub, n, r, FUSED_DESIGNS),
               ("one-key", torch.full_like(idx_u, n // 3 + 5), n, r, FUSED_DESIGNS)]
    for sname, idx, nn, rr, designs in streams:
        mm = idx.shape[0]
        for dt, design in [(dt, d) for dt in (torch.float32, torch.int32) for d in designs]:
            if dt == torch.float32:
                val = torch.randn(mm, device=dev, generator=gen)
            else:
                val = torch.randint(-50, 50, (mm,), device=dev, generator=gen, dtype=torch.int32)
            reps = 2 if design else 10
            for op in ("add", "min", "max"):
                nb = -(-nn // rr)
                got = K.cobra_bin_accumulate(idx, val, nn, rr, nb, op, design=design)
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
                        "op": op, "design": design or fused_design(mm, nn),
                        "max_abs_err": err, "ok": bool(ok),
                        "kernel_ms": cuda_ms(K.cobra_bin_accumulate, idx, val, nn, rr, nb, op,
                                             design, reps=10),
                        # the library and plain calls serialise on a hub: 15-60 ms each
                        "plain_ms": cuda_ms(ref.scatter_reduce_ref, idx, val, nn, op, reps=reps,
                                            warmup=1),
                        "library_ms": cuda_ms(lib_call, reps=reps, warmup=1),
                        "bound_ms": bound_ms(8 * mm + 4 * nn),
                    }),
                )
                require(ok, f"fused {op} {dt} on {sname} ({design or 'default'} design) "
                            f"differs from plain (max err {err})")
    del idx_u, idx_hub, val, got, want
    say(f"phase2 seconds: {time.perf_counter() - t2:.1f}")

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

    t3 = time.perf_counter()
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
    torch.cuda.empty_cache()
    say(f"phase3 seconds: {time.perf_counter() - t3:.1f}")

    t4 = time.perf_counter()
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
    after_shapes = K.launch_shapes()
    p4 = {k: after[k] - before[k] for k in after}
    say("phase4 launches:", json.dumps(p4))
    require(p4["histogram"] > 0 and p4["counting_positions"] > 0,
            "phase 4 did not launch the histogram and positions kernels")
    first = ("histogram", "counting_positions", "cobra_bin_accumulate")
    require(all(after[k] > 0 for k in first), f"a kernel of the path never launched: {after}")
    say(f"phase4 seconds: {time.perf_counter() - t4:.1f}")

    # -- phase 5: the second slice's kernels against their plain versions ------
    T.set_default_executor(None)
    t5 = time.perf_counter()
    worst.update({"cobra_bin_accumulate_rows": 0.0, "binread_scatter_add": 0.0})

    def rows_check(tag, idx, n, F, dt, op, timed=False):
        m = idx.shape[0]
        if dt == torch.float32:
            val = torch.randn(m, F, device=dev, generator=gen)
        else:
            val = torch.randint(-50, 50, (m, F), device=dev, generator=gen, dtype=torch.int32)
        br = min(512, n)
        got = K.cobra_bin_accumulate_rows(idx, val, n, br, -(-n // br), op)
        want = ref.scatter_reduce_ref(idx, val, n, op)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        if dt == torch.float32 and op == "add":
            scale = ref.scatter_reduce_ref(idx, val.abs(), n, "add")
            ok = bool(((got - want).abs() <= ADD_TOL * scale + 1e-6).all())
        else:
            ok = torch.equal(got, want)
        worst["cobra_bin_accumulate_rows"] = max(worst["cobra_bin_accumulate_rows"], err)
        rec = {"rows": tag, "n": n, "m": m, "F": F, "dtype": str(dt), "op": op,
               "max_abs_err": err, "ok": ok}
        if timed:
            rec.update(
                kernel_ms=cuda_ms(K.cobra_bin_accumulate_rows, idx, val, n, br, -(-n // br), op,
                                  reps=5),
                plain_ms=cuda_ms(ref.scatter_reduce_ref, idx, val, n, op, reps=5),
                bound_ms=bound_ms(4 * m + 4 * m * F + 4 * n * F),
            )
        say("phase5", json.dumps(rec))
        require(ok, f"rows {op} {dt} on {tag} F={F} differs from plain (max err {err})")

    kron_g = suite["KRON"]
    kron_sorted = torch.sort(kron_g.dst, stable=True).values
    for F in F_GRID:
        for dt in (torch.float32, torch.int32):
            for op in ("add", "min", "max"):
                rows_check("S1 KRON dst-sorted", kron_sorted, kron_g.num_nodes, F, dt, op,
                           timed=dt == torch.float32 and op == "add")
    rows_check("S1 KRON coo-order", kron_g.dst, kron_g.num_nodes, 32, torch.float32, "add", True)
    s2_sorted = torch.sort(s2.dst, stable=True).values
    for dt in (torch.float32, torch.int32):
        for op in ("add", "min", "max"):  # m * F = 2^31: 64-bit row offsets
            rows_check("S2 dst-sorted", s2_sorted, s2.num_nodes, GNN_D, dt, op,
                       timed=dt == torch.float32 and op == "add")
    torch.cuda.empty_cache()

    for tag, g in (("S2", s2), ("S3", s3)):
        for rng_ in T.CobraPlan.from_hardware(g.num_nodes, hw).level_ranges():
            nb = -(-g.num_nodes // rng_)
            keys = bin_ids(g.dst, rng_)
            starts = starts_from_counts(ref.histogram_ref(keys, nb))[:-1].contiguous()
            for val in (g.src, torch.randn(g.num_edges, device=dev, generator=gen)):
                got = K.cobra_binning_pass(keys, g.dst, val, starts, nb)
                want = ref.binned_stream_ref(keys, g.dst, val, nb)
                ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                say("phase5", json.dumps({"cobra_pass": tag, "m": g.num_edges, "bin_range": rng_,
                                          "num_bins": nb, "dtype": str(val.dtype), "equal": ok}))
                require(ok, f"COBRA pass on {tag} ({val.dtype}) differs from binned_stream_ref")
            del keys, got, want

    emb = embed_inputs()
    for ids_name in ("uniform", "zipf"):
        ids = emb[ids_name]
        keys = bin_ids(ids, EMB_BIN_RANGE)
        counts = ref.histogram_ref(keys, emb["bins"])
        starts = starts_from_counts(counts)
        pos = ref.counting_positions_ref(keys, starts[:-1].contiguous(), emb["bins"])
        L = max(8, -(-int(counts.max()) // 8) * 8)
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            x = emb["g"].to(dt) if dt != torch.int32 else (emb["g"] * 100).to(dt)
            got = K.scatter_rows(x, pos, ids.shape[0])
            ok = torch.equal(got, ref.scatter_rows_ref(x, pos, ids.shape[0]))
            say("phase5", json.dumps({"scatter_rows": ids_name, "dtype": str(dt), "equal": ok}))
            require(ok, f"scatter_rows {ids_name} {dt} differs from plain")
            if dt == torch.int32:
                continue
            bidx = torch.zeros_like(ids)
            bidx[pos.long()] = ids
            idx_p, val_p = K.ops.padded_bin_layout(
                pb.Bins(bidx, got, starts, EMB_BIN_RANGE), emb["bins"], L)
            b_got = K.binread_scatter_add(idx_p, val_p, EMB_BIN_RANGE)
            b_want = ref.binread_scatter_add_ref(idx_p, val_p, EMB_BIN_RANGE)
            err = float((b_got.double() - b_want.double()).abs().max())
            if dt == torch.float32:  # the float32 add rule
                scale = ref.binread_scatter_add_ref(idx_p, val_p.abs(), EMB_BIN_RANGE)
                ok = bool(((b_got - b_want).abs() <= ADD_TOL * scale + 1e-6).all())
            else:  # bfloat16: atol 1e-1, as tests/test_kernels.py:139 allows
                ok = err <= 1e-1
            worst["binread_scatter_add"] = max(worst["binread_scatter_add"], err)
            say("phase5", json.dumps({"binread": ids_name, "dtype": str(dt), "B": emb["bins"],
                                      "L": L, "d": x.shape[1], "max_abs_err": err, "ok": ok}))
            require(ok, f"binread {ids_name} {dt} differs from plain (max err {err})")
            del idx_p, val_p
    torch.cuda.empty_cache()
    say(f"phase5 seconds: {time.perf_counter() - t5:.1f}")

    # -- phase 6: the GNN/SpMM path: fig9's three arms, then one GNN layer -----
    t6 = time.perf_counter()
    T.set_default_executor(T.PBExecutor(cache_dir=cache))
    K.reset_launch_counts()  # the fig9 path starts here (its CPU reference launches nothing)
    for name, g in suite.items():
        n, m = g.num_nodes, g.num_edges
        order = torch.argsort(g.dst, stable=True)
        dsort = g.dst[order].contiguous()
        indeg = indeg_of(g)
        vals_cpu = fig9_values(m)
        g_cpu = suite_cpu[name]
        dsort_cpu = torch.sort(g_cpu.dst, stable=True).values
        row = {}
        for F in F_GRID:
            vals = vals_cpu[F].to(dev)
            vals_coo = torch.empty_like(vals)
            vals_coo[order] = vals  # the same (index, row) pairs in COO order
            d = T.get_default_executor().decide_or_forced(
                "fused", n, m, torch.float32, kind="reduce", feature_dim=F)
            arms9 = {
                "fused": (fused_arm(n), dsort, vals),
                "two_phase": (two_phase_arm(n, d.bin_range), dsort, vals),
                "index_add": (index_add_arm(n, F), g.dst, vals_coo),
            }
            outs = {a: chained(fn, i, v, indeg) for a, (fn, i, v) in arms9.items()}
            times = {a: time_fn(lambda fn=fn, i=i, v=v: chained(fn, i, v, indeg), reps=3, warmup=1)
                     for a, (fn, i, v) in arms9.items()}
            errs = {a: spread(o, outs["fused"]) for a, o in outs.items() if a != "fused"}
            on_cpu = chained(fused_arm(n), dsort_cpu, vals_cpu[F], indeg_of(g_cpu))
            errs["fused_vs_cpu"] = spread(outs["fused"].cpu(), on_cpu)
            row[F] = {"f_tile": d.f_tile,
                      "ms_per_iter": {a: t / ITERS9 * 1e3 for a, t in times.items()},
                      "rel_err": errs}
            for a, e in errs.items():
                require(e <= SPMM_TOL, f"fig9 {name} F={F}: {a} off by {e} (> {SPMM_TOL})")
        say(f"phase6 fig9 {name}", json.dumps({"n": n, "m": m, "F": row}))
    fig9_counts = K.launch_counts()  # the fig9 path ends here
    fig9_shapes = K.launch_shapes()
    say("phase6 fig9 launches:", json.dumps(fig9_counts))
    require(fig9_counts["cobra_bin_accumulate_rows"] > 0, "fig9: the rows kernel never launched")
    del outs, vals, vals_coo

    csr2, csc2 = T.build_csr_csc(s2)
    hgen = torch.Generator(device=dev).manual_seed(5)
    h2 = torch.randn(s2.num_nodes, GNN_D, device=dev, generator=hgen)
    rw2 = torch.randn(s2.num_nodes, GNN_D, device=dev, generator=hgen)  # the loss's weights
    layer = GNNLayer(GNN_D, GNN_D, generator=torch.Generator().manual_seed(0), device=dev)
    torch.cuda.empty_cache()
    K.reset_launch_counts()  # the GNN layer's path starts here
    for agg in ("sum", "mean", "max"):
        layer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows0 = K.launch_counts()["cobra_bin_accumulate_rows"]
        t0 = time.perf_counter()
        y = layer(h2, csc2, csr2, agg=agg)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        rows1 = K.launch_counts()["cobra_bin_accumulate_rows"]
        t0 = time.perf_counter()
        (y * rw2).sum().backward()
        torch.cuda.synchronize()
        t_bwd = time.perf_counter() - t0
        rows2 = K.launch_counts()["cobra_bin_accumulate_rows"]
        peak = torch.cuda.max_memory_allocated()
        got = {"y": y.detach(), "w_msg": layer.w_msg.grad, "w_self": layer.w_self.grad,
               "b": layer.b.grad}
        del y
        torch.cuda.empty_cache()
        want, scale = gnn_layer64(layer, h2, rw2, csc2, agg)
        errs = {}
        for k in got:
            diff = (got[k].double() - want[k]).abs()
            tol = (FWD_TOL if k == "y" else GRAD_TOL) * scale[k] + 1e-6
            errs[k] = {"max_abs_err": float(diff.max()),
                       "worst_share_of_tol": float((diff / tol).max())}
            require(bool(torch.isfinite(got[k]).all()), f"GNN {agg}: {k} is not finite")
            require(bool((diff <= tol).all()), f"GNN {agg}: {k} differs from float64 ({errs[k]})")
        say(f"phase6 gnn {agg}", json.dumps({
            "n": s2.num_nodes, "m": s2.num_edges, "d": GNN_D, "forward_s": t_fwd,
            "backward_s": t_bwd, "rows_launches": {"forward": rows1 - rows0,
                                                   "backward": rows2 - rows1},
            "max_memory_allocated": peak, "vs_float64": errs}))
        require(rows2 > rows1, f"GNN {agg}: the backward did not launch the rows kernel")
        del got, want, scale
        torch.cuda.empty_cache()
    gnn_counts = K.launch_counts()  # the GNN layer's path ends here
    gnn_shapes = K.launch_shapes()
    say("phase6 gnn launches:", json.dumps(gnn_counts))
    del csr2, csc2, h2, rw2, layer
    torch.cuda.empty_cache()
    say(f"phase6 seconds: {time.perf_counter() - t6:.1f}")

    # -- phase 7: the ops entry points: COBRA binning, embedding scatter-add ----
    t7 = time.perf_counter()
    K.reset_launch_counts()  # the ops path starts here
    for tag, g in (("S2", s2), ("S3", s3)):
        plan = T.CobraPlan.from_hardware(g.num_nodes, hw)
        keys = bin_ids(g.dst, plan.final_bin_range)
        for val in (g.src, torch.randn(g.num_edges, device=dev, generator=gen)):
            t0 = time.perf_counter()
            bins = K.ops.cobra_binning(g.dst, val, plan)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            wi, wv = ref.binned_stream_ref(keys, g.dst, val, plan.num_bins)
            ok = (torch.equal(bins.idx, wi) and torch.equal(bins.val, wv) and torch.equal(
                bins.starts, starts_from_counts(ref.histogram_ref(keys, plan.num_bins))))
            say("phase7", json.dumps({
                "cobra_binning": tag, "m": g.num_edges, "dtype": str(val.dtype),
                "final_bin_range": plan.final_bin_range,
                "pass_bins": [-(-g.num_nodes // r) for r in plan.level_ranges()],
                "seconds": secs, "equal_to_binned_stream_ref": ok}))
            require(ok, f"cobra_binning on {tag} ({val.dtype}) differs from binned_stream_ref")
            del bins, wi, wv
        del keys
    ids, upd = emb["zipf"], emb["g"]
    V = EMB_VOCAB
    t0 = time.perf_counter()
    got = K.ops.pb_scatter_add_full(ids, upd, V, bin_range=EMB_BIN_RANGE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = torch.zeros(V, upd.shape[1], dtype=torch.float64, device=dev).index_add_(
        0, ids, upd.double())
    scale = torch.zeros(V, upd.shape[1], device=dev).index_add_(0, ids, upd.abs())
    diff = (got.double() - want).abs()
    ok = bool((diff <= 1e-4 + ADD_TOL * scale).all())
    rec = {"pb_scatter_add_full": "zipf", "T": ids.shape[0], "V": V, "d": upd.shape[1],
           "bin_range": EMB_BIN_RANGE, "first_call_s": secs, "max_abs_err": float(diff.max()),
           "ok": ok}
    del got, want, scale, diff
    torch.cuda.empty_cache()
    rec["ms"] = cuda_ms(lambda: K.ops.pb_scatter_add_full(ids, upd, V, bin_range=EMB_BIN_RANGE),
                        reps=3, warmup=1)
    rec["index_add_ms"] = cuda_ms(
        lambda: torch.zeros(V, upd.shape[1], device=dev).index_add_(0, ids, upd), reps=10)
    ops_counts = K.launch_counts()  # the ops path ends here (timing launches included)
    ops_shapes = K.launch_shapes()
    say("phase7", json.dumps(rec))
    require(ok, f"pb_scatter_add_full differs from float64 index_add_ ({rec['max_abs_err']})")
    say("phase7 ops launches:", json.dumps(ops_counts))
    for k in ("cobra_binning_pass", "binread_scatter_add", "scatter_rows"):
        require(ops_counts[k] > 0, f"the ops path never launched {k}")
    say(f"phase7 seconds: {time.perf_counter() - t7:.1f}")

    # -- phases 8-10: the LM serving path -----------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.kernels.flashattn import flash_attention_ref, flash_flops, flash_hbm_bytes
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    T.set_default_executor(None)
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    flash_worst = {"random": flash_checks(dev, FLASH_SHAPES),
                   "cancel": flash_checks(dev, FLASH_CANCEL_SHAPES, cancel=True)}
    say("phase8 largest |diff| and share of the tolerance by dtype:", json.dumps(flash_worst))
    worst["flash_attention"] = max(e for w in flash_worst.values() for e, _ in w.values())
    torch.cuda.empty_cache()
    say(f"phase8 seconds: {time.perf_counter() - t8:.1f}")

    t9 = time.perf_counter()
    lm_cfg = get_config(LM_ARCH)
    mem0 = torch.cuda.memory_allocated()  # the earlier phases' tensors, still held
    model = init_params(lm_cfg, seed=LM_SEED, device=dev)
    torch.cuda.synchronize()
    say(f"phase9 {LM_ARCH}: {sum(p.numel() for p in model.parameters())} parameters "
        f"({lm_cfg.param_dtype}, {lm_cfg.num_layers} layers) drawn in "
        f"{time.perf_counter() - t9:.1f} s")
    prompts = lm_prompts(lm_cfg, LM_REQUESTS, *LM_PROMPT_LENS, seed=LM_SEED)
    serve_counts, rec = serve_lm(lm_cfg, model, prompts, LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW)
    serve_shapes = rec.pop("launch_shapes")
    rec["earlier_phases_bytes"] = mem0
    rec["serving_peak_bytes"] = rec["max_memory_allocated"] - mem0  # weights included
    say("phase9 serve", json.dumps(rec))
    say("phase9 serve launches:", json.dumps(serve_counts))
    # where a step's time goes: the longest prefill, and a 4-slot decode tick
    # at the run's final position (decode attends over the whole cache)
    longest = torch.from_numpy(max(prompts, key=len)[None]).to(dev)
    prefill = make_prefill_step(lm_cfg, LM_MAX_LEN)
    prof = {"prefill": {"tokens": longest.shape[1],
                        **device_profile(lambda: prefill(model, {"tokens": longest}), dev)}}
    st = init_cache(lm_cfg, LM_SLOTS, LM_MAX_LEN, device=dev)._replace(index=rec["final_index"])
    tok4 = torch.zeros(LM_SLOTS, 1, dtype=torch.int32, device=dev)
    decode = make_decode_step(lm_cfg)
    prof["decode_tick"] = {"slots": LM_SLOTS, "index": st.index,
                           **device_profile(lambda: decode(model, st, tok4), dev)}
    say("phase9 profile", json.dumps(prof))
    del st, longest
    got, want, same_cache = engine_equals_manual_loop(
        lm_cfg, model, prompts[0], LM_MAX_LEN, LM_MAX_NEW)
    say("phase9 engine vs manual loop:", json.dumps(
        {"engine": got, "manual": want, "same_cache": same_cache}))
    require(got == want and same_cache,
            "the engine differs from a manual prefill + decode loop (tokens or cache)")
    del model
    torch.cuda.empty_cache()
    say(f"phase9 seconds: {time.perf_counter() - t9:.1f}")

    t10 = time.perf_counter()
    cfg32 = dataclasses.replace(lm_cfg, num_layers=2, param_dtype="float32",
                                compute_dtype="float32")
    model32 = init_params(cfg32, seed=LM_SEED + 1, device=dev)
    prompt32 = lm_prompts(cfg32, 1, LM_CPU_PROMPT, LM_CPU_PROMPT, seed=LM_SEED + 1)[0]
    share, same_tokens, toks32 = lm_vs_cpu(cfg32, model32, prompt32, 512, LM_CPU_STEPS)
    say("phase10", json.dumps({"layers": 2, "d_model": cfg32.d_model, "dtype": "float32",
                               "prompt": LM_CPU_PROMPT, "decode_steps": LM_CPU_STEPS,
                               "max_logit_err_share": share, "tolerance": LM_TOL,
                               "tokens": toks32, "tokens_equal": same_tokens}))
    require(share <= LM_TOL and same_tokens,
            f"the float32 model on the card differs from the CPU (share {share}, "
            f"tokens equal {same_tokens})")
    del model32
    torch.cuda.empty_cache()
    say(f"phase10 seconds: {time.perf_counter() - t10:.1f}")

    # -- phase 11: the kernels line at the paths' shapes -------------------------
    t11 = time.perf_counter()
    n2, br2 = s2.num_nodes, min(max(64, T.compromise_bin_range(s2.num_nodes, hw)), s2.num_nodes)
    nb2 = -(-n2 // br2)
    keys = bin_ids(s2.dst, br2)
    starts = starts_from_counts(ref.histogram_ref(keys, nb2))[:-1].contiguous()
    outdeg = T.degrees_from_coo(s2, by="src").clamp(min=1).float()
    contrib = (torch.full((n2,), 1.0 / n2, device=dev) / outdeg)[s2.src]
    m2 = s2.num_edges

    def lib_add():
        return torch.zeros(n2, device=dev).index_add_(0, s2.dst, contrib)

    # each kernel once more against its plain version, at the shapes it is timed at
    hist_err = int((K.histogram(keys, nb2) - ref.histogram_ref(keys, nb2)).abs().max())
    pos_err = int((K.counting_positions(keys, starts, nb2)
                   - ref.counting_positions_ref(keys, starts, nb2)).abs().max())
    got = K.cobra_bin_accumulate(s2.dst, contrib, n2, br2, nb2)
    want = ref.scatter_reduce_ref(s2.dst, contrib, n2)
    fused_err = float((got - want).abs().max())
    fused_ok = bool(((got - want).abs() <= ADD_TOL * want.abs() + 1e-6).all())  # contrib > 0
    require(hist_err == 0 and pos_err == 0 and fused_ok,
            f"S2 shapes: kernel vs plain: histogram {hist_err}, positions {pos_err}, fused {fused_err}")

    # rows: the GNN forward's stream at S2 (dst-sorted, F = 64)
    rows_v = torch.randn(m2, GNN_D, device=dev, generator=gen)
    got = K.cobra_bin_accumulate_rows(s2_sorted, rows_v, n2, 512, -(-n2 // 512))
    want = ref.scatter_reduce_ref(s2_sorted, rows_v, n2)
    scale = ref.scatter_reduce_ref(s2_sorted, rows_v.abs(), n2)
    rows_err = float((got - want).abs().max())
    require(bool(((got - want).abs() <= ADD_TOL * scale + 1e-6).all()),
            f"rows at S2 F={GNN_D} differs from plain ({rows_err})")
    del got, want, scale
    # COBRA pass: S3's first pass
    r3 = T.CobraPlan.from_hardware(s3.num_nodes, hw).level_ranges()[0]
    nb3 = -(-s3.num_nodes // r3)
    keys3 = bin_ids(s3.dst, r3)
    starts3 = starts_from_counts(ref.histogram_ref(keys3, nb3))[:-1].contiguous()
    got = K.cobra_binning_pass(keys3, s3.dst, s3.src, starts3, nb3)
    want = ref.binned_stream_ref(keys3, s3.dst, s3.src, nb3)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "COBRA pass at S3's first level differs from plain")
    del got, want
    m3 = s3.num_edges
    # binread and scatter_rows: the embedding gradient's zipf stream, float32
    ids = emb["zipf"]
    ekeys = bin_ids(ids, EMB_BIN_RANGE)
    ecounts = ref.histogram_ref(ekeys, emb["bins"])
    estarts = starts_from_counts(ecounts)
    epos = ref.counting_positions_ref(ekeys, estarts[:-1].contiguous(), emb["bins"])
    x = emb["g"]
    srows = K.scatter_rows(x, epos, ids.shape[0])
    require(torch.equal(srows, ref.scatter_rows_ref(x, epos, ids.shape[0])),
            "scatter_rows at the embedding shapes differs from plain")
    bidx = torch.zeros_like(ids)
    bidx[epos.long()] = ids
    L = max(8, -(-int(ecounts.max()) // 8) * 8)
    idx_p, val_p = K.ops.padded_bin_layout(
        pb.Bins(bidx, srows, estarts, EMB_BIN_RANGE), emb["bins"], L)
    B_, d_ = emb["bins"], x.shape[1]
    got = K.binread_scatter_add(idx_p, val_p, EMB_BIN_RANGE)
    want = ref.binread_scatter_add_ref(idx_p, val_p, EMB_BIN_RANGE)
    scale = ref.binread_scatter_add_ref(idx_p, val_p.abs(), EMB_BIN_RANGE)
    require(bool(((got - want).abs() <= ADD_TOL * scale + 1e-6).all()),
            "binread at the embedding shapes differs from plain")
    del got, want, scale
    T_ = ids.shape[0]
    rows = [
        ("histogram", "src/repro_torch/kernels/csrc/histogram.cu",
         "src/repro/kernels/histogram.py:37", max(worst["histogram"], hist_err),
         lambda: K.histogram(keys, nb2), lambda: ref.histogram_ref(keys, nb2),
         lambda: torch.bincount(keys, minlength=nb2), 4 * m2 + 4 * nb2),
        ("counting_positions", "src/repro_torch/kernels/csrc/positions.cu",
         "src/repro/kernels/binning.py:62", max(worst["counting_positions"], pos_err),
         lambda: K.counting_positions(keys, starts, nb2),
         lambda: ref.counting_positions_ref(keys, starts, nb2), None, 8 * m2 + 4 * nb2),
        ("cobra_binning_pass", "src/repro_torch/kernels/csrc/cobra_pass.cu",
         "src/repro/kernels/binning.py:182", 0,
         lambda: K.cobra_binning_pass(keys3, s3.dst, s3.src, starts3, nb3),
         lambda: ref.binned_stream_ref(keys3, s3.dst, s3.src, nb3), None, 20 * m3 + 4 * nb3),
        ("cobra_bin_accumulate", "src/repro_torch/kernels/csrc/fused.cu",
         "src/repro/kernels/fused.py:344", max(worst["cobra_bin_accumulate"], fused_err),
         lambda: K.cobra_bin_accumulate(s2.dst, contrib, n2, br2, nb2),
         lambda: ref.scatter_reduce_ref(s2.dst, contrib, n2), lib_add, 8 * m2 + 4 * n2),
        ("cobra_bin_accumulate_rows", "src/repro_torch/kernels/csrc/fused_rows.cu",
         "src/repro/kernels/fused.py:263", max(worst["cobra_bin_accumulate_rows"], rows_err),
         lambda: K.cobra_bin_accumulate_rows(s2_sorted, rows_v, n2, 512, -(-n2 // 512)),
         lambda: ref.scatter_reduce_ref(s2_sorted, rows_v, n2),
         lambda: torch.zeros(n2, GNN_D, device=dev).index_add_(0, s2_sorted, rows_v),
         4 * m2 + 4 * m2 * GNN_D + 4 * n2 * GNN_D),
        ("binread_scatter_add", "src/repro_torch/kernels/csrc/binread.cu",
         "src/repro/kernels/binread.py:36", worst["binread_scatter_add"],
         lambda: K.binread_scatter_add(idx_p, val_p, EMB_BIN_RANGE),
         lambda: ref.binread_scatter_add_ref(idx_p, val_p, EMB_BIN_RANGE), None,
         4 * B_ * L + 4 * T_ * d_ + 4 * B_ * EMB_BIN_RANGE * d_),  # only real rows are read
        ("scatter_rows", "src/repro_torch/kernels/csrc/scatter_rows.cu",
         "src/repro/kernels/scatter_rows.py:37", 0,
         lambda: K.scatter_rows(x, epos, T_), lambda: ref.scatter_rows_ref(x, epos, T_),
         lambda: torch.zeros(T_, d_, device=dev).index_copy_(0, epos.long(), x),
         4 * T_ + 8 * T_ * d_),
    ]
    path = {k: after[k] + fig9_counts[k] + gnn_counts[k] + ops_counts[k] + serve_counts[k]
            for k in after}
    path_shapes = {}
    for part in (after_shapes, fig9_shapes, gnn_shapes, ops_shapes, serve_shapes):
        for k, by in part.items():
            for shp, c in by.items():
                path_shapes.setdefault(k, {})[shp] = path_shapes.get(k, {}).get(shp, 0) + c
    say("phase11 launches by shape (key: histogram, positions, COBRA pass m,B; fused m,n; "
        "rows m,F,n; Bin-Read B,L,d; row scatter m,d; flash B,H,KH,Sq,Skv,hd):",
        json.dumps(path_shapes))
    # the fused accumulate where most of its launches are: fig5's S1 PageRank streams
    for name in ("KRON", "DBP"):
        g = suite[name]
        n1 = g.num_nodes
        br1 = min(max(64, T.compromise_bin_range(n1, hw)), n1)
        c1 = (torch.full((n1,), 1.0 / n1, device=dev)
              / T.degrees_from_coo(g, by="src").clamp(min=1).float())[g.src]
        # the DBP hub sums about a million float32 terms: the PageRank rule
        ok, rel = close(K.cobra_bin_accumulate(g.dst, c1, n1, br1, -(-n1 // br1)),
                        ref.scatter_reduce_ref(g.dst, c1, n1))
        require(ok, f"fused at S1 {name} differs from plain ({rel})")
        say("phase11 S1", json.dumps({
            "graph": name, "m": g.num_edges, "n": n1, "design": fused_design(g.num_edges, n1),
            "fused_ms": {d: cuda_ms(lambda d=d: K.cobra_bin_accumulate(
                g.dst, c1, n1, br1, -(-n1 // br1), design=d), reps=20) for d in FUSED_DESIGNS},
            "index_add_ms": cuda_ms(lambda: torch.zeros(n1, device=dev).index_add_(0, g.dst, c1),
                                    reps=20)}))
    say("phase11 profile", json.dumps({
        "counting_positions": {"m": m2, "B": nb2, "design": positions_design(nb2),
                               **kernel_profile(lambda: K.counting_positions(keys, starts, nb2))},
        "cobra_bin_accumulate": {"m": m2, "n": n2, "design": fused_design(m2, n2),
                                 **kernel_profile(lambda: K.cobra_bin_accumulate(
                                     s2.dst, contrib, n2, br2, nb2))}}))
    kernels = []
    designs = {"counting_positions": positions_design(nb2),
               "cobra_bin_accumulate": fused_design(m2, n2)}
    for name, source, replaces, err, kfn, pfn, lfn, nbytes in rows:
        reps = 5 if name in ("cobra_binning_pass", "binread_scatter_add") else 20
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path[name], "checked_against_plain": True, "max_abs_err": err,
            "ms": cuda_ms(kfn, reps=reps), "plain_ms": cuda_ms(pfn, reps=reps),
            "bound_ms": bound_ms(nbytes), "bound_bytes": nbytes, "bound_by": "bytes",
            "library_ms": cuda_ms(lfn, reps=reps) if lfn is not None else None,
            **({"design": designs[name]} if name in designs else {}),
        })
    # flash: the longest prefill's attention, qwen2-1.5b's heads at S = 4096, bf16, causal
    fB, fH, fKH, fS, fhd = 1, lm_cfg.num_heads, lm_cfg.num_kv_heads, LM_MAX_LEN, lm_cfg.head_dim
    fq = torch.randn(fB, fH, fS, fhd, device=dev, generator=gen).to(torch.bfloat16)
    fk = torch.randn(fB, fKH, fS, fhd, device=dev, generator=gen).to(torch.bfloat16)
    fv = torch.randn(fB, fKH, fS, fhd, device=dev, generator=gen).to(torch.bfloat16)
    ferr, _, fok = flash_close(K.flash_attention(fq, fk, fv), flash_attention_ref(fq, fk, fv),
                               torch.bfloat16)
    require(fok, f"flash at the timing shape differs from plain (max |diff| {ferr}; see flash_close)")
    fflop = flash_flops(fB, fH, fS, fS, fhd, causal=True)
    fbytes = 2 * (2 * fB * fH * fS * fhd + 2 * fB * fKH * fS * fhd)  # q, o, k, v once each
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flashattn.cu",
        "replaces": "src/repro/kernels/flashattn.py:61", "launches": path["flash_attention"],
        "checked_against_plain": True, "max_abs_err": max(worst["flash_attention"], ferr),
        "ms": cuda_ms(lambda: K.flash_attention(fq, fk, fv), reps=20),
        "plain_ms": cuda_ms(lambda: flash_attention_ref(fq, fk, fv), reps=5),
        "bound_ms": max(fflop / BF16_FLOP_PER_S, fbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_flop": fflop, "bound_bytes": fbytes,
        "bound_by": "operations" if fflop / BF16_FLOP_PER_S > fbytes / HBM_BYTES_PER_S else "bytes",
        "flash_hbm_bytes": flash_hbm_bytes(fB, fH, fKH, fS, fS, fhd),
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            fq, fk, fv, is_causal=True, enable_gqa=True), reps=20),
    })
    require(all(k["launches"] > 0 for k in kernels), f"a kernel never launched on a path: {path}")
    say(f"phase11 shapes: S2 m={m2} n={n2} bin_range={br2} num_bins={nb2}; rows F={GNN_D}; "
        f"COBRA pass S3 m={m3} bins={nb3}; embedding T={T_} d={d_} B={B_} L={L}; "
        f"flash B={fB} H={fH} KH={fKH} S={fS} hd={fhd} bf16 causal")
    say(f"phase11 seconds: {time.perf_counter() - t11:.1f}; whole run {time.perf_counter() - T0:.1f} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
