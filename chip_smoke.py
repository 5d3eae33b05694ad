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
   {2, 512, 2048, 2049} (both sides of the design switch); the histogram
   on skewed streams of 2^25 keys (a hub taking half of them, the
   embedding gradient's zipf ids at 13 bins, keys outside [0, B) with
   negatives) and on the embedding stream itself, each also from a view
   one key off a 16-byte boundary; the fused
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
   C-E must agree with arm B. At S3 arm E runs the two-pass fused kernel
   (the H100 model's fit rule): it must have launched there; its time is
   printed beside arm B's and the 348.960 ms it took on the hierarchical
   path, with the decisions, the peak device memory and a
   ``torch.profiler`` listing of the whole arm.
4. The same arms with ``PBExecutor(use_pallas=True)`` plus
   ``build_csr_pb(method="pallas")`` at S1 and S2: CSRs and binned
   streams identical to phase 3's, ranks within tolerance.
5. The second slice's kernels against their plain versions: the rows
   reduce for {add, min, max} x {float32, int32} on S1 KRON's
   destination-sorted stream at F in {1, 8, 32, 128} (and in COO order at
   F = 32) and at S2 with F = 64 (m * F = 2^31), and float32 add on the
   EURO and HBUBL streams (fig9's other two lengths) at every F: each
   float32 add is timed (events), with ``index_add_`` as its library
   time, its bound, and its kernel's device time from ``torch.profiler``
   (at F = 1 the event-timed loop measures the host); the COBRA pass in both
   designs (onesweep, three-phase: ``cobra_pass_design``) at every level
   of S2's and S3's ``CobraPlan`` with int32 and float32 values, and on
   one-key and hub streams of S3's length at 2,203 bins;
   ``scatter_rows`` (float32, bfloat16, int32) and ``binread_scatter_add``
   (float32, bfloat16) at ``benchmarks/embed_grad.py``'s full shapes with
   uniform and zipf ids; Bin-Read timed beside ``index_add_`` of the
   compact stream (``compact_index_add_ms``) and its bound.
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
12. (Runs before phase 11.) The traversal path through the port's entry
   points (``benchmarks/fig8_traversal.py``, ``fig2_preproc_cost.py``):
   ``bfs`` with parents, ``sssp`` (weights from numpy seed 8, uniform in
   [0.1, 1.1)), ``k_core`` (k = 3), ``connected_components_fused`` and
   ``_pb`` (run to convergence: ``max_iters`` = n), ``radii`` (k = 4,
   300 levels), ``bfs_batched`` (with parents) and ``sssp_batched`` from
   8 sources and ``personalized_pagerank`` from the same 8 (the source
   is the vertex of largest out-degree, the batch the 8 largest), under
   the default executor, BFS and CC-PB also under ``use_pallas=True``,
   on the five S1 graphs and S2, and BFS and CC at S3. At S1 each result
   must equal the port's run on the CPU; at every size BFS levels and
   parents must equal a dense plain-torch BFS (parent: the largest-id
   predecessor on the previous level), CC labels scipy's weak components
   (labelled by their smallest vertex), k-core ``k_core_oracle``; at S2
   each batched lane must equal its single-source run and SSSP scipy's
   Dijkstra in float64. S2 and S3 print ``timing.time_fn`` times beside
   ``method="unbinned"`` (for CC: ``connected_components``, the
   random-order baseline), levels, the per-level decision trace
   (``L<level>:<method>@2^<bucketed length>``) and the peak device
   memory; S2 also each BFS level's reduce on its padded stream and on
   its real tuples only.
13. (Runs before phase 11.) Graph-query serving (``launch/serve_graphs.py``'s
   path): ``GraphFrontend.register_graph`` of S1's DBP and KRON and S2
   (degree_sort; the preprocessing pipeline, each stage's seconds,
   modeled bytes and decisions printed), and S2 once more under
   ``use_pallas=True`` (histogram and positions must launch); each
   ``new_ids`` must be a permutation in non-increasing degree, the CSR
   equal ``build_csr_baseline(relabel_coo(...))`` and ``slack.to_csr()``
   the CSR. Then warmup and a seeded 64-query ``make_query_mix`` trace
   (200 queries/s, max_batch 8) replayed on a FakeClock twice (tick logs
   and latencies identical), with max_batch 1 (BFS/SSSP/k-core answers
   equal, PPR/PageRank to the PageRank tolerance), and on the real clock
   (throughput, p50/p99, mean batch). Four S2 update queries of 4096
   edges (``random_edge_batch``, 10% deletes; each batch also timed
   alone through ``apply_edge_batch``) must leave epoch 4 and the edge
   multiset of ``build_csr(merge_batch_coo(...))``, and make the
   PageRank memo recompute; a forced ``rebuild_slack_csr`` must keep the
   graph, and ``bfs_incremental`` after an insert-only batch equal a
   full ``bfs``. The fused kernels must launch in this phase.
14. (Runs before phase 11.) LM training (``launch/train.py``'s path).
   a) ``_pb_take``'s backward at the training shape: 4 x 4096
   Markov-synthetic ids (``SyntheticLM``), bfloat16 cotangent rows of
   1536 into the 152,064-row padded vocabulary, through autograd (it must
   launch the rows kernel) and through ``execute_reduce``, held to a
   float64 ``index_add_`` (and the bfloat16 table gradient to one
   bfloat16 rounding of it); timed beside ``index_add_`` and its bound,
   with a profile (the output's fill and the kernel). b) Flash attention's
   q, k, v gradients (the kernel's forward, the plain function's float32
   backward by query blocks) on the card against the CPU at (B, H, KH, S,
   hd) = (1, 12, 2, 1024, 128), causal, float32 and bfloat16. c) One
   AdamW step of a 2-layer full-width float32 copy on the card and on the
   CPU from one state (S = 256). d) ``launch/train.py`` at full width,
   28 layers in bfloat16 with remat and AdamW, B 4, S 4096 (train_4k's
   sequence; its global batch of 256 cut to 4 for one card): 3 steps
   with a checkpoint every 2 and at the end, the checkpoint restored and
   compared bit for bit with the state, then a resume to step 4, and one
   more step under ``torch.profiler``. Losses and grad norms must be
   finite, every moment must have moved (attention's key bias aside: its
   gradient is rounding, see ``_scale_name``), and each step must launch
   the rows kernel and the flash kernel for every layer. Printed: ms per
   step, tokens/s, model FLOP/s (6 N per token) beside 989 TFLOP/s, peak
   memory, the profile, the card's name and power limit.
15. (Runs before phase 11.) MoE serving: ``qwen3-moe-235b-a22b`` at full
   width (d 4096, 64/4 heads of 128, 128 experts of d_ff 1536, top-8,
   vocab 151,936) with 8 of its 94 layers, bfloat16 weights from a seeded
   generator, counting dispatch (histogram + positions kernels). Checks:
   (a) ``sort`` and ``counting`` dispatch route bit for bit at 2048 and 4
   tokens, with equal layer outputs; (b) one layer against
   ``_moe_dense_oracle`` at 256 tokens, capacity factor 16 (no drops);
   (c) flash at 64 query heads over 4 KV heads against its plain version,
   and the histogram, positions, row scatter and rows kernel (bfloat16
   and float32) against theirs at the longest prefill's shapes; (d) the
   engine against a manual prefill + decode loop; (e) a 2-layer float32
   copy with 16 experts on the card against the CPU; (f) in the serve
   (``Engine``, 4 slots, 8 requests of 256-1024 prompt tokens, 32 new
   each, 2048 positions) the rows, histogram, positions and row-scatter
   kernels launch once per layer per forward call and flash once per
   layer per prefill. Printed: prefill tokens/s, decode ms a tick and
   tokens/s, peak memory, a profile of the longest prefill and a decode
   tick (device busy share, ms by kernel kind), dropped assignments and
   top-k ties per layer, and one layer's dispatch, expert-FFN and combine
   ms at prefill and decode.
11. The ``kernels`` JSON line: each kernel's launches on the paths of
   phases 3-4, 6, 7, 9, 12, 13, 14 and 15 (counts set to 0 before each
   path, read after it; the checks of phases 2, 5, 8, 10, 11, 14a-c and
   15a-e do not count), its largest error against its plain version, and
   times at a path's shapes (Bin-Read's row also ``compact_index_add_ms``,
   the rows kernel's an ``embedding_backward`` record at phase 14's
   shape), then rows 2b, 5c, 7b and 8b (``<kernel>:moe_...``): positions,
   the bfloat16 rows kernel, the row scatter and flash at phase 15's
   shapes with phase 15's launches; then the result line. Before it: the
   same launches split by shape, the fused accumulate and ``index_add_``
   timed at the S1 KRON and DBP streams (fig5's S1 PageRank shapes), and a
   ``torch.profiler`` listing of one call of positions and of the fused
   accumulate at S2, kernel by kernel. Every profile opens and closes its
   window with ``PROFILE_GUARD_MS`` or more of spin kernels, which the
   listings leave out, and fails the run when it finds no CUDA row.

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
8960 float32 products in another order), greedy tokens equal. Training
(phase 14): flash gradients are held to the forward's rule (both sides
compute the plain function's gradient in float32; bfloat16 rounds it
once); the float32 step's loss to rtol 1e-5, each gradient and moment
within 1e-4 of its tensor's max (the key bias's of the key weight's),
parameters within 2 lr_1 plus two float32 roundings (AdamW's first step
moves a parameter by about lr in the sign of its gradient, and a
gradient that is 0 up to rounding can take either sign).
MoE (phase 15): the dispatch is integer routing and equal bit for bit;
the row scatter and histogram/positions are exact; the bfloat16 rows
kernel is a float32 sum rounded once, within one bfloat16 step (at most
2^-7 relative) of the plain version's plus the float32 add tolerance; the
layer against the dense oracle within 2^-8 of the sum of its terms'
magnitudes (``moe_oracle_check``, which also shows that the limit rejects
a combine that drops one assignment); the float32 copy against the CPU
as phase 10.
Traversal (phase 12): levels, parents, labels, k-core membership,
eccentricities and SSSP distances are exact (integer and min/max
reductions; an SSSP distance is one float32 add per hop, then an exact
min), so the card equals the CPU bit for bit; PPR sums float32 and is
held to the PageRank tolerance. Against float64 Dijkstra, a float32
distance is a float32 sum along a path of k hops, each add rounding by
at most 2^-24 of its partial sum, so it is within about k * 2^-24 of the
exact distance, relatively; k is at most the number of rounds or d /
0.1 (the lightest weight), and the check allows k * 2^-23 * d.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
PROFILE_GUARD_MS = 20.0  # least spin time before and after a profiled call (_profiled)
PROFILE_SPIN_MS = 1.0  # one spin kernel of the guard
_PROFILE_CLOCK = {"cycles_per_ms": None, "lost_ms": 0.0}  # _spin_rate, the largest loss
LM_ARCH = "qwen2-1.5b"
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_MAX_NEW = 4, 4096, 8, 16
LM_PROMPT_LENS = (100, 2048)
LM_SEED = 0
LM_TOL = 1e-4  # float32 logits: times max |logit| (tests/test_torch_lm.py)
LM_CPU_PROMPT, LM_CPU_STEPS = 300, 8
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_LAYERS = 8  # of its 94: 8 layers' experts are 38.7 GB in bfloat16
MOE_SEED = 15
MOE_SLOTS, MOE_MAX_LEN, MOE_REQUESTS, MOE_MAX_NEW = 4, 2048, 8, 32
MOE_PROMPT_LENS = (256, 1024)
MOE_DISPATCH_T = (2048, 4)  # check (a): a prefill of max_len tokens and a 4-slot decode tick
MOE_ORACLE_T = 256  # check (b): capacity_factor 16 gives C = T, so nothing drops
MOE_BF16_TOL = 2.0**-8  # check (b): times the sum of |terms| (moe_oracle_check)
MOE_FLASH_SHAPES = [(1, 64, 4, S, S, 128) for S in (256, 1000, 2048)]  # qwen3-moe's heads
MOE_CPU_EXPERTS = 16  # check (e): 2 float32 layers at full width, 16 experts, on both devices
TRAIN_B, TRAIN_S = 4, 4096  # train_4k's sequence; its global batch of 256 cut to 4 for one card
TRAIN_STEPS = 3  # then one more from the checkpoint
TRAIN_CPU_S = 256  # phase 14's card-vs-CPU step: 2 float32 layers, B 1
TRAIN_TOL = 1e-4  # card vs CPU gradients and moments: times the tensor's max
FLASH_GRAD_SHAPE = (1, 12, 2, 1024, 128)  # (B, H, KH, S, hd): qwen2-1.5b's heads
S3_ARM_E_HIERARCHICAL_S = 0.348960  # S3 arm E on the hierarchical path (PERF.md, section 5)
INT32_MAX = 2**31 - 1
F32_MAX = 3.4028234663852886e38  # float32's largest value: SSSP's unreached distance
KCORE_K = 3  # benchmarks/fig8_traversal.py
RADII_K, RADII_ITERS = 4, 300  # benchmarks/fig2_preproc_cost.py
TRAV_BATCH = 8  # sources of the batched BFS/SSSP and of PPR
TRAV_REPS = 3  # time_fn repetitions of the traversal phase
SERVE_REQUESTS = 64  # phase 13's trace: make_query_mix, Poisson arrivals
SERVE_RATE = 200.0  # queries per second (launch/serve_graphs.py's default)
SERVE_BATCH = 8  # max_batch (launch/serve_graphs.py's default)
SERVE_TICK = 0.02  # FakeClock seconds a tick: arrivals (every 5 ms) queue and coalesce
SERVE_SEED = 0
UPDATE_BATCH = 4096  # edges a batch, 10% of them deletes
UPDATE_BATCHES = 4
SSSP_EPS = 2.0**-23  # per hop, relative: twice float32's unit roundoff
SSSP_W_MIN = 0.1  # the lightest weight (fig8: uniform in [0.1, 1.1))


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


def pr_close(x, y):
    """The PageRank tolerance: elementwise rtol PR_RTOL (atol 1e-6 of the
    largest value) and PR_L1 in relative L1 norm; (ok, the errors)."""
    import torch

    x, y = x.double().cpu(), y.double().cpu()
    rel = float(((x - y).abs() / y.abs().clamp(min=1e-30)).max())
    l1 = float((x - y).abs().sum() / y.abs().sum())
    ok = torch.allclose(x, y, rtol=PR_RTOL, atol=1e-6 * float(y.abs().max())) and l1 <= PR_L1
    return ok, {"max_rel": rel, "l1_rel": l1}


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


def _spin_rate(dev) -> float:
    """Clock cycles per ms of a spin kernel (``torch.cuda._sleep``), from
    CUDA events around a 20M-cycle spin the first time."""
    import torch

    if _PROFILE_CLOCK["cycles_per_ms"] is None:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        _PROFILE_CLOCK["cycles_per_ms"] = 20_000_000 / a.elapsed_time(b)
    return _PROFILE_CLOCK["cycles_per_ms"]


def _profiled(fn, dev):
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA), between
    a lead and a trail of spin kernels. Returns (the profile, the call's
    wall ms, the guard: the lead's and trail's ms, how many of their spin
    records the profiler dropped, and the host ms each loss reached from
    the window's opening or to its close).

    The guard is the repair of an empty ``kernel_profile`` (PERF.md §7).
    On the H100 the profiler drops the device records of a window's
    first D ms, or of its last, as device and host clocks part; D varies
    from window to window and grows over a process's life (44 ms late in
    one whole ``chip_smoke.py`` run), so short calls were lost whole.
    Lead and trail are series of ``PROFILE_SPIN_MS`` spins, each
    synchronised, for ``PROFILE_GUARD_MS`` or twice the largest D seen,
    whichever is longer, with a short marker spin right before the call
    and a longer one right after it. When a marker's record is missing,
    D reached the call: it is profiled again with a longer guard, at
    most four times, then the run fails. ``_cuda_rows`` leaves the spin
    kernels out of the listings."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spin = int(PROFILE_SPIN_MS * _spin_rate(dev))  # cycles

    def spins(guard_ms, t_from):  # host ms since t_from at each spin's launch
        launched = []
        while not launched or launched[-1] - launched[0] < guard_ms:
            launched.append((time.perf_counter() - t_from) * 1e3)
            torch.cuda._sleep(spin)
            torch.cuda.synchronize(dev)
        return launched

    for _ in range(5):
        guard_ms = max(PROFILE_GUARD_MS, 2 * _PROFILE_CLOCK["lost_ms"])
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_open = time.perf_counter()
            lead = spins(guard_ms, t_open)
            torch.cuda._sleep(spin // 20)  # the marker before the call
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            torch.cuda._sleep(spin // 4)  # the marker after it
            torch.cuda.synchronize(dev)
            trail = spins(guard_ms, t1)
            t_close = time.perf_counter()
        recs = sorted((e.start_ns(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA and "spin_kernel" in e.name())
        short = [(t, d) for t, d in recs if d < PROFILE_SPIN_MS / 8]  # before the call
        mid = [(t, d) for t, d in recs if PROFILE_SPIN_MS / 8 <= d < 0.6 * PROFILE_SPIN_MS]
        full = [t for t, d in recs if d >= 0.6 * PROFILE_SPIN_MS]
        kept_lead = sum(t < short[0][0] for t in full) if short else 0
        kept_trail = sum(t > mid[0][0] for t in full) if mid else 0
        lead_lost = len(lead) - kept_lead + (not short)
        trail_lost = len(trail) - kept_trail + (not mid)
        t_call = (t0 - t_open) * 1e3
        lost_start = (lead + [t_call])[len(lead) - kept_lead] if short else t_call
        lost_end = (t_close - t1) * 1e3 - ([0.0] + trail)[kept_trail] if mid else (t_close - t1) * 1e3
        _PROFILE_CLOCK["lost_ms"] = max(_PROFILE_CLOCK["lost_ms"], lost_start, lost_end)
        guard = {"lead_ms": t_call, "trail_ms": (t_close - t1) * 1e3,
                 "spins": [len(lead), len(trail)], "spins_lost": [lead_lost, trail_lost],
                 "lost_ms": [lost_start, lost_end]}
        if short and mid:
            return prof, (t1 - t0) * 1e3, guard
    fail(f"torch.profiler dropped a marker beside the call ({guard}, {profile_skew(prof)})")


def _cuda_rows(prof):
    """The profile's CUDA rows, the spin kernels of ``_profiled`` left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]


def profile_skew(prof) -> dict:
    """What an empty profile's trace holds, for the failure messages of
    ``_profiled``, ``device_profile`` and ``kernel_profile``: the runtime
    calls and device records Kineto returned, how many were spin records,
    the names of the others, and the range over device records of the
    start of its activity minus the start of the runtime call that
    launched it (same correlation id), in microseconds."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    dev_ev = [e for e in events if e.device_type() == DeviceType.CUDA]
    calls = [e for e in events if e.device_type() == DeviceType.CPU and e.name().startswith("cu")]
    launch = {e.correlation_id(): e.start_ns() for e in calls if e.correlation_id()}
    skew = [(e.start_ns() - launch[e.correlation_id()]) / 1e3 for e in dev_ev
            if e.correlation_id() in launch]
    return {"runtime_calls": len(calls), "device_records": len(dev_ev),
            "spin_records": sum("spin_kernel" in e.name() for e in dev_ev),
            "device_record_names": sorted({e.name()[:40] for e in dev_ev if "spin" not in e.name()}),
            "launch_to_kernel_us": [min(skew), max(skew)] if skew else None}


def device_profile(fn, dev, kinds=None):
    """One call of ``fn`` under ``torch.profiler`` (``_profiled``): its wall
    ms (which the profiler's own bookkeeping lengthens), the device's busy
    ms (the sum of its kernels' times; one stream, so they do not
    overlap), the number of kernels and the six that took the most device
    time. With ``kinds`` ({label: substrings of a kernel's name}, first
    match wins) also the device ms of each kind, the rest under
    ``other``, and ``_profiled``'s guard. Fails the run when the profile
    holds no device time."""
    prof, wall, guard = _profiled(fn, dev)
    kernels = _cuda_rows(prof)
    require(kernels, f"device_profile: torch.profiler recorded no CUDA kernel ({profile_skew(prof)})")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {"wall_ms": wall, "device_busy_ms": busy, "busy_share": busy / wall,
           "kernels": sum(e.count for e in kernels), "guard": guard,
           "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top]}
    if kinds:
        by = dict.fromkeys(list(kinds) + ["other"], 0.0)
        for e in kernels:
            label = next((k for k, pats in kinds.items() if any(p in e.key for p in pats)),
                         "other")
            by[label] += e.self_device_time_total / 1e3
        out["by_kind_ms"] = by
    return out


def kernel_profile(fn):
    """Device ms of each kernel (and memset) of one call of ``fn`` under
    ``torch.profiler`` (``_profiled``), after one call outside it, and
    ``_profiled``'s guard (its ms and the spin records lost). Fails
    the run when the profile lists no CUDA row: every ``fn`` given here
    launches kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof, _, guard = _profiled(fn, torch.device("cuda"))
    rows = _cuda_rows(prof)
    require(rows, f"kernel_profile: torch.profiler recorded no CUDA kernel ({profile_skew(prof)})")
    return {"device_ms": sum(e.self_device_time_total for e in rows) / 1e3, "guard": guard,
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


# -- the LM training path (phase 14) ------------------------------------------------


def _scale_name(name):
    """A gradient's rounding scale: attention's key bias shifts every score
    of a query alike, which the softmax ignores, so its gradient is 0 but
    for rounding of a sum of dL/dk, whose scale is dL/dwk's."""
    return name[:-2] + "wk" if name.endswith("attn.bk") else name


def embedding_backward_check(dev, K, cfg):
    """Phase 14a: ``_pb_take``'s backward at the training shape (B*S token
    rows of d_model float32 from a bfloat16 cotangent into the padded
    vocabulary; Markov-synthetic ids) against index_add_ in float64, then
    timed beside index_add_ and its bound. Returns the record."""
    import torch

    from repro_torch.core.executor import execute_reduce
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.ref import scatter_reduce_ref
    from repro_torch.models import layers as L
    from repro_torch.timing import cuda_ms

    ids = torch.from_numpy(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_S, global_batch=TRAIN_B)).batch_at(0)["tokens"]).to(dev)
    n, F = cfg.padded_vocab, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(14)
    g = torch.randn(TRAIN_B, TRAIN_S, F, device=dev, generator=gen).to(torch.bfloat16)
    table = torch.zeros(n, F, dtype=torch.bfloat16, device=dev, requires_grad=True)
    before = K.cobra_bin_accumulate_rows.launches
    (dtab,) = torch.autograd.grad(L._pb_take(table, ids), table, g)
    require(K.cobra_bin_accumulate_rows.launches == before + 1,
            "the embedding backward did not launch the rows kernel")
    flat, rows = ids.reshape(-1), g.reshape(-1, F).float()
    m = flat.shape[0]

    def kernel():
        return execute_reduce(flat, rows, out_size=n, op="add", method="fused")

    got = kernel()
    want = torch.zeros(n, F, dtype=torch.float64, device=dev).index_add_(0, flat, rows.double())
    scale = torch.zeros_like(want).index_add_(0, flat, rows.abs().double())
    err = float((got.double() - want).abs().max())
    require(bool(((got.double() - want).abs() <= ADD_TOL * scale + 1e-6).all()),
            f"the embedding backward differs from index_add_ in float64 ({err})")
    # the table's gradient: that sum rounded once to bfloat16
    require(bool(((dtab.double() - want).abs()
                  <= 2.0**-8 * want.abs() + ADD_TOL * scale + 1e-6).all()),
            "the embedding gradient differs from index_add_ beyond one bfloat16 rounding")
    del want, scale, got, dtab, table
    nbytes = 4 * m * F + 4 * m + 4 * n * F  # rows, ids, the output once each
    rec = {"m": m, "F": F, "n": n, "max_abs_err": err,
           "ms": cuda_ms(kernel, reps=10),
           "plain_ms": cuda_ms(lambda: scatter_reduce_ref(flat, rows, n), reps=10),
           "library_ms": cuda_ms(lambda: torch.zeros(n, F, device=dev).index_add_(0, flat, rows),
                                 reps=10),
           "bound_ms": bound_ms(nbytes), "bound_bytes": nbytes, "bound_by": "bytes",
           "profile": kernel_profile(kernel)}
    return rec


def flash_grad_checks(dev, q_block):
    """Phase 14b: flash attention's q, k, v gradients on the card (kernel
    forward, plain float32 backward) against the CPU's, causal, float32
    and bfloat16, held to the forward check's rule (flash_close)."""
    import torch

    from repro_torch.kernels.flashattn import flash_attention

    B, H, KH, S, hd = FLASH_GRAD_SHAPE
    gen = torch.Generator().manual_seed(141)  # on the CPU: the same inputs on both sides
    q, go = (torch.randn(B, H, S, hd, generator=gen) for _ in range(2))
    k, v = (torch.randn(B, KH, S, hd, generator=gen) for _ in range(2))
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        grads = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            args = [x.to(d, dt).requires_grad_() for x in (q, k, v)]
            out = flash_attention(*args, causal=True, q_block=q_block)
            grads[side] = torch.autograd.grad(out, args, go.to(d, dt))
        for name, a, b in zip("qkv", grads["card"], grads["cpu"]):
            err, share, ok = flash_close(a.cpu(), b, dt)
            worst[f"d{name} {dt}"] = (err, share)
            require(ok and a.dtype == dt,
                    f"flash d{name} {dt} on the card differs from the CPU (max |diff| {err})")
    return worst


def train_step_vs_cpu(dev, cfg):
    """Phase 14c: one AdamW step of a 2-layer full-width float32 copy on
    the card and on the CPU from the same state: the loss to rtol 1e-5,
    each gradient and moment within TRAIN_TOL of its max, parameters
    within 2 lr_1 plus two float32 roundings."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import DenseLM, init_params
    from repro_torch.train.optimizer import apply_updates, init_opt_state
    from repro_torch.train.steps import default_opt_config, make_loss_fn

    cfg32 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32", compute_dtype="float32")
    model = init_params(cfg32, seed=LM_SEED + 2, device=dev)
    cpu = DenseLM(cfg32, device="cpu")
    cpu.load_state_dict(model.state_dict())
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_CPU_S,
                                   global_batch=1)).batch_at(0)
    oc = default_opt_config(cfg32)
    loss_fn = make_loss_fn(cfg32)
    out = {}
    for side, m in (("card", model), ("cpu", cpu)):
        d = m.embed.table.device
        params = dict(m.named_parameters())
        loss = loss_fn(m, {k: torch.from_numpy(v).to(d) for k, v in batch.items()})
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        _, opt, met = apply_updates(params, grads, init_opt_state(params, oc), oc)
        out[side] = (float(loss.detach()), {n: g.cpu() for n, g in grads.items()},
                     {n: t.cpu() for n, t in opt.m.items()}, {n: t.cpu() for n, t in opt.v.items()},
                     {n: p.detach().cpu() for n, p in params.items()}, met)
    (la, ga, ma, va, pa, met), (lb, gb, mb, vb, pb, _) = out["card"], out["cpu"]
    shares = {"loss_rel": abs(la - lb) / abs(lb)}
    for what, a, b in (("grad", ga, gb), ("m", ma, mb), ("v", va, vb)):
        shares[what] = max(float((a[n] - b[n]).abs().max() / b[_scale_name(n)].abs().max())
                           for n in b)
    lr = met["lr"]
    shares["param_vs_2lr"] = max(float(((pa[n] - pb[n]).abs() - 2.0**-22 * pb[n].abs()).max())
                                 for n in pb) / (2 * lr)
    ok = (shares["loss_rel"] <= 1e-5 and max(shares["grad"], shares["m"], shares["v"]) <= TRAIN_TOL
          and shares["param_vs_2lr"] <= 1.0)
    require(ok, f"the 2-layer float32 train step on the card differs from the CPU: {shares}")
    return {"loss": [la, lb], "lr": lr, **shares}


def train_phase(dev, K, smi):
    """Phase 14: the LM training path. The backward kernels against their
    plain versions (14a, 14b), a float32 step against the CPU (14c), then
    ``launch/train.py`` at full width: 3 steps with checkpoints, the
    checkpoint restored bit for bit, one more step from it, and one step
    under the profiler (14d). Returns (launches, launches by shape, the
    embedding-backward record)."""
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager, _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.models.config import flops_per_token
    from repro_torch.train.steps import default_opt_config, make_train_step

    cfg = get_config(LM_ARCH)
    t = time.perf_counter()
    emb = embedding_backward_check(dev, K, cfg)
    say("phase14 embedding backward", json.dumps(dict(emb, card=smi)))
    torch.cuda.empty_cache()
    say("phase14 flash gradients card vs CPU (max |diff|, share of tolerance):",
        json.dumps({k: list(v) for k, v in flash_grad_checks(dev, cfg.attn_q_block).items()}))
    say("phase14 float32 step card vs CPU", json.dumps(train_step_vs_cpu(dev, cfg)))
    torch.cuda.empty_cache()
    say(f"phase14 checks seconds: {time.perf_counter() - t:.1f}")

    flags = ["--arch", LM_ARCH, "--preset", "full", "--seq-len", str(TRAIN_S),
             "--batch", str(TRAIN_B), "--log-every", "1"]
    counts, shapes = {}, {}

    def add(c, sh):
        for k, x in c.items():
            counts[k] = counts.get(k, 0) + x
        for k, by in sh.items():
            for key, x in by.items():
                shapes.setdefault(k, {})[key] = shapes.get(k, {}).get(key, 0) + x

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        args = train_mod.parse_args(flags + ["--steps", str(TRAIN_STEPS), "--ckpt-dir", ck,
                                             "--ckpt-every", "2"])
        K.reset_launch_counts()  # the training path starts here
        run = train_mod.train(args)
        torch.cuda.synchronize()
        c1, s1 = K.launch_counts(), K.launch_shapes()  # and ends here
        add(c1, s1)
        peak = torch.cuda.max_memory_allocated() - mem0
        opt = run.state.opt
        require(all(math.isfinite(x) for x in run.losses + run.grad_norms)
                and len(run.losses) == TRAIN_STEPS, f"training diverged: {run.losses}")
        stale = [n for n in opt.m if not n.endswith("attn.bk")
                 and not (float(opt.m[n].abs().max()) > 0 and float(opt.v[n].abs().max()) > 0)]
        require(opt.step == TRAIN_STEPS and not stale, f"moments that did not move: {stale}")
        require(c1["cobra_bin_accumulate_rows"] >= TRAIN_STEPS
                and c1["flash_attention"] >= cfg.num_layers * TRAIN_STEPS,
                f"training launched {c1} in {TRAIN_STEPS} steps")
        restored, at = CheckpointManager(ck).restore(run.state)
        same = all((torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
                   for (_, a), (_, b) in zip(_flatten_with_paths(restored),
                                             _flatten_with_paths(run.state)))
        require(at == TRAIN_STEPS and same, f"checkpoint step {at} does not restore bit for bit")
        rec = {"arch": LM_ARCH, "layers": cfg.num_layers, "param_dtype": cfg.param_dtype,
               "remat": cfg.remat, "optimizer": default_opt_config(cfg).kind,
               "batch": TRAIN_B, "seq_len": TRAIN_S,
               "cut": f"global batch {TRAIN_B} of train_4k's 256 (one card)",
               "losses": run.losses, "grad_norms": run.grad_norms, "lrs": run.lrs,
               "step_ms": [1e3 * x for x in run.step_seconds],
               "launches": {k: c1[k] for k in ("cobra_bin_accumulate_rows", "flash_attention")},
               "peak_bytes_above_earlier_phases": peak, "earlier_phases_bytes": mem0,
               "checkpoint_restored_bit_equal": same, "card": smi}
        del restored, run, opt
        torch.cuda.empty_cache()
        K.reset_launch_counts()  # the resumed run starts here
        run = train_mod.train(train_mod.parse_args(
            flags + ["--steps", str(TRAIN_STEPS + 1), "--ckpt-dir", ck, "--ckpt-every", "100"]))
        torch.cuda.synchronize()
        c2, s2 = K.launch_counts(), K.launch_shapes()  # and ends here
        add(c2, s2)
        require(run.start_step == TRAIN_STEPS and len(run.losses) == 1
                and math.isfinite(run.losses[0]) and c2["cobra_bin_accumulate_rows"] >= 1
                and c2["flash_attention"] >= cfg.num_layers,
                f"the resumed run: start {run.start_step}, losses {run.losses}, launches {c2}")
        rec["resumed"] = {"start_step": run.start_step, "loss": run.losses[0],
                          "step_ms": 1e3 * run.step_seconds[0]}
    steady = [x for x in rec["step_ms"][1:]] + [rec["resumed"]["step_ms"]]
    tokens = TRAIN_B * TRAIN_S
    ms = min(steady)
    rec.update({"steady_step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
                "model_flop_per_s": flops_per_token(cfg) * tokens / ms * 1e3,
                "model_flop_share_of_989T": flops_per_token(cfg) * tokens / ms * 1e3
                / BF16_FLOP_PER_S})
    say("phase14 train", json.dumps(rec))
    # one more step under the profiler, from the resumed state
    step = make_train_step(cfg, default_opt_config(cfg, total_steps=TRAIN_STEPS + 2))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S, global_batch=TRAIN_B))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(TRAIN_STEPS + 1).items()}
    state = run.state
    prof = device_profile(lambda: step(state, batch), dev, kinds={
        "flash kernel": ("flash_fwd",), "rows kernel": ("rows_kernel",),
        "float32 GEMM": ("f32f32_f32",), "other GEMM": ("gemm", "nvjet", "cutlass"),
        "elementwise": ("elementwise",), "reductions": ("reduce",),
        "copies and fills": ("Memcpy", "Memset", "fill")})
    say("phase14 profile", json.dumps(dict(prof, card=smi)))
    del run, state, batch
    torch.cuda.empty_cache()
    return counts, shapes, emb


# -- the MoE serving path (phase 15) -------------------------------------------------


def moe_dispatch_checks(cfg, moe, dev, gen):
    """Check (a): ``sort`` and ``counting`` dispatch give bit-equal
    ``(order, key_sorted, starts, rank)`` on one layer's router at each of
    ``MOE_DISPATCH_T`` tokens, and bit-equal layer outputs (the same slots,
    so the same products and sums: the combine's one atomic a column per
    token leaves no order to differ). Returns the records."""
    import torch

    from repro_torch.core.executor import dispatch_permutation
    from repro_torch.models import layers as L

    out = []
    for T_ in MOE_DISPATCH_T:
        x = torch.randn(T_, cfg.d_model, device=dev, generator=gen).to(cfg.cdtype)
        _, ids = L.moe_route(x, moe.wr, cfg)
        key = ids.reshape(-1).to(torch.int32)
        res = {m: dispatch_permutation(key, cfg.num_experts, method=m) for m in ("sort", "counting")}
        same = all(torch.equal(a, b) for a, b in zip(res["sort"], res["counting"]))
        y = {m: L.moe_apply(moe, x[None], dataclasses.replace(cfg, moe_dispatch_method=m))
             for m in ("sort", "counting")}
        same_y = torch.equal(y["sort"], y["counting"])
        rec = {"tokens": T_, "assignments": key.shape[0], "slots": cfg.num_experts + 1,
               "capacity": L.moe_capacity(T_, cfg), "routing_equal": same,
               "layer_output_equal": same_y}
        say("phase15 (a) dispatch sort vs counting", json.dumps(rec))
        require(same and same_y, f"sort and counting dispatch differ at T={T_}: {rec}")
        out.append(rec)
    return out


def moe_oracle_check(cfg, moe, dev, gen):
    """Check (b): one MoE layer (PB dispatch, experts, rows-kernel combine)
    against ``_moe_dense_oracle`` on the card, bfloat16, at
    ``MOE_ORACLE_T`` tokens with ``capacity_factor`` 16 (C = T: no drops).
    Tolerance: |got - want| <= MOE_BF16_TOL * S elementwise, S being the
    same weighted sum of absolute values (|gate| * |h| @ |w2|, float32).
    Both sides round h, each expert row and the output to bfloat16, and
    the PB side also each weighted row; the matrix products sum in float32
    in other orders, so a rounded value differs between the sides by at
    most one ulp (2^-8 relative), and only where the two float32 sums fall
    on either side of a rounding boundary. Each rounding's difference is
    bounded by 2^-9 of S and they rarely meet in one element: 2^-8 of S.

    The planted fault: the same output with one assignment's weighted row
    taken out of the combine (its weight zeroed), for every assignment in
    turn; the limit must reject every such fault, and the record gives
    the smallest and median share of the limit they reach."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as L

    c = dataclasses.replace(cfg, capacity_factor=16.0)
    T_ = MOE_ORACLE_T
    x = torch.randn(T_, c.d_model, device=dev, generator=gen).to(c.cdtype)
    got = L._moe_expert_shard(x, moe.wr, moe.w1, moe.w3, moe.w2, c, 0, c.num_experts)
    want = L._moe_dense_oracle(x, moe.wr, moe.w1, moe.w3, moe.w2, c)
    gw, gi = L.moe_route(x, moe.wr, c)
    h = F.silu(torch.einsum("td,edf->tef", x, moe.w1)) * torch.einsum("td,edf->tef", x, moe.w3)
    y_abs = torch.einsum("tef,efd->ted", h.abs().float(), moe.w2.abs().float())
    gates = (F.one_hot(gi, c.num_experts).float() * gw[..., None]).sum(1)
    limit = MOE_BF16_TOL * torch.einsum("te,ted->td", gates, y_abs)
    del y_abs
    delta = got.float() - want.float()
    diff = delta.abs()
    # every assignment's weighted expert row, (T, k, d): the planted faults
    y = torch.einsum("tef,efd->ted", h, moe.w2).float()
    row = torch.gather(y, 1, gi[..., None].expand(-1, -1, c.d_model)) * gw[..., None]
    del y, h
    fault = ((delta[:, None] - row).abs() / limit[:, None]).amax(-1).flatten()
    rec = {"tokens": T_, "capacity": L.moe_capacity(T_, c), "capacity_factor": 16.0,
           "max_abs_err": float(diff.max()), "max_abs_want": float(want.float().abs().max()),
           "tolerance_share": float((diff / limit).max()),
           "tolerance": f"{MOE_BF16_TOL} * sum of |terms|",
           "planted_fault_share": {"min": float(fault.min()), "median": float(fault.median()),
                                   "rejected": float((fault > 1).float().mean())}}
    say("phase15 (b) MoE layer vs the dense oracle", json.dumps(rec))
    require(bool((diff <= limit).all()),
            f"the MoE layer differs from the dense oracle: {rec}")
    require(rec["planted_fault_share"]["min"] > 1,
            f"check (b)'s limit passes a combine that drops one assignment: {rec}")
    return rec


def moe_kernel_rows(cfg, moe, dev, gen, T_, launches, K):
    """Check (c) for the histogram, positions, row scatter and rows kernel
    (bfloat16 and float32) against their plain versions on one layer at
    ``T_`` tokens (the serve's longest prefill), then the kernels line's
    rows 2b, 5c and 7b at those shapes: ms, plain ms, bound and the
    library call's ms. ``launches``: phase 15's serve counts."""
    import torch

    from repro_torch.core.executor import dispatch_permutation
    from repro_torch.core.pb import starts_from_counts
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.timing import cuda_ms

    E, k, d = cfg.num_experts, cfg.top_k, cfg.d_model
    x = torch.randn(T_, d, device=dev, generator=gen).to(cfg.cdtype)
    disp = L.moe_dispatch(x, moe.wr, cfg, 0, E)
    _, ids = L.moe_route(x, moe.wr, cfg)
    key = ids.reshape(-1).to(torch.int32)
    m, nb = key.shape[0], E + 1
    h = K.histogram(key, nb)
    starts = starts_from_counts(h)[:-1].contiguous()
    pos = K.counting_positions(key, starts, nb)
    require(torch.equal(h, ref.histogram_ref(key, nb))
            and torch.equal(pos, ref.counting_positions_ref(key, starts, nb)),
            "histogram / positions at the MoE dispatch differ from plain")
    order, key_s, _, rank = dispatch_permutation(key, E, method="counting")
    C = disp.capacity
    slot = torch.where((key_s < E) & (rank < C), key_s * C + rank, -1)
    xs = x[torch.div(order.long(), k, rounding_mode="floor")]
    srows = K.scatter_rows(xs, slot, E * C)
    require(torch.equal(srows, ref.scatter_rows_ref(xs, slot, E * C))
            and torch.equal(srows, disp.xbuf), "scatter_rows at the MoE dispatch differs from plain")
    yb = L.moe_experts(disp.xbuf, moe.w1, moe.w3, moe.w2, cfg, C)
    kept = disp.slot_of_assign >= 0
    rows = yb[disp.slot_of_assign.clamp(min=0).long()].masked_fill_(~kept[:, None], 0)
    vals = rows * disp.gate_w.reshape(-1).to(cfg.cdtype)[:, None]
    tokens = torch.arange(T_, dtype=torch.int32, device=dev).repeat_interleave(k)
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        v = vals.to(dt)
        got = K.cobra_bin_accumulate_rows(tokens, v, T_, T_, 1)
        want = ref.scatter_reduce_ref(tokens, v, T_)
        scale = ref.scatter_reduce_ref(tokens, v.float().abs(), T_)
        diff = (got.float() - want.float()).abs()
        # bfloat16: one step of bfloat16 (at most 2^-7 relative), where the
        # two float32 sums straddle a rounding boundary
        tol = ADD_TOL * scale + 1e-6 + (2.0**-7 * want.float().abs() if dt == torch.bfloat16 else 0)
        errs[str(dt)] = float(diff.max())
        require(got.dtype == dt and bool((diff <= tol).all()),
                f"the rows kernel ({dt}) at the MoE combine differs from plain ({errs})")
    say("phase15 (c) kernels vs plain at the MoE shapes", json.dumps({
        "tokens": T_, "assignments": m, "bins": nb, "capacity": C, "histogram_equal": True,
        "positions_equal": True, "scatter_rows_equal": True, "rows_max_abs_err": errs}))
    cap_rows = E * C
    kept_i = slot >= 0
    lib_pos, lib_x = slot[kept_i].long(), xs[kept_i]
    xw = xs.element_size()
    vb = vals.to(torch.bfloat16)
    return [
        {"name": "counting_positions:moe_dispatch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/positions.cu",
         "replaces": "src/repro/kernels/binning.py:62", "launches": launches["counting_positions"],
         "checked_against_plain": True, "max_abs_err": 0, "shape": {"m": m, "B": nb},
         "ms": cuda_ms(lambda: K.counting_positions(key, starts, nb), reps=20),
         "plain_ms": cuda_ms(lambda: ref.counting_positions_ref(key, starts, nb), reps=20),
         "bound_ms": bound_ms(8 * m + 4 * nb), "bound_bytes": 8 * m + 4 * nb,
         "bound_by": "bytes", "library_ms": None},
        {"name": "cobra_bin_accumulate_rows:moe_combine", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_rows.cu",
         "replaces": "src/repro/kernels/fused.py:263",
         "launches": launches["cobra_bin_accumulate_rows"], "checked_against_plain": True,
         "max_abs_err": errs[str(torch.bfloat16)], "shape": {"m": m, "F": d, "n": T_},
         "dtype": "bfloat16",
         "ms": cuda_ms(lambda: K.cobra_bin_accumulate_rows(tokens, vb, T_, T_, 1), reps=20),
         "plain_ms": cuda_ms(lambda: ref.scatter_reduce_ref(tokens, vb, T_), reps=20),
         "bound_ms": bound_ms(2 * m * d + 4 * m + 2 * T_ * d),
         "bound_bytes": 2 * m * d + 4 * m + 2 * T_ * d, "bound_by": "bytes",
         "float32_ms": cuda_ms(lambda: K.cobra_bin_accumulate_rows(
             tokens, vals.float(), T_, T_, 1), reps=20),
         "library_ms": cuda_ms(lambda: torch.zeros(T_, d, dtype=torch.bfloat16, device=dev)
                               .index_add_(0, tokens, vb), reps=20)},
        {"name": "scatter_rows:moe_dispatch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/scatter_rows.cu",
         "replaces": "src/repro/kernels/scatter_rows.py:37", "launches": launches["scatter_rows"],
         "checked_against_plain": True, "max_abs_err": 0,
         "shape": {"m": m, "d": d, "out_rows": cap_rows}, "dtype": str(xs.dtype),
         "ms": cuda_ms(lambda: K.scatter_rows(xs, slot, cap_rows), reps=20),
         "plain_ms": cuda_ms(lambda: ref.scatter_rows_ref(xs, slot, cap_rows), reps=20),
         "bound_ms": bound_ms(4 * m + xw * (m + cap_rows) * d),
         "bound_bytes": 4 * m + xw * (m + cap_rows) * d, "bound_by": "bytes",
         "library_ms": cuda_ms(lambda: torch.zeros(cap_rows, d, dtype=xs.dtype, device=dev)
                               .index_copy_(0, lib_pos, lib_x), reps=20)},
    ]


def moe_layer_stage_ms(cfg, moe, dev, gen, T_):
    """One layer's dispatch, expert FFN and combine ms at ``T_`` tokens
    (CUDA events over ``moe_dispatch``, ``moe_experts``, ``moe_combine``)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.timing import cuda_ms

    x = torch.randn(T_, cfg.d_model, device=dev, generator=gen).to(cfg.cdtype)
    E = cfg.num_experts
    disp = L.moe_dispatch(x, moe.wr, cfg, 0, E)
    yb = L.moe_experts(disp.xbuf, moe.w1, moe.w3, moe.w2, cfg, disp.capacity)
    return {"tokens": T_, "capacity": disp.capacity,
            "dispatch_ms": cuda_ms(lambda: L.moe_dispatch(x, moe.wr, cfg, 0, E), reps=10),
            "experts_ms": cuda_ms(lambda: L.moe_experts(disp.xbuf, moe.w1, moe.w3, moe.w2, cfg,
                                                        disp.capacity), reps=10),
            "combine_ms": cuda_ms(lambda: L.moe_combine(yb, disp.slot_of_assign, disp.gate_w, cfg),
                                  reps=10)}


def moe_routing_stats(cfg, fn):
    """Run ``fn`` with every MoE layer's routing recorded: per layer call
    the tokens, capacity, the heaviest expert's load, the assignments
    dropped past capacity and the tokens with a top-k tie
    (``layers.moe_topk_ties``)."""
    import torch

    from repro_torch.models import layers as L

    stats, plain = [], L.moe_apply

    def recording(p, x, c):
        x2d = x.reshape(-1, x.shape[-1])
        _, ids = L.moe_route(x2d, p.wr, c)
        load = torch.bincount(ids.reshape(-1), minlength=c.num_experts)
        C = L.moe_capacity(x2d.shape[0], c)
        stats.append({"tokens": x2d.shape[0], "capacity": C, "max_load": int(load.max()),
                      "dropped": int((load - C).clamp(min=0).sum()),
                      "topk_ties": L.moe_topk_ties(x2d, p.wr, c)})
        return plain(p, x, c)

    L.moe_apply = recording
    try:
        fn()
    finally:
        L.moe_apply = plain
    return stats


def moe_phase(dev, K, smi):
    """Phase 15: MoE serving at ``qwen3-moe-235b-a22b``'s full width with
    ``MOE_LAYERS`` of its 94 layers (bfloat16, random weights from a seeded
    generator, counting dispatch): checks (a) dispatch sort == counting,
    (b) a layer against the dense oracle, (c) the kernels against their
    plain versions at the phase's shapes (flash at 64 heads over 4), then
    the serve (``Engine``: MOE_REQUESTS requests of MOE_PROMPT_LENS tokens,
    MOE_MAX_NEW new each, MOE_SLOTS slots) with (f) its launch counts,
    routing statistics, per-layer stage ms, a profile, (d) the engine
    against a manual loop, and (e) a 2-layer float32 copy with
    MOE_CPU_EXPERTS experts against the CPU. Returns (launches, launches by
    shape, the kernels line's rows 2b, 5c, 7b and 8b)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flashattn import flash_attention_ref, flash_flops
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.timing import cuda_ms
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    t = time.perf_counter()
    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, num_layers=MOE_LAYERS, moe_dispatch_method="counting")
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    model = init_params(cfg, seed=MOE_SEED, device=dev)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    say("phase15 model", json.dumps({
        "arch": MOE_ARCH, "layers": cfg.num_layers, "of_layers": base.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
        "experts": cfg.num_experts, "d_ff": cfg.d_ff, "top_k": cfg.top_k,
        "capacity_factor": cfg.capacity_factor, "dispatch": cfg.moe_dispatch_method,
        "vocab": cfg.vocab_size, "parameters": nparams,
        "parameter_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
        "earlier_phases_bytes": mem0, "seconds_to_draw": time.perf_counter() - t,
        "reduced": f"{MOE_LAYERS} of {base.num_layers} layers (one card)"}))
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    moe0 = model.blocks[0].moe
    with torch.inference_mode():
        # (c) flash at the model's heads first: the serve trusts it
        flash_worst = flash_checks(dev, MOE_FLASH_SHAPES)
        say("phase15 (c) flash at 64 heads over 4, largest |diff| and share:", json.dumps(flash_worst))
        moe_dispatch_checks(cfg, moe0, dev, gen)
        moe_oracle_check(cfg, moe0, dev, gen)
    torch.cuda.empty_cache()
    say(f"phase15 checks seconds: {time.perf_counter() - t:.1f}")

    prompts = lm_prompts(cfg, MOE_REQUESTS, *MOE_PROMPT_LENS, seed=MOE_SEED)
    counts, rec = serve_lm(cfg, model, prompts, MOE_SLOTS, MOE_MAX_LEN, MOE_MAX_NEW)
    shapes = rec.pop("launch_shapes")
    forwards = len(rec["prefill_ms"]) + rec["decode_ticks"]
    prompt_tokens = sum(len(p) for p in prompts)
    rec.update({"arch": MOE_ARCH, "layers": cfg.num_layers, "forward_calls": forwards,
                "prefill_tokens_per_s": prompt_tokens / (sum(rec["prefill_ms"]) / 1e3),
                "serving_peak_bytes": (rec["max_memory_allocated"] - mem0
                                       if dev.type == "cuda" else None),
                "earlier_phases_bytes": mem0, "launches": counts, "card": smi})
    say("phase15 serve", json.dumps(rec))
    # (f) every forward call runs each layer's dispatch and combine once
    L_ = cfg.num_layers
    for name in ("cobra_bin_accumulate_rows", "histogram", "counting_positions", "scatter_rows"):
        require(counts[name] == L_ * forwards,
                f"{name}: {counts[name]} launches != {L_} layers x {forwards} forward calls")
    longest = torch.from_numpy(max(prompts, key=len)[None]).to(dev)
    T_long = longest.shape[1]
    prefill, decode = make_prefill_step(cfg, MOE_MAX_LEN), make_decode_step(cfg)
    st = init_cache(cfg, MOE_SLOTS, MOE_MAX_LEN, device=dev)._replace(index=rec["final_index"])
    tok4 = torch.zeros(MOE_SLOTS, 1, dtype=torch.int32, device=dev)
    routing = {"prefill": moe_routing_stats(cfg, lambda: prefill(model, {"tokens": longest})),
               "decode_tick": moe_routing_stats(cfg, lambda: decode(model, st, tok4))}
    say("phase15 routing per layer (dropped assignments, top-k ties)", json.dumps(dict({
        k: {"dropped": sum(r["dropped"] for r in v), "topk_ties": sum(r["topk_ties"] for r in v),
            "layers": v} for k, v in routing.items()}, card=smi)))
    kinds = {"flash kernel": ("flash_fwd",), "rows kernel": ("rows_kernel", "f32_to_bf16"),
             "row scatter": ("scatter_rows",), "histogram+positions": ("histogram", "positions"),
             "GEMM": ("gemm", "nvjet", "cutlass", "xmma"), "elementwise": ("elementwise",),
             "copies and fills": ("Memcpy", "Memset", "fill")}
    prof = {"prefill": {"tokens": T_long, **device_profile(
                lambda: prefill(model, {"tokens": longest}), dev, kinds)},
            "decode_tick": {"slots": MOE_SLOTS, "index": st.index, **device_profile(
                lambda: decode(model, st, tok4), dev, kinds)}}
    say("phase15 profile", json.dumps(dict(prof, card=smi)))
    with torch.inference_mode():
        say("phase15 per-layer stage ms", json.dumps({
            "prefill": moe_layer_stage_ms(cfg, moe0, dev, gen, T_long),
            "decode": moe_layer_stage_ms(cfg, moe0, dev, gen, MOE_SLOTS), "card": smi}))
        rows = moe_kernel_rows(cfg, moe0, dev, gen, T_long, counts, K)
        fB, fH, fKH, fhd = 1, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        fq = torch.randn(fB, fH, T_long, fhd, device=dev, generator=gen).to(torch.bfloat16)
        fk = torch.randn(fB, fKH, T_long, fhd, device=dev, generator=gen).to(torch.bfloat16)
        fv = torch.randn(fB, fKH, T_long, fhd, device=dev, generator=gen).to(torch.bfloat16)
        ferr, _, fok = flash_close(K.flash_attention(fq, fk, fv), flash_attention_ref(fq, fk, fv),
                                   torch.bfloat16)
        require(fok, f"flash at the MoE prefill shape differs from plain ({ferr})")
        fflop = flash_flops(fB, fH, T_long, T_long, fhd, causal=True)
        fbytes = 2 * (2 * fB * fH * T_long * fhd + 2 * fB * fKH * T_long * fhd)
        rows.append({
            "name": "flash_attention:moe_prefill", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flashattn.cu",
            "replaces": "src/repro/kernels/flashattn.py:61", "launches": counts["flash_attention"],
            "checked_against_plain": True,
            "max_abs_err": max([ferr] + [e for e, _ in flash_worst.values()]),
            "shape": {"B": fB, "H": fH, "KH": fKH, "S": T_long, "hd": fhd},
            "ms": cuda_ms(lambda: K.flash_attention(fq, fk, fv), reps=20),
            "plain_ms": cuda_ms(lambda: flash_attention_ref(fq, fk, fv), reps=5),
            "bound_ms": max(fflop / BF16_FLOP_PER_S, fbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_flop": fflop, "bound_bytes": fbytes,
            "bound_by": "operations" if fflop / BF16_FLOP_PER_S > fbytes / HBM_BYTES_PER_S
            else "bytes",
            "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                fq, fk, fv, is_causal=True, enable_gqa=True), reps=20)})
        del fq, fk, fv
    del st
    got, want, same_cache = engine_equals_manual_loop(cfg, model, prompts[0], MOE_MAX_LEN,
                                                      MOE_MAX_NEW)
    say("phase15 (d) engine vs manual loop:", json.dumps(
        {"engine": got, "manual": want, "same_cache": same_cache}))
    require(got == want and same_cache,
            "the MoE engine differs from a manual prefill + decode loop (tokens or cache)")
    del model, moe0
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, num_layers=2, num_experts=MOE_CPU_EXPERTS,
                                param_dtype="float32", compute_dtype="float32")
    model32 = init_params(cfg32, seed=MOE_SEED + 1, device=dev)
    prompt32 = lm_prompts(cfg32, 1, LM_CPU_PROMPT, LM_CPU_PROMPT, seed=MOE_SEED + 1)[0]
    share, same_tokens, toks32 = lm_vs_cpu(cfg32, model32, prompt32, 512, LM_CPU_STEPS)
    say("phase15 (e) card vs CPU", json.dumps({
        "layers": 2, "experts": MOE_CPU_EXPERTS, "d_model": cfg32.d_model, "dtype": "float32",
        "prompt": LM_CPU_PROMPT, "decode_steps": LM_CPU_STEPS, "max_logit_err_share": share,
        "tolerance": LM_TOL, "tokens": toks32, "tokens_equal": same_tokens,
        "reduced": f"2 layers, {MOE_CPU_EXPERTS} of {base.num_experts} experts (the CPU copy)",
        "card": smi}))
    require(share <= LM_TOL and same_tokens,
            f"the float32 MoE model on the card differs from the CPU (share {share}, "
            f"tokens equal {same_tokens})")
    del model32
    torch.cuda.empty_cache()
    return counts, shapes, rows


# -- the traversal path (phase 12) -------------------------------------------------


def decision_trace(decisions) -> str:
    """fig8's per-level trace: L<level>:<method>@2^<log2 bucketed length>."""
    per_level = {}
    for d in decisions:
        per_level.setdefault(d.get("level", -1), d)
    items = [f"L{lvl}:{d['method']}@2^{max(d['stream_len'], 1).bit_length() - 1}"
             for lvl, d in sorted(per_level.items())[:12]]
    return " ".join(items) + (" ..." if len(per_level) > 12 else "")


def dense_bfs(T, csr, source):
    """Level-synchronous BFS over every edge at once, independent of the
    executor: levels, and the parent rule of ``traversal.bfs`` (the
    largest-id predecessor on the previous level)."""
    import torch

    n = csr.num_nodes
    src = T.segment_ids_from_offsets(csr.offsets, csr.num_edges).long()
    dst = csr.neighs.long()
    dist = torch.full((n,), INT32_MAX, dtype=torch.int32, device=src.device)
    dist[source] = 0
    front = torch.zeros(n, dtype=torch.bool, device=src.device)
    front[source] = True
    level = 0
    while bool(front.any()):
        hit = torch.zeros(n, dtype=torch.bool, device=src.device)
        hit[dst[front[src]]] = True
        front = hit & (dist == INT32_MAX)
        level += 1
        dist[front] = level
    du, dv = dist[src], dist[dst]
    e = (du != INT32_MAX) & (dv == du + 1)
    parent = torch.full((n,), -1, dtype=torch.int32, device=src.device)
    parent.scatter_reduce_(0, dst[e], src[e].to(torch.int32), "amax")
    parent[source] = source
    return dist, parent


def scipy_cc_labels(g):
    """Weakly connected components by scipy, each labelled with its
    smallest vertex id."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = g.num_nodes
    s, d = g.src.cpu().numpy(), g.dst.cpu().numpy()
    a = sp.csr_matrix((np.ones(s.shape[0], np.float32), (s, d)), shape=(n, n))
    _, comp = connected_components(a, directed=True, connection="weak")
    first = np.full(int(comp.max()) + 1, n, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    return first[comp].astype(np.int32)


def scipy_sssp(csr, w, source):
    """Dijkstra in float64 on the same weighted edges (parallel edges
    reduced to their lightest first); unreached vertices are inf."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    n = csr.num_nodes
    off = csr.offsets.cpu().numpy().astype(np.int64)
    u = np.repeat(np.arange(n, dtype=np.int64), np.diff(off))
    v = csr.neighs.cpu().numpy().astype(np.int64)
    w64 = w.cpu().numpy().astype(np.float64)
    key = u * n + v
    order = np.lexsort((w64, key))
    keep = np.ones(order.shape[0], bool)
    keep[1:] = key[order[1:]] != key[order[:-1]]
    o = order[keep]
    a = sp.csr_matrix((w64[o], (u[o], v[o])), shape=(n, n))
    return dijkstra(a, directed=True, indices=source)


def traversal_phase(dev, T, K, suite, suite_cpu, sizes, cache):
    """Phase 12: BFS (with parents), SSSP, k-core, both CC forms, radii,
    the batched BFS/SSSP and PPR through the port's entry points on
    ``suite`` (S1, held against ``suite_cpu``'s run on the CPU) and on
    ``sizes`` ({"S2": coo, "S3": coo}: all of it at S2, BFS and CC at S3).
    Returns the kernel launches of the path (counts, shapes)."""
    import numpy as np
    import torch

    from repro_torch.core import components as TC
    from repro_torch.core.executor import execute_reduce
    from repro_torch.core.traversal import _expand_frontier, bucket_len
    from repro_torch.timing import cuda_ms, time_fn

    on_card = torch.device(dev).type == "cuda"
    ex = T.PBExecutor(cache_dir=cache)
    ex_pallas = T.PBExecutor(cache_dir=cache, use_pallas=True)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def prepare(g):
        csr = T.build_csr(g, method="auto")
        off = csr.offsets.cpu().numpy()
        source = int(np.argmax(np.diff(off)))
        w = torch.from_numpy(np.random.default_rng(8).random(csr.num_edges).astype(np.float32)
                             + 0.1).to(csr.offsets.device)
        deg = np.diff(off)
        # the batch: the source and the next seven vertices by out-degree
        srcs = [int(v) for v in np.argsort(-deg, kind="stable")[:TRAV_BATCH]]
        return csr, source, w, srcs

    def run_all(g, csr, source, w, srcs, executor, full=True):
        """Every entry point once on one graph; the results by name."""
        T.set_default_executor(executor)
        out = {"bfs": T.bfs(csr, source, executor=executor),
               "cc_fused": T.connected_components_fused(g, max_iters=g.num_nodes),
               "cc_pb": TC.connected_components_pb(g, max_iters=g.num_nodes)}
        if full:
            out.update(
                sssp=T.sssp(csr, w, source, executor=executor),
                k_core=T.k_core(csr, KCORE_K, executor=executor),
                radii=T.radii(csr, k=RADII_K, max_iters=RADII_ITERS, executor=executor),
                bfs_batched=T.bfs_batched(csr, srcs, executor=executor, with_parents=True),
                sssp_batched=T.sssp_batched(csr, w, srcs, executor=executor),
                ppr=T.personalized_pagerank(csr, srcs, executor=executor),
            )
        sync()
        return out

    def same(a, b):
        return torch.equal(a.cpu(), b.cpu())

    def compare(tag, got, want):
        """Card against CPU: integers, distances, labels, eccentricities
        and parents equal; PPR to the PageRank tolerance."""
        checks = {
            "bfs": same(got["bfs"].dist, want["bfs"].dist)
            and same(got["bfs"].parent, want["bfs"].parent)
            and got["bfs"].levels == want["bfs"].levels,
            "cc_fused": same(got["cc_fused"].labels, want["cc_fused"].labels)
            and got["cc_fused"].iters == want["cc_fused"].iters,
            "cc_pb": same(got["cc_pb"].labels, want["cc_pb"].labels),
        }
        if "sssp" in want:
            checks.update(
                sssp=same(got["sssp"].dist, want["sssp"].dist),
                k_core=same(got["k_core"].in_core, want["k_core"].in_core),
                radii=same(got["radii"].ecc, want["radii"].ecc),
                bfs_batched=same(got["bfs_batched"].dist, want["bfs_batched"].dist)
                and same(got["bfs_batched"].parent, want["bfs_batched"].parent),
                sssp_batched=same(got["sssp_batched"].dist, want["sssp_batched"].dist),
                ppr=pr_close(got["ppr"].ranks, want["ppr"].ranks)[0],
            )
        bad = [k for k, ok in checks.items() if not ok]
        require(not bad, f"{tag}: card differs from the CPU run in {bad}")

    def independent_checks(tag, g, csr, source, w, srcs, res, dijkstra=False, lanes=False):
        """Results against code that does not use the executor."""
        rec = {}
        dd, dp = dense_bfs(T, csr, source)
        b = res["bfs"]
        require(same(b.dist, dd) and same(b.parent, dp),
                f"{tag}: BFS levels or parents differ from the dense BFS")
        want = torch.from_numpy(scipy_cc_labels(g))
        for k in ("cc_fused", "cc_pb"):
            require(same(res[k].labels, want), f"{tag}: {k} labels differ from scipy's components")
        rec["components"] = int(torch.unique(want).numel())
        if "k_core" in res:
            require(same(res["k_core"].in_core, torch.from_numpy(T.k_core_oracle(csr, KCORE_K))),
                    f"{tag}: k-core differs from k_core_oracle")
        if lanes:  # each batched lane against its single-source run
            for q, s in enumerate(srcs):
                bq = T.bfs(csr, s, executor=ex)
                sq = T.sssp(csr, w, s, executor=ex)
                require(same(res["bfs_batched"].dist[q], bq.dist)
                        and same(res["bfs_batched"].parent[q], bq.parent),
                        f"{tag}: bfs_batched lane {q} differs from bfs")
                require(same(res["sssp_batched"].dist[q], sq.dist),
                        f"{tag}: sssp_batched lane {q} differs from sssp")
                pq = T.personalized_pagerank(csr, s, executor=ex).ranks
                ok, rel = pr_close(res["ppr"].ranks[q], pq)
                require(ok, f"{tag}: PPR lane {q} differs from the single-source run ({rel})")
        if dijkstra:
            d64 = torch.from_numpy(scipy_sssp(csr, w, source))
            d32 = res["sssp"].dist.cpu()
            reached = torch.isfinite(d64)
            require(torch.equal(reached, d32 < F32_MAX),
                    f"{tag}: SSSP reaches other vertices than Dijkstra")
            dr = d64[reached]
            hops = torch.clamp(dr / SSSP_W_MIN, min=res["sssp"].levels)  # see the docstring
            tol = hops * SSSP_EPS * dr
            err = (d32[reached].double() - dr).abs()
            rec["sssp_vs_dijkstra"] = {"max_abs_err": float(err.max()),
                                       "worst_share_of_tol": float((err / tol.clamp(min=1e-30)).max())}
            require(bool((err <= tol).all()), f"{tag}: SSSP differs from Dijkstra ({rec})")
        return rec

    def summary(res):
        b = res["bfs"]
        rec = {"bfs_levels": b.levels, "bfs_frontier_sizes": list(b.frontier_sizes[:12]),
               "bfs_decisions": decision_trace(b.decisions),
               "cc_fused_iters": res["cc_fused"].iters, "cc_pb_iters": res["cc_pb"].iters}
        if "sssp" in res:
            rec.update(
                sssp_rounds=res["sssp"].levels, sssp_decisions=decision_trace(res["sssp"].decisions),
                k_core_rounds=res["k_core"].rounds,
                k_core_in_core=int(res["k_core"].in_core.sum()),
                k_core_decisions=decision_trace(res["k_core"].decisions),
                radii_ecc=res["radii"].ecc.tolist(), radii_converged=res["radii"].converged,
                bfs_batched_levels=res["bfs_batched"].levels,
                bfs_batched_decisions=decision_trace(res["bfs_batched"].decisions),
                sssp_batched_rounds=res["sssp_batched"].levels,
                ppr_decisions=decision_trace(res["ppr"].decisions[:1]),
            )
        return rec

    def timings(g, csr, source, w, srcs, full=True):
        """fig8's columns: the executor's run and the unbinned baseline
        (for CC: the random-order baseline, ``connected_components``)."""
        T.set_default_executor(ex)
        fns = {
            "bfs": (lambda: T.bfs(csr, source, executor=ex),
                    lambda: T.bfs(csr, source, method="unbinned")),
            "cc_fused": (lambda: T.connected_components_fused(g, max_iters=g.num_nodes),
                         lambda: T.connected_components(g, max_iters=g.num_nodes)),
            "cc_pb": (lambda: TC.connected_components_pb(g, max_iters=g.num_nodes), None),
        }
        if full:
            fns.update({
                "sssp": (lambda: T.sssp(csr, w, source, executor=ex),
                         lambda: T.sssp(csr, w, source, method="unbinned")),
                "k_core": (lambda: T.k_core(csr, KCORE_K, executor=ex),
                           lambda: T.k_core(csr, KCORE_K, method="unbinned")),
                "radii": (lambda: T.radii(csr, k=RADII_K, max_iters=RADII_ITERS, executor=ex),
                          lambda: T.radii(csr, k=RADII_K, max_iters=RADII_ITERS,
                                          method="unbinned")),
                "bfs_batched": (lambda: T.bfs_batched(csr, srcs, executor=ex, with_parents=True),
                                lambda: T.bfs_batched(csr, srcs, method="unbinned",
                                                      with_parents=True)),
                "sssp_batched": (lambda: T.sssp_batched(csr, w, srcs, executor=ex),
                                 lambda: T.sssp_batched(csr, w, srcs, method="unbinned")),
                "ppr": (lambda: T.personalized_pagerank(csr, srcs, executor=ex),
                        lambda: T.personalized_pagerank(csr, srcs, method="unbinned")),
            })
        out = {}
        for k, (f, base) in fns.items():
            t = time_fn(f, reps=TRAV_REPS, warmup=1)
            rec = {"s": t}
            if base is not None:
                tb = time_fn(base, reps=TRAV_REPS, warmup=1)
                rec.update(unbinned_s=tb, speedup_vs_unbinned=tb / t)
            out[k] = rec
        return out

    def padding_cost(csr, res):
        """Per BFS level: the min reduce of the padded stream against the
        same reduce of its real tuples only (the padding is the op's
        identity at in-range indices), at the level's decision."""
        n = csr.num_nodes
        dist = res["bfs"].dist
        rows = []
        for e in res["bfs"].decisions:
            if e["op"] != "min":
                continue
            lvl = e["level"]
            frontier = torch.nonzero(dist == lvl).flatten().to(torch.int32)
            total = int((csr.offsets[frontier.long() + 1] - csr.offsets[frontier.long()]).sum())
            ids = torch.zeros(bucket_len(frontier.numel()), dtype=torch.int32, device=dist.device)
            ids[: frontier.numel()] = frontier
            nbr, _, _, ok = _expand_frontier(csr.offsets, csr.neighs, ids, frontier.numel(),
                                             bucket_len(total))
            val = torch.where(ok, lvl + 1, INT32_MAX).to(torch.int32)
            d = ex.decide_or_forced(e["method"], n, int(nbr.shape[0]), torch.int32,
                                    kind="reduce", op="min", device=nbr.device)

            def red(i, v, d=d):
                return execute_reduce(i, v, out_size=n, op="min", method=d.method,
                                      bin_range=d.bin_range, num_bins=d.num_bins, plan=d.plan)

            require(same(red(nbr, val), red(nbr[:total], val[:total])),
                    f"BFS level {lvl}: the padded stream reduces to another result")
            rows.append({"level": lvl, "tuples": total, "padded": int(nbr.shape[0]),
                         "method": d.method,
                         "padded_ms": cuda_ms(red, nbr, val, reps=10),
                         "real_only_ms": cuda_ms(red, nbr[:total], val[:total], reps=10)})
        return rows

    K.reset_launch_counts()  # the traversal path starts here (CPU runs launch nothing)
    for name, g in suite.items():
        t0 = time.perf_counter()
        csr, source, w, srcs = prepare(g)
        res = run_all(g, csr, source, w, srcs, ex)
        t_card = time.perf_counter() - t0
        g_cpu = suite_cpu[name]
        want = run_all(g_cpu, *prepare(g_cpu), T.PBExecutor(cache_dir=cache))
        t_cpu = time.perf_counter() - t0 - t_card
        compare(f"phase12 S1 {name}", res, want)
        rec = independent_checks(f"phase12 S1 {name}", g, csr, source, w, srcs, res)
        # BFS and CC-PB under the kernel-backed binning method
        T.set_default_executor(ex_pallas)
        bp = T.bfs(csr, source, executor=ex_pallas)
        cp = TC.connected_components_pb(g, max_iters=g.num_nodes)
        require(same(bp.dist, res["bfs"].dist) and same(bp.parent, res["bfs"].parent)
                and same(cp.labels, res["cc_pb"].labels),
                f"phase12 S1 {name}: use_pallas BFS / CC-PB differ from the default executor")
        say(f"phase12 S1 {name}", json.dumps({"n": g.num_nodes, "m": g.num_edges, "source": source,
                                             **summary(res), **rec, "card_run_s": t_card,
                                             "cpu_run_s": t_cpu}))
    for tag, g in sizes.items():
        full = tag == "S2"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        csr, source, w, srcs = prepare(g)
        res = run_all(g, csr, source, w, srcs, ex, full=full)
        T.set_default_executor(ex_pallas)
        bp = T.bfs(csr, source, executor=ex_pallas)
        require(same(bp.dist, res["bfs"].dist) and same(bp.parent, res["bfs"].parent),
                f"phase12 {tag}: use_pallas BFS differs from the default executor")
        times = timings(g, csr, source, w, srcs, full=full)
        peak = torch.cuda.max_memory_allocated() if on_card else None
        rec = independent_checks(f"phase12 {tag}", g, csr, source, w, srcs, res, dijkstra=full,
                                 lanes=full)
        say(f"phase12 {tag}", json.dumps({"n": g.num_nodes, "m": g.num_edges, "source": source,
                                         **summary(res), **rec, "times": times,
                                         "max_memory_allocated": peak}))
        if full:
            padding = res, csr
            if on_card:  # where a BFS's time goes: expansion, reduces, host syncs
                say(f"phase12 {tag} BFS profile", json.dumps(device_profile(
                    lambda: T.bfs(csr, source, executor=ex), dev)))
        del csr, w, res
    counts, shapes = K.launch_counts(), K.launch_shapes()  # the traversal path ends here
    say("phase12 launches:", json.dumps(counts))
    require(counts["cobra_bin_accumulate"] > 0 and counts["cobra_bin_accumulate_rows"] > 0,
            f"the traversal path did not launch the fused kernels: {counts}")
    if on_card:
        say("phase12 S2 BFS padding", json.dumps(padding_cost(padding[1], padding[0])))
    T.set_default_executor(None)
    return counts, shapes


# -- the graph-serving path (phase 13) ---------------------------------------------


def serving_phase(dev, T, K, suite, s2, cache):
    """Phase 13: graph-query serving through ``GraphFrontend`` on S1's DBP
    and KRON and S2: registration (the preprocessing pipeline, also once
    under ``use_pallas=True``), warmup, FakeClock and real-clock replays
    of one seeded ``make_query_mix`` trace, then S2 edge batches through
    update queries, a forced rebuild and ``bfs_incremental``. Returns the
    kernel launches of the path (counts, shapes)."""
    import numpy as np
    import torch

    from repro_torch.core import updates as U
    from repro_torch.launch.serve_graphs import make_query_mix
    from repro_torch.serving import graph_frontend as F

    ex = T.PBExecutor(cache_dir=cache)
    graphs = {"DBP": suite["DBP"], "KRON": suite["KRON"], "S2": s2}
    names = list(graphs)
    num_nodes = {k: g.num_nodes for k, g in graphs.items()}

    def sync():
        torch.cuda.synchronize()

    def frontend(max_batch, clock, tick_cost=0.0):
        fe = F.GraphFrontend(executor=ex, max_batch=max_batch, clock=clock, tick_cost=tick_cost)
        regs = {name: fe.register_graph(name, g, variant="degree_sort", seed=SERVE_SEED)
                for name, g in graphs.items()}
        return fe, regs

    def trace():
        return F.poisson_trace(SERVE_RATE, SERVE_REQUESTS, make_query_mix(names, num_nodes),
                               seed=SERVE_SEED)

    def same_csr(a, b):
        return torch.equal(a.offsets, b.offsets) and torch.equal(a.neighs, b.neighs)

    def same_edges(a, b):
        """Equal as edge multisets: equal offsets, equal sorted (src, dst) keys."""
        if not torch.equal(a.offsets, b.offsets):
            return False
        seg = T.segment_ids_from_offsets(a.offsets, a.num_edges).long() * a.num_nodes
        return torch.equal(torch.sort(seg + a.neighs.long()).values,
                           torch.sort(seg + b.neighs.long()).values)

    def check_registration(tag, g, reg):
        n = g.num_nodes
        ids = reg.new_ids_dev
        require(torch.equal(torch.sort(ids).values, torch.arange(n, device=dev)),
                f"{tag}: new_ids is not a permutation")
        deg = torch.empty(n, dtype=torch.long, device=dev)
        deg[ids] = torch.bincount(g.src.long(), minlength=n)
        require(bool((deg[:-1] >= deg[1:]).all()), f"{tag}: new ids not in non-increasing degree")
        want = T.build_csr_baseline(T.relabel_coo(g, ids.to(torch.int32)))
        require(same_csr(reg.csr, want), f"{tag}: CSR differs from build_csr_baseline(relabel)")
        require(same_csr(reg.slack.to_csr(), reg.csr), f"{tag}: slack.to_csr() differs")
        rep = reg.report
        say(f"phase13 register {tag}", json.dumps({
            "n": n, "m": g.num_edges, "variant": rep.variant,
            "total_seconds": rep.total_seconds, "total_modeled_bytes": rep.total_modeled_bytes,
            "stages": [{"name": st.name, "seconds": st.seconds,
                        "compile_seconds": st.compile_seconds, "modeled_bytes": st.modeled_bytes,
                        "decisions": [f"{d['kind']}:{d['method']}@r{d['bin_range']}[{d['source']}]"
                                      for d in st.decisions]}
                       for st in rep.stages]}))

    def results(rep):
        return [q.result for q in sorted(rep.completed, key=lambda q: q.qid)]

    def latencies(rep):
        return [q.latency for q in sorted(rep.completed, key=lambda q: q.qid)]

    T.set_default_executor(ex)  # the builds decide through the default executor
    K.reset_launch_counts()  # the serving path starts here
    # registration (the preprocessing pipeline), checked, then warmup and the
    # FakeClock replay, twice
    t0 = time.perf_counter()
    fe_a, regs = frontend(SERVE_BATCH, F.FakeClock(), SERVE_TICK)
    sync()
    say(f"phase13 registered {names} in {time.perf_counter() - t0:.3f} s")
    for name, reg in regs.items():
        check_registration(name, graphs[name], reg)
    wr = fe_a.warmup(probe=True)
    say("phase13 warmup", json.dumps(dataclasses.asdict(wr)))
    rep_a = F.replay_trace(fe_a, trace())
    fe_b, _ = frontend(SERVE_BATCH, F.FakeClock(), SERVE_TICK)
    fe_b.warmup(probe=False)
    rep_b = F.replay_trace(fe_b, trace())
    require(len(rep_a.completed) == SERVE_REQUESTS, "the FakeClock replay left queries undone")
    require(max(e["batch"] for e in fe_a.tick_log) > 1, "the FakeClock replay never coalesced")
    require(fe_a.tick_log == fe_b.tick_log and latencies(rep_a) == latencies(rep_b)
            and rep_a.stats() == rep_b.stats(), "two FakeClock replays differ")
    say("phase13 fake-clock replay", json.dumps({
        "queries": len(rep_a.completed), "ticks": rep_a.ticks, "span_s": rep_a.span_seconds,
        "stats": rep_a.stats(), "kinds": sorted({e["kind"] for e in fe_a.tick_log}),
        "mean_batch": sum(e["batch"] for e in fe_a.tick_log) / len(fe_a.tick_log)}))
    del fe_b, rep_b
    # coalescing: one query a tick gives the same answers
    fe_c, _ = frontend(1, F.FakeClock(), SERVE_TICK)
    rep_c = F.replay_trace(fe_c, trace())
    worst = {}
    for q, one, many in zip(sorted(rep_c.completed, key=lambda q: q.qid), results(rep_c),
                            results(rep_a)):
        if q.kind in ("ppr", "pagerank"):
            ok, rel = pr_close(torch.from_numpy(many), torch.from_numpy(one))
            worst[q.kind] = max(worst.get(q.kind, 0.0), rel["max_rel"])
        else:
            ok = np.array_equal(one, many)
        require(ok, f"phase13: max_batch=1 and max_batch={SERVE_BATCH} differ on {q.kind}")
    say("phase13 coalescing: max_batch 1 == 8", json.dumps({
        "ticks": [rep_c.ticks, rep_a.ticks], "ppr_pagerank_max_rel": worst}))
    del fe_a, rep_a, fe_c, rep_c

    # S2 once more under use_pallas: the builds bin through histogram + positions
    ex_p = T.PBExecutor(cache_dir=cache, use_pallas=True)
    T.set_default_executor(ex_p)
    c0 = K.launch_counts()
    reg_p = F.GraphFrontend(executor=ex_p, clock=F.FakeClock()).register_graph(
        "S2", s2, variant="degree_sort", seed=SERVE_SEED)
    sync()
    c1 = K.launch_counts()
    T.set_default_executor(ex)
    check_registration("S2 use_pallas", s2, reg_p)
    require(c1["histogram"] > c0["histogram"] and c1["counting_positions"] > c0["counting_positions"],
            f"the use_pallas registration did not launch histogram and positions: {c0} -> {c1}")
    require(same_csr(reg_p.csr, regs["S2"].csr), "use_pallas registration's CSR differs")
    del reg_p, regs

    # the real clock
    fe, regs = frontend(SERVE_BATCH, F.Clock())
    wr = fe.warmup(probe=True)
    sync()
    rep = F.replay_trace(fe, trace())
    sync()
    st = rep.stats()
    require(len(rep.completed) == SERVE_REQUESTS, "the real-clock replay left queries undone")
    say("phase13 real-clock replay", json.dumps({
        "queries": len(rep.completed), "ticks": rep.ticks, "span_s": rep.span_seconds,
        "throughput_qps": rep.throughput_qps, "p50_ms": st["p50"] * 1e3,
        "p99_ms": st["p99"] * 1e3, "mean_ms": st["mean"] * 1e3, "max_ms": st["max"] * 1e3,
        "mean_batch": sum(e["batch"] for e in fe.tick_log) / len(fe.tick_log),
        "rate_qps": SERVE_RATE, "warmup_s": wr.seconds}))

    # S2 edge batches through update queries (original ids), 10% deletes
    g = regs["S2"]
    ids32 = g.new_ids_dev.to(torch.int32)
    q0 = F.GraphQuery(tenant="u", graph="S2", kind="pagerank", iters=ITERS)
    fe.submit(q0)
    fe.run_until_drained()
    coo = s2
    ndel = UPDATE_BATCH // 10
    apply_ms, tick_ms = [], []
    for k in range(UPDATE_BATCHES):
        b = U.random_edge_batch(coo, UPDATE_BATCH - ndel, ndel, seed=100 + k)
        # the batch alone on the pre-batch slab, timed (its result dropped)
        nb = U.make_batch(ids32[b.src.long()], ids32[b.dst.long()], b.insert, device=dev)
        sync()
        t0 = time.perf_counter()
        res = U.apply_edge_batch(g.slack, nb, executor=ex)
        sync()
        apply_ms.append((time.perf_counter() - t0) * 1e3)
        coo = U.merge_batch_coo(coo, b)
        uq = F.GraphQuery(tenant="u", graph="S2", kind="update", batch=b)
        fe.submit(uq)
        t0 = time.perf_counter()
        fe.run_until_drained()
        sync()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        require(uq.result.tolist() == [k + 1, UPDATE_BATCH - ndel, ndel, 0],
                f"phase13 update {k}: {uq.result.tolist()}")
    require(g.epoch == UPDATE_BATCHES, f"S2 epoch {g.epoch} after {UPDATE_BATCHES} batches")
    want = T.build_csr_baseline(T.relabel_coo(coo, ids32))
    require(same_edges(g.csr, want), "S2 after the batches differs from build_csr(merge_batch_coo)")
    q1 = F.GraphQuery(tenant="u", graph="S2", kind="pagerank", iters=ITERS)
    fe.submit(q1)
    fe.run_until_drained()
    require(fe.tick_log[-1]["memo"] is False and not np.array_equal(q0.result, q1.result)
            and all(key[1] == UPDATE_BATCHES for key in fe._memo if key[0] == "S2"),
            "the PageRank memo was not recomputed after the batches")
    t0 = time.perf_counter()
    rebuilt, rrep = U.rebuild_slack_csr(g.slack, executor=ex)
    sync()
    rebuild_s = time.perf_counter() - t0
    require(same_csr(rebuilt.to_csr(), g.csr), "the forced rebuild changed the graph")
    # an insert-only batch: bfs_incremental from the pre-batch levels == a full bfs
    b = U.random_edge_batch(coo, UPDATE_BATCH, 0, seed=200)
    nb = U.make_batch(ids32[b.src.long()], ids32[b.dst.long()], b.insert, device=dev)
    source = 0  # degree_sort: new id 0 is the vertex of largest degree
    prev = T.bfs(g.csr, source, executor=ex, with_parents=False).dist
    csr1 = U.apply_edge_batch(g.slack, nb, executor=ex).graph.to_csr()
    touched, has_del = U.touched_vertices(nb)
    sync()
    t0 = time.perf_counter()
    inc, mode = T.bfs_incremental(csr1, source, prev, touched, has_deletes=has_del, executor=ex)
    sync()
    inc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    full = T.bfs(csr1, source, executor=ex, with_parents=False)
    sync()
    full_ms = (time.perf_counter() - t0) * 1e3
    require(mode == "incremental" and torch.equal(inc.dist, full.dist),
            "bfs_incremental differs from a full bfs at S2")
    say("phase13 updates S2", json.dumps({
        "batch": UPDATE_BATCH, "deletes": ndel, "apply_edge_batch_ms": apply_ms,
        "update_tick_ms": tick_ms, "epoch": g.epoch, "slack_fraction": g.slack.slack_fraction,
        "rebuild_s": rebuild_s, "rebuild_stages": {s.name: s.seconds for s in rrep.stages},
        "bfs_incremental_ms": inc_ms, "bfs_incremental_rounds": inc.levels,
        "bfs_full_ms": full_ms, "bfs_full_levels": full.levels,
        "update_decisions": [f"{d['kind']}:{d['method']}@r{d['bin_range']}[{d['source']}]"
                             for d in res.decisions]}))
    counts, shapes = K.launch_counts(), K.launch_shapes()  # the serving path ends here
    say("phase13 launches:", json.dumps(counts))
    require(counts["cobra_bin_accumulate"] > 0 and counts["cobra_bin_accumulate_rows"] > 0,
            f"the serving path did not launch the fused kernels: {counts}")
    T.set_default_executor(None)
    return counts, shapes


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
    from repro_torch.kernels.binning import COBRA_PASS_DESIGNS, cobra_pass_design, positions_design
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

    # the histogram's skewed streams: 2^25 keys with a hub taking half of
    # them, the embedding gradient's zipf ids at 13 bins, keys outside
    # [0, B) with negatives; and the embedding stream itself (262,144 keys)
    m = 1 << 25
    zrng = np.random.default_rng(0)
    zipf = torch.from_numpy((np.minimum((zrng.pareto(1.2, m) * 50).astype(np.int64), EMB_VOCAB - 1)
                             // EMB_BIN_RANGE).astype(np.int32)).to(dev)
    hub = torch.randint(0, 512, (m,), device=dev, generator=gen, dtype=torch.int32)
    hub[torch.rand(m, device=dev, generator=gen) < 0.5] = 170
    for sname, keys, B in (("hub", hub, 512), ("zipf", zipf, 13), ("embedding zipf", zipf[:EMB_T], 13),
                           ("outside", torch.randint(-515, 1027, (m,), device=dev, generator=gen,
                                                     dtype=torch.int32), 512)):
        for off in (0, 1):  # 1: the first key is 4 bytes past a 16-byte boundary
            k = keys[off:]
            eh = int((K.histogram(k, B) - ref.histogram_ref(k, B)).abs().max())
            worst["histogram"] = max(worst["histogram"], eh)
            say("phase2", json.dumps({
                "histogram_stream": sname, "m": k.shape[0], "B": B, "offset": off,
                "max_abs_err": eh, "kernel_ms": cuda_ms(K.histogram, k, B, reps=10),
                "library_ms": None if sname == "outside" else cuda_ms(
                    torch.bincount, k, None, B, reps=10),
                "bound_ms": bound_ms(4 * k.shape[0] + 4 * B)}))
            require(eh == 0, f"histogram differs from plain on the {sname} stream (offset {off})")
    del zipf, hub, keys, k

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

    close = pr_close

    def run_size(tag, g, reps, warmup, ref_cpu=None, pallas=False):
        br, plan, fns = arms(g)
        log0 = len(T.get_default_executor().decision_log)
        times = {a: time_fn(f, reps=reps, warmup=warmup) for a, f in fns.items()}
        arm_times[tag] = times
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
        ex = T.get_default_executor()
        decisions = sorted({
            f"{e['kind']}:{e['method']}@r{e['bin_range']}" for e in ex.decision_log[log0:]
        })
        # a binning decision at the planned range (build_csr(method="auto")): the
        # card's measured table for CUDA streams against the reference's table
        auto_bin = {"cuda": ex.decide(g.num_nodes, g.num_edges, device=dev).describe(),
                    "reference_table": ex.decide(g.num_nodes, g.num_edges, device="cpu").describe()}
        say(
            tag,
            json.dumps({
                "n": g.num_nodes, "m": g.num_edges, "bin_range": br,
                "plan": [plan.final_bin_range, list(plan.level_fanouts)],
                "arm_s": times, "vs_B": rels, "l1_vs_f64": l1_vs_f64,
                "decisions": decisions, "auto_bin_decision": auto_bin,
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

    arm_times = {}
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
    before = K.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run_size("phase3 S3", s3, 3, 1)
    s3_fused = K.launch_counts()["cobra_bin_accumulate"] - before["cobra_bin_accumulate"]
    t_s3 = arm_times["phase3 S3"]
    say("phase3 S3 arm E", json.dumps({
        "E_s": t_s3["E"], "B_s": t_s3["B"],
        "E_s_on_the_hierarchical_path": S3_ARM_E_HIERARCHICAL_S,
        "E_over_B": t_s3["E"] / t_s3["B"], "fused_launches": s3_fused,
        "fused_design": fused_design(s3.num_edges, s3.num_nodes),
        "reduce_decision": T.get_default_executor().decide(
            s3.num_nodes, s3.num_edges, torch.float32, kind="reduce", device=dev).describe(),
        "max_memory_allocated": torch.cuda.max_memory_allocated()}))
    require(s3_fused > 0, "S3: the fused kernel was not launched on the main path")
    # where arm E's time goes: the whole arm once, kernel by kernel
    say("phase3 S3 arm E profile", json.dumps(device_profile(
        lambda: T.pagerank_fused(s3, iters=ITERS), dev)))
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
                library_ms=cuda_ms(lambda: torch.zeros(n, F, device=dev).index_add_(0, idx, val),
                                   reps=5),
                bound_ms=bound_ms(4 * m + 4 * m * F + 4 * n * F),
                # the kernel's own device time: at F = 1 an event-timed loop
                # measures the host's enqueue (PERF.md)
                kernel_device_ms=sum(k[1] for k in kernel_profile(
                    lambda: K.cobra_bin_accumulate_rows(idx, val, n, br, -(-n // br), op))[
                        "kernels"] if "rows" in k[0]),
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
    for name in ("EURO", "HBUBL"):  # fig9's other two stream lengths (DBP and URND: KRON's m)
        g = suite[name]
        for F in F_GRID:
            rows_check(f"S1 {name} dst-sorted", torch.sort(g.dst, stable=True).values,
                       g.num_nodes, F, torch.float32, "add", True)
    rows_check("S1 KRON coo-order", kron_g.dst, kron_g.num_nodes, 32, torch.float32, "add", True)
    s2_sorted = torch.sort(s2.dst, stable=True).values
    for dt in (torch.float32, torch.int32):
        for op in ("add", "min", "max"):  # m * F = 2^31: 64-bit row offsets
            rows_check("S2 dst-sorted", s2_sorted, s2.num_nodes, GNN_D, dt, op,
                       timed=dt == torch.float32 and op == "add")
    torch.cuda.empty_cache()

    def cobra_check(tag, keys, idx, val, nb, rec):
        starts = starts_from_counts(ref.histogram_ref(keys, nb))[:-1].contiguous()
        want = ref.binned_stream_ref(keys, idx, val, nb)
        for design in COBRA_PASS_DESIGNS:
            got = K.cobra_binning_pass(keys, idx, val, starts, nb, design=design)
            ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            say("phase5", json.dumps({
                "cobra_pass": tag, **rec, "m": keys.shape[0], "num_bins": nb,
                "dtype": str(val.dtype), "design": design, "default": cobra_pass_design(nb),
                "equal": ok, "kernel_ms": cuda_ms(K.cobra_binning_pass, keys, idx, val, starts, nb,
                                                  design, reps=3)}))
            require(ok, f"COBRA pass ({design}) on {tag} ({val.dtype}) differs from binned_stream_ref")
            del got

    for tag, g in (("S2", s2), ("S3", s3)):
        for rng_ in T.CobraPlan.from_hardware(g.num_nodes, hw).level_ranges():
            nb = -(-g.num_nodes // rng_)
            keys = bin_ids(g.dst, rng_)
            for val in (g.src, torch.randn(g.num_edges, device=dev, generator=gen)):
                cobra_check(tag, keys, g.dst, val, nb, {"bin_range": rng_})
            del keys
    nb = 2203  # S3's second level, on one key and on a hub taking half of the stream
    for sname in ("one-key", "hub"):
        keys = torch.full_like(s3.dst, nb - 1) if sname == "one-key" else torch.where(
            torch.rand(s3.num_edges, device=dev, generator=gen) < 0.5, 734,
            bin_ids(s3.dst, -(-s3.num_nodes // nb))).to(torch.int32)
        cobra_check("S3", keys, s3.dst, s3.src, nb, {"stream": sname})
        del keys
    torch.cuda.empty_cache()

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
            esize = x.element_size()
            say("phase5", json.dumps({
                "binread": ids_name, "dtype": str(dt), "B": emb["bins"], "L": L, "d": x.shape[1],
                "max_abs_err": err, "ok": ok,
                "kernel_ms": cuda_ms(K.binread_scatter_add, idx_p, val_p, EMB_BIN_RANGE, reps=5),
                "plain_ms": cuda_ms(ref.binread_scatter_add_ref, idx_p, val_p, EMB_BIN_RANGE,
                                    reps=3),
                # the same sum on the compact stream: no PyTorch call takes the padded layout
                "compact_index_add_ms": cuda_ms(lambda: torch.zeros(
                    emb["bins"] * EMB_BIN_RANGE, x.shape[1], dtype=dt, device=dev).index_add_(
                        0, ids, x), reps=5),
                "bound_ms": bound_ms(4 * idx_p.numel() + esize * ids.shape[0] * x.shape[1]
                                     + esize * emb["bins"] * EMB_BIN_RANGE * x.shape[1])}))
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

    # -- phase 12: the traversal path (before phase 11's kernels line) --------------
    t12 = time.perf_counter()
    trav_counts, trav_shapes = traversal_phase(
        dev, T, K, suite, suite_cpu, {"S2": s2, "S3": s3}, cache)
    torch.cuda.empty_cache()
    say(f"phase12 seconds: {time.perf_counter() - t12:.1f}")

    # -- phase 13: the graph-serving path (before phase 11's kernels line) ----------
    t13 = time.perf_counter()
    serving_counts, serving_shapes = serving_phase(dev, T, K, suite, s2, cache)
    torch.cuda.empty_cache()
    say(f"phase13 seconds: {time.perf_counter() - t13:.1f}")

    # -- phase 14: the LM training path (before phase 11's kernels line) ------------
    t14 = time.perf_counter()
    train_counts, train_shapes, emb_bwd = train_phase(dev, K, smi)
    say(f"phase14 seconds: {time.perf_counter() - t14:.1f}")

    # -- phase 15: the MoE serving path (before phase 11's kernels line) ------------
    t15 = time.perf_counter()
    moe_counts, moe_shapes, moe_rows = moe_phase(dev, K, smi)
    say(f"phase15 seconds: {time.perf_counter() - t15:.1f}")

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
            + trav_counts[k] + serving_counts[k] + train_counts[k] + moe_counts[k] for k in after}
    path_shapes = {}
    for part in (after_shapes, fig9_shapes, gnn_shapes, ops_shapes, serve_shapes, trav_shapes,
                 serving_shapes, train_shapes, moe_shapes):
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
        "histogram": {"m": m2, "B": nb2, **kernel_profile(lambda: K.histogram(keys, nb2))},
        "cobra_binning_pass": {"m": m3, "B": nb3, "design": cobra_pass_design(nb3),
                               **kernel_profile(lambda: K.cobra_binning_pass(
                                   keys3, s3.dst, s3.src, starts3, nb3))},
        "counting_positions": {"m": m2, "B": nb2, "design": positions_design(nb2),
                               **kernel_profile(lambda: K.counting_positions(keys, starts, nb2))},
        "cobra_bin_accumulate": {"m": m2, "n": n2, "design": fused_design(m2, n2),
                                 **kernel_profile(lambda: K.cobra_bin_accumulate(
                                     s2.dst, contrib, n2, br2, nb2))}}))
    kernels = []
    designs = {"counting_positions": positions_design(nb2),
               "cobra_binning_pass": cobra_pass_design(nb3),
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
    # Bin-Read's yardstick: the same sum by index_add_ on the compact stream
    # (no single PyTorch call takes the padded layout, so library_ms is null)
    next(k for k in kernels if k["name"] == "binread_scatter_add")["compact_index_add_ms"] = \
        cuda_ms(lambda: torch.zeros(B_ * EMB_BIN_RANGE, d_, device=dev).index_add_(0, ids, x),
                reps=5)
    # the rows kernel at its second shape: the embedding backward of phase 14
    next(k for k in kernels if k["name"] == "cobra_bin_accumulate_rows")["embedding_backward"] = {
        k: emb_bwd[k] for k in ("m", "F", "n", "max_abs_err", "ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_bytes")}
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
    kernels += moe_rows  # rows 2b, 5c, 7b and 8b: phase 15's shapes and launches
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
