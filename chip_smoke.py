#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and ``nvcc``, and
imports only ``repro_torch`` (never JAX or ``repro``). It exits non-zero,
without a result line, when CUDA is unavailable, when the package is not
beside it, or on any mismatch. Each phase prints its seconds. Phases:

1. Device: ``nvidia-smi`` name and power limit, the device properties
   beside ``HardwareModel.h100()``, then the kernels' build (nvcc, sm_90a),
   and the HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync)
   instructions that ``cuobjdump -sass`` finds in each flash kernel: every
   bfloat16 one (head dims 16, 32, 64, 80 and 128, in blocks of 64 and
   128 queries) must have HGMMA and UTMALDG and no HMMA, and the float32
   ones none of the three; and the REDG.E.ADD.F32x4 (float4 reduction)
   instructions in each instantiation of the rows kernel's tile walk: the
   float32 add of 16-byte rows must have them.
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
   arms must agree, and the fused arm with the port on the CPU at F in
   ``FIG9_CPU_F`` (the CPU runs at F = 32 and 128 were cut to make room
   for phase 20). Then one
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
   for hd in {16, 32, 64}, at every Sq, Skv in {1, 15, 63, 65, 127,
   129} (around the 64-row tiles), and around the 128-row tiles in
   128-query blocks ((12, 12, 2, Sq, Skv, hd) for hd in {80, 128}); then
   where outputs nearly cancel (v = +-1 alternating by key), which a
   bfloat16-rounded P would fail.
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
   on the five S1 graphs and S2, and BFS and CC at S3, every result
   held to code that does not use the executor (the S1 graphs' runs on
   the CPU were cut: the road and bubble graphs' for phase 18, those of
   DBP, KRON and URND for phase 20): at every size BFS levels and
   parents must equal a dense plain-torch BFS (parent: the largest-id
   predecessor on the previous level), CC labels scipy's weak components
   at S1 (at S2 and S3 a plain-torch min-label propagation on the card:
   the S3 checks took 46 s with scipy), both labelled by their smallest
   vertex, k-core
   ``k_core_oracle``; at S1 and S2 SSSP scipy's Dijkstra in float64; at
   S2 each batched lane must equal its single-source run; at S1 every
   ``sssp_batched`` lane scipy's Dijkstra, every ``bfs_batched`` lane the
   dense BFS, PPR ``personalized_pagerank_oracle`` (float64) by the
   PageRank tolerance, and radii the dense BFS's eccentricities from its
   own seeded draw (capped at its ``max_iters``). S2 and S3 print ``timing.time_fn`` times beside
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
   sequence; its global batch of 256 cut to 4 for one card): 3 steps,
   one more step under ``torch.profiler``, then the checkpoint path at 4
   of the 28 layers: 3 steps with a checkpoint at the end and a resume to
   step 4 whose restore must give the saved state (``_mesh_fingerprint``
   of both: sums of the bit patterns and their squares, tensor by
   tensor). Cut to make room: the async save at step 2, a 15.5 GB host
   copy that stalled a step (phase 18); the resumed run's save after step
   4 (phase 20); the checkpoint of the whole model, a 15.5 GB write and
   two reads (phase 21).
   Losses and grad norms must be
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
16. (Runs before phase 11.) Sharded PB: four ranks of one gloo group on
   ``cuda:0`` (``launch/ranks.py``: spawned, a FileStore in a temporary
   directory, joined with a deadline; a rank that fails or hangs fails
   the run). Every rank builds S2 and S3 from the same seeds and computes
   the single-device results first; then, with the launch counts set to
   0: ``shard_reduce_stream`` on S2's destination stream for add
   (float32, PageRank's contributions), min and max (int32) at K = 1, 2,
   4, packed and with two collectives, and at the executor's decided K,
   each against ``execute_reduce``; a row-valued add at F = 64 on the
   first 2^24 tuples against the plain sum (the whole stream's 8.6 GB of
   values, which every rank holds, ran the card out of memory: 17.3 GiB
   on a rank, four ranks); a forced overflow (capacity 1: ``fallback`` and an
   equal result); ``build_csr(method="sharded")`` equal to
   ``build_csr_baseline``; ``pagerank_sharded`` (10 iterations) against
   ``pagerank_fused``; ``connected_components_sharded`` labels and rounds
   equal to the fused run's; ``bfs(mesh=)`` levels and parents equal to
   ``bfs``; ``PreprocessPipeline(mesh=)`` ids, CSR and CSC equal to the
   single-device pipeline's; one in-degree reduce under
   ``PBExecutor(use_pallas=True)``, method pallas (histogram and
   positions must launch). At S3 (counted apart): ``build_csr_sharded``
   equal to the single-device build bit for bit and ``pagerank_sharded``
   against arm E, held on rank 0. Printed: each call's seconds on rank 0
   after a barrier (a one-card emulation: gloo stages every collective
   through host memory, so these are no interconnect's times), the info
   dicts, the decisions, the modeled per-device bytes
   (``traffic.sharded_*``), a ``torch.profiler`` listing of rank 0's S2
   reduce, each rank's peak memory and the launches summed over the
   ranks. Rank 0 also holds the fused and rows kernels against their
   plain versions at its local reduce's shapes (rows 4c and 5d).
17. (Runs before phase 11.) The recurrent families: (a) flash at head_dim
   80 against its plain version, float32 and bfloat16, causal and not, at
   zamba2's heads (1, 32, 32, S, 80) for S in {1000, 1024} and at
   (1, 8, 2, 333, 80), then where outputs nearly cancel; (b) Mamba2 at
   zamba2's width and mLSTM and sLSTM at xlstm's, float32, each on the
   card against its CPU copy (a ragged 300-token prefill, then a decode
   step) and, on the card, the prefill + decode against 301 decode steps
   from zero; (c) one full-width float32 cycle of each model (zamba2: 6
   Mamba2 blocks and the shared block; xlstm: mLSTM + sLSTM) on the card
   against the CPU, a 300-token prefill and 8 greedy decode steps; then
   ``zamba2-2.7b`` (54 Mamba2 layers, 9 applications of the shared
   attention block) and ``xlstm-350m`` (24 layers) at full width and depth
   in bfloat16 from a seeded generator: (e) served by ``Engine`` (4 slots,
   4 requests of 128-512 prompt tokens, 32 new each, 2048 positions;
   flash launches exactly 9 times a zamba2 prefill and never for xlstm),
   with prefill tokens/s, decode ms a tick, peak memory, a profile of one
   prefill and one decode tick, xlstm's mLSTM and sLSTM timed apart at the
   longest prompt, and (d) the engine with one slot against a manual
   prefill + decode loop (tokens and every cache leaf). The serves'
   launches go into phase 11's counts.
18. (Runs before phase 11.) Training of the moe, ssm and hybrid families.
   (a) The MoE backward's two PB calls at phase 15's 972-token prefill
   (d 4096, 128 experts, top-8, bfloat16): the dispatch's backward (kept
   cotangent rows gathered in token order, k a token summed by the rows
   kernel) against a float64 ``index_add_`` under phase 15's rule, the
   combine's backward (weighted cotangent rows written to their slots by
   ``scatter_rows``) equal to ``index_copy_``; each timed beside its
   library call and its bound (rows 5e, 7c). (b) One full-width float32
   MoE layer (capacity factor 1.25, counting dispatch) on 256 tokens: the
   gradients of the input and of every weight, card against CPU, within
   1e-4 of max |g|, routed alike, the forward launching the row scatter
   and the rows kernel once each and the backward once more each; then
   one AdamW step of a one-cycle full-width float32 copy of zamba2-2.7b
   (6 Mamba2 blocks and the shared block) and of xlstm-350m, card against
   CPU, as 14c (zamba2's gradients and moments within 2e-4, ``FAM_TOL``). (c) ``launch/train.py`` at full width, 3 steps
   each, bfloat16 with remat: zamba2-2.7b (54 Mamba2 blocks, AdamW, B 2 x
   S 1024), qwen3-moe-235b-a22b (2 of 94 layers, Adafactor as for the full
   model, counting dispatch, B 2 x S 1024: 16,384 assignments, C = 160)
   and xlstm-350m (12 cycles, AdamW, B 4 x S 64), the config and the
   optimizer set on the launcher's ``get_config`` and
   ``default_opt_config``. Losses and grad norms finite, every moment
   moved, and the launches exact: per step the embedding backward's rows
   kernel, per MoE layer the row scatter, histogram, positions and rows
   kernel in the forward and the remat recompute, then the rows kernel
   (dispatch backward) and the row scatter (combine backward), and flash
   twice per attention use. Printed: ms a step, tokens/s, model FLOP/s
   (``flops_per_token``) beside 989 TFLOP/s, peak memory, and a profile of
   one more step (xlstm's at S 16: its full step is some 400,000
   launches; zamba2's at S 256: the profiler's processing of its full
   step took 44-45 s, cut for phase 19). Its launches go into phase 11's
   counts.
19. (Runs before phase 11.) The vlm and encdec families. (a) Flash
   against its plain version, float32 and bfloat16, non-causal, at the
   vlm's cross-attention (1, 32, 8, Sq, 1601, 128) for Sq in {1, 300,
   1024, 2048}, Whisper's encoder (1, 8, 8, 1500, 1500, 64) and decoder
   cross-attention (4, 8, 8, 448, 1500, 64), then where outputs nearly
   cancel. (b) Float32 at full width, card against CPU: one vlm cycle (4
   self layers and the cross layer, d 4096) with a 1,601-row image and
   without one (the ``Engine``'s path: cross keys from the prompt), and
   whisper-base whole with 1,500 frames, each a 300-token prefill's last
   logits and 8 greedy decode steps; one vlm cross layer's gradients
   (input, source, every weight) with the image; one AdamW step of
   whisper-base whole with its frames (14c's rule). Then
   ``llama-3.2-vision-11b`` (40 layers, 9.8 B parameters) and
   ``whisper-base`` at full width and depth in bfloat16 from a seeded
   generator: (c) served by ``Engine`` (prompts only, as in the
   reference; 4 slots, 8 requests of 256-1,024 prompt tokens from numpy
   seed 0, 32 new each, 2,048 positions): every request done, flash
   exactly once per attention layer per prefill (32 self + 8 cross; 6 + 6)
   and never at decode, with prefill tokens/s, decode ms a tick, peak
   memory and a profile of the longest prefill and a decode tick; (d) the
   engine with one slot against a manual prefill + decode loop (tokens
   and every cache leaf); (e) a manual prefill with the frontend input
   (the vlm: a 1,024-token prompt and a 1,601-row image; Whisper: 1,500
   frames and 448 tokens), then 32 greedy decode steps that read the
   cross caches: flash 40 (vlm) and 6 + 6 + 6 (encoder, self, cross)
   times at the prefill, never at decode; prefill ms and ms a step. (f)
   Training: three steps of ``make_train_step`` on ``make_batch``'s
   inputs, bfloat16 with remat, AdamW: whisper-base whole (B 4 x S 4096,
   1,500 frames) and the vlm at full width with 2 of its 8 cycles (10 of
   40 layers, B 2 x S 2048, 1,601-row images): losses and grad norms
   finite, every moment moved, per step the rows kernel once (the
   embedding backward) and flash once per attention use and again in the
   remat recompute of each vlm cycle and Whisper decoder layer (the
   encoder is not recomputed): 30 a Whisper step, 20 a vlm step. Then
   ``launch/train.py`` for whisper-base (3 steps, B 4 x S 4096), whose
   batches hold no frames, as the reference's: the cross layers' and the
   encoder's moments stay exactly zero (their gradients are 0), every
   other moment moves, flash 12 a step. Printed: ms a step, tokens/s,
   model FLOP/s beside 989 TFLOP/s, peak memory. Its launches go into
   phase 11's counts.
20. (Runs before phase 11.) The dense and MoE LMs over a (data, model)
   mesh: MESH_RANKS ranks of one gloo group on ``cuda:0``
   (``mesh_rank``; an emulation with no interconnect: gloo stages every
   collective through host memory, so its times say nothing about
   scaling). (a) On 2x2 and 1x4, every leaf of qwen2-1.5b and of
   qwen3-moe (2 layers) from ``init_params(mesh=)``: its block has
   ``spec_for``'s shape and equals its block of the one-rank draw bit for
   bit, and for qwen2 the all-gather of every leaf equals the draw. (b)
   One float32 AdamW step of qwen2-1.5b at 4 of its 28 layers (full
   width), B 4 x S 512, on 2x2 and on 1x4 (2 KV heads do not split 4
   ways: the gathered fallback), against the one-device step of the same
   weights, which every rank takes. (c) qwen3-moe's layer at full width
   (d 4,096, 128 experts, top 8), bf16, on 2x2: the expert-sharded
   ``moe_apply`` on 4 x 256 tokens against the one-device layer on each
   data rank's rows (the same capacity from the same local T, so the
   same drops, counted), the weight-stationary decode on 4 tokens against
   ``_moe_dense_oracle``, ``moe_combine_sharded`` over the data axis on
   32,768 assignments against ``index_add_``. (d) ``launch/train.py
   --mesh host:2x2`` inside the group, bf16, remat: qwen2-1.5b at full
   width with 7 of its 28 layers, B 4 x S 2048, AdamW, 3 steps with a
   checkpoint (in blocks, each rank its file) after step 2; qwen3-moe at
   full width with 1 of 94 layers, B 2 x S 256, Adafactor, counting, 2
   steps; losses and grad norms finite and equal on every rank, the
   launches exact (``mesh_launcher_run``); printed: ms a step, tokens/s,
   the host seconds inside ``torch.distributed``'s calls on rank 0, each
   rank's peak memory. (e) ``compressed_psum_tree`` of the last qwen2
   step's gradients over the data axis, twice; ``gpipe_apply`` over 4
   stages of 7 full-width qwen2 layers, 8 microbatches of 1 x 1024,
   against the 28 layers in order on rank 0. (f) The step-2 checkpoint
   restored onto ``ElasticPlan(2, 2, 2)``'s mesh, 1x2 over ranks 0 and 1
   with accumulation 2: its fingerprint equal to the saved state's, then
   one step whose loss equals the 2x2 mesh's step 3. Its launches (of
   (d)) go into phase 11's counts.
21. (Runs before phase 11.) Serving over a (data, model) mesh, and the
   ssm, hybrid, vlm and encdec families on a mesh: SMESH_RANKS ranks of
   one gloo group on ``cuda:0`` (``serve_mesh_rank``; an emulation, as
   phase 20). Every rank holds its ``spec_for`` blocks of the weights and
   of the caches, and the engines' one-device twins run on rank 0. (a)
   qwen2-1.5b at full width with 4 of its 28 layers, float32, served on
   2x2 and on 1x4 (2 requests, the longer of 255 tokens, 4 new each, 4
   slots of 512, so that the decodes write and attend across the 2x2
   cache's block boundary at 256) against the one-device engine of the
   same weights: tokens equal, every prefill's and tick's logits within
   LM_TOL of max |logit|. (b)
   ``launch/serve.py --mesh host:2x2`` inside the group: qwen2-1.5b
   whole, bf16, 4 slots of 2048, 4 requests of 64-511 tokens, 16 new
   each; the launcher checks that every rank's tokens agree, and every
   prefill's logits, and every tick's on the slots whose tokens so far
   agree, must be within SMESH_BF16_TOL of the one-device engine's; printed: TTFT, tokens/s, ms a tick, the
   host seconds inside ``torch.distributed`` on each rank, each rank's
   peak memory. (c) qwen3-moe at full width with 2 of its 94 layers
   (counting dispatch), float32, served on 1x4 (the expert-sharded layer)
   against one device as (a); on 2x2 the engine's one-row prefill must raise the
   reference's batch-split error. (d) zamba2-2.7b (1 of its 9 cycles),
   xlstm-350m (4 of its 12), llama-3.2-vision-11b (1 of its 8) and
   whisper-base (whole) at full width: 2 steps of ``launch/train.py --mesh host:2x2`` inside the group
   (SMESH_FAM_TRAIN's shapes, bf16, remat; losses finite and equal on
   every rank, the launches exact), then 2 requests (the longer of 255
   tokens, so that the decodes cross the block boundary as (a)'s) served
   over 2x2 in float32 against one device as (a). Its launches go into phase 11's counts.
22. (Runs before phase 11.) The stream contract, the dry run and the
   linter (``contract_phase``). (a) ``check_stream`` at the cheap level on
   S2's stream and decision inside ``torch.cuda.set_sync_debug_mode
   ("error")``, beside a control sync that must raise there. (b) Arms C,
   D and E's reduce streams at S2 and S1 KRON's dst-sorted rows at F = 32
   through ``PBExecutor.reduce_stream`` with their true claims, with and
   without ``REPRO_PB_CHECK=1``: equal within the add rule, each arm's ms
   both ways and the full check's own ms printed; an index of n under
   ``in_bounds=True`` and one backwards pair under ``sorted_within=1``
   must raise ``ContractError`` named ``in-bounds`` and ``sortedness``.
   (c) ``launch/dryrun.py``'s trace of phase 14's step on ``meta`` (one
   rank, B 4 x S 4096, bf16): its peak within DRYRUN_PEAK_TOL (20%) of
   phase 14's ``max_memory_allocated``, its counted FLOPs at least the
   model-FLOP count; both gaps printed. (d) The port's linter over
   ``src/repro_torch``, ``chip_smoke.py`` and ``scripts/torch_*.py``: no
   finding. Its launches are checks and do not count.
11. The ``kernels`` JSON line: each kernel's launches on the paths of
   phases 3-4, 6, 7, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20 and 21 (counts
   set to 0 before each path, read after it; the checks of phases 2, 5,
   8, 10, 11, 14a-c, 15a-e, 17a-d, 18a-b, 19a-b, d, 20a-c, e-f and the
   one-device engines of 21 do not count; ``launches_16`` is phase 16's
   share, summed over its ranks, ``launches_18`` phase 18's,
   ``launches_19`` phase 19's, ``launches_20`` phase 20's and
   ``launches_21`` phase 21's, summed over their ranks),
   its largest error against its plain version, and
   times at a path's shapes (Bin-Read's row also ``compact_index_add_ms``,
   the rows kernel's an ``embedding_backward`` record at phase 14's
   shape; the rows kernel's launches also split by walk, ``narrow`` or
   ``tile`` as ``rows_design`` names them, and by shape m,F,n, and each
   rows-kernel line its ``rows_design``), then rows 2b, 5c, 7b and 8b
   (``<kernel>:moe_...``): positions,
   the bfloat16 rows kernel, the row scatter and flash at phase 15's
   shapes with phase 15's launches, and rows 4c and 5d
   (``<kernel>:sharded_s2_local``): the fused and rows kernels at phase
   16's local shapes with its launches, and row 8c
   (``flash_attention:hybrid_prefill``): flash at the longest zamba2
   prefill's shape with phase 17's launches (each flash row also carries
   ``kernel_device_ms`` from ``torch.profiler``), and rows 5e
   (``cobra_bin_accumulate_rows:moe_dispatch_backward``) and 7c
   (``scatter_rows:moe_combine_backward``) at phase 18a's shapes with
   phase 18's launches, and rows 8d (``flash_attention:vlm_cross_prefill``,
   (1, 32, 8, 1024, 1601, 128) non-causal), 8e
   (``flash_attention:whisper_encoder``, (1, 8, 8, 1500, 1500, 64)
   non-causal) and 5f (``cobra_bin_accumulate_rows:vlm_embedding_backward``:
   4,096 token rows of 4,096 into the vlm's 128,256-row vocabulary) with
   phase 19's launches (``launches_19`` on every row is phase 19's share),
   and rows 8f (``flash_attention:mesh_local_heads``: a 2x2 rank's (2, 6,
   1, 2048, 128) causal) and 5g
   (``cobra_bin_accumulate_rows:mesh_vocab_parallel_embedding_backward``:
   a rank's 4,096 token rows of 1,536 into its 76,032 rows of the
   vocabulary, the ids outside them -1) with phase 20's launches, and row
   8g (``flash_attention:serve_mesh_local_heads``: a 2x2 rank's (1, 6, 1,
   S, S, 128) causal at 21b's longest prompt) with phase 21's launches;
   then the result line. Before it: the
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
to 1e-5 * sum|v| plus 1e-6 times the largest sum|v| when that is below
1 (a flat 1e-6 would pass an all-zero sum of PageRank's contributions,
about 3e-8 each at S2), and phases 11 and 16 plant faults (all zeros,
the odd tuples dropped, the one weakest tuple dropped) that this rule
must refuse; ``pb_scatter_add_full`` to that plus
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
Recurrent families (phase 17): flash at head_dim 80 by phase 8's rule;
each recurrent layer within 1e-3 of max(1, max |want|), card against CPU
and chunked against step by step (mLSTM's normalizer |q . n| nearly
cancels at some positions, and there its two float32 forms differ by up
to 6.3e-5 of max |out| on the CPU; REC_LAYER_TOL); the one-cycle float32
models as phase 10; the engine equal to the manual loop bit for bit.
Sharded PB (phase 16): min, max, integer add, CSRs, labels, levels and
parents equal the single-device results exactly (order-free ops, stable
exchanges); a float32 add sums per rank and per chunk, and is held to
the float32 add rule above against ``execute_reduce``; PageRank to the
PageRank tolerance.
Training of the families (phase 18): the dispatch backward's bfloat16
rows reduce by phase 15's rule for the combine, the combine backward's
row scatter exactly; the float32 MoE layer's gradients within TRAIN_TOL
of max |g| (sums of k rows and of the experts' products in another
order; the two sides must route alike); the one-cycle float32 steps as
14c, zamba2's gradients and moments within ``FAM_TOL``: the
reference's own float32 conditioning, which the CPU tests measure
(Mamba2's decays and gated norm; mLSTM's normalizer |q . n|, which
crosses zero at some positions, amplifies more, yet xlstm's one cycle
holds TRAIN_TOL here), and AdamW's v (g squared) doubles a gradient's
relative error.
The vlm and encdec families (phase 19): flash by phase 8's rule; the
float32 copies as phase 10 (logits within 1e-4 of max |logit|, tokens
equal); the cross layer's gradients within TRAIN_TOL of each tensor's max
|g|; Whisper's float32 step as 14c; the engine equal to the manual loop
bit for bit; the launcher's unreached leaves' moments exactly zero.
The LMs over a mesh (phase 20): blocks, gathers, the GPipe run and the
restored state equal bit for bit or within 2^-8 of max |y| (GPipe); the
float32 step's loss within rtol 1e-5, AdamW's moments within 1e-5 of
their leaf's max (the key bias's of ``wk``'s), its parameters within 2 lr
+ 1e-6 (an element whose gradient is rounding noise moves by about lr in
its sign; the leaves beyond 1e-5 of their max are printed); the MoE
layers by phase 15's rule, times 2 for the expert-sharded layer (the
model ranks' partial sums and the psum round once more) and times 4 for
the weight-stationary one (its products round per data rank before
their sum), each limit also rejecting every planted fault that drops an
assignment; the sharded combine within one bfloat16 rounding of the
float64 sum; compression's error within the reference test's 0.05 and
the two-step error no larger; the re-meshed step's loss within rtol 1e-3.
Serving over a mesh (phase 21): float32 engines as phase 10 (tokens
equal, every logged logits within 1e-4 of max |logit|: the ranks' sums
run in another order); bfloat16 engines, mesh against one device,
within SMESH_BF16_TOL (2%) of max |logit| at every prefill and at every
tick on the slots whose request's tokens so far agree: a row-parallel
product's two bfloat16 halves and their psum round once more than one
device's product, and the difference grows through 28 residual layers
(the worst of 38 readings at the first prefill and tick was 0.99%, PERF.md;
2% is about five bfloat16 rounding steps of the largest logit, 2^-8
each); later tokens may part at a bfloat16 near tie, so the tokens'
agreement is printed, not required.
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
ADD_ATOL = 1e-6  # times the largest such sum, when below 1 (_add_limit)
POS_TILE = 16384  # csrc/positions.cu kPosTile: the onesweep tile
F_GRID = (1, 8, 32, 128)  # benchmarks/fig9_spmm.py
ITERS9 = 8  # fig9's chained reduce -> gather rounds at bench scale
FIG9_CPU_F = (1, 8)  # phase 6: the widths at which the fused arm is held to the CPU
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
    # around the 128-row tiles of 128-query blocks (12 x 12 heads fill the SMs)
    + [(12, 12, 2, sq, skv, hd) for hd in (80, 128)
       for sq, skv in ((127, 129), (129, 127), (255, 257), (257, 255))]
)
FLASH_CANCEL_SHAPES = [(1, 2, 2, 128, 128, 16), (1, 12, 2, 512, 512, 128),
                       (1, 12, 2, 2048, 2048, 128), (1, 12, 2, 100, 1000, 64),
                       (12, 12, 2, 300, 300, 80)]
FLASH_F32_ATOL = 1e-4  # flash kernel vs plain, float32 (see flash_close)
FLASH_BF16_REL, FLASH_BF16_FLOOR = 2.0**-7, 1e-4  # bfloat16: times |plain| plus the floor
PROFILE_GUARD_MS = 20.0  # least spin time before and after a profiled call (_profiled)
PROFILE_SPIN_MS = 1.0  # one spin kernel of the guard
PROFILE_TRIES = 5  # profiles of one call before the run fails (_profiled)
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
REC_ARCHS = ("zamba2-2.7b", "xlstm-350m")  # phase 17: the hybrid and the ssm family
REC_SEED = 17
# 4 requests (8 until PR 27's review follow-up: one wave of the slots, not two)
REC_SLOTS, REC_MAX_LEN, REC_REQUESTS, REC_MAX_NEW = 4, 2048, 4, 32
REC_PROMPT_LENS = (128, 512)  # (256, 1024) until phase 21: xlstm's prefill is a loop a token
REC_FLASH_SHAPES = [(1, 32, 32, 1024, 1024, 80), (1, 32, 32, 1000, 1000, 80),  # zamba2's heads
                    (1, 8, 2, 333, 333, 80)]  # head_dim 80 under GQA, ragged
REC_FLASH_CANCEL_SHAPES = [(1, 32, 32, 1024, 1024, 80)]
REC_LAYER_S = 300  # phase 17 (b): ragged against both chunks (64: zamba2, 256: xlstm)
# (b): card vs CPU and chunked vs token by token, times max(1, max |want|). mLSTM's
# output divides by |q . n| + 1e-6, which nearly cancels at some positions: its two
# float32 forms (chunked, step by step) differ there by 2.9e-5 to 6.3e-5 of max |out|
# at full width on the CPU (four seeds); Mamba2 and sLSTM by 5e-6 or less
REC_LAYER_TOL = 1e-3
TRAIN_B, TRAIN_S = 4, 4096  # train_4k's sequence; its global batch of 256 cut to 4 for one card
TRAIN_STEPS = 3  # then the checkpointed run's one more from its checkpoint
TRAIN_CKPT_LAYERS = 4  # the checkpoint and resume: 4 of qwen2's 28 layers (28 until phase 21)
# phase 14's (and 18's) card-vs-CPU step, B 1. At 128 tokens zamba2's one-cycle gradients
# differed card vs CPU by 1.5e-3 of max |g| (2e-4 allowed; 9.7e-5 at 256). It is the Mamba2
# chain's float32 conditioning at that batch (scripts/torch_zamba2_witness.py): moving each
# weight by one ulp moves the CPU's own gradients by 4.3e-4 to 1.1e-3, and the card's float64
# gradients equal the CPU's to 8e-12. So the step stays at 256
TRAIN_CPU_S = 256
TRAIN_TOL = 1e-4  # card vs CPU gradients and moments: times the tensor's max
FAM_ARCHS = ("zamba2-2.7b", "qwen3-moe-235b-a22b", "xlstm-350m")  # phase 18's launcher runs
FAM_SEED = 18
FAM_STEPS = 3
FAM_MOE_LAYERS = 2  # of qwen3-moe's 94: 2.49 B parameters a layer, 1.25 B in the embeddings
# (B, S) a step: zamba2 2,048 tokens (29 GB of bf16 parameters and gradients and float32
# moments, one recomputed cycle); qwen3-moe 2,048 (16,384 assignments, C = 160); xlstm
# 512 (its sLSTM loop: about 14 launches a token a layer in each forward, so some
# 100,000 launches a step with remat and the backward). Until phase 21: zamba2 2 x
# 2048, xlstm 4 x 512; xlstm 4 x 128 until PR 27's review follow-up
FAM_SHAPES = {"zamba2-2.7b": (2, 1024), "qwen3-moe-235b-a22b": (2, 1024), "xlstm-350m": (4, 64)}
# the profiled step's S: xlstm's full step is some 400,000 launches, and the profiler's
# processing of zamba2's full step (44-45 s) and xlstm's at S 32 (20-21 s) took a third of
# phase 18; cut to make room for phase 19, and again (from 16 and 256) for phase 21
FAM_PROFILE_S = {"xlstm-350m": 8, "zamba2-2.7b": 128}
FAM_MOE_T = 972  # check (a): phase 15's longest prefill (its prompts from MOE_SEED)
FAM_CPU_T = 256  # check (b): the MoE layer's tokens
# check (b): zamba2's one-cycle card-vs-CPU step. Its Mamba2 chain amplifies float32
# order (tests/test_torch_train_families.py holds its CPU gradients to 6e-5), and AdamW's
# v, a squared gradient, doubles a gradient's relative error: measured 9.7e-5 (gradients),
# 9.4e-5 (m) and 1.13e-4 (v) of max in two runs on the card
FAM_TOL = {"zamba2-2.7b": 2e-4}
FLASH_GRAD_SHAPE = (1, 12, 2, 1024, 128)  # (B, H, KH, S, hd): qwen2-1.5b's heads
X_ARCHS = ("llama-3.2-vision-11b", "whisper-base")  # phase 19: the vlm and encdec families
X_SEED = 19
X_SLOTS, X_MAX_LEN, X_REQUESTS, X_MAX_NEW = 4, 2048, 8, 32
X_PROMPT_LENS = (256, 1024)  # within the cross caches: 1,601 image rows, 1,500 frames
# check (a): flash at the cross-attention shapes (B, H, KH, Sq, Skv, hd), non-causal: the vlm's
# 32 query heads over 8 KV heads of 128 against its 1,601 image rows (not a multiple of the
# 64-key tile), Whisper's encoder over 1,500 frames and its decoder's cross-attention
X_FLASH_SHAPES = [(1, 32, 8, Sq, 1601, 128) for Sq in (1, 300, 1024, 2048)] + [
    (1, 8, 8, 1500, 1500, 64), (4, 8, 8, 448, 1500, 64)]
X_FLASH_CANCEL_SHAPES = [(1, 32, 8, 1024, 1601, 128), (1, 8, 8, 1500, 1500, 64)]
# check (e): (prompt tokens, frontend rows) of a manual prefill with the frontend input
X_FRONTEND_PREFILL = {"llama-3.2-vision-11b": (1024, 1601), "whisper-base": (448, 1500)}
X_DECODE_STEPS = 32
# check (f): (B, S, cycles) of the train steps; the vlm at full width with 2 of its 8
# cycles (10 of 40 layers: 3.25 B parameters, about 45 GB reckoned with AdamW's float32
# moments, bf16 gradients and the embedding backward's 2.1 GB float32 accumulator)
X_TRAIN = {"whisper-base": (4, 4096, None), "llama-3.2-vision-11b": (2, 2048, 2)}
X_STEPS = 3
S3_ARM_E_HIERARCHICAL_S = 0.348960  # S3 arm E on the hierarchical path (PERF.md, section 5)
INT32_MAX = 2**31 - 1
F32_MAX = 3.4028234663852886e38  # float32's largest value: SSSP's unreached distance
KCORE_K = 3  # benchmarks/fig8_traversal.py
RADII_K, RADII_ITERS = 4, 300  # benchmarks/fig2_preproc_cost.py
TRAV_BATCH = 8  # sources of the batched BFS/SSSP and of PPR
TRAV_REPS = 1  # time_fn repetitions of the traversal phase (3 until phase 20, 2 until 21)
SERVE_REQUESTS = 64  # phase 13's trace: make_query_mix, Poisson arrivals
SERVE_RATE = 200.0  # queries per second (launch/serve_graphs.py's default)
SERVE_BATCH = 8  # max_batch (launch/serve_graphs.py's default)
SERVE_TICK = 0.02  # FakeClock seconds a tick: arrivals (every 5 ms) queue and coalesce
SERVE_SEED = 0
UPDATE_BATCH = 4096  # edges a batch, 10% of them deletes
UPDATE_BATCHES = 4
SHARD_RANKS = 4  # phase 16's ranks, all on cuda:0 (NCCL refuses two ranks on one card)
SHARD_TIMEOUT = 420  # s: the deadline of phase 16's ranks (spawn, build, run, join)
SHARD_KS = (1, 2, 4)  # pipeline depths held against the single-device reduce
SHARD_S2 = (1 << 22, 8)  # gen_uniform's (vertices, degree): phases 3-4's S2
SHARD_S3 = (32_000_000, 4)  # and S3, the paper's scale
# phase 16's row stream (F = GNN_D): the first half of S2's destinations. The
# whole stream does not fit: every rank holds the whole 8.6 GB value tensor,
# and on the H100 a rank ran out at 17.3 GiB allocated (80 GB for four)
SHARD_ROWS_M = 1 << 24
MESH_RANKS = 4  # phase 20's ranks, all on cuda:0: the 2x2 and 1x4 meshes
MESH_TIMEOUT = 900  # s: the deadline of phase 20's ranks (spawn, run, join)
MESH_SEED = 20
MESH_F32 = (4, 4, 512)  # (b): qwen2-1.5b float32 at 4 of its 28 layers, B 4 x S 512
# (b): each leaf's update, |du_mesh - du_one| / |du_one|, as tests/test_torch_mesh_train.py's
# UPDATE_RTOL (at most 7.2e-5 there on the CPU); a skipped update reads 1, a flipped one 2
MESH_UPDATE_RTOL = 1e-3
MESH_MOE_T = (4, 256)  # (c): the expert-sharded layer's B x S
MESH_WS_T = 4  # (c): decode tokens of the weight-stationary layer
MESH_COMBINE_M = 32768  # (c): moe_combine_sharded's assignments (4,096 tokens, top 8)
MESH_MOE_LAYERS = 2  # (a): qwen3-moe at full width, 2 of its 94 layers
# (d), (f): layers at full width: qwen2 7 of its 28, qwen3-moe 1 of its 94 (28 and 2 until
# phase 21; qwen2 14 until PR 27's review follow-up)
MESH_TRAIN_LAYERS = {LM_ARCH: 7, "qwen3-moe-235b-a22b": 1}
# (d): global B, S (until phase 21: qwen2 S 4096, qwen3-moe S 1024 and 3 steps)
MESH_TRAIN = {LM_ARCH: (4, 2048), "qwen3-moe-235b-a22b": (2, 256)}
MESH_STEPS = 2  # qwen2's steps before its checkpoint (3 until phase 21)
MESH_MOE_STEPS = 2
MESH_PIPE = (4, 7, 8, 1024)  # (e): stages, qwen2 layers a stage, microbatches, S
SMESH_RANKS = 4  # phase 21's ranks, all on cuda:0: the 2x2 and 1x4 meshes
SMESH_TIMEOUT = 900  # s: the deadline of phase 21's ranks (spawn, run, join)
SMESH_SEED = 21
SMESH_SLOTS = 4
# (a): qwen2 layers, requests, new tokens, max_len, shortest prompt (the longest is
# max_len / 2 - 1: ``_crossing_prompts``)
SMESH_F32 = (4, 2, 4, 512, 64)
# (b): max_len (prompts [64, 512)), requests, shortest, new; 4 requests (one wave of the
# slots; 8 until phase 22 needed the time)
SMESH_BF16 = (2048, 4, 64, 16)
SMESH_BF16_TOL = 0.02  # (b): bf16 logits, times max |logit| (module docstring)
SMESH_MOE = (2, 4, 4, 512, 64, 256)  # (c): qwen3-moe layers, requests, new, max_len, prompts
SMESH_FAMILIES = ("zamba2-2.7b", "xlstm-350m", "llama-3.2-vision-11b", "whisper-base")
# (d): layers at full width: zamba2 1 of its 9 cycles, xlstm 4 of its 12, the vlm 1 of its 8,
# whisper-base whole
SMESH_FAM_LAYERS = {"zamba2-2.7b": 6, "xlstm-350m": 8, "llama-3.2-vision-11b": 5}
SMESH_FAM_TRAIN = {"zamba2-2.7b": (2, 256), "xlstm-350m": (2, 64),
                   "llama-3.2-vision-11b": (2, 256), "whisper-base": (4, 256)}  # (d): B, S
SMESH_FAM_STEPS = 2
# (d): requests, new tokens (3: ``run_until_drained`` returns no request that its
# admitting tick also finishes), max_len, shortest prompt (the longest as (a)'s)
SMESH_FAM_SERVE = (2, 3, 512, 64)
DRYRUN_PEAK_TOL = 0.2  # phase 22 (c): |predicted - measured| / measured, phase 14's peak
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


def _add_limit(scale):
    """The float32 ``add`` rule's limit at each index: ``ADD_TOL`` times
    the sum of |v| reaching it (``scale``), plus ``ADD_ATOL`` times the
    largest such sum when that is below 1. A fixed 1e-6 would exceed
    every sum of PageRank's contributions at S2 (about 3e-8 each), so an
    all-zero result would pass; the absolute term follows the data down."""
    top = float(scale.max()) if scale.numel() else 0.0
    return ADD_TOL * scale + ADD_ATOL * min(1.0, top)


def add_ratio(got, want, scale) -> float:
    """The largest error of a float32 ``add`` result over its limit
    (``_add_limit``): at most 1 where the result holds."""
    import torch

    lim = _add_limit(scale).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs() / lim).max()) if want.numel() else 0.0


def add_close(got, want, scale) -> bool:
    return add_ratio(got, want, scale) <= 1.0


def add_faults(idx, val, n, want, scale, chunk=1 << 22) -> dict:
    """Plants three faults in the float32 ``add`` result ``want`` of
    ``val`` reduced at ``idx`` into ``n`` entries (or rows) and fails the
    run unless ``add_close`` refuses each: all zeros, the odd tuples
    dropped, and the one tuple dropped whose value is smallest beside the
    limit at its index. Returns each fault's ``add_ratio`` (all above 1)."""
    import torch

    lim = _add_limit(scale).clamp_min(torch.finfo(torch.float32).tiny)
    odd = torch.zeros_like(want)
    weakest, j = math.inf, None
    for a in range(0, idx.shape[0], chunk):  # chunk is even: odd stays global
        i, v = idx[a:a + chunk].long(), val[a:a + chunk]
        odd.index_add_(0, i[1::2], v[1::2].to(want.dtype))
        r = v.abs().to(lim.dtype) / lim[i]
        r = r.amax(1) if r.dim() > 1 else r
        r = torch.where(v.reshape(v.shape[0], -1).abs().amax(1) > 0, r, math.inf)
        k = int(torch.argmin(r))
        if float(r[k]) < weakest:
            weakest, j = float(r[k]), a + k
    one = want.clone()
    one[int(idx[j])] -= val[j].to(want.dtype)
    faults = {"zeros": torch.zeros_like(want), "odd_tuples_dropped": want - odd,
              "weakest_tuple_dropped": one}
    ratios = {k: add_ratio(f, want, scale) for k, f in faults.items()}
    require(all(r > 1.0 for r in ratios.values()),
            f"the float32 add check passed a planted fault ({ratios})")
    return ratios


# -- the LM serving path (phases 8-10) -------------------------------------------


def flash_checks(dev, shapes, cancel=False, causal_modes=(True, False)):
    """Phase 8: the flash kernel against its plain version at ``shapes``
    (B, H, KH, Sq, Skv, hd) for float32 and bfloat16, causal and not (or
    ``causal_modes``). With ``cancel``, v = +-1 alternating by key, so that
    every output nearly cancels: a kernel that rounded P to bfloat16 once
    would fail there. Returns {dtype: (largest |diff|, largest share of
    the tolerance)}."""
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
            for causal in causal_modes:
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
    prompt once through every attention layer's kernel (every layer of a
    dense model, the shared block once a cycle in the hybrid family, none
    in the ssm family). Returns the launch counts and the record printed."""
    import torch

    import repro_torch.kernels as K
    from repro_torch.models.transformer import attention_layers
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
    attn = attention_layers(cfg)
    require(counts["flash_attention"] == attn * len(prompts),
            f"flash launches {counts['flash_attention']} != {attn} attention layers x "
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


def _profiled(fn, dev, agree=None):
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
    kernels out of the listings. ``agree`` (for a call that runs
    collectives) turns whether this try kept both markers into whether
    every rank takes it, so that all ranks try again together."""
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

    for _ in range(PROFILE_TRIES):
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
        kept = bool(short and mid)
        if agree(kept) if agree is not None else kept:
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


def kernel_profile(fn, agree=None):
    """Device ms of each kernel (and memset) of one call of ``fn`` under
    ``torch.profiler`` (``_profiled``, ``agree`` passed on), after one
    call outside it, the call's wall ms and ``_profiled``'s guard (its ms
    and the spin records lost). Fails the run when the profile lists no
    CUDA row: every ``fn`` given here launches kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof, wall, guard = _profiled(fn, torch.device("cuda"), agree)
    rows = _cuda_rows(prof)
    require(rows, f"kernel_profile: torch.profiler recorded no CUDA kernel ({profile_skew(prof)})")
    return {"wall_ms": wall, "device_ms": sum(e.self_device_time_total for e in rows) / 1e3,
            "guard": guard,
            "kernels": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                        for e in sorted(rows, key=lambda e: -e.self_device_time_total)]}


def engine_equals_manual_loop(cfg, model, prompt, max_len, max_new):
    """One request served alone (one slot) gives the tokens of a prefill +
    greedy decode loop, token for token (tests/test_serving.py:33-54), and
    leaves the same cache, bit for bit, leaf by leaf: a random model's
    greedy tokens often repeat, the cache holds every step's keys and
    values and recurrent states."""
    import torch

    from repro_torch.models.transformer import cache_leaves
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
    same_cache = all(torch.equal(a, b) for a, b in zip(cache_leaves(eng.state.caches),
                                                       cache_leaves(st.caches)))
    return r.out, want, same_cache


def lm_vs_cpu(cfg, model, prompt, max_len, steps, frontend=None):
    """Phase 10: the model on its device against a copy on the CPU (plain
    versions): the prefill's last logits and ``steps`` greedy decode steps,
    each side feeding its own tokens; ``frontend`` ({"img_embed" or
    "enc_embed": tensor}) joins the prefill's batch. Returns the largest
    logit error as a share of max |logit|, whether every greedy token
    agreed, and the tokens."""
    import torch

    from repro_torch.models.transformer import LM
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    dev = model.embed.table.device
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    prefill, decode = make_prefill_step(cfg, max_len), make_decode_step(cfg)
    toks = torch.from_numpy(prompt[None])
    out = {}
    for name, m, d in (("device", model, dev), ("cpu", cpu, torch.device("cpu"))):
        logits, st = prefill(m, {"tokens": toks.to(d),
                                 **{k: v.to(d) for k, v in (frontend or {}).items()}})
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


def embedding_backward_check(dev, K, cfg, B=TRAIN_B, S=TRAIN_S, vocab_block=None):
    """Phase 14a (and rows 5f, 5g): ``_pb_take``'s backward at the training
    shape (B*S token rows of d_model float32 from a bfloat16 cotangent
    into the padded vocabulary; Markov-synthetic ids) against index_add_
    in float64, then timed beside index_add_ and its bound. With
    ``vocab_block`` (i, n): into block i of n of the vocabulary, the ids
    outside it -1 (a vocab-parallel rank's stream, which the rows kernel
    drops; index_add_ takes the kept rows). Returns the record."""
    import torch

    from repro_torch.core.executor import execute_reduce
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.ref import scatter_reduce_ref
    from repro_torch.models import layers as L
    from repro_torch.timing import cuda_ms

    ids = torch.from_numpy(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).batch_at(0)["tokens"]).to(dev)
    n, F = cfg.padded_vocab, cfg.d_model
    if vocab_block is not None:
        i, nb = vocab_block
        n //= nb
        local = ids - i * n
        ids = torch.where((local >= 0) & (local < n), local, -1)
    gen = torch.Generator(device=dev).manual_seed(14)
    g = torch.randn(B, S, F, device=dev, generator=gen).to(torch.bfloat16)
    table = torch.zeros(n, F, dtype=torch.bfloat16, device=dev, requires_grad=True)
    before = K.cobra_bin_accumulate_rows.launches
    (dtab,) = torch.autograd.grad(L._pb_take(table, ids, vocab_block is not None), table, g)
    require(K.cobra_bin_accumulate_rows.launches == before + 1,
            "the embedding backward did not launch the rows kernel")
    flat, rows = ids.reshape(-1), g.reshape(-1, F).float()
    m = flat.shape[0]
    keep = flat >= 0
    kflat, krows = flat[keep], rows[keep]
    m_kept = int(kflat.shape[0])

    def kernel():
        return execute_reduce(flat, rows, out_size=n, op="add", method="fused")

    got = kernel()
    want = torch.zeros(n, F, dtype=torch.float64, device=dev).index_add_(0, kflat, krows.double())
    scale = torch.zeros_like(want).index_add_(0, kflat, krows.abs().double())
    err = float((got.double() - want).abs().max())
    require(add_close(got.double(), want, scale),
            f"the embedding backward differs from index_add_ in float64 ({err})")
    # the table's gradient: that sum rounded once to bfloat16
    require(bool(((dtab.double() - want).abs()
                  <= 2.0**-8 * want.abs() + _add_limit(scale)).all()),
            "the embedding gradient differs from index_add_ beyond one bfloat16 rounding")
    del want, scale, got, dtab, table
    # the kept rows, every id, the output once each (a dropped row need not be read)
    nbytes = 4 * m_kept * F + 4 * m + 4 * n * F
    rec = {"m": m, "m_kept": m_kept, "F": F, "n": n, "max_abs_err": err,
           "ms": cuda_ms(kernel, reps=10),
           "plain_ms": cuda_ms(lambda: scatter_reduce_ref(flat, rows, n), reps=10),
           "library_ms": cuda_ms(lambda: torch.zeros(n, F, device=dev).index_add_(0, kflat, krows),
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


def train_step_vs_cpu(dev, cfg32, seed=LM_SEED + 2, tol=TRAIN_TOL, frontend=None):
    """Phases 14c, 18b and 19b: one AdamW step of a full-width float32 copy
    ``cfg32`` (few layers) on the card and on the CPU from the same state,
    weights from ``seed`` (``frontend``: the batch's ``img_embed`` or
    ``enc_embed``, a CPU tensor): the loss to rtol 1e-5, each gradient and
    moment within ``tol`` of its max, parameters within 2 lr_1 plus two
    float32 roundings."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import LM, init_params
    from repro_torch.train.optimizer import apply_updates, init_opt_state
    from repro_torch.train.steps import default_opt_config, make_loss_fn

    model = init_params(cfg32, seed=seed, device=dev)
    cpu = LM(cfg32, device="cpu")
    cpu.load_state_dict(model.state_dict())
    batch = SyntheticLM(DataConfig(vocab_size=cfg32.vocab_size, seq_len=TRAIN_CPU_S,
                                   global_batch=1)).batch_at(0)
    oc = default_opt_config(cfg32)
    loss_fn = make_loss_fn(cfg32)
    out = {}
    for side, m in (("card", model), ("cpu", cpu)):
        d = m.embed.table.device
        params = dict(m.named_parameters())
        loss = loss_fn(m, {**{k: torch.from_numpy(v).to(d) for k, v in batch.items()},
                           **{k: v.to(d) for k, v in (frontend or {}).items()}})
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
    ok = (shares["loss_rel"] <= 1e-5 and max(shares["grad"], shares["m"], shares["v"]) <= tol
          and shares["param_vs_2lr"] <= 1.0)
    require(ok, f"the {cfg32.num_layers}-layer float32 {cfg32.name} train step on the card differs "
                f"from the CPU: {shares}")
    return {"arch": cfg32.name, "layers": cfg32.num_layers, "tokens": TRAIN_CPU_S, "loss": [la, lb],
            "lr": lr, "tolerance": tol, **shares}


def train_phase(dev, K, smi):
    """Phase 14: the LM training path. The backward kernels against their
    plain versions (14a, 14b), a float32 step against the CPU (14c), then
    ``launch/train.py`` at full width: 3 steps and one more under the
    profiler, and at TRAIN_CKPT_LAYERS layers 3 steps with a checkpoint at
    the end and a resume whose restore holds the saved state's
    fingerprint (14d). Returns (launches, launches by shape, the
    embedding-backward record, the training record: phase 22 (c) reads its
    peak and step time)."""
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
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
    cfg32 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32", compute_dtype="float32")
    say("phase14 float32 step card vs CPU", json.dumps(train_step_vs_cpu(dev, cfg32)))
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

    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()  # the training path starts here
    run = train_mod.train(train_mod.parse_args(flags + ["--steps", str(TRAIN_STEPS)]))
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
    rec = {"arch": LM_ARCH, "layers": cfg.num_layers, "param_dtype": cfg.param_dtype,
           "remat": cfg.remat, "optimizer": default_opt_config(cfg).kind,
           "batch": TRAIN_B, "seq_len": TRAIN_S,
           "cut": f"global batch {TRAIN_B} of train_4k's 256 (one card)",
           "losses": run.losses, "grad_norms": run.grad_norms, "lrs": run.lrs,
           "step_ms": [1e3 * x for x in run.step_seconds],
           "launches": {k: c1[k] for k in ("cobra_bin_accumulate_rows", "flash_attention")},
           "peak_bytes_above_earlier_phases": peak, "earlier_phases_bytes": mem0,
           "card": smi}
    state = run.state
    del run, opt
    # the checkpoint and the resume at TRAIN_CKPT_LAYERS of the 28 layers: a checkpoint
    # at the end of TRAIN_STEPS steps, then a resume whose restore must give the saved
    # state's fingerprint (the whole model's 15.5 GB write and two reads until phase 21)
    ck_cfg = dataclasses.replace(cfg, num_layers=TRAIN_CKPT_LAYERS)
    restore, restored, saved_cfg = CheckpointManager.restore, {}, train_mod.get_config

    def fingerprinted_restore(self, *a, **kw):
        out = restore(self, *a, **kw)
        if out[0] is not None:
            restored.update(step=out[1], fp=_mesh_fingerprint(out[0]))
        return out

    CheckpointManager.restore = fingerprinted_restore
    train_mod.get_config = lambda name: ck_cfg
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
            ck_flags = flags + ["--ckpt-dir", ck, "--ckpt-every", "100"]
            t = time.perf_counter()
            K.reset_launch_counts()  # the checkpointed run starts here
            first = train_mod.train(train_mod.parse_args(ck_flags + ["--steps", str(TRAIN_STEPS)]))
            torch.cuda.synchronize()
            add(K.launch_counts(), K.launch_shapes())  # and ends here
            save_s = time.perf_counter() - t
            fp_saved = _mesh_fingerprint(first.state)
            del first
            torch.cuda.empty_cache()
            t = time.perf_counter()
            K.reset_launch_counts()  # the resumed run starts here
            run = train_mod.train(train_mod.parse_args(
                ck_flags + ["--steps", str(TRAIN_STEPS + 1), "--no-ckpt-final"]))
            torch.cuda.synchronize()
            c2, s2 = K.launch_counts(), K.launch_shapes()  # and ends here
            resume_s = time.perf_counter() - t
    finally:
        CheckpointManager.restore = restore
        train_mod.get_config = saved_cfg
    add(c2, s2)
    same = restored.get("fp") == fp_saved
    require(restored.get("step") == TRAIN_STEPS and same,
            f"checkpoint step {restored.get('step')} does not restore the saved state")
    require(run.start_step == TRAIN_STEPS and len(run.losses) == 1
            and math.isfinite(run.losses[0]) and c2["cobra_bin_accumulate_rows"] >= 1
            and c2["flash_attention"] >= ck_cfg.num_layers,
            f"the resumed run: start {run.start_step}, losses {run.losses}, launches {c2}")
    rec["checkpoint"] = {"layers": ck_cfg.num_layers, "fingerprint_equal": same,
                         "steps_and_save_seconds": save_s, "resume_seconds": resume_s,
                         "resumed_loss": run.losses[0]}
    del run
    torch.cuda.empty_cache()
    steady = rec["step_ms"][1:]
    tokens = TRAIN_B * TRAIN_S
    ms = min(steady)
    rec.update({"steady_step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
                "model_flop_per_s": flops_per_token(cfg) * tokens / ms * 1e3,
                "model_flop_share_of_989T": flops_per_token(cfg) * tokens / ms * 1e3
                / BF16_FLOP_PER_S})
    say("phase14 train", json.dumps(rec))
    # one more step under the profiler, from the full model's state
    step = make_train_step(cfg, default_opt_config(cfg, total_steps=TRAIN_STEPS + 2))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S, global_batch=TRAIN_B))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(TRAIN_STEPS).items()}
    prof = device_profile(lambda: step(state, batch), dev, kinds={
        "flash kernel": ("flash_fwd",), "rows kernel": ("rows_tile_kernel", "rows_seg_kernel"),
        "float32 GEMM": ("f32f32_f32",), "other GEMM": ("gemm", "nvjet", "cutlass"),
        "elementwise": ("elementwise",), "reductions": ("reduce",),
        "copies and fills": ("Memcpy", "Memset", "fill")})
    say("phase14 profile", json.dumps(dict(prof, card=smi)))
    del state, batch
    torch.cuda.empty_cache()
    return counts, shapes, emb, rec


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
        tol = _add_limit(scale) + (2.0**-7 * want.float().abs() if dt == torch.bfloat16 else 0)
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
    from repro_torch.models.transformer import init_cache, init_params
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
    kinds = {"flash kernel": ("flash_fwd",), "row scatter": ("scatter_rows",),
             "rows kernel": ("rows_tile_kernel", "rows_seg_kernel", "f32_to_bf16"),
             "histogram+positions": ("histogram", "positions"),
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
        rows.append(flash_row("flash_attention:moe_prefill", cfg, dev, gen, T_long,
                              counts["flash_attention"], max(e for e, _ in flash_worst.values())))
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


# -- the recurrent families (phase 17) -------------------------------------------------


def _state_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), on the CPU in float32."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def recurrent_layer_checks(dev, layers, gen):
    """Phase 17 (b): each recurrent layer at full width in float32 on the
    card against its copy on the CPU. ``layers``: {name: (apply function,
    layer on the card, config)}; the layer's per-head scalars and biases
    are redrawn at random on a copy (the init rule sets them to 0 or 1).
    On REC_LAYER_S tokens (ragged against the chunk) from the zero state,
    then one decode step from that state: outputs and states, card against
    CPU. On the card, the chunked prefill followed by the decode step
    against REC_LAYER_S + 1 decode steps from the zero state. Every error
    (``_state_err``) must stay within REC_LAYER_TOL. Returns the errors."""
    import copy

    import torch

    out = {}
    for name, (apply, layer, cfg) in layers.items():
        layer = copy.deepcopy(layer)
        with torch.no_grad():
            for leaf in ("A_log", "D", "dt_bias", "b"):
                if hasattr(layer, leaf):
                    getattr(layer, leaf).copy_(
                        0.5 * torch.randn(getattr(layer, leaf).shape, device=dev, generator=gen))
        cpu = copy.deepcopy(layer).to("cpu")
        S = REC_LAYER_S
        x = torch.randn(1, S + 1, cfg.d_model, device=dev, generator=gen)
        xc = x.cpu()
        errs = {}
        with torch.inference_mode():
            o_d, st_d = apply(layer, x[:, :S], cfg)
            o_c, st_c = apply(cpu, xc[:, :S], cfg)
            errs["prefill_out"] = _state_err(o_d, o_c)
            errs["prefill_state"] = max(_state_err(a, b) for a, b in zip(st_d, st_c))
            d_d, sd_d = apply(layer, x[:, S:], cfg, state=st_d, decode=True)
            d_c, sd_c = apply(cpu, xc[:, S:], cfg, state=st_c, decode=True)
            errs["decode_out"] = _state_err(d_d, d_c)
            errs["decode_state"] = max(_state_err(a, b) for a, b in zip(sd_d, sd_c))
            st, steps = None, []
            for t in range(S + 1):
                o, st = apply(layer, x[:, t:t + 1], cfg, state=st, decode=True)
                steps.append(o)
            steps = torch.cat(steps, 1)
            errs["token_by_token_out"] = max(_state_err(steps[:, :S], o_d),
                                             _state_err(steps[:, S:], d_d))
            errs["token_by_token_state"] = max(_state_err(a, b) for a, b in zip(st, sd_d))
        out[name] = errs
        require(max(errs.values()) <= REC_LAYER_TOL,
                f"phase17 (b) {name}: {errs} above {REC_LAYER_TOL}")
        del layer, cpu
    return out


def recurrent_phase(dev, K, smi):
    """Phase 17: the recurrent families. (a) flash at head_dim 80 against
    its plain version (REC_FLASH_SHAPES, then outputs that nearly cancel);
    (b) each recurrent layer at full width in float32, card against CPU
    (``recurrent_layer_checks``); (c) a full-width float32 copy of each
    model with one cycle, card against CPU (``lm_vs_cpu``); then for each
    of REC_ARCHS at full width and depth in bfloat16: (e) the serve
    (``Engine``: REC_REQUESTS requests of REC_PROMPT_LENS tokens,
    REC_MAX_NEW new each, REC_SLOTS slots, REC_MAX_LEN positions; flash
    once per cycle per prefill in the hybrid family, never in the ssm
    family), a profile of one prefill and one decode tick, xLSTM's layers
    timed apart at the longest prefill, and (d) the engine with one slot
    against a manual prefill + decode loop. Returns (the serves' launches,
    by shape, and the kernels line's row 8c)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TM
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(REC_SEED)
    with torch.inference_mode():
        flash_worst = {"random": flash_checks(dev, REC_FLASH_SHAPES),
                       "cancel": flash_checks(dev, REC_FLASH_CANCEL_SHAPES, cancel=True)}
    say("phase17 (a) flash at head_dim 80, largest |diff| and share:", json.dumps(flash_worst))
    torch.cuda.empty_cache()

    # (c) one cycle of each model at full width in float32; (b) runs on its layers
    models32 = {}
    for arch in REC_ARCHS:
        base = get_config(arch)
        layers = base.attn_every if base.family == "hybrid" else 2
        cfg32 = dataclasses.replace(base, num_layers=layers, param_dtype="float32",
                                    compute_dtype="float32")
        models32[arch] = (cfg32, TM.init_params(cfg32, seed=REC_SEED, device=dev))
    hyb_cfg, hyb = models32["zamba2-2.7b"]
    ssm_cfg, ssm = models32["xlstm-350m"]
    layer_errs = recurrent_layer_checks(dev, {
        "mamba2": (SSM.mamba2_apply, hyb.blocks[0].mamba[0].mamba, hyb_cfg),
        "mlstm": (SSM.mlstm_apply, ssm.blocks[0].mlstm, ssm_cfg),
        "slstm": (SSM.slstm_apply, ssm.blocks[0].slstm, ssm_cfg)}, gen)
    say("phase17 (b) layers at full width, float32, card vs CPU and chunked vs token by token "
        "(error over max(1, max |want|)):", json.dumps(dict(layer_errs, tokens=REC_LAYER_S,
                                                            tolerance=REC_LAYER_TOL)))
    for arch, (cfg32, model32) in models32.items():
        prompt = lm_prompts(cfg32, 1, LM_CPU_PROMPT, LM_CPU_PROMPT, seed=REC_SEED)[0]
        share, same_tokens, toks = lm_vs_cpu(cfg32, model32, prompt, 512, LM_CPU_STEPS)
        say("phase17 (c) card vs CPU", json.dumps({
            "arch": arch, "layers": cfg32.num_layers, "d_model": cfg32.d_model,
            "dtype": "float32", "prompt": LM_CPU_PROMPT, "decode_steps": LM_CPU_STEPS,
            "max_logit_err_share": share, "tolerance": LM_TOL, "tokens": toks,
            "tokens_equal": same_tokens, "reduced": f"one cycle, {cfg32.num_layers} of "
            f"{get_config(arch).num_layers} layers (the CPU copy)", "card": smi}))
        require(share <= LM_TOL and same_tokens,
                f"phase17 (c) {arch}: the float32 model on the card differs from the CPU "
                f"(share {share}, tokens equal {same_tokens})")
    del models32, hyb, ssm
    torch.cuda.empty_cache()
    say(f"phase17 checks seconds: {time.perf_counter() - t:.1f}")

    counts_all, shapes_all, rows = {}, {}, []
    kinds = {"flash kernel": ("flash_fwd",), "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
             "elementwise": ("elementwise",), "reductions": ("reduce",),
             "copies and fills": ("Memcpy", "Memset", "fill", "copy")}
    for arch in REC_ARCHS:
        ta = time.perf_counter()
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        model = TM.init_params(cfg, seed=REC_SEED, device=dev)
        torch.cuda.synchronize()
        say("phase17 model", json.dumps({
            "arch": arch, "family": cfg.family, "layers": cfg.num_layers,
            "cycles": TM._num_cycles(cfg), "attention_layers": TM.attention_layers(cfg),
            "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
            "parameters": sum(p.numel() for p in model.parameters()),
            "parameter_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "earlier_phases_bytes": mem0, "seconds_to_draw": time.perf_counter() - ta}))
        prompts = lm_prompts(cfg, REC_REQUESTS, *REC_PROMPT_LENS, seed=REC_SEED)
        counts, rec = serve_lm(cfg, model, prompts, REC_SLOTS, REC_MAX_LEN, REC_MAX_NEW)
        shapes = rec.pop("launch_shapes")
        for k, c in counts.items():
            counts_all[k] = counts_all.get(k, 0) + c
        for k, by in shapes.items():
            for shp, c in by.items():
                shapes_all.setdefault(k, {})[shp] = shapes_all.get(k, {}).get(shp, 0) + c
        prompt_tokens = sum(len(p) for p in prompts)
        rec.update({"arch": arch, "prefill_tokens_per_s": prompt_tokens / (sum(rec["prefill_ms"]) / 1e3),
                    "serving_peak_bytes": (rec["max_memory_allocated"] - mem0
                                           if dev.type == "cuda" else None),
                    "earlier_phases_bytes": mem0, "launches": counts, "card": smi})
        say("phase17 serve", json.dumps(rec))  # serve_lm checked flash's launches
        # one prefill (the longest prompt's; xLSTM's shortest, whose sLSTM loop
        # is already some 40,000 launches) and one decode tick under the profiler
        pick = min if cfg.family == "ssm" else max
        prompt = torch.from_numpy(pick(prompts, key=len)[None]).to(dev)
        prefill, decode = make_prefill_step(cfg, REC_MAX_LEN), make_decode_step(cfg)
        st = TM.init_cache(cfg, REC_SLOTS, REC_MAX_LEN, device=dev)._replace(index=rec["final_index"])
        tok4 = torch.zeros(REC_SLOTS, 1, dtype=torch.int32, device=dev)
        prof = {"prefill": {"tokens": prompt.shape[1], **device_profile(
                    lambda: prefill(model, {"tokens": prompt}), dev, kinds)},
                "decode_tick": {"slots": REC_SLOTS, "index": st.index, **device_profile(
                    lambda: decode(model, st, tok4), dev, kinds)}}
        say("phase17 profile", json.dumps(dict(prof, arch=arch, card=smi)))
        del st
        longest = max(prompts, key=len)
        T_long = len(longest)
        if cfg.family == "ssm":
            # where an xLSTM prefill goes: one cycle's two layers at the longest prompt
            x = torch.randn(1, T_long, cfg.d_model, device=dev, generator=gen).to(cfg.cdtype)
            blk = model.blocks[0]
            layer_ms = {}
            with torch.inference_mode():
                for name, fn in (("mlstm", lambda: SSM.mlstm_apply(blk.mlstm, x, cfg)),
                                 ("slstm", lambda: SSM.slstm_apply(blk.slstm, x, cfg))):
                    fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    layer_ms[name] = (time.perf_counter() - t0) * 1e3
            say("phase17 xlstm layers at the longest prefill (host clock, synchronised)",
                json.dumps({"tokens": T_long, "ms": layer_ms, "cycles": TM._num_cycles(cfg),
                            "card": smi}))
            del x
        else:
            with torch.inference_mode():
                rows.append(flash_row(
                    "flash_attention:hybrid_prefill", cfg, dev, gen, T_long,
                    counts["flash_attention"],
                    max(e for w in flash_worst.values() for e, _ in w.values())))
        got, want, same_cache = engine_equals_manual_loop(cfg, model, prompts[0], REC_MAX_LEN,
                                                          REC_MAX_NEW)
        say("phase17 (d) engine vs manual loop:", json.dumps(
            {"arch": arch, "engine": got, "manual": want, "same_cache": same_cache}))
        require(got == want and same_cache,
                f"phase17 {arch}: the engine differs from a manual prefill + decode loop")
        del model
        torch.cuda.empty_cache()
        say(f"phase17 {arch} seconds: {time.perf_counter() - ta:.1f}")
    return counts_all, shapes_all, rows


def flash_row(name, cfg, dev, gen, S, launches, worst, Skv=None, causal=True, B=1):
    """A ``kernels`` line row for flash at a prefill of ``S`` tokens with
    ``cfg``'s heads, (B, H, KH, S, hd), bfloat16, causal (or against
    ``Skv`` keys, with or without the mask): random q, k, v
    from ``gen``, held to the plain version (``flash_close``), then its ms,
    the plain version's, its bound (q, k, v, o moved once; FLOP at the
    bf16 rate) and SDPA's at the same inputs, and the kernel's device ms
    from ``torch.profiler`` (``kernel_profile``): at a few hundredths of a
    ms the event-timed loop can measure the host's wrapper calls instead.
    ``launches``: the path's flash launches; ``worst``: the largest error
    of the path's checks."""
    import torch

    import repro_torch.kernels as K
    from repro_torch.kernels.flashattn import flash_attention_ref, flash_flops
    from repro_torch.timing import cuda_ms

    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Skv = Skv or S
    q = torch.randn(B, H, S, hd, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, KH, Skv, hd, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, KH, Skv, hd, device=dev, generator=gen).to(torch.bfloat16)
    err, _, ok = flash_close(K.flash_attention(q, k, v, causal=causal),
                             flash_attention_ref(q, k, v, causal=causal), torch.bfloat16)
    require(ok, f"flash at {name}'s shape {(B, H, KH, S, Skv, hd)} differs from plain (max "
                f"|diff| {err}; see flash_close)")
    flop = flash_flops(B, H, S, Skv, hd, causal=causal)
    nbytes = 2 * (2 * B * H * S * hd + 2 * B * KH * Skv * hd)  # q, o, k, v once each
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/flashattn.cu",
        "replaces": "src/repro/kernels/flashattn.py:61", "launches": launches,
        "checked_against_plain": True, "max_abs_err": max(worst, err),
        "shape": {"B": B, "H": H, "KH": KH, "S": S, "Skv": Skv, "hd": hd, "causal": causal},
        "ms": cuda_ms(lambda: K.flash_attention(q, k, v, causal=causal), reps=20),
        "kernel_device_ms": kernel_profile(
            lambda: K.flash_attention(q, k, v, causal=causal))["device_ms"],
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal), reps=5),
        "bound_ms": max(flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_flop": flop, "bound_bytes": nbytes,
        "bound_by": "operations" if flop / BF16_FLOP_PER_S > nbytes / HBM_BYTES_PER_S else "bytes",
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), reps=20)}


# -- training of the moe, ssm and hybrid families (phase 18) ---------------------------


def moe_backward_checks(dev, K):
    """Phase 18 (a): the MoE backward's two PB calls at phase 15's longest
    prefill (FAM_MOE_T tokens, full width, bfloat16, counting dispatch)
    against their plain versions. The dispatch's backward: each kept
    assignment's cotangent row gathered from its slot in token order and
    the k rows of each token summed by the rows kernel
    (``layers._sum_token_rows``), held to a float64 ``index_add_`` as
    phase 15 holds the combine (one bfloat16 rounding plus the float32 add
    limit); the combine's backward: each kept assignment's weighted
    cotangent row written to its slot by ``scatter_rows``, equal to
    ``index_copy_`` and to the plain version. Returns the kernels line's
    rows 5e and 7c without their launches (timed: ms by events, the
    kernel's device ms from the profiler, plain ms, the library call's
    ms, bound; 5e also ``_sum_token_rows``' whole call, token stream
    included)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models.params import winit_
    from repro_torch.timing import cuda_ms

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=1, moe_dispatch_method="counting")
    E, k, d, T_ = cfg.num_experts, cfg.top_k, cfg.d_model, FAM_MOE_T
    gen = torch.Generator(device=dev).manual_seed(FAM_SEED)
    wr = torch.empty(d, E, device=dev)
    winit_(wr, gen, None)
    x = torch.randn(T_, d, device=dev, generator=gen).to(cfg.cdtype)
    with torch.no_grad():
        disp = L.moe_dispatch(x, wr, cfg, 0, E)
    soa, n_slots, m = disp.slot_of_assign, E * disp.capacity, T_ * k
    g_xbuf = torch.randn(n_slots, d, device=dev, generator=gen).to(cfg.cdtype)
    g_out = torch.randn(T_, d, device=dev, generator=gen).to(cfg.cdtype)
    tokens = torch.arange(T_, dtype=torch.int32, device=dev).repeat_interleave(k)
    rows = L._kept_rows(g_xbuf, soa)
    before = K.cobra_bin_accumulate_rows.launches
    got = L._sum_token_rows(rows, T_)
    require(K.cobra_bin_accumulate_rows.launches == before + 1,
            "the dispatch backward's sum did not launch the rows kernel")
    want = torch.zeros(T_, d, dtype=torch.float64, device=dev).index_add_(0, tokens, rows.double())
    scale = torch.zeros_like(want).index_add_(0, tokens, rows.abs().double())
    diff = (got.double() - want).abs()
    rows_err = float(diff.max())
    require(got.dtype == torch.bfloat16
            and bool((diff <= _add_limit(scale) + 2.0**-7 * want.abs()).all()),
            f"the dispatch backward's rows reduce differs from index_add_ in float64 ({rows_err})")
    w = disp.gate_w.reshape(-1).to(cfg.cdtype)
    vals = (g_out.repeat_interleave(k, dim=0) * w[:, None]).contiguous()
    kept = soa >= 0
    lib_pos, lib_x = soa[kept].long(), vals[kept]
    before = K.scatter_rows.launches
    got_s = K.scatter_rows(vals, soa, n_slots)
    require(K.scatter_rows.launches == before + 1, "the combine backward did not launch scatter_rows")
    require(torch.equal(got_s, torch.zeros_like(got_s).index_copy_(0, lib_pos, lib_x))
            and torch.equal(got_s, ref.scatter_rows_ref(vals, soa, n_slots)),
            "the combine backward's row scatter differs from index_copy_ / its plain version")
    say("phase18 (a) MoE backward kernels vs plain", json.dumps({
        "tokens": T_, "assignments": m, "capacity": disp.capacity, "slots": n_slots,
        "kept": int(kept.sum()), "rows_max_abs_err": rows_err, "scatter_equal": True}))
    xw = vals.element_size()
    # the kernel as ``_sum_token_rows`` calls it (execute_reduce's bins), timed
    # without the token stream's construction; the wrapper's whole call beside it
    br = min(512, T_)

    def rows_kernel():
        return K.cobra_bin_accumulate_rows(tokens, rows, T_, br, -(-T_ // br))

    def scatter_kernel():
        return K.scatter_rows(vals, soa, n_slots)

    return [
        {"name": "cobra_bin_accumulate_rows:moe_dispatch_backward", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_rows.cu",
         "replaces": "src/repro/kernels/fused.py:263", "checked_against_plain": True,
         "max_abs_err": rows_err, "shape": {"m": m, "F": d, "n": T_}, "dtype": "bfloat16",
         "ms": cuda_ms(rows_kernel, reps=20),
         "kernel_device_ms": kernel_profile(rows_kernel)["device_ms"],
         "sum_token_rows_ms": cuda_ms(lambda: L._sum_token_rows(rows, T_), reps=20),
         "plain_ms": cuda_ms(lambda: ref.scatter_reduce_ref(tokens, rows, T_), reps=20),
         "bound_ms": bound_ms(xw * m * d + 4 * m + xw * T_ * d),
         "bound_bytes": xw * m * d + 4 * m + xw * T_ * d, "bound_by": "bytes",
         "library_ms": cuda_ms(lambda: torch.zeros(T_, d, dtype=rows.dtype, device=dev)
                               .index_add_(0, tokens, rows), reps=20)},
        {"name": "scatter_rows:moe_combine_backward", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/scatter_rows.cu",
         "replaces": "src/repro/kernels/scatter_rows.py:37", "checked_against_plain": True,
         "max_abs_err": 0, "shape": {"m": m, "d": d, "out_rows": n_slots}, "dtype": "bfloat16",
         "ms": cuda_ms(scatter_kernel, reps=20),
         "kernel_device_ms": kernel_profile(scatter_kernel)["device_ms"],
         "plain_ms": cuda_ms(lambda: ref.scatter_rows_ref(vals, soa, n_slots), reps=20),
         "bound_ms": bound_ms(4 * m + xw * (m + n_slots) * d),
         "bound_bytes": 4 * m + xw * (m + n_slots) * d, "bound_by": "bytes",
         "library_ms": cuda_ms(lambda: torch.zeros(n_slots, d, dtype=vals.dtype, device=dev)
                               .index_copy_(0, lib_pos, lib_x), reps=20)},
    ]


def moe_layer_grads_vs_cpu(dev, K):
    """Phase 18 (b): one MoE layer of ``qwen3-moe-235b-a22b`` at full
    width (d 4096, 128 experts of d_ff 1536, top-8, capacity factor 1.25)
    in float32 on FAM_CPU_T tokens, counting dispatch: the gradients of
    the input and of every weight on the card (the MoE backward's rows
    and scatter kernels; each launch counted) against the CPU's (plain
    versions), each within TRAIN_TOL of its max; the two sides must
    route alike. Host memory: the CPU's copy holds 9.7 GB of float32
    experts and as much again of their gradients."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.params import winit_

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=1, param_dtype="float32",
                              compute_dtype="float32", moe_dispatch_method="counting")
    moe = L.MoE(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(FAM_SEED + 1)
    with torch.no_grad():
        for name, p in moe.named_parameters():
            winit_(p, gen, cfg.d_ff ** -0.5 if name == "w2" else None)
    x = torch.randn(1, FAM_CPU_T, cfg.d_model, device=dev, generator=gen)
    g = torch.randn(1, FAM_CPU_T, cfg.d_model, device=dev, generator=gen)
    cpu = copy.deepcopy(moe).to("cpu")
    ids = {}
    grads = {}
    for side, layer in (("card", moe), ("cpu", cpu)):
        d = layer.wr.device
        xs = x.to(d).requires_grad_()
        ids[side] = L.moe_route(xs.detach()[0], layer.wr.detach(), cfg)[1].cpu()
        K.reset_launch_counts()
        out = L.moe_apply(layer, xs, cfg)
        fwd = K.launch_counts()
        grads[side] = torch.autograd.grad(out, [xs, layer.wr, layer.w1, layer.w3, layer.w2],
                                          g.to(d))
        bwd = K.launch_counts()
        del out
        if side == "card":
            counts = {"forward": {k: fwd[k] for k in ("scatter_rows", "cobra_bin_accumulate_rows",
                                                       "histogram", "counting_positions")},
                      "forward_and_backward": {k: bwd[k] for k in ("scatter_rows",
                                                                   "cobra_bin_accumulate_rows")}}
    require(torch.equal(ids["card"], ids["cpu"]), "the card and the CPU route the tokens apart")
    require(counts["forward"] == {"scatter_rows": 1, "cobra_bin_accumulate_rows": 1,
                                  "histogram": 1, "counting_positions": 1}
            and counts["forward_and_backward"] == {"scatter_rows": 2,
                                                   "cobra_bin_accumulate_rows": 2},
            f"the MoE layer's forward and backward launched {counts}")
    shares = {}
    for name, a, b in zip(("x", "wr", "w1", "w3", "w2"), grads["card"], grads["cpu"]):
        shares[name] = float((a.cpu() - b).abs().max() / b.abs().max())
    rec = {"tokens": FAM_CPU_T, "capacity": L.moe_capacity(FAM_CPU_T, cfg),
           "dropped": int((torch.bincount(ids["cpu"].reshape(-1), minlength=cfg.num_experts)
                           - L.moe_capacity(FAM_CPU_T, cfg)).clamp(min=0).sum()),
           "topk_ties": L.moe_topk_ties(x[0], moe.wr.detach(), cfg), "launches": counts,
           "grad_err_share_of_max": shares, "tolerance": TRAIN_TOL}
    require(max(shares.values()) <= TRAIN_TOL,
            f"the float32 MoE layer's gradients on the card differ from the CPU: {rec}")
    del grads, cpu, moe
    return rec


def family_train_run(dev, K, smi, arch):
    """Phase 18 (c): ``launch/train.py`` at full width for ``arch``
    (FAM_SHAPES, FAM_STEPS steps, bfloat16, remat, the optimizer
    ``default_opt_config`` picks for the full model; qwen3-moe with
    FAM_MOE_LAYERS of its 94 layers and counting dispatch, set on the
    config the launcher reads), with the launch counts set to 0 before and
    read after; then one more step under the profiler (xlstm at
    FAM_PROFILE_S positions: its full step is some 400,000 launches),
    whose seconds, the profiler's processing included, are printed.
    Returns (launches, launches by shape, the record)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as TM
    from repro_torch.models.config import flops_per_token
    from repro_torch.train import steps as steps_mod

    full = get_config(arch)
    cfg = full
    if full.family == "moe":
        cfg = dataclasses.replace(full, num_layers=FAM_MOE_LAYERS, moe_dispatch_method="counting")
    oc = steps_mod.default_opt_config(full, total_steps=FAM_STEPS)
    B, S = FAM_SHAPES[arch]
    saved = train_mod.get_config, train_mod.default_opt_config
    train_mod.get_config = lambda name: cfg
    train_mod.default_opt_config = lambda c, total_steps=10_000: steps_mod.default_opt_config(
        full, total_steps)
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        args = train_mod.parse_args(["--arch", arch, "--preset", "full", "--seq-len", str(S),
                                     "--batch", str(B), "--steps", str(FAM_STEPS),
                                     "--log-every", "1"])
        K.reset_launch_counts()  # this family's training path starts here
        run = train_mod.train(args)
        torch.cuda.synchronize()
        counts, shapes = K.launch_counts(), K.launch_shapes()  # and ends here
    finally:
        train_mod.get_config, train_mod.default_opt_config = saved
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    model, opt = run.state.params, run.state.opt
    require(len(run.losses) == FAM_STEPS
            and all(math.isfinite(x) for x in run.losses + run.grad_norms),
            f"{arch}: training diverged: {run.losses} {run.grad_norms}")
    if opt.m is not None:
        stale = [n for n in opt.m if not n.endswith("attn.bk")
                 and not (float(opt.m[n].abs().max()) > 0 and float(opt.v[n].abs().max()) > 0)]
    else:  # Adafactor's moments: above the 1e-30 floor that g * g + 1e-30 adds
        stale = [n for n, v in opt.v.items()
                 if not all(float(t.max()) > 1e-20 for t in (v if isinstance(v, tuple) else (v,)))]
    require(opt.step == FAM_STEPS and not stale, f"{arch}: moments that did not move: {stale}")
    # each step: the embedding backward; per MoE layer the dispatch (row scatter,
    # counting's histogram and positions) and the combine (rows) in the forward
    # and again in the remat recompute, and the backward's rows reduce (dispatch)
    # and row scatter (combine); flash at every attention use, twice (remat)
    L_moe = cfg.num_layers if cfg.family == "moe" else 0
    passes = 2 if cfg.remat else 1
    want = {"cobra_bin_accumulate_rows": 1 + L_moe * (passes + 1),
            "scatter_rows": L_moe * (passes + 1), "histogram": L_moe * passes,
            "counting_positions": L_moe * passes,
            "flash_attention": TM.attention_layers(cfg) * passes}
    want = {k: v * FAM_STEPS for k, v in want.items()}
    got = {k: counts[k] for k in want}
    require(got == want, f"{arch}: {FAM_STEPS} steps launched {got}, expected {want}")
    tokens = B * S
    ms = min(1e3 * x for x in run.step_seconds[1:])
    nparams = sum(p.numel() for p in model.parameters())
    rec = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
           "of_layers": full.num_layers, "parameters": nparams,
           "param_dtype": cfg.param_dtype, "remat": cfg.remat,
           "optimizer": oc.kind, "dispatch": cfg.moe_dispatch_method if L_moe else None,
           "batch": B, "seq_len": S, "tokens_per_step": tokens,
           "losses": run.losses, "grad_norms": run.grad_norms,
           "step_ms": [1e3 * x for x in run.step_seconds], "steady_step_ms": ms,
           "tokens_per_s": tokens / ms * 1e3,
           "model_flop_per_s": flops_per_token(cfg) * tokens / ms * 1e3,
           "model_flop_share_of_989T": flops_per_token(cfg) * tokens / ms * 1e3 / BF16_FLOP_PER_S,
           "peak_bytes_above_earlier_phases": peak, "earlier_phases_bytes": mem0,
           "launches": got, "seconds": seconds, "card": smi}
    # one more step under the profiler, from the trained state
    pS = FAM_PROFILE_S.get(arch, S)
    step = steps_mod.make_train_step(cfg, oc)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=pS, global_batch=B))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(FAM_STEPS).items()}
    state = run.state
    kinds = {"flash kernel": ("flash_fwd",), "row scatter": ("scatter_rows",),
             "rows kernel": ("rows_tile_kernel", "rows_seg_kernel", "f32_to_bf16"),
             "histogram+positions": ("histogram", "positions"), "float32 GEMM": ("f32f32_f32",), "other GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
             "elementwise": ("elementwise",), "reductions": ("reduce",),
             "copies and fills": ("Memcpy", "Memset", "fill", "copy")}
    tp = time.perf_counter()
    rec["profile"] = {"batch": B, "seq_len": pS, **device_profile(lambda: step(state, batch), dev,
                                                                  kinds)}
    rec["profile_seconds"] = time.perf_counter() - tp
    say("phase18 train", json.dumps(rec))
    del run, state, model, opt, batch, step
    torch.cuda.empty_cache()
    return counts, shapes, rec


def family_train_phase(dev, K, smi):
    """Phase 18: training of the moe, ssm and hybrid families. (a) the MoE
    backward's rows reduce and row scatter against their plain versions
    at phase 15's prefill shape (``moe_backward_checks``); (b) one
    full-width float32 MoE layer's gradients, card against CPU
    (``moe_layer_grads_vs_cpu``), and one AdamW step of a one-cycle
    full-width float32 copy of zamba2-2.7b and of xlstm-350m, card against
    CPU (``train_step_vs_cpu``); (c) ``launch/train.py`` for each of
    FAM_ARCHS (``family_train_run``). Returns (the launches of (c), by
    shape, the kernels line's rows 5e and 7c)."""
    import torch

    from repro_torch.configs import get_config

    t = time.perf_counter()
    rows = moe_backward_checks(dev, K)
    torch.cuda.empty_cache()
    tb = time.perf_counter()
    say("phase18 (b) MoE layer gradients card vs CPU",
        json.dumps(dict(moe_layer_grads_vs_cpu(dev, K), card=smi,
                        seconds=time.perf_counter() - tb)))
    torch.cuda.empty_cache()
    for arch in REC_ARCHS:
        tb = time.perf_counter()
        base = get_config(arch)
        layers = base.attn_every if base.family == "hybrid" else 2
        cfg32 = dataclasses.replace(base, num_layers=layers, param_dtype="float32",
                                    compute_dtype="float32")
        say("phase18 (b) one-cycle float32 step card vs CPU", json.dumps(dict(
            train_step_vs_cpu(dev, cfg32, seed=FAM_SEED, tol=FAM_TOL.get(arch, TRAIN_TOL)),
            card=smi, seconds=time.perf_counter() - tb)))
        torch.cuda.empty_cache()
    say(f"phase18 checks seconds: {time.perf_counter() - t:.1f}")
    counts, shapes = {}, {}
    for arch in FAM_ARCHS:
        ta = time.perf_counter()
        c, sh, _ = family_train_run(dev, K, smi, arch)
        say(f"phase18 {arch} seconds: {time.perf_counter() - ta:.1f}")
        for k, x in c.items():
            counts[k] = counts.get(k, 0) + x
        for k, by in sh.items():
            for key, x in by.items():
                shapes.setdefault(k, {})[key] = shapes.get(k, {}).get(key, 0) + x
    for r in rows:
        r["launches"] = counts[r["name"].split(":")[0]]
    return counts, shapes, rows


# -- the vlm and encdec families (phase 19) --------------------------------------------


def _x_cfg32(arch):
    """Phase 19 (b)'s float32 copy at full width: one vlm cycle (4 self
    layers and the cross layer), or Whisper whole."""
    from repro_torch.configs import get_config

    base = get_config(arch)
    layers = base.cross_attn_every if base.family == "vlm" else base.num_layers
    return dataclasses.replace(base, num_layers=layers, param_dtype="float32",
                               compute_dtype="float32")


def _x_frontend(cfg, gen):
    """One sequence's frontend input from ``make_batch``, on ``gen``'s
    device: {"img_embed": (1, num_image_tokens, frontend_dim)} or
    {"enc_embed": (1, encoder_seq, d)}."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.train.steps import make_batch

    batch = make_batch(cfg, ShapeSpec("phase19", 1, 1, "prefill"), gen)
    return {k: v for k, v in batch.items() if k != "tokens"}


def cross_layer_grads_vs_cpu(cfg32, model32, dev, gen):
    """Phase 19 (b): one full-width float32 vlm cross layer (``lnx``,
    ``xattn``, ``ln2``, ``mlp``) on LM_CPU_PROMPT tokens against a
    1,601-row image source (``img_proj`` of a drawn image): the gradients
    of the input, the source and every weight on the card (flash forward,
    plain float32 backward) against the CPU's, each within TRAIN_TOL of
    its max. Returns the shares."""
    import copy

    import torch

    from repro_torch.models import transformer as TM

    layer = model32.blocks[0].cross
    cpu = copy.deepcopy(layer).to("cpu")
    with torch.no_grad():
        (img,) = _x_frontend(cfg32, gen).values()
        src = img @ model32.img_proj
    x = torch.randn(1, LM_CPU_PROMPT, cfg32.d_model, device=dev, generator=gen)
    g = torch.randn(1, LM_CPU_PROMPT, cfg32.d_model, device=dev, generator=gen)
    grads, names = {}, ["x", "src"] + [n for n, _ in layer.named_parameters()]
    for side, m in (("card", layer), ("cpu", cpu)):
        d = m.ln2.w.device
        xs, ss = x.to(d).requires_grad_(), src.to(d).requires_grad_()
        out = TM._apply_dense_layer(m, xs, cfg32, None, None, None, cross_src=ss)
        grads[side] = torch.autograd.grad(out, [xs, ss, *m.parameters()], g.to(d))
    shares = {n: float((a.cpu() - b).abs().max() / b.abs().max())
              for n, a, b in zip(names, grads["card"], grads["cpu"])}
    require(max(shares.values()) <= TRAIN_TOL,
            f"phase19 (b) the float32 cross layer's gradients differ card vs CPU: {shares}")
    del cpu, grads
    return shares


def x_checks(dev, K, smi):
    """Phase 19 (a) and (b): flash at the cross-attention shapes against its
    plain version; then, in float32 at full width, card against CPU: one
    vlm cycle with and without a 1,601-row image, Whisper whole with 1,500
    frames (a LM_CPU_PROMPT-token prefill and LM_CPU_STEPS greedy decode
    steps: logits within LM_TOL of max |logit|, tokens equal); one cross
    layer's gradients; one AdamW step of Whisper whole with its frames
    (14c's rule). Returns flash's worst error."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TM

    gen = torch.Generator(device=dev).manual_seed(X_SEED)
    with torch.inference_mode():
        worst = {"random": flash_checks(dev, X_FLASH_SHAPES, causal_modes=(False,)),
                 "cancel": flash_checks(dev, X_FLASH_CANCEL_SHAPES, cancel=True,
                                        causal_modes=(False,))}
    say("phase19 (a) flash at the cross-attention shapes, largest |diff| and share:",
        json.dumps(worst))
    torch.cuda.empty_cache()
    for arch in X_ARCHS:
        cfg32 = _x_cfg32(arch)
        model32 = TM.init_params(cfg32, seed=X_SEED, device=dev)
        prompt = lm_prompts(cfg32, 1, LM_CPU_PROMPT, LM_CPU_PROMPT, seed=X_SEED)[0]
        fe = {k: v.cpu() for k, v in _x_frontend(cfg32, gen).items()}
        for with_fe in ((True, False) if cfg32.family == "vlm" else (True,)):
            tb = time.perf_counter()
            share, same_tokens, toks = lm_vs_cpu(cfg32, model32, prompt, 512, LM_CPU_STEPS,
                                                 frontend=fe if with_fe else None)
            say("phase19 (b) card vs CPU", json.dumps({
                "arch": arch, "layers": cfg32.num_layers, "d_model": cfg32.d_model,
                "dtype": "float32", "prompt": LM_CPU_PROMPT, "decode_steps": LM_CPU_STEPS,
                "frontend": {k: list(v.shape) for k, v in fe.items()} if with_fe else None,
                "max_logit_err_share": share, "tolerance": LM_TOL, "tokens": toks,
                "tokens_equal": same_tokens, "seconds": time.perf_counter() - tb,
                "reduced": (f"one cycle, {cfg32.num_layers} of {get_config(arch).num_layers} "
                            "layers" if cfg32.family == "vlm" else "whole"),
                "card": smi}))
            require(share <= LM_TOL and same_tokens,
                    f"phase19 (b) {arch} (frontend {with_fe}): the float32 model on the card "
                    f"differs from the CPU (share {share}, tokens equal {same_tokens})")
        if cfg32.family == "vlm":
            tb = time.perf_counter()
            say("phase19 (b) float32 cross layer gradients card vs CPU (share of max |g|):",
                json.dumps({"tokens": LM_CPU_PROMPT, "image_rows": cfg32.num_image_tokens,
                            "shares": cross_layer_grads_vs_cpu(cfg32, model32, dev, gen),
                            "tolerance": TRAIN_TOL, "seconds": time.perf_counter() - tb}))
        del model32
        torch.cuda.empty_cache()
    cfg32 = _x_cfg32("whisper-base")
    tb = time.perf_counter()
    fe = {k: v.cpu() for k, v in _x_frontend(cfg32, gen).items()}
    say("phase19 (b) whisper-base float32 AdamW step card vs CPU", json.dumps(dict(
        train_step_vs_cpu(dev, cfg32, seed=X_SEED, frontend=fe), frames=cfg32.encoder_seq,
        card=smi, seconds=time.perf_counter() - tb)))
    torch.cuda.empty_cache()
    return max(e for w in worst.values() for e, _ in w.values())


def x_serve(dev, K, smi, arch, cfg, model, gen):
    """Phase 19 (c)-(e) for one model at full width and depth in bfloat16:
    (c) the serve (``Engine``: X_REQUESTS prompts of X_PROMPT_LENS tokens,
    X_MAX_NEW new each, X_SLOTS slots, X_MAX_LEN positions; flash exactly
    once per attention layer per prefill and never at decode), with a
    profile of the longest prefill and a decode tick; (d) the engine with
    one slot against a manual loop; (e) a manual prefill with the frontend
    input (X_FRONTEND_PREFILL) and X_DECODE_STEPS greedy decode steps:
    flash once per attention layer of the prefill (the encoder's too),
    never at decode. Returns (the launches of (c) and (e), by shape)."""
    import torch

    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.models import transformer as TM
    from repro_torch.train.steps import make_batch, make_decode_step, make_prefill_step

    mem0 = torch.cuda.memory_allocated() - sum(p.numel() * p.element_size()
                                               for p in model.parameters())
    prompts = lm_prompts(cfg, X_REQUESTS, *X_PROMPT_LENS, seed=0)
    counts, rec = serve_lm(cfg, model, prompts, X_SLOTS, X_MAX_LEN, X_MAX_NEW)
    shapes = rec.pop("launch_shapes")
    prompt_tokens = sum(len(p) for p in prompts)
    rec.update({"arch": arch, "prefill_tokens_per_s": prompt_tokens / (sum(rec["prefill_ms"]) / 1e3),
                "attention_layers": TM.attention_layers(cfg),
                "peak_bytes_above_earlier_phases": (rec["max_memory_allocated"] - mem0
                                                    if dev.type == "cuda" else None),
                "launches": counts, "card": smi})
    say("phase19 (c) serve", json.dumps(rec))  # serve_lm checked flash's launches
    longest = torch.from_numpy(max(prompts, key=len)[None]).to(dev)
    prefill, decode = make_prefill_step(cfg, X_MAX_LEN), make_decode_step(cfg)
    st = TM.init_cache(cfg, X_SLOTS, X_MAX_LEN, device=dev)._replace(index=rec["final_index"])
    tok4 = torch.zeros(X_SLOTS, 1, dtype=torch.int32, device=dev)
    kinds = {"flash kernel": ("flash_fwd",), "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
             "elementwise": ("elementwise",), "reductions": ("reduce",),
             "copies and fills": ("Memcpy", "Memset", "fill", "copy")}
    prof = {"prefill": {"tokens": longest.shape[1], **device_profile(
                lambda: prefill(model, {"tokens": longest}), dev, kinds)},
            "decode_tick": {"slots": X_SLOTS, "index": st.index, **device_profile(
                lambda: decode(model, st, tok4), dev, kinds)}}
    say("phase19 (c) profile", json.dumps(dict(prof, arch=arch, card=smi)))
    del st
    got, want, same_cache = engine_equals_manual_loop(cfg, model, prompts[0], X_MAX_LEN,
                                                      X_MAX_NEW)
    say("phase19 (d) engine vs manual loop:", json.dumps(
        {"arch": arch, "engine": got, "manual": want, "same_cache": same_cache}))
    require(got == want and same_cache,
            f"phase19 {arch}: the engine differs from a manual prefill + decode loop")
    # (e) the frontend input at prefill; decode reads the cross caches
    S, rows = X_FRONTEND_PREFILL[arch]
    batch = make_batch(cfg, ShapeSpec("phase19", S, 1, "prefill"), gen)
    (name, fe), = ((k, v) for k, v in batch.items() if k != "tokens")
    require(fe.shape[1] == rows, f"{arch}: make_batch gave {name} {tuple(fe.shape)}")
    attn = TM.attention_layers(cfg) + (cfg.encoder_layers if cfg.family == "encdec" else 0)
    torch.cuda.synchronize()
    K.reset_launch_counts()  # the frontend prefill and its decode start here
    t0 = time.perf_counter()
    logits, st = prefill(model, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    at_prefill = K.launch_counts()["flash_attention"]
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    step_ms, toks, finite = [], [int(tok[0, 0])], bool(torch.isfinite(logits).all())
    for _ in range(X_DECODE_STEPS):
        t0 = time.perf_counter()
        lg, nxt, st = decode(model, st, tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= bool(torch.isfinite(lg).all())
        tok = nxt[:, None]
        toks.append(int(nxt[0]))
    e_counts, e_shapes = K.launch_counts(), K.launch_shapes()  # and end here
    say("phase19 (e) prefill with the frontend input, then decode", json.dumps({
        "arch": arch, "prompt": S, name: list(fe.shape), "prefill_ms": prefill_ms,
        "decode_ms_per_step": [min(step_ms), sum(step_ms) / len(step_ms)],
        "decode_steps": X_DECODE_STEPS, "flash_launches": [at_prefill, e_counts["flash_attention"]],
        "tokens": toks, "card": smi}))
    require(finite and at_prefill == attn and e_counts["flash_attention"] == attn,
            f"phase19 (e) {arch}: flash launched {at_prefill} at prefill and "
            f"{e_counts['flash_attention'] - at_prefill} at decode (want {attn} and 0); "
            f"finite {finite}")
    del st, logits, batch
    for k, c in e_counts.items():
        counts[k] = counts.get(k, 0) + c
    for k, by in e_shapes.items():
        for shp, c in by.items():
            shapes.setdefault(k, {})[shp] = shapes.get(k, {}).get(shp, 0) + c
    return counts, shapes


def x_train(dev, K, smi, arch, gen):
    """Phase 19 (f): X_STEPS steps of ``make_train_step`` on ``make_batch``'s
    inputs (the frontend's included), bfloat16 with remat, AdamW
    (``default_opt_config``), at X_TRAIN's shape. Per step the rows kernel
    runs once (the embedding backward) and flash once per attention use in
    the forward and once more in the remat recompute of a vlm cycle or a
    Whisper decoder layer; Whisper's encoder layers are not recomputed, so
    their flash runs once: 30 a Whisper step (6 + 2 x (6 + 6)), 20 a step
    of 2 vlm cycles (2 x 2 x (4 + 1)). Returns (launches, by shape, the
    record)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.models.config import flops_per_token
    from repro_torch.train.steps import default_opt_config, make_batch, make_init_fn, make_train_step

    full = get_config(arch)
    B, S, cycles = X_TRAIN[arch]
    cfg = full if cycles is None else dataclasses.replace(
        full, num_layers=cycles * full.cross_attn_every)
    oc = default_opt_config(full, total_steps=X_STEPS)
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = make_init_fn(cfg, oc)(X_SEED, device=dev)
    step = make_train_step(cfg, oc)
    batches = [make_batch(cfg, ShapeSpec("phase19", S, B, "train"), gen) for _ in range(X_STEPS)]
    torch.cuda.synchronize()
    K.reset_launch_counts()  # this family's train steps start here
    losses, norms, secs = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))  # waits for the step
        norms.append(float(met["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    counts, shapes = K.launch_counts(), K.launch_shapes()  # and end here
    peak = torch.cuda.max_memory_allocated() - mem0
    opt = state.opt
    require(all(math.isfinite(x) for x in losses + norms),
            f"{arch}: training diverged: {losses} {norms}")
    stale = [n for n in opt.m
             if not (float(opt.m[n].abs().max()) > 0 and float(opt.v[n].abs().max()) > 0)]
    require(opt.step == X_STEPS and not stale, f"{arch}: moments that did not move: {stale}")
    if cfg.family == "vlm":
        per_step = 2 * cycles * cfg.cross_attn_every
    else:
        per_step = cfg.encoder_layers + 2 * 2 * cfg.num_layers
    want = {"cobra_bin_accumulate_rows": X_STEPS, "flash_attention": per_step * X_STEPS}
    got = {k: counts[k] for k in want}
    require(got == want, f"{arch}: {X_STEPS} steps launched {got}, expected {want}")
    tokens = B * S
    ms = min(1e3 * x for x in secs[1:])
    rec = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
           "of_layers": full.num_layers, "parameters": sum(p.numel() for p in
                                                          state.params.parameters()),
           "remat": cfg.remat, "optimizer": oc.kind, "batch": B, "seq_len": S,
           "frontend": {k: list(v.shape) for k, v in batches[0].items()
                        if k not in ("tokens", "labels")},
           "losses": losses, "grad_norms": norms, "step_ms": [1e3 * x for x in secs],
           "steady_step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
           "model_flop_per_s": flops_per_token(cfg) * tokens / ms * 1e3,
           "model_flop_share_of_989T": flops_per_token(cfg) * tokens / ms * 1e3 / BF16_FLOP_PER_S,
           "peak_bytes_above_earlier_phases": peak, "earlier_phases_bytes": mem0,
           "launches": got, "card": smi}
    say("phase19 (f) train", json.dumps(rec))
    del state, batches, opt, step
    torch.cuda.empty_cache()
    return counts, shapes, rec


def x_launcher_train(dev, K, smi):
    """Phase 19 (f): ``launch/train.py`` for whisper-base, X_STEPS steps at
    X_TRAIN's shape. Its batches hold tokens and labels only, as the
    reference's do, so the cross layers and the encoder are skipped: their
    moments must stay exactly zero (their gradients are exactly zero) and
    every other moment must move; flash runs for the decoder's
    self-attention only, twice a layer a step (remat)."""
    import torch

    from repro_torch.launch import train as train_mod

    arch = "whisper-base"
    B, S, _ = X_TRAIN[arch]
    torch.cuda.empty_cache()
    args = train_mod.parse_args(["--arch", arch, "--preset", "full", "--seq-len", str(S),
                                 "--batch", str(B), "--steps", str(X_STEPS), "--log-every", "1"])
    K.reset_launch_counts()  # the launcher's path starts here
    run = train_mod.train(args)
    torch.cuda.synchronize()
    counts, shapes = K.launch_counts(), K.launch_shapes()  # and ends here
    opt = run.state.opt
    unreached = [n for n in opt.m if ".xattn." in n or ".lnx." in n or n.startswith("enc_")]
    moved = [n for n in opt.m if float(opt.m[n].abs().max()) > 0
             and float(opt.v[n].abs().max()) > 0]
    nonzero = [n for n in unreached if opt.m[n].any() or opt.v[n].any()]
    require(len(run.losses) == X_STEPS and all(math.isfinite(x) for x in run.losses + run.grad_norms),
            f"{arch} launcher: {run.losses} {run.grad_norms}")
    require(unreached and not nonzero and sorted(moved) == sorted(set(opt.m) - set(unreached)),
            f"{arch} launcher: unreached leaves with moments {nonzero}; moved "
            f"{len(moved)} of {len(opt.m) - len(unreached)} reached")
    layers = run.state.params.cfg.num_layers
    want = {"cobra_bin_accumulate_rows": X_STEPS, "flash_attention": 2 * layers * X_STEPS}
    got = {k: counts[k] for k in want}
    require(got == want, f"{arch} launcher: {X_STEPS} steps launched {got}, expected {want}")
    say("phase19 (f) launch/train.py", json.dumps({
        "arch": arch, "batch": B, "seq_len": S, "losses": run.losses,
        "grad_norms": run.grad_norms, "step_ms": [1e3 * x for x in run.step_seconds],
        "unreached_leaves_zero": len(unreached), "moved": len(moved), "launches": got,
        "card": smi}))
    del run, opt
    torch.cuda.empty_cache()
    return counts, shapes


def cross_phase(dev, K, smi):
    """Phase 19: the vlm and encdec families. (a), (b): ``x_checks``; then
    for each of X_ARCHS at full width and depth in bfloat16 from a seeded
    generator: (c)-(e) ``x_serve``, (f) ``x_train``; then (f) the launcher
    for whisper-base (``x_launcher_train``); then the kernels line's rows
    8d (flash at the vlm's cross-attention prefill), 8e (flash at
    Whisper's encoder) and 5f (the rows kernel at the vlm's embedding
    backward). Returns (launches of (c), (e) and (f), by shape, the
    rows)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TM

    t = time.perf_counter()
    worst = x_checks(dev, K, smi)
    say(f"phase19 checks seconds: {time.perf_counter() - t:.1f}")
    counts_all, shapes_all = {}, {}

    def add(c, sh):
        for k, x in c.items():
            counts_all[k] = counts_all.get(k, 0) + x
        for k, by in sh.items():
            for key, x in by.items():
                shapes_all.setdefault(k, {})[key] = shapes_all.get(k, {}).get(key, 0) + x

    gen = torch.Generator(device=dev).manual_seed(X_SEED)
    for arch in X_ARCHS:
        ta = time.perf_counter()
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        model = TM.init_params(cfg, seed=X_SEED, device=dev)
        torch.cuda.synchronize()
        say("phase19 model", json.dumps({
            "arch": arch, "family": cfg.family, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers, "attention_layers": TM.attention_layers(cfg),
            "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
            "parameters": sum(p.numel() for p in model.parameters()),
            "parameter_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "earlier_phases_bytes": mem0, "seconds_to_draw": time.perf_counter() - ta}))
        add(*x_serve(dev, K, smi, arch, cfg, model, gen))
        del model
        torch.cuda.empty_cache()
        c, sh, _ = x_train(dev, K, smi, arch, gen)
        add(c, sh)
        say(f"phase19 {arch} seconds: {time.perf_counter() - ta:.1f}")
    ta = time.perf_counter()
    add(*x_launcher_train(dev, K, smi))
    say(f"phase19 launcher seconds: {time.perf_counter() - ta:.1f}")
    vlm, whisper = get_config("llama-3.2-vision-11b"), get_config("whisper-base")
    with torch.inference_mode():
        rows = [flash_row("flash_attention:vlm_cross_prefill", vlm, dev, gen, 1024,
                          counts_all["flash_attention"], worst, Skv=vlm.num_image_tokens,
                          causal=False),
                flash_row("flash_attention:whisper_encoder", whisper, dev, gen,
                          whisper.encoder_seq, counts_all["flash_attention"], worst,
                          causal=False)]
    B, S, _ = X_TRAIN["llama-3.2-vision-11b"]
    emb = embedding_backward_check(dev, K, vlm, B=B, S=S)
    rows.append({
        "name": "cobra_bin_accumulate_rows:vlm_embedding_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_rows.cu",
        "replaces": "src/repro/kernels/fused.py:263",
        "launches": counts_all["cobra_bin_accumulate_rows"], "checked_against_plain": True,
        "shape": {k: emb[k] for k in ("m", "F", "n")}, "dtype": "bfloat16 cotangent, float32 rows",
        "max_abs_err": emb["max_abs_err"], "ms": emb["ms"],
        "kernel_device_ms": emb["profile"]["device_ms"], "plain_ms": emb["plain_ms"],
        "bound_ms": emb["bound_ms"], "bound_bytes": emb["bound_bytes"], "bound_by": "bytes",
        "library_ms": emb["library_ms"]})
    say("phase19 rows 8d, 8e, 5f", json.dumps(rows))
    torch.cuda.empty_cache()
    return counts_all, shapes_all, rows


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


def min_label_components(g):
    """Weakly connected components, each labelled with its smallest vertex
    id, by plain torch on the graph's device (no executor): every vertex
    takes the smallest label at either end of its edges, then follows its
    label's label, until nothing changes."""
    import torch

    src, dst = g.src.long(), g.dst.long()
    lab = torch.arange(g.num_nodes, device=src.device)
    while True:
        m = torch.minimum(lab[src], lab[dst])
        new = lab.scatter_reduce(0, src, m, "amin").scatter_reduce_(0, dst, m, "amin")
        while True:  # pointer jumping
            hop = new[new]
            if torch.equal(hop, new):
                break
            new = hop
        if torch.equal(new, lab):
            return lab.to(torch.int32).cpu()
        lab = new


def scipy_sssp(csr, w, source):
    """Dijkstra in float64 on the same weighted edges (parallel edges
    reduced to their lightest first); unreached vertices are inf. A list
    of sources gives one row each, from one build of the matrix."""
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


def traversal_phase(dev, T, K, suite, sizes, cache):
    """Phase 12: BFS (with parents), SSSP, k-core, both CC forms, radii,
    the batched BFS/SSSP and PPR through the port's entry points on
    ``suite`` (S1, held to executor-free oracles) and on
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

    def sssp_vs_dijkstra(tag, d64, dist, rounds):
        """An SSSP distance vector against scipy's float64 Dijkstra's
        (``scipy_sssp``), within SSSP_EPS a hop (the docstring's rule); its
        record."""
        d64 = torch.from_numpy(d64)
        d32 = dist.cpu()
        reached = torch.isfinite(d64)
        require(torch.equal(reached, d32 < F32_MAX),
                f"{tag}: SSSP reaches other vertices than Dijkstra")
        dr = d64[reached]
        hops = torch.clamp(dr / SSSP_W_MIN, min=rounds)  # see the docstring
        tol = hops * SSSP_EPS * dr
        err = (d32[reached].double() - dr).abs()
        rec = {"max_abs_err": float(err.max()),
               "worst_share_of_tol": float((err / tol.clamp(min=1e-30)).max())}
        require(bool((err <= tol).all()), f"{tag}: SSSP differs from Dijkstra ({rec})")
        return rec

    def independent_checks(tag, g, csr, source, w, srcs, res, dijkstra=False, lanes=False,
                           oracles=False, scipy_cc=True):
        """Results against code that does not use the executor. ``oracles``
        (every S1 graph): every batched lane, radii and PPR against
        executor-free oracles too. CC labels against scipy's components, or
        (``scipy_cc=False``, S2 and S3) a plain-torch min-label propagation."""
        rec = {}
        dd, dp = dense_bfs(T, csr, source)
        b = res["bfs"]
        require(same(b.dist, dd) and same(b.parent, dp),
                f"{tag}: BFS levels or parents differ from the dense BFS")
        want = torch.from_numpy(scipy_cc_labels(g)) if scipy_cc else min_label_components(g)
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
        if dijkstra or oracles:  # one Dijkstra call: the source, then the lanes
            d64 = scipy_sssp(csr, w, [source] + (list(srcs) if oracles else []))
        if dijkstra:
            rec["sssp_vs_dijkstra"] = sssp_vs_dijkstra(tag, d64[0], res["sssp"].dist,
                                                       res["sssp"].levels)
        if oracles:
            worst = 0.0
            for q, s in enumerate(srcs):
                dd, dp = dense_bfs(T, csr, s)
                require(same(res["bfs_batched"].dist[q], dd)
                        and same(res["bfs_batched"].parent[q], dp),
                        f"{tag}: bfs_batched lane {q} differs from the dense BFS")
                worst = max(worst, sssp_vs_dijkstra(
                    f"{tag} sssp_batched lane {q}", d64[1 + q], res["sssp_batched"].dist[q],
                    res["sssp_batched"].levels)["worst_share_of_tol"])
            rec["sssp_batched_vs_dijkstra_worst_share_of_tol"] = worst
            want = np.stack([T.personalized_pagerank_oracle(csr, s) for s in srcs])
            ok, errs = pr_close(res["ppr"].ranks, torch.from_numpy(want))
            require(ok, f"{tag}: PPR differs from the float64 power iteration ({errs})")
            rec["ppr_vs_float64"] = errs
            # radii: radii's own draw of sources, each eccentricity by the dense BFS
            draw = torch.randperm(csr.num_nodes, generator=torch.Generator().manual_seed(0))
            ecc = []
            for s in draw[:RADII_K].tolist():
                dd, _ = dense_bfs(T, csr, s)
                ecc.append(int(dd[dd != INT32_MAX].max()))
            want_ecc = [min(e, RADII_ITERS) for e in ecc]
            require(res["radii"].ecc.tolist() == want_ecc
                    and res["radii"].converged == all(e < RADII_ITERS for e in ecc),
                    f"{tag}: radii {res['radii'].ecc.tolist()} (converged "
                    f"{res['radii'].converged}), the dense BFS {ecc}")
            rec["radii_dense_bfs_ecc"] = ecc
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

    K.reset_launch_counts()  # the traversal path starts here
    for name, g in suite.items():
        t0 = time.perf_counter()
        csr, source, w, srcs = prepare(g)
        res = run_all(g, csr, source, w, srcs, ex)
        t_card = time.perf_counter() - t0
        rec = independent_checks(f"phase12 S1 {name}", g, csr, source, w, srcs, res,
                                 dijkstra=True, oracles=True)
        rec["checks_s"] = time.perf_counter() - t0 - t_card
        # BFS and CC-PB under the kernel-backed binning method
        T.set_default_executor(ex_pallas)
        bp = T.bfs(csr, source, executor=ex_pallas)
        cp = TC.connected_components_pb(g, max_iters=g.num_nodes)
        require(same(bp.dist, res["bfs"].dist) and same(bp.parent, res["bfs"].parent)
                and same(cp.labels, res["cc_pb"].labels),
                f"phase12 S1 {name}: use_pallas BFS / CC-PB differ from the default executor")
        say(f"phase12 S1 {name}", json.dumps({"n": g.num_nodes, "m": g.num_edges, "source": source,
                                             **summary(res), **rec, "card_run_s": t_card}))
    for tag, g in sizes.items():
        full = tag == "S2"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        csr, source, w, srcs = prepare(g)
        res = run_all(g, csr, source, w, srcs, ex, full=full)
        T.set_default_executor(ex_pallas)
        bp = T.bfs(csr, source, executor=ex_pallas)
        require(same(bp.dist, res["bfs"].dist) and same(bp.parent, res["bfs"].parent),
                f"phase12 {tag}: use_pallas BFS differs from the default executor")
        t1 = time.perf_counter()
        times = timings(g, csr, source, w, srcs, full=full)
        peak = torch.cuda.max_memory_allocated() if on_card else None
        t2 = time.perf_counter()
        rec = independent_checks(f"phase12 {tag}", g, csr, source, w, srcs, res, dijkstra=full,
                                 lanes=full, scipy_cc=False)
        rec["seconds"] = {"run": t1 - t0, "timings": t2 - t1, "checks": time.perf_counter() - t2}
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


# -- Sharded PB over four ranks (phase 16) ---------------------------------------------


def _rank_timed(rec, name, fn, mesh):
    """One call of ``fn`` on every rank; this rank's seconds for it, from
    a barrier (every rank starts together) to a device synchronisation."""
    import torch

    from repro_torch.core.distributed_pb import barrier

    barrier(mesh)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec["seconds"][name] = time.perf_counter() - t
    return out


def _rank_profile(fn, mesh):
    """``kernel_profile`` of ``fn`` on rank 0 of ``mesh``, while every other
    rank calls ``fn`` (which runs collectives) once outside the profile
    and once beside each of rank 0's tries; whether a try kept its markers
    is agreed over the ranks, so all of them try again together. Returns
    rank 0's listing (None on the other ranks)."""
    import torch

    from repro_torch.core.distributed_pb import any_across

    def agree(kept):
        return not bool(any_across(torch.tensor(not kept), mesh))

    if mesh.rank == 0:
        return kernel_profile(fn, agree)
    fn()
    for _ in range(PROFILE_TRIES):
        fn()
        torch.cuda.synchronize()
        if agree(True):
            return None
    fail(f"phase16 rank {mesh.rank}: rank 0's profile kept no try")


def sharded_rank(rank, world, outdir, device="cuda:0"):
    """One of phase 16's ranks (``repro_torch.launch.ranks.spawn_ranks``):
    every rank builds S2 and S3 from the same seeds on ``cuda:0``, computes
    the single-device results the sharded ones are held to, then drives
    the sharded path with the launch counts set to 0 and reads them after
    (two windows, S2 and S3), and writes what it measured to
    ``outdir/rank<rank>.json``."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np

    import repro_torch.core as T
    import repro_torch.kernels as K
    from repro_torch.core import distributed_pb as dpb
    from repro_torch.core import traffic
    from repro_torch.core.executor import execute_reduce
    from repro_torch.core.pb import bin_ids
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels.fused import fused_design
    from repro_torch.timing import cuda_ms

    dev = torch.device(device)
    if dev.type == "cuda":
        _lib.load()  # built by the parent: this finds the library
        torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cache = os.path.join(outdir, "cache")  # one directory: only rank 0 writes it
    T.set_default_executor(T.PBExecutor(cache_dir=cache))
    ex = T.PBExecutor(cache_dir=cache)
    mesh = T.make_stream_mesh(device=dev)
    require(mesh.size == world, f"phase16: mesh {mesh}")
    rec = {"rank": rank, "seconds": {}, "info": {}, "checks": {}, "decided": {}}
    t_rank = time.perf_counter()

    # -- S2: the single-device results first (their launches do not count)
    s2 = T.gen_uniform(*SHARD_S2, seed=3, device=dev)
    n2, m2 = s2.num_nodes, s2.num_edges
    gen = torch.Generator(device=dev).manual_seed(16)
    outdeg = T.degrees_from_coo(s2, by="src").clamp(min=1).float()
    vals = {
        "add": (torch.full((n2,), 1.0 / n2, device=dev) / outdeg)[s2.src],  # PageRank's stream
        "min": torch.randint(-2**30, 2**30, (m2,), dtype=torch.int32, device=dev, generator=gen),
        "max": torch.randint(-2**30, 2**30, (m2,), dtype=torch.int32, device=dev, generator=gen),
    }
    want = {op: execute_reduce(s2.dst, v, out_size=n2, op=op) for op, v in vals.items()}
    ones = torch.ones(m2, dtype=torch.int32, device=dev)
    outdeg_i = execute_reduce(s2.src, ones, out_size=n2)
    indeg_i = execute_reduce(s2.dst, ones, out_size=n2)
    base = T.build_csr_baseline(s2)
    pr_ref = T.pagerank_fused(s2, iters=ITERS).ranks
    cc_ref = T.connected_components_fused(s2)
    source = int(torch.argmax(outdeg_i))
    bfs_ref = T.bfs(base, source, with_parents=True)
    pre_ref = T.PreprocessPipeline(warmup=False).run(s2)
    ex_pallas = T.PBExecutor(cache_dir=cache, use_pallas=True)
    if rank == 0:  # the float32 add check must refuse a wrong sum of PageRank's stream
        rec["faults"] = {"S2 add": add_faults(s2.dst, vals["add"], n2, want["add"], want["add"])}

    def check(name, ok, err=None):
        rec["checks"][name] = err if err is not None else bool(ok)
        require(ok, f"phase16 rank {rank}: {name} ({err})")

    # -- S2: the sharded path, counted; first the row-valued add, whose
    # values (4.3 GB, on every rank) go before the other calls
    K.reset_launch_counts()
    ridx = s2.dst[:SHARD_ROWS_M]
    rval = torch.randn(SHARD_ROWS_M, GNN_D, device=dev, generator=gen)
    peak_before = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    name = f"S2 rows F={GNN_D} add (first {SHARD_ROWS_M} tuples)"
    got, info = _rank_timed(rec, name, lambda: dpb.shard_reduce_stream_info(
        ridx, rval, out_size=n2, mesh=mesh, op="add"), mesh)
    rec["info"][name] = info
    rec["rows_bytes"] = {"values": rval.numel() * 4, "held_before": held,
                         "peak": torch.cuda.max_memory_allocated(dev)}
    if rank == 0:  # against the plain sum, which takes no kernel
        want_rows = ref.scatter_reduce_ref(ridx, rval, n2)
        scale = torch.zeros_like(want_rows)
        for a in range(0, SHARD_ROWS_M, 1 << 22):
            scale.index_add_(0, ridx[a:a + (1 << 22)], rval[a:a + (1 << 22)].abs())
        check(name, add_close(got, want_rows, scale), add_ratio(got, want_rows, scale))
        rec["faults"]["S2 rows"] = add_faults(ridx, rval, n2, want_rows, scale)
        del want_rows, scale
    del got
    # the rows kernel's input at a rank's local reduce (row 5d, timed below)
    r2 = dpb.shard_range_for(n2, world)
    rows_loc = -(-SHARD_ROWS_M // world)
    rli, rlv, _ = dpb.owner_exchange(
        dpb._rank_block(ridx, rank, rows_loc, n2), dpb._rank_block(rval, rank, rows_loc, 0),
        out_size=n2, shard_range=r2, mesh=mesh,
        capacity=dpb.estimate_capacity(ridx, out_size=n2, n_dev=world))
    rli = dpb.clamp_for_local_reduce(rli, r2)
    del ridx, rval
    if rank != 0:
        del rli, rlv
    torch.cuda.empty_cache()
    for op, v in vals.items():
        for k in SHARD_KS:
            for packed in (True, False):
                name = f"S2 {op} K{k} {'packed' if packed else 'two collectives'}"
                got, info = _rank_timed(rec, name, lambda: dpb.shard_reduce_stream_info(
                    s2.dst, v, out_size=n2, mesh=mesh, op=op, pipeline_chunks=k, packed=packed),
                    mesh)
                rec["info"][name] = info
                if op == "add":
                    check(name, add_close(got, want[op], want[op]),
                          add_ratio(got, want[op], want[op]))
                else:
                    check(name, torch.equal(got, want[op]))
        name = f"S2 {op} decided"
        got = _rank_timed(rec, name, lambda: ex.shard_reduce_stream(
            s2.dst, v, out_size=n2, mesh=mesh, op=op), mesh)
        entry = ex.decision_log[-1]
        rec["decided"][op] = {k: entry[k] for k in (
            "method", "bin_range", "source", "num_indices", "stream_len", "pipeline_chunks",
            "capacity", "capacity_source", "overflow", "packed")}
        if op == "add":
            check(name, add_close(got, want[op], want[op]), add_ratio(got, want[op], want[op]))
        else:
            check(name, torch.equal(got, want[op]))
    name = "S2 degrees at capacity 1 (forced overflow)"
    got, info = _rank_timed(rec, name, lambda: dpb.shard_reduce_stream_info(
        s2.src, ones, out_size=n2, mesh=mesh, capacity=1), mesh)
    rec["info"][name] = info
    check(name, info["overflow"] and info["fallback"] and torch.equal(got, outdeg_i))
    csr = _rank_timed(rec, "S2 build_csr sharded", lambda: T.build_csr(
        s2, method="sharded", mesh=mesh), mesh)
    check("S2 build_csr sharded == build_csr_baseline",
          torch.equal(csr.offsets, base.offsets) and torch.equal(csr.neighs, base.neighs))
    del csr
    pr = _rank_timed(rec, f"S2 pagerank_sharded {ITERS} iterations",
                     lambda: T.pagerank_sharded(s2, mesh, iters=ITERS), mesh)
    ok, errs = pr_close(pr.ranks, pr_ref)
    check("S2 pagerank_sharded vs pagerank_fused", ok, errs)
    cc = _rank_timed(rec, "S2 connected_components_sharded",
                     lambda: T.connected_components_sharded(s2, mesh), mesh)
    check("S2 CC sharded labels == fused", torch.equal(cc.labels, cc_ref.labels)
          and cc.iters == cc_ref.iters)
    rec["cc_iters"] = cc.iters
    b = _rank_timed(rec, "S2 bfs over the mesh", lambda: T.bfs(
        base, source, mesh=mesh, with_parents=True), mesh)
    check("S2 bfs(mesh=) levels and parents == bfs", torch.equal(b.dist, bfs_ref.dist)
          and torch.equal(b.parent, bfs_ref.parent) and b.levels == bfs_ref.levels)
    rec["bfs_levels"] = b.levels
    pre = _rank_timed(rec, "S2 PreprocessPipeline over the mesh", lambda: T.PreprocessPipeline(
        mesh=mesh, warmup=False).run(s2), mesh)
    check("S2 PreprocessPipeline(mesh=) == single device", pre.report.sharded
          and torch.equal(pre.new_ids, pre_ref.new_ids)
          and all(torch.equal(getattr(pre, f).offsets, getattr(pre_ref, f).offsets)
                  and torch.equal(getattr(pre, f).neighs, getattr(pre_ref, f).neighs)
                  for f in ("csr", "csc")))
    rec["preprocess_stages_s"] = {s.name: s.seconds for s in pre.report.stages}
    del pre, pre_ref
    got = _rank_timed(rec, "S2 in-degrees, use_pallas executor, method pallas",
                      lambda: ex_pallas.shard_reduce_stream(
                          # pb-lint: disable=PB001 — the pallas arm, forced to launch its kernels
                          s2.dst, ones, out_size=n2, mesh=mesh, method="pallas"), mesh)
    check("S2 pallas reduce == in-degrees", torch.equal(got, indeg_i))
    rec["counts"] = [K.launch_counts()]
    rec["shapes"] = [K.launch_shapes()]
    require(all(rec["counts"][0][k] > 0 for k in (
        "cobra_bin_accumulate", "cobra_bin_accumulate_rows", "histogram", "counting_positions")),
        f"phase16 rank {rank}: a kernel of the sharded S2 path never launched: {rec['counts']}")

    # -- S2: the kernels at the shapes the ranks' local reduces take, the profile
    m_loc = -(-m2 // world)
    cap = dpb.estimate_capacity(s2.dst, out_size=n2, n_dev=world)
    li, lv, _ = dpb.owner_exchange(dpb._rank_block(s2.dst, rank, m_loc, n2),
                                   dpb._rank_block(vals["add"], rank, m_loc, 0), out_size=n2,
                                   shard_range=r2, mesh=mesh, capacity=cap)
    li = dpb.clamp_for_local_reduce(li, r2)
    br = min(max(64, T.compromise_bin_range(r2, T.HardwareModel.h100())), r2)
    keys = bin_ids(li, br)
    nb = -(-r2 // br)
    hist = K.histogram(keys, nb)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(hist, 0, dtype=torch.int32)])[:-1].contiguous()
    check("local histogram == plain", torch.equal(hist, ref.histogram_ref(keys, nb)))
    check("local positions == plain", torch.equal(K.counting_positions(keys, starts, nb),
                                                  ref.counting_positions_ref(keys, starts, nb)))
    if rank == 0:
        m_l, mr = int(li.shape[0]), int(rli.shape[0])
        got, plain = K.cobra_bin_accumulate(li, lv, r2, br, nb), ref.scatter_reduce_ref(li, lv, r2)
        check("local fused == plain", add_close(got, plain, plain), add_ratio(got, plain, plain))
        fused_err = float((got - plain).abs().max())
        rec["faults"]["local fused"] = add_faults(li, lv, r2, plain, plain)
        got = K.cobra_bin_accumulate_rows(rli, rlv, r2, 512, -(-r2 // 512))
        plain = ref.scatter_reduce_ref(rli, rlv, r2)
        scale = ref.scatter_reduce_ref(rli, rlv.abs(), r2)
        check("local rows == plain", add_close(got, plain, scale), add_ratio(got, plain, scale))
        rows_err = float((got - plain).abs().max())
        del got, plain, scale
        fb, rb = 8 * m_l + 4 * r2, 4 * mr + 4 * mr * GNN_D + 4 * r2 * GNN_D
        rec["kernel_rows"] = [
            {"name": "cobra_bin_accumulate:sharded_s2_local", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/fused.cu",
             "replaces": "src/repro/kernels/fused.py:344", "checked_against_plain": True,
             "max_abs_err": fused_err, "shape": {"m": m_l, "n": r2, "bin_range": br},
             "design": fused_design(m_l, r2),
             "ms": cuda_ms(lambda: K.cobra_bin_accumulate(li, lv, r2, br, nb), reps=20),
             "plain_ms": cuda_ms(lambda: ref.scatter_reduce_ref(li, lv, r2), reps=20),
             "bound_ms": bound_ms(fb), "bound_bytes": fb, "bound_by": "bytes",
             "library_ms": cuda_ms(lambda: torch.zeros(r2, device=dev).index_add_(0, li, lv),
                                   reps=20)},
            {"name": "cobra_bin_accumulate_rows:sharded_s2_local", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/fused_rows.cu",
             "replaces": "src/repro/kernels/fused.py:263", "checked_against_plain": True,
             "max_abs_err": rows_err, "shape": {"m": mr, "F": GNN_D, "n": r2},
             "ms": cuda_ms(lambda: K.cobra_bin_accumulate_rows(rli, rlv, r2, 512, -(-r2 // 512)),
                           reps=10),
             "plain_ms": cuda_ms(lambda: ref.scatter_reduce_ref(rli, rlv, r2), reps=10),
             "bound_ms": bound_ms(rb), "bound_bytes": rb, "bound_by": "bytes",
             "library_ms": cuda_ms(lambda: torch.zeros(r2, GNN_D, device=dev)
                                   .index_add_(0, rli, rlv), reps=10)},
        ]
        rec["modeled"] = {
            f"S2 m={m2} n={n2}": {
                "hbm_bytes_per_device": traffic.sharded_fused_hbm_bytes_per_device(m2, n2, world),
                "exchange_bytes_per_device": traffic.sharded_exchange_bytes_per_device(m2, world),
                "padded_exchange_bytes_per_device": traffic.sharded_exchange_bytes_per_device(
                    m2, world, padded_capacity=cap),
                "single_device_fused_bytes": traffic.fused_stream_bytes(m2, n2)}}
        del rli, rlv
    del li, lv, keys
    rec["profile"] = _rank_profile(lambda: dpb.shard_reduce_stream(
        s2.dst, vals["add"], out_size=n2, mesh=mesh, op="add"), mesh)
    if rank == 0:  # fused.cu's single-sweep or two-pass kernel
        require(any(n in k[0] for k in rec["profile"]["kernels"]
                    for n in ("fused_accumulate_kernel", "slab_reduce_kernel")),
                f"phase16: rank 0's profile lists no fused kernel: {rec['profile']}")
    rec["peak_bytes_s2"] = max(peak_before, torch.cuda.max_memory_allocated(dev))
    del s2, vals, want, ones, base, pr_ref, cc_ref, bfs_ref
    del outdeg, outdeg_i, indeg_i, pr, cc, b
    torch.cuda.empty_cache()

    # -- S3 (the paper's scale): rank 0 computes the single-device results
    torch.cuda.reset_peak_memory_stats(dev)
    s3 = T.gen_uniform(*SHARD_S3, seed=3, device=dev)
    n3, m3 = s3.num_nodes, s3.num_edges
    if rank == 0:
        base3 = T.build_csr_baseline(s3)
        pr3_ref = T.pagerank_fused(s3, iters=ITERS).ranks
    dpb.barrier(mesh)
    K.reset_launch_counts()
    csr3 = _rank_timed(rec, "S3 build_csr_sharded", lambda: T.build_csr_sharded(s3, mesh), mesh)
    pr3 = _rank_timed(rec, f"S3 pagerank_sharded {ITERS} iterations",
                      lambda: T.pagerank_sharded(s3, mesh, iters=ITERS), mesh)
    rec["counts"].append(K.launch_counts())
    rec["shapes"].append(K.launch_shapes())
    require(rec["counts"][1]["cobra_bin_accumulate"] > 0,
            f"phase16 rank {rank}: the fused kernel never launched at S3: {rec['counts'][1]}")
    if rank == 0:
        check("S3 build_csr_sharded == build_csr_baseline",
              torch.equal(csr3.offsets, base3.offsets) and torch.equal(csr3.neighs, base3.neighs))
        ok, errs = pr_close(pr3.ranks, pr3_ref)
        check("S3 pagerank_sharded vs arm E (pagerank_fused)", ok, errs)
        rec["modeled"][f"S3 m={m3} n={n3}"] = {
            "hbm_bytes_per_device": traffic.sharded_fused_hbm_bytes_per_device(m3, n3, world),
            "exchange_bytes_per_device": traffic.sharded_exchange_bytes_per_device(m3, world),
            "single_device_fused_bytes": traffic.fused_stream_bytes(m3, n3)}
    rec["peak_bytes_s3"] = torch.cuda.max_memory_allocated(dev)
    rec["rank_seconds"] = time.perf_counter() - t_rank
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def sharded_phase(smi):
    """Phase 16: the sharded path on ``SHARD_RANKS`` ranks of one gloo group,
    every rank on ``cuda:0`` (``sharded_rank``). Prints rank 0's seconds,
    info dicts, decisions, the modeled bytes, its profile and every
    rank's peak memory; returns the launches summed over the ranks (counts,
    shapes) and the kernels line's rows at the ranks' local shapes."""
    import tempfile

    import torch

    from repro_torch.launch.ranks import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        try:
            spawn_ranks(sharded_rank, SHARD_RANKS, store_dir=td, timeout=SHARD_TIMEOUT,
                        args=(td, "cuda:0"))
        except Exception as e:  # a rank failed or hung: the run fails
            fail(f"phase16: {type(e).__name__}: {e}")
        wall = time.perf_counter() - t
        recs = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(td, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    r0 = recs[0]
    label = f"{SHARD_RANKS} ranks on one card, gloo through host memory"
    say("phase16 seconds of each call, rank 0 after a barrier "
        f"({label}; not an interconnect's time)", json.dumps(r0["seconds"]))
    say("phase16 info (capacity, K, packed, fallback)", json.dumps(r0["info"]))
    say("phase16 decided", json.dumps(r0["decided"]))
    say("phase16 checks (rank 0)", json.dumps(r0["checks"]))
    say("phase16 planted faults in float32 add results, rank 0 (add_ratio, each above 1)",
        json.dumps(r0["faults"]))
    say("phase16 modeled bytes per device (traffic.sharded_*)", json.dumps(r0["modeled"]))
    say("phase16 profile of rank 0's S2 shard_reduce_stream (add, float32)",
        json.dumps(dict(r0["profile"], card=smi)))
    say("phase16 ranks", json.dumps({
        "ranks": SHARD_RANKS, "spawn_to_join_s": wall, "parent_bytes_held": held,
        "rank_seconds": [r["rank_seconds"] for r in recs],
        "rows_bytes": [r["rows_bytes"] for r in recs],
        "peak_bytes_s2": [r["peak_bytes_s2"] for r in recs],
        "peak_bytes_s3": [r["peak_bytes_s3"] for r in recs],
        "cc_iters": r0["cc_iters"], "bfs_levels": r0["bfs_levels"],
        "preprocess_stages_s": r0["preprocess_stages_s"], "card": smi}))
    counts, shapes = {}, {}
    for r in recs:
        for c, s in zip(r["counts"], r["shapes"]):
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
            for k, by in s.items():
                for shp, v in by.items():
                    shapes.setdefault(k, {})[shp] = shapes.get(k, {}).get(shp, 0) + v
    say("phase16 launches (summed over the ranks):", json.dumps(counts))
    rows = r0["kernel_rows"]
    for row in rows:
        row["launches"] = counts[row["name"].split(":")[0]]
    return counts, shapes, rows


# -- the dense and MoE LMs over a (data, model) mesh of ranks (phase 20) -----------------


def _mesh_fingerprint(state, specs=None, mesh=None):
    """{path: [sum of the bit patterns, sum of their squares]} of every
    tensor of a ``TrainState``, over its unique blocks (a rank adds its
    block when it sits at coordinate 0 of every axis the leaf is not
    sharded on), as int64 sums that wrap the same way in any order: equal
    on two meshes when the two hold the same values (one device's whole
    tensors without a ``mesh``)."""
    import torch

    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.distributed import sharding as shd

    out = {}
    for path, v in _flatten_with_paths(state):
        if not isinstance(v, torch.Tensor):
            continue
        sharded = shd.spec_axes((specs or {}).get(path) or ())
        mine = mesh is None or all(mesh.coords[a] == 0 for a in mesh.axis_names
                                   if a not in sharded)
        bits = v.detach().contiguous().view({2: torch.int16, 4: torch.int32}[v.element_size()])
        b = bits.reshape(-1).to(torch.int64)
        t = torch.stack([b.sum(), (b * b).sum()]) if mine else torch.zeros(2, dtype=torch.int64,
                                                                           device=v.device)
        out[path] = (t if mesh is None else shd.all_reduce(t, mesh.axis_names, mesh)).tolist()
    return out


class _CollectiveClock:
    """Host seconds inside ``torch.distributed``'s collectives while on:
    gloo runs a CUDA tensor's collective synchronously (staging it through
    host memory), so the wall time of the call is the collective's."""

    NAMES = ("all_reduce", "all_gather", "gather", "broadcast", "batch_isend_irecv", "barrier")

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.seconds, self.calls, self.on = dist, 0.0, 0, False
        self.saved = {n: getattr(dist, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(dist, n, self._wrap(fn))

    def _wrap(self, fn):
        def timed(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t
                self.calls += 1
        return timed

    def close(self):
        for n, fn in self.saved.items():
            setattr(self.dist, n, fn)


def mesh_specs_check(rec, arch, layers, dev, D, M):
    """(a) on a D x M mesh: every leaf's block has its spec's shape and
    equals its block of the one-rank draw bit for bit; for qwen2-1.5b the
    all-gather of every leaf equals that draw."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as TM

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    mesh = shd.make_rank_mesh(D, M, device=dev)
    specs = TM.param_specs(cfg, mesh, shd.rules_for_profile(cfg.sharding_profile))
    model = TM.init_params(cfg, seed=MESH_SEED, device=dev, mesh=mesh)
    local = dict(model.named_parameters())
    bad, gathered = [], 0
    for name, full in TM.init_leaves(cfg, MESH_SEED, dev):
        blk = local[name].detach()
        if (tuple(blk.shape) != shd.shard_shape(full.shape, specs[name], mesh)
                or not torch.equal(blk, shd.shard_of(full, specs[name], mesh))):
            bad.append(name)
        if arch == LM_ARCH:
            if not torch.equal(shd.gather(blk, specs[name], mesh), full):
                bad.append(f"{name} (gathered)")
            gathered += 1
        del full
    rec["checks"][f"(a) {arch} {D}x{M}: {len(local)} leaves, {gathered} gathered"] = not bad
    require(not bad, f"phase20 (a) {arch} {D}x{M}: leaves whose blocks differ: {bad[:8]}")
    del model, local
    torch.cuda.empty_cache()


def mesh_f32_parity(rec, dev):
    """(b) one float32 AdamW step of qwen2-1.5b at MESH_F32's depth and
    shape on 2x2 and on 1x4 (its 2 KV heads do not split 4 ways: the
    gathered fallback), against the single-device step of the same weights
    on the card, which every rank takes and holds its blocks to. Loss rtol
    1e-5; AdamW's moments within 1e-5 of their leaf's max (the key bias's
    of ``wk``'s: its gradient is rounding noise); each parameter's update
    within MESH_UPDATE_RTOL of the one-device update in norm (the key
    bias's update, rounding noise in lr's size, within 1.01 lr). The worst
    of each over the ranks (the norms over every rank's block)."""
    import torch

    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as TM
    from repro_torch.train.optimizer import OptConfig, init_opt_state, lr_schedule
    from repro_torch.train.steps import TrainState, make_train_step, state_specs

    L_, B, S = MESH_F32
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=L_, param_dtype="float32",
                              compute_dtype="float32")
    oc = OptConfig(kind="adamw", warmup_steps=1, total_steps=10)
    lr = float(lr_schedule(oc, 1))
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    model = TM.init_params(cfg, seed=MESH_SEED, device=dev)
    st = TrainState(model, init_opt_state(dict(model.named_parameters()), oc))
    st, m = make_train_step(cfg, oc)(st, batch)
    want = {p: v.detach() for p, v in _flatten_with_paths(st) if isinstance(v, torch.Tensor)}
    want_loss = float(m["loss"])
    del model, st
    out = {}
    for D, M in ((2, 2), (1, 4)):
        mesh = shd.make_rank_mesh(D, M, device=dev)
        model = TM.init_params(cfg, seed=MESH_SEED, device=dev, mesh=mesh)
        init = {f"params/{n}": p.detach().clone() for n, p in model.named_parameters()}
        st = TrainState(model, init_opt_state(dict(model.named_parameters()), oc))
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, m = make_train_step(cfg, oc, mesh=mesh)(st, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        specs, _ = state_specs(st, cfg, mesh)
        names = [p for p, _ in _flatten_with_paths(st) if p in specs]
        errs, sq = [], []  # (max |error|, scale) a leaf; (|du - dw|^2, |dw|^2) an update
        for p, v in _flatten_with_paths(st):
            if p not in specs:
                continue
            w = shd.shard_of(want[p], specs[p], mesh)
            if p in init:
                du, dw = v.detach() - init[p], w - init[p]
                errs += [float(du.abs().max()), lr]
                sq += [float((du - dw).double().square().sum()), float(dw.double().square().sum())]
                continue
            scale = want[p.replace("attn.bk", "attn.wk")]
            errs += [float((v.detach() - w).abs().max()), float(scale.abs().max()) or 1.0]
            sq += [0.0, 0.0]
        # the worst error of each leaf over the ranks (its scale is the same on every
        # rank), and the update's squared norms summed over them (a replicated block
        # counts once a holder in both, so their ratio is the whole leaf's)
        worst = shd.all_reduce(torch.tensor(errs, dtype=torch.float64), mesh.axis_names, mesh,
                               op="max").tolist()
        sums = shd.all_reduce(torch.tensor(sq, dtype=torch.float64), mesh.axis_names,
                              mesh).tolist()
        err = {p: (worst[2 * i], worst[2 * i + 1]) for i, p in enumerate(names)}
        upd = {p: (sums[2 * i] / max(sums[2 * i + 1], 1e-300)) ** 0.5
               for i, p in enumerate(names) if p in init and not p.endswith("attn.bk")}
        loss_rel = abs(float(m["loss"]) - want_loss) / abs(want_loss)
        r = {"loss": float(m["loss"]), "single_loss": want_loss, "loss_rel": loss_rel,
             "worst_moment_share": max(e / sc for p, (e, sc) in err.items()
                                       if p.startswith("opt/")),
             "worst_update_rel": max(upd.values()), "worst_update_leaf": max(upd, key=upd.get),
             "update_rtol": MESH_UPDATE_RTOL,
             "key_bias_update_share_of_lr": max(e / sc for p, (e, sc) in err.items()
                                               if p.endswith("attn.bk")),
             "step_seconds": step_s}
        out[f"{D}x{M}"] = r
        require(loss_rel <= 1e-5 and r["worst_moment_share"] <= 1e-5
                and r["worst_update_rel"] <= MESH_UPDATE_RTOL
                and r["key_bias_update_share_of_lr"] <= 1.01,
                f"phase20 (b) {D}x{M} float32 step differs from one device: {r}")
        del model, st
        torch.cuda.empty_cache()
    rec["f32_parity"] = out
    del want
    torch.cuda.empty_cache()


def mesh_moe_checks(rec, dev):
    """(c) qwen3-moe's layer at full width, bf16, on 2x2: the expert-sharded
    ``moe_apply`` on MESH_MOE_T tokens against the one-device layer on each
    data rank's rows (the same capacity from the same local T, so the same
    assignments drop: counted); the weight-stationary decode on 4 tokens
    against ``_moe_dense_oracle``; ``moe_combine_sharded`` over the data
    axis on MESH_COMBINE_M assignments against ``index_add_`` in float64.
    Limits: phase 15's |diff| <= MOE_BF16_TOL * S (S the same weighted sum
    of |terms|), times 2 for the expert-sharded layer (each model rank's
    partial sum and the psum round once more to bfloat16) and times 4 for
    the weight-stationary one (its w1 / w3 products round per data rank
    before their sum), each also rejecting every planted fault that drops
    one assignment; the combine within one bfloat16 rounding of the sum."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import set_param

    cfg = dataclasses.replace(get_config(MOE_ARCH), moe_dispatch_method="counting")
    mesh = shd.make_rank_mesh(2, 2, device=dev)
    shapes = L._moe_shapes(cfg)
    layer, whole = L.MoE(cfg, "meta"), {}
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 2)
    from repro_torch.models.params import winit_

    for n in ("wr", "w1", "w3", "w2"):  # drawn whole on every rank, the same
        t = torch.empty(shapes[n], dtype=torch.float32 if n == "wr" else cfg.pdtype, device=dev)
        winit_(t, gen, cfg.d_ff ** -0.5 if n == "w2" else None)
        spec = shd.spec_for(mesh, shapes[n], L.MOE_NAMES[n], shd.rules_for_profile("tp_fsdp"))
        set_param(layer, n, shd.shard_of(t, spec, mesh).clone())
        whole[n] = t
    out = {}

    def terms_of(x2d):
        """(|terms|, signed rows, dispatch) of the one-device layer: each
        kept assignment's |gate| times |h| @ |w2| and its weighted expert
        row, (T, k, d) float32 (zero where dropped)."""
        E = cfg.num_experts
        d = L.moe_dispatch(x2d, whole["wr"], cfg, 0, E)
        xb = d.xbuf.view(E, d.capacity, -1)
        h = F.silu(torch.bmm(xb, whole["w1"])) * torch.bmm(xb, whole["w3"])
        y_abs = torch.bmm(h.abs().float(), whole["w2"].abs().float()).reshape(E * d.capacity, -1)
        y = torch.bmm(h, whole["w2"]).float().reshape(E * d.capacity, -1)
        gw = d.gate_w.reshape(-1, 1)
        shape = (x2d.shape[0], cfg.top_k, -1)
        return ((L._kept_rows(y_abs, d.slot_of_assign) * gw.abs()).reshape(shape),
                (L._kept_rows(y, d.slot_of_assign) * gw).reshape(shape), d)

    # the expert-sharded layer on this data rank's rows
    B, S = MESH_MOE_T
    x = (torch.randn(B, S, cfg.d_model, generator=gen, device=dev) * 0.5).to(cfg.cdtype)
    mine = shd.shard_of(x, ("data",), mesh)
    with shd.use_mesh(mesh), torch.no_grad():
        got = L.moe_apply(layer, mine, cfg)
    x2d = mine.reshape(-1, cfg.d_model)
    with torch.no_grad():
        want = L._moe_expert_shard(x2d, whole["wr"], whole["w1"], whole["w3"], whole["w2"], cfg,
                                   0, cfg.num_experts)
        terms, rows, d = terms_of(x2d)
    limit = 2 * MOE_BF16_TOL * terms.sum(1)
    delta = got.reshape(x2d.shape).float() - want.float()
    diff = delta.abs()
    dropped = int((d.slot_of_assign < 0).sum())
    fault = ((delta[:, None] - rows).abs() / limit[:, None]).amax(-1)  # a kept row taken out
    kept = (d.slot_of_assign >= 0).reshape(-1, cfg.top_k)
    out["expert_sharded"] = {
        "tokens_per_data_rank": x2d.shape[0], "capacity": d.capacity, "dropped": dropped,
        "max_abs_err": float(diff.max()), "tolerance_share": float((diff / limit).max()),
        "planted_fault_min_share": float(fault[kept].min())}
    require(bool((diff <= limit).all()) and float(fault[kept].min()) > 1,
            f"phase20 (c) expert-sharded MoE differs from one device: {out['expert_sharded']}")
    del terms, rows, d, want, got

    # the weight-stationary decode against the dense oracle
    ws = dataclasses.replace(cfg, moe_weight_stationary_decode=True)
    xd = (torch.randn(MESH_WS_T, 1, cfg.d_model, generator=gen, device=dev) * 0.5).to(cfg.cdtype)
    with shd.use_mesh(mesh), torch.no_grad():
        got = L.moe_apply(layer, shd.shard_of(xd, ("data",), mesh), ws)
        got = shd.all_gather(got, 0, "data", mesh).reshape(MESH_WS_T, -1)
    x2d = xd.reshape(MESH_WS_T, -1)
    with torch.no_grad():
        want = L._moe_dense_oracle(x2d, whole["wr"], whole["w1"], whole["w3"], whole["w2"], cfg)
        terms, rows, d = terms_of(x2d)
    limit = 4 * MOE_BF16_TOL * terms.sum(1)
    delta = got.float() - want.float()
    diff = delta.abs()
    fault = ((delta[:, None] - rows).abs() / limit[:, None]).amax(-1)
    out["weight_stationary"] = {
        "tokens": MESH_WS_T, "capacity": d.capacity, "dropped": int((d.slot_of_assign < 0).sum()),
        "max_abs_err": float(diff.max()), "tolerance_share": float((diff / limit).max()),
        "planted_fault_min_share": float(fault.min())}
    require(bool((diff <= limit).all()) and float(fault.min()) > 1,
            f"phase20 (c) weight-stationary MoE differs from the oracle: {out['weight_stationary']}")
    del terms, rows, d, want, got

    # moe_combine_sharded over the data axis
    T_ = MESH_COMBINE_M // cfg.top_k
    tok = torch.arange(T_, dtype=torch.int32, device=dev).repeat_interleave(cfg.top_k)
    rows = torch.randn(MESH_COMBINE_M, cfg.d_model, generator=gen, device=dev).to(cfg.cdtype)
    gw = torch.rand(MESH_COMBINE_M, generator=gen, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = L.moe_combine_sharded(tok, rows, gw, T_, mesh, "data")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    wrows = (rows * gw[:, None].to(rows.dtype)).double()
    want = torch.zeros(T_, cfg.d_model, dtype=torch.float64, device=dev).index_add_(0, tok.long(),
                                                                                    wrows)
    scale = torch.zeros_like(want).index_add_(0, tok.long(), wrows.abs())
    ok = bool(((got.double() - want).abs() <= 2.0**-8 * want.abs() + _add_limit(scale)).all())
    out["combine_sharded"] = {"assignments": MESH_COMBINE_M, "tokens": T_,
                              "max_abs_err": float((got.double() - want).abs().max()),
                              "seconds": sec}
    require(ok, f"phase20 (c) moe_combine_sharded differs from index_add_: {out['combine_sharded']}")
    rec["moe"] = out
    del layer, whole, rows, wrows, want, scale, got
    torch.cuda.empty_cache()


def mesh_launcher_run(rec, dev, K, arch, ckpt_dir=None):
    """(d) ``launch/train.py --mesh host:2x2`` inside this group of four
    ranks at MESH_TRAIN's shape, bf16, remat, the optimizer
    ``default_opt_config`` picks for the full model, MESH_TRAIN_LAYERS'
    depth (qwen3-moe with counting dispatch), set on the config the
    launcher reads, with the launch counts set to 0 before and read
    after, and the host seconds inside ``torch.distributed``'s calls.
    With ``ckpt_dir`` (qwen2-1.5b): MESH_STEPS + 1 steps, a checkpoint
    after MESH_STEPS (each rank writes its blocks on a thread during the
    next step) whose fingerprint (``_mesh_fingerprint``) is taken as it is
    saved, and no save after the last; without (qwen3-moe): MESH_MOE_STEPS
    steps. A rank's launches, exact: a step runs flash
    once per layer per forward pass (the pass and remat's recomputation),
    the rows kernel once for the embedding backward and, per MoE layer,
    the dispatch (row scatter, counting's histogram and positions) and the
    combine (rows kernel) in both passes, and the backward's rows reduce
    and row scatter. Returns (the run, its config, the last step's
    gradients, the fingerprint or None)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as TM
    from repro_torch.train import steps as steps_mod

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=MESH_TRAIN_LAYERS[arch])
    if full.family == "moe":
        cfg = dataclasses.replace(cfg, moe_dispatch_method="counting")
    B, S = MESH_TRAIN[arch]
    steps = MESH_STEPS + 1 if ckpt_dir else MESH_MOE_STEPS
    saved = train_mod.get_config, train_mod.default_opt_config, steps_mod.apply_updates
    grads, fingerprint, save_seconds = {}, {}, []

    def keep_grads(params, g, *a, **kw):  # the last step's gradients, for (e)
        grads.clear()
        grads.update(g)
        return saved[2](params, g, *a, **kw)

    save = train_mod.CheckpointManager.save

    def fingerprinted_save(self, step, tree, *a, **kw):
        fingerprint.update(_mesh_fingerprint(tree, kw["specs"], kw["mesh"]))
        t = time.perf_counter()
        try:
            return save(self, step, tree, *a, **kw)
        finally:
            save_seconds.append(time.perf_counter() - t)

    train_mod.get_config = lambda name: cfg
    train_mod.default_opt_config = lambda c, total_steps=10_000: steps_mod.default_opt_config(
        full, total_steps)
    steps_mod.apply_updates = keep_grads
    train_mod.CheckpointManager.save = fingerprinted_save
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    clock = _CollectiveClock()
    argv = ["--arch", arch, "--preset", "full", "--seq-len", str(S), "--batch", str(B),
            "--steps", str(steps), "--log-every", "1", "--mesh", "host:2x2",
            "--device", str(dev)]
    if ckpt_dir:
        argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", str(MESH_STEPS), "--no-ckpt-final"]
    t0 = time.perf_counter()
    try:
        K.reset_launch_counts()  # this model's mesh training path starts here
        clock.on = True
        run = train_mod.train(train_mod.parse_args(argv))
        torch.cuda.synchronize()
        clock.on = False
        counts, shapes = K.launch_counts(), K.launch_shapes()  # and ends here
    finally:
        clock.close()
        train_mod.get_config, train_mod.default_opt_config, steps_mod.apply_updates = saved
        train_mod.CheckpointManager.save = save
    seconds = time.perf_counter() - t0
    require(len(run.losses) == steps
            and all(math.isfinite(x) for x in run.losses + run.grad_norms),
            f"phase20 {arch}: training diverged: {run.losses} {run.grad_norms}")
    L_moe = cfg.num_layers if cfg.family == "moe" else 0
    passes = 2 if cfg.remat else 1
    want = {"cobra_bin_accumulate_rows": 1 + L_moe * (passes + 1),
            "scatter_rows": L_moe * (passes + 1), "histogram": L_moe * passes,
            "counting_positions": L_moe * passes,
            "flash_attention": TM.attention_layers(cfg) * passes}
    want = {k: v * steps for k, v in want.items()}
    got = {k: counts[k] for k in want}
    require(got == want, f"phase20 {arch}: {steps} steps launched {got} on a rank, "
                         f"expected {want}")
    ms = min(1e3 * x for x in run.step_seconds[1:MESH_STEPS])
    r = {"arch": arch, "layers": cfg.num_layers, "of_layers": full.num_layers,
         "local_parameters": sum(p.numel() for p in run.state.params.parameters()),
         "optimizer": "adamw" if run.state.opt.m is not None else "adafactor",
         "batch": B, "seq_len": S, "losses": run.losses, "grad_norms": run.grad_norms,
         "step_ms": [1e3 * x for x in run.step_seconds], "steady_step_ms": ms,
         "tokens_per_s": B * S / ms * 1e3, "collective_seconds": clock.seconds,
         "collective_calls": clock.calls, "run_seconds": seconds, "save_seconds": save_seconds,
         "peak_bytes_above_earlier": torch.cuda.max_memory_allocated() - mem0,
         "launches": got}
    rec["train"][arch] = r
    return run, cfg, grads, fingerprint or None


def mesh_compression_and_pipe(rec, dev, grads):
    """(e) ``compressed_psum_tree`` over the data axis of rank 0's last
    qwen2 gradients of (d) (each data group takes its data-index-0
    member's: identical gradients), twice with the residual: the largest
    error within the reference test's 0.05 and the two-step error no
    larger; then ``gpipe_apply`` over the 4 ranks as stages of
    MESH_PIPE's layers of full-width qwen2 against those layers run in
    order on rank 0 (M microbatches; bf16: within 2^-8 of max |y|)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.compression import compressed_psum_tree, init_residuals
    from repro_torch.distributed.pipeline import bubble_fraction, gpipe_apply
    from repro_torch.models import transformer as TM

    mesh = shd.make_rank_mesh(2, 2, device=dev)
    g = {}
    src = mesh.global_ranks[mesh.coords["model"]]  # this rank's data-index-0 peer
    for n, t in grads.items():
        b = t.detach().clone()
        torch.distributed.broadcast(b, src, group=mesh.group("data"))
        g[n] = b
    torch.cuda.synchronize()
    t = time.perf_counter()
    o1, r1 = compressed_psum_tree(g, init_residuals(g), mesh, axes=("data",))
    o2, _ = compressed_psum_tree(g, r1, mesh, axes=("data",))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    err1 = max(float((o1[n] - g[n].float()).abs().max()) for n in g)
    err2 = max(float(((o1[n] + o2[n]) / 2 - g[n].float()).abs().max()) for n in g)
    gmax = max(float(g[n].float().abs().max()) for n in g)
    rec["compression"] = {"leaves": len(g), "elements": sum(x.numel() for x in g.values()),
                          "err1": err1, "err2": err2, "max_abs_grad": gmax, "seconds": sec}
    require(err1 < 0.05 and err2 <= err1 + 1e-6,
            f"phase20 (e) compression: {rec['compression']}")
    del g, o1, o2, r1
    torch.cuda.empty_cache()

    stages, per, Mb, S = MESH_PIPE
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=stages * per)
    pmesh = shd.make_mesh({"pipe": stages}, device=dev)
    s = pmesh.axis_index("pipe")
    model = TM.LM(cfg, "meta")
    keep = range(stages * per) if pmesh.rank == 0 else range(s * per, (s + 1) * per)
    for name, p in TM.init_leaves(cfg, MESH_SEED + 3, dev):
        parts = name.split(".")
        if parts[0] == "blocks" and int(parts[1]) in keep:
            TM.set_param(model, name, p)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]

    def stage_fn(blocks, x):
        for blk in blocks:
            x = TM._apply_dense_layer(blk, x, cfg, pos, None, None)
        return x

    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 4)
    xs = (torch.randn(Mb, 1, S, cfg.d_model, generator=gen, device=dev)).to(cfg.cdtype)
    mine = [model.blocks[i] for i in range(s * per, (s + 1) * per)]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = gpipe_apply(stage_fn, mine, xs, pmesh)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        if pmesh.rank == 0:
            want = torch.stack([stage_fn(list(model.blocks), x) for x in xs])
            diff = float((y.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            rec["pipeline"] = {"stages": stages, "layers_per_stage": per, "microbatches": Mb,
                               "shape": [1, S, cfg.d_model], "max_abs_err": diff,
                               "max_abs_y": scale, "equal": bool(torch.equal(y, want)),
                               "bubble_fraction": bubble_fraction(Mb, stages), "seconds": sec}
            require(diff <= 2.0**-8 * scale, f"phase20 (e) GPipe differs: {rec['pipeline']}")
    del model, mine, xs, y
    torch.cuda.empty_cache()


def mesh_remesh(rec, dev, ckpt_dir, fp_saved, loss_next):
    """(f) the 2x2 qwen2 state saved after (d) restored onto the mesh of
    ``ElasticPlan(old_data=2, old_model=2, surviving_devices=2)`` (1x2 over
    ranks 0 and 1, accumulation 2): the restored values' fingerprint
    equals the saved state's (``_mesh_fingerprint``), and one more step
    there gives the 2x2 mesh's next loss within rtol 1e-3 (bf16)."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_data
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.ft.resilience import ElasticPlan
    from repro_torch.models import transformer as TM
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.optimizer import init_opt_state

    plan = ElasticPlan(old_data=2, old_model=2, surviving_devices=2)
    D, M = plan.mesh_shape()
    mesh = shd.make_rank_mesh(D, M, device=dev, ranks=range(D * M))
    if mesh is not None:
        cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=MESH_TRAIN_LAYERS[LM_ARCH])
        oc = steps_mod.default_opt_config(cfg, total_steps=MESH_STEPS + 1)  # the 2x2 run's
        model = TM.init_params(cfg, seed=0, device=dev, mesh=mesh)
        target = steps_mod.TrainState(model, init_opt_state(dict(model.named_parameters()), oc))
        specs, _ = steps_mod.state_specs(target, cfg, mesh)
        t = time.perf_counter()
        state, at = CheckpointManager(ckpt_dir).restore(target, mesh=mesh, specs=specs)
        restore_s = time.perf_counter() - t
        del target, model
        require(at == MESH_STEPS, f"phase20 (f): restored step {at}")
        fp = _mesh_fingerprint(state, specs, mesh)
        same = fp == fp_saved
        B, S = MESH_TRAIN[LM_ARCH]
        data = make_data(cfg, ShapeSpec("custom", S, B, "train"), host_index=0, host_count=1)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(MESH_STEPS).items()}
        step = steps_mod.make_train_step(cfg, oc, accum_steps=plan.accumulation_steps(1),
                                         mesh=mesh)
        t = time.perf_counter()
        _, m = step(state, batch)
        loss = float(m["loss"])
        rec["remesh"] = {"mesh": [D, M], "accum": plan.accumulation_steps(1),
                         "restored_step": at, "fingerprint_equal": same,
                         "restore_seconds": restore_s, "step_seconds": time.perf_counter() - t,
                         "loss": loss, "loss_2x2": loss_next,
                         "loss_rel": abs(loss - loss_next) / abs(loss_next)}
        require(same, "phase20 (f): the restored state's fingerprint differs from the saved one")
        require(rec["remesh"]["loss_rel"] <= 1e-3, f"phase20 (f): {rec['remesh']}")
        del state, step, batch
        torch.cuda.empty_cache()
    torch.distributed.barrier()


def mesh_rank(rank, world, outdir, device="cuda:0"):
    """One of phase 20's ranks (``repro_torch.launch.ranks.spawn_ranks``):
    (a)-(f) of ``mesh_phase`` in order, every rank on ``cuda:0``; writes
    what it measured to ``outdir/mesh<rank>.json``."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch.kernels as K
    from repro_torch.kernels import _lib

    dev = torch.device(device)
    if dev.type == "cuda":
        _lib.load()  # built by the parent: this finds the library
        torch.cuda.set_device(dev)
    t_rank = time.perf_counter()
    rec = {"rank": rank, "seconds": {}, "checks": {}, "train": {}, "counts": {}, "shapes": {}}

    def part(name, fn, *a):
        torch.distributed.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        rec["seconds"][name] = time.perf_counter() - t
        rec.setdefault("peak_bytes", {})[name] = torch.cuda.max_memory_allocated(dev)
        return out

    for D, M in ((2, 2), (1, 4)):
        part(f"(a) {LM_ARCH} {D}x{M}", mesh_specs_check, rec, LM_ARCH, 0, dev, D, M)
        part(f"(a) {MOE_ARCH} {D}x{M}", mesh_specs_check, rec, MOE_ARCH, MESH_MOE_LAYERS, dev,
             D, M)
    part("(b)", mesh_f32_parity, rec, dev)
    part("(c)", mesh_moe_checks, rec, dev)
    ckpt_dir = os.path.join(outdir, "ckpt")
    counts, shapes = {}, {}

    def add(c, sh):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        for k, by in sh.items():
            for key, v in by.items():
                shapes.setdefault(k, {})[key] = shapes.get(k, {}).get(key, 0) + v

    run, _, grads, fp_saved = part(f"(d) {LM_ARCH}", mesh_launcher_run, rec, dev, K, LM_ARCH,
                                   ckpt_dir)
    add(K.launch_counts(), K.launch_shapes())
    loss_next = run.losses[MESH_STEPS]  # the 2x2 mesh's step after the checkpoint
    del run
    torch.cuda.empty_cache()
    part("(e)", mesh_compression_and_pipe, rec, dev, grads)
    del grads
    torch.cuda.empty_cache()
    part("(f)", mesh_remesh, rec, dev, ckpt_dir, fp_saved, loss_next)
    moe_run, _, moe_grads, _ = part(f"(d) {MOE_ARCH}", mesh_launcher_run, rec, dev, K, MOE_ARCH)
    add(K.launch_counts(), K.launch_shapes())
    del moe_run, moe_grads
    torch.cuda.empty_cache()
    rec["counts"], rec["shapes"] = counts, shapes
    rec["rank_seconds"] = time.perf_counter() - t_rank
    with open(os.path.join(outdir, f"mesh{rank}.json"), "w") as f:
        json.dump(rec, f)


def mesh_phase(dev, K, smi):
    """Phase 20: the dense and MoE LMs over a (data, model) mesh of
    MESH_RANKS gloo ranks, every one on ``cuda:0`` (``mesh_rank``): an
    emulation with no interconnect (gloo stages every collective through
    host memory), so its times say nothing about scaling. Prints the
    checks, rank 0's training records, each rank's peaks and seconds, and
    returns the launches of (d) summed over the ranks (counts, shapes) and
    the kernels line's rows 8f and 5g at a rank's shapes."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.ranks import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as td:
        t = time.perf_counter()
        try:
            spawn_ranks(mesh_rank, MESH_RANKS, store_dir=td, timeout=MESH_TIMEOUT,
                        args=(td, "cuda:0"))
        except Exception as e:  # a rank failed or hung: the run fails
            fail(f"phase20: {type(e).__name__}: {e}")
        wall = time.perf_counter() - t
        recs = []
        for r in range(MESH_RANKS):
            with open(os.path.join(td, f"mesh{r}.json")) as f:
                recs.append(json.load(f))
    r0 = recs[0]
    label = (f"{MESH_RANKS} ranks on one card, gloo through host memory: an emulation, "
             "no interconnect's time and nothing about scaling")
    say("phase20 checks (rank 0)", json.dumps(r0["checks"]))
    say("phase20 (b) float32 step, mesh vs one device", json.dumps(dict(r0["f32_parity"],
                                                                        card=smi)))
    say("phase20 (c) MoE at full width", json.dumps(r0["moe"]))
    for arch, tr in r0["train"].items():
        losses = [r["train"][arch]["losses"] for r in recs]
        require(all(x == losses[0] for x in losses), f"phase20 {arch}: ranks' losses differ")
        say(f"phase20 (d) {arch} ({label})", json.dumps(dict(tr, card=smi)))
    say("phase20 (e) compression", json.dumps(r0["compression"]))
    say("phase20 (e) pipeline", json.dumps(r0["pipeline"]))
    say("phase20 (f) re-mesh", json.dumps(r0["remesh"]))
    say("phase20 ranks", json.dumps({
        "ranks": MESH_RANKS, "spawn_to_join_s": wall, "parent_bytes_held": held,
        "seconds": r0["seconds"], "rank_seconds": [r["rank_seconds"] for r in recs],
        "peak_bytes": [r["peak_bytes"] for r in recs], "card": smi}))
    counts, shapes = {}, {}
    for r in recs:
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
        for k, by in r["shapes"].items():
            for key, v in by.items():
                shapes.setdefault(k, {})[key] = shapes.get(k, {}).get(key, 0) + v
    say("phase20 launches of (d) (summed over the ranks):", json.dumps(counts))
    # rows 8f and 5g at a rank's shapes of (d)'s qwen2 run
    cfg = get_config(LM_ARCH)
    B, S = MESH_TRAIN[LM_ARCH]
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 5)
    tp_cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // 2,
                                 num_kv_heads=cfg.num_kv_heads // 2)
    with torch.inference_mode():
        r8 = flash_row("flash_attention:mesh_local_heads", tp_cfg, dev, gen, S,
                       counts["flash_attention"], 0.0, B=B // 2)
    emb = embedding_backward_check(dev, K, cfg, B=B // 2, S=S, vocab_block=(0, 2))
    r5 = {"name": "cobra_bin_accumulate_rows:mesh_vocab_parallel_embedding_backward",
          "route": "cuda", "source": "src/repro_torch/kernels/csrc/fused_rows.cu",
          "replaces": "src/repro/kernels/fused.py:263",
          "launches": counts["cobra_bin_accumulate_rows"], "checked_against_plain": True,
          "shape": {k: emb[k] for k in ("m", "m_kept", "F", "n")},
          "dtype": "bfloat16 cotangent, float32 rows; ids outside the block -1",
          "max_abs_err": emb["max_abs_err"], "ms": emb["ms"],
          "kernel_device_ms": emb["profile"]["device_ms"], "plain_ms": emb["plain_ms"],
          "bound_ms": emb["bound_ms"], "bound_bytes": emb["bound_bytes"], "bound_by": "bytes",
          "library_ms": emb["library_ms"]}
    rows = [dict(r8, launches_20=counts["flash_attention"]),
            dict(r5, launches_20=counts["cobra_bin_accumulate_rows"])]
    say("phase20 rows 8f, 5g", json.dumps(rows))
    torch.cuda.empty_cache()
    return counts, shapes, rows

# -- serving over a mesh, and the four other families on a mesh (phase 21) ----------------


def _smesh_init(cfg, seed, dev, mesh):
    """``init_params(mesh=)`` on each rank of the group in turn: a rank
    draws each leaf whole before it keeps its block (qwen3-moe's experts of
    a layer: 3.2 GB in float32), and four ranks share one card, so the
    draws do not overlap; each rank then empties its cache."""
    import torch

    from repro_torch.models import transformer as TM

    params = None
    for r in range(torch.distributed.get_world_size()):
        if r == torch.distributed.get_rank():
            params = TM.init_params(cfg, seed=seed, device=dev, mesh=mesh)
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    return params


def _crossing_prompts(cfg, n, lo, max_len, seed):
    """``n`` prompts (``lm_prompts``) of lengths in [lo, max_len / 2), the
    last of max_len / 2 - 1 tokens: the engine's shared decode index
    starts there, so the first tick writes the last row of the 2x2 cache's
    first ``seq_kv`` block and the next one the first row of the second."""
    import numpy as np

    half = max_len // 2
    prompts = lm_prompts(cfg, n - 1, lo, half - 1, seed)
    rng = np.random.default_rng(seed + 1)
    return prompts + [rng.integers(0, cfg.vocab_size, half - 1).astype(np.int32)]


def _logged(eng, log, times=None):
    """Wrap ``eng``'s prefill and decode steps: each call appends (kind,
    its float32 logits on the host, the slots' (rid, tokens so far) at a
    tick) to ``log`` and, with ``times``, its synchronised host seconds.
    The wrappers hold the engine's slot list, not the engine: a cycle
    through the engine would keep its weights and caches on the card
    until the next garbage collection."""
    import torch

    active = eng.active  # filled and emptied in place

    def wrap(kind, fn):
        def run(*a):
            if times is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = fn(*a)
            if times is not None:
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
            slots = None if kind == "prefill" else [
                None if r is None else (r.rid, len(r.out)) for r in active]
            log.append((kind, out[0].float().cpu(), slots))
            return out
        return run

    eng._prefill = wrap("prefill", eng._prefill)
    eng._decode = wrap("decode", eng._decode)


def _smesh_engine(cfg, params, prompts, max_new, max_len, mesh=None):
    """Serve ``prompts`` through an ``Engine`` (over ``mesh`` when given)
    whose steps are wrapped by ``_logged``; returns (its log, its finished
    requests by rid, {"prefill": [s], "decode": [s]} host seconds of each
    call, synchronised, its final decode index)."""
    from repro_torch.serving.server import Engine, Request

    eng = Engine(cfg, params, slots=SMESH_SLOTS, max_len=max_len, mesh=mesh)
    times, log = {"prefill": [], "decode": []}, []
    _logged(eng, log, times)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=max_new))
    done = {r.rid: r for r in eng.run_until_drained()}
    require(len(done) == len(prompts), f"phase21: {len(done)} of {len(prompts)} requests finished")
    return log, done, times, eng.state.index


def _logit_shares(got, want, done, done1):
    """max |got - want| / max |want| of each pair of logged calls, in order:
    a prefill whole, a tick on the slots whose request's tokens so far are
    the same in both runs (``done``, ``done1``: the finished requests);
    None for a tick with no such slot. The two logs must hold the same
    calls on the same slots."""
    out = []
    for (kind, g, slots), (kind1, w, slots1) in zip(got, want):
        require(kind == kind1 and slots == slots1,
                f"phase21: the mesh engine's calls differ from one device's: {kind} {slots}, "
                f"{kind1} {slots1}")
        rows = list(range(g.shape[0])) if kind == "prefill" else [
            s for s, x in enumerate(slots)
            if x is not None and done[x[0]].out[:x[1]] == done1[x[0]].out[:x[1]]]
        out.append(float((g[rows] - w[rows]).abs().max() / w[rows].abs().max()) if rows else None)
    return out


def _smesh_compare(rec_key, rec, cfg, make_one, prompts, max_new, max_len, log, done, tol,
                   tokens_equal):
    """Rank 0 serves ``prompts`` on one device (``make_one()``'s model) and
    holds the mesh engine (its ``_logged`` log, its finished requests
    ``done``) to it: every prefill's logits, and every tick's on the slots
    whose request's tokens so far agree, within ``tol`` of max |logit|,
    and with ``tokens_equal`` (float32) every token equal; else (bfloat16)
    the tokens' agreement is reported (a bfloat16 near tie may pick
    another). The other ranks wait at a barrier."""
    import torch

    if torch.distributed.get_rank() == 0:
        one = make_one()
        log1, done1, _, _ = _smesh_engine(cfg, one, prompts, max_new, max_len)
        shares = _logit_shares(log, log1, done, done1)
        held = [x for x in shares if x is not None]
        same = [done[r].out == done1[r].out for r in sorted(done1)]
        ticks = [x for (k, _, _), x in zip(log, shares) if k == "decode"]
        r = {"logged": len(shares), "compared": len(held), "max_logit_share": max(held),
             "prefill_shares": [x for (k, _, _), x in zip(log, shares) if k == "prefill"],
             "tick_shares": ticks, "tolerance": tol, "requests_with_equal_tokens": sum(same),
             "requests": len(same)}
        rec.setdefault("compare", {})[rec_key] = r
        ok = len(log) == len(log1) and max(held) <= tol and (all(same) or not tokens_equal)
        require(ok, f"phase21 {rec_key}: the mesh engine differs from one device: {r}")
        del one
        torch.cuda.empty_cache()
    torch.distributed.barrier()


def _smesh_record(final_index, done, times, seconds):
    """Serving metrics of one engine run on this rank."""
    tokens = sum(len(r.out) for r in done.values())
    dec = times["decode"]
    return {"requests": len(done), "tokens": tokens, "seconds": seconds,
            "tokens_per_s": tokens / seconds,
            "ttft_s": [done[r].t_first - done[r].t_submit for r in sorted(done)],
            "prefill_ms": [1e3 * t for t in times["prefill"]],
            "decode_ticks": len(dec),
            "decode_ms_per_tick": [1e3 * min(dec), 1e3 * sum(dec) / len(dec)] if dec else None,
            "final_index": final_index}


def smesh_f32_parity(rec, dev, K):
    """(a) qwen2-1.5b at full width with SMESH_F32's depth, float32, served
    on 2x2 and on 1x4 (its 2 KV heads do not split 4 ways: gathered) by the
    mesh engine against the one-device engine of the same weights (drawn
    from SMESH_SEED on every rank, whole leaves, the rank keeping its
    blocks): tokens equal and every prefill's and tick's logits within
    LM_TOL of max |logit|, the decodes crossing the 2x2 cache's block
    boundary (``_crossing_prompts``; on 1x4 too, whose blocks are half as
    long). Launches counted over the mesh engines' runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as TM

    layers, n, new, max_len, lo = SMESH_F32
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=layers, param_dtype="float32",
                              compute_dtype="float32")
    prompts = _crossing_prompts(cfg, n, lo, max_len, SMESH_SEED)
    out = {}
    for D, M in ((2, 2), (1, 4)):
        mesh = shd.make_rank_mesh(D, M, device=dev)
        params = _smesh_init(cfg, SMESH_SEED, dev, mesh)
        torch.distributed.barrier()
        K.reset_launch_counts()  # this mesh's serving path starts here
        t = time.perf_counter()
        log, done, times, index = _smesh_engine(cfg, params, prompts, new, max_len, mesh)
        secs = time.perf_counter() - t
        rec["launch"][f"(a) {D}x{M}"] = K.launch_counts()  # and ends here
        rec["launch_shapes"][f"(a) {D}x{M}"] = K.launch_shapes()
        out[f"{D}x{M}"] = _smesh_record(index, done, times, secs)
        require(rec["launch"][f"(a) {D}x{M}"]["flash_attention"] == layers * n,
                f"phase21 (a): flash {rec['launch'][f'(a) {D}x{M}']} for {n} prefills")
        require(index > max_len // 2, f"phase21 (a): the decodes stop at {index}, before the "
                                      f"block boundary at {max_len // 2}")
        del params
        torch.cuda.empty_cache()
        _smesh_compare(f"(a) {D}x{M}", rec, cfg,
                       lambda: TM.init_params(cfg, seed=SMESH_SEED, device=dev), prompts, new,
                       max_len, log, done, LM_TOL, True)
    rec["f32"] = out


def smesh_launcher(rec, dev, K):
    """(b) ``launch/serve.py --mesh host:2x2`` inside this group: qwen2-1.5b
    whole, bfloat16, SMESH_SLOTS slots, SMESH_BF16's requests, prompt
    lengths and new tokens (the launcher checks that every rank's tokens
    agree); its engine is wrapped to time each call and keep the logits
    (``_logged``), and rank 0 holds every prefill's logits and every
    tick's on the slots whose tokens so far agree to the one-device
    engine's on the same weights and prompts (seed 0, the launcher's
    draw) within SMESH_BF16_TOL of max |logit|. Host seconds
    inside ``torch.distributed`` on each rank (``_CollectiveClock``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer as TM

    max_len, n, lo, new = SMESH_BF16
    held = []
    base = serve_mod.Engine

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.times, self.log, self.finished = {"prefill": [], "decode": []}, [], {}
            _logged(self, self.log, self.times)
            held.append(self)

        def run_until_drained(self, max_ticks=10_000):
            done = super().run_until_drained(max_ticks)
            self.finished = {r.rid: r for r in done}
            return done

    argv = ["--arch", LM_ARCH, "--preset", "full", "--slots", str(SMESH_SLOTS), "--max-len",
            str(max_len), "--requests", str(n), "--min-prompt", str(lo), "--max-new", str(new),
            "--mesh", "host:2x2", "--device", str(dev)]
    serve_mod.Engine = Recorded
    clock = _CollectiveClock()
    try:
        torch.distributed.barrier()
        K.reset_launch_counts()  # the launcher's serving path starts here
        clock.on = True
        t = time.perf_counter()
        count = serve_mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        clock.on = False
        rec["launch"]["(b)"] = K.launch_counts()  # and ends here
        rec["launch_shapes"]["(b)"] = K.launch_shapes()
    finally:
        clock.close()
        serve_mod.Engine = base
    eng = held[0]
    require(count == n and all(len(r.out) == new for r in eng.finished.values()),
            f"phase21 (b): {count} of {n} requests")
    r = _smesh_record(eng.state.index, eng.finished, eng.times, secs)
    r.update(collective_seconds=clock.seconds, collective_calls=clock.calls,
             prompt_lens=[len(x.prompt) for x in eng.finished.values()])
    layers = get_config(LM_ARCH).num_layers
    require(rec["launch"]["(b)"]["flash_attention"] == layers * n,
            f"phase21 (b): flash {rec['launch']['(b)']}, expected {layers} x {n} prefills")
    rec["bf16"] = r
    cfg = get_config(LM_ARCH)
    rng = np.random.default_rng(0)  # the launcher's draw
    prompts = []
    for _ in range(n):
        plen = int(rng.integers(lo, max_len // 4))
        prompts.append(rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32))
    require([len(p) for p in prompts] == [len(eng.finished[i].prompt) for i in range(n)],
            "phase21 (b): the launcher's prompts")
    log, done = eng.log, eng.finished
    del held, eng
    torch.cuda.empty_cache()
    _smesh_compare("(b)", rec, cfg, lambda: TM.init_params(cfg, seed=0, device=dev), prompts,
                   new, max_len, log, done, SMESH_BF16_TOL, False)


def smesh_moe(rec, dev, K):
    """(c) qwen3-moe at full width with SMESH_MOE's layers (counting
    dispatch), float32 (a bfloat16 near tie in the router would send a
    token to other experts), served on 1x4 (the expert-sharded layer, the
    experts over ``model``) against the one-device engine as (a), with
    exact launches; then on 2x2, where the engine's one-row prefill must
    raise the reference's batch-split error."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as TM

    layers, n, new, max_len, lo, hi = SMESH_MOE
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=layers, param_dtype="float32",
                              compute_dtype="float32", moe_dispatch_method="counting")
    prompts = lm_prompts(cfg, n, lo, hi, SMESH_SEED + 1)
    mesh = shd.make_rank_mesh(1, 4, device=dev)
    params = _smesh_init(cfg, SMESH_SEED + 1, dev, mesh)
    torch.distributed.barrier()
    K.reset_launch_counts()  # the moe serving path starts here
    t = time.perf_counter()
    log, done, times, index = _smesh_engine(cfg, params, prompts, new, max_len, mesh)
    secs = time.perf_counter() - t
    rec["launch"]["(c)"] = K.launch_counts()  # and ends here
    rec["launch_shapes"]["(c)"] = K.launch_shapes()
    r = _smesh_record(index, done, times, secs)
    calls = len(times["prefill"]) + len(times["decode"])
    want = {"flash_attention": layers * n, "scatter_rows": layers * calls,
            "cobra_bin_accumulate_rows": layers * calls, "histogram": layers * calls,
            "counting_positions": layers * calls}
    got = {k: rec["launch"]["(c)"][k] for k in want}
    require(got == want, f"phase21 (c): launches {got}, expected {want}")
    rec["moe"] = r
    del params
    torch.cuda.empty_cache()
    _smesh_compare("(c) 1x4", rec, cfg,
                   lambda: TM.init_params(cfg, seed=SMESH_SEED + 1, device=dev), prompts, new,
                   max_len, log, done, LM_TOL, True)
    one = dataclasses.replace(cfg, num_layers=1)
    mesh = shd.make_rank_mesh(2, 2, device=dev)
    params = _smesh_init(one, SMESH_SEED + 1, dev, mesh)
    try:
        _smesh_engine(one, params, prompts[:1], new, max_len, mesh)
        raised = None
    except ValueError as e:
        raised = str(e)
    r["2x2_raises"] = raised
    require(raised is not None and "does not evenly divide 1" in raised,
            f"phase21 (c): the 2x2 engine did not raise the batch-split error ({raised})")
    del params
    torch.cuda.empty_cache()


def smesh_family(rec, dev, K, arch):
    """(d) ``arch`` at full width with SMESH_FAM_LAYERS's depth:
    SMESH_FAM_STEPS steps of ``launch/train.py --mesh host:2x2`` inside the
    group at SMESH_FAM_TRAIN's shape (bf16, remat; the launcher checks that
    every rank's losses agree; its batches carry no image or frames, so the
    cross layers and Whisper's encoder are skipped, as in the reference),
    with exact launches: flash twice a self-attention layer a step, the
    rows kernel once a step (the embedding backward); then
    SMESH_FAM_SERVE's requests served over 2x2, in float32, against the
    one-device engine as (a), the decodes crossing the cache's block
    boundary as (a)'s."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as TM

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=SMESH_FAM_LAYERS.get(arch, full.num_layers))
    B, S = SMESH_FAM_TRAIN[arch]
    saved = train_mod.get_config
    train_mod.get_config = lambda name: cfg
    argv = ["--arch", arch, "--preset", "full", "--seq-len", str(S), "--batch", str(B),
            "--steps", str(SMESH_FAM_STEPS), "--log-every", "1", "--mesh", "host:2x2",
            "--device", str(dev), "--no-ckpt-final"]
    clock = _CollectiveClock()
    try:
        torch.distributed.barrier()
        K.reset_launch_counts()  # this family's mesh training path starts here
        clock.on = True
        run = train_mod.train(train_mod.parse_args(argv))
        torch.cuda.synchronize()
        clock.on = False
        counts = K.launch_counts()  # and ends here
    finally:
        clock.close()
        train_mod.get_config = saved
    require(len(run.losses) == SMESH_FAM_STEPS
            and all(math.isfinite(x) for x in run.losses + run.grad_norms),
            f"phase21 (d) {arch}: training diverged: {run.losses} {run.grad_norms}")
    nc = TM._num_cycles(cfg)
    self_attn = {"vlm": nc * (cfg.cross_attn_every - 1), "hybrid": nc, "ssm": 0,
                 "encdec": cfg.num_layers}[cfg.family]
    want = {"flash_attention": 2 * self_attn * SMESH_FAM_STEPS,
            "cobra_bin_accumulate_rows": SMESH_FAM_STEPS}
    got = {k: counts[k] for k in want}
    require(got == want, f"phase21 (d) {arch}: launches {got}, expected {want}")
    rec["launch"][f"(d) train {arch}"] = counts
    rec["launch_shapes"][f"(d) train {arch}"] = K.launch_shapes()
    r = {"layers": cfg.num_layers, "of_layers": full.num_layers, "batch": B, "seq_len": S,
         "losses": run.losses, "grad_norms": run.grad_norms,
         "step_ms": [1e3 * x for x in run.step_seconds],
         "tokens_per_s": B * S / min(run.step_seconds[1:] or run.step_seconds),
         "collective_seconds": clock.seconds, "collective_calls": clock.calls}
    rec["families"][arch] = r
    del run
    torch.cuda.empty_cache()
    n, new, max_len, lo = SMESH_FAM_SERVE
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    prompts = _crossing_prompts(cfg32, n, lo, max_len, SMESH_SEED + 2)
    mesh = shd.make_rank_mesh(2, 2, device=dev)
    params = _smesh_init(cfg32, SMESH_SEED + 2, dev, mesh)
    torch.distributed.barrier()
    K.reset_launch_counts()  # this family's mesh serving path starts here
    t = time.perf_counter()
    log, done, times, index = _smesh_engine(cfg32, params, prompts, new, max_len, mesh)
    secs = time.perf_counter() - t
    counts = K.launch_counts()  # and ends here
    rec["launch"][f"(d) serve {arch}"] = counts
    rec["launch_shapes"][f"(d) serve {arch}"] = K.launch_shapes()
    attn = TM.attention_layers(cfg32)
    require(counts["flash_attention"] == attn * n,
            f"phase21 (d) {arch}: serving flash {counts['flash_attention']}, expected {attn * n}")
    r["serve"] = _smesh_record(index, done, times, secs)
    require(index > max_len // 2, f"phase21 (d) {arch}: the decodes stop at {index}, before "
                                  f"the block boundary at {max_len // 2}")
    del params
    torch.cuda.empty_cache()
    _smesh_compare(f"(d) {arch}", rec, cfg32,
                   lambda: TM.init_params(cfg32, seed=SMESH_SEED + 2, device=dev), prompts, new,
                   max_len, log, done, LM_TOL, True)


def serve_mesh_rank(rank, world, outdir, device="cuda:0"):
    """One of phase 21's ranks (``repro_torch.launch.ranks.spawn_ranks``):
    (a)-(d) of ``serve_mesh_phase`` in order, every rank on ``cuda:0``;
    writes what it measured to ``outdir/smesh<rank>.json``."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch.kernels as K
    from repro_torch.kernels import _lib

    dev = torch.device(device)
    if dev.type == "cuda":
        _lib.load()  # built by the parent: this finds the library
        torch.cuda.set_device(dev)
    t_rank = time.perf_counter()
    rec = {"rank": rank, "seconds": {}, "launch": {}, "launch_shapes": {}, "families": {},
           "peak_bytes": {}}

    def part(name, fn, *a):
        torch.cuda.empty_cache()  # the ranks share the card: free what the last part cached
        torch.distributed.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        fn(*a)
        torch.cuda.synchronize()
        rec["seconds"][name] = time.perf_counter() - t
        rec["peak_bytes"][name] = torch.cuda.max_memory_allocated(dev)
        with open(os.path.join(outdir, f"smesh{rank}.json"), "w") as f:
            json.dump(rec, f)  # what the parts so far measured, should a later one fail

    part("(a)", smesh_f32_parity, rec, dev, K)
    part("(b)", smesh_launcher, rec, dev, K)
    part("(c)", smesh_moe, rec, dev, K)
    for arch in SMESH_FAMILIES:
        part(f"(d) {arch}", smesh_family, rec, dev, K, arch)
    rec["rank_seconds"] = time.perf_counter() - t_rank
    with open(os.path.join(outdir, f"smesh{rank}.json"), "w") as f:
        json.dump(rec, f)


def serve_mesh_phase(dev, K, smi):
    """Phase 21: serving over a (data, model) mesh of SMESH_RANKS gloo
    ranks on ``cuda:0`` (``serve_mesh_rank``), and the ssm, hybrid, vlm and
    encdec families trained and served there: an emulation with no
    interconnect, whose times say nothing about scaling. Prints each
    part's records and checks, rank 0's serving metrics, each rank's peaks
    and seconds, and returns the launches of the serving and training
    paths summed over the ranks (counts, shapes) and the kernels line's
    row 8g (flash at (b)'s longest prefill on a 2x2 rank's heads)."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.ranks import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as td:
        t = time.perf_counter()
        try:
            spawn_ranks(serve_mesh_rank, SMESH_RANKS, store_dir=td, timeout=SMESH_TIMEOUT,
                        args=(td, "cuda:0"))
        except Exception as e:  # a rank failed or hung: the run fails, after what it measured
            if os.path.exists(os.path.join(td, "smesh0.json")):
                with open(os.path.join(td, "smesh0.json")) as f:
                    say("phase21 rank 0 before the failure", f.read())
            fail(f"phase21: {type(e).__name__}: {e}")
        wall = time.perf_counter() - t
        recs = []
        for r in range(SMESH_RANKS):
            with open(os.path.join(td, f"smesh{r}.json")) as f:
                recs.append(json.load(f))
    r0 = recs[0]
    label = (f"{SMESH_RANKS} ranks on one card, gloo through host memory: an emulation, "
             "no interconnect's time and nothing about scaling")
    say("phase21 (a) float32 serving, mesh vs one device",
        json.dumps(dict(r0["f32"], compare={k: v for k, v in r0["compare"].items()
                                            if k.startswith("(a)")}, card=smi)))
    say(f"phase21 (b) launch/serve.py --mesh host:2x2, qwen2-1.5b bf16 ({label})",
        json.dumps(dict(r0["bf16"], compare=r0["compare"]["(b)"],
                        collective_seconds_by_rank=[r["bf16"]["collective_seconds"]
                                                    for r in recs],
                        peak_bytes_by_rank=[r["peak_bytes"]["(b)"] for r in recs], card=smi)))
    say("phase21 (c) qwen3-moe float32 on 1x4, the 2x2 raise",
        json.dumps(dict(r0["moe"], compare=r0["compare"]["(c) 1x4"], card=smi)))
    for arch, fr in r0["families"].items():
        losses = [r["families"][arch]["losses"] for r in recs]
        require(all(x == losses[0] for x in losses), f"phase21 {arch}: ranks' losses differ")
        say(f"phase21 (d) {arch} ({label})",
            json.dumps(dict(fr, compare=r0["compare"][f"(d) {arch}"], card=smi)))
    say("phase21 ranks", json.dumps({
        "ranks": SMESH_RANKS, "spawn_to_join_s": wall, "parent_bytes_held": held,
        "seconds": r0["seconds"], "rank_seconds": [r["rank_seconds"] for r in recs],
        "peak_bytes": [r["peak_bytes"] for r in recs], "card": smi}))
    counts, shapes = {}, {}
    for r in recs:
        for part in r["launch"].values():
            for k, v in part.items():
                counts[k] = counts.get(k, 0) + v
        for part in r["launch_shapes"].values():
            for k, by in part.items():
                for shp, c in by.items():
                    shapes.setdefault(k, {})[shp] = shapes.get(k, {}).get(shp, 0) + c
    say("phase21 launches of (a)-(d) (summed over the ranks):", json.dumps(counts))
    # row 8g: flash at (b)'s longest prefill on a 2x2 rank's heads
    cfg = get_config(LM_ARCH)
    S = max(r0["bf16"]["prompt_lens"])
    tp_cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // 2,
                                 num_kv_heads=cfg.num_kv_heads // 2)
    gen = torch.Generator(device=dev).manual_seed(SMESH_SEED + 3)
    with torch.inference_mode():
        r8 = flash_row("flash_attention:serve_mesh_local_heads", tp_cfg, dev, gen, S,
                       counts["flash_attention"], 0.0)
    rows = [dict(r8, launches_21=counts["flash_attention"])]
    say("phase21 row 8g", json.dumps(rows))
    torch.cuda.empty_cache()
    return counts, shapes, rows


def contract_phase(dev, smi, s2, kron, kron_sorted, train_rec):
    """Phase 22: the stream contract on the card, the dry run's prediction
    of phase 14's step, and the linter. (a) ``check_stream`` at the cheap
    level on S2's stream and decision inside
    ``torch.cuda.set_sync_debug_mode("error")`` (a control sync must
    raise there). (b) Arms C, D and E's reduce streams at S2 (C binned at
    its range, D by the COBRA plan, E as drawn) and S1 KRON's dst-sorted
    row stream at F = 32 through ``PBExecutor.reduce_stream`` with their
    true claims, without the check and with ``REPRO_PB_CHECK=1``: equal
    within the add rule; each arm's ms with and without the check and the
    full check's own ms; an index of n under ``in_bounds=True`` and one
    backwards pair under ``sorted_within=1`` must raise ``ContractError``
    named ``in-bounds`` and ``sortedness``. (c) ``launch/dryrun.py``'s trace
    of phase 14's step (one rank, B TRAIN_B x S TRAIN_S, bf16) on ``meta``:
    its predicted peak within DRYRUN_PEAK_TOL of phase 14's
    ``max_memory_allocated``, its counted FLOPs beside the model-FLOP
    count (at least that), the gaps printed. (d) The port's linter over
    its default targets: no finding."""
    import torch

    from repro_torch.analysis import contracts, lint
    from repro_torch.analysis.contracts import ContractError
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core import pb
    from repro_torch.core.cobra import hierarchical_binning
    from repro_torch.core.executor import PBExecutor
    from repro_torch.core.plan import CobraPlan, compromise_bin_range
    from repro_torch.launch import dryrun
    from repro_torch.models.config import flops_per_token
    from repro_torch.timing import cuda_ms

    prev = os.environ.pop("REPRO_PB_CHECK", None)
    ex = PBExecutor()
    n2, m2 = s2.num_nodes, s2.num_edges
    outdeg = torch.bincount(s2.src, minlength=n2).clamp(min=1).float()
    vals = (torch.full((n2,), 1.0 / n2, device=dev) / outdeg)[s2.src]
    d2 = ex.decide(n2, m2, torch.float32, kind="reduce", device=dev)

    # (a) the cheap level reads no data: no host sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cheap_ms = []  # the first call reads the executor's source once (cache-key check)
        for _ in range(2):
            t = time.perf_counter()
            # in-bounds-ok: S2's endpoints are drawn in [0, n)
            contracts.check_stream(s2.dst, vals, n2, d2, hw=ex.hw, level="cheap", in_bounds=True)
            cheap_ms.append((time.perf_counter() - t) * 1e3)
        try:
            int(s2.dst[0])
            control = False
        except RuntimeError:
            control = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(control, "phase22 (a): set_sync_debug_mode('error') let a host sync through")
    say("phase22 (a)", json.dumps({"stream": "S2", "m": m2, "n": n2, "decision": d2.describe(),
                                   "cheap_check_host_ms_first_then_warm": cheap_ms,
                                   "syncs": 0,
                                   "control_sync_refused": control, "card": smi}))

    # (b) the arms' streams, checked and not
    br = min(max(64, compromise_bin_range(n2, ex.hw)), n2)  # arm C's range, as phase 3's
    plan = CobraPlan.from_hardware(n2, ex.hw)
    bc = pb.binning(s2.dst, vals, br, -(-n2 // br), method="sort")
    bd = hierarchical_binning(s2.dst, vals, plan)
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = torch.randn(kron_sorted.shape[0], 32, device=dev, generator=gen)
    n1 = kron.num_nodes
    streams = {  # (indices, values, out_size, the arm's method and true claims)
        "C": (bc.idx, bc.val, n2, dict(method="sort", bin_range=br, sorted_within=br)),
        "D": (bd.idx, bd.val, n2, dict(method="hierarchical",
                                       sorted_within=plan.final_bin_range)),
        "E": (s2.dst, vals, n2, {}),
        # sorted-ok: KRON's destinations, sorted in phase 5
        "S1 KRON rows F=32": (kron_sorted, rows, n1, dict(sorted_within=1)),
    }
    out = {}
    for name, (idx, v, n, kw) in streams.items():
        def run(idx=idx, v=v, n=n, kw=kw):
            # in-bounds-ok: binned or sorted permutations of edge streams drawn in [0, n)
            return ex.reduce_stream(idx, v, out_size=n, op="add", in_bounds=True, **kw)

        d = ex.decide_or_forced(kw.get("method"), n, int(idx.shape[0]), v.dtype,
                                bin_range=kw.get("bin_range"), kind="reduce",
                                feature_dim=v.shape[1] if v.ndim == 2 else 0, device=dev)
        os.environ.pop("REPRO_PB_CHECK", None)
        want = run()
        ms = cuda_ms(run, reps=5)
        os.environ["REPRO_PB_CHECK"] = "1"
        got = run()
        checked_ms = cuda_ms(run, reps=5)
        check_ms = cuda_ms(lambda: contracts.check_stream(
            # in-bounds-ok: as run's
            idx, v, n, d, hw=ex.hw, in_bounds=True, sorted_within=kw.get("sorted_within")),
            reps=5)
        scale = want if v.ndim == 1 else ex.reduce_stream(
            # in-bounds-ok: as run's
            idx, v.abs(), out_size=n, op="add", in_bounds=True, **kw)
        ok = add_close(got, want, scale)
        out[name] = {"m": int(idx.shape[0]), "n": n, "decision": d.describe(),
                     "claims": {"in_bounds": True, **{k: x for k, x in kw.items()
                                                      if k == "sorted_within"}},
                     "add_ratio_checked_vs_unchecked": add_ratio(got, want, scale),
                     "arm_ms": ms, "arm_checked_ms": checked_ms, "full_check_ms": check_ms}
        require(ok, f"phase22 (b) {name}: the checked result differs from the unchecked one")
        del want, got, scale
    faults = {}
    bad = s2.dst.clone()
    bad[m2 // 2] = n2
    back = kron_sorted.clone()
    i = int(torch.nonzero(back[1:] != back[:-1])[0])  # back[i] < back[i + 1]
    back[i], back[i + 1] = kron_sorted[i + 1], kron_sorted[i]
    for name, fn, invariant in (
        ("index n under in_bounds", lambda: ex.reduce_stream(
            # in-bounds-ok: the planted fault the contract must refuse
            bad, vals, out_size=n2, op="add", in_bounds=True), "in-bounds"),
        ("a backwards pair under sorted_within=1", lambda: ex.reduce_stream(
            # sorted-ok: the planted fault the contract must refuse
            back, rows, out_size=n1, op="add", sorted_within=1), "sortedness"),
    ):
        try:
            fn()
            faults[name] = None
        except ContractError as e:
            faults[name] = e.invariant
        require(faults[name] == invariant,
                f"phase22 (b) {name}: raised {faults[name]!r}, not {invariant!r}")
    say("phase22 (b)", json.dumps({"streams": out, "faults": faults, "card": smi}))
    del bc, bd, rows, bad, back
    if prev is None:
        os.environ.pop("REPRO_PB_CHECK", None)
    else:
        os.environ["REPRO_PB_CHECK"] = prev
    torch.cuda.empty_cache()

    # (c) the dry run's prediction of phase 14's step
    cfg = get_config(LM_ARCH)
    t = time.perf_counter()
    tr = dryrun.trace_cell(cfg, ShapeSpec("train_4k", TRAIN_S, TRAIN_B, "train"))
    trace_s = time.perf_counter() - t
    measured = train_rec["peak_bytes_above_earlier_phases"]
    gap = (tr.peak_bytes - measured) / measured
    model_flops = flops_per_token(cfg) * TRAIN_B * TRAIN_S
    step_s = train_rec["steady_step_ms"] / 1e3
    say("phase22 (c)", json.dumps({
        "arch": LM_ARCH, "batch": TRAIN_B, "seq_len": TRAIN_S, "trace_s": trace_s,
        "predicted_peak_bytes": tr.peak_bytes, "measured_peak_bytes": measured,
        "peak_gap": gap, "tolerance": DRYRUN_PEAK_TOL,
        "counted_flops": tr.flops, "aten_flops": tr.aten_flops,
        "kernel_flops": {k: e["flops"] for k, e in tr.kernels.items()},
        "model_flops": model_flops, "counted_over_model": tr.flops / model_flops,
        "predicted_bytes_accessed": tr.bytes_accessed, "steady_step_ms": step_s * 1e3,
        "counted_flop_share_of_989T": tr.flops / step_s / BF16_FLOP_PER_S,
        "model_flop_share_of_989T": model_flops / step_s / BF16_FLOP_PER_S, "card": smi}))
    require(abs(gap) <= DRYRUN_PEAK_TOL,
            f"phase22 (c): predicted peak {tr.peak_bytes} vs measured {measured} ({gap:+.3f})")
    require(tr.flops >= model_flops,
            f"phase22 (c): counted {tr.flops} FLOPs below the model count {model_flops}")

    # (d) the linter over the port
    t = time.perf_counter()
    files = list(lint.iter_python_files(lint.DEFAULT_TARGETS))
    findings = lint.lint_paths()
    say("phase22 (d)", json.dumps({"targets": list(lint.DEFAULT_TARGETS), "files": len(files),
                                   "findings": [f.render() for f in findings],
                                   "seconds": time.perf_counter() - t}))
    require(not findings and len(files) > 50, f"phase22 (d): lint findings {findings}")


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
    from repro_torch.kernels.fused import FUSED_DESIGNS, fused_design, rows_design
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
            # sorted-ok: CSC segment ids  # in-bounds-ok: each in [0, n)
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
    # the bf16 flash kernels are Hopper's (wgmma fed by TMA, no mma.sync), the
    # float32 ones CUDA-core code: HGMMA, UTMALDG and HMMA lines in their SASS
    ops = {name: {op: body.count(op) for op in ("HGMMA", "UTMALDG", "HMMA")}
           for name, body in _lib.kernel_sass("flash_fwd_").items()}
    say("phase1 flash SASS HGMMA, UTMALDG, HMMA counts:", json.dumps(ops))
    bf16_ops = [n for name, n in ops.items() if "flash_fwd_bf16_kernel" in name]
    f32_ops = [n for name, n in ops.items() if "flash_fwd_f32_kernel" in name]
    require(len(bf16_ops) == 10 and all(n["HGMMA"] and n["UTMALDG"] and not n["HMMA"]
                                        for n in bf16_ops),
            f"the bf16 flash kernels are not all wgmma fed by TMA: {ops}")
    require(len(f32_ops) == 5 and not any(sum(n.values()) for n in f32_ops),
            f"a float32 flash kernel runs on the tensor cores: {ops}")
    # the rows kernel's tile walk: float4 reductions (REDG.E.ADD.F32x4) in its SASS,
    # <TIn, TAcc, op, VEC>: the float32 add of 16-byte rows is rows_tile_kernelIffLi0ELi4E
    redg = {name: body.count("REDG.E.ADD.F32x4")
            for name, body in _lib.kernel_sass("rows_tile_kernel").items()}
    say("phase1 rows tile walk SASS REDG.E.ADD.F32x4 count:", json.dumps(redg))
    require(any(n > 0 for name, n in redg.items() if "rows_tile_kernelIffLi0ELi4E" in name),
            f"the float32-add tile walk issues no float4 reduction: {redg}")

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
                    ok = add_close(got, want, scale)
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
            ok = add_close(got, want, scale)
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
                ok = add_close(b_got, b_want, scale)
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
            if F in FIG9_CPU_F:
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
    from repro_torch.kernels.flashattn import flash_hbm_bytes
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
    trav_counts, trav_shapes = traversal_phase(dev, T, K, suite, {"S2": s2, "S3": s3}, cache)
    torch.cuda.empty_cache()
    say(f"phase12 seconds: {time.perf_counter() - t12:.1f}")

    # -- phase 13: the graph-serving path (before phase 11's kernels line) ----------
    t13 = time.perf_counter()
    serving_counts, serving_shapes = serving_phase(dev, T, K, suite, s2, cache)
    torch.cuda.empty_cache()
    say(f"phase13 seconds: {time.perf_counter() - t13:.1f}")

    # -- phase 14: the LM training path (before phase 11's kernels line) ------------
    t14 = time.perf_counter()
    train_counts, train_shapes, emb_bwd, train_rec = train_phase(dev, K, smi)
    say(f"phase14 seconds: {time.perf_counter() - t14:.1f}")

    # -- phase 15: the MoE serving path (before phase 11's kernels line) ------------
    t15 = time.perf_counter()
    moe_counts, moe_shapes, moe_rows = moe_phase(dev, K, smi)
    say(f"phase15 seconds: {time.perf_counter() - t15:.1f}")

    # -- phase 16: sharded PB on four ranks (before phase 11's kernels line) --------
    t16 = time.perf_counter()
    shard_counts, shard_shapes, shard_rows = sharded_phase(smi)
    say(f"phase16 seconds: {time.perf_counter() - t16:.1f}")

    # -- phase 17: the recurrent families (before phase 11's kernels line) ----------
    t17 = time.perf_counter()
    rec_counts, rec_shapes, rec_rows = recurrent_phase(dev, K, smi)
    say(f"phase17 seconds: {time.perf_counter() - t17:.1f}")

    # -- phase 18: training of the moe, ssm and hybrid families (before phase 11) ----
    t18 = time.perf_counter()
    fam_counts, fam_shapes, fam_rows = family_train_phase(dev, K, smi)
    say(f"phase18 seconds: {time.perf_counter() - t18:.1f}")

    # -- phase 19: the vlm and encdec families (before phase 11) ----------------------
    t19 = time.perf_counter()
    x_counts, x_shapes, x_rows = cross_phase(dev, K, smi)
    say(f"phase19 seconds: {time.perf_counter() - t19:.1f}")

    # -- phase 20: the LMs over a mesh of four ranks (before phase 11) ------------------
    t20 = time.perf_counter()
    mesh_counts, mesh_shapes, mesh_rows = mesh_phase(dev, K, smi)
    say(f"phase20 seconds: {time.perf_counter() - t20:.1f}")

    # -- phase 21: serving over a mesh, the other families on a mesh (before phase 11) --
    t21 = time.perf_counter()
    smesh_counts, smesh_shapes, smesh_rows = serve_mesh_phase(dev, K, smi)
    say(f"phase21 seconds: {time.perf_counter() - t21:.1f}")

    # -- phase 22: the stream contract, the dry run and the linter (before phase 11) --
    t22 = time.perf_counter()
    contract_phase(dev, smi, s2, kron_g, kron_sorted, train_rec)
    say(f"phase22 seconds: {time.perf_counter() - t22:.1f}")

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
    fused_ok = add_close(got, want, want)  # contrib > 0: the sum of |v| is the sum
    require(hist_err == 0 and pos_err == 0 and fused_ok,
            f"S2 shapes: kernel vs plain: histogram {hist_err}, positions {pos_err}, fused {fused_err}")
    say("phase11 fused at S2: add_ratio of the kernel and of planted faults (each fault above 1)",
        json.dumps({"kernel": add_ratio(got, want, want),
                    **add_faults(s2.dst, contrib, n2, want, want)}))

    # rows: the GNN forward's stream at S2 (dst-sorted, F = 64)
    rows_v = torch.randn(m2, GNN_D, device=dev, generator=gen)
    got = K.cobra_bin_accumulate_rows(s2_sorted, rows_v, n2, 512, -(-n2 // 512))
    want = ref.scatter_reduce_ref(s2_sorted, rows_v, n2)
    scale = ref.scatter_reduce_ref(s2_sorted, rows_v.abs(), n2)
    rows_err = float((got - want).abs().max())
    require(add_close(got, want, scale),
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
    require(add_close(got, want, scale),
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
            + trav_counts[k] + serving_counts[k] + train_counts[k] + moe_counts[k]
            + shard_counts[k] + rec_counts[k] + fam_counts[k] + x_counts[k]
            + mesh_counts.get(k, 0) + smesh_counts.get(k, 0) for k in after}
    path_shapes = {}
    for part in (after_shapes, fig9_shapes, gnn_shapes, ops_shapes, serve_shapes, trav_shapes,
                 serving_shapes, train_shapes, moe_shapes, shard_shapes, rec_shapes, fam_shapes,
                 x_shapes, mesh_shapes, smesh_shapes):
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
            "launches": path[name], "launches_16": shard_counts[name],
            "launches_18": fam_counts[name], "launches_19": x_counts[name],
            "launches_20": mesh_counts.get(name, 0), "launches_21": smesh_counts.get(name, 0),
            "checked_against_plain": True, "max_abs_err": err,
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
    rows5 = next(k for k in kernels if k["name"] == "cobra_bin_accumulate_rows")
    rows5["embedding_backward"] = {
        k: emb_bwd[k] for k in ("m", "F", "n", "max_abs_err", "ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_bytes")}
    rows5["embedding_backward"]["rows_design"] = rows_design(emb_bwd["F"])
    # its launches on the paths by walk and shape (key m,F,n; 16-byte rows assumed)
    by_walk = {}
    for shp, c in path_shapes.get("cobra_bin_accumulate_rows", {}).items():
        walk = by_walk.setdefault(rows_design(int(shp.split(",")[1])), {})
        walk[shp] = walk.get(shp, 0) + c
    rows5["launches_by_walk"] = {w: {"launches": sum(v.values()), "shapes": v}
                                 for w, v in sorted(by_walk.items())}
    # flash: the longest prefill's attention, qwen2-1.5b's heads at S = 4096, bf16, causal
    fB, fH, fKH, fS, fhd = 1, lm_cfg.num_heads, lm_cfg.num_kv_heads, LM_MAX_LEN, lm_cfg.head_dim
    kernels.append(dict(
        flash_row("flash_attention", lm_cfg, dev, gen, fS, path["flash_attention"],
                  worst["flash_attention"]),
        launches_16=shard_counts["flash_attention"], launches_18=fam_counts["flash_attention"],
        launches_19=x_counts["flash_attention"], launches_20=mesh_counts["flash_attention"],
        launches_21=smesh_counts["flash_attention"],
        flash_hbm_bytes=flash_hbm_bytes(fB, fH, fKH, fS, fS, fhd)))
    kernels += moe_rows  # rows 2b, 5c, 7b and 8b: phase 15's shapes and launches
    kernels += shard_rows  # rows 4c and 5d: a rank's local reduce in phase 16, its launches
    kernels += rec_rows  # row 8c: flash at the longest zamba2 prefill, phase 17's launches
    kernels += fam_rows  # rows 5e and 7c: the MoE backward at phase 15's shape, phase 18's launches
    kernels += x_rows  # rows 8d, 8e and 5f: the vlm's and Whisper's shapes, phase 19's launches
    kernels += mesh_rows  # rows 8f and 5g: a rank's shapes in phase 20, its launches
    kernels += smesh_rows  # row 8g: flash at a 2x2 rank's heads in phase 21, its launches
    require(all(k["launches"] > 0 for k in kernels), f"a kernel never launched on a path: {path}")
    for k in kernels:  # the walk each rows-kernel line ran (fused.py's rule)
        if k["name"].startswith("cobra_bin_accumulate_rows"):
            k["rows_design"] = rows_design(k.get("shape", {}).get("F", GNN_D))
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
