#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # the full run: R-MAT scale 20, k = 32
    python3 chip_smoke.py --scale 16 --products-scale 0.1   # a shorter run

Phases, each printing one JSON line:

1. device   — the card, as ``nvidia-smi`` reports its name and power limit;
2. build    — ``nvcc`` builds every kernel source of the port (in parallel);
3. main     — S5P under the default ``S5PConfig`` (CMS Θ, chunk 65,536, one
              stream) on the Graph500 R-MAT (a=0.57, b=c=0.19, seed 0),
              k = 32, with every kernel launch counter set to 0 just before
              and read just after; max load must hold and every kernel of
              the path (K1, K2, K4a, K4b, and K5 twice for the game's
              cluster degrees and once per ordered sum that the game
              reports) must have launched; ``game_audit``: every W[i, p]
              and partition-size sum of the game below its limit (2^24,
              2^23) or summed in the reference's order, each of the
              statistics pass's three cluster-size sums under 2^24 terms,
              and the game's δ on the card with the CPU's bits;
4. compare  — every other entry of ``PARTITIONERS`` on the main path's
              graph and k (the S5P row is the main run's; CLUGP's runs on the
              same R-MAT cut to scale 17, ``CLUGP_SCALE``, and each row names
              its graph and scale), each with the launch counters set to 0
              just before and read just after:
              parts must lie in [0, k), K3 must launch once per chunk for
              Greedy and HDRF, G1 once per chunk for grid; the rows that
              run S5P's pipeline report its per-phase seconds, and
              S5P-exact's and CLUGP's their ``game_audit``; then the
              delete path: the HDRF stream's last chunk is retracted from
              its final carry (``HdrfCarry.retract_chunk``, K3 with sign
              = -1, once) and the carry must equal the one rebuilt without
              that chunk; then PageRank (10 iterations) on the S5P and HDRF
              partitions: mirror-sync bytes, their ratio, seconds of the
              layout build and of the supersteps; S5P's values again on the
              card and on the CPU, both bitwise (the gather on K5);
5. parallel — parallel ingest at S = 8 lanes on the main path's graph and
              k, each run with the launch counters set to 0 just before
              and read just after: S5P under ``S5PConfig(k, num_streams=8,
              shard="hub", super_chunk="auto")`` with its touch-up (parts
              in [0, k), the final load equal to the bincount of the
              parts, K1 once per plan chunk, K2 once per plan chunk and
              once per chunk of the touch-up's replay, K4a/K4b twice per
              stream chunk for the hub plan plus the Θ pass's, K5 for both
              games; the per-phase seconds, ``parallel_ingest``,
              ``touch_up``, both games' audits, the peak memory and the RF
              beside the sequential run's; the max load beside its cap is
              reported: lanes place against the last merge's loads, as
              the reference does); HDRF at S = 8 (hub, auto) on the
              threads and the vmap backend, which must give equal bits,
              K3 once per plan chunk; Greedy at S = 8 (range, super-chunk
              8); the degree count at S = 8 (hub), equal to
              ``compute_degrees``;
5b. ooc    — out-of-core ingest on the main path's graph and k: the
              edges written as 15 shards of 2^20 edges (``write_shards``,
              timed), S5P under the default ``S5PConfig`` from a natural
              ``ShardedEdgeStream`` (parts and cluster assignment equal to
              phase main's, the same launch counts), HDRF at S = 8 (hub,
              auto) from disk (parts equal to phase parallel's: the hub
              plan pages through ``_edges_at``), and HDRF from disk at
              R-MAT scale 14 under the shuffled, dst-sorted and windowed
              orderings (each equal to the in-memory stream's parts on
              the card), each stream's ``budget.peak_bytes`` beside 8·E;
5c. incremental — dynamic re-partitioning on the main path's graph and k,
              each step with the launch counters set to 0 just before and
              read just after: the warm-start bundle packed from phase
              main's own S5P output (``pack_warm_bundle``), a 10 % insertion
              (the first E/10 edges of the R-MAT of seed 1, appended) under
              the default drift thresholds (``s5p_apply_delta``: seconds,
              refined, game rounds, replay fraction, RF, balance, max load
              under its cap, the games' audit; K1 and K2 once per 65,536-edge
              delta chunk, K2 also once per chunk of a refinement's replay,
              K4a/K4b, and K5 as the games report) beside a cold S5P run of
              all the edges (seconds, RF); the rollback of exactly that batch
              (``rolled_back``, every bundle leaf bitwise the base; with
              refinement off when the delta refined, since a refinement
              drops the journal); a decremental ``frac:0.05`` deletion of
              the base (``_parse_delete``, seed 0: seconds, churn, refined,
              RF); ``CarryStore`` save and load of the post-delta bundle
              (bitwise, bytes on disk, seconds); HDRF's ``cold_start`` (its
              parts equal phase compare's) then ``run_incremental`` with the
              same delta and ``frac:0.05`` of the grown stream (K3 inserts
              once per delta chunk, retracts once per deletion chunk; RF
              beside phase compare's HDRF); ``S5PWindowChain`` over phase
              main's edges, window 2^22, step 2^20, through its first
              steady step (every step's seconds, RF, refined, rolled back,
              compactions, slots freed; cut from 2^23 / 2^21 over the whole
              stream for the time limit).  The
              summed launches join the ``kernels`` rows
              (``launches_incremental``), and the deletion's Θ retraction
              gives phase ``kernels`` a K4a row with negative counts;
5d. elastic — elastic k→k′ resharding, the runtime and the serving
              controller at phase main's scale (``phase_elastic``): phase
              incremental's base bundle resharded 32 → 40 and 32 → 24
              (``reshard_bundle``: the migration-cost game on the card, K5
              for its sums, K2 for the affected edges; the game's audit;
              the load equal to the placed parts' histogram, c2p < k′,
              on shrink n_displaced exactly the edges on partitions
              24–31, on grow every edge of unmoved clusters in place);
              HDRF's cold carry 32 → 24
              (K3's retract and K3 once per displaced chunk each); a
              ``ServingController`` over a 2^21 / 2^19 window (cut from
              2^22 / 2^20, and the cold S5P at k′ = 24 dropped, for the
              time limit): the fill, a steady step, ``resize(40)`` (origin ``"resize"``,
              a pinned reader still on k = 32), a steady step at k = 40,
              PageRank supersteps and 16 ``query_pagerank`` a swap;
              ``FaultTolerantLoop`` over label propagation (bitwise the
              undisturbed run) and ``ElasticController.resize`` (the
              state back on the card bitwise); the summed launches join
              the ``kernels`` rows (``launches_elastic``);
5e. hybrid  — the memory-budget hybrid partitioner (``phase_hybrid``):
              ``run_hybrid`` on phase main's graph, k = 32, budget 0.05 of
              E·CORE_EDGE_BYTES·2 (45,530,385 bytes): the plan (mode, ξ*,
              ladder, estimated core), the core spilled, the peak budget
              bytes and retreats, the accepted levels and game rounds, RF
              and balance beside the streaming run's, seconds of pass 0,
              the plan, the spill and the refinement, peak memory; pass 0
              must equal phase main bit for bit, peak ≤ budget, RF ≤ the
              streaming RF and the parts' RF, max load under its cap, the
              40-key bundle at E, and the launches exact (K1 240; K4a pass
              0's + 480 and K4b + 2 for the degree sketch; K2 + ⌈core /
              65,536⌉ + 240 a level; K5 as the games report); the bundle
              through ``HybridServingChain`` and a ``ServingController``
              (the publish, origin ``"cold"``; a delta of 65,536 edges);
              the frontier on ``block_rmat_graph(14, 8, 8)`` at rungs 0,
              0.05, 0.3, 1.0 (RF non-increasing, ≤ streaming, peak ≤
              budget, rung 0 the plain S5P, 1.0 in memory); the summed
              launches join the ``kernels`` rows (``launches_hybrid``);
6. serve    — the serving read side with GCN inference: the
              ``ogbn_products_like(seed=0)`` graph at scale 1.0 (2,449,029
              vertices), S5P at k = 32, ``build_bundle`` and
              ``BundleRegistry.publish``, ``GASServer`` for 10 PageRank
              supersteps, 16 ``query_pagerank`` calls of 16 vertices, one
              ``query_components(5)``, one ``gcn_forward`` of gcn-cora at
              d_feat 100 over ``products_features``, ``query_gnn`` for all
              vertices and then 16 times for 16 vertices; launch counters
              set to 0 just before and read just after, K5 launched 6 times
              per forward, once a PageRank superstep and as S5P's game
              reports; one more ``query_gnn``
              under ``torch.profiler``, its device time split into K5 and
              the rest; the ``game_audit``; S5P's Θ stream replayed from
              the run's clusters (``theta_capture``), which must end at the
              run's sketch; the full logits held against the same forward
              on ``device="cpu"`` (rtol 1e-4, atol 1e-5: only ``x @ W``
              differs); one line each for the graph, S5P, GAS, latency,
              GCN and device numbers;
6b. gnn3d   — SchNet, EGNN and DimeNet at their published configs
              (``phase_gnn3d``): ``molecule`` (``molecule_batch(128, 30, 64,
              seed=0)``, V 4,096, E 8,192, T 32,768), ``minibatch_lg`` (one
              15-10 ``NeighborSampler`` batch of 1,024 seeds from
              ``build_csr`` of phase serve's graph on the card: V 169,984, E
              168,960, T 337,920) and ``ogb_products`` (phase serve's whole
              graph; SchNet and EGNN), each call with the launch counters
              set to 0 just before and read just after: forward and loss
              seconds, loss and MAE, peak memory, K5 launches against the
              models' stated counts, and at the first two shapes the card's
              energies against the CPU forward (per node at
              ``minibatch_lg``) within ``GNN3D_TOL``; phase ``kernels`` then
              adds K5's identity-source message sums at ``minibatch_lg`` (d
              = 64, 128 twice, 3) and at ``ogb_products`` (d = 64, the plain
              check over its first ``K5_SLICE_ROWS`` rows);
7. kernels  — each kernel's wrapper on card tensors at the main path's
              shapes against its plain PyTorch version on the same inputs:
              K1–K5 bitwise equal (tolerance 0), K6 within the tolerance
              its row states (below); times by CUDA
              events, the plain version's time, the bound, and a PyTorch
              library call where one computes the same function; for the
              serial scans also a latency bound (edges × the chain's
              dependent steps × the round trips that a pointer chase and a
              reduction chain measure on the card first, ``latency.py``).
              K1 and K3 run the main path's 65,536-edge chunks from the
              empty state and from the state after half the chunks (K1
              under S5P, S5P-B, 2PS-L's ξ = -1 and CLUGP's ξ; K3 in both
              modes, each insert followed by its retract, which must
              restore the state), 4,096 edges onto the final state, and a
              65,536-edge chunk from a merge base whose id counters passed
              V + 1 (16 clustering lanes merged every chunk, CLUGP's ξ: the
              reference's clamp and drop);
              each row also holds two launches against each other and
              names the first differing leaf and index on a mismatch; K3's
              rung and tile and K1's tile are printed for k = 8, 32, 256
              and 4,096 (``kernel_plan``).  K2 (``k2_cases``) runs the
              main path's 65,536-edge chunks 0, 120 and 239 with the loads
              the replayed stream had before each, 4,096 edges onto the
              final loads, chunk 0 with no room and under the wrap guard
              (cap 2^31 - 1), the last chunk's retract (n_valid < E) and
              4,096 edges at k = 8 and 256; each row names its overflow
              edges, the edges of each mode of the plan and its latency
              bound.  G1 runs the grid row's chunk.  K4a runs the first,
              the middle and the last 2^18-key chunk of the main run's and
              the serve phase's Θ streams (replayed), a hot-key chunk, the
              deduplicated pair list and, with counts of -1, phase
              incremental's Θ retraction onto phase main's sketch, K4b the
              real pair count of both
              runs, with the floors a launch can reach (an empty launch,
              the card's rate of atomic adds) and the whole ``cms_update``
              call's time;
              K5 runs the serve phase's degree counts (d = 1, every long
              row on the tree), layer-1 (d = 16) and layer-2 (d = 7)
              aggregations and one over its features in bfloat16 (d = 100),
              recording the long rows, the tree rows and the compiled
              kernel's registers, with ``torch.sparse.mm`` on the same CSR matrix as
              the library call (for bf16 a CSR of bf16 weights; where
              PyTorch refuses it, the row records the error text);
8. lm       — the LM serving path at full width: ``serve_lm`` of
              ``llama3-8b`` (32 layers, 8,030,261,248 parameters, bf16,
              seed 0) over 4 prompts of 4,096 tokens, then 32 greedy
              tokens, with the launch counters set to 0 just before and
              read just after: init seconds and peak memory, prefill seconds
              and tokens/s, decode ms per token (mean, p99), K6 launched
              exactly once per layer of the prefill (32), the logits finite;
              then a float32 check at full width and 2 layers: the logits
              of ``prefill(prompt[:S])`` against ``prefill(prompt[:S-1])``
              followed by ``decode_step(prompt[S-1])`` within atol 2e-3,
              rtol 1e-3 (the reference's decode-against-forward
              tolerance), which holds K6 against the plain decode path.
              Phase ``kernels`` then holds K6 against its plain version
              (``flash_attention_ref`` over K6's key tiles on the same card
              tensors, float32 products in full float32, no TF32) at
              llama3-8b's prefill layer, qwen3-14b's 5-head groups,
              Mixtral's 4,096 window over 8,192 tokens and a ragged,
              padded float32 case, within ``K6_LIMITS`` (bf16: per-row and
              mean relative error), shows that a dropped kv tile and q, p
              left in float32 fail those limits, times
              ``scaled_dot_product_attention`` beside it (a boolean mask
              from the positions where not causal alone), and states the
              tile classes (``kv_tile_classes``) and the compiled kernel's
              registers, spills and shared memory;
8b. moe     — Mixtral's MoE serving path at published width: ``serve_lm``
              of ``mixtral-8x7b`` (d_model 4,096, 32 / 8 heads, d_ff 14,336,
              8 experts, top-2, window 4,096, bf16, seed 0) cut to 16 of its
              32 layers (``MOE_LAYERS``: 23.48 G parameters, 47 GB; the 32
              layers' 93.4 GB pass the card), once phase lm's weights are
              freed, over 2 prompts of 8,192 tokens (past the window: K6
              masks by window, the rolling cache wraps), then 32 greedy
              tokens, with the launch counters set to 0 just before and
              read just after: device memory allocated at the start, init
              seconds and peak memory, prefill seconds and tokens/s, decode
              ms per token (mean, p99), each layer's dropped assignments
              and per-expert load (cap 2,560 of 16,384 assignments a row),
              K6 launched exactly once per layer of the prefill (16), the
              logits finite; then the float32 check at full width, 2 layers
              and capacity factor 4 (cap = T, nothing dropped) on 2 prompts
              of 4,608 tokens: ``prefill(prompt[:S])`` against
              ``prefill(prompt[:S-1])`` then ``decode_step`` within atol
              2e-3, rtol 1e-3, K6 launched 2 × 2 times.  Phase ``kernels``
              adds its K6 launches to phase lm's, and its Mixtral row runs
              at this phase's shape (B = 2);
9. recsys   — the recsys serving path at xDeepFM's published config (39
              fields, embed 10, CIN 200-200-200, MLP 400-400, float32,
              50,453,809 parameters, seed 0): ``serve_recsys`` (init and the
              first ``serve_p99`` request), 16 more requests of 512 samples
              (ids drawn from ``PRNGKey(r)`` as the reference draws them), 2
              ``serve_bulk`` requests of 262,144 samples and a retrieval of
              1 query against 1,000,000 candidates (top 100, twice: the
              first call pays the first use of its kernels), each ending in
              a copy to the host, with the launch counters set to 0 just
              before and read just after: init seconds, latency mean and
              p99, samples/s, peak memory, K7 launched exactly 3 times per
              forward; the last p99 request and the first 1,024 rows of the
              last bulk request again on the CPU forward: logits within rtol
              1e-4, atol 1e-6 and each CIN layer's pools within 1e-5 of its
              max (the logits cannot see a K7 that drops a term).  Phase
              ``kernels`` then holds K7 against ``cin_layer_ref`` at layer
              1's and layer 2's shapes (B = 512, float32 and bf16), a
              ragged B = 1,000 and ``serve_bulk``'s layer 2 (B = 262,144),
              within ``K7_LIMITS``; two launches must give equal bits; a
              dropped h slice and, where ``plan`` splits the K stages, a
              dropped split's partial (``cin_split_partials``) must fail the
              limits; one ``torch.einsum`` is timed beside it where its
              intermediate fits the card, and the bound is stated on the
              tensor cores (``k7_bounds``) beside the scalar one;
9b. train   — training through ``launch.train.train`` (``phase_train``),
              each run with the launch counters set to 0 just before and
              read just after: llama3-8b ``train_4k`` at published width cut
              to 4 of 32 layers and B = 2 of 256 (``TRAIN_LM_LAYERS``,
              ``TRAIN_LM_BATCH``), 3 steps (``TRAIN_LM_STEPS``; ms a step,
              tokens/s, the loss a step, peak memory, the fault loop's entry
              copy; K6 exactly 2 × 4 × 3 with remat and K6b 4 × 3; no
              checkpoint written: ``_train_run(save=False)``);
              the smoke LM 4 steps with ``fail_at=(2,)`` beside a clean run
              (the same bits); xDeepFM ``train_batch`` (K7 and K7b 3 a step);
              gcn-cora ``full_graph_sm`` and SchNet, EGNN, DimeNet at
              ``molecule`` on the reference cells' batches (K5 and K5ᵀ both
              launched); every loss and parameter finite; then K6b (bf16 at
              the LM's shape, float32 ragged with a window), K7b (layers 1
              and 2 at B = 65,536) and K5ᵀ (GCN's and a message layout)
              against their plain versions, each twice with the same bits,
              beside SDPA's backward, ``torch.einsum``'s and
              ``torch.sparse.mm``; each family's smoke gradients on the card
              against the CPU (``TRAIN_GRAD_TOL``);
10. parity  — every partitioner on ``community_graph(2000, 32, 8,
              seed=5)``, k = 8, on ``cuda`` and on ``cpu``: the parts must be
              identical; then S5P (with its touch-up), HDRF, Greedy and
              grid at S = 4 lanes in each shard mode (range, rr, hub;
              chunks of 1,024 edges), identical parts (and touch-up
              counts) on both; and the game's δ where Σ(degs + sizes)
              passes 2**24 (Θ scaled by 3001), on both: the same bits and
              assignment; and ROADMAP Queue 3 j's input (8 clustering lanes
              merged every chunk on ``rmat_graph(10, edge_factor=8,
              seed=4)``, ξ = κ = 2^20, chunks of 256: ``next_t`` passes
              V + 1), every leaf of the state equal on both; and the
              incremental sequence on ``community_graph(600, 8, 6,
              seed=3)`` (a delta, its rollback, a refined delta, a
              deletion, four window steps): every bundle leaf and result
              field equal on both; and the elastic sequence
              (``_elastic_sequence``: the migration-cost game at three
              scales, ``reshard_bundle`` grow and shrink,
              ``reshard_scan_carry`` for Greedy and HDRF, HDRF at S = 4 in
              each shard mode with a forced straggler handoff and a lane
              killed and replayed, a ``ServingController`` with one
              resize): every result equal on both; and the hybrid sequence
              (``_hybrid_sequence``: ``run_hybrid`` at three budgets and at
              S = 4 hub lanes, a spill that retreats, ``HybridServingChain``
              with one delta): every result, bundle leaf and published
              bundle equal on both.

5f. distributed — multi-device S5P over ``torch.distributed``
              (``core/distributed.py``, ``run_parallel``'s ``shard_map``), after
              every other phase, nothing beside it: phase main's R-MAT cut to
              scale 16 (``DIST_SCALE``) and its sequential S5P beside, the
              edges written once as ``.npy`` (under ``build/``) and
              memory-mapped by the ranks; ``distributed_partition`` under the
              default ``S5PConfig`` (k = 32) in a world of 4 ranks sharing the
              card under gloo, then in this process alone as a world of 1 under
              NCCL, each rank with its launch counters and collective bytes set
              to 0 just before and read just after: every phase's seconds (the
              max over ranks), ``info``, RF and balance beside the sequential
              run's, max load at or under its cap with every valid edge
              placed, the same parts hash on every rank, K1 exactly ⌈shard /
              65,536⌉ and K2 ⌈shard / chunk⌉ times a rank, K4a once a
              2^18-pair chunk of the rank's pairs, K4b once, K5 as the game
              reports, the collectives' bytes by phase, peak device memory a
              rank; HDRF at 4 ranks (range, super-chunk 8) bit for bit the
              threads backend at S = 4 run before the world starts, K3 once a
              lane chunk; and the parity sequence on ``community_graph(600, 8,
              6, seed=3)``, k = 8, in a world of 2 ranks sharing the card, each
              running it on the card and then on the CPU
              (``distributed_partition`` at S = 2, S5P at 2 hub lanes with auto
              cadence, Greedy and grid at 2 range lanes,
              ``ElasticController`` resizing a state on both ranks onto the
              first): every result equal on both.

The R-MATs of phases 4 (CLUGP's), 5c (its 10 % delta, seed 1) and 5f are
made by worker processes while the script makes phase main's graph, before
anything is timed (``make_graphs``).
The kernel checks of phase 7 run after phases 8, 9 and 9b.  Phase 6's
features (one generator a vertex) are made in ranges by worker processes
while the script makes the graph and runs nothing timed: no timed phase
shares the host with them.

Then one ``{"kernels": [...]}`` line, the script's ``total_s``, the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result.  It needs the rest of the repository
(``src/repro_torch``) and a CUDA device.  Long outputs (the compiler's
register report, the full results) go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# the sliding windows of phase incremental (cut from 2^23 / 2^21) and of
# phase elastic's serving controller (cut from 2^22 / 2^20)
WINDOW_EDGES, WINDOW_STEP = 1 << 22, 1 << 20
ELASTIC_WINDOW_EDGES, ELASTIC_WINDOW_STEP = 1 << 21, 1 << 19

# H100 SXM peaks (NVIDIA data sheet):
# HBM3 bytes/s, and the float32 rate outside the tensor cores, used for
# the 32-bit integer work of these kernels.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12  # dense bf16 tensor-core rate
TF32_TENSOR_OPS_PER_S = 495e12  # dense TF32 tensor-core rate


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, setup=None) -> float:
    """Mean device time of ``fn`` by CUDA events over ``reps`` runs (after
    one warm-up); ``setup`` runs before each, outside the timed region."""
    import torch

    if setup is not None:
        setup()
    fn()
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def host_time_ms(fn, reps: int = 1) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = SCALAR_OPS_PER_S
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise SystemExit(f"chip_smoke: shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if not a.numel():
        return 0
    return int((a.cpu().to(torch.int64) - b.cpu().to(torch.int64)).abs().max())


def _kernel_modules():
    from repro_torch.kernels.cin import kernel as cin_k
    from repro_torch.kernels.cms_sketch import kernel as cms_k
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.segment_agg import kernel as seg_k
    from repro_torch.kernels.stream_scan import kernel as scan_k

    return scan_k, cms_k, seg_k, fa_k, cin_k


def launch_counts() -> dict:
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.launch_counts())
    return counts


def reset_launch_counts() -> None:
    for mod in _kernel_modules():
        mod.reset_launch_counts()


# ------------------------------------------------------------- serve's data

FEATURE_WORKERS = 6


def _products_features(lo: int, hi: int):
    """``products_features`` of vertices [lo, hi), in a worker process: one
    generator a vertex, so the ranges concatenate to the whole table."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.graphs import products_features

    return products_features(np.arange(lo, hi), 100, seed=0)


def _serve_data(products_scale: float):
    """Phase serve's host-made data: ``ogbn_products_like(seed=0)`` made
    here while :data:`FEATURE_WORKERS` spawned processes make its 100
    features a vertex in ranges.  Returns ``(graph, features, graph_s,
    features_s)``, each the wall time from the common start."""
    import numpy as np

    from repro_torch.graphs import ogbn_products_like

    n = int(2_449_029 * products_scale)  # ogbn_products_like's vertex count
    cuts = np.linspace(0, n, FEATURE_WORKERS + 1).astype(int)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=FEATURE_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(_products_features, int(lo), int(hi))
                for lo, hi in zip(cuts[:-1], cuts[1:])]
        g = ogbn_products_like(seed=0, scale=products_scale)
        graph_s = time.perf_counter() - t0
        feats = np.concatenate([job.result() for job in jobs])
    if g.n_vertices != n:
        raise SystemExit(f"chip_smoke: ogbn_products_like made {g.n_vertices} vertices, "
                         f"not {n}")
    return g, feats, graph_s, time.perf_counter() - t0


# --------------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> dict:
    from repro_torch.kernels import _build

    res = _build.build_all()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        for name, log in res["logs"].items():
            f.write(f"== {name}\n{log}\n")
    info = {"phase": "build", "seconds": res["seconds"],
            "sources": {n: os.path.relpath(str(p), ROOT)
                        for n, p in _build.SOURCES.items()},
            "k4_kernels": ptxas_kernels(res["logs"].get("cms_sketch", "")),
            "k6_kernels": ptxas_kernels(res["logs"].get("flash_attention", "")),
            "k7_kernels": ptxas_kernels(res["logs"].get("cin", ""))}
    emit(info)
    return info


def _kernel_label(mangled: str) -> str:
    """``_ZN12_GLOBAL__N_111fa_fwd_bf16ILi128EEEv…`` → ``fa_fwd_bf16<128>``:
    the last of the length-prefixed names, and its template arguments (an
    int, a bool, ``float`` or ``__nv_bfloat16``; ``fa_bwd_kv_bf16<128,
    true>``)."""
    import re

    pos, name = re.match(r"_ZN?", mangled).end() if mangled.startswith("_Z") else 0, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:])
        pos += n.end()
        name, pos = mangled[pos:pos + int(n.group())], pos + int(n.group())
    arg = r"Li(\d+)E|Lb([01])E|(f)|\d+(__nv_bfloat16)"
    t = re.match(rf"I((?:{arg})+)E", mangled[pos:])
    if not t:
        return name
    args = [i or ("true" if b == "1" else "false") if (i or b) else ("float" if f else h)
            for i, b, f, h in re.findall(arg, t.group(1))]
    return f"{name}<{', '.join(args)}>"


def ptxas_kernels(log: str) -> dict:
    """``-Xptxas -v``'s figures per kernel of one source: registers, spill
    stores and loads (bytes), stack frame (bytes); templates named as
    ``fa_fwd_bf16<128>``."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(_kernel_label(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _game_audit(out, src, dst) -> dict:
    """The game's float32 sums on this run's inputs, against the limits below
    which a sum of non-negative terms is exact in any order: 2**24 for
    integer-valued terms (Θ, so W[i, p] ≤ deg_i), 2**23 for multiples of ½
    (the cluster and partition sizes).  Every row whose exact degree
    (float64 here) reaches 2**24 must lie in one of the game's hub batches,
    which sum W in the reference's order on K5; the partition sizes must be
    below 2**23 in all (Σ sizes), or guarded by the game, with the sizes
    summed in order (a replayed or an ordered round) wherever a guarded
    total reached 2**23.  The statistics pass makes each cluster size from
    three atomic sums over the edges of ``src``, ``dst`` (internal edges
    ×1, each side's boundary edges ×½, added elementwise after), so each
    sum must have fewer than 2**24 terms (``cluster_sizes_below_2^23``
    alone is the stricter bound on their result).  The cluster degrees and
    δ's sums run in the reference's order
    (K5, ``xla_sum_f32``): δ on the card against δ on the CPU, bitwise.
    ``game`` is the game's own report, over all rounds."""
    import numpy as np
    import torch

    from repro_torch.core import game as G
    from repro_torch.core.s5p import _edge_clusters

    st, game = out.aux["incremental"], out.aux["game"]
    sizes, pa, pb, pw = st["sizes"], st["pair_a"], st["pair_b"], st["pair_w"]
    C, k = out.n_clusters, out.k
    a, b = pa.long().clamp(max=C), pb.long().clamp(max=C)
    w64 = pw.double()
    deg = torch.zeros(C + 1, dtype=torch.float64, device=pw.device)
    deg = deg.index_add(0, a, w64).index_add(0, b, w64)[:C]
    assign = torch.as_tensor(out.cluster_assignment, device=pw.device).long()
    ext = torch.cat([assign, assign.new_zeros(1)])
    wip = torch.zeros((C + 1) * k, dtype=torch.float64, device=pw.device)
    wip.index_add_(0, a * k + ext[b], w64).index_add_(0, b * k + ext[a], w64)
    parts = torch.zeros(k, dtype=torch.float64, device=pw.device).index_add_(
        0, assign, sizes.double())
    inputs = G.GameInputs(sizes, pa, pb, pw, 0, k)
    d_dev = G.compute_delta(sizes, G._cluster_degrees(inputs, C), k)
    cpu = G.GameInputs(sizes.cpu(), pa.cpu(), pb.cpu(), pw.cpu(), 0, k)
    d_cpu = G.compute_delta(cpu.sizes, G._cluster_degrees(cpu, C), k)
    total = float(deg.sum() + sizes.double().sum())
    # the game's spans (leaders, then followers) and the ones that hold a hub row
    bs, n_head = game["batch_size"], game["n_head"]
    spans = [(lo, min(lo + bs, n_head)) for lo in range(0, n_head, bs)]
    spans += [(lo, min(lo + bs, C)) for lo in range(n_head, C, bs)]
    hub_rows = torch.nonzero(deg >= G.W_LIMIT)[:, 0].cpu().numpy()
    hub_spans = [(lo, hi) for lo, hi in spans
                 if np.searchsorted(hub_rows, lo) < np.searchsorted(hub_rows, hi)]
    sum_sizes = float(sizes.double().sum())
    max_cluster_size = float(sizes.max())
    s_t = torch.from_numpy(src).to(pw.device, torch.int32)
    d_t = torch.from_numpy(dst).to(pw.device, torch.int32)
    cu, cv, _ = _edge_clusters(s_t, d_t, st["compact"], st["degrees"], out.xi)
    valid = s_t != d_t
    internal, boundary = (cu == cv) & valid, (cu != cv) & valid
    size_terms = max(int(torch.bincount(c.clamp(min=0).long()[m], minlength=C).max())
                     for c, m in ((cu, internal), (cu, boundary), (cv, boundary)))
    del s_t, d_t, cu, cv, valid, internal, boundary
    replay_ok = game["max_part_size"] < G.SIZE_LIMIT or game["ordered_rounds"] > 0
    return {"sum_degs_sizes": total, "max_cluster_degree": float(deg.max()),
            "hub_rows": int(hub_rows.size), "hub_batches_expected": len(hub_spans),
            "sum_sizes": sum_sizes, "max_cluster_size": max_cluster_size,
            "max_cluster_size_sum_terms": size_terms,
            "max_w_ip_final": float(wip.max()), "max_part_size_final": float(parts.max()),
            "game": {key: v for key, v in game.items() if key not in ("rounds", "converged")},
            "w_sums_ordered_or_below_2^24": game["hub_batches"] == len(hub_spans),
            "part_sizes_below_2^23_or_replayed": sum_sizes < G.SIZE_LIMIT or (
                game["size_guard"] and replay_ok),
            "cluster_sizes_below_2^23": max_cluster_size < G.SIZE_LIMIT,
            "cluster_size_sums_exact": size_terms < G.W_LIMIT,
            "delta_bits_cuda": int(d_dev.cpu().view(torch.int32)),
            "delta_bits_cpu": int(d_cpu.view(torch.int32)),
            "delta_sum_above_2^24": total >= 2**24}


def _audit_problems(name: str, audit: dict) -> list[str]:
    keys = ("w_sums_ordered_or_below_2^24", "part_sizes_below_2^23_or_replayed",
            "cluster_size_sums_exact")
    problems = [f"{name}: the game audit fails {key}: {audit}" for key in keys if not audit[key]]
    if audit["delta_bits_cuda"] != audit["delta_bits_cpu"]:
        problems.append(f"{name}: the game's δ differs between cuda and cpu: {audit}")
    return problems


def theta_capture(src, dst, out, cfg) -> dict:
    """S5P's Θ stream replayed from the run's own state: the pair stream of
    ``core.s5p.theta_pairs`` (the run's clusters), chunked as the
    statistics pass chunks it (2^18 keys), each chunk's keys and counts as
    ``SketchCarry.step_chunk`` makes them, through ``cms_update`` from the
    empty sketch.  The replay must end at the run's final sketch, bit for
    bit.  Returns the first, the middle and the last chunk, each with the
    table it found, and the seeds, width and depth."""
    import torch

    from repro_torch.core.cms import SketchCarry, cms_update, pair_key, suggest_params
    from repro_torch.core.s5p import theta_pairs
    from repro_torch.streaming import EdgeStream

    st = out.aux["incremental"]
    s_t = torch.from_numpy(src).to("cuda", torch.int32)
    d_t = torch.from_numpy(dst).to("cuda", torch.int32)
    a, b = theta_pairs(s_t, d_t, st["compact"], st["degrees"], out.xi)
    del s_t, d_t
    C = out.n_clusters
    w, depth = suggest_params(cfg.cms_epsilon, cfg.cms_nu)
    theta = SketchCarry(w * max(1, int(math.sqrt(C))), depth, seed=cfg.seed, device="cuda")
    stream = EdgeStream(a, b, C + 1, chunk_size=1 << 18, device="cuda")
    n = stream.n_chunks
    picks = {0, n // 2, n - 1}
    sketch, chunks = theta.init(), {}
    for i in range(n):
        ch = stream.chunk_at(i)
        keys, counts = pair_key(ch.src, ch.dst), theta._counts(ch.src, ch.n_valid)
        if i in picks:
            chunks[i] = {"keys": keys, "counts": counts, "table": sketch.table.clone(),
                         "n_valid": int(ch.n_valid)}
        sketch = cms_update(sketch, keys, counts)
    torch.cuda.synchronize()
    return {"chunks": chunks, "n_chunks": n, "pairs_streamed": int(a.size),
            "seeds": sketch.seeds, "width": theta.width, "depth": theta.depth,
            "ends_at_run_sketch": bool(torch.equal(sketch.table, out.aux["sketch"].table))}


def _rmat_worker(scale: int, seed: int):
    """The Graph500 R-MAT at ``scale`` from ``seed`` (edge factor 16) and
    the seconds it took to make: ``((src, dst, n), seconds)``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.graphs import rmat_graph

    t0 = time.perf_counter()
    g = rmat_graph(scale, edge_factor=16, a=0.57, b=0.19, c=0.19, seed=seed)
    return g, time.perf_counter() - t0


def make_graphs(main: tuple[int, int], others: dict) -> dict:
    """The script's R-MATs, each ``(scale, seed)``: phase main's made in this
    process while worker processes make ``others`` (``{name: (scale,
    seed)}``), all done before anything is timed.  Returns ``{"main": ...,
    name: ...}``, each as :func:`_rmat_worker` returns it."""
    with ProcessPoolExecutor(max_workers=max(len(others), 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {name: pool.submit(_rmat_worker, *args) for name, args in others.items()}
        graphs = {"main": _rmat_worker(*main)}
        graphs.update((name, job.result()) for name, job in jobs.items())
    return graphs


def phase_main(scale: int, graph) -> dict:
    """S5P on ``graph``, the R-MAT at ``scale`` (:func:`make_graphs`)."""
    import torch

    from repro_torch.core.metrics import load_balance, partition_loads, replication_factor
    from repro_torch.core.s5p import S5PConfig, s5p_partition

    (src, dst, n), gen_s = graph
    dev = torch.device("cuda")
    cfg = S5PConfig(k=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = s5p_partition(src, dst, n, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    E = int(src.shape[0])
    parts = out.parts
    s_t = torch.from_numpy(src).to(dev)
    d_t = torch.from_numpy(dst).to(dev)
    loads = partition_loads(parts, k=cfg.k)
    info = {
        "phase": "main", "graph": f"rmat:{scale} edge_factor=16 seed=0",
        "V": n, "E": E, "k": cfg.k, "generate_s": gen_s,
        "clusters": out.n_clusters, "head_clusters": out.n_head_clusters,
        "tail_clusters": out.n_clusters - out.n_head_clusters,
        "xi": out.xi, "kappa": out.kappa,
        "game_rounds": out.game_rounds, "game_converged": out.game_converged,
        "rf": replication_factor(s_t, d_t, parts, n_vertices=n, k=cfg.k),
        "balance": load_balance(parts, k=cfg.k),
        "max_load": int(loads.max()), "max_load_cap": out.max_load,
        "seconds": out.timings, "wall_s": wall,
        "clustering_edges_per_s": E / out.timings["clustering"],
        "placement_edges_per_s": E / out.timings["postprocess"],
        "max_memory_allocated": peak, "launches": launches,
        "pairs": out.aux["n_pairs"], "game_audit": _game_audit(out, src, dst),
    }
    emit(info)
    n_chunks = math.ceil(E / cfg.chunk_size)
    problems = []
    if info["max_load"] > out.max_load:
        problems.append(f"max load {info['max_load']} > cap {out.max_load}")
    problems += _audit_problems("s5p", info["game_audit"])
    if launches["cluster_scan"] != n_chunks or launches["assign_scan"] != n_chunks:
        problems.append(f"K1/K2 launches {launches} != {n_chunks} chunks")
    if launches["cms_update"] < 1 or launches["cms_query"] < 1:
        problems.append(f"CMS kernels not launched: {launches}")
    game_k5 = 2 + out.aux["game"]["ordered_sums"]  # the degrees, then the ordered sums
    if launches["segment_agg"] != game_k5:
        problems.append(f"K5 launched {launches['segment_agg']} times by the game, not "
                        f"{game_k5}")
    p = parts.cpu().numpy()
    if p.shape != (E,) or p.min() < 0 or p.max() >= cfg.k:
        problems.append("parts outside [0, k) on a graph without self-loops")
    if not math.isfinite(info["rf"]) or not 1.0 <= info["rf"] <= cfg.k:
        problems.append(f"RF {info['rf']} outside [1, k]")
    if problems:
        raise SystemExit("chip_smoke main path failed: " + "; ".join(problems))
    return {"info": info, "out": out, "src": src, "dst": dst, "n": n,
            "launches": launches, "cfg": cfg}


def first_diff(got, want, names) -> str | None:
    """The first leaf and index where two sequences of tensors differ."""
    import torch

    for name, a, b in zip(names, got, want):
        if a is None and b is None:
            continue
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape:
            return f"leaf {name}: shape {tuple(a.shape)} vs {tuple(b.shape)}"
        if not torch.equal(a, b):
            i = int((a.reshape(-1) != b.reshape(-1)).nonzero()[0])
            return f"leaf {name} index {i}: {int(a.reshape(-1)[i])} vs {int(b.reshape(-1)[i])}"
    return None


def twice(run, reset, outs) -> bool:
    """Whether two launches from one state give the same bits: ``run``
    launches, ``outs()`` lists what it left."""
    import torch

    reset()
    run()
    first = [t.clone() for t in outs() if t is not None]
    reset()
    run()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, [t for t in outs() if t is not None]))


def main_chunk(main, c: int):
    """Chunk ``c`` of the main stream (65,536 edges; no chunk but the last
    is padded) on the card."""
    import torch

    L = 1 << 16
    return (torch.from_numpy(main["src"][c * L:(c + 1) * L]).cuda(),
            torch.from_numpy(main["dst"][c * L:(c + 1) * L]).cuda())


def _k1_row(label, state0, src, dst, degrees, kw, rt, launches, shape) -> dict:
    """K1 on card tensors from ``state0`` against the plain fold on the same
    inputs, bitwise, and two launches against each other."""
    import torch

    from repro_torch.core.clustering import ClusterState
    from repro_torch.kernels.stream_scan import cluster_chunk_oracle, cluster_scan
    from repro_torch.kernels.stream_scan.latency import latency_bound_ms

    E = int(src.numel())
    work = [t.clone() for t in state0]

    def reset():
        for w, t in zip(work, state0):
            w.copy_(t)

    def run():
        cluster_scan(tuple(work), src, dst, degrees, **kw)

    ms = cuda_time_ms(run, reps=3, setup=reset)
    same = twice(run, reset, lambda: work)
    plain_state = tuple(t.cpu() for t in state0)
    cpu_args = (src.cpu(), dst.cpu(), degrees.cpu())
    want = {}

    def run_plain():
        want["out"] = cluster_chunk_oracle(tuple(t.clone() for t in plain_state),
                                           *cpu_args, **kw)

    plain_ms = host_time_ms(run_plain)
    diff = first_diff(work, want["out"], ClusterState._fields)
    err = max(max_abs_err(g, w) for g, w in zip(work, want["out"]))
    uniq = int(torch.unique(torch.cat([src, dst])).numel())
    n_bytes = 8 * E + uniq * (7 * 4 + 6 * 4 + 4 * 4)
    b, by = bound_ms(n_bytes, 60 * E)
    return {"name": label, "route": "cuda",
            "source": "src/repro_torch/kernels/stream_scan/csrc/stream_scan.cu",
            "replaces": "src/repro/kernels/stream_scan/kernel.py:467",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None, "latency_bound_ms": latency_bound_ms("K1", E, rt),
            "shape": {"V": int(degrees.shape[0]), "chunk": E, "distinct_vertices": uniq,
                      "new_head_ids": int(want["out"][5]) - int(state0[5]),
                      "new_tail_ids": int(want["out"][6]) - int(state0[6]),
                      "bitwise": diff is None and same, "first_diff": diff,
                      "equal_on_two_launches": same, "xi": kw["xi"], "kappa": kw["kappa"],
                      "global_tail": kw["global_tail"], **shape}}


def check_k1(main, rt) -> list[dict]:
    """K1 where the main path and the baselines run it: 65,536-edge chunks
    from the empty state and from the state after half the chunks, under
    S5P's ξ and κ, S5P-B's global tail at κ = 2^31 - 1, 2PS-L's ξ = -1 (all
    head) and CLUGP's ξ (all tail); and 4,096 edges onto the main run's
    final state.  The first row is the main path's chunk."""
    import torch

    from repro_torch.core.clustering import init_state
    from repro_torch.kernels.stream_scan import cluster_scan

    out, cfg, n = main["out"], main["cfg"], main["n"]
    inc = out.aux["incremental"]
    degrees = inc["degrees"]
    E_all = int(main["src"].shape[0])
    mid = math.ceil(E_all / (1 << 16)) // 2
    kappa = max(math.ceil(2.0 * E_all / cfg.k), 2)
    variants = [("S5P", out.xi, out.kappa, cfg.bounded, ("mid", "empty")),
                ("S5P-B", out.xi, 2**31 - 1, True, ("mid", "empty")),
                ("2PS-L xi=-1", -1, kappa, False, ("mid", "empty")),
                ("CLUGP xi=2^31-2", 2**31 - 2, kappa, False, ("mid",))]
    launches = main["launches"]["cluster_scan"]
    rows = []
    for name, xi, kap, gt, states in variants:
        kw = dict(xi=xi, kappa=kap, global_tail=gt)
        state = tuple(init_state(n, "cuda"))
        snaps = {"empty": tuple(t.clone() for t in state)}
        for c in range(mid):
            cluster_scan(state, *main_chunk(main, c), degrees, **kw)
        snaps["mid"] = state
        for st in states:
            c = mid if st == "mid" else 0
            rows.append(_k1_row(f"K1 cluster_scan (Alg. 1 fold) {name}, {st} state",
                                snaps[st], *main_chunk(main, c), degrees, kw, rt,
                                launches, {"variant": name, "state": st, "chunk_index": c}))
        del state, snaps
    E = 4096
    src, dst = (torch.from_numpy(a[:E]).cuda() for a in (main["src"], main["dst"]))
    kw = dict(xi=out.xi, kappa=out.kappa, global_tail=cfg.bounded)
    rows.append(_k1_row("K1 cluster_scan (Alg. 1 fold) S5P, 4,096 edges, final state",
                        inc["cluster_state"], src, dst, degrees, kw, rt, launches,
                        {"variant": "S5P", "state": "final", "chunk_index": 0}))
    rows.append(_k1_merged_row(main, degrees, kappa, mid, rt, launches))
    return rows


def _k1_merged_row(main, degrees, kappa, mid, rt, launches) -> dict:
    """K1 from a merge base whose id counters passed V + 1 (ROADMAP Queue 3
    j at scale): 16 clustering lanes (range) merged every chunk over the
    main stream's first ``mid`` chunks, every edge tail (CLUGP's ξ), then
    chunk ``mid`` folded from that base on the card and by the plain fold."""
    import torch

    from repro_torch.core.clustering import ClusterCarry
    from repro_torch.streaming import EdgeStream, run_parallel

    n, L = main["n"], 1 << 16
    kw = dict(xi=2**31 - 2, kappa=kappa, global_tail=False)
    head = EdgeStream(main["src"][:mid * L], main["dst"][:mid * L], n, chunk_size=L,
                      device="cuda")
    _, base = run_parallel(head, ClusterCarry(degrees, n, **kw), num_streams=16,
                           super_chunk=1, shard="range")
    src, dst = main_chunk(main, mid)
    touched = torch.unique(torch.cat([src, dst])).long()
    info = {"variant": "CLUGP xi, 16 range lanes merged every chunk", "state": "merged",
            "chunk_index": mid, "V": n, "next_h": int(base.next_h),
            "next_t": int(base.next_t),
            "chunk_vertices_with_ids_past_V": int((base.v2c_t[touched] > n).sum())}
    if info["next_t"] <= n + 1:
        raise SystemExit(f"chip_smoke: the merged lanes' id counter did not pass V + 1: {info}")
    return _k1_row("K1 cluster_scan (Alg. 1 fold) CLUGP, merge base past V + 1", tuple(base),
                   src, dst, degrees, kw, rt, launches, info)


INT32_MAX = 2**31 - 1


def k2_cases(main, step=None) -> list[dict]:
    """K2's inputs where the main path meets it, and its rare cases.

    The main path's placement (S5P's postprocess: ``_edge_clusters``, the
    65,536-edge chunks of the stream padded with (0, 0) and zero extras, the
    ``c2p`` gathers) is replayed chunk by chunk from zero loads through
    ``step(load, chunk) -> (parts, load)`` (the port's ``assign_scan`` by
    default); its final loads must equal the main run's.  Cases, each a
    dict of card tensors: the first, the middle and the last (padded)
    chunk, 0, 120 and 239 at scale 20, with the loads before them; 4,096 edges of chunk 0 onto the final loads; chunk 0 with no room
    from the start (the final loads raised to the cap); chunk 0 under the
    wrap guard (cap 2^31 - 1, loads within 2,048 of it); the last chunk
    retracted from the final loads (n_valid < E); and 4,096 edges at k = 8
    and 256 with partitions from a seed and loads at cap - 64 … cap + 2."""
    import numpy as np
    import torch

    from repro_torch.core.s5p import _edge_clusters
    from repro_torch.kernels.stream_scan import assign_scan
    from repro_torch.streaming import EdgeStream

    out, cfg = main["out"], main["cfg"]
    inc = out.aux["incremental"]
    k, cap = cfg.k, out.max_load
    s_all = torch.from_numpy(main["src"]).cuda()
    d_all = torch.from_numpy(main["dst"]).cuda()
    cu, cv, head = _edge_clusters(s_all, d_all, inc["compact"], inc["degrees"], out.xi)
    cu, cv = cu.clamp(min=0), cv.clamp(min=0)
    c2p = torch.from_numpy(out.cluster_assignment).cuda()
    stream = EdgeStream(main["src"], main["dst"], main["n"], chunk_size=cfg.chunk_size,
                        device="cuda")
    if step is None:
        def step(load, x):
            return assign_scan(load, x["src"], x["dst"], x["head"], x["pcu"], x["pcv"],
                               max_load=cap)
    load = torch.zeros(k, dtype=torch.int32, device="cuda")
    picked = (0, stream.n_chunks // 2, stream.n_chunks - 1)
    chunks = {}
    for c in range(stream.n_chunks):
        ch = stream.chunk_at(c, head, cu, cv)
        h, a, b = ch.extras
        x = {"src": ch.src, "dst": ch.dst, "head": h, "pcu": c2p[a.long()].contiguous(),
             "pcv": c2p[b.long()].contiguous(), "n_valid": ch.n_valid, "chunk_index": c}
        if c in picked:
            chunks[c] = {**x, "load": load.clone()}
        parts, load = step(load, x)
        if c in picked:
            chunks[c]["parts"] = parts
    final = load
    if not torch.equal(final, inc["load"]):
        raise SystemExit("chip_smoke: K2's replay of the main path ends at other loads "
                         "than the main run")

    def case(name, x, load0, *, cap=cap, sign=1, n=None, state):
        n = int(x["src"].numel()) if n is None else n
        t = {f: x[f][:n].contiguous() for f in ("src", "dst", "head", "pcu", "pcv")}
        return {"name": name, "k": int(load0.numel()), "cap": cap, "load": load0.clone(),
                "sign": sign, "state": state, "chunk_index": x.get("chunk_index"),
                "parts": x.get("parts") if sign < 0 else None,
                "n_valid": x["n_valid"] if sign < 0 else None,
                "restores": x["load"] if sign < 0 else None, **t}

    c0 = chunks[0]
    last = chunks[picked[-1]]
    cases = [case(f"chunk {c}", chunks[c], chunks[c]["load"], state=f"before chunk {c}")
             for c in picked]
    cases.append(case("4,096 edges, final state", c0, final, n=4096, state="final"))
    cases.append(case("no room", c0, torch.clamp(final, min=cap), state="final, raised to cap"))
    wrap = INT32_MAX - (torch.arange(k, device="cuda", dtype=torch.int32) * 131) % 2048
    cases.append(case("wrap guard", c0, wrap, cap=INT32_MAX, state="cap - (131 j mod 2048)"))
    cases.append(case(f"retract chunk {last['chunk_index']}", last, final, sign=-1,
                      state="final"))
    for kk in (8, 256):
        rng = np.random.default_rng(kk)
        E = 4096
        cap_k = math.ceil(int(main["src"].shape[0]) / kk)
        x = {"src": c0["src"][:E], "dst": c0["dst"][:E],
             "head": torch.from_numpy(rng.random(E) < 0.3).cuda(),
             "pcu": torch.from_numpy(rng.integers(0, kk, E).astype(np.int32)).cuda(),
             "pcv": torch.from_numpy(rng.integers(0, kk, E).astype(np.int32)).cuda(),
             "n_valid": E, "chunk_index": 0}
        load_k = torch.from_numpy(rng.integers(cap_k - 64, cap_k + 3, kk).astype(np.int32))
        cases.append(case("4,096 edges, partitions from a seed", x, load_k.cuda(), cap=cap_k,
                          state="cap - 64 … cap + 2 from a seed"))
    return cases


def k2_bounds(c: dict, rt) -> dict:
    """K2's bounds on a case: bytes (insert: src, dst, head, pcu, pcv read
    and the parts written, 24 bytes an edge; retract
    ``latency.retract_bytes_bound_ms``) and, for an insert, the latency of
    its chain (``latency.py``'s K2: two shared steps an edge)."""
    from repro_torch.kernels.stream_scan.latency import (latency_bound_ms,
                                                         retract_bytes_bound_ms)

    E, k = int(c["src"].numel()), c["k"]
    if c["sign"] < 0:
        return {"bound_ms": retract_bytes_bound_ms(E, k), "bound_by": "bytes",
                "latency_bound_ms": None}
    b, by = bound_ms(24 * E + 8 * k, 12 * E)
    return {"bound_ms": b, "bound_by": by, "latency_bound_ms": latency_bound_ms("K2", E, rt)}


def check_k2(main, rt) -> list[dict]:
    """K2 on every case of ``k2_cases`` against its plain version, bitwise,
    with equal bits on two launches; each row names its overflow edges
    (placed with both endpoint partitions full) and the edges the plan
    folds in each mode (``ref.assign_chunk_planned``)."""
    import torch

    from repro_torch.kernels.stream_scan import assign_chunk_oracle, assign_scan
    from repro_torch.kernels.stream_scan.ref import assign_chunk_planned

    rows = []
    for c in k2_cases(main):
        E, cap, sign = int(c["src"].numel()), c["cap"], c["sign"]
        cols = [c[f] for f in ("src", "dst", "head", "pcu", "pcv")]
        kw = dict(max_load=cap, sign=sign, parts=c["parts"], n_valid=c["n_valid"])
        load = c["load"].clone()
        got = {}

        def reset():
            load.copy_(c["load"])

        def run():
            got["out"] = assign_scan(load, *cols, **kw)

        ms = cuda_time_ms(run, reps=10, setup=reset)
        same = twice(run, reset, lambda: got["out"])
        cpu = [t.cpu() for t in cols]
        cpu_kw = {**kw, "parts": None if c["parts"] is None else c["parts"].cpu()}
        want = {}

        def run_plain():
            want["out"] = assign_chunk_oracle(c["load"].cpu(), *cpu, **cpu_kw)

        plain_ms = host_time_ms(run_plain)
        stats = {}
        planned = assign_chunk_planned(c["load"].cpu(), *cpu, **cpu_kw, stats=stats)
        diff = first_diff(got["out"], want["out"], ("parts", "load"))
        err = max(max_abs_err(a, b) for a, b in zip(got["out"], want["out"]))
        plan_equal = all(torch.equal(a, b) for a, b in zip(planned, want["out"]))
        shape = {"k": c["k"], "chunk": E, "cap": cap, "sign": sign, "state": c["state"],
                 "chunk_index": c["chunk_index"], "n_valid": c["n_valid"],
                 "bitwise": diff is None and same and plan_equal, "first_diff": diff,
                 "equal_on_two_launches": same, "plan_equal_to_plain": plan_equal}
        if sign > 0:
            shape.update(overflow_edges=stats["overflow"],
                         mode_edges={m: stats[m] for m in ("room", "full", "wrap")},
                         full_partitions_after=int((want["out"][1] >= cap).sum()))
        else:
            # the retracted chunk's loads are the ones before it
            shape["restored"] = bool(torch.equal(got["out"][1], c["restores"]))
            shape["bitwise"] = shape["bitwise"] and shape["restored"]
        bounds = k2_bounds(c, rt)
        shape["latency_bound_ms"] = bounds["latency_bound_ms"]
        rows.append({"name": f"K2 assign_scan (Alg. 3 placement), {c['name']}, k={c['k']}",
                     "route": "cuda",
                     "source": "src/repro_torch/kernels/stream_scan/csrc/stream_scan.cu",
                     "replaces": "src/repro/kernels/stream_scan/kernel.py:581",
                     "launches": main["launches"]["assign_scan"], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds["bound_ms"],
                     "bound_by": bounds["bound_by"], "library_ms": None,
                     "latency_bound_ms": bounds["latency_bound_ms"], "shape": shape})
    return rows


def k4_bounds(n: int, depth: int, width: int, query: bool) -> tuple[float, str]:
    """K4a: the keys and counts (int64) and the seeds read, the table read
    and written once; K4b: the keys and the table read, the int64 estimates
    written.  Operations: the hash, ~11 integer operations a key and row."""
    if query:
        return bound_ms(16 * n + 8 * depth + 4 * depth * width, 11 * n * depth)
    return bound_ms(16 * n + 8 * depth + 8 * depth * width, 11 * n * depth)


def check_cms(main, serve, incremental) -> list[dict]:
    """K4a on the Θ stream's own chunks (the first, the middle and the last
    2^18-key chunk of the main run's and of the serve phase's S5P, replayed
    by ``theta_capture``, each onto the table it found), on a hot-key chunk
    (one key 2^18 times) and on the deduplicated pair list; K4b at the real
    pair count P on each run's final sketch.  Each bitwise against the plain
    version; times of the kernel alone (its C entry point on ready
    operands; K4a onto a scratch copy of the table) and of the whole
    ``core.cms`` call; the floors a
    launch can reach (``latency.measure_launch_floor``: an empty launch,
    and d × keys global atomic adds at the card's rate for distinct
    addresses); ``index_put_(accumulate=True)`` of the same counts at the
    same (hashed) cells as the library call."""
    import torch

    from repro_torch.core.cms import CMSketch, _row_cols, cms_query, cms_update, pair_key
    from repro_torch.kernels import _build
    from repro_torch.kernels.cms_sketch import add_ref, query_ref
    from repro_torch.kernels.cms_sketch import kernel as cms_k
    from repro_torch.kernels.cms_sketch.ref import u32_bits
    from repro_torch.kernels.stream_scan.latency import measure_launch_floor

    main_theta = theta_capture(main["src"], main["dst"], main["out"], main["cfg"])
    if not main_theta["ends_at_run_sketch"]:
        raise SystemExit("chip_smoke: the replayed Θ stream does not end at the main run's sketch")
    seeds, width, d = main_theta["seeds"], main_theta["width"], main_theta["depth"]
    floor = measure_launch_floor(d * width)
    emit({"phase": "k4_floor", **floor})
    launches = main["launches"]
    source = "src/repro_torch/kernels/cms_sketch/csrc/cms_sketch.cu"
    lib, stream = cms_k._lib(), torch.cuda.current_stream().cuda_stream

    def k4a_row(label, keys, counts, table0, seeds, extra):
        depth, w = table0.shape
        n = int(keys.numel())
        scratch = table0.clone()
        ms = cuda_time_ms(lambda: _build.check(lib.cms_update_launch(
            keys.data_ptr(), counts.data_ptr(), seeds.data_ptr(), n, depth, w,
            scratch.data_ptr(), 0, stream), "cms_update"), reps=20,
            setup=lambda: scratch.copy_(table0))
        sketch = CMSketch(table=table0, seeds=seeds)
        call_ms = cuda_time_ms(lambda: cms_update(sketch, keys, counts), reps=20)
        got = cms_update(sketch, keys, counts).table
        kc, sc, cc, tc = keys.cpu(), seeds.cpu(), counts.cpu(), table0.cpu()
        res = {}
        plain = host_time_ms(lambda: res.__setitem__("t", add_ref(tc, kc, sc, cc)))
        cols = _row_cols(keys, seeds, w)
        flat = (torch.arange(depth, device="cuda")[:, None] * w + cols).reshape(-1)
        vals = u32_bits(counts).expand(depth, -1).reshape(-1).contiguous()
        lib_table = table0.clone().reshape(-1)
        lib_ms = cuda_time_ms(lambda: lib_table.index_put_((flat,), vals, accumulate=True),
                              reps=20, setup=lambda: lib_table.copy_(table0.reshape(-1)))
        b, by = k4_bounds(n, depth, w, query=False)
        atomics_ms = depth * n / floor["atomic_adds_per_s"] * 1e3
        uniq = int(torch.unique(cols[0]).numel()) if n else 0
        shape = {"keys": n, "depth": depth, "width": w, "columns_hit_row0": uniq,
                 "blocks_per_row": cms_k.default_blocks_per_row(n, depth, w),
                 "call_ms": call_ms,
                 "floor": {"empty_launch_ms": floor["empty_launch_ms"],
                           "d_keys_atomics_ms": atomics_ms,
                           "floor_ms": max(floor["empty_launch_ms"], atomics_ms)},
                 "bitwise": bool(torch.equal(got.cpu(), res["t"])), **extra}
        return {"name": f"K4a cms_update{label}", "route": "cuda", "source": source,
                "replaces": "src/repro/kernels/cms_sketch/kernel.py:89",
                "launches": launches["cms_update"], "max_abs_err": max_abs_err(got, res["t"]),
                "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
                "library_ms": lib_ms, "shape": shape}

    def k4b_row(label, table, keys, seeds, extra):
        depth, w = table.shape
        n = int(keys.numel())
        sketch = CMSketch(table=table, seeds=seeds)
        got = cms_query(sketch, keys)
        out = torch.empty_like(got)
        ms = cuda_time_ms(lambda: _build.check(lib.cms_query_launch(
            keys.data_ptr(), seeds.data_ptr(), table.data_ptr(), n, depth, w, out.data_ptr(),
            stream), "cms_query"), reps=20)
        call_ms = cuda_time_ms(lambda: cms_query(sketch, keys), reps=20)
        res = {}
        tc, kc, sc = table.cpu(), keys.cpu(), seeds.cpu()
        plain = host_time_ms(lambda: res.__setitem__("q", query_ref(tc, kc, sc)))
        b, by = k4_bounds(n, depth, w, query=True)
        shape = {"keys": n, "depth": depth, "width": w, "call_ms": call_ms,
                 "floor": {"empty_launch_ms": floor["empty_launch_ms"]},
                 "bitwise": bool(torch.equal(got.cpu(), res["q"])), **extra}
        return {"name": f"K4b cms_query{label}", "route": "cuda", "source": source,
                "replaces": "src/repro/kernels/cms_sketch/kernel.py:114",
                "launches": launches["cms_query"], "max_abs_err": max_abs_err(got, res["q"]),
                "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
                "library_ms": None, "shape": shape}

    rows = []
    for run, theta in (("main", main_theta), ("serve", serve["theta"])):
        chunks = theta["chunks"]
        for i in sorted(chunks):
            c = chunks[i]
            label = "" if run == "main" and i == theta["n_chunks"] // 2 else \
                f" ({run} Θ chunk {i} of {theta['n_chunks']})"
            rows.append(k4a_row(label, c["keys"], c["counts"], c["table"], theta["seeds"],
                                {"stream": run, "chunk": i, "n_chunks": theta["n_chunks"],
                                 "n_valid": c["n_valid"]}))
    mid = main_theta["chunks"][main_theta["n_chunks"] // 2]
    hot = torch.full_like(mid["keys"], int(mid["keys"][0]))
    rows.append(k4a_row(" (hot key: one key 2^18 times)", hot, torch.ones_like(hot),
                        mid["table"], seeds, {"stream": "hot key"}))
    pa, pb = main["out"].aux["incremental"]["pair_a"], main["out"].aux["incremental"]["pair_b"]
    N = 1 << 18
    reps = -(-N // pa.numel())
    dedup = pair_key(pa.repeat(reps)[:N], pb.repeat(reps)[:N])
    counts = torch.ones_like(dedup)
    counts[-1000:] = 0  # the padding of a last chunk
    counts[:1000] = -1  # retractions wrap in Z/2^32
    rows.append(k4a_row(" (the deduplicated pair list, 2^18 keys)", dedup, counts,
                        torch.zeros_like(mid["table"]), seeds, {"stream": "dedup pairs"}))
    # negative counts: phase incremental's frac:0.05 deletion retracts its
    # Θ pairs (count -1 each) from the base sketch, which is phase main's
    ra, rb = (torch.from_numpy(x).to("cuda") for x in incremental["retract_pairs"])
    rkeys = pair_key(ra, rb)
    rows.append(k4a_row(" (negative counts: the frac:0.05 deletion's Θ retraction)", rkeys,
                        -torch.ones_like(rkeys), main["out"].aux["sketch"].table,
                        main["out"].aux["sketch"].seeds,
                        {"stream": "phase incremental: decremental Θ retraction"}))
    for run, (a, b), sketch in (("main", (pa, pb), main["out"].aux["sketch"]),
                                ("serve", serve["pairs"], serve["sketch"])):
        label = "" if run == "main" else " (serve: the real pair count P)"
        rows.append(k4b_row(label, sketch.table, pair_key(a, b), sketch.seeds,
                            {"stream": f"{run}: the real pair count P"}))
    rows.sort(key=lambda r: (r["name"].startswith("K4b"), r["name"] not in (
        "K4a cms_update", "K4b cms_query")))
    return rows


def phase_compare(main, clugp_graph) -> dict:
    """Every other partitioner on phase main's graph, CLUGP's on
    ``clugp_graph`` (the R-MAT at ``CLUGP_SCALE``, :func:`make_graphs`)."""
    import torch

    from repro_torch.core.baselines import PARTITIONERS, S5P_BASED
    from repro_torch.core.metrics import gas_comm_bytes, load_balance, partition_loads, replication_factor
    from repro_torch.gas import build_gas_graph, comm_stats, pagerank

    src, dst, n, k = main["src"], main["dst"], main["n"], main["cfg"].k
    dev = torch.device("cuda")
    s_t = torch.from_numpy(src).to(dev)
    d_t = torch.from_numpy(dst).to(dev)
    E = int(src.shape[0])
    n_chunks = math.ceil(E / (1 << 16))
    rows, parts_of, problems = {}, {}, []
    for name, fn in PARTITIONERS.items():
        kw = {"full_output": True} if name in S5P_BASED else {}
        g_src, g_dst, g_n, g_s, g_d = src, dst, n, s_t, d_t
        if name == "clugp":  # its graph cut (CLUGP_SCALE)
            g_src, g_dst, g_n = clugp_graph[0]
            g_s, g_d = torch.from_numpy(g_src).to(dev), torch.from_numpy(g_dst).to(dev)
        if name == "s5p":  # the main run, under the same arguments
            out, dt, launches = main["out"], main["info"]["wall_s"], main["launches"]
        else:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = fn(g_src, g_dst, g_n, k, 0, device=dev, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = launch_counts()
        parts = out.parts if kw else out
        loads = partition_loads(parts, k=k)
        row = {"phase": "compare", "partitioner": name,
               "graph": f"rmat:{int(round(math.log2(g_n)))} edge_factor=16 seed=0",
               "scale": int(round(math.log2(g_n))), "edges": int(g_src.shape[0]),
               "rf": replication_factor(g_s, g_d, parts, n_vertices=g_n, k=k),
               "balance": load_balance(parts, k=k), "max_load": int(loads.max()),
               "gas_comm_bytes": gas_comm_bytes(g_s, g_d, parts, n_vertices=g_n, k=k),
               "seconds": dt, "launches": launches}
        if kw:
            row.update(clusters=out.n_clusters, head_clusters=out.n_head_clusters,
                       game_rounds=out.game_rounds, game_converged=out.game_converged,
                       seconds_by_phase=out.timings)
            if name != "s5p":  # the main run's audit is phase main's
                row["game_audit"] = _game_audit(out, g_src, g_dst)
                problems += _audit_problems(name, row["game_audit"])
                want_k5 = 2 + out.aux["game"]["ordered_sums"]
                if launches["segment_agg"] != want_k5:
                    problems.append(f"{name}: K5 launched {launches['segment_agg']} times, "
                                    f"not {want_k5} (the game's degrees and ordered sums)")
        emit(row)
        rows[name] = row
        parts_of[name] = parts
        if int(parts.min()) < 0 or int(parts.max()) >= k or parts.shape != (len(g_src),):
            problems.append(f"{name}: a part outside [0, {k})")
    for name, kernel in (("greedy", "scoring_scan"), ("hdrf", "scoring_scan"),
                         ("grid", "grid_scan")):
        if rows[name]["launches"][kernel] != n_chunks:
            problems.append(f"{name}: {kernel} launched {rows[name]['launches'][kernel]}"
                            f" times, not once per chunk ({n_chunks})")
    retract = _compare_retract(main, parts_of["hdrf"], s_t, d_t)
    if not retract["restored"] or retract["launches"]["scoring_retract"] != 1:
        problems.append(f"HDRF retract of the last chunk: {retract}")
    pr = {}
    for name in ("s5p", "hdrf"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = build_gas_graph(s_t, d_t, parts_of[name], n, k, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        values, stats = pagerank(g, iterations=10)
        torch.cuda.synchronize()
        pr[name] = {"bytes": stats.total_bytes(), "layout_s": t1 - t0,
                    "supersteps_s": time.perf_counter() - t1,
                    "mirrors_per_step": comm_stats(g).mirror_to_master_msgs,
                    "values": values}
        if not bool(torch.isfinite(values).all()):
            problems.append(f"PageRank on {name}: values not finite")
        if name == "s5p":  # the gather on K5: the same bits again, and the CPU's
            again = pagerank(g, iterations=10)[0]
            del g
            t0 = time.perf_counter()
            g_cpu = build_gas_graph(src, dst, parts_of[name].cpu(), n, k, device="cpu")
            on_cpu = pagerank(g_cpu, iterations=10)[0]
            pr[name].update(bitwise_repeat=bool(torch.equal(values, again)),
                            bitwise_cpu=bool(torch.equal(values.cpu(), on_cpu)),
                            cpu_s=time.perf_counter() - t0)
            del g_cpu
            if not (pr[name]["bitwise_repeat"] and pr[name]["bitwise_cpu"]):
                problems.append(f"PageRank on the card: repeat bitwise "
                                f"{pr[name]['bitwise_repeat']}, the CPU's bits "
                                f"{pr[name]['bitwise_cpu']}")
    # PageRank is replica-exact, so its values do not depend on the cut;
    # each cut's replica rows sum the float32 terms in another order, so
    # the two agree to a relative 1e-4
    a, b = pr["s5p"]["values"], pr["hdrf"]["values"]
    pr_diff = float(((a - b).abs() / torch.maximum(a.abs(), b.abs())).max())
    if pr_diff > 1e-4:
        problems.append(f"PageRank values differ between cuts by {pr_diff} (relative)")
    info = {"phase": "pagerank", "iterations": 10,
            "s5p_bytes": pr["s5p"]["bytes"], "hdrf_bytes": pr["hdrf"]["bytes"],
            "s5p_over_hdrf": pr["s5p"]["bytes"] / pr["hdrf"]["bytes"],
            "s5p_layout_s": pr["s5p"]["layout_s"], "s5p_supersteps_s": pr["s5p"]["supersteps_s"],
            "hdrf_layout_s": pr["hdrf"]["layout_s"],
            "hdrf_supersteps_s": pr["hdrf"]["supersteps_s"],
            "s5p_bitwise_repeat": pr["s5p"]["bitwise_repeat"],
            "s5p_bitwise_cpu": pr["s5p"]["bitwise_cpu"], "s5p_cpu_s": pr["s5p"]["cpu_s"],
            "max_rel_value_diff": pr_diff}
    emit(info)
    if problems:
        raise SystemExit("chip_smoke compare phase failed: " + "; ".join(problems))
    main["compare_rf"] = {name: r["rf"] for name, r in rows.items()}
    main["compare_s"] = {name: r["seconds"] for name, r in rows.items()}
    return {"rows": rows, "pagerank": info, "parts": parts_of, "retract": retract,
            "launches": {name: r["launches"] for name, r in rows.items()}}


def _touch_up_audit(out) -> dict:
    """The touch-up's masked game against the same limits as the game's
    (``_game_audit``): every (stage, window) it visits that holds a row of
    exact degree ≥ 2**24 must be a hub batch, and the partition sizes must
    be below 2**23 in all or guarded with the sizes in order where a
    guarded total reached 2**23."""
    import numpy as np
    import torch

    from repro_torch.core import game as G

    tu = out.aux.get("touch_up", {})
    game = tu.get("game")
    if game is None:
        return {"ran": False}
    st = out.aux["incremental"]
    pa, pb, pw, sizes = st["pair_a"], st["pair_b"], st["pair_w"], st["sizes"]
    C = out.n_clusters
    w64 = pw.double()
    deg = torch.zeros(C + 1, dtype=torch.float64, device=pw.device)
    deg = deg.index_add(0, pa.long().clamp(max=C), w64).index_add(
        0, pb.long().clamp(max=C), w64)[:C]
    hub = np.zeros(C, bool)
    hub[torch.nonzero(deg >= G.W_LIMIT)[:, 0].cpu().numpy()] = True
    move, bs = game["move_mask"], game["batch_size"]
    lead = np.arange(C) < out.n_head_clusters
    expected = 0
    for role in (lead & move, ~lead & move):
        for b in np.unique(np.nonzero(move)[0] // bs):
            lo, hi = int(b) * bs, min(int(b) * bs + bs, C)
            expected += bool(role[lo:hi].any() and hub[lo:hi].any())
    sum_sizes = float(sizes.double().sum())
    ok_sizes = sum_sizes < G.SIZE_LIMIT or (game["size_guard"] and (
        game["max_part_size"] < G.SIZE_LIMIT or game["ordered_rounds"] > 0))
    return {"ran": True, "movable_clusters": int(move.sum()),
            "hub_batches": game["hub_batches"], "hub_batches_expected": expected,
            "ordered_sums": game["ordered_sums"], "size_guard": game["size_guard"],
            "replayed_rounds": game["replayed_rounds"],
            "ordered_rounds": game["ordered_rounds"],
            "w_sums_ordered_or_below_2^24": game["hub_batches"] == expected,
            "part_sizes_below_2^23_or_replayed": ok_sizes}


def phase_parallel(main) -> dict:
    """Parallel ingest at S = 8 lanes on the main path's graph and k: S5P
    (hub lanes, ``super_chunk="auto"``, the touch-up), HDRF on both
    backends (equal bits), Greedy (range lanes, super-chunk 8) and the
    degree count (hub lanes), each with the launch counters set to 0 just
    before and read just after."""
    import torch

    from repro_torch.core.baselines import greedy_partition
    from repro_torch.core.clustering import compute_degrees, compute_degrees_stream
    from repro_torch.core.metrics import load_balance, partition_loads, replication_factor
    from repro_torch.core.s5p import S5PConfig, s5p_partition, theta_pairs
    from repro_torch.kernels.stream_scan import HdrfCarry
    from repro_torch.streaming import EdgeStream, ParallelEdgeStream, last_ingest_stats, run_parallel

    src, dst, n, k = main["src"], main["dst"], main["n"], main["cfg"].k
    dev = torch.device("cuda")
    E = int(src.shape[0])
    S, B = 8, 1 << 16
    n_chunks = math.ceil(E / B)
    s_t = torch.from_numpy(src).to(dev)
    d_t = torch.from_numpy(dst).to(dev)
    problems, info = [], {"phase": "parallel", "num_streams": S, "E": E, "k": k}

    def drive(fn):
        """Run ``fn`` with the counters at 0; returns (result, seconds,
        launches, the peak memory beyond what was allocated before)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return (got, time.perf_counter() - t0, launch_counts(),
                torch.cuda.max_memory_allocated() - before)

    def check_parts(name, parts):
        p = parts.cpu().numpy()
        if p.shape != (E,) or p.min() < 0 or p.max() >= k:
            problems.append(f"{name}: parts outside [0, {k}) on a graph without self-loops")

    # ---- S5P, hub lanes, auto cadence, the touch-up ----
    cfg = S5PConfig(k=k, num_streams=S, shard="hub", super_chunk="auto")
    out, wall, launches, peak = drive(lambda: s5p_partition(src, dst, n, cfg, device=dev))
    check_parts("s5p", out.parts)
    loads = partition_loads(out.parts, k=k)
    load = out.aux["incremental"]["load"]
    # the same plan on a new stream: the hub plan's launches and seconds
    # alone (K4a and K4b twice per stream chunk)
    stream = EdgeStream(src, dst, n, chunk_size=B, device=dev)
    ps, plan_wall, plan_launches, _ = drive(lambda: ParallelEdgeStream(stream, S, shard="hub"))
    plan_chunks = sum(len(lane) for lane in ps.lanes)
    if plan_launches["cms_update"] != 2 * n_chunks or plan_launches["cms_query"] != 2 * n_chunks:
        problems.append(f"the hub plan launched K4a/K4b {plan_launches}, not {2 * n_chunks} each")
    tu = {key: v for key, v in out.aux.get("touch_up", {}).items() if key != "game"}
    replay_chunks = math.ceil(tu.get("replayed_edges", 0) / B)
    st = out.aux["incremental"]
    pairs, _ = theta_pairs(s_t, d_t, st["compact"], st["degrees"], out.xi)
    theta_chunks = math.ceil(pairs.size / (1 << 18))
    tu_game = out.aux.get("touch_up", {}).get("game")
    want = {"cluster_scan": plan_chunks, "assign_scan": plan_chunks + replay_chunks,
            "cms_update": 2 * n_chunks + theta_chunks, "cms_query": 2 * n_chunks + 1,
            "segment_agg": 2 + out.aux["game"]["ordered_sums"] + (
                2 + tu_game["ordered_sums"] if tu_game else 0)}
    rf = replication_factor(s_t, d_t, out.parts, n_vertices=n, k=k)
    audit = _game_audit(out, src, dst)
    tu_audit = _touch_up_audit(out)
    row = {"step": "s5p", "shard": "hub", "super_chunk": "auto",
           "rf": rf, "rf_sequential": main["info"]["rf"], "rf_over_sequential": rf / main["info"]["rf"],
           "balance": load_balance(out.parts, k=k), "max_load": int(loads.max()),
           "max_load_cap": out.max_load, "max_load_over_cap": int(loads.max()) - out.max_load,
           "load_equals_bincount": bool(torch.equal(load, loads)),
           "clusters": out.n_clusters, "head_clusters": out.n_head_clusters,
           "clusters_sequential": main["info"]["clusters"],
           "game_rounds": out.game_rounds, "game_converged": out.game_converged,
           "seconds": out.timings, "wall_s": wall,
           "seconds_sequential": main["info"]["seconds"],
           "parallel_ingest": out.aux["parallel_ingest"], "touch_up": tu,
           "launches": launches, "launches_expected": want, "plan_chunks": plan_chunks,
           "hub_plan_s": plan_wall, "hub_plan_launches": plan_launches,
           "hubs": ps.n_hubs, "hub_threshold": ps.hub_threshold,
           "max_memory_allocated": peak, "game_audit": audit, "touch_up_audit": tu_audit}
    emit({"phase": "parallel", **row})
    info["s5p"] = row
    if not row["load_equals_bincount"]:
        problems.append("s5p: the final load is not the bincount of the parts")
    for key, v in want.items():
        if launches[key] != v:
            problems.append(f"s5p: {key} launched {launches[key]} times, not {v}")
    problems += _audit_problems("s5p S=8", audit)
    if tu_audit.get("ran"):
        for key in ("w_sums_ordered_or_below_2^24", "part_sizes_below_2^23_or_replayed"):
            if not tu_audit[key]:
                problems.append(f"s5p S=8: the touch-up audit fails {key}: {tu_audit}")
    if not math.isfinite(rf) or not 1.0 <= rf <= k:
        problems.append(f"s5p S=8: RF {rf} outside [1, k]")
    del out

    # ---- HDRF, hub lanes, auto cadence: threads and vmap, equal bits ----
    hd = {}
    for backend in ("threads", "vmap"):
        pc = HdrfCarry(n, k, device=dev)
        (parts, carry), wall, launches, peak = drive(lambda: run_parallel(
            stream, pc, num_streams=S, super_chunk="auto", shard="hub", backend=backend))
        ing = last_ingest_stats()
        check_parts(f"hdrf {backend}", parts)
        hd[backend] = (parts, carry)
        plan = sum(lane.chunks for lane in ing.lanes)
        r = {"step": "hdrf", "backend": backend, "shard": "hub", "super_chunk": "auto",
             "rf": replication_factor(s_t, d_t, parts, n_vertices=n, k=k),
             "rf_sequential": main["compare_rf"]["hdrf"],
             "max_load": int(partition_loads(parts, k=k).max()), "wall_s": wall,
             "seconds_sequential": main["compare_s"]["hdrf"], "launches": launches,
             "plan_chunks": plan, "merges": len(ing.schedule),
             "schedule": _compress(ing.schedule),
             "lanes": [vars(lane) for lane in ing.lanes], "max_memory_allocated": peak}
        emit({"phase": "parallel", **r})
        info[f"hdrf_{backend}"] = r
        if backend == "threads":
            main["hdrf_hub_s"] = wall
        if launches["scoring_scan"] != plan:
            problems.append(f"hdrf {backend}: K3 launched {launches['scoring_scan']} times, "
                            f"not once per plan chunk ({plan})")
    same = torch.equal(hd["threads"][0], hd["vmap"][0]) and all(
        torch.equal(a, b) for a, b in zip(hd["threads"][1][:3], hd["vmap"][1][:3]))
    info["hdrf_threads_equal_vmap"] = same
    if not same:
        problems.append("hdrf: the threads and vmap backends differ")
    main["hdrf_hub_parts"] = hd["threads"][0].cpu()  # phase ooc's reference
    del hd

    # ---- Greedy, range lanes, super-chunk 8 ----
    parts, wall, launches, peak = drive(lambda: greedy_partition(
        src, dst, n, k, stream=stream, num_streams=S, super_chunk=8, shard="range"))
    check_parts("greedy", parts)
    r = {"step": "greedy", "shard": "range", "super_chunk": 8,
         "rf": replication_factor(s_t, d_t, parts, n_vertices=n, k=k),
         "rf_sequential": main["compare_rf"]["greedy"], "wall_s": wall,
         "seconds_sequential": main["compare_s"]["greedy"], "launches": launches,
         "merges": len(last_ingest_stats().schedule), "max_memory_allocated": peak}
    emit({"phase": "parallel", **r})
    info["greedy"] = r
    if launches["scoring_scan"] != n_chunks:
        problems.append(f"greedy: K3 launched {launches['scoring_scan']} times, not {n_chunks}")

    # ---- the degree count, hub lanes (the plan built above): equal to
    # compute_degrees ----
    deg, wall, launches, _ = drive(lambda: compute_degrees_stream(stream, S, "auto", "hub"))
    exact = bool(torch.equal(deg, compute_degrees(s_t, d_t, n)))
    r = {"step": "degrees", "shard": "hub", "equal_compute_degrees": exact, "wall_s": wall,
         "launches": launches}
    emit({"phase": "parallel", **r})
    info["degrees"] = r
    if not exact:
        problems.append("degrees at S=8 (hub) differ from compute_degrees")
    if launches["cms_update"] or launches["cms_query"]:
        problems.append(f"the cached hub plan launched K4a/K4b again: {launches}")
    if problems:
        raise SystemExit("chip_smoke parallel phase failed: " + "; ".join(problems))
    return info


def phase_ooc(main) -> dict:
    """Out-of-core ingest on the main path's graph and k: the edges written
    as shards of 2^20 edges, S5P under the default ``S5PConfig`` from a
    natural ``ShardedEdgeStream`` (its parts and launch counts must equal
    phase main's), HDRF at 8 hub lanes (auto) from disk (its parts must
    equal phase parallel's: the hub plan pages through ``_edges_at``), and
    at R-MAT scale 14 HDRF from disk under the shuffled, dst-sorted and
    windowed orderings (each equal to the in-memory stream's parts on the
    card); each run with the launch counters set to 0 just before and read
    just after, each stream's ``budget.peak_bytes`` beside the edge list's
    8·E bytes.  The shards live under ``build/`` and are removed after."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core.baselines import hdrf_partition
    from repro_torch.core.s5p import s5p_partition
    from repro_torch.graphs import rmat_graph
    from repro_torch.streaming import (EdgeStream, ShardedEdgeStream, last_ingest_stats,
                                       read_manifest, write_shards)

    src, dst, n, cfg = main["src"], main["dst"], main["n"], main["cfg"]
    k, E, B, S = cfg.k, int(src.shape[0]), cfg.chunk_size, 8
    n_chunks = math.ceil(E / B)
    dev = torch.device("cuda")
    root = os.path.join(ROOT, "build", "chip_smoke_ooc")
    shutil.rmtree(root, ignore_errors=True)
    problems, info = [], {"phase": "ooc", "E": E, "k": k, "edge_list_bytes": 8 * E}

    def drive(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0, launch_counts()

    try:
        t0 = time.perf_counter()
        man = write_shards(os.path.join(root, "main"), src, dst, n_vertices=n)
        meta = read_manifest(man)[1]
        info.update(write_shards_s=time.perf_counter() - t0, shards=len(meta["shards"]),
                    shard_edges=meta["shard_edges"],
                    shard_bytes=sum(os.path.getsize(os.path.join(root, "main", f))
                                    for f in os.listdir(os.path.join(root, "main"))))
        emit({"phase": "ooc", "step": "write_shards", **info})

        # ---- S5P from disk, natural: phase main's bits and launches ----
        with ShardedEdgeStream(man, chunk_size=B, device=dev) as st:
            out, wall, launches = drive(lambda: s5p_partition(src, dst, n, cfg, stream=st))
            peak = st.budget.peak_bytes
        row = {"step": "s5p natural",
               "parts_equal_main": bool(torch.equal(out.parts, main["out"].parts)),
               "assignment_equal_main": bool(np.array_equal(out.cluster_assignment,
                                                            main["out"].cluster_assignment)),
               "game_rounds": out.game_rounds, "seconds": out.timings, "wall_s": wall,
               "seconds_main": main["info"]["seconds"], "wall_s_main": main["info"]["wall_s"],
               "peak_bytes": peak, "peak_over_edge_list": peak / (8 * E),
               "launches": launches, "launches_main": main["launches"]}
        emit({"phase": "ooc", **row})
        info["s5p"] = row
        if not (row["parts_equal_main"] and row["assignment_equal_main"]):
            problems.append("s5p from disk differs from phase main")
        if launches != main["launches"]:
            problems.append(f"s5p from disk launched {launches}, phase main {main['launches']}")
        del out

        # ---- HDRF, 8 hub lanes, auto, from disk: phase parallel's bits ----
        with ShardedEdgeStream(man, chunk_size=B, device=dev) as st:
            parts, wall, launches = drive(lambda: hdrf_partition(
                None, None, n, k, stream=st, num_streams=S, super_chunk="auto", shard="hub"))
            peak = st.budget.peak_bytes
        plan = sum(lane.chunks for lane in last_ingest_stats().lanes)
        row = {"step": "hdrf hub", "num_streams": S,
               "parts_equal_parallel": bool(torch.equal(parts.cpu(), main["hdrf_hub_parts"])),
               "wall_s": wall, "wall_s_parallel": main["hdrf_hub_s"], "plan_chunks": plan,
               "peak_bytes": peak, "peak_over_edge_list": peak / (8 * E), "launches": launches}
        emit({"phase": "ooc", **row})
        info["hdrf_hub"] = row
        if not row["parts_equal_parallel"]:
            problems.append("hdrf at 8 hub lanes from disk differs from phase parallel")
        if (launches["scoring_scan"] != plan or launches["cms_update"] != 2 * n_chunks
                or launches["cms_query"] != 2 * n_chunks):
            problems.append(f"hdrf hub from disk launched {launches}: K3 not once per plan "
                            f"chunk ({plan}) or the plan's K4a/K4b not {2 * n_chunks} each")
        del parts

        # ---- R-MAT scale 14: the reorderings from disk against memory ----
        s14, d14, n14 = rmat_graph(14, edge_factor=16, a=0.57, b=0.19, c=0.19, seed=0)
        man14 = write_shards(os.path.join(root, "rmat14"), s14, d14, shard_edges=1 << 16,
                             n_vertices=n14)
        B14 = 1 << 14
        info["rmat14"] = {"E": int(s14.size), "shard_edges": 1 << 16, "chunk": B14}
        for ordering in ("shuffled", "dst-sorted", "windowed"):
            kw = dict(chunk_size=B14, ordering=ordering, seed=0, window=4096)
            want = hdrf_partition(None, None, n14, k,
                                  stream=EdgeStream(s14, d14, n14, device=dev, **kw))
            t0 = time.perf_counter()
            st = ShardedEdgeStream(man14, scratch_dir=os.path.join(root, "scratch"),
                                   device=dev, **kw)
            open_s = time.perf_counter() - t0  # the reorder pass and its spills
            with st:
                got, wall, launches = drive(
                    lambda: hdrf_partition(None, None, n14, k, stream=st))
                peak = st.budget.peak_bytes
            row = {"step": f"hdrf rmat:14 {ordering}", "open_s": open_s, "wall_s": wall,
                   "parts_equal_memory": bool(torch.equal(want, got)), "peak_bytes": peak,
                   "peak_over_edge_list": peak / (8 * s14.size), "launches": launches}
            emit({"phase": "ooc", **row})
            info[f"hdrf_{ordering}"] = row
            if not row["parts_equal_memory"]:
                problems.append(f"hdrf from disk ({ordering}) differs from memory")
            if launches["scoring_scan"] != math.ceil(s14.size / B14):
                problems.append(f"hdrf {ordering}: K3 launched {launches['scoring_scan']} times")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise SystemExit("chip_smoke ooc phase failed: " + "; ".join(problems))
    return info


def _incremental_game_audit(bundle, games) -> dict:
    """The settle and refine games of one delta or deletion
    (``pipeline.last_games``) against the float32 limits of
    ``_game_audit``.  A masked game visits only the windows of
    ``batch_size`` ids that hold a movable cluster, leaders' stages first:
    every visited stage that holds a cluster whose exact degree (float64
    over the bundle's pairs) reaches 2**24 must be one of the game's hub
    batches, and Σ sizes at or past 2**23 needs the size guard, with an
    ordered round wherever a guarded total reached 2**23."""
    import numpy as np

    from repro_torch.core import game as G

    sizes = np.asarray(bundle["sizes"], np.float64)
    C = sizes.size
    w = np.asarray(bundle["pair_w"], np.float64)
    deg = (np.bincount(bundle["pair_a"], w, minlength=C)
           + np.bincount(bundle["pair_b"], w, minlength=C))[:C]
    hub_rows = np.flatnonzero(deg >= G.W_LIMIT)
    sum_sizes = float(sizes.sum())
    out = []
    for g in games:
        bs, lead, move = g["batch_size"], g["leader_mask"], g["move_mask"]
        spans = [(int(b) * bs, min(int(b) * bs + bs, C))
                 for role in (lead & move, ~lead & move)
                 for b in np.unique(np.flatnonzero(move) // bs) if role[b * bs:b * bs + bs].any()]
        hub_spans = sum(int(np.searchsorted(hub_rows, lo) < np.searchsorted(hub_rows, hi))
                        for lo, hi in spans)
        played = g["rounds"] > 0
        rep = {key: v for key, v in g.items() if key not in ("leader_mask", "move_mask")}
        out.append({**rep, "movable": int(move.sum()), "stages": len(spans),
                    "hub_stages_expected": int(hub_spans),
                    "w_sums_ordered_or_below_2^24": bool(not played
                                                         or g["hub_batches"] == hub_spans),
                    "part_sizes_below_2^23_or_replayed": bool(
                        not played or sum_sizes < G.SIZE_LIMIT or (
                            g["size_guard"] and (g["max_part_size"] < G.SIZE_LIMIT
                                                 or g["ordered_rounds"] > 0)))})
    return {"max_cluster_degree": float(deg.max(initial=0.0)), "hub_rows": int(hub_rows.size),
            "sum_sizes": sum_sizes, "games": out,
            "ok": all(x["w_sums_ordered_or_below_2^24"]
                      and x["part_sizes_below_2^23_or_replayed"] for x in out)}


def _game_k5(games) -> int:
    """K5 launches the games make: the cluster degrees twice, then one per
    ordered sum (a game with no movable cluster returns before any)."""
    return sum(2 + g["ordered_sums"] for g in games if g["rounds"] > 0)


def phase_incremental(main, compare, seed1) -> dict:
    """Dynamic re-partitioning at phase main's scale (``repro_torch.incremental``):
    the base bundle packed from phase main's own S5P output, a 10 % insertion
    (the first E/10 edges of R-MAT seed 1, appended) under the default drift
    thresholds beside a cold S5P run of all the edges, the rollback of
    exactly that batch (every leaf bitwise the base), a decremental
    ``frac:0.05`` deletion of the base, ``CarryStore`` save and load of the
    post-delta bundle, HDRF's ``cold_start`` then ``run_incremental`` (the
    same delta and ``frac:0.05``), and ``S5PWindowChain`` over phase main's
    edges until its first steady step.  Each step runs with the launch
    counters set to 0 just before and read just after.  Cut for the
    script's time limit: the window runs at 2^22 edges, step 2^20, and
    stops after its first steady step (2^23 / 2^21 over the whole stream
    took 89 s on an NVIDIA H100 80GB HBM3 at 700 W, its steady steps 19–28
    s each: a churn-tripped refinement of every live cluster)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core.metrics import replication_factor
    from repro_torch.core.s5p import s5p_partition
    from repro_torch.incremental import (CarryStore, S5PWindowChain, cold_start,
                                         pack_warm_bundle, run_incremental, s5p_apply_delta,
                                         s5p_apply_deletion)
    from repro_torch.incremental.pipeline import last_games, theta_delta_pairs
    from repro_torch.launch.partition import _parse_delete

    t_phase = time.perf_counter()
    out, src, dst, n, cfg = main["out"], main["src"], main["dst"], main["n"], main["cfg"]
    dev = out.parts.device
    E, k = int(src.size), cfg.k
    problems, totals = [], {}
    info = {"phase": "incremental", "E": E, "k": k}

    def drive(fn, path=True):
        """``fn()`` timed, with its launches; ``path`` adds them to the
        phase's totals (the comparison runs are not the incremental path)."""
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        if path:
            for key, v in launches.items():
                totals[key] = totals.get(key, 0) + v
        return res, dt, launches

    def same_bundle(a, b, skip=()):
        keys = sorted(x for x in set(a) | set(b) if x not in skip)
        for key in keys:
            if key not in a or key not in b:
                return key
            x, y = np.asarray(a[key]), np.asarray(b[key])
            if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
                return key
        return None

    def emit_step(row):
        emit({"phase": "incremental", **row})
        info[row["step"]] = row

    # ---- the base bundle: phase main's output, packed (no second cold run) ----
    inc = out.aux["incremental"]
    t0 = time.perf_counter()
    base = pack_warm_bundle(
        src, dst, n, cfg, state=inc["cluster_state"], res=inc["compact"],
        degrees=inc["degrees"], sizes=inc["sizes"], pair_a=inc["pair_a"],
        pair_b=inc["pair_b"], pair_w=inc["pair_w"], c2p=out.cluster_assignment,
        parts=out.parts, load=inc["load"], xi=out.xi, kappa=out.kappa,
        sketch=out.aux.get("sketch"))
    bundle_bytes = int(sum(np.asarray(v).nbytes for v in base.values()))
    emit_step({"step": "pack_base", "seconds": time.perf_counter() - t0,
               "bundle_bytes": bundle_bytes, "bytes_per_edge": bundle_bytes / E,
               "clusters": int(base["comb_is_head"].size), "rf_baseline": float(base["rf_baseline"])})

    # ---- insertion: 10 % of the base, appended ----
    m = E // 10
    (s1, d1, _), info["seed1_generate_s"] = seed1  # made beside phase main's (make_graphs)
    full_src = np.concatenate([src, s1[:m]]).astype(np.int32)
    full_dst = np.concatenate([dst, d1[:m]]).astype(np.int32)
    E_full = int(full_src.size)
    (b1, r1), dt, launches = drive(lambda: s5p_apply_delta(base, cfg, full_src, full_dst, E,
                                                          device=dev))
    games = last_games()
    p1 = r1.parts
    loads = np.bincount(p1[p1 >= 0], minlength=k)
    cap = int(math.ceil(cfg.tau * E_full / k))
    n_chunks = math.ceil(m / cfg.chunk_size)
    audit = _incremental_game_audit(b1, games)
    row = {"step": "delta", "edges": m, "seconds": dt, "refined": r1.refined,
           "game_rounds": r1.game_rounds, "replay_fraction": r1.replay_fraction,
           "edges_replayed": r1.edges_replayed, "n_new_clusters": r1.n_new_clusters,
           "rf": r1.rf, "balance": r1.balance, "rf_drift": r1.rf_drift,
           "max_load": int(loads.max()), "max_load_cap": cap, "launches": launches,
           "delta_chunks": n_chunks, "game_audit": audit}
    emit_step(row)
    if int(loads.max()) > cap:
        problems.append(f"delta: max load {int(loads.max())} > cap {cap}")
    # K1 once a delta chunk; K2 once a delta chunk plus the refinement's replay
    replay_chunks = math.ceil((r1.edges_replayed - 4 * m) / cfg.chunk_size)
    if launches["cluster_scan"] != n_chunks or launches["assign_scan"] != n_chunks + replay_chunks:
        problems.append(f"delta: K1/K2 launched {launches}, not {n_chunks} / "
                        f"{n_chunks} + {replay_chunks} (replay)")
    if launches["cms_update"] < 1 or launches["cms_query"] < 1:
        problems.append(f"delta: K4a/K4b not launched: {launches}")
    if launches["segment_agg"] != _game_k5(games) or not audit["ok"]:
        problems.append(f"delta: the games' K5 launches {launches['segment_agg']} != "
                        f"{_game_k5(games)} or their audit fails: {audit}")

    # ---- a cold S5P run of all the edges, beside it ----
    cold, dt, cold_launches = drive(lambda: s5p_partition(full_src, full_dst, n, cfg,
                                                          device=dev), path=False)
    s_t = torch.from_numpy(full_src).to(dev)
    d_t = torch.from_numpy(full_dst).to(dev)
    rf_cold = replication_factor(s_t, d_t, cold.parts, n_vertices=n, k=k)
    del s_t, d_t, cold
    emit_step({"step": "cold_all", "edges": E_full, "seconds": dt, "rf": rf_cold,
               "delta_seconds_over_cold": row["seconds"] / dt, "delta_rf_over_cold": r1.rf / rf_cold,
               "launches": cold_launches})

    # ---- rollback of exactly the inserted batch ----
    rb_from, rb_note = b1, "the delta above"
    if r1.refined:  # a refinement drops the journal: insert again with it off
        inf = float("inf")
        cfg_nr = dataclasses.replace(cfg, drift_rf_threshold=inf,
                                     drift_balance_threshold=inf, drift_churn_threshold=inf)
        (rb_from, _), dt_nr, _ = drive(lambda: s5p_apply_delta(base, cfg_nr, full_src,
                                                                full_dst, E, device=dev),
                                       path=False)
        rb_note = f"the delta again with refinement off ({dt_nr:.3f} s)"
    (b2, r2), dt, launches = drive(lambda: s5p_apply_deletion(
        rb_from, cfg, full_src, full_dst, np.arange(E, E_full), device=dev))
    skip = ("journal_valid", "journal_pos")
    diff = same_bundle(base, b2, skip)
    emit_step({"step": "rollback", "edges": m, "seconds": dt, "rolled_back": r2.rolled_back,
               "bitwise_equal_to_base": diff is None, "first_diff": diff, "of": rb_note,
               "launches": launches})
    if not r2.rolled_back or diff is not None:
        problems.append(f"rollback: rolled_back {r2.rolled_back}, first differing leaf {diff}")
    del b2, rb_from

    # ---- decremental: frac:0.05 of the base ----
    idx = _parse_delete("frac:0.05", E, 0)
    (b3, r3), dt, launches = drive(lambda: s5p_apply_deletion(base, cfg, src, dst, idx,
                                                              device=dev))
    games3 = last_games()
    slot = np.searchsorted(base["arrival"], idx)
    ret_a, ret_b = theta_delta_pairs(base["edge_cu"][slot], base["edge_cv"][slot],
                                     base["edge_alt_u"][slot], base["edge_alt_v"][slot])
    info["retract_pairs"] = (ret_a, ret_b)
    emit_step({"step": "deletion", "spec": "frac:0.05", "edges": int(idx.size), "seconds": dt,
               "churn": r3.churn, "refined": r3.refined, "game_rounds": r3.game_rounds,
               "rf": r3.rf, "balance": r3.balance, "theta_pairs_retracted": int(ret_a.size),
               "launches": launches, "game_audit": _incremental_game_audit(b3, games3)})
    if launches["cms_update"] < 1 or r3.n_retracted != idx.size:
        problems.append(f"deletion: K4a not launched or wrong count: {launches}")
    del b3

    # ---- CarryStore: save and load the post-delta bundle ----
    store_dir = os.path.join(ROOT, "build", "chip_smoke_carry")
    shutil.rmtree(store_dir, ignore_errors=True)
    store = CarryStore(store_dir, keep=1)
    t0 = time.perf_counter()
    path = store.save(b1, consumer="s5p", config={"k": k}, stream_pos=E_full)
    save_s = time.perf_counter() - t0
    disk = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    t0 = time.perf_counter()
    loaded, _ = store.load(consumer="s5p", config={"k": k})
    load_s = time.perf_counter() - t0
    diff = same_bundle(b1, loaded)
    shutil.rmtree(store_dir, ignore_errors=True)
    emit_step({"step": "store", "save_s": save_s, "load_s": load_s, "bytes_on_disk": disk,
               "bytes_per_edge": disk / E_full, "bitwise": diff is None, "first_diff": diff})
    if diff is not None:
        problems.append(f"store: the loaded bundle differs at {diff}")
    del loaded, b1

    # ---- HDRF: cold start, then the same delta and frac:0.05 ----
    hdrf_dir = os.path.join(ROOT, "build", "chip_smoke_hdrf")
    shutil.rmtree(hdrf_dir, ignore_errors=True)
    (hparts, _), dt_cold, l_cold = drive(lambda: cold_start(hdrf_dir, "hdrf", src, dst, n, k,
                                                            device=dev), path=False)
    same_as_compare = bool(np.array_equal(hparts, compare["parts"]["hdrf"].cpu().numpy()))
    info["hdrf_cold"] = {"parts": hparts, "carry": _stored_scan_carry(hdrf_dir, "hdrf", n, k,
                                                                      dev)}
    hidx = _parse_delete("frac:0.05", E_full, 0)
    hres, dt, launches = drive(lambda: run_incremental(hdrf_dir, "hdrf", full_src, full_dst,
                                                       n, k, delete=hidx, device=dev))
    shutil.rmtree(hdrf_dir, ignore_errors=True)
    emit_step({"step": "hdrf", "cold_start_s": dt_cold, "cold_launches": l_cold,
               "cold_parts_equal_phase_compare": same_as_compare, "seconds": dt,
               "delta": hres.n_delta_edges, "deleted": hres.n_retracted, "rf": hres.rf,
               "rf_phase_compare": compare["rows"]["hdrf"]["rf"],
               "k3_insert_launches": launches["scoring_scan"],
               "k3_retract_launches": launches["scoring_retract"], "launches": launches})
    if (launches["scoring_scan"] != n_chunks
            or launches["scoring_retract"] != math.ceil(hidx.size / (1 << 16))
            or not same_as_compare):
        problems.append(f"hdrf: K3 launched {launches} (want {n_chunks} inserts, "
                        f"{math.ceil(hidx.size / (1 << 16))} retracts), cold parts equal "
                        f"phase compare's: {same_as_compare}")

    # ---- the sliding window over phase main's edges ----
    W, B = WINDOW_EDGES, WINDOW_STEP
    chain = S5PWindowChain(src, dst, n, cfg, W, step_edges=B, device=dev)
    steps = []
    while not any(st["n_retracted"] for st in steps):  # through the first steady step
        rec, dt, launches = drive(chain.step)
        if rec is None:
            break
        st = {"window_step": rec.step, "lo": rec.lo, "hi": rec.hi, "seconds": dt,
              "filling": rec.filling, "rf": rec.rf, "balance": rec.balance,
              "refined": rec.refined, "rolled_back": rec.rolled_back,
              "n_inserted": rec.n_inserted, "n_retracted": rec.n_retracted,
              "churn": rec.churn, "n_compacted": rec.n_compacted,
              "n_slots_freed": rec.n_slots_freed, "launches": launches}
        emit({"phase": "incremental", "step": "window", **st})
        steps.append(st)
    info["window"] = {"window_edges": W, "step_edges": B, "n_steps": chain.n_steps,
                      "steps": steps}
    live = chain.live_partition()
    if live is None or live[0].size != steps[-1]["hi"] - steps[-1]["lo"]:
        problems.append("window: the live partition does not hold the last window")
    del chain
    info["base"] = base  # phase elastic reshards it
    info["launches"] = totals
    info["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "incremental", "step": "done", "phase_s": info["phase_s"],
          "launches": totals})
    if problems:
        raise SystemExit("chip_smoke incremental phase failed: " + "; ".join(problems))
    return info


def _stored_scan_carry(store_dir, name: str, n: int, k: int, dev):
    """The scan carry a ``cold_start`` saved, rebuilt on ``dev`` as
    ``run_incremental`` rebuilds it."""
    from repro_torch.checkpoint.manager import as_like
    from repro_torch.incremental import CarryStore
    from repro_torch.incremental.driver import _scan_carry
    from repro_torch.streaming.carry import (tree_flatten, tree_flatten_with_paths,
                                             tree_unflatten)

    flat, _ = CarryStore(store_dir).load(consumer=name)
    proto = _scan_carry(name, n, k, 0, dev).init()
    _, spec = tree_flatten(proto)
    return tree_unflatten(spec, [as_like(flat[key], x)
                                 for key, x in tree_flatten_with_paths({"scan": proto})])


def _fixed_monitor(slow: int = 2, lanes: int = 4):
    """A straggler monitor whose plan does not depend on timing (lane
    ``slow`` seeded at 100, the others at 1; ``record`` keeps the history
    only), so a forced handoff gives the same plan on every device."""
    from repro_torch.runtime import StragglerMonitor

    class Fixed(StragglerMonitor):
        def record(self, step, dt, shard=0):
            self.n_shards = max(self.n_shards, int(shard) + 1)
            self.history.append((step, int(shard), dt))

    mon = Fixed(threshold=1.01)
    for s in range(lanes):
        StragglerMonitor.record(mon, 0, 100.0 if s == slow else 1.0, shard=s)
    return mon


def _reshard_affected(before: dict, after: dict, k_new: int) -> int:
    """The live edges a bundle reshard placed again: those on a partition
    past ``k_new`` and those of a cluster whose partition changed."""
    import numpy as np

    old = np.asarray(before["parts"], np.int32)
    placed = np.asarray(before["alive"], bool) & (old >= 0)
    moved = np.asarray(after["c2p"], np.int32) != np.asarray(before["c2p"], np.int32)
    cu, cv = np.asarray(before["edge_cu"]), np.asarray(before["edge_cv"])
    on_moved = ((cu >= 0) & moved[np.maximum(cu, 0)]) | ((cv >= 0) & moved[np.maximum(cv, 0)])
    return int(np.count_nonzero(placed & ((old >= k_new) | on_moved)))


def _reshard_checks(res, before: dict, after: dict, k_old: int) -> list[str]:
    """``tests/test_elastic.py::_check_invariants`` on a resharded bundle,
    plus the grow and shrink postconditions."""
    import numpy as np

    k = res.k_new
    problems = []
    parts = np.asarray(after["parts"], np.int32)
    old = np.asarray(before["parts"], np.int32)
    placed = np.asarray(after["alive"], bool) & (parts >= 0)
    if parts[placed].max() >= k or np.asarray(after["c2p"]).max() >= k:
        problems.append(f"k'={k}: parts or c2p out of range")
    if not np.array_equal(np.asarray(after["load"]), np.bincount(parts[placed], minlength=k)):
        problems.append(f"k'={k}: the load vector is not the placed parts' histogram")
    if k < k_old:
        want = int(np.count_nonzero(np.asarray(before["alive"], bool) & (old >= k)))
        if res.n_displaced != want:
            problems.append(f"shrink: n_displaced {res.n_displaced} != {want} on "
                            f"partitions {k}..{k_old - 1}")
    else:
        moved = np.asarray(after["c2p"], np.int32) != np.asarray(before["c2p"], np.int32)
        cu, cv = np.asarray(after["edge_cu"]), np.asarray(after["edge_cv"])
        stable = ~moved[np.maximum(cu, 0)] & ~moved[np.maximum(cv, 0)]
        if res.n_displaced or not np.array_equal(parts[stable], old[stable]):
            problems.append("grow: an edge whose clusters stayed changed partition")
    return problems


def phase_elastic(main, incremental) -> dict:
    """Elastic k→k′ resharding, the runtime and the serving controller at
    phase main's scale, each step with the launch counters set to 0 just
    before and read just after: phase incremental's base bundle (phase
    main's output, packed once) resharded 32 → 40 and 32 → 24
    (``reshard_bundle``, ``move_cost_scale = 1``: the migration-cost game on
    the card, its sums on K5, the affected edges placed again on K2; the
    game's seconds beside the rest of the step, K2 held to one launch a
    chunk of the edges placed again, the game's audit, the invariants of
    ``tests/test_elastic.py``); HDRF's carry from phase incremental's cold
    start resharded 32 → 24 (``reshard_scan_carry``: K3's retract, then K3
    at k′); a ``ServingController`` over an ``S5PWindowChain`` of phase
    main's edges (window 2^21, step 2^19): the fill, one steady step at
    k = 32, ``resize(40)`` while a reader pins the k = 32 version, one
    steady step at k = 40, with 4 PageRank supersteps and 16
    ``query_pagerank`` after each swap; ``FaultTolerantLoop`` driving 12
    label-propagation supersteps over the served bundle (checkpoints every
    5, a failure at step 7) against the undisturbed run, bitwise; and
    ``ElasticController.resize`` (``CheckpointManager``, an
    ``ElasticPartition`` over the served window's bundle, 40 → 24): the
    state tensors back on the card bitwise.  Cut for the script's time
    limit, in this order: the cold S5P at k′ = 24 beside the shrink
    (14.7 s), and the controller's window from 2^22 / 2^20 to 2^21 / 2^19
    (its four swaps took 52.4 s); uncut, the script took 1,113.6 s on an
    NVIDIA H100 80GB HBM3 at 700 W, the phase 115.2 s."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.elastic import reshard_bundle, reshard_scan_carry
    from repro_torch.gas import label_propagation_step, pagerank_step
    from repro_torch.incremental import S5PWindowChain
    from repro_torch.incremental.pipeline import last_games
    from repro_torch.kernels.stream_scan import HdrfCarry
    from repro_torch.runtime import (ElasticController, ElasticPartition, FaultInjector,
                                     FaultTolerantLoop)
    from repro_torch.serving import BundleRegistry, GASServer, ServingController

    t_phase = time.perf_counter()
    src, dst, n, cfg = main["src"], main["dst"], main["n"], main["cfg"]
    dev = main["out"].parts.device
    k, E = cfg.k, int(src.size)
    base = incremental["base"]
    problems, totals = [], {}
    info = {"phase": "elastic", "E": E, "k": k}

    def drive(fn, path=True):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        if path:
            for key, v in launches.items():
                totals[key] = totals.get(key, 0) + v
        return res, dt, launches

    def emit_step(row):
        emit({"phase": "elastic", **row})
        info[row["step"]] = row

    # ---- the bundle resharded: grow 32 -> 40, shrink 32 -> 24 ----
    for k_new, name in ((40, "grow"), (24, "shrink")):
        (b2, _, res), dt, launches = drive(lambda: reshard_bundle(
            base, cfg, k_new, src, dst, move_cost_scale=1.0, device=dev))
        games = last_games()
        audit = _incremental_game_audit(b2, games)
        k2_chunks = math.ceil(_reshard_affected(base, b2, k_new) / cfg.chunk_size)
        emit_step({"step": name, "k_old": k, "k_new": k_new, "seconds": dt,
                   "game_s": games[-1]["seconds"],
                   "after_game_s": dt - games[-1]["seconds"], "k2_chunks": k2_chunks,
                   "rounds": res.game_rounds, "migrated_fraction": res.migrated_fraction,
                   "migrated_edges": res.migrated_edges, "n_displaced": res.n_displaced,
                   "moved_clusters": res.moved_clusters, "rf": res.rf, "balance": res.balance,
                   "rf_base": float(base["rf_baseline"]), "n_live": res.n_live,
                   "launches": launches, "game_audit": audit})
        problems += _reshard_checks(res, base, b2, k)
        if not audit["ok"]:
            problems.append(f"{name}: the game's audit fails: {audit}")
        if (launches["assign_scan"] != k2_chunks
                or launches["segment_agg"] != _game_k5(games)):
            problems.append(f"{name}: K2 {launches['assign_scan']} / K5 "
                            f"{launches['segment_agg']} launches (want {k2_chunks} / "
                            f"{_game_k5(games)})")
        del b2

    # ---- HDRF's carry from phase incremental's cold start: 32 -> 24 ----
    hc = incremental["hdrf_cold"]
    hparts = hc["parts"]
    (work, new_parts, hres), dt, launches = drive(lambda: reshard_scan_carry(
        HdrfCarry(n, 24, 1.1, device=dev), hc["carry"], 24, src, dst, hparts))
    displaced = int(np.count_nonzero(hparts >= 24))
    k3_chunks = math.ceil(displaced / (1 << 16))
    ok = (bool(np.array_equal(work[0].cpu().numpy(), np.bincount(new_parts, minlength=24)))
          and new_parts.max() < 24 and hres.n_displaced == displaced
          and bool(np.array_equal(new_parts != hparts, hparts >= 24)))
    emit_step({"step": "hdrf_carry", "k_old": k, "k_new": 24, "seconds": dt,
               "n_displaced": hres.n_displaced, "migrated_fraction": hres.migrated_fraction,
               "rf": hres.rf, "balance": hres.balance, "k3_retract_launches":
               launches["scoring_retract"], "k3_insert_launches": launches["scoring_scan"],
               "chunks": k3_chunks, "invariants": ok, "launches": launches})
    if (not ok or launches["scoring_retract"] != k3_chunks
            or launches["scoring_scan"] != k3_chunks):
        problems.append(f"hdrf carry: invariants {ok}, K3 {launches} (want {k3_chunks} each)")
    del work, new_parts, hc, incremental["hdrf_cold"]

    # ---- the serving controller over the window chain, with a resize ----
    W, B = ELASTIC_WINDOW_EDGES, ELASTIC_WINDOW_STEP
    chain = S5PWindowChain(src, dst, n, cfg, W, step_edges=B, device=dev)
    reg = BundleRegistry()
    ctl = ServingController(reg, chain)
    server = GASServer(reg)
    rng = np.random.default_rng(0)
    swaps = []

    def serve_round():
        t0 = time.perf_counter()
        server.run(4)
        for _ in range(16):
            server.query_pagerank(rng.integers(0, n, 16))
        return time.perf_counter() - t0

    while len([r for r in ctl.history if not r.filling]) < 2:  # the fill, one steady step
        rec, dt, launches = drive(ctl.step)
        row = {"window_step": rec.step, "seconds": dt, "filling": rec.filling,
               "version": ctl.version, "k": chain.config.k, "rf": rec.rf,
               "refined": rec.refined, "launches": launches}
        if not rec.filling:
            row.update(origin=reg.current.origin, serve_s=serve_round())
        swaps.append(row)
        emit({"phase": "elastic", "step": "controller", **row})
    v32 = reg.current_version
    with reg.pin() as held:
        res, dt, launches = drive(lambda: ctl.resize(40))
        held.check()
        pinned_k = held.k
        pinned_vals = pagerank_step(held.gas, torch.ones(n, device=dev), held.out_deg_inv)
        pinned_ok = pinned_k == k and bool(torch.isfinite(pinned_vals).all())
    row = {"window_step": "resize", "seconds": dt, "version": ctl.version,
           "origin": reg.current.origin, "k": reg.current.k, "rf": res.rf,
           "migrated_fraction": res.migrated_fraction, "rounds": res.game_rounds,
           "game_s": last_games()[-1]["seconds"],
           "pinned_version": v32, "pinned_k": pinned_k, "launches": launches,
           "serve_s": serve_round()}
    swaps.append(row)
    emit({"phase": "elastic", "step": "controller", **row})
    if reg.current.origin != "resize" or reg.current.k != 40 or not pinned_ok:
        problems.append(f"controller: resize published origin {reg.current.origin}, k "
                        f"{reg.current.k}; the pinned reader read k {pinned_k}")
    rec, dt, launches = drive(ctl.step)
    row = {"window_step": rec.step, "seconds": dt, "version": ctl.version,
           "origin": reg.current.origin, "k": reg.current.k, "rf": rec.rf,
           "refined": rec.refined, "launches": launches, "serve_s": serve_round()}
    swaps.append(row)
    emit({"phase": "elastic", "step": "controller", **row})
    lat = server.metrics.query_latency_us
    info["controller"] = {"window_edges": W, "step_edges": B, "swaps": swaps,
                          "supersteps": server.metrics.n_supersteps,
                          "swaps_observed": server.metrics.swaps_observed,
                          "query_pagerank_us": _latency(lat)}
    if reg.current.k != 40 or np.asarray(reg.current.parts).max() >= 40:
        problems.append("controller: the step after the resize did not publish at k = 40")

    # ---- FaultTolerantLoop: label propagation over the served bundle ----
    g = reg.current.gas

    def step_fn(state, batch):
        labels = label_propagation_step(g, state["labels"])
        return {"labels": labels, "n": state["n"] + 1}, {"labels": labels}

    def loop_run(d, fail_at):
        shutil.rmtree(d, ignore_errors=True)
        loop = FaultTolerantLoop(step_fn, lambda s: None,
                                 CheckpointManager(d, async_write=False), ckpt_every=5,
                                 injector=FaultInjector(fail_at))
        state = {"labels": torch.arange(n, dtype=torch.int32, device=dev),
                 "n": torch.zeros((), dtype=torch.int32, device=dev)}
        out, _, _ = loop.run(state, 12)
        return out, loop.restarts

    ckpt = os.path.join(ROOT, "build", "chip_smoke_elastic")
    (clean, r0), dt0, _ = drive(lambda: loop_run(os.path.join(ckpt, "clean"), ()), path=False)
    (faulty, r1), dt1, _ = drive(lambda: loop_run(os.path.join(ckpt, "faulty"), (7,)),
                                 path=False)
    same = bool(torch.equal(clean["labels"], faulty["labels"])) and int(faulty["n"]) == 12
    emit_step({"step": "fault_loop", "supersteps": 12, "ckpt_every": 5, "fail_at": 7,
               "restarts": [r0, r1], "seconds": [dt0, dt1], "bitwise_equal": same,
               "components": int(torch.unique(clean["labels"]).numel())})
    if not same or (r0, r1) != (0, 1):
        problems.append(f"fault loop: restarts {(r0, r1)}, bitwise {same}")

    # ---- ElasticController: checkpoint, place, reshard the served window ----
    state = {"labels": clean["labels"], "pagerank": server.values}
    part = ElasticPartition(chain.bundle, chain.config, chain.seen_src, chain.seen_dst,
                            device=dev)
    controller = ElasticController(CheckpointManager(os.path.join(ckpt, "ctl"), keep=1,
                                                     async_write=False),
                                   make_mesh=lambda size: dev, partition=part)
    (new_state, mesh, eres, step), dt, launches = drive(
        lambda: controller.resize(state, 12, 24))
    same = all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
               for a, b in ((new_state["labels"], state["labels"]),
                            (new_state["pagerank"], state["pagerank"])))
    emit_step({"step": "elastic_controller", "seconds": dt, "k_new": eres.k_new,
               "migrated_fraction": eres.migrated_fraction, "rf": eres.rf, "step_out": step,
               "state_bitwise_on_card": same, "partition_k": part.k, "launches": launches})
    if not same or eres.k_new != 24 or part.k != 24 or step != 12:
        problems.append(f"elastic controller: state bitwise {same}, k {part.k}, step {step}")
    shutil.rmtree(ckpt, ignore_errors=True)
    del chain, ctl, reg, server, g, part

    info["launches"] = totals
    info["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "elastic", "step": "done", "phase_s": info["phase_s"], "launches": totals})
    if problems:
        raise SystemExit("chip_smoke elastic phase failed: " + "; ".join(problems))
    return info


# ------------------------------------------------------------ phase hybrid

# phase hybrid: the full-scale budget, as a fraction of E·CORE_EDGE_BYTES·2
# (0.05 of the main graph's: 45,530,385 bytes, ~9 % of its edges), and the
# frontier's graph and rungs
HYBRID_BUDGET_FRACTION = 0.05
FRONTIER_BLOCK_SCALE = 14
FRONTIER_RUNGS = (0.0, 0.05, 0.3, 1.0)


@contextlib.contextmanager
def _hybrid_recorder():
    """Record what ``run_hybrid`` computed inside: pass 0's ``S5POutput``
    and each refinement game's report (``GameResult`` without the
    assignment), for the launch counts and the check against phase main."""
    from repro_torch.hybrid import driver as hd

    rec = {"pass0": None, "games": []}
    s5p, game = hd.s5p_partition, hd.refine_core_game

    def s5p_rec(*a, **kw):
        rec["pass0"] = s5p(*a, **kw)
        return rec["pass0"]

    def game_rec(*a, **kw):
        g = game(*a, **kw)
        rec["games"].append({f: getattr(g, f) for f in g._fields if f != "assignment"})
        return g

    hd.s5p_partition, hd.refine_core_game = s5p_rec, game_rec
    try:
        yield rec
    finally:
        hd.s5p_partition, hd.refine_core_game = s5p, game


def _hybrid_want(res, src, dst, n, chunk: int, games, base: dict) -> dict:
    """The launches a hybrid run must make beyond pass 0's (``base``): K4a
    twice a stream chunk and K4b twice (the plan), then for each level
    whose core holds an edge (min exact degree above the level, no
    self-loop) K2 once a ``chunk`` of that core and once a stream chunk
    for the tail, K5 as each game reports."""
    import numpy as np

    n_chunks = math.ceil(src.size / chunk)
    want = dict(base)
    if res.budget_bytes > 0:
        want["cms_update"] = base.get("cms_update", 0) + 2 * n_chunks
        want["cms_query"] = base.get("cms_query", 0) + 2
    played = []
    if res.mode != "streaming":
        deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
        dmin = np.minimum(deg[src], deg[dst])[src != dst]
        ladder = res.plan.ladder[:res.plan.ladder.index(res.xi_star) + 1]
        played = [int((dmin > lv).sum()) for lv in ladder]
        played = [m for m in played if m > 0]
    want["assign_scan"] = base.get("assign_scan", 0) + sum(
        math.ceil(m / chunk) + n_chunks for m in played)
    want["segment_agg"] = base.get("segment_agg", 0) + sum(
        2 + g["ordered_sums"] for g in games if g["rounds"] > 0)
    return want, len(played)


def _launch_problems(name: str, launches: dict, want: dict) -> list[str]:
    bad = {key: (launches.get(key, 0), v) for key, v in want.items()
           if launches.get(key, 0) != v}
    return [f"{name}: launches (got, want) {bad}"] if bad else []


def _hybrid_row(res) -> dict:
    plan = res.plan
    ladder_used = (plan.ladder[:plan.ladder.index(res.xi_star) + 1]
                   if res.mode != "streaming" else ())
    return {"budget_bytes": res.budget_bytes, "mode": res.mode,
            "plan": {"mode": plan.mode, "xi_star": plan.xi_star, "ladder": list(plan.ladder),
                     "est_core_edges": plan.est_core_edges,
                     "est_core_bytes": plan.est_core_bytes,
                     "sample_edges": plan.sample_edges, "sketch_bytes": plan.sketch_bytes},
            "xi_star": res.xi_star, "retreats": len(plan.ladder) - len(ladder_used)
            if res.mode != "streaming" else None,
            "core_edges": res.core_edges, "peak_budget_bytes": res.peak_budget_bytes,
            "accepted_levels": list(res.accepted_levels), "game_rounds": res.game_rounds,
            "rf": res.rf, "balance": res.balance, "rf_streaming": res.rf_streaming,
            "balance_streaming": res.balance_streaming, "seconds": dict(res.timings)}


def phase_hybrid(main) -> dict:
    """The memory-budget hybrid partitioner (``repro_torch.hybrid``) at
    phase main's scale, each step with the launch counters set to 0 just
    before and read just after: ``run_hybrid`` on phase main's graph at k =
    32 under ``S5PConfig(host_budget=…)`` of 0.05 × E·CORE_EDGE_BYTES·2
    (pass 0 must equal phase main's run bit for bit; peak ≤ budget, RF ≤
    the streaming RF and equal to the returned parts' RF, max load under
    its cap, the 40-key bundle at ``stream_pos == E``; K1 240, K4a pass 0's
    + 480, K4b pass 0's + 2, K2 pass 0's + ⌈core / 65,536⌉ + 240 a level,
    K5 as the games report); ``HybridServingChain`` through a
    ``ServingController`` (the publish, origin ``"cold"``, and one delta
    of 65,536 uniform edges, ``default_rng(26)``); then the frontier of
    ``benchmarks/hybrid_bench.py``'s gates on ``block_rmat_graph(14, 8,
    8)`` at k = 32, rungs 0, 0.05, 0.3 and 1.0 (RF non-increasing, ≤ the
    streaming RF above 0, peak ≤ budget, rung 0 the plain S5P bit for bit,
    1.0 in memory)."""
    import numpy as np
    import torch

    from repro_torch.core.metrics import partition_loads, replication_factor
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.graphs import block_rmat_graph
    from repro_torch.hybrid import CORE_EDGE_BYTES, HybridServingChain, run_hybrid
    from repro_torch.serving import BundleRegistry, ServingController

    t_phase = time.perf_counter()
    src, dst, n, cfg = main["src"], main["dst"], main["n"], main["cfg"]
    dev = main["out"].parts.device
    k, E = cfg.k, int(src.size)
    problems, totals = [], {}
    info = {"phase": "hybrid", "E": E, "k": k}

    def drive(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        for key, v in launches.items():
            totals[key] = totals.get(key, 0) + v
        return res, dt, launches

    # ---- the full-scale run ----
    budget = int(HYBRID_BUDGET_FRACTION * E * CORE_EDGE_BYTES * 2)
    hcfg = dataclasses.replace(cfg, host_budget=budget)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _hybrid_recorder() as rec:
        res, dt, launches = drive(lambda: run_hybrid((src, dst, n), hcfg, device=dev))
    peak = torch.cuda.max_memory_allocated()
    pass0 = rec["pass0"]
    base = {key: main["launches"][key] for key in
            ("cluster_scan", "assign_scan", "cms_update", "cms_query", "segment_agg")}
    want, n_levels = _hybrid_want(res, src, dst, n, cfg.chunk_size, rec["games"], base)
    s_t, d_t = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    p_t = torch.from_numpy(res.parts).to(dev)
    rf_parts = replication_factor(s_t, d_t, p_t, n_vertices=n, k=k)
    max_load = int(partition_loads(p_t, k=k).max())
    pass0_same = bool(torch.equal(pass0.parts, main["out"].parts))
    row = {"step": "run", **_hybrid_row(res), "wall_s": dt,
           "budget_fraction_of_edges": budget / (E * CORE_EDGE_BYTES),
           "pass0_equals_main": pass0_same, "rf_main": main["info"]["rf"],
           "rf_of_parts": rf_parts, "max_load": max_load, "max_load_cap": pass0.max_load,
           "bundle_keys": len(res.bundle), "stream_pos": int(res.bundle["stream_pos"]),
           "levels_played": n_levels, "games": rec["games"],
           "max_memory_allocated": peak, "launches": launches, "launches_want": want}
    emit({"phase": "hybrid", **row})
    info["run"] = row
    if not pass0_same or res.rf_streaming != main["info"]["rf"]:
        problems.append(f"pass 0 differs from phase main (parts equal {pass0_same}, RF "
                        f"{res.rf_streaming} against {main['info']['rf']})")
    if res.mode == "streaming" or not res.peak_budget_bytes <= budget:
        problems.append(f"mode {res.mode}, peak {res.peak_budget_bytes} of {budget} bytes")
    if not res.rf <= res.rf_streaming or res.rf != rf_parts:
        problems.append(f"RF {res.rf} (of its parts {rf_parts}), streaming {res.rf_streaming}")
    if max_load > pass0.max_load:
        problems.append(f"max load {max_load} > cap {pass0.max_load}")
    if len(res.bundle) != 40 or int(res.bundle["stream_pos"]) != E:
        problems.append(f"bundle: {len(res.bundle)} keys at {int(res.bundle['stream_pos'])}")
    if len(rec["games"]) != n_levels:
        problems.append(f"{len(rec['games'])} games for {n_levels} levels with a core")
    problems += _launch_problems("run", launches, want)

    # ---- the hybrid bundle served: the publish, then one delta ----
    rng = np.random.default_rng(26)
    delta = (rng.integers(0, n, 1 << 16).astype(np.int32),
             rng.integers(0, n, 1 << 16).astype(np.int32))
    chain = HybridServingChain(res, hcfg, src, dst, n, deltas=[delta], device=dev)
    reg = BundleRegistry()
    ctl = ServingController(reg, chain)
    serving = []
    for step in ("publish", "delta"):
        srec, sdt, slaunches = drive(ctl.step)
        b = reg.current
        b.check()
        serving.append({"step": step, "seconds": sdt, "version": b.version,
                        "origin": b.origin, "n_edges": b.n_edges, "rf": b.rf,
                        "balance": b.balance, "refined": bool(getattr(srec, "refined", False)),
                        "launches": slaunches})
        emit({"phase": "hybrid", "step": "serving", **serving[-1]})
    info["serving"] = serving
    done = ctl.step() is None
    if ([(s["version"], s["origin"], s["n_edges"]) for s in serving]
            != [(1, "cold", E), (2, serving[1]["origin"], E + (1 << 16))]
            or serving[0]["rf"] != res.rf or not done or serving[1]["origin"] == "cold"):
        problems.append(f"serving chain: {serving}, done {done}")
    del chain, reg, ctl, res, rec, pass0, s_t, d_t, p_t

    # ---- the frontier (benchmarks/hybrid_bench.py's gates) ----
    fs, fd, fn = block_rmat_graph(block_scale=FRONTIER_BLOCK_SCALE, n_blocks=8,
                                  edge_factor=8, seed=0)
    fE = int(fs.size)
    fcfg = S5PConfig(k=k)
    plain, plain_s, plain_l = drive(lambda: s5p_partition(fs, fd, fn, fcfg, device=dev))
    rows, prev, rf_stream = [], None, None
    for frac in FRONTIER_RUNGS:
        b = int(frac * fE * CORE_EDGE_BYTES * 2)
        with _hybrid_recorder() as frec:
            r, rdt, rl = drive(lambda: run_hybrid((fs, fd, fn), fcfg, host_budget=b,
                                                  device=dev))
        fwant, _ = _hybrid_want(r, fs, fd, fn, fcfg.chunk_size, frec["games"], plain_l)
        row = {"budget_fraction": frac, **_hybrid_row(r), "wall_s": rdt, "launches": rl}
        rows.append(row)
        emit({"phase": "hybrid", "step": "frontier", **row})
        rf_stream = r.rf_streaming if rf_stream is None else rf_stream
        if b > 0 and not (r.peak_budget_bytes <= b and r.rf <= rf_stream):
            problems.append(f"frontier {frac}: peak {r.peak_budget_bytes} of {b}, RF {r.rf} "
                            f"against streaming {rf_stream}")
        if prev is not None and not r.rf <= prev:
            problems.append(f"frontier {frac}: RF {r.rf} > the previous rung's {prev}")
        if frac == 0.0 and not np.array_equal(r.parts, plain.parts.cpu().numpy()):
            problems.append("frontier rung 0 differs from the plain s5p_partition")
        if frac == 1.0 and r.mode != "in_memory":
            problems.append(f"frontier rung 1.0 planned {r.mode}")
        problems += _launch_problems(f"frontier {frac}", rl, fwant)
        prev = r.rf
    info["frontier"] = {"graph": f"block_rmat_graph({FRONTIER_BLOCK_SCALE}, 8, 8, seed=0)",
                        "V": int(fn), "E": fE, "k": k, "plain_s5p_s": plain_s, "rows": rows}

    info["launches"] = totals
    info["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "hybrid", "step": "done", "phase_s": info["phase_s"], "launches": totals})
    if problems:
        raise SystemExit("chip_smoke hybrid phase failed: " + "; ".join(problems))
    return info


def _compress(schedule) -> str:
    from repro_torch.streaming.parallel import _compress_schedule

    return _compress_schedule(schedule)


def _compare_retract(main, hdrf_parts, s_t, d_t) -> dict:
    """The delete path: retract the HDRF stream's last chunk from the
    run's final carry with ``HdrfCarry.retract_chunk`` (launch counters
    set to 0 just before, read just after).  The carry must then equal the
    one rebuilt from the parts without that chunk; the partial degrees
    lose every entry of the chunk."""
    import torch

    from repro_torch.kernels.stream_scan import HdrfCarry

    n, k = main["n"], main["cfg"].k
    E = int(s_t.numel())
    L = 1 << 16
    start = (math.ceil(E / L) - 1) * L
    carry = HdrfCarry(n, k, lam=1.1, device="cuda").init()
    for leaf, t in zip(carry[:3], _scoring_state(main, hdrf_parts, hdrf=True)):
        leaf.copy_(t)
    src, dst = s_t[start:].contiguous(), d_t[start:].contiguous()
    chunk_parts = hdrf_parts[start:].contiguous()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    carry = HdrfCarry(n, k, lam=1.1, device="cuda").retract_chunk(
        carry, src, dst, E - start, chunk_parts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    kept = hdrf_parts.clone()
    kept[start:] = -1
    want = _scoring_state(main, kept, hdrf=True)
    want[2] -= torch.bincount(torch.cat([src, dst]).long(), minlength=n).to(torch.int32)
    restored = all(torch.equal(a, b) for a, b in zip(carry[:3], want))
    info = {"phase": "compare", "step": "hdrf retract of the last chunk",
            "edges": E - start, "seconds": dt, "launches": launches,
            "restored": restored}
    emit(info)
    return info


def _scoring_state(main, parts, hdrf: bool, n_edges: int | None = None):
    """The (load, rep[, pd]) of a Greedy/HDRF run over the main graph's
    first ``n_edges`` edges (default all), rebuilt from their parts: the
    counted tables are functions of them, and pd counts every endpoint
    entry, the last chunk's (0, 0) padding too."""
    import torch

    from repro_torch.core.clustering import compute_degrees

    n, k = main["n"], main["cfg"].k
    m = int(main["src"].shape[0]) if n_edges is None else n_edges
    s = torch.from_numpy(main["src"][:m]).cuda()
    d = torch.from_numpy(main["dst"][:m]).cuda()
    ok = (parts[:m] >= 0).to(torch.int32)
    p = parts[:m].clamp(min=0).long()
    load = torch.zeros(k, dtype=torch.int32, device="cuda").index_add_(0, p, ok)
    rep = torch.zeros(n * k, dtype=torch.int32, device="cuda")
    rep.index_add_(0, s.long() * k + p, ok).index_add_(0, d.long() * k + p, ok)
    state = [load, rep.view(n, k)]
    if hdrf:
        pd = compute_degrees(s, d, n)
        if n_edges is None:
            pad = (-s.numel()) % (1 << 16) if s.numel() > (1 << 16) else 0
            pd[0] += 2 * pad
        state.append(pd)
    return state


def _k3_bytes(src, dst, parts, uniq, k, hdrf, retract):
    """Each input read once, each output written once: edge ids and parts
    (read too on retract), the touched replica rows read whole, the
    partial degrees (HDRF) in and out, the loads, and of the table only the
    32-byte sectors (8 counters) that hold a changed counter."""
    import torch

    E = int(src.numel())
    ok = parts >= 0
    p = parts[ok].long()
    cells = torch.cat([src[ok].long() * k + p, dst[ok].long() * k + p])
    sectors = int(torch.unique(cells // 8).numel())
    return ((16 if retract else 12) * E + uniq * k * 4 + (8 * uniq if hdrf else 0)
            + 32 * sectors + 8 * k)


def _k3_row(label, mode, sign, state0, src, dst, parts_in, rt, launches, shape):
    """K3 on card tensors from ``state0`` against the plain version on the
    same inputs, bitwise, and two launches against each other.  Returns the
    row and the kernel's (parts, load, rep, pd)."""
    import torch

    from repro_torch.kernels.stream_scan import scoring_chunk_oracle, scoring_scan
    from repro_torch.kernels.stream_scan.latency import latency_bound_ms
    from repro_torch.kernels.stream_scan.plan import scoring_plan

    hdrf = mode == "hdrf"
    E = int(src.numel())
    k = int(state0[0].numel())
    work = [t.clone() for t in state0]
    lam = 1.1 if hdrf else None
    kw = dict(mode=mode, sign=sign, parts=parts_in, n_valid=E if sign < 0 else None)
    got = {}

    def reset():
        for w, t in zip(work, state0):
            w.copy_(t)

    def run():
        got["out"] = scoring_scan(src, dst, *work[:2], work[2] if hdrf else None, lam, **kw)

    ms = cuda_time_ms(run, reps=3, setup=reset)
    same = twice(run, reset, lambda: got["out"])
    out = got["out"]
    plain = [t.to("cpu", copy=True) for t in state0]
    ckw = dict(kw, parts=None if parts_in is None else parts_in.cpu())
    want = {}

    def run_plain():
        want["out"] = scoring_chunk_oracle(src.cpu(), dst.cpu(), *plain[:2],
                                           plain[2] if hdrf else None, lam, **ckw)

    plain_ms = host_time_ms(run_plain)
    diff = first_diff(out, want["out"], ("parts", "load", "rep", "pd"))
    err = max(max_abs_err(g, w) for g, w in zip(out, want["out"]) if w is not None)
    uniq = int(torch.unique(torch.cat([src, dst])).numel())
    b, by = bound_ms(_k3_bytes(src, dst, out[0], uniq, k, hdrf, sign < 0),
                     (12 if hdrf else 8) * k * E)
    p = scoring_plan(k)
    chain = "K3 retract" if sign < 0 else f"K3 {mode}"
    row = {"name": label, "route": "cuda",
           "source": "src/repro_torch/kernels/stream_scan/csrc/scoring_scan.cu",
           "replaces": "src/repro/kernels/stream_scan/kernel.py:124",
           "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
           "library_ms": None, "latency_bound_ms": latency_bound_ms(chain, E, rt),
           "shape": {"V": int(state0[1].shape[0]), "k": k, "chunk": E,
                     "distinct_vertices": uniq, "rung": p.rung, "tile": p.tile,
                     "bitwise": diff is None and same, "first_diff": diff,
                     "equal_on_two_launches": same, **shape}}
    return row, out


def check_k3_g1(main, compare, rt) -> list[dict]:
    """K3 where the Greedy and HDRF rows run it: 65,536-edge chunks from the
    empty state and from the state after half the chunks, insert and then
    the retract of what that insert placed, in both modes; and the 4,096-edge
    rows onto the compare run's final state.  G1 on the grid row's chunk.
    The first three rows are the main path's: Greedy and HDRF inserts and
    HDRF's retract, mid-stream."""
    import torch

    from repro_torch.core.baselines import _grid_dims, _grid_rowcol
    from repro_torch.kernels.stream_scan import grid_chunk_oracle, grid_scan
    from repro_torch.kernels.stream_scan.latency import latency_bound_ms

    n, k = main["n"], main["cfg"].k
    L = 1 << 16
    E_all = int(main["src"].shape[0])
    mid = math.ceil(E_all / L) // 2
    launches = compare["launches"]
    n_ret = compare["retract"]["launches"]["scoring_retract"]
    made = {}
    for mode in ("greedy", "hdrf"):
        hdrf = mode == "hdrf"
        parts = compare["parts"][mode]
        for st in ("mid", "empty"):
            c = mid if st == "mid" else 0
            if st == "mid":
                state0 = _scoring_state(main, parts, hdrf, n_edges=mid * L)
            else:
                state0 = [torch.zeros(k, dtype=torch.int32, device="cuda"),
                          torch.zeros((n, k), dtype=torch.int32, device="cuda")]
                if hdrf:
                    state0.append(torch.zeros(n, dtype=torch.int32, device="cuda"))
            src, dst = main_chunk(main, c)
            shape = {"state": st, "chunk_index": c}
            ins, out = _k3_row(f"K3 scoring_scan {mode} insert, {st} state", mode, 1,
                               state0, src, dst, None, rt, launches[mode]["scoring_scan"],
                               shape)
            after = [t.clone() for t in out[1:] if t is not None]
            ret, undone = _k3_row(f"K3 scoring_scan {mode} retract (sign=-1), {st} state",
                                  mode, -1, after, src, dst, out[0].clone(), rt,
                                  n_ret if hdrf else 0, shape)
            # the retract gives back exactly what the insert added
            ret["shape"]["restores_state"] = first_diff(
                undone[1:], state0, ("load", "rep", "pd")) is None
            ret["shape"]["bitwise"] &= ret["shape"]["restores_state"]
            made[mode, st, 1], made[mode, st, -1] = ins, ret
            del state0, after, out, undone
    # the main path's three: Greedy's and HDRF's inserts and HDRF's retract
    main_rows = [made.pop(("greedy", "mid", 1)), made.pop(("hdrf", "mid", 1)),
                 made.pop(("hdrf", "mid", -1))]
    extra = list(made.values())

    E = 4096
    src, dst = (torch.from_numpy(a[:E]).cuda() for a in (main["src"], main["dst"]))
    g_state = _scoring_state(main, compare["parts"]["greedy"], hdrf=False)
    extra.append(_k3_row("K3 scoring_scan greedy insert, 4,096 edges, final state",
                         "greedy", 1, g_state, src, dst, None, rt,
                         launches["greedy"]["scoring_scan"], {"state": "final"})[0])
    del g_state
    h_state = _scoring_state(main, compare["parts"]["hdrf"], hdrf=True)
    row, out = _k3_row("K3 scoring_scan hdrf insert, 4,096 edges, final state", "hdrf", 1,
                       h_state, src, dst, None, rt, launches["hdrf"]["scoring_scan"],
                       {"state": "final"})
    extra.append(row)
    after = [t.clone() for t in out[1:]]
    extra.append(_k3_row("K3 scoring_scan hdrf retract (sign=-1), 4,096 edges, final state",
                         "hdrf", -1, after, src, dst, out[0].clone(), rt, n_ret,
                         {"state": "final"})[0])
    del h_state, after, out

    # G1: the grid row's chunk, onto the loads of the chunks before it
    _, c = _grid_dims(k)
    row_t, col_t = _grid_rowcol(n, k, c, 0, "cuda")
    gp = compare["parts"]["grid"][:mid * L]
    load0 = torch.zeros(k, dtype=torch.int32, device="cuda").index_add_(
        0, gp.clamp(min=0).long(), (gp >= 0).to(torch.int32))
    load = load0.clone()
    src, dst = main_chunk(main, mid)
    E = int(src.numel())
    ms = cuda_time_ms(lambda: grid_scan(load, row_t, col_t, c, src, dst), reps=10,
                      setup=lambda: load.copy_(load0))
    load.copy_(load0)
    got = grid_scan(load, row_t, col_t, c, src, dst)
    torch.cuda.synchronize()
    want = {}
    rc, cc, cs, cd = row_t.cpu(), col_t.cpu(), src.cpu(), dst.cpu()
    plain_ms = host_time_ms(lambda: want.__setitem__(
        "out", grid_chunk_oracle(load0.to("cpu", copy=True), rc, cc, c, cs, cd)))
    err = max(max_abs_err(a, b) for a, b in zip(got, want["out"]))
    uniq = int(torch.unique(torch.cat([src, dst])).numel())
    # edge ids in, parts out; row[·] and col[·] of each touched vertex; loads
    b, by = bound_ms(12 * E + uniq * 8 + 8 * k, 6 * E)
    g1 = {"name": "G1 grid_scan", "route": "cuda",
          "source": "src/repro_torch/kernels/stream_scan/csrc/scoring_scan.cu",
          "replaces": "src/repro/kernels/stream_scan/ref.py:191 (lax.scan, no Pallas kernel)",
          "launches": launches["grid"]["grid_scan"], "max_abs_err": err,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
          "library_ms": None, "latency_bound_ms": latency_bound_ms("G1", E, rt),
          "shape": {"V": n, "k": k, "chunk": E, "distinct_vertices": uniq,
                    "state": "mid", "chunk_index": mid}}
    return [*main_rows, g1], extra


def kernel_plan() -> dict:
    """K1's tile, K2's shared bytes and K3's rung and tile for k = 8, 32, 256
    and 4,096, as ``plan`` sizes them and as the C sources lay out their
    bytes (which must agree)."""
    from repro_torch.kernels.stream_scan import kernel as scan_k
    from repro_torch.kernels.stream_scan import plan

    k1_c = scan_k._lib().cluster_smem_bytes(plan.K1_TILE)
    info = {"phase": "kernel_plan",
            "k1": {"tile": plan.K1_TILE, "threads": plan.K1_THREADS,
                   "smem_bytes": plan.cluster_smem_bytes(plan.K1_TILE),
                   "smem_bytes_c": k1_c},
            "k3": {}}
    bad = k1_c != info["k1"]["smem_bytes"]
    info["k2"] = {"tile": plan.K2_TILE, "threads": plan.K2_THREADS}
    for k in (8, 32, 256, 4096):
        info["k2"][k] = {"smem_bytes": plan.assign_smem_bytes(k),
                         "smem_bytes_c": scan_k._lib().assign_smem_bytes(k)}
        bad |= info["k2"][k]["smem_bytes"] != info["k2"][k]["smem_bytes_c"]
    for k in (8, 32, 256, 4096):
        p = plan.scoring_plan(k)
        c_bytes = scan_k._scoring_lib().scoring_smem_bytes(
            k, p.tile if p.rung == "shared" else 0)
        info["k3"][k] = {"rung": p.rung, "tile": p.tile, "smem_bytes": p.smem_bytes,
                         "smem_bytes_c": c_bytes}
        bad |= c_bytes != p.smem_bytes
    emit(info)
    if bad:
        raise SystemExit(f"chip_smoke: plan and C sources disagree on shared bytes: {info}")
    return info


_COUNTERS = {"K1": "cluster_scan", "K2": "assign_scan", "K3": "scoring_scan",
             "G1": "grid_scan", "K4a": "cms_update", "K4b": "cms_query", "K5": "segment_agg",
             "K6": "flash_attention", "K7": "cin", "K6b": "flash_attention_bwd",
             "K7b": "cin_bwd", "K5ᵀ": "segment_agg_transposed"}


def phase_kernels(main, compare, serve, gnn3d, lm, moe, recsys, build, incremental,
                  elastic, hybrid, train) -> list[dict]:
    from repro_torch.kernels.stream_scan.latency import measure_round_trips

    rt = measure_round_trips()
    emit({"phase": "latency_probe", **rt, "nvidia_smi_clocks_sm": nvidia_smi_line("clocks.sm")})
    kernel_plan()
    k1 = check_k1(main, rt)
    k2 = check_k2(main, rt)
    cms = check_cms(main, serve, incremental)
    k3_g1, k3_extra = check_k3_g1(main, compare, rt)
    k5 = check_k5(serve)
    k5_gnn3d = check_k5_gnn3d(serve, gnn3d)
    k6 = check_k6(lm["launches"]["flash_attention"] + moe["launches"]["flash_attention"],
                  build)
    k7 = check_k7(recsys, build)
    k6b = [r for r in train["rows"] if r["name"].startswith("K6b")]
    k7b = [r for r in train["rows"] if r["name"].startswith("K7b")]
    k5t = [r for r in train["rows"] if r["name"].startswith("K5ᵀ")]
    rows = [*k1, *k2, *cms, *k3_g1, *k3_extra, *k5, *k5_gnn3d, *k6, *k7, *k6b, *k7b, *k5t]
    _check_rows(rows)
    main_k2 = k2[1]  # the main path's middle chunk
    main_k4 = [r for r in cms if r["name"] in ("K4a cms_update", "K4b cms_query")
               or "negative counts" in r["name"]]
    summary = [k1[0], main_k2, *main_k4, *k3_g1, *k5, *k5_gnn3d, k6[0], k7[1], k6b[0],
               k7b[-1], k5t[0]]
    for r in summary:  # a latency bound for the serial scans, none for the rest
        r.setdefault("latency_bound_ms", None)
        # the launches of phases incremental's, elastic's, hybrid's and
        # gnn3d's paths (K3: inserts, and retracts apart)
        for phase, totals in (("incremental", incremental["launches"]),
                              ("elastic", elastic["launches"]),
                              ("hybrid", hybrid["launches"]),
                              ("gnn3d", gnn3d["launches"])):
            r[f"launches_{phase}"] = totals.get(_COUNTERS.get(r["name"].split()[0]), 0)
            if r["name"].startswith("K3"):
                r[f"launches_{phase}_retract"] = totals.get("scoring_retract", 0)
    return summary, rows


def _check_rows(rows) -> None:
    """Each row within its stated limits, or else its tolerance (0 unless it
    states one)."""
    for r in rows:
        emit({"phase": "kernel", **r})
    bad = [r["name"] for r in rows
           if (not _within(r["shape"]["errors"], r["shape"]["limits"])
               if "limits" in r["shape"] else
               r["max_abs_err"] > r["shape"].get("tolerance", 0)
               or not r["shape"].get("bitwise", True))]
    if bad:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {bad}")


def _latency(us: list) -> dict:
    import numpy as np

    a = np.asarray(us, np.float64)
    return {"n": int(a.size), "mean_us": float(a.mean()), "p99_us": float(np.percentile(a, 99))}


def phase_serve(products_scale: float) -> dict:
    """The serving read side over the products-shaped graph: S5P, bundle,
    registry, PageRank supersteps and queries, GCN inference through K5."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.core.metrics import load_balance, replication_factor
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.models.gnn import gcn_forward, gcn_init
    from repro_torch.serving import BundleRegistry, GASServer, build_bundle

    g, feats_np, graph_s, feats_s = _serve_data(products_scale)
    n, E = g.n_vertices, int(g.src.size)
    # gcn-cora at the ogb_products shape's d_feat, as launch/cells.py sizes it
    cfg = dataclasses.replace(get_arch("gcn-cora").config,
                              d_feat=get_arch("gcn-cora").shapes["ogb_products"]["d_feat"])
    dev = torch.device("cuda")
    params = gcn_init(cfg, trandom.PRNGKey(0), device=dev)
    feats = torch.from_numpy(feats_np).to(dev)
    rng = np.random.default_rng(0)
    problems = []

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = s5p_partition(g.src, g.dst, n, S5PConfig(k=32), device=dev)
    torch.cuda.synchronize()
    s5p_s = time.perf_counter() - t0
    game_k5 = launch_counts()["segment_agg"]  # the game's degree sums and ordered sums
    s_t, d_t = torch.from_numpy(g.src).to(dev), torch.from_numpy(g.dst).to(dev)
    rf = replication_factor(s_t, d_t, out.parts, n_vertices=n, k=32)
    bal = load_balance(out.parts, k=32)
    del s_t, d_t
    t0 = time.perf_counter()
    bundle = build_bundle(1, g.src, g.dst, out.parts.cpu().numpy(), n, 32, rf=rf,
                          balance=bal, device=dev)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    registry = BundleRegistry()
    registry.publish(bundle)
    server = GASServer(registry)
    t0 = time.perf_counter()
    server.run(10)
    torch.cuda.synchronize()
    supersteps_s = time.perf_counter() - t0
    lat = server.metrics.query_latency_us

    pr_vals = [server.query_pagerank(rng.integers(0, n, 16)) for _ in range(16)]
    pr_lat = lat[-16:]
    labels = server.query_components(5)
    comp_lat = lat[-1:]

    from repro_torch.kernels.segment_agg import launch_counts as k5_counts

    def k5_delta(fn):
        before = k5_counts()["segment_agg"]
        res = fn()
        return res, k5_counts()["segment_agg"] - before

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_dev, fwd_k5 = k5_delta(lambda: gcn_forward(params, feats, bundle.edge_src,
                                                      bundle.edge_dst, n, cfg, device=dev))
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    del logits_dev
    logits, full_k5 = k5_delta(lambda: server.query_gnn(params, feats, cfg))
    full_lat = lat[-1:]
    point_k5 = []
    for _ in range(16):
        vs = rng.integers(0, n, 16)
        got, k5 = k5_delta(lambda: server.query_gnn(params, feats, cfg, vertices=vs))
        point_k5.append(k5)
        if not np.array_equal(got, logits[vs]):
            problems.append("query_gnn for 16 vertices differs from the full query's rows")
    gnn_lat = lat[-16:]
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gnn_profile = _profile_query_gnn(server, params, feats, cfg)
    audit = _game_audit(out, g.src, g.dst)
    problems += _audit_problems("serve", audit)
    theta = theta_capture(g.src, g.dst, out, S5PConfig(k=32))

    # the same forward on the CPU, through the plain K5
    t0 = time.perf_counter()
    params_cpu = {"layers": [{"w": layer["w"].cpu()} for layer in params["layers"]]}
    want = gcn_forward(params_cpu, feats_np, g.src, g.dst, n, cfg, device="cpu").numpy()
    cpu_forward_s = time.perf_counter() - t0
    close = bool(np.allclose(logits, want, rtol=1e-4, atol=1e-5))
    max_abs = float(np.abs(logits - want).max())

    n_chunks = math.ceil(E / S5PConfig(k=32).chunk_size)
    if fwd_k5 != 6 or full_k5 != 6 or any(k != 6 for k in point_k5):
        problems.append(f"K5 launches per forward {fwd_k5}, {full_k5}, {point_k5}, not 6")
    want_k5 = 2 + out.aux["game"]["ordered_sums"]
    if game_k5 != want_k5 or launches["segment_agg"] - game_k5 != 10 + 6 * 18:
        problems.append(f"K5 launched {launches['segment_agg']} times, {game_k5} in S5P's "
                        f"game: not {want_k5} + 10 PageRank supersteps + 6 x 18")
    if not theta["ends_at_run_sketch"]:
        problems.append("the replayed Θ stream does not end at the run's sketch")
    if launches["cluster_scan"] != n_chunks or launches["assign_scan"] != n_chunks:
        problems.append(f"K1/K2 launches {launches} != {n_chunks} chunks")
    if launches["cms_update"] < 1 or launches["cms_query"] < 1:
        problems.append(f"CMS kernels not launched: {launches}")
    if not close:
        problems.append(f"cuda logits differ from cpu beyond rtol 1e-4, atol 1e-5 (max {max_abs})")
    if logits.shape != (n, cfg.n_classes) or not np.isfinite(logits).all():
        problems.append(f"logits of shape {logits.shape}, or not finite")
    if not all(np.isfinite(v).all() and (v > 0).all() and v.shape == (16,) for v in pr_vals):
        problems.append("PageRank values not finite and positive")
    if labels.shape != (n,) or (labels > np.arange(n)).any() or labels.min() < 0:
        problems.append("component labels outside [0, v]")
    if not 1.0 <= rf <= 32:
        problems.append(f"RF {rf} outside [1, k]")
    info = {
        "phase": "serve", "graph": f"ogbn_products_like(seed=0, scale={products_scale})",
        "V": n, "E": E, "k": 32, "generate_graph_s": graph_s, "generate_features_s": feats_s,
        "s5p_s": s5p_s, "s5p_seconds": out.timings, "rf": rf, "balance": bal,
        "sync_bytes_per_superstep": server.metrics.bytes_per_superstep(),
        "layout_s": layout_s, "supersteps": 10, "supersteps_s": supersteps_s,
        "latency": {"query_pagerank": _latency(pr_lat),
                    "query_components": _latency(comp_lat),
                    "query_gnn_all": _latency(full_lat),
                    "query_gnn_16": _latency(gnn_lat)},
        "gcn": {"d_feat": cfg.d_feat, "d_hidden": cfg.d_hidden, "n_classes": cfg.n_classes,
                "forward_s": forward_s, "k5_per_forward": fwd_k5,
                "cpu_forward_s": cpu_forward_s, "max_abs_err_vs_cpu": max_abs,
                "within_rtol_1e-4": close},
        "components": int(np.unique(labels).size),
        "max_memory_allocated": peak, "launches": launches,
        "query_gnn_profile": gnn_profile, "game_audit": audit,
        "theta_stream": {key: theta[key] for key in ("n_chunks", "pairs_streamed",
                                                      "ends_at_run_sketch")},
    }
    for step, keys in (("graph", ("graph", "V", "E", "generate_graph_s", "generate_features_s")),
                       ("s5p", ("k", "rf", "balance", "s5p_s", "s5p_seconds", "game_audit",
                                "theta_stream")),
                       ("gas", ("sync_bytes_per_superstep", "layout_s", "supersteps",
                                "supersteps_s", "components")),
                       ("latency", ("latency", "query_gnn_profile")), ("gcn", ("gcn",)),
                       ("device", ("max_memory_allocated", "launches"))):
        emit({"phase": "serve", "step": step, **{key: info[key] for key in keys}})
    if problems:
        raise SystemExit("chip_smoke serve phase failed: " + "; ".join(problems))
    return {"info": info, "params": params, "feats": feats, "bundle": bundle, "cfg": cfg,
            "launches": launches, "theta": theta, "pairs": (out.aux["incremental"]["pair_a"],
                                                            out.aux["incremental"]["pair_b"]),
            "sketch": out.aux["sketch"]}


def _profile_query_gnn(server, params, feats, cfg) -> dict:
    """One more ``query_gnn`` (all vertices) under ``torch.profiler``: its
    device time split into K5, the sorts of ``gcn_norm``'s two layouts, the
    matmuls and the rest, against the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def group(name: str) -> str:
        low = name.lower()
        if "segment_agg_kernel" in name:
            return "k5"
        if "sort" in low or "radix" in low or "onesweep" in low:
            return "sort"
        if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90_")):
            return "matmul"
        return "other"

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.query_gnn(params, feats, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type is not None and "cuda" in str(e.device_type).lower():
            groups[group(e.key)] = groups.get(group(e.key), 0.0) + us / 1e3
            kernels.append({"name": e.key[:90], "calls": e.count, "device_ms": us / 1e3})
    busy = sum(groups.values())
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_ms_by_group": groups, "k5_ms": groups.get("k5", 0.0),
            "rest_device_ms": busy - groups.get("k5", 0.0),
            "top_kernels": sorted(kernels, key=lambda k: -k["device_ms"])[:10]}


def check_k5(serve) -> list[dict]:
    """K5 at the serve phase's shapes against the plain version on the CPU."""
    import torch

    from repro_torch.models.gnn import gcn_layer, gcn_norm

    bundle, params, feats = serve["bundle"], serve["params"], serve["feats"]
    n = bundle.n_vertices
    norm = gcn_norm(bundle.edge_src, bundle.edge_dst, n, device="cuda")
    lay = norm.fwd  # the forward direction's layout, the GCN's weights
    x1 = feats @ params["layers"][0]["w"]
    x2 = torch.relu(gcn_layer(x1, norm)) @ params["layers"][1]["w"]
    unit = lay.with_weights(torch.ones(lay.n_edges, device="cuda"))
    cases = [("K5 segment_agg degrees (d=1, f32)", torch.ones(n, 1, device="cuda"), unit),
             ("K5 segment_agg layer 1 (d=16, f32)", x1, lay),
             ("K5 segment_agg layer 2 (d=7, f32)", x2, lay),
             ("K5 segment_agg features (d=100, bf16)", feats.to(torch.bfloat16), lay)]
    return [_k5_row(name, x, layout, serve["launches"]["segment_agg"])
            for name, x, layout in cases]


def _k5_row(name, x, layout, launches: int, plain_rows: int | None = None) -> dict:
    """K5 on ``x`` over ``layout`` against the plain version on the CPU over
    the layout's first ``plain_rows`` rows (all by default; a slice is fed
    its rows' inputs gathered in layout order, the same products in the
    same order): bits, time, the bound and ``torch.sparse.mm`` on the same
    CSR (bf16 weights for bf16 ``x``)."""
    import torch

    from repro_torch.kernels.segment_agg import kernel_attributes, segment_agg, segment_agg_ref

    x = x.contiguous()
    n_rows, E, n_src = layout.n_rows, int(layout.src.numel()), int(x.shape[0])
    d, esize = int(x.shape[1]), x.element_size()
    n_long = int(layout.long_rows.numel())
    flags = torch.zeros(n_long, dtype=torch.int32, device=x.device)
    segment_agg(x, layout, tree_flags=flags)
    ms = cuda_time_ms(lambda: segment_agg(x, layout), reps=5)
    got = segment_agg(x, layout)
    torch.cuda.synchronize()
    R = n_rows if plain_rows is None else min(plain_rows, n_rows)
    cnt = int(layout.row_ptr[R])
    if R == n_rows:
        x_in, ids = x.cpu(), layout.src.cpu()
    else:  # only the rows' inputs, gathered in layout order
        x_in, ids = x[layout.src[:cnt].long()].cpu(), torch.arange(cnt, dtype=torch.int32)
    dst, w = layout.dst[:cnt].cpu(), layout.w[:cnt].cpu()
    want = {}
    plain_ms = host_time_ms(lambda: want.__setitem__("out", segment_agg_ref(x_in, ids, dst, w,
                                                                            R)))
    g, w_out = got[:R].cpu(), want["out"]
    if g.shape != w_out.shape or g.dtype != w_out.dtype:
        raise SystemExit(f"chip_smoke: K5 gave {g.shape} {g.dtype}, not {w_out.shape} "
                         f"{w_out.dtype}")
    err = float((g.float() - w_out.float()).abs().max()) if g.numel() else 0.0
    bits = torch.int32 if g.dtype == torch.float32 else torch.int16
    bitwise = torch.equal(g.view(bits), w_out.view(bits))
    # each input read once, each output written once
    n_bytes = 8 * E + 8 * (n_rows + 1) + n_src * d * esize + n_rows * d * esize
    b, by = bound_ms(n_bytes, 2 * E * d)
    # no reuse of gathered rows: each costs at least one 32-byte sector
    sectors = -(-d * esize // 32) * 32
    no_reuse, _ = bound_ms(8 * E + 8 * (n_rows + 1) + E * sectors + n_rows * d * esize, 0)
    csr = torch.sparse_csr_tensor(layout.row_ptr, layout.src.long(), layout.w.to(x.dtype),
                                  size=(n_rows, n_src))
    lib_ms, lib_error = None, None
    try:
        lib_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, x), reps=5)
    except RuntimeError as e:  # a yardstick only: record why there is none
        lib_error = str(e).splitlines()[0]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/segment_agg/csrc/segment_agg.cu",
            "replaces": "src/repro/kernels/segment_agg/kernel.py:61",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms,
            "shape": {"rows": n_rows, "V": n_src, "d": d, "dtype": str(x.dtype),
                      "bitwise": bitwise, "edges": E, "plain_rows": R, "plain_edges": cnt,
                      "max_row": int(layout.row_ptr.diff().max()),
                      "long_row_edges": layout.long_row_edges, "n_long": n_long,
                      "tree_rows": int(flags.sum()), "kernel": kernel_attributes(x),
                      "no_reuse_bound_ms": no_reuse,
                      "library": "torch.sparse.mm(CSR of the weights, x)",
                      "library_error": lib_error}}


# ------------------------------------------------------------- phase gnn3d

GNN3D_MODELS = ("schnet", "egnn", "dimenet")
# the card's energies against the port's CPU forward (plain K5): |Δ| over
# the largest |energy|; the matmuls sum in other orders, exp/cos/softplus
# differ by an ulp
GNN3D_TOL = 1e-4
K5_SLICE_ROWS = 1 << 16  # the ogb_products K5 row's plain check: its first rows
F32_SQRT_MAX = 1.8446743e19  # ~√(float32 max): a larger error's square is inf


def _pad512(n: int) -> int:
    """``launch/cells.py``'s padding of a GNN batch's counts."""
    return -(-n // 512) * 512


def _molecule_inputs() -> dict:
    """``molecule_batch(128, 30, 64, seed=0)`` flattened with ``graph_idx``
    and padded as the reference's molecule cell pads it: V 4,096, E 8,192,
    T = 4E from ``build_triplets``; masks on the padding."""
    import numpy as np

    from repro_torch.graphs import molecule_batch
    from repro_torch.models.gnn import build_triplets

    B, N, Em = 128, 30, 64
    mb = molecule_batch(B, N, Em, seed=0)
    V, E = _pad512(B * N), _pad512(B * Em)
    off = (np.arange(B) * N)[:, None]
    pos = np.zeros((V, 3), np.float32)
    pos[:B * N] = mb.positions.reshape(-1, 3)
    species = np.zeros(V, np.int32)
    species[:B * N] = mb.species.reshape(-1)
    es, ed = np.zeros(E, np.int32), np.zeros(E, np.int32)
    es[:B * Em], ed[:B * Em] = (mb.edge_src + off).reshape(-1), (mb.edge_dst + off).reshape(-1)
    graph_idx = np.zeros(V, np.int32)
    graph_idx[:B * N] = np.repeat(np.arange(B), N)
    kj, ji, tm = build_triplets(es, ed, 4 * E)
    return {"species": species, "positions": pos, "edge_src": es, "edge_dst": ed,
            "edge_mask": (np.arange(E) < B * Em).astype(np.float32),
            "node_mask": (np.arange(V) < B * N).astype(np.float32),
            "graph_idx": graph_idx, "n_graphs": B, "targets": mb.energies,
            "tri_kj": kj, "tri_ji": ji, "tri_mask": tm}


def _minibatch_inputs(sub, pos_all, species_all) -> dict:
    """One ``NeighborSampler`` batch as the reference's ``minibatch_lg``
    cell shapes it (no ``graph_idx``: one energy, target 0), T = 2E."""
    import numpy as np

    from repro_torch.models.gnn import build_triplets

    E = sub.edge_src.size
    kj, ji, tm = build_triplets(sub.edge_src, sub.edge_dst, 2 * E)
    return {"species": species_all[sub.nodes], "positions": pos_all[sub.nodes],
            "edge_src": sub.edge_src, "edge_dst": sub.edge_dst,
            "edge_mask": sub.edge_mask.astype(np.float32),
            "node_mask": sub.node_mask.astype(np.float32),
            "targets": np.zeros(1, np.float32), "tri_kj": kj, "tri_ji": ji, "tri_mask": tm}


def _to_device(batch: dict, dev) -> dict:
    import torch

    return {k: v if isinstance(v, int) else torch.as_tensor(v).to(dev)
            for k, v in batch.items()}


def _gnn3d_forward(name, params, b, cfg, dev, per_node: bool = False):
    """The model's forward on batch ``b`` (the loss's arguments); with
    ``per_node`` each node its own graph, so the result is ``e_atom``."""
    import torch

    from repro_torch.models import gnn

    V = int(b["species"].shape[0])
    kw = {"edge_mask": b.get("edge_mask"), "node_mask": b.get("node_mask"),
          "graph_idx": b.get("graph_idx"), "n_graphs": b.get("n_graphs", 1), "device": dev}
    if per_node:
        kw.update(graph_idx=torch.arange(V, dtype=torch.int32, device=dev), n_graphs=V)
    args = (params, b["species"], b["positions"], b["edge_src"], b["edge_dst"])
    if name == "dimenet":
        return gnn.dimenet_forward(*args, b["tri_kj"], b["tri_ji"], V, cfg,
                                   tri_mask=b.get("tri_mask"), **kw)
    fwd = gnn.schnet_forward if name == "schnet" else gnn.egnn_forward
    return fwd(*args, V, cfg, **kw)


def _gnn3d_k5_want(name, cfg, pooled: bool) -> int:
    """K5 launches a forward: the models' docstrings' counts."""
    if name == "schnet":
        n = cfg.n_interactions
    elif name == "egnn":
        n = 1 + 2 * cfg.n_layers
    else:
        n = 2 * cfg.n_blocks
    return n + int(pooled)


def phase_gnn3d(serve) -> dict:
    """SchNet, EGNN and DimeNet at their published configs (float32, seed 0)
    at three of ``GNN_SHAPES``, each call with the launch counters set to 0
    just before and read just after: ``molecule`` (``_molecule_inputs``),
    ``minibatch_lg`` (one ``NeighborSampler(build_csr(products), (15, 10),
    1,024, seed=0)`` batch of phase ``serve``'s graph: a cut, the shape's
    own graph is Reddit-sized; positions (standard normal, as the
    reference's cell draws them) and species in [0, 10) drawn from seed 0
    for every global vertex) and ``ogb_products`` (the whole
    graph, SchNet and EGNN: DimeNet's 2E triplets need ~70 GB for two
    (T, 128) tensors alone).  For each: the forward's seconds and the
    loss's (host clock ending in a synchronise), the loss and MAE, peak
    memory, K5 launches against ``_gnn3d_k5_want``, the energies finite
    (and the loss, unless an error's square passes float32's range, as
    EGNN's does over the graph's 392,195-edge hub), and at the first two
    shapes the greatest |Δ| from the port's CPU forward (plain K5) over the
    largest |value| (per node at ``minibatch_lg``), within
    :data:`GNN3D_TOL`."""
    import numpy as np
    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.graphs import NeighborSampler, build_csr
    from repro_torch.models import gnn

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bundle = serve["bundle"]
    n = bundle.n_vertices
    problems, runs, k5_total, data_s = [], [], 0, {}

    t0 = time.perf_counter()
    mol = _molecule_inputs()
    data_s["molecule"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = build_csr(bundle.edge_src, bundle.edge_dst, n, device=dev)
    data_s["build_csr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(csr, (15, 10), 1024, seed=0)
    sub = sampler.sample()
    data_s["sample"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    pos_all = rng.standard_normal((n, 3)).astype(np.float32)
    species_all = rng.integers(0, 10, n).astype(np.int32)
    mini = _minibatch_inputs(sub, pos_all, species_all)
    data_s["positions_and_triplets"] = time.perf_counter() - t0
    if (sampler.max_nodes, sampler.max_edges) != (_pad512(169_984), _pad512(168_960)):
        problems.append(f"minibatch_lg budget {sampler.max_nodes}, {sampler.max_edges}")
    products = {"species": torch.from_numpy(species_all).to(dev),
                "positions": torch.from_numpy(pos_all).to(dev),
                "edge_src": bundle.edge_src, "edge_dst": bundle.edge_dst,
                "targets": torch.zeros(1, device=dev)}
    shapes = (("molecule", mol, GNN3D_MODELS, "graph"),
              ("minibatch_lg", mini, GNN3D_MODELS, "node"),
              ("ogb_products", products, ("schnet", "egnn"), None))
    losses = {"schnet": gnn.schnet_loss, "egnn": gnn.egnn_loss, "dimenet": gnn.dimenet_loss}
    for shape, batch, models, check in shapes:
        b_dev = _to_device(batch, dev)
        b_cpu = _to_device(batch, "cpu") if check else None
        for name in models:
            cfg = get_arch(name).config
            params = {"schnet": gnn.schnet_init, "egnn": gnn.egnn_init,
                      "dimenet": gnn.dimenet_init}[name](cfg, trandom.PRNGKey(0), device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            pred = _gnn3d_forward(name, params, b_dev, cfg, dev)
            torch.cuda.synchronize()
            forward_s = time.perf_counter() - t0
            k5_fwd = launch_counts()["segment_agg"]
            reset_launch_counts()
            t0 = time.perf_counter()
            loss, aux = losses[name](params, b_dev, cfg, device=dev)
            loss_v, mae = float(loss), float(aux["mae"])
            loss_s = time.perf_counter() - t0
            k5_loss = launch_counts()["segment_agg"]
            peak = torch.cuda.max_memory_allocated()
            k5_total += k5_fwd + k5_loss
            want_k5 = _gnn3d_k5_want(name, cfg, "graph_idx" in batch)
            row = {"phase": "gnn3d", "shape": shape, "model": name,
                   "V": int(b_dev["species"].shape[0]), "E": int(b_dev["edge_src"].shape[0]),
                   "T": int(b_dev["tri_kj"].shape[0]) if name == "dimenet" else None,
                   "forward_s": forward_s, "loss_s": loss_s, "loss": loss_v, "mae": mae,
                   "energies": int(pred.numel()), "max_memory_allocated": peak,
                   "k5_forward": k5_fwd, "k5_loss": k5_loss, "k5_want": want_k5}
            if k5_fwd != want_k5 or k5_loss != want_k5:
                problems.append(f"{name} at {shape}: K5 {k5_fwd}, {k5_loss}, not {want_k5}")
            # an error past √(float32 max) overflows the loss's square, in the
            # reference too: the energies must be finite, the loss unless so
            overflows = mae > F32_SQRT_MAX
            row["loss_overflows_f32"] = overflows
            if not (torch.isfinite(pred).all() and np.isfinite(mae)
                    and (np.isfinite(loss_v) or overflows)):
                problems.append(f"{name} at {shape}: not finite")
            if check:  # comparison runs: not the path's launches
                got = _gnn3d_forward(name, params, b_dev, cfg, dev, per_node=check == "node")
                t0 = time.perf_counter()
                want = _gnn3d_forward(name, _tree_to(params, "cpu"), b_cpu, cfg, "cpu",
                                      per_node=check == "node")
                row["cpu_forward_s"] = time.perf_counter() - t0
                scale = float(want.abs().max())
                err = float((got.cpu() - want).abs().max()) / max(scale, 1e-30)
                row.update(compared=check, max_rel_err_vs_cpu=err, tolerance=GNN3D_TOL)
                if not err <= GNN3D_TOL:
                    problems.append(f"{name} at {shape}: {err} from the CPU forward")
                del got, want
            emit(row)
            runs.append(row)
            del params, pred, loss
        del b_dev, b_cpu
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    info = {"phase_s": phase_s, "data_s": data_s, "runs": runs,
            "skipped": {"dimenet@ogb_products": "2E = 58.7 M triplets: (T, 128) float32 "
                        "tensors of 30 GB each, and a host triplet list of that size"},
            "minibatch": {"nodes": int(sub.node_mask.sum()), "edges": int(sub.edge_mask.sum()),
                          "triplets": int(mini["tri_mask"].sum())},
            "launches": {"segment_agg": k5_total}}
    emit({"phase": "gnn3d", "step": "done", **{k: v for k, v in info.items() if k != "runs"}})
    if problems:
        raise SystemExit("chip_smoke gnn3d phase failed: " + "; ".join(problems))
    return {"info": info, "minibatch": mini, "launches": info["launches"]}


def check_k5_gnn3d(serve, gnn3d) -> list[dict]:
    """K5 at phase ``gnn3d``'s message sums: at ``minibatch_lg`` d = 64 into
    the nodes, d = 128 triplets into the edges and edges into the nodes,
    d = 3 (EGNN's ``dx``), bitwise against the plain version; at
    ``ogb_products`` d = 64 into the nodes, the plain check over the first
    :data:`K5_SLICE_ROWS` rows.  The messages are normal draws (seed 0)."""
    import torch

    from repro_torch.models.gnn import message_layout

    dev = torch.device("cuda")
    mini, launches = gnn3d["minibatch"], gnn3d["launches"]["segment_agg"]
    gen = torch.Generator(device=dev).manual_seed(0)
    E, T = mini["edge_src"].size, mini["tri_kj"].size
    into_nodes = message_layout(mini["edge_dst"], mini["species"].size, device=dev)
    into_edges = message_layout(mini["tri_ji"], E, device=dev)
    rows = []
    for label, layout, n_msg, d in (("messages into nodes", into_nodes, E, 64),
                                    ("triplets into edges", into_edges, T, 128),
                                    ("edges into nodes", into_nodes, E, 128),
                                    ("dx into nodes", into_nodes, E, 3)):
        x = torch.randn(n_msg, d, generator=gen, device=dev)
        rows.append(_k5_row(f"K5 segment_agg {label} (minibatch_lg, d={d}, f32)", x,
                            layout, launches))
    bundle = serve["bundle"]
    layout = message_layout(bundle.edge_dst, bundle.n_vertices, device=dev)
    x = torch.randn(int(bundle.edge_dst.numel()), 64, generator=gen, device=dev)
    rows.append(_k5_row("K5 segment_agg messages into nodes (ogb_products, d=64, f32)", x,
                        layout, launches, plain_rows=K5_SLICE_ROWS))
    del x, layout
    torch.cuda.empty_cache()
    return rows


def phase_parity() -> dict:
    import numpy as np

    from repro_torch.core.baselines import PARTITIONERS
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(2000, n_communities=32, avg_degree=8, seed=5)
    differing, seconds = {}, {}
    for name, fn in PARTITIONERS.items():
        t0 = time.perf_counter()
        gpu = fn(src, dst, n, 8, 0, device="cuda").cpu().numpy()
        t1 = time.perf_counter()
        cpu = fn(src, dst, n, 8, 0, device="cpu").numpy()
        seconds[name] = [t1 - t0, time.perf_counter() - t1]
        differing[name] = int((gpu != cpu).sum()) if gpu.shape == cpu.shape else -1
    # S = 4 lanes in every shard mode (chunks of 1,024 edges: 8 chunks)
    touch_up = {}
    for shard in ("range", "rr", "hub"):
        for name in ("s5p", "hdrf", "greedy", "grid"):
            kw = dict(chunk_size=1024, num_streams=4, shard=shard,
                      super_chunk="auto" if name in ("s5p", "hdrf") else 2)
            if name == "s5p":
                kw["full_output"] = True
            row = f"{name} S=4 {shard}"
            t0 = time.perf_counter()
            gpu = PARTITIONERS[name](src, dst, n, 8, 0, device="cuda", **kw)
            t1 = time.perf_counter()
            cpu = PARTITIONERS[name](src, dst, n, 8, 0, device="cpu", **kw)
            seconds[row] = [t1 - t0, time.perf_counter() - t1]
            if name == "s5p":
                tu = [{key: v for key, v in o.aux.get("touch_up", {}).items() if key != "game"}
                      for o in (gpu, cpu)]
                touch_up[row] = {"cuda": tu[0], "same": tu[0] == tu[1]}
                differing[row + " touch_up"] = int(tu[0] != tu[1])
                gpu, cpu = gpu.parts, cpu.parts
            gpu, cpu = gpu.cpu().numpy(), cpu.numpy()
            differing[row] = int((gpu != cpu).sum()) if gpu.shape == cpu.shape else -1
    same = all(v == 0 for v in differing.values())
    delta = _delta_above_2_24()
    merged = _merged_ids_past_v()
    incremental = _incremental_parity()
    elastic = _elastic_parity()
    hybrid = _hybrid_parity()
    info = {"phase": "parity", "graph": "community_graph(2000, 32, 8, seed=5)",
            "k": 8, "E": int(src.shape[0]), "parts_identical": same,
            "differing_edges": differing, "cuda_cpu_s": seconds, "touch_up": touch_up,
            "delta_above_2^24": delta, "merged_ids_past_V": merged,
            "incremental": incremental, "elastic": elastic, "hybrid": hybrid}
    emit(info)
    if not hybrid["same"] or not hybrid["retreated"]:
        raise SystemExit(f"chip_smoke: the hybrid sequence differs, cuda vs cpu, or its "
                         f"spill did not retreat: {hybrid}")
    if not elastic["same"]:
        raise SystemExit(f"chip_smoke: the elastic sequence differs, cuda vs cpu: {elastic}")
    if not incremental["same"]:
        raise SystemExit(f"chip_smoke: the incremental sequence differs, cuda vs cpu: "
                         f"{incremental}")
    if not merged["same"] or merged["next_t"] <= merged["V"] + 1:
        raise SystemExit(f"chip_smoke: Alg. 1 lanes merged past V + 1 differ, cuda vs cpu: "
                         f"{merged}")
    if not same:
        raise SystemExit(f"chip_smoke: cuda and cpu parts differ on the community graph: {differing}")
    if not delta["same"]:
        raise SystemExit(f"chip_smoke: the game's δ above 2**24 differs, cuda vs cpu: {delta}")
    return info


def _incremental_sequence(dev):
    """On ``community_graph(600, 8, 6, seed=3)``, k = 8, chunks of 256: a
    cold bundle of 90 % of the edges, the last 10 % inserted with
    refinement off and rolled back, then inserted under a drift threshold
    of 0 (refined), a decremental deletion of 10 % (seed 1), and four
    steps of an ``S5PWindowChain`` (window 512, step 256: a fill step, the
    cold start, two steady steps).  Returns the bundles and the results."""
    import numpy as np

    from repro_torch.core.s5p import S5PConfig
    from repro_torch.graphs import community_graph
    from repro_torch.incremental import (S5PWindowChain, s5p_apply_delta, s5p_apply_deletion,
                                         s5p_cold_bundle)

    src, dst, n = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    E = src.size
    E0 = int(E * 0.9)
    inf = float("inf")
    cfg = S5PConfig(k=8, chunk_size=256, drift_rf_threshold=inf,
                    drift_balance_threshold=inf, drift_churn_threshold=inf)
    _, b0 = s5p_cold_bundle(src[:E0], dst[:E0], n, cfg, device=dev)
    b1, r1 = s5p_apply_delta(b0, cfg, src, dst, E0, device=dev)
    b2, r2 = s5p_apply_deletion(b1, cfg, src, dst, np.arange(E0, E), device=dev)
    cfg_r = S5PConfig(k=8, chunk_size=256, drift_rf_threshold=0.0)
    b3, r3 = s5p_apply_delta(b0, cfg_r, src, dst, E0, device=dev)
    idx = np.sort(np.random.default_rng(1).choice(E, E // 10, replace=False))
    b4, r4 = s5p_apply_deletion(b3, cfg_r, src, dst, idx, device=dev)
    chain = S5PWindowChain(src, dst, n, cfg_r, 512, step_edges=256, device=dev)
    steps = [chain.step() for _ in range(4)]
    return [b0, b1, b2, b3, b4, chain.bundle], [r1, r2, r3, r4, *steps]


def _incremental_parity() -> dict:
    """``_incremental_sequence`` on cuda and on cpu: every bundle leaf and
    every result field equal."""
    import numpy as np

    t0 = time.perf_counter()
    gb, gr = _incremental_sequence("cuda")
    t1 = time.perf_counter()
    cb, cr = _incremental_sequence("cpu")
    diffs = []
    for i, (g, c) in enumerate(zip(gb, cb)):
        diffs += [f"bundle {i} {key}" for key in sorted(set(g) | set(c))
                  if key not in g or key not in c
                  or np.asarray(g[key]).dtype != np.asarray(c[key]).dtype
                  or not np.array_equal(g[key], c[key])]
    for i, (g, c) in enumerate(zip(gr, cr)):
        diffs += [f"result {i} {f}" for f in c._fields
                  if not (np.array_equal(getattr(g, f), getattr(c, f))
                          if isinstance(getattr(c, f), np.ndarray)
                          else getattr(g, f) == getattr(c, f))]
    return {"graph": "community_graph(600, 8, 6, seed=3)", "same": not diffs,
            "differing": diffs[:20], "rolled_back": gr[1].rolled_back,
            "refined": [gr[2].refined, gr[3].refined],
            "window_steps": [r.step for r in gr[4:]],
            "cuda_cpu_s": [t1 - t0, time.perf_counter() - t1]}


def _elastic_sequence(dev) -> dict:
    """On ``community_graph(2000, 32, 8, seed=5)``, k = 8, chunks of 1,024:
    the migration-cost game at three scales (k′ = 10, homes from the cold
    bundle's seats, -1 where they die), ``reshard_bundle`` grow (12) and
    shrink (5), ``reshard_scan_carry`` for Greedy and HDRF (12 and 5),
    ``run_parallel`` of HDRF at S = 4 in each shard mode (chunks of 512)
    with a forced straggler handoff (:func:`_fixed_monitor`) and a
    ``LaneFaultInjector`` killing lane 1's second chunk (replayed); and a
    ``ServingController`` over an ``S5PWindowChain`` on
    ``community_graph(600, 8, 6, seed=3)`` (window 512, step 256) with one
    resize to k = 10.  Returns every result as host values, keyed by
    step."""
    import numpy as np
    import torch

    from repro_torch.core import game as G
    from repro_torch.core.s5p import S5PConfig
    from repro_torch.elastic import reshard_bundle, reshard_scan_carry
    from repro_torch.graphs import community_graph
    from repro_torch.incremental import S5PWindowChain, s5p_cold_bundle
    from repro_torch.kernels.stream_scan import GreedyCarry, HdrfCarry
    from repro_torch.runtime import LaneFaultInjector
    from repro_torch.serving import BundleRegistry, ServingController
    from repro_torch.streaming import EdgeStream, ParallelEdgeStream, run_carry, run_parallel

    src, dst, n = community_graph(2000, n_communities=32, avg_degree=8, seed=5)
    cfg = S5PConfig(k=8, chunk_size=1024)
    out = {}
    _, b0 = s5p_cold_bundle(src, dst, n, cfg, device=dev)
    sizes = np.asarray(b0["sizes"], np.float32)
    C, c2p = sizes.size, np.asarray(b0["c2p"], np.int32)
    inputs = G.GameInputs(*(torch.from_numpy(np.asarray(b0[key])).to(dev)
                            for key in ("sizes", "pair_a", "pair_b", "pair_w")), 0, 10)
    for scale in (0.0, 1.0, 4.0):
        res = G.run_game(inputs, C, batch_size=G.default_batch_size(256, C), assign0=c2p,
                         seed=2, leader_mask=np.asarray(b0["comb_is_head"], bool),
                         move_mask=sizes > 0, home=np.where(c2p < 10, c2p, -1),
                         move_cost=(np.float32(scale) * sizes / np.float32(10)))
        out[f"game scale={scale}"] = (res.assignment.cpu().numpy(), res.rounds)
    for k_new in (12, 5):
        b2, _, res = reshard_bundle(b0, cfg, k_new, src, dst, device=dev)
        out[f"reshard_bundle k'={k_new}"] = (b2, tuple(res))
    for name in ("greedy", "hdrf"):
        make = ((lambda k: GreedyCarry(n, k, device=dev)) if name == "greedy"
                else (lambda k: HdrfCarry(n, k, 1.1, device=dev)))
        parts, carry = run_carry(EdgeStream(src, dst, n, chunk_size=1024, device=dev), make(8))
        parts = parts.cpu().numpy()
        for k_new in (12, 5):
            work, p2, res = reshard_scan_carry(make(k_new), carry, k_new, src, dst, parts,
                                               chunk_size=1024)
            out[f"reshard_scan_carry {name} k'={k_new}"] = (
                [x.cpu().numpy() for x in work], p2, tuple(res))
    for shard in ("range", "rr", "hub"):  # 16 chunks of 512: every lane holds 2 or more
        st = EdgeStream(src, dst, n, chunk_size=512, device=dev)
        cid = ParallelEdgeStream(st, 4, shard=shard).lanes[1][1]
        inj, mon = LaneFaultInjector([(1, cid)]), _fixed_monitor()
        parts, carry = run_parallel(st, HdrfCarry(n, 8, 1.1, device=dev), num_streams=4,
                                    super_chunk=2, shard=shard, straggler=mon,
                                    on_lane_failure="replay", lane_injector=inj)
        out[f"handoff {shard}"] = (parts.cpu().numpy(), [x.cpu().numpy() for x in carry],
                                   inj.fired, [h[:2] for h in mon.history])
    s2, d2, n2 = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    chain = S5PWindowChain(s2, d2, n2, S5PConfig(k=8, chunk_size=256), 512, step_edges=256,
                           device=dev)
    reg = BundleRegistry()
    ctl = ServingController(reg, chain)
    published = []
    while reg.current is None:
        ctl.step()
    published.append(reg.current)
    res = ctl.resize(10)
    published.append(reg.current)
    while ctl.step() is not None:
        published.append(reg.current)
    out["controller"] = ([(b.version, b.origin, b.k, b.rf, b.parts) for b in published],
                         tuple(res))
    return out


def _same_value(a, b) -> bool:
    """Equal values, bit for bit: dicts by key, sequences by position,
    arrays by dtype and value."""
    import numpy as np

    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same_value(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        return np.asarray(a).dtype == np.asarray(b).dtype and bool(np.array_equal(a, b))
    return a == b


def _elastic_parity() -> dict:
    """``_elastic_sequence`` on cuda and on cpu: every result equal."""
    t0 = time.perf_counter()
    gpu = _elastic_sequence("cuda")
    t1 = time.perf_counter()
    cpu = _elastic_sequence("cpu")
    differing = [key for key in cpu if not _same_value(gpu[key], cpu[key])]
    origins = [x[1] for x in cpu["controller"][0]]
    return {"graph": "community_graph(2000, 32, 8, seed=5)", "same": not differing,
            "differing": differing, "steps": list(cpu),
            "game_rounds": [cpu[f"game scale={s}"][1] for s in (0.0, 1.0, 4.0)],
            "controller_origins": origins, "cuda_cpu_s": [t1 - t0, time.perf_counter() - t1]}


def _retreat_graph():
    """131,072 edges whose stride sample (every other edge) hides the hubs:
    the even positions hold 2,048 edges among 8 super vertices, 8,192
    among 1,024 mid vertices and a ring of low vertices, the odd ones
    edges among 512 hubs of a degree between theirs.  The plan misses the
    hubs' edges below the super vertices' threshold, so the spill
    retreats (the input of ``tests/test_torch_hybrid.py``'s retreat)."""
    import numpy as np

    rng = np.random.default_rng(26)
    half = 1 << 16
    sup = rng.integers(0, 8, (2048, 2))
    mid = 8 + rng.integers(0, 1024, (8192, 2))
    low_ids = 8 + 1024 + 512 + np.arange(half - 2048 - 8192)
    low = np.stack([low_ids, np.roll(low_ids, 1)], 1)
    even = np.concatenate([sup, mid, low])[rng.permutation(half)]
    odd = 8 + 1024 + rng.integers(0, 512, (half, 2))
    e = np.empty((2 * half, 2), np.int64)
    e[0::2], e[1::2] = even, odd
    return e[:, 0].astype(np.int32), e[:, 1].astype(np.int32), int(e.max()) + 1


def _hybrid_fields(res) -> dict:
    """A ``HybridResult`` as values to compare: every field but the
    seconds, the plan as a tuple, the bundle leaf by leaf."""
    out = {f: getattr(res, f) for f in res._fields if f not in ("timings", "bundle", "plan")}
    return {**out, "plan": tuple(res.plan), "bundle": dict(res.bundle)}


def _hybrid_sequence(dev) -> dict:
    """On ``community_graph(2000, 32, 8, seed=5)``, k = 8: ``run_hybrid`` at
    0, 0.3 and 1.0 of E·CORE_EDGE_BYTES·2 and at 0.3 with S = 4 hub lanes
    (chunks of 1,024, super-chunk auto); on ``_retreat_graph`` (k = 8,
    chunks of 2^14) a budget of 800,000 bytes, whose spill retreats; a
    ``HybridServingChain`` of the full budget's result with one delta of
    48 edges (``default_rng(11)``) through a ``ServingController``."""
    import numpy as np

    from repro_torch.core.s5p import S5PConfig
    from repro_torch.graphs import community_graph
    from repro_torch.hybrid import CORE_EDGE_BYTES, HybridServingChain, run_hybrid
    from repro_torch.serving import BundleRegistry, ServingController

    src, dst, n = community_graph(2000, n_communities=32, avg_degree=8, seed=5)
    full = src.size * CORE_EDGE_BYTES * 2
    cfg = S5PConfig(k=8)
    out, runs = {}, {}
    for frac in (0.0, 0.3, 1.0):
        runs[frac] = run_hybrid((src, dst, n), cfg, host_budget=int(frac * full), device=dev)
        out[f"budget {frac}"] = _hybrid_fields(runs[frac])
    hub = S5PConfig(k=8, chunk_size=1024, num_streams=4, shard="hub", super_chunk="auto")
    out["S=4 hub"] = _hybrid_fields(run_hybrid((src, dst, n), hub, host_budget=int(0.3 * full),
                                               device=dev))
    rs, rd, rn = _retreat_graph()
    r = run_hybrid((rs, rd, rn), S5PConfig(k=8, chunk_size=1 << 14), host_budget=800_000,
                   device=dev)
    out["retreat"] = _hybrid_fields(r)
    out["retreated"] = r.mode == "hybrid" and r.xi_star > r.plan.xi_star
    rng = np.random.default_rng(11)
    delta = (rng.integers(0, n, 48).astype(np.int32), rng.integers(0, n, 48).astype(np.int32))
    chain = HybridServingChain(runs[1.0], cfg, src, dst, n, deltas=[delta], device=dev)
    reg = BundleRegistry()
    ctl = ServingController(reg, chain)
    published = []
    while ctl.step() is not None:
        b = reg.current
        published.append((b.version, b.origin, b.k, b.n_edges, b.rf, b.balance,
                          np.asarray(b.parts)))
    out["serving"] = published
    out["serving bundle"] = dict(chain.bundle)
    return out


def _hybrid_parity() -> dict:
    """``_hybrid_sequence`` on cuda and on cpu: every result equal."""
    t0 = time.perf_counter()
    gpu = _hybrid_sequence("cuda")
    t1 = time.perf_counter()
    cpu = _hybrid_sequence("cpu")
    differing = [key for key in cpu if not _same_value(gpu[key], cpu[key])]
    return {"graph": "community_graph(2000, 32, 8, seed=5); the retreat graph",
            "same": not differing, "differing": differing, "steps": list(cpu),
            "retreated": bool(cpu["retreated"]),
            "modes": {key: v["mode"] for key, v in cpu.items()
                      if isinstance(v, dict) and "mode" in v},
            "accepted_levels": {key: list(v["accepted_levels"]) for key, v in cpu.items()
                                if isinstance(v, dict) and "mode" in v},
            "cuda_cpu_s": [t1 - t0, time.perf_counter() - t1]}


def _merged_ids_past_v() -> dict:
    """ROADMAP Queue 3 j's input: clustering lanes merged every chunk sum
    their id counters past V + 1, where K1 reads slot V and drops the adds
    as the plain fold does; every leaf of the state, cuda against cpu."""
    from repro_torch.core.clustering import ClusterState, cluster_stream
    from repro_torch.graphs import rmat_graph

    src, dst, n = rmat_graph(10, edge_factor=8, seed=4)
    kw = dict(xi=1 << 20, kappa=1 << 20, chunk_size=256, num_streams=8, super_chunk=1)
    t0 = time.perf_counter()
    gpu = cluster_stream(src, dst, n, device="cuda", **kw)
    t1 = time.perf_counter()
    cpu = cluster_stream(src, dst, n, device="cpu", **kw)
    diff = first_diff(gpu, cpu, ClusterState._fields)
    return {"graph": "rmat_graph(10, edge_factor=8, seed=4)", "V": n,
            "next_h": int(cpu.next_h), "next_t": int(cpu.next_t), "same": diff is None,
            "first_diff": diff, "cuda_cpu_s": [t1 - t0, time.perf_counter() - t1], **{
                key: v for key, v in kw.items() if key != "xi"}, "xi": kw["xi"]}


def _delta_above_2_24() -> dict:
    """The game's δ where Σ(degs + sizes) passes 2**24: the Θ inputs of
    ``community_graph(600, 8, 6, seed=3)`` at k = 8 (CMS Θ, two-stage),
    sizes and Θ scaled by 3001, on the card and on the CPU; δ's bits and
    the game's assignment must agree (the reference gives 0x371b42d7)."""
    import numpy as np
    import torch

    from repro_torch.core import clustering as cl
    from repro_torch.core import game as G
    from repro_torch.core.s5p import cluster_statistics
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    s, d = torch.from_numpy(src).int(), torch.from_numpy(dst).int()
    deg = cl.compute_degrees(s, d, n)
    xi, kappa = int(2.0 * src.size / n), max(int(np.ceil(2.0 * src.size / 8)), 2)
    res = cl.compact_clusters(cl.cluster_stream(s, d, n, xi=xi, kappa=kappa, device="cpu"),
                              deg, xi)
    sizes, pa, pb, pw, _ = cluster_statistics(s, d, res, deg, xi, use_cms=True,
                                              cms_epsilon=0.1, cms_nu=0.01, seed=0)
    C = res.n_clusters
    cpu = G.GameInputs(sizes * 3001, pa, pb, pw * 3001, res.n_head, 8)
    dev = G.GameInputs(*(t.cuda() for t in cpu[:4]), res.n_head, 8)
    bits = [int(G.compute_delta(g.sizes, G._cluster_degrees(g, C), 8).cpu().view(torch.int32))
            for g in (dev, cpu)]
    kw = dict(batch_size=G.default_batch_size(256, C), accept_prob=0.9, seed=3)
    g_dev, g_cpu = G.run_game(dev, C, **kw), G.run_game(cpu, C, **kw)
    total = float((G._cluster_degrees(cpu, C) + cpu.sizes).double().sum())
    same = (bits[0] == bits[1] and g_dev.rounds == g_cpu.rounds
            and torch.equal(g_dev.assignment.cpu(), g_cpu.assignment))
    return {"sum_degs_sizes": total, "delta_bits_cuda": hex(bits[0]),
            "delta_bits_cpu": hex(bits[1]), "game_rounds": g_cpu.rounds, "same": same}


def _highest_f32() -> None:
    """Float32 matmuls in full float32 on the card (no TF32), stated."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ------------------------------------------------------- phase distributed

DIST_WORLD = 4  # ranks sharing the card under gloo
# phase compare's CLUGP row runs on the R-MAT cut from 20 to this scale: at
# 20 its game (96 ordered rounds) took 185.7-325.6 s by host, and the script
# 1,072.0-1,338.2 s (NVIDIA H100 80GB HBM3, 700 W)
CLUGP_SCALE = 17
# the worlds' R-MAT scale, cut from phase main's 20: there the world of 4
# took 290.8 s, its replicated game 252.6 s over 2,192,371 raw cluster
# ids; at 17 the phase took 101.6 s and the script 1,185.9 s, too near its
# limit (NVIDIA H100 80GB HBM3, 700 W)
DIST_SCALE = 16
DIST_DIR = os.path.join(ROOT, "build", "chip_smoke_distributed")  # gitignored
DIST_PARITY = "community_graph(600, 8, 6, seed=3)"


def _np_hash(a) -> str:
    import hashlib

    import numpy as np

    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _drive_rank(fn):
    """Run ``fn`` in a rank with its launch counters and collective bytes
    set to 0 just before and read just after: ``(result, seconds,
    launches, bytes, peak device bytes beyond what was allocated before)``."""
    import torch

    from repro_torch import _dist

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launch_counts()
    _dist.reset_collective_bytes()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    return (got, time.perf_counter() - t0, launch_counts(), _dist.collective_bytes(),
            torch.cuda.max_memory_allocated() - before)


def _rank_full_width(rank, world, dev, edges_dir, n, k, with_hdrf):
    """A rank of phase distributed's full-width worlds: ``distributed_partition``
    over the world under ``S5PConfig(k)``, then (``with_hdrf``) HDRF at one
    range lane a rank, super-chunk 8 (``run_parallel`` resolves to
    ``shard_map``).  The edges are phase main's, memory-mapped."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import distributed_partition, last_partition_stats
    from repro_torch.core.metrics import load_balance, replication_factor
    from repro_torch.core.s5p import S5PConfig
    from repro_torch.kernels.stream_scan import HdrfCarry
    from repro_torch.streaming import EdgeStream, last_ingest_stats, run_parallel

    src = np.load(os.path.join(edges_dir, "src.npy"), mmap_mode="r")
    dst = np.load(os.path.join(edges_dir, "dst.npy"), mmap_mode="r")
    (parts, info), wall, launches, moved, peak = _drive_rank(
        lambda: distributed_partition(src, dst, n, S5PConfig(k=k), None))
    st = last_partition_stats()
    p = parts.cpu().numpy()
    valid = src != dst
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(dev), "info": info,
           "wall_s": wall, "seconds": st["seconds"], "collective_bytes": st["collective_bytes"],
           "bytes_by_kind": moved, "launches": launches, "peak_bytes": peak,
           "shard_edges": st["shard_edges"], "place_chunk": st["place_chunk"],
           "pairs": st["pairs"], "game": {key: st["game"][key] for key in
                                          ("ordered_sums", "hub_batches", "batch_size")},
           "parts_hash": _np_hash(p), "max_load": int(np.bincount(p[valid], minlength=k).max()),
           "max_load_cap": st["max_load"], "unplaced_valid_edges": int((p[valid] < 0).sum())}
    if rank == 0:
        s_t, d_t = torch.from_numpy(np.array(src)).to(dev), torch.from_numpy(np.array(dst)).to(dev)
        out["rf"] = replication_factor(s_t, d_t, parts, n_vertices=n, k=k)
        out["balance"] = load_balance(parts, k=k)
        del s_t, d_t
    del parts
    if with_hdrf:
        stream = EdgeStream(np.array(src), np.array(dst), n, chunk_size=1 << 16, device=dev)
        (hp, carry), wall, launches, moved, peak = _drive_rank(lambda: run_parallel(
            stream, HdrfCarry(n, k, device=dev), num_streams=world, super_chunk=8,
            shard="range"))
        ing = last_ingest_stats()
        out["hdrf"] = {"backend": ing.backend, "wall_s": wall, "launches": launches,
                       "bytes_by_kind": moved, "peak_bytes": peak,
                       "lane_chunks": ing.lanes[rank].chunks, "merges": len(ing.schedule),
                       "parts_hash": _np_hash(hp), "carry_hash": [_np_hash(x) for x in carry[:3]]}
    return out


def _parity_sequence(rank, world, dev):
    """The parity sequence of phase distributed in one rank, on ``dev`` (the
    card or the CPU): ``distributed_partition`` at S = 2, S5P at 2 hub lanes
    (auto cadence), Greedy and grid at 2 range lanes, and
    ``ElasticController`` resizing a state placed on both ranks onto the
    first alone."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.reshard import reshard_state
    from repro_torch.core.baselines import greedy_partition, grid_partition
    from repro_torch.core.distributed import distributed_partition
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.graphs import community_graph
    from repro_torch.runtime import ElasticController

    src, dst, n = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    reset_launch_counts()
    out = {}
    parts, info = distributed_partition(src, dst, n, S5PConfig(k=8), None, device=dev)
    out["distributed_partition"] = (parts.cpu().numpy(), info)
    cfg = S5PConfig(k=8, num_streams=world, shard="hub", super_chunk="auto", chunk_size=256)
    res = s5p_partition(src, dst, n, cfg, device=dev)
    out["s5p S=2 hub auto"] = (res.parts.cpu().numpy(), res.n_clusters, res.game_rounds,
                               res.aux["parallel_ingest"]["backend"],
                               {key: v for key, v in res.aux.get("touch_up", {}).items()
                                if key != "game"})
    for name, fn in (("greedy", greedy_partition), ("grid", grid_partition)):
        out[f"{name} S=2"] = fn(src, dst, n, 8, 0, chunk_size=256, num_streams=world,
                                super_chunk=2, shard="range", device=dev).cpu().numpy()
    state = {"w": torch.arange(24, dtype=torch.float32, device=dev).reshape(6, 4) - 7.5,
             "table": torch.tensor([-5, 2**31 - 1, -2**31], dtype=torch.int32, device=dev),
             "step": torch.tensor([7], dtype=torch.int64, device=dev)}
    mesh = DeviceMesh(dev.type, list(range(world)), mesh_dim_names=("data",))
    placed = reshard_state(state, (mesh, [Replicate()]))
    ctl = ElasticController(
        CheckpointManager(os.path.join(DIST_DIR, f"ckpt-{dev.type}-{rank}"), async_write=False),
        make_mesh=lambda size: DeviceMesh(dev.type, list(range(size)), mesh_dim_names=("data",)),
        make_shardings=lambda m: (m, [Replicate()]))
    new_state, new_mesh, _, step = ctl.resize(placed, 3, 1)
    inside = new_mesh.get_coordinate() is not None
    out["elastic 2 -> 1"] = (step, inside, {
        key: (v.full_tensor() if inside else v.to_local()).cpu().numpy()
        for key, v in new_state.items()})
    out["elastic_equals_state"] = (not inside) or all(
        np.array_equal(out["elastic 2 -> 1"][2][key], v.cpu().numpy()) for key, v in state.items())
    return {"results": out, "launches": launch_counts()}


def _rank_parity(rank, world, dev):
    """A rank of the parity world (ranks sharing the card under gloo): the
    sequence on the card, then on the CPU."""
    import torch

    t0 = time.perf_counter()
    card = _parity_sequence(rank, world, dev)
    t1 = time.perf_counter()
    host = _parity_sequence(rank, world, torch.device("cpu"))
    return {"cuda": card, "cpu": host, "cuda_cpu_s": [t1 - t0, time.perf_counter() - t1]}


def _world_summary(ranks, n_chunk: int = 1 << 16) -> tuple[dict, list]:
    """Phase distributed's report of one full-width world, and its problems."""
    import math as m

    problems = []
    r0 = ranks[0]
    S = len(ranks)
    phases = list(r0["seconds"])
    row = {"world": S, "backend": r0["backend"], "info": r0["info"],
           "seconds_max_over_ranks": {p: max(r["seconds"][p] for r in ranks) for p in phases},
           "wall_s_max": max(r["wall_s"] for r in ranks),
           "collective_bytes_by_phase": [r["collective_bytes"] for r in ranks],
           "bytes_by_kind": [r["bytes_by_kind"] for r in ranks],
           "peak_bytes": [r["peak_bytes"] for r in ranks],
           "rf": r0["rf"], "balance": r0["balance"],
           "max_load": r0["max_load"], "max_load_cap": r0["max_load_cap"],
           "unplaced_valid_edges": r0["unplaced_valid_edges"],
           "parts_hashes": [r["parts_hash"] for r in ranks],
           "launches": [r["launches"] for r in ranks], "pairs": [r["pairs"] for r in ranks],
           "game": r0["game"]}
    if len(set(row["parts_hashes"])) != 1:
        problems.append(f"S={S}: the ranks' parts differ: {row['parts_hashes']}")
    if row["max_load"] > row["max_load_cap"] or row["unplaced_valid_edges"]:
        problems.append(f"S={S}: max load {row['max_load']} (cap {row['max_load_cap']}), "
                        f"{row['unplaced_valid_edges']} valid edges unplaced")
    for r in ranks:
        want = {"cluster_scan": m.ceil(r["shard_edges"] / n_chunk),
                "assign_scan": m.ceil(r["shard_edges"] / r["place_chunk"]),
                "cms_update": max(1, m.ceil(r["pairs"] / (1 << 18))), "cms_query": 1,
                "segment_agg": 2 + r["game"]["ordered_sums"]}
        got = {key: r["launches"][key] for key in want}
        if got != want:
            problems.append(f"S={S} rank {r['rank']}: launches {got}, not {want}")
    return row, problems


def phase_distributed(main, graph, main_scale: int) -> dict:
    """Multi-device S5P over ``torch.distributed`` (``core/distributed.py``,
    ``run_parallel``'s ``shard_map``): a world of 4 ranks sharing the card
    under gloo, then a world of 1 under NCCL, at k = 32 under the default
    ``S5PConfig`` on phase main's R-MAT cut to :data:`DIST_SCALE` (the
    sequential S5P of that graph beside it); HDRF at 4 ranks against the
    threads backend; the parity sequence as a world of 2 on the card and
    on the CPU.  Nothing else runs beside it."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import _dist
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.core.metrics import load_balance, replication_factor
    from repro_torch.kernels.stream_scan import HdrfCarry
    from repro_torch.streaming import EdgeStream, last_ingest_stats, run_parallel

    t_phase = time.perf_counter()
    scale = min(main_scale, DIST_SCALE)
    k = main["cfg"].k
    (src, dst, n), _ = graph  # made beside phase main's (make_graphs)
    E = int(src.shape[0])
    os.makedirs(DIST_DIR, exist_ok=True)
    edges = os.path.join(DIST_DIR, "edges")
    os.makedirs(edges, exist_ok=True)
    np.save(os.path.join(edges, "src.npy"), np.asarray(src, np.int32))
    np.save(os.path.join(edges, "dst.npy"), np.asarray(dst, np.int32))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    seq = s5p_partition(src, dst, n, S5PConfig(k=k), device=dev)
    s_t, d_t = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    info = {"phase": "distributed", "graph": f"rmat:{scale} edge_factor=16 seed=0",
            "cut_from": f"rmat:{main_scale}", "V": n, "E": E, "k": k,
            "sequential": {"rf": replication_factor(s_t, d_t, seq.parts, n_vertices=n, k=k),
                           "balance": load_balance(seq.parts, k=k),
                           "clusters": seq.n_clusters, "game_rounds": seq.game_rounds,
                           "seconds": seq.timings, "wall_s": time.perf_counter() - t0},
            "rf_main": main["info"]["rf"], "balance_main": main["info"]["balance"]}
    del seq, s_t, d_t
    emit({**info, "step": "sequential"})
    problems = []

    # ---- HDRF at S = 4 on the threads backend, in the parent, first ----
    stream = EdgeStream(src, dst, n, chunk_size=1 << 16, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    hp, carry = run_parallel(stream, HdrfCarry(n, k, device=dev), num_streams=DIST_WORLD,
                             super_chunk=8, shard="range", backend="threads")
    torch.cuda.synchronize()
    threads = {"wall_s": time.perf_counter() - t0, "launches": launch_counts(),
               "plan_chunks": sum(lane.chunks for lane in last_ingest_stats().lanes),
               "parts_hash": _np_hash(hp), "carry_hash": [_np_hash(x) for x in carry[:3]]}
    del hp, carry, stream
    torch.cuda.empty_cache()

    # ---- 4 ranks under gloo on the card, then this process alone as a
    # world of 1 under NCCL ----
    worlds = {}
    for world, with_hdrf in ((DIST_WORLD, True), (1, False)):
        t0 = time.perf_counter()
        if world > 1:
            ranks = _dist.spawn_world(_rank_full_width, world, (edges, n, k, with_hdrf),
                                      work_dir=os.path.join(DIST_DIR, f"world{world}"))
        else:
            store = os.path.join(DIST_DIR, "store-nccl")
            rank_dev = _dist.init_world(0, 1, f"file://{store}")
            try:
                ranks = [_rank_full_width(0, 1, rank_dev, edges, n, k, with_hdrf)]
            finally:
                _dist.shutdown()
        row, bad = _world_summary(ranks)
        row["world_s"] = time.perf_counter() - t0
        problems += bad
        if with_hdrf:
            hd = [r["hdrf"] for r in ranks]
            row["hdrf"] = {"threads": threads, "shard_map": hd,
                           "equal_threads": all(h["parts_hash"] == threads["parts_hash"]
                                                and h["carry_hash"] == threads["carry_hash"]
                                                for h in hd)}
            if not row["hdrf"]["equal_threads"] or any(h["backend"] != "shard_map" for h in hd):
                problems.append("hdrf at 4 ranks differs from the threads backend at S = 4")
            for h in hd:
                if h["launches"]["scoring_scan"] != h["lane_chunks"]:
                    problems.append(f"hdrf: a rank launched K3 {h['launches']['scoring_scan']} "
                                    f"times for its {h['lane_chunks']} chunks")
            if sum(h["lane_chunks"] for h in hd) != threads["plan_chunks"]:
                problems.append("hdrf: the ranks' chunks are not the plan's")
        emit({"phase": "distributed", "step": f"S={world}", **row})
        worlds[world] = row
    info["worlds"] = worlds

    # ---- the parity sequence: a world of 2 ranks sharing the card under
    # gloo, each running it on the card, then on the CPU ----
    t0 = time.perf_counter()
    ranks = _dist.spawn_world(_rank_parity, 2, work_dir=os.path.join(DIST_DIR, "parity"))
    # every rank returns the same results but for the resize, which
    # differs by rank (inside or outside the new mesh): cuda against cpu
    # rank by rank, and the ranks against rank 0
    res = [r[side]["results"] for r in ranks for side in ("cuda", "cpu")]
    differing = [key for key in res[0] if any(
        not _same_value(res[i][key], res[j][key])
        for i, j in ([(0, 1), (2, 3)] if key == "elastic 2 -> 1" else [(0, 1), (0, 2), (0, 3)]))]
    parity = {"graph": DIST_PARITY, "k": 8, "world_s": time.perf_counter() - t0,
              "cuda_cpu_s": [r["cuda_cpu_s"] for r in ranks],
              "steps": list(res[0]), "differing": differing,
              "elastic_equals_state": [r["elastic_equals_state"] for r in res],
              "launches_cuda": [r["cuda"]["launches"] for r in ranks]}
    parity["same"] = not parity["differing"] and all(parity["elastic_equals_state"])
    emit({"phase": "distributed", "step": "parity", **parity})
    info["parity"] = parity
    if not parity["same"]:
        problems.append(f"the parity sequence differs, cuda vs cpu: {parity['differing']}")
    totals: dict = {}
    for counts in ([c for w in worlds.values() for c in w["launches"]] +
                   [h["launches"] for h in worlds[DIST_WORLD]["hdrf"]["shard_map"]] +
                   parity["launches_cuda"]):
        for key, v in counts.items():
            totals[key] = totals.get(key, 0) + v
    info["launches"] = totals
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    info["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "distributed", "step": "done", "phase_s": info["phase_s"], "launches": totals})
    if problems:
        raise SystemExit("chip_smoke distributed phase failed: " + "; ".join(problems))
    return info


def phase_lm(prompt_len: int = 4096, batch: int = 4, gen_tokens: int = 32,
             f32_layers: int = 2) -> dict:
    """The LM serving path at full width (llama3-8b), then the float32
    prefill-against-decode check at full width and ``f32_layers`` layers."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import lm as LM

    _highest_f32()
    arch = "llama3-8b"
    cfg = get_arch(arch).config
    dev = torch.device("cuda")
    problems = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = {}
    t0 = time.perf_counter()
    seqs = serve_lm(arch, prompt_len=prompt_len, gen_tokens=gen_tokens, batch=batch,
                    smoke=False, seed=0, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_ms = np.asarray(stats["decode_s"]) * 1e3
    first, last = stats.pop("prefill_logits"), stats.pop("last_logits")
    finite = bool(torch.isfinite(first).all()) and bool(torch.isfinite(last).all())
    toks = seqs.cpu().numpy()
    info = {
        "phase": "lm", "arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": LM.count_params(cfg), "dtype": str(cfg.dtype), "seed": 0,
        "batch": batch, "prompt_len": prompt_len, "gen_tokens": gen_tokens,
        "init_s": stats["init_s"], "init_peak_bytes": stats["init_peak_bytes"],
        "prefill_s": stats["prefill_s"],
        "prefill_tokens_per_s": batch * prompt_len / stats["prefill_s"],
        "decode_ms_per_token": {"n": int(decode_ms.size), "mean": float(decode_ms.mean()),
                                "p99": float(np.percentile(decode_ms, 99))},
        "decode_tokens_per_s": batch / float(decode_ms.mean()) * 1e3,
        "wall_s": wall, "max_memory_allocated": peak, "launches": launches,
        "logits_finite": finite, "logits_abs_max": float(first.float().abs().max()),
        "tokens_head": toks[:, :8].tolist(),
    }
    emit(info)
    if launches["flash_attention"] != cfg.n_layers:
        problems.append(f"K6 launched {launches['flash_attention']} times in the prefill, "
                        f"not once per layer ({cfg.n_layers})")
    if toks.shape != (batch, gen_tokens) or toks.min() < 0 or toks.max() >= cfg.vocab:
        problems.append(f"tokens of shape {toks.shape} or outside the vocabulary")
    if not finite:
        problems.append("logits not finite")

    # float32 at full width, f32_layers layers: K6 (prefill) against the plain
    # decode path on the same card
    cfg32 = dataclasses.replace(cfg, n_layers=f32_layers, dtype=torch.float32)
    key = trandom.PRNGKey(0)
    torch.cuda.reset_peak_memory_stats()
    params = LM.init_params(cfg32, key, device=dev)
    prompts = trandom.randint(key, (batch, prompt_len), 0, cfg.vocab, device=dev)
    reset_launch_counts()
    with torch.inference_mode():
        want, _ = LM.prefill(params, prompts, cfg32, max_seq=prompt_len, device=dev)
        _, cache = LM.prefill(params, prompts[:, :-1], cfg32, max_seq=prompt_len, device=dev)
        pos = torch.full((batch,), prompt_len - 1, dtype=torch.int32, device=dev)
        got, _ = LM.decode_step(params, cache, prompts[:, -1], pos, cfg32, device=dev)
    torch.cuda.synchronize()
    k6_f32 = launch_counts()["flash_attention"]
    err = float((got - want).abs().max())
    close = bool(torch.allclose(got, want, atol=2e-3, rtol=1e-3))
    check = {"phase": "lm", "step": "float32 prefill against decode",
             "layers": f32_layers, "d_model": cfg.d_model, "batch": batch,
             "prompt_len": prompt_len, "max_abs_err": err,
             "logits_abs_max": float(want.abs().max()), "within_atol_2e-3_rtol_1e-3": close,
             "k6_launches": k6_f32, "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(check)
    del params, cache, prompts
    if not close or not math.isfinite(err):
        problems.append(f"float32 prefill and decode logits differ by {err}")
    if k6_f32 != 2 * f32_layers:
        problems.append(f"K6 launched {k6_f32} times in two float32 prefills of "
                        f"{f32_layers} layers")
    if problems:
        raise SystemExit("chip_smoke lm phase failed: " + "; ".join(problems))
    return {"info": info, "f32_check": check, "launches": launches}


# phase moe serves mixtral-8x7b cut from 32 layers to this depth: the 32
# layers are 46.70 G parameters (93.4 GB in bf16, past the card's 80 GB),
# 16 are 23.48 G (47.0 GB)
MOE_LAYERS = 16


def phase_moe(prompt_len: int = 8192, batch: int = 2, gen_tokens: int = 32,
              f32_layers: int = 2, f32_prompt_len: int = 4608) -> dict:
    """Mixtral's MoE serving path at published width (``mixtral-8x7b`` cut
    to ``MOE_LAYERS`` layers), then the float32 prefill-against-decode check
    at full width, ``f32_layers`` layers and capacity factor 4 (cap = T:
    nothing dropped, so a token's route does not depend on the others')."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import lm as LM

    _highest_f32()
    torch.cuda.empty_cache()  # phase lm's weights are freed
    t_phase = time.perf_counter()
    arch = "mixtral-8x7b"
    published = get_arch(arch).config
    cfg = dataclasses.replace(published, n_layers=MOE_LAYERS)
    dev = torch.device("cuda")
    problems = []
    torch.cuda.synchronize()
    allocated_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = {}
    t0 = time.perf_counter()
    seqs = serve_lm(arch, prompt_len=prompt_len, gen_tokens=gen_tokens, batch=batch,
                    smoke=False, seed=0, device=dev, stats=stats, n_layers=MOE_LAYERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_ms = np.asarray(stats["decode_s"]) * 1e3
    first, last = stats.pop("prefill_logits"), stats.pop("last_logits")
    finite = bool(torch.isfinite(first).all()) and bool(torch.isfinite(last).all())
    toks = seqs.cpu().numpy()
    E, K = cfg.n_experts, cfg.top_k
    cap = max(8, min(int(cfg.capacity_factor * K * prompt_len / E), prompt_len))
    layers = stats["moe"]
    load = np.asarray([layer["load"] for layer in layers])  # (L, B, E)
    dropped = np.asarray([layer["dropped"] for layer in layers])  # (L, B)
    info = {
        "phase": "moe", "arch": arch, "layers": cfg.n_layers,
        "published_layers": published.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
        "n_experts": E, "top_k": K, "window": cfg.sliding_window,
        "params": LM.count_params(cfg), "published_params": LM.count_params(published),
        "dtype": str(cfg.dtype), "seed": 0, "batch": batch, "prompt_len": prompt_len,
        "gen_tokens": gen_tokens, "capacity_factor": cfg.capacity_factor,
        "cap_per_row": cap, "assignments_per_row": prompt_len * K,
        "allocated_at_start_bytes": allocated_at_start,
        "init_s": stats["init_s"], "init_peak_bytes": stats["init_peak_bytes"],
        "prefill_s": stats["prefill_s"],
        "prefill_tokens_per_s": batch * prompt_len / stats["prefill_s"],
        "decode_ms_per_token": {"n": int(decode_ms.size), "mean": float(decode_ms.mean()),
                                "p99": float(np.percentile(decode_ms, 99))},
        "decode_tokens_per_s": batch / float(decode_ms.mean()) * 1e3,
        "dropped_per_layer": dropped.sum(axis=1).tolist(),
        "dropped_per_layer_row": dropped.tolist(),
        "expert_load_per_layer": load.sum(axis=1).tolist(),
        "expert_load_per_layer_row": load.tolist(),
        "dropped_share": float(dropped.sum() / (cfg.n_layers * batch * prompt_len * K)),
        "wall_s": wall, "max_memory_allocated": peak, "launches": launches,
        "logits_finite": finite, "logits_abs_max": float(first.float().abs().max()),
        "tokens_head": toks[:, :8].tolist(),
    }
    emit(info)
    if launches["flash_attention"] != cfg.n_layers:
        problems.append(f"K6 launched {launches['flash_attention']} times in the prefill, "
                        f"not once per layer ({cfg.n_layers})")
    if toks.shape != (batch, gen_tokens) or toks.min() < 0 or toks.max() >= cfg.vocab:
        problems.append(f"tokens of shape {toks.shape} or outside the vocabulary")
    if not finite:
        problems.append("logits not finite")
    if load.shape != (cfg.n_layers, batch, E) or (load.sum(axis=2) != prompt_len * K).any():
        problems.append(f"expert loads of shape {load.shape} do not sum to T·K a row")
    if not np.array_equal(dropped, np.maximum(load - cap, 0).sum(axis=2)):
        problems.append("dropped assignments are not the loads past capacity")

    # float32 at full width, f32_layers layers, drop-free: K6 (prefill) against
    # the plain decode path on the same card
    cfg32 = dataclasses.replace(published, n_layers=f32_layers, dtype=torch.float32,
                                capacity_factor=4.0)
    key = trandom.PRNGKey(0)
    torch.cuda.reset_peak_memory_stats()
    S = f32_prompt_len
    params = LM.init_params(cfg32, key, device=dev)
    prompts = trandom.randint(key, (batch, S), 0, cfg32.vocab, device=dev)
    reset_launch_counts()
    routes = []
    with torch.inference_mode():
        want, _ = LM.prefill(params, prompts, cfg32, max_seq=S, device=dev, routes=routes)
        _, cache = LM.prefill(params, prompts[:, :-1], cfg32, max_seq=S, device=dev,
                              routes=routes)
        pos = torch.full((batch,), S - 1, dtype=torch.int32, device=dev)
        got, _ = LM.decode_step(params, cache, prompts[:, -1], pos, cfg32, device=dev)
    torch.cuda.synchronize()
    k6_f32 = launch_counts()["flash_attention"]
    drops = sum(int((~r["keep"]).sum()) for r in routes)
    err = float((got - want).abs().max())
    close = bool(torch.allclose(got, want, atol=2e-3, rtol=1e-3))
    check = {"phase": "moe", "step": "float32 prefill against decode",
             "layers": f32_layers, "d_model": cfg32.d_model, "capacity_factor": 4.0,
             "batch": batch, "prompt_len": S, "window": cfg32.sliding_window,
             "prefill_dropped": drops, "max_abs_err": err,
             "logits_abs_max": float(want.abs().max()), "within_atol_2e-3_rtol_1e-3": close,
             "k6_launches": k6_f32, "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del params, cache, prompts, routes
    check["phase_s"] = time.perf_counter() - t_phase
    emit(check)
    if not close or not math.isfinite(err):
        problems.append(f"float32 prefill and decode logits differ by {err}")
    if drops:
        problems.append(f"{drops} assignments dropped at capacity factor 4")
    if k6_f32 != 2 * f32_layers:
        problems.append(f"K6 launched {k6_f32} times in two float32 prefills of "
                        f"{f32_layers} layers")
    if problems:
        raise SystemExit("chip_smoke moe phase failed: " + "; ".join(problems))
    return {"info": info, "f32_check": check, "launches": launches}


def _visible_pairs(q_pos, kv_pos, causal, window) -> int:
    """Visible (query, key) pairs per head, summed over the batch rows: for
    each query, the keys with ``kv_pos >= 0`` and ``q − window < kv_pos <= q``
    (as the masks say), counted on sorted key positions."""
    import torch

    total = 0
    for qp, kp in zip(q_pos.long(), kv_pos.long()):
        keys = torch.sort(kp[kp >= 0]).values
        hi = torch.searchsorted(keys, qp, right=True) if causal else \
            torch.full_like(qp, keys.numel())
        lo = torch.searchsorted(keys, qp - window, right=True) if window is not None else \
            torch.zeros_like(qp)
        total += int((hi - lo).clamp(min=0).sum())
    return total


# K6's limits against its plain version.  float32: atol 2e-5, as the flash
# sweep of tests/test_kernels.py.  bfloat16, where a flat atol would be as
# large as a typical output of a long row: per (query, head) row, the
# largest |got − want| over the row's largest |want| (two bf16 ulps of it;
# one output rounding flipped is at most one), and mean |got − want| over
# mean |want|.  The mean limit lies between what K6 reads on the H100
# (about 1e-5) and what q and p left unrounded read (about 2e-3; PERF.md
# §6).  Every check also shows that two planted faults fail the limits.
K6_LIMITS = {"bfloat16": {"row_rel_err": 2**-6, "mean_rel_err": 2**-13},
             "float32": {"max_abs_err": 2e-5}}


def _k6_errs(got, want, hd: int) -> dict:
    d = (got.float() - want.float()).abs().view(-1, hd)
    w = want.float().abs().view(-1, hd)
    return {"max_abs_err": float(d.max()),
            "row_rel_err": float((d.amax(1) / w.amax(1).clamp(min=1e-30)).max()),
            "mean_rel_err": float(d.mean() / w.mean())}


def _within(errs: dict, limits: dict) -> bool:
    return all(errs[k] <= v for k, v in limits.items())


K6_CASES = [  # name, B, S, T, H, KV, dtype, window, padded keys
    ("K6 flash_attention llama3-8b prefill (bf16, causal)", 4, 4096, 4096, 32, 8,
     "bfloat16", None, 0),
    ("K6 flash_attention qwen3-14b groups G=5 (bf16, causal)", 1, 4096, 4096, 40, 8,
     "bfloat16", None, 0),
    ("K6 flash_attention Mixtral window 4096 over 8192 (bf16)", 2, 8192, 8192, 32, 8,
     "bfloat16", 4096, 0),
    ("K6 flash_attention ragged, padded keys (f32, causal)", 2, 1000, 1100, 32, 8,
     "float32", None, 37),
]
K6_HD = 128


def k6_inputs(case, gen) -> tuple:
    """q (B·KV, S, G·hd), k, v (B·KV, T, hd) from ``gen`` on the card, and
    the positions: queries at the last S of T, the last keys padding."""
    import torch

    _, B, S, T, H, KV, dtn, _, pad = case
    dt, G, hd = getattr(torch, dtn), H // KV, K6_HD
    q = torch.randn(B * KV, S, G * hd, device="cuda", generator=gen).to(dt)
    k = torch.randn(B * KV, T, hd, device="cuda", generator=gen).to(dt)
    v = torch.randn(B * KV, T, hd, device="cuda", generator=gen).to(dt)
    qp = torch.arange(T - S, T, dtype=torch.int32, device="cuda").expand(B * KV, S).contiguous()
    kp = torch.arange(T, dtype=torch.int32, device="cuda").expand(B * KV, T).contiguous()
    if pad:  # the last keys are padding
        kp[:, T - pad:] = -(2**30)
    return q, k, v, qp, kp


def k6_tile_classes(case, qp, kp) -> dict:
    """How many (q tile, kv tile) pairs of one kv head K6 skips, masks and
    takes whole, from ``kv_tile_classes`` (the kernel's rule in torch)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref

    _, B, S, T, H, KV, dtn, window, _ = case
    dt = getattr(torch, dtn)
    cls = fa_ref.kv_tile_classes(qp[::KV], kp[::KV], H // KV, fa_k.ROW_TILE[dt],
                                 fa_k.KEY_TILE[dt], causal=True, window=window)
    return {"rows": fa_k.ROW_TILE[dt], "keys": fa_k.KEY_TILE[dt],
            "skip": int((cls == fa_ref.SKIP).sum()), "partial": int((cls == fa_ref.PARTIAL).sum()),
            "full": int((cls == fa_ref.FULL).sum())}


def check_k6(launches: int, build) -> list[dict]:
    """K6 at the LM's shapes against ``flash_attention_ref`` on the same
    card tensors (float32 products in full float32), within ``K6_LIMITS``.
    The plain version runs over K6's key tiles (``KEY_TILE``), so each
    row's running max, and with it each p rounded to bf16, is K6's: over
    other tiles the two would round p apart, as far apart as a p left
    unrounded.
    Two planted faults, computed by the plain version on altered inputs,
    must fail those limits: one kv tile in the middle dropped (its keys
    masked), and, in bf16, q and p kept in float32 (the inputs upcast).
    ``scaled_dot_product_attention`` is the yardstick: ``is_causal`` where
    the mask is causal alone, else a boolean mask built from the positions
    (every query row sees a key, so the sentinel decides nothing).  Each
    row also states the tile classes and the compiled kernel's registers,
    spills and shared memory."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_ref

    _highest_f32()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    hd = K6_HD
    for case in K6_CASES:
        name, B, S, T, H, KV, dtn, window, pad = case
        dt, G = getattr(torch, dtn), H // KV
        q, k, v, qp, kp = k6_inputs(case, gen)
        ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, qp, kp, causal=True,
                                                      window=window), reps=10)
        got = flash_attention_fwd(q, k, v, qp, kp, causal=True, window=window)
        torch.cuda.synchronize()
        out = {}

        def plain(qq=q, kk=k, vv=v, kpos=kp):
            return flash_attention_ref(qq, kk, vv, qp, kpos, causal=True, window=window,
                                       block_q=1024, block_k=fa_k.KEY_TILE[dt])

        plain_ms = cuda_time_ms(lambda: out.__setitem__("ref", plain()), reps=2)
        limits = K6_LIMITS[dtn]
        errs = _k6_errs(got, out["ref"], hd)
        j0 = (T // 2) // 64 * 64
        kp_drop = kp.clone()
        kp_drop[:, j0:j0 + 64] = -1
        faults = {f"kv tile {j0}..{j0 + 63} dropped": _k6_errs(got, plain(kpos=kp_drop), hd)}
        if dt == torch.bfloat16:
            faults["q and p kept in float32"] = _k6_errs(
                got, plain(q.float(), k.float(), v.float()).to(dt), hd)
        passed = [f for f, e in faults.items() if _within(e, limits)]
        if passed:
            raise SystemExit(f"chip_smoke: {name}: the limits {limits} do not see the "
                             f"planted faults {passed}: {faults}")
        ql = q.view(B, KV, S, G, hd).permute(0, 1, 3, 2, 4).reshape(B, H, S, hd)
        kl, vl = k.view(B, KV, T, hd), v.view(B, KV, T, hd)
        if window is None and not pad and S == T:
            library = "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, enable_gqa=True), reps=10)
        else:
            library = ("scaled_dot_product_attention(attn_mask=(B, 1, S, T) bool from the "
                       "positions, enable_gqa=True)")
            dp = qp[::KV, :, None] - kp[::KV, None, :]
            mask = (kp[::KV, None, :] >= 0) & (dp >= 0)
            if window is not None:
                mask &= dp < window
            mask = mask[:, None]
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, enable_gqa=True), reps=10)
            del mask, dp
        pairs = _visible_pairs(qp[::KV], kp[::KV], True, window) * H
        es = q.element_size()
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * es + 4 * (qp.numel() + kp.numel())
        n_ops = 4 * hd * pairs  # q·k and p·v per visible pair
        peak = BF16_TENSOR_OPS_PER_S if dt == torch.bfloat16 else SCALAR_OPS_PER_S
        b, by = bound_ms(n_bytes, n_ops, peak)
        kern = f"fa_fwd_{'bf16' if dt == torch.bfloat16 else 'f32'}<{hd}>"
        compiled = dict(build.get("k6_kernels", {}).get(kern, {}),
                        smem_bytes=fa_k.smem_bytes(hd, dt))
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/kernel.py:36",
                     "launches": launches,
                     "max_abs_err": errs["max_abs_err"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": lib_ms,
                     "shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd,
                               "dtype": dtn, "window": window, "padded_keys": pad,
                               "errors": errs, "limits": limits, "planted_faults": faults,
                               "visible_pairs_per_head": pairs // H,
                               "tile_classes": k6_tile_classes(case, qp, kp),
                               "kernel": kern, "compiled": compiled,
                               "flops": n_ops, "bytes": n_bytes,
                               "tflops_per_s": n_ops / ms / 1e9,
                               "plain": f"flash_attention_ref(block_q=1024, "
                                        f"block_k={fa_k.KEY_TILE[dt]}), on the card, TF32 off",
                               "library": library,
                               "launches_on": "llama3-8b prefill (phase lm) and "
                                              "mixtral-8x7b prefill (phase moe)"}})
        del q, k, v, ql, got, out
    return rows


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tree_leaves(v)]
    return [tree]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _pool_errs(got: list, want: list) -> list:
    """Each CIN layer's max |got − want| over the layer's max |want|."""
    return [float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]


XDEEPFM_PARAMS = 50_453_809


def phase_recsys(p99_requests: int = 16, bulk_batch: int = 262_144, bulk_requests: int = 2,
                 n_candidates: int = 1_000_000, cpu_rows: int = 1024) -> dict:
    """The recsys serving path at xDeepFM's published config: ``serve_recsys``
    (the first ``serve_p99`` request), ``p99_requests`` more of 512 samples,
    ``bulk_requests`` of ``bulk_batch``, one retrieval of 1 query against
    ``n_candidates``; then the last p99 request and the first ``cpu_rows``
    rows of the last bulk request again on the CPU."""
    import numpy as np
    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import recsys_ids, serve_recsys
    from repro_torch.models import recsys as R

    _highest_f32()
    arch = "xdeepfm"
    cfg = get_arch(arch).config
    dev = torch.device("cuda")
    problems = []

    def request(ids):
        """One request: the forward and a copy of the scores to the host."""
        pools = []
        torch.cuda.synchronize()
        c0 = launch_counts()["cin"]
        t0 = time.perf_counter()
        with torch.inference_mode():
            host = R.xdeepfm_forward(params, ids, cfg, pools=pools).cpu()
        return time.perf_counter() - t0, host, pools, launch_counts()["cin"] - c0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = {}
    t0 = time.perf_counter()
    serve_recsys(arch, batch=512, smoke=False, seed=0, device=dev, stats=stats)
    first_scores = stats["scores"].cpu()
    first_s = time.perf_counter() - t0
    params = stats["params"]
    n_params = sum(t.numel() for t in _tree_leaves(params))
    per_forward = [launch_counts()["cin"]]
    finite = bool(torch.isfinite(first_scores).all())

    p99_s = []
    for r in range(1, p99_requests + 1):
        ids = recsys_ids(trandom.PRNGKey(r), cfg, 512, dev)
        s, host, pools, k7 = request(ids)
        p99_s.append(s)
        per_forward.append(k7)
        finite &= bool(torch.isfinite(host).all())
    p99_check = (ids, host, pools)

    bulk_s = []
    for r in range(bulk_requests):
        ids = recsys_ids(trandom.PRNGKey(p99_requests + 1 + r), cfg, bulk_batch, dev)
        s, host, pools, k7 = request(ids)
        bulk_s.append(s)
        per_forward.append(k7)
        finite &= bool(torch.isfinite(host).all()) and host.shape == (bulk_batch,)
    bulk_check = (ids[:cpu_rows], host[:cpu_rows], [p[:cpu_rows] for p in pools])
    del pools

    query = recsys_ids(trandom.PRNGKey(p99_requests + bulk_requests + 1), cfg, 1, dev)
    cand = trandom.normal(trandom.PRNGKey(p99_requests + bulk_requests + 2),
                          (n_candidates, cfg.embed_dim), dev)
    retrieval_s = []  # the first call pays the first use of its kernels
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            top_v, top_i = R.retrieval_scores(params, query, cand, cfg, top_k=100)
            top_v, top_i = top_v.cpu(), top_i.cpu()
        retrieval_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # the same requests on the CPU forward, same parameters and ids
    cpu_params = _tree_to(params, "cpu")
    checks = {}
    for name, (ids, got, got_pools) in (("serve_p99 last request", p99_check),
                                        (f"serve_bulk first {cpu_rows} rows", bulk_check)):
        want_pools = []
        t0 = time.perf_counter()
        want = R.xdeepfm_forward(cpu_params, ids.cpu(), cfg, pools=want_pools)
        checks[name] = {
            "rows": int(want.shape[0]), "cpu_forward_s": time.perf_counter() - t0,
            "logits_max_abs_err": float((got - want).abs().max()),
            "logits_abs_max": float(want.abs().max()),
            "logits_within_rtol_1e-4_atol_1e-6": bool(torch.allclose(got, want, rtol=1e-4,
                                                                     atol=1e-6)),
            "pool_rel_errs": _pool_errs(got_pools, want_pools),
            "pool_abs_max": [float(w.abs().max()) for w in want_pools]}
    # every candidate scored on the CPU: the card's top 100 must carry the
    # CPU's top values, in order (a near-tie may swap two indices)
    all_v, all_i = R.retrieval_scores(cpu_params, query.cpu(), cand.cpu(), cfg,
                                      top_k=n_candidates)
    cpu_score = torch.empty(n_candidates)
    cpu_score[all_i[0].long()] = all_v[0]
    want_v = all_v[0, :100]
    retrieval_ok = bool(torch.allclose(top_v[0], want_v, rtol=1e-4, atol=1e-6)
                        and torch.allclose(cpu_score[top_i[0].long()], want_v, rtol=1e-4,
                                           atol=1e-6)
                        and (top_v[0].diff() <= 0).all())

    p99_ms = np.asarray(p99_s) * 1e3
    info = {
        "phase": "recsys", "arch": arch, "params": n_params, "dtype": str(cfg.dtype),
        "seed": 0, "n_fields": cfg.n_fields, "embed_dim": cfg.embed_dim,
        "cin_layers": list(cfg.cin_layers), "mlp_dims": list(cfg.mlp_dims),
        "embedding_rows": sum(cfg.vocabs()),
        "init_s": stats["init_s"], "init_peak_bytes": stats["init_peak_bytes"],
        "first_request_s": first_s, "first_forward_s": stats["forward_s"],
        "serve_p99": {"batch": 512, "requests": p99_requests,
                      "latency_ms": {"mean": float(p99_ms.mean()),
                                     "p99": float(np.percentile(p99_ms, 99)),
                                     "min": float(p99_ms.min())}},
        "serve_bulk": {"batch": bulk_batch, "requests": bulk_requests, "seconds": bulk_s,
                       "samples_per_s": [bulk_batch / s for s in bulk_s]},
        "retrieval": {"queries": 1, "candidates": n_candidates, "top_k": 100,
                      "latency_ms": retrieval_s[1] * 1e3,
                      "first_call_ms": retrieval_s[0] * 1e3, "matches_cpu": retrieval_ok},
        "k7_per_forward": per_forward, "launches": launches,
        "max_memory_allocated": peak, "logits_finite": finite, "cpu_checks": checks,
    }
    emit(info)
    n_forwards = 1 + p99_requests + bulk_requests
    if n_params != XDEEPFM_PARAMS:
        problems.append(f"{n_params} parameters, not {XDEEPFM_PARAMS}")
    if any(k != len(cfg.cin_layers) for k in per_forward) or \
            launches["cin"] != len(cfg.cin_layers) * n_forwards:
        problems.append(f"K7 launched {per_forward} times per forward ({launches['cin']} in "
                        f"all), not {len(cfg.cin_layers)} per forward")
    if not finite:
        problems.append("logits not finite")
    for name, c in checks.items():
        if not c["logits_within_rtol_1e-4_atol_1e-6"]:
            problems.append(f"{name}: logits differ from the CPU beyond rtol 1e-4, atol 1e-6")
        if not all(e <= 1e-5 for e in c["pool_rel_errs"]):
            problems.append(f"{name}: CIN pools differ from the CPU by {c['pool_rel_errs']} "
                            "of their max, above 1e-5")
    if not retrieval_ok:
        problems.append("retrieval top 100 differs from the CPU")
    if problems:
        raise SystemExit("chip_smoke recsys phase failed: " + "; ".join(problems))
    return {"info": info, "launches": launches}


# K7's limits against its plain version.  float32: max |Δ| over max |want|
# (the reference's jnp CIN, the Pallas kernel and the plain version agree
# to ~6e-7 of it at the published shapes).  bfloat16: per element
# |Δ| ≤ 2^-7·|want| + 2^-15·max |want| (one output rounding, and the
# float32 sums' disagreement near zero), as the ratio ``elem_ratio`` ≤ 1;
# and mean |Δ| over mean |want| ≤ 2^-16, about 10× what K7 read at layer
# 2's shape on an NVIDIA H100 80GB HBM3 at 700 W (1.42e-6) and 1/3,700 of
# a dropped h slice (0.056; PERF.md §6).
K7_LIMITS = {"float32": {"rel_err": 1e-5},
             "bfloat16": {"elem_ratio": 1.0, "mean_rel_err": 2**-16}}


def _k7_errs(got, want) -> dict:
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    top = w.max()
    return {"max_abs_err": float(d.max()), "rel_err": float(d.max() / top),
            "elem_ratio": float((d / (2**-7 * w + 2**-15 * top)).max()),
            "mean_rel_err": float(d.mean() / w.mean())}


K7_CASES = [  # name, B, Hk, dtype: m = 39, H' = 200, D = 10 (the published widths)
    ("K7 cin serve_p99 layer 1 (B=512, f32)", 512, 39, "float32"),
    ("K7 cin serve_p99 layer 2 (B=512, f32)", 512, 200, "float32"),
    ("K7 cin serve_p99 layer 2 (B=512, bf16)", 512, 200, "bfloat16"),
    ("K7 cin ragged layer 2 (B=1000, f32)", 1000, 200, "float32"),
    ("K7 cin serve_bulk layer 2 (B=262144, f32)", 262_144, 200, "float32"),
]


def k7_inputs(B: int, Hk: int, dt, gen, m: int = 39, Hn: int = 200, D: int = 10):
    """xk, x0, w at the model's scales: embeddings 0.01, layer-1 outputs
    ~5e-4, w 0.1 (layer 1 takes x0 as xk)."""
    import torch

    x0 = (0.01 * torch.randn(B, m, D, device="cuda", generator=gen)).to(dt)
    xk = x0 if Hk == m else \
        (5e-4 * torch.randn(B, Hk, D, device="cuda", generator=gen)).to(dt)
    w = (0.1 * torch.randn(Hk * m, Hn, device="cuda", generator=gen)).to(dt)
    return xk, x0, w


def k7_bounds(B: int, Hk: int, m: int, D: int, Hn: int, dtn: str, elem: int) -> dict:
    """K7's bound on the tensor cores (3 TF32 products in float32 at 495
    TFLOP/s, 2 bf16 products in bf16 at 989: the passes its rounding needs)
    and the scalar-rate bound that the scalar kernel was held to (one
    product at 67 TFLOP/s)."""
    n_ops = 2 * B * D * Hk * m * Hn
    n_bytes = (B * D * (Hk + m + Hn) + Hk * m * Hn) * elem
    passes, rate = (3, TF32_TENSOR_OPS_PER_S) if dtn == "float32" else \
        (2, BF16_TENSOR_OPS_PER_S)
    b, by = bound_ms(n_bytes, passes * n_ops, rate)
    return {"bound_ms": b, "bound_by": by, "bound_scalar_ms": bound_ms(n_bytes, n_ops)[0],
            "flops": n_ops, "tensor_flops": passes * n_ops, "bytes": n_bytes}


def check_k7(recsys, build) -> list[dict]:
    """K7 at the recsys path's shapes against ``cin_layer_ref`` on the same
    card tensors (float32 products in full float32), within ``K7_LIMITS``.
    Two launches on the same inputs must give equal bits.  Two planted
    faults must fail those limits: the plain version with one h slice of
    ``xk`` zeroed, and, where ``plan`` splits the K stages, the emulated
    partials (``cin_split_partials``) summed without one split.  The
    yardstick is one ``torch.einsum`` of the same function with TF32 off,
    where its (B, Hk, m, D) intermediate fits the card."""
    import torch

    from repro_torch.kernels.cin import cin_layer, cin_layer_ref, cin_split_partials, plan
    from repro_torch.kernels.cin.kernel import _lib, _slots

    _highest_f32()
    gen = torch.Generator(device="cuda").manual_seed(0)
    m, Hn, D = 39, 200, 10
    compiled = {k: v for k, v in build.get("k7_kernels", {}).items() if "cin_kernel" in k}
    rows = []
    for name, B, Hk, dtn in K7_CASES:
        dt = getattr(torch, dtn)
        bulk = B > 100_000
        xk, x0, w = k7_inputs(B, Hk, dt, gen)
        is_bf16 = int(dt == torch.bfloat16)
        cut = plan(B, Hk, m, D, Hn, dt, _slots(_lib(), xk.device, m, is_bf16), _lib())
        ms = cuda_time_ms(lambda: cin_layer(xk, x0, w), reps=3 if bulk else 10)
        got = cin_layer(xk, x0, w)
        again = cin_layer(xk, x0, w)
        torch.cuda.synchronize()
        as_int = torch.int16 if is_bf16 else torch.int32
        repeatable = bool(torch.equal(got.view(as_int), again.view(as_int)))
        del again
        out = {}
        plain_ms = cuda_time_ms(lambda: out.__setitem__("ref", cin_layer_ref(xk, x0, w)),
                                reps=1 if bulk else 3)
        limits = K7_LIMITS[dtn]
        errs = _k7_errs(got, out["ref"])
        h_drop = Hk // 2
        xk_drop = xk.clone()
        xk_drop[:, h_drop] = 0
        faults = {f"h = {h_drop} dropped": _k7_errs(got, cin_layer_ref(xk_drop, x0, w))}
        del xk_drop
        emulation = None
        if not bulk:
            parts = cin_split_partials(xk, x0, w, splits=cut["splits"])
            emulation = _k7_errs(got, sum(parts[1:], parts[0]).to(dt))
            if len(parts) > 1:
                s_drop = len(parts) // 2
                kept = [p for i, p in enumerate(parts) if i != s_drop]
                faults[f"split {s_drop} of {len(parts)} dropped"] = \
                    _k7_errs(got, sum(kept[1:], kept[0]).to(dt))
            del parts
        for fault, fe in faults.items():
            if _within(fe, limits):
                raise SystemExit(f"chip_smoke: {name}: the limits {limits} do not see the "
                                 f"planted fault ({fault}): {fe}")
        if not repeatable:
            raise SystemExit(f"chip_smoke: {name}: two launches on the same inputs differ")
        w3 = w.view(Hk, m, Hn)
        z_bytes = B * Hk * m * D * 4
        if z_bytes < torch.cuda.mem_get_info()[0] // 4:
            lib_ms = cuda_time_ms(lambda: torch.einsum("bhd,bmd,hmn->bnd", xk, x0, w3), reps=10)
            library = "torch.einsum('bhd,bmd,hmn->bnd'), TF32 off, opt_einsum " + \
                ("on" if torch.backends.opt_einsum.enabled else "off")
        else:
            lib_ms = None
            library = (f"none: one torch.einsum forms the {z_bytes:,}-byte (B, Hk, m, D) "
                       "product, more than the card holds")
        bounds = k7_bounds(B, Hk, m, D, Hn, dtn, xk.element_size())
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/cin/csrc/cin.cu",
                     "replaces": "src/repro/kernels/cin/kernel.py:39",
                     "launches": recsys["launches"]["cin"],
                     "max_abs_err": errs["max_abs_err"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds["bound_ms"],
                     "bound_by": bounds["bound_by"], "library_ms": lib_ms,
                     "shape": {"B": B, "Hk": Hk, "m": m, "H'": Hn, "D": D, "dtype": dtn,
                               "plan": cut, "errors": errs, "limits": limits,
                               "repeatable_bits": repeatable,
                               "emulation_errors": emulation,
                               "planted_faults": faults,
                               "flops": bounds["flops"], "tensor_flops": bounds["tensor_flops"],
                               "bytes": bounds["bytes"],
                               "bound_scalar_ms": bounds["bound_scalar_ms"],
                               "tflops_per_s": bounds["flops"] / ms / 1e9,
                               "tensor_tflops_per_s": bounds["tensor_flops"] / ms / 1e9,
                               "compiled": compiled,
                               "plain": "cin_layer_ref on the card, TF32 off",
                               "library": library,
                               "launches_on": "xDeepFM serving (phase recsys)"}})
        del x0, xk, w, got, out
    return rows



# ------------------------------------------------------------- phase train

# phase train's cuts: llama3-8b at published width, its train_4k batch cut
# from 256 sequences to 2 and its depth from 32 layers to 4 (1.92 G
# parameters, about 23 GB of bf16 parameters and gradients and float32
# moments; the full depth, 8.03 G, needs about 96 GB of state alone)
TRAIN_LM_LAYERS, TRAIN_LM_BATCH, TRAIN_LM_STEPS = 4, 2, 3
TRAIN_STEPS = 3  # xDeepFM's and the GNNs' steps
TRAIN_GNN_CELLS = (("gcn-cora", "full_graph_sm"), ("schnet", "molecule"),
                   ("egnn", "molecule"), ("dimenet", "molecule"))
# each backward kernel against its plain version on the same card tensors:
# the largest error of each gradient over the gradient's largest magnitude
# (float32: the products sum in another order; bf16: p and ds are rounded
# to bf16 from scores summed in another order, and each result once)
K6B_LIMITS = {"bfloat16": 2**-6, "float32": 1e-5}
K7B_LIMIT = 1e-5
# the card's gradients against the CPU's (one AdamW step's first moment,
# 0.1 × the clipped gradient), per leaf over its largest magnitude: cuBLAS
# and the CPU's BLAS sum in other orders, K6/K7 against their plain
# versions; the smoke LM's weights (fan_in = L = 2) make its attention
# nearly one-hot, which amplifies those ulps (tests/test_torch_train.py)
TRAIN_GRAD_TOL = {"llama3-8b": 1e-3, "other": 1e-4}


def _train_run(arch: str, shape: str, smoke: bool, ckpt_dir: str, save: bool = True,
               **kw) -> dict:
    """One ``launch.train.train`` call on the card with every launch counter
    at 0 just before and read just after; its figures, state and peak.
    ``save=False`` hands ``train`` a checkpoint manager that writes nothing:
    with ``ckpt_every`` past the steps that skips only the run's final
    checkpoint, tens of GB for the LM (scripts/profile_train.py --save
    times it)."""
    from unittest import mock

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as train_mod

    class Unsaved(CheckpointManager):
        def save(self, step, state):
            pass

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    info: dict = {}
    t0 = time.perf_counter()
    with mock.patch.object(train_mod, "CheckpointManager",
                           CheckpointManager if save else Unsaved):
        state, metrics = train_mod.train(arch, shape, smoke=smoke, ckpt_dir=ckpt_dir,
                                         device="cuda", info=info, **kw)
    torch.cuda.synchronize()
    return {"state": state, "metrics": metrics, "info": info, "launches": launch_counts(),
            "wall_s": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated()}


def _tree_finite(tree) -> bool:
    import torch

    from repro_torch.streaming.carry import tree_flatten

    return all(bool(torch.isfinite(x).all()) for x in tree_flatten(tree)[0]
               if x.is_floating_point())


def _same_bits(a, b) -> bool:
    import torch

    from repro_torch.streaming.carry import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _rel_errs(got, want) -> list:
    return [float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp(min=1e-30))
            for g, w in zip(got, want)]


def check_k6b(launches: int) -> list[dict]:
    """K6b against ``flash_attention_bwd_ref`` at llama3-8b's training shape
    in bf16 (B = 2: BK = 16, S = T = 4,096, G = 4, hd = 128, causal) and at a
    small ragged float32 shape with Mixtral's kind of window, each launched
    twice (the bits must repeat), with its time, its plain version's and
    SDPA's backward (``enable_gqa``; forward and backward minus forward)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import _k6, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    dev = torch.device("cuda")
    rows = []
    for B, KV, S, G, hd, dt, window in ((2, 8, 4096, 4, 128, torch.bfloat16, None),
                                        (2, 4, 1000, 4, 128, torch.float32, 256)):
        BK, T = B * KV, S
        gen = torch.Generator(dev).manual_seed(S)
        q, dout = (torch.randn((BK, S, G * hd), generator=gen, device=dev).to(dt)
                   for _ in range(2))
        k, v = (torch.randn((BK, T, hd), generator=gen, device=dev).to(dt) for _ in range(2))
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(BK, S).contiguous()
        out, lse = _k6(q, k, v, pos, pos, True, window, True)
        args = (q, k, v, out, lse, dout, pos, pos)
        got = flash_attention_bwd(*args, causal=True, window=window)
        again = flash_attention_bwd(*args, causal=True, window=window)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        ms = cuda_time_ms(lambda: flash_attention_bwd(*args, causal=True, window=window), 3)
        want = {}
        plain_ms = cuda_time_ms(lambda: want.__setitem__("g", flash_attention_bwd_ref(
            *args, causal=True, window=window, block_q=512, block_k=1024)), 1)
        errs = _rel_errs(got, want["g"])
        dtn = "bfloat16" if dt == torch.bfloat16 else "float32"
        limit = K6B_LIMITS[dtn]
        pairs = G * _visible_pairs(pos, pos, True, window)
        n_ops = 5 * 2 * hd * pairs  # s, dp, dv, dk, dq over the visible pairs
        elem = q.element_size()
        n_bytes = 4 * BK * S * G * hd * elem + 4 * BK * T * hd * elem + 4 * BK * S * G
        passes, rate = (1, BF16_TENSOR_OPS_PER_S) if dt == torch.bfloat16 else \
            (3, TF32_TENSOR_OPS_PER_S)
        b, by = bound_ms(n_bytes, passes * n_ops, rate)
        # SDPA on the model layout: q (B, H, S, hd), k/v (B, KV, T, hd)
        lib_ms, lib_err = None, None
        try:
            q4 = q.view(B, KV, S, G, hd).permute(0, 1, 3, 2, 4).reshape(B, KV * G, S, hd)
            q4 = q4.detach().clone().requires_grad_()
            k4 = k.view(B, KV, T, hd).detach().clone().requires_grad_()
            v4 = v.view(B, KV, T, hd).detach().clone().requires_grad_()
            d4 = dout.view(B, KV, S, G, hd).permute(0, 1, 3, 2, 4).reshape(B, KV * G, S, hd)
            mask = None
            if window is not None:
                i = torch.arange(S, device=dev)
                mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)

            def fwd():
                return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                      is_causal=mask is None, enable_gqa=True)

            def fwd_bwd():
                fwd().backward(d4)

            lib_ms = cuda_time_ms(fwd_bwd, 3) - cuda_time_ms(fwd, 3)
            del q4, k4, v4, d4
        except RuntimeError as e:  # a yardstick only: record why there is none
            lib_err = str(e).splitlines()[0]
        rows.append({
            "name": f"K6b flash_attention_bwd ({dtn}, BK={BK}, S={S}, G={G}, hd={hd}"
                    + (f", window {window}" if window else "") + ")",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:128 (_fa_bwd, no Pallas kernel)",
            "launches": launches, "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
            "shape": {"BK": BK, "S": S, "T": T, "G": G, "hd": hd, "dtype": dtn,
                      "window": window, "causal": True, "visible_pairs": pairs,
                      "flops": n_ops, "bytes": n_bytes,
                      "bound_scalar_ms": bound_ms(n_bytes, n_ops)[0],
                      "errors": {"dq": errs[0], "dk": errs[1], "dv": errs[2]},
                      "limits": {"dq": limit, "dk": limit, "dv": limit},
                      "repeat_bitwise": repeat,
                      "error_measure": "max |got - want| / max |want| per gradient",
                      "plain": "flash_attention_bwd_ref(block_q=512, block_k=1024), TF32 off",
                      "library": "SDPA forward+backward minus forward (enable_gqa; "
                                 + ("is_causal)" if window is None else "a dense window mask)"),
                      "library_error": lib_err}})
        del got, want, args, q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    return rows


def check_k7b(launches: int) -> list[dict]:
    """K7b against ``cin_layer_bwd_ref`` at ``train_batch``'s CIN layers 1
    (Hk = 39) and 2 (Hk = 200) in float32, B = 65,536, each launched twice
    (the bits must repeat); the library call is the autograd backward of
    ``torch.einsum("bhd,bmd,hmn->bnd")``, or the first line of the error
    it raises (out of memory) under ``library_error``."""
    import torch

    from repro_torch.kernels.cin.kernel import bwd_splits, cin_layer_bwd
    from repro_torch.kernels.cin.ref import cin_layer_bwd_ref

    dev = torch.device("cuda")
    B, m, D, Hn = 65_536, 39, 10, 200
    rows = []
    for layer, Hk in ((1, 39), (2, 200)):
        gen = torch.Generator(dev).manual_seed(Hk)
        xk = torch.randn((B, Hk, D), generator=gen, device=dev)
        x0 = torch.randn((B, m, D), generator=gen, device=dev)
        w = 0.1 * torch.randn((Hk * m, Hn), generator=gen, device=dev)
        g = torch.randn((B, Hn, D), generator=gen, device=dev)
        got = cin_layer_bwd(xk, x0, w, g)
        again = cin_layer_bwd(xk, x0, w, g)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        ms = cuda_time_ms(lambda: cin_layer_bwd(xk, x0, w, g), 2)
        want = {}
        plain_ms = cuda_time_ms(lambda: want.__setitem__("g", cin_layer_bwd_ref(xk, x0, w, g)),
                                1)
        errs = _rel_errs(got, want["g"])
        K = Hk * m
        n_ops = 4 * B * D * K * Hn + 5 * B * D * K  # t and dw; z, dxk and dx0
        n_bytes = 4 * 2 * (B * D * (Hk + m) + K * Hn) + 4 * B * Hn * D
        b, by = bound_ms(n_bytes, 3 * n_ops, TF32_TENSOR_OPS_PER_S)
        lib_ms, lib_err = None, None
        xr, x0r = xk.detach().clone().requires_grad_(), x0.detach().clone().requires_grad_()
        wr = w.view(Hk, m, Hn).detach().clone().requires_grad_()

        def fwd_bwd():
            torch.einsum("bhd,bmd,hmn->bnd", xr, x0r, wr).backward(g)

        def fwd():
            torch.einsum("bhd,bmd,hmn->bnd", xr, x0r, wr)

        try:
            lib_ms = cuda_time_ms(fwd_bwd, 2) - cuda_time_ms(fwd, 2)
        except RuntimeError as e:
            lib_err = str(e).splitlines()[0]
        del xr, x0r, wr
        torch.cuda.empty_cache()
        rows.append({
            "name": f"K7b cin_bwd (train_batch layer {layer}: B={B}, Hk={Hk}, m={m}, D={D}, "
                    f"H'={Hn}, float32)",
            "route": "cuda", "source": "src/repro_torch/kernels/cin/csrc/cin_bwd.cu",
            "replaces": "src/repro/models/recsys.py:158 (_cin_layer, differentiated by XLA)",
            "launches": launches, "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
            "shape": {"B": B, "Hk": Hk, "m": m, "D": D, "H'": Hn, "dtype": "float32",
                      "splits": bwd_splits(B, Hk, m, D, Hn), "flops": n_ops,
                      "bytes": n_bytes, "bound_scalar_ms": bound_ms(n_bytes, n_ops)[0],
                      "errors": {"dxk": errs[0], "dx0": errs[1], "dw": errs[2]},
                      "limits": {"dxk": K7B_LIMIT, "dx0": K7B_LIMIT, "dw": K7B_LIMIT},
                      "repeat_bitwise": repeat,
                      "error_measure": "max |got - want| / max |want| per gradient",
                      "plain": "cin_layer_bwd_ref, TF32 off",
                      "library": 'autograd backward of torch.einsum("bhd,bmd,hmn->bnd") '
                                 "(forward+backward minus forward)",
                      "library_error": lib_err}})
        del got, want, xk, x0, w, g
        torch.cuda.empty_cache()
    return rows


def check_k5t(launches: int, gcn_batch: dict, mol_batch: dict) -> list[dict]:
    """K5ᵀ (K5 over a transposed layout, the gradient of a sum) on phase
    train's own layouts: GCN's by-destination layout of the gcn-cora
    ``full_graph_sm`` batch (its transpose sums into the sources) and SchNet's
    ``message_layout`` of the ``molecule`` batch (each transposed row one
    edge); bitwise against the plain version, the bits repeated."""
    import torch

    from repro_torch.kernels.segment_agg import segment_agg
    from repro_torch.models.gnn import gcn_norm, message_layout

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(5)
    rows = []
    V = int(gcn_batch["feats"].shape[0])
    norm = gcn_norm(gcn_batch["edge_src"], gcn_batch["edge_dst"], V,
                    edge_mask=gcn_batch["edge_mask"], device=dev)
    Vm, E = int(mol_batch["species"].shape[0]), int(mol_batch["edge_src"].shape[0])
    into_nodes = message_layout(mol_batch["edge_dst"], Vm, device=dev)
    for label, fwd, n_x, d in (("gcn-cora full_graph_sm, d 16", norm.fwd, V, 16),
                               ("schnet molecule message layout, d 64", into_nodes, E, 64)):
        lay = fwd.transposed(n_x)
        g = torch.randn((fwd.n_rows, d), generator=gen, device=dev)  # the sum's gradient
        row = _k5_row(f"K5ᵀ segment_agg over the transposed layout ({label})", g, lay,
                      launches)
        first, second = segment_agg(g, lay), segment_agg(g, lay)
        torch.cuda.synchronize()
        row["shape"]["repeat_bitwise"] = bool(torch.equal(first, second))
        row["shape"]["rows_of_x"] = n_x
        row["replaces"] = ("src/repro/models/gnn.py:39 (the VJP of jax.ops.segment_sum: "
                           "XLA's scatter-add)")
        rows.append(row)
    return rows


def _grads_card_vs_cpu() -> dict:
    """One AdamW step of each family's smoke training cell in float32 (the
    LM cast from bf16) on the card and on the CPU from the same state and
    batch: the first moment's largest error over its largest magnitude,
    per leaf and the worst leaf of each family."""
    import dataclasses

    import torch

    from repro_torch import random as trandom
    from repro_torch.launch import cells
    from repro_torch.streaming.carry import tree_flatten, tree_flatten_with_paths

    key = trandom.PRNGKey(0)
    out = {}
    for arch, shape in (("llama3-8b", "train_4k"), ("xdeepfm", "train_batch"),
                        ("gcn-cora", "full_graph_sm"), ("schnet", "molecule"),
                        ("egnn", "molecule"), ("dimenet", "molecule")):
        mus, losses = {}, {}
        for dev in ("cpu", "cuda"):
            if arch == "llama3-8b":
                spec = cells.get_arch(arch)
                cell = cells._lm_cell(spec, shape, dict(seq=64, batch=2, kind="lm_train"),
                                      dataclasses.replace(spec.smoke_config,
                                                          dtype=torch.float32),
                                      torch.device(dev))
            else:
                cell = cells.build_cell(arch, shape, smoke=True, device=dev)
            new, metrics = cell.step_fn(cell.init_state(key),
                                        *cell.make_batch(trandom.fold_in(key, 0)))
            mus[dev] = [t.cpu() for t in tree_flatten(new.mu)[0]]
            losses[dev] = float(metrics["loss"])
            paths = [p for p, _ in tree_flatten_with_paths(new.mu)]
        errs = _rel_errs(mus["cuda"], mus["cpu"])
        out[arch] = {"shape": shape, "leaves": len(errs), "max_rel_err": max(errs),
                     "rel_err_per_leaf": dict(zip(paths, errs)),
                     "loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"],
                     "finite": all(bool(torch.isfinite(t).all()) for t in mus["cuda"])}
    return out


def phase_train() -> dict:
    """Training on the card through ``repro_torch.launch.train.train``:
    llama3-8b ``train_4k`` at published width (4 of 32 layers, 2 of 256
    sequences), the resume after a fault at the smoke config, xDeepFM
    ``train_batch`` and the four GNNs at published widths; then K6b, K7b
    and K5ᵀ against their plain versions, and each family's gradients on
    the card against the CPU."""
    import shutil
    import tempfile

    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch import cells
    from repro_torch.models import lm as LM

    t_phase = time.perf_counter()
    _highest_f32()
    torch.cuda.empty_cache()
    problems = []
    # remat's torch.utils.checkpoint imports torch._dynamo at its first call
    # (seconds in a fresh process: scripts/profile_train.py times it), taken
    # here, so that the LM's first step times the step
    t0 = time.perf_counter()
    import torch._dynamo  # noqa: F401

    dynamo_import_s = time.perf_counter() - t0
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    runs = {}
    try:
        # llama3-8b at published width, cut in depth and batch
        cfg = dataclasses.replace(get_arch("llama3-8b").config, n_layers=TRAIN_LM_LAYERS)
        r = _train_run("llama3-8b", "train_4k", False, ckpt, steps=TRAIN_LM_STEPS,
                       n_layers=TRAIN_LM_LAYERS, batch=TRAIN_LM_BATCH,
                       ckpt_every=TRAIN_LM_STEPS + 1, save=False)
        step_s = r["info"]["step_s"]
        lm = {"phase": "train", "run": "llama3-8b train_4k", "layers": TRAIN_LM_LAYERS,
              "batch": TRAIN_LM_BATCH, "seq": 4096, "cuts": r["info"]["cuts"],
              "params": LM.count_params(cfg), "steps": r["info"]["steps"],
              "ms_per_step": [s * 1e3 for s in step_s],
              "tokens_per_s": [TRAIN_LM_BATCH * 4096 / s for s in step_s],
              "losses": r["info"]["losses"], "entry_copy_s": r["info"]["entry_copy_s"],
              "wall_s": r["wall_s"], "max_memory_allocated": r["peak"],
              "launches": {k: r["launches"][k] for k in ("flash_attention",
                                                         "flash_attention_bwd")},
              "model_flops_per_step": r["info"]["model_flops"]}
        lm["params_finite"] = _tree_finite(r["state"].params)
        emit(lm)
        runs["lm"] = lm
        del r
        torch.cuda.empty_cache()
        want_k6 = 2 * TRAIN_LM_LAYERS * TRAIN_LM_STEPS  # remat: each layer's forward twice
        if lm["launches"]["flash_attention"] != want_k6 or \
                lm["launches"]["flash_attention_bwd"] != TRAIN_LM_LAYERS * TRAIN_LM_STEPS:
            problems.append(f"the LM launched K6/K6b {lm['launches']}, not {want_k6}/"
                            f"{TRAIN_LM_LAYERS * TRAIN_LM_STEPS}")
        if not (lm["params_finite"] and all(math.isfinite(x) for x in lm["losses"])):
            problems.append("the LM's losses or parameters are not finite")

        # resume after a fault at the smoke config: the same bits as without it
        clean = _train_run("llama3-8b", "train_4k", True, ckpt + "/clean", steps=4,
                           ckpt_every=100)
        faulty = _train_run("llama3-8b", "train_4k", True, ckpt + "/faulty", steps=4,
                            ckpt_every=2, fail_at=(2,))
        resume = {"phase": "train", "run": "llama3-8b smoke resume, fail_at=(2,)",
                  "restarts": faulty["info"]["restarts"],
                  "same_bits": _same_bits(clean["state"], faulty["state"]),
                  "losses_clean": clean["info"]["losses"],
                  "losses_faulty": faulty["info"]["losses"]}
        emit(resume)
        runs["resume"] = resume
        if resume["restarts"] != 1 or not resume["same_bits"]:
            problems.append(f"the resumed run is not the clean run's bits: {resume}")
        del clean, faulty

        # xDeepFM at published width
        r = _train_run("xdeepfm", "train_batch", False, ckpt, steps=TRAIN_STEPS,
                       ckpt_every=TRAIN_STEPS + 1, save=False)
        rec = {"phase": "train", "run": "xdeepfm train_batch", "batch": 65_536,
               "ms_per_step": [s * 1e3 for s in r["info"]["step_s"]],
               "losses": r["info"]["losses"], "wall_s": r["wall_s"],
               "max_memory_allocated": r["peak"],
               "launches": {k: r["launches"][k] for k in ("cin", "cin_bwd")},
               "params_finite": _tree_finite(r["state"].params)}
        emit(rec)
        runs["xdeepfm"] = rec
        del r
        if rec["launches"] != {"cin": 3 * TRAIN_STEPS, "cin_bwd": 3 * TRAIN_STEPS}:
            problems.append(f"xDeepFM launched K7/K7b {rec['launches']}, not 3 each a step")
        if not (rec["params_finite"] and all(math.isfinite(x) for x in rec["losses"])):
            problems.append("xDeepFM's losses or parameters are not finite")

        # the GNNs at published widths on the reference cells' batches
        gnn_launches = 0
        for arch, shape in TRAIN_GNN_CELLS:
            r = _train_run(arch, shape, False, ckpt, steps=TRAIN_STEPS,
                           ckpt_every=TRAIN_STEPS + 1)
            row = {"phase": "train", "run": f"{arch} {shape}",
                   "ms_per_step": [s * 1e3 for s in r["info"]["step_s"]],
                   "losses": r["info"]["losses"], "wall_s": r["wall_s"],
                   "max_memory_allocated": r["peak"],
                   "k5_forward": r["launches"]["segment_agg"],
                   "k5t_backward": r["launches"]["segment_agg_transposed"],
                   "params_finite": _tree_finite(r["state"].params)}
            emit(row)
            runs[arch] = row
            gnn_launches += row["k5t_backward"]
            if row["k5_forward"] == 0 or row["k5t_backward"] == 0:
                problems.append(f"{arch} launched K5 {row['k5_forward']} and K5ᵀ "
                                f"{row['k5t_backward']} times")
            if not (row["params_finite"] and all(math.isfinite(x) for x in row["losses"])):
                problems.append(f"{arch}'s losses or parameters are not finite")
            del r
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    main_s = time.perf_counter() - t_phase

    # the backward kernels against their plain versions, on the path's shapes
    key = trandom.fold_in(trandom.PRNGKey(0), 0)  # train()'s first batch
    gcn_batch = cells.build_cell("gcn-cora", "full_graph_sm", device="cuda").make_batch(key)[0]
    mol_batch = cells.build_cell("schnet", "molecule", device="cuda").make_batch(key)[0]
    rows = [*check_k6b(runs["lm"]["launches"]["flash_attention_bwd"]),
            *check_k7b(runs["xdeepfm"]["launches"]["cin_bwd"]),
            *check_k5t(gnn_launches, gcn_batch, mol_batch)]
    for r in rows:
        if not r["shape"].get("repeat_bitwise", False):
            problems.append(f"{r['name']}: two launches gave other bits")
    grads = _grads_card_vs_cpu()
    emit({"phase": "train", "step": "gradients, card against CPU", "families": grads,
          "tolerance": TRAIN_GRAD_TOL})
    for arch, v in grads.items():
        if not v["finite"] or not v["max_rel_err"] <= TRAIN_GRAD_TOL.get(arch,
                                                                         TRAIN_GRAD_TOL["other"]):
            problems.append(f"{arch}'s gradient on the card is {v['max_rel_err']} from the "
                            f"CPU's")
    phase_s = time.perf_counter() - t_phase
    info = {"phase": "train", "step": "done", "dynamo_import_s": dynamo_import_s,
            "main_path_s": main_s, "phase_s": phase_s, "within_60_s": phase_s <= 60.0}
    emit(info)
    if problems:
        raise SystemExit("chip_smoke train phase failed: " + "; ".join(problems))
    return {"info": {**info, "runs": runs, "gradients": grads}, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="R-MAT scale of the main path (default 20)")
    ap.add_argument("--products-scale", type=float, default=1.0,
                    help="scale of the served ogbn_products_like graph (default 1.0)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    dev = phase_device()
    build = phase_build()
    results = {"device": dev, "build": build}
    later = {"seed1": (args.scale, 1)}  # phase incremental's 10 % delta
    for name, scale in (("distributed", DIST_SCALE), ("clugp", CLUGP_SCALE)):
        if args.scale > scale:
            later[name] = (scale, 0)
    graphs = make_graphs((args.scale, 0), later)
    graphs.setdefault("distributed", graphs["main"])
    graphs.setdefault("clugp", graphs["main"])
    main_run = phase_main(args.scale, graphs["main"])
    compare = phase_compare(main_run, graphs.pop("clugp"))
    t0 = time.perf_counter()
    parallel = phase_parallel(main_run)
    parallel["phase_s"] = time.perf_counter() - t0
    emit({"phase": "parallel", "step": "done", "phase_s": parallel["phase_s"]})
    t0 = time.perf_counter()
    ooc = phase_ooc(main_run)
    ooc["phase_s"] = time.perf_counter() - t0
    emit({"phase": "ooc", "step": "done", "phase_s": ooc["phase_s"]})
    incremental = phase_incremental(main_run, compare, graphs.pop("seed1"))
    elastic = phase_elastic(main_run, incremental)
    for key in ("base", "hdrf_cold"):
        incremental.pop(key, None)
    hybrid = phase_hybrid(main_run)
    serve = phase_serve(args.products_scale)
    gnn3d = phase_gnn3d(serve)
    lm = phase_lm()
    moe = phase_moe()
    recsys = phase_recsys()
    train = phase_train()
    summary, all_rows = phase_kernels(main_run, compare, serve, gnn3d, lm, moe, recsys,
                                      build, incremental, elastic, hybrid, train)
    results.update(main=main_run["info"], compare=compare["rows"],
                   pagerank=compare["pagerank"], parallel=parallel, ooc=ooc,
                   incremental={key: v for key, v in incremental.items()
                                if key != "retract_pairs"}, elastic=elastic,
                   hybrid=hybrid, serve=serve["info"], gnn3d=gnn3d["info"])
    del serve, gnn3d
    results["parity"] = phase_parity()
    distributed = phase_distributed(main_run, graphs.pop("distributed"), args.scale)
    for r in summary:  # the launches of phase distributed's worlds, all ranks
        r["launches_distributed"] = distributed["launches"].get(
            _COUNTERS.get(r["name"].split()[0]), 0)
    results.update(lm=lm["info"], lm_f32_check=lm["f32_check"], moe=moe["info"],
                   moe_f32_check=moe["f32_check"], recsys=recsys["info"],
                   train=train["info"],
                   distributed=distributed, kernels=all_rows,
                   total_s=time.perf_counter() - t_start)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1, default=str)
    emit({"kernels": [{k: v for k, v in r.items() if k != "shape"} for r in summary]})
    emit({"phase": "total", "total_s": results["total_s"]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
