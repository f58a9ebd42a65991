#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when all
of them passed):

  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. build the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
  3. each force kernel against its plain PyTorch version (and against
     itself: two calls on one input must agree bit for bit):
     a. before phase 4, on drawn inputs: the largest exact, neighbor and
        grid levels of delaunay(1_000_000)'s hierarchy, positions drawn
        from a seed (``inputs: "random"``);
     b. after phase 4, on the path's own inputs: nbody, neighbor_force,
        grid_near and grid_far on the arguments of their first call at each
        level of phase 4's profiled run, one row a shape with that shape's
        launches, which sum to the kernel's launches in phase 4
        (``inputs: "path"``).
     c. after 3a, the stress engine's two extreme entropy constants: each
        force kernel against its plain version on 3a's inputs at C = α·C
        for α = ALPHA0 and ALPHA0·ALPHA_SHRINK (``core/stress.py``), within
        phase 3's tolerance (the force is linear in C);
     d. after phase 7, the lane rows: each force kernel over lanes on the
        arguments of its first call at each batched group shape of phase 7
        (``ManyRecorder``), against its plain version over lanes within
        phase 3's tolerance and against B one-lane calls bit for bit; timed
        as the other rows, with ``one_lane_ms`` (lane 0 alone at that
        shape) beside, the bound counting the live lanes' work only, and
        the launches of that shape in the suite's warm batched run, as the
        wrappers count them by shape;
     One JSON line a row (3a and 3b also time the same inputs handed over
     as one lane, ``b1_ms``, whose bits must equal the call's): ``ms`` is device time per call (calls captured in
     a CUDA graph, replayed between CUDA events), ``eager_ms`` the same
     calls made back to back from Python (the median of a few batches,
     host work included); the plain version's ms; the least time the card
     could take (bytes over 3.35 TB/s or 11 flops a pair over 67 TFLOP/s
     fp32, whichever is larger, for the pairs and vertices this input
     needs). The row's own line also gives the pairs and, for all but
     nbody, the MUFU ceiling (one reciprocal a pair at 16 a clock per SM),
     which the ``{"kernels": [...]}`` line leaves out;
  4. the main path, ``repro_torch.core.multigila_layout`` with the default
     ``LayoutConfig()``, on delaunay(1_000_000) on the card, its refinement
     through the step cache (``core/bucketing.py``: one captured CUDA graph
     of one iteration per shape bucket, replayed once an iteration): a cold
     run (cache cleared), then a warm one, then the eager loop beside them
     (``EagerRefine`` patches ``bucketing.refine_level`` to the engine's
     Python loop for the length of a run). Every position finite, every
     kernel launched, the launches (replays included) and the levels and
     modes of all three equal, NELD of the cached runs within NELD_DELTA
     of the eager run's; wall, phase seconds (``compile``: warm-up and
     capture of cold entries), the cache's entries/hits/misses and the
     allocator's peak are printed for each. Then, under torch.profiler, the
     warm cached run and the eager run (device busy and idle share), the
     latter with the force kernels' arguments recorded for phase 3b
     (``PathInputs``). Then, level by level, the host seconds of the k-hop
     build and the iterations' wall and device span through the cache and
     eagerly (``refine_breakdown``, 4f); last, at the largest level of each
     mode, k = 10 iterations replayed from the cached entry against the
     eager loop (4e), EAGER_RUNS runs of each: the median replay-to-eager
     distance (mean per-vertex max |Δpos|) and the median distance between
     two replays within REPLAY_FACTOR times the median distance between two
     eager runs over the same k iterations (``index_add_``'s atomics change
     the bits from run to run), that spread floored at FLOOR_ULPS ulps;
     b. the stress path: the same cold / warm / eager runs, profiles,
        refine breakdown and replay check with
        ``LayoutConfig(engine="stress")`` and per-edge weights drawn from a
        seed, on the same graph: its levels, modes and launches equal phase
        4's (the schedule is the gila path's);
     c. the ``flat`` driver on the same graph (one grid level of 300
        iterations), cached and eager: wall and NELD beside phase 4's.
        ``centralized`` is not run at this size (exact all-pairs over 10^6
        vertices);
     d. the weighted hierarchy of the same graph built on the card and on
        the CPU: level sizes and every array, ``ewt`` included, equal bit
        for bit, and the CPU build's seconds;
     g. after 4b, every cached refine step of the layout path, both
        engines, under ``torch.cuda.set_sync_debug_mode("error")`` (a host
        sync raises): the single-graph ``RefineProgram`` on a warm entry
        at the largest level of each mode (4b's cold run cleared gila's
        entries, which are captured again first), and the batched
        ``RefineManyProgram`` on two lanes of the smallest level of each
        mode; each SYNC_ITERS iterations (replays and a schedule chunk
        reload), then EAGER_STEPS eager calls of the step function, its
        launches equal to its iterations, positions finite;
  The CPU sides of phases 4d, 5, 5b, 5d, 9c, 9e and 10b (hierarchies and
  layouts on the CPU, 9e's dry-run counts, 10b's training steps: the
  references of card-against-CPU checks) run in CPU_WORKERS worker processes
  (``CpuRefs``) from the end of phase 4c until phase 7, beside the card's
  phases 4d to 6; each card side runs in its place, and its check against
  the CPU reference is made once the workers are done, before phase 7
  (9c's in phase 9c, 10b's in phase 10b). Phase 10e(d)'s CPU side, 8 gloo
  ranks under torchrun (``ElasticCpuRun``), runs from the script's start;
  5. a ~5,000-vertex delaunay with exact_threshold=64, grid_threshold=512
     (all three modes): the hierarchy built on the card equals the one built
     on the CPU, and the card's layout scores within the stated deltas of the
     CPU layout's NELD and CRE;
     b. the same graph, card against CPU, through the ported engine and
        drivers: the stress engine with weights (three modes; weighted
        hierarchy equal, ``ewt`` included; NELD and CRE within the deltas),
        ``centralized`` (NELD and CRE within the deltas) and ``flat`` (the
        random init equal, the first 5 iterations within FLAT_EARLY_TOL,
        NELD within the delta; the final CRE is printed, not compared:
        a flat run from a random init is chaotic at this size);
     c. the layout CLI, ``repro_torch.launch.layout.main`` with
        ``--engine stress``, in process on the card;
     d. the batched driver, card against CPU: the first LANES_5D graphs of
        suite A (below) with exact_threshold=64, grid_threshold=512 (all
        three modes) through ``multigila_layout_many`` on both (on the card
        once more with every seed moved by SPREAD_SEED): every lane's
        hierarchy equal bit for bit and NELD within NELD_DELTA, the
        sequential driver's on the card too; each batched lane's CRE within
        max(CRE_DELTA, CRE_SPREAD_MULT × the median gap between the card's
        runs of the two seeds) of the card's sequential run, and
        against the CPU each driver's lanes' mean within
        max(CRE_MEAN_DELTA, CRE_MEAN_SES standard errors), each lane
        printed (``many_card_vs_cpu``);
  6. the LM serving path, for each of LM_ARCHS in turn at its published
     width and depth in bf16, weights drawn from a seed on the card and
     freed before the next model's: internlm2-1.8b (24 layers, 16 heads
     over 8 KV heads), starcoder2-7b (32 layers, 36 over 4: GQA group 9),
     starcoder2-15b (40 layers, 48 over 4: group 12), gemma-2b (18 layers,
     8 heads over 1 at hd 256: MQA, GeGLU, a tied head over 256000 tokens),
     granite-moe-3b-a800m (32 layers, 24 over 8 at hd 64: group 3; 40
     experts top-8) and deepseek-moe-16b (28 layers, 16 over 16: MHA; a
     dense layer 0 of width 10944, then 64 experts top-6 and 2 shared
     experts), mamba2-1.3b (48 SSD layers, d_model 2048, 64 heads of P
     64 over N 128, chunk 256, no attention, a tied head over 50288
     tokens), jamba-v0.1-52b (d_model 4096; a period of 8 layers: SSD
     layers of 128 heads over N 16, attention at position 4 with 32 heads
     over 8, MoE of 16 experts top-2 on odd layers), seamless-m4t-medium
     (12 encoder and 12 decoder layers, d_model 1024, 16 heads over 16 at
     hd 64, LayerNorm, GELU, an untied head over 256208 tokens; its 2048
     positions are 1024 audio-frame embeddings for the encoder and a
     1024-token decoder prompt, LM_FRAMES) and internvl2-76b (d_model
     8192, 64 heads over 8 at hd 128: group 8; SwiGLU of 28672, vocab
     128256; its prompt's first 256 positions patch embeddings),
     deepseek, jamba and internvl2 at named depth cuts in 6b (LM_DEPTH, at
     full width: deepseek's dense layer 0 and 7 of its 27 MoE layers, so
     that the script keeps inside its time limit on a slow host; jamba's
     first period, 8 of its 32 layers, and internvl2's first 16 of 80,
     since their ~103 and ~141 GB of bf16 weights do not fit the card);
     a. the flash-attention kernel against its plain version at the path's
        shapes, on its layout — prefill (B 4, Sq = Sk = the decoder prompt,
        2048 or seamless's 1024, the model's hd, causal; k/v = cache[:,
        :prompt] of a prompt + 40-row cache: the wgmma route) and decode
        (Sq 1 against the whole cache with ``kv_len`` an int32 on the
        device, as ``decode_step`` calls it, checked at kv_len prompt + 1,
        + 17 and + 32 and timed at the last, rotating over caches of
        DECODE_KV_BYTES together, twice the L2: the split-KV route); for
        seamless also the non-causal calls: Sq = Sk = 1024 (the encoder's
        self-attention and the cross prefill; wgmma) and cross decode (Sq
        1 against 1024 frames, no ``kv_len``: split-KV), and, checked with
        no row, Sq 512 against 1024 frames (a chunk's cross-attention) and
        Sq 300 against 1000 (a ragged frame count) — timed as device time
        per call (CUDA-graph replay) and eagerly (host work included),
        beside ``scaled_dot_product_attention`` timed the same ways as a
        yardstick, with the bound max(bytes / 3.35 TB/s, flops / 989
        TFLOP/s bf16), each row's launches those of its shape (B, Sq, Sk,
        causal) in 6b's prefill or captured decode; a model without
        attention (mamba2-1.3b) prints that its path makes no flash call;
     b. ``repro_torch.models.prefill`` of a 4 × 2048-position prompt, then
        32 greedy steps of the captured decode (``models.compile_decode``:
        one CUDA graph of a step, ``pos`` and ``kv_len`` on the device, and
        for seamless the encoder output in a static buffer; a cold
        sequence that captures, then a warm one that is timed) beside 32
        eager ``decode_step``s: the same greedy tokens, prefill seconds
        (seamless: its encoder alone too), decode ms a step and tokens/s of
        both, flash launches (its attention layers' count per prefill and
        per step, replays included, one more a cross-attention layer and,
        per prefill, an encoder layer), every logit finite, peak GB; then
        prefill and each decode under torch.profiler (device busy share,
        device ms by kernel, kernels a step; the weight floor a step, the
        weights' bytes over 3.35 TB/s, beside; seamless: the device time of
        the cross-attention's keys and values that each step computes
        again, ``cross_kv_ms``); for a model with SSD layers, an encoder or
        patches, the prompt prefilled in two chunks as well (``chunks=2``:
        the SSD state and the caches carried from one chunk to the next,
        the frames encoded once, the patches in the first chunk) against
        the single-shot prefill, last-token logits within LOGIT_TOL, its
        MoE layers' capacity lifted to the chunk's length for both
        prefills (an expert's capacity is per chunk, so capacity drops
        differ between one chunk and two by design);
     c. a 2-layer model at full width (seamless: 2 encoder and 2 decoder
        layers, 128 frames; internvl2: LM_CHECK_PATCHES patches), the same
        weights on the card and on the CPU (plain attention there):
        prefill's last-token logits and the first decode step's agree
        within LOGIT_TOL; for an MoE model (2
        layers: granite's two MoE layers, deepseek's dense layer 0 and one
        MoE layer, jamba's SSD layer with an MLP and one with an MoE) each
        MoE layer's expert choices, card against CPU, are
        equal on every token whose CPU margin between the k-th and (k+1)-th
        router probability is at least ROUTE_MARGIN; at most one of the two
        sequences may be left out of the LOGIT_TOL check, and only for a
        flip below that margin at its own last token (the flips are
        counted and printed); for jamba (LM_DEPTH_SWEEP), measured and not
        held, its first 5 layers the same way, the card dispatching as the
        CPU did: the last-token logits' distance after each layer;
     each model's 6a/6b/6c seconds are printed (``lm_seconds``);
  7. the batched driver, ``multigila_layout_many``, at the size a layout
     service's tenants submit: suite A, SUITE_A graphs
     ``generators.delaunay(5_000, seed=100+i)`` (L0 neighbor, coarser
     levels exact; L0 lanes at n_pad 8192), default ``LayoutConfig()``,
     cold (cache cleared), warm, warm again with the seeds moved (profiled:
     device busy and idle share) and through as many warm sequential
     ``multigila_layout`` calls; then the same on its first SUITE_A_STRESS
     graphs with ``engines=["stress"]`` for every graph and weights
     U(0.5, 2) from ``default_rng(i)``; suite B, SUITE_B graphs
     ``generators.delaunay(50_000, seed=200+i)`` (L0 grid, L1 neighbor),
     the same runs, a third warm run profiled as it moves no seed. Each
     prints wall, graphs/s, phase seconds, the cache's
     entries/hits/misses, resident and peak GB, waves, groups a wave and
     launches by kernel and by shape, each shape's equal to the sum over
     its groups of their largest iteration budget. Every lane's hierarchy,
     levels and modes equal its sequential run's bit for bit, its positions
     finite, its NELD within NELD_DELTA of the sequential one's (and on
     suite A, CRE counted on the card by ``cre_card``: each lane within
     max(CRE_DELTA, CRE_SPREAD_MULT × the median gap between the warm run
     and one with every seed moved by SPREAD_SEED; the cold-vs-warm gaps
     are printed), the lanes' mean within max(CRE_MEAN_DELTA,
     CRE_MEAN_SES standard errors));
     every exact and neighbor group with incidence tables repeats its bits
     when run again; one
     level's k = 10 batched iterations (suite A L0 neighbor, suite B L0
     grid) held to the single-graph cached step, within twice its spread
     (between its runs, or from the CPU's run of the step).
     Sequential layouts sum edges with ``index_add_`` atomics on the card,
     so batched and sequential cannot agree bit for bit there;
  8. serving on the card (``serving_phase``): the 1M export and its tile
     pyramid, viewport queries, the store, the continuous engine and the
     HTTP front door;
  9. the sharded driver, ``LayoutConfig(driver="multigila_dist",
     mesh_shape=(1, 1))``, over a one-rank NCCL group made through a
     FileStore and destroyed at the end of the phase (``dist_phase``):
     b. delaunay(1M), the graph of phase 4, cold then warm: every position
        finite, levels and modes equal phase 4's, launches of grid_far and
        near_field each the grid levels' iterations and of no other
        kernel (exact and neighbor levels run plain torch, as the JAX
        package's sharded step runs plain jnp there), NELD within
        NELD_DELTA of phase 4's warm run, no cache miss warm; wall, phase
        seconds, the cache's entries/hits/misses and peak GB printed;
     a. the near_field kernel on the arguments of its first call at each
        grid level of the warm run (the all-gather variant's index form)
        and on the halo variant's direct form built from the same
        positions: against its plain version and itself, timed as phase 3
        times a row, the per-cell grid_near kernel's ms on the same level
        beside it, and the op's device ms split into its grouping, pack
        and near kernels (``split_ms``, from a profile of eager calls),
        with the grouping's plain version (``ops.group_rows``: torch.sort
        and searchsorted) timed beside it;
        then the refine loop of grid level 1, staged on its warm entry,
        runs under ``torch.cuda.set_sync_debug_mode("error")``;
     c. phase 5's graph (all three modes), gila then stress with phase
        5b's weights, on the card against the CPU's run over the same
        one-rank group (gloo): hierarchy equal bit for bit, ``ewt``
        included, NELD and CRE within phase 5's deltas;
     d. the layout CLI with ``--driver multigila_dist --mesh 1x1`` in
        process on the card;
     e. the dry run's layout rows (``launch/dryrun.py``'s ``layout``
        suite) run for real over the same mesh (``dryrun_layout_card``):
        each of its 10 rows at its ``BIG_GRAPH_DRYRUN`` size (the four
        fine-level modes of ``hugetric_like``, 8,388,608 vertices, and of
        ``delaunay_like``, 4,194,304, each with 33,554,432 edge slots;
        ``coarse_level``'s neighbor row at 65,536 and its exact row cut to
        DRYRUN_EXACT_CARD_N), one step through ``layout_train_step`` or
        ``layout_train_step_halo`` on shape-true random inputs made on
        the card from a seed, cold then DRYRUN_WARM warm: ms a step, peak
        GB, launches (one grid_far and one near_field call a step in the
        grid rows, none elsewhere), every position finite, the halo and
        grid_halo rows within REPLAY_FACTOR × the spread of the neighbor
        and grid rows; the dry run's own argument bytes and counted peak
        of each row at mesh (1, 1), counted on meta in a CPU worker,
        beside (``{"dryrun_layout_card": {...}}``); grid_far and both
        forms of near_field timed on the arguments of ``hugetric_like``'s
        grid and grid_halo rows, rows of the kernels line whose launches
        are those rows' counts;
  10. LM training (after the CPU workers are joined; 10a's CPU sides run
     in the main process, 10b's came from the workers):
     a. every registered model's smoke config (LM_ARCHS), one training
        step on the card and on the CPU from the same bf16 weights (drawn
        on the CPU, copied) and the training driver's batch 0
        (``batch_at`` and ``extra_inputs``, B 2 × S 64): loss and grad
        norm within
        LOGIT_TOL, every gradient leaf within GRAD_TOL of the leaf's
        largest |value|, the card's AdamW on the CPU's gradients from the
        same state giving the CPU's masters, mu and nu within 1e-6 of each
        leaf's largest |value|, the card's own masters within 0.02 × the
        step's lr where both sides' gradients agree in sign and lie past
        AdamW's eps (within 2 × lr elsewhere), MoE choices as 6c holds them at SMOKE_ROUTE_MARGIN
        (the card follows the CPU's, ``RouteRecorder``); on the card,
        remat "full" and "dots"
        give "none"'s loss bit for bit and its gradients within GRAD_TOL
        (``train_step_card_vs_cpu``);
     b. internlm2-1.8b, mamba2-1.3b and seamless-m4t-medium (TRAIN_WIDE)
        at full width, 2 layers, B 2 × S 128 (seamless: 64 frames + 64
        tokens): the same checks, the CPU's weights, loss and gradients
        computed in the workers (``train_cpu_side``, handed over in npz
        files), its AdamW step here, the CPU's seconds printed;
     c. internlm2-1.8b at full width and depth through
        ``repro_torch.launch.train.main`` (TRAIN_FULL: --batch 4 --seq
        1024, 30 steps at --remat none, then 7 at full and 7 at dots):
        step ms (median from the third step, the last left out), tokens/s,
        peak GB, 6·N·tokens over the step time; every loss finite and the
        last 5 losses' mean below step 0's; each mode's last step
        profiled, its attention kernels named (SDPA's backend);
     d. a resume on the card at internlm2-1.8b's smoke config: 40 steps
        straight against 40 checkpointed every 20, step_40 deleted and
        resumed with --resume auto from step 20: final losses within
        LOGIT_TOL;
     e. the sharded trainer and ``parallel/`` over a one-rank NCCL mesh
        (``train_parallel_phase``, after 10c's model is freed; prints
        ``{"parallel": {...}}``): (a) internlm2-1.8b at full width and
        depth, B 4 × S 1024, SHARDED_STEPS steps of the training step under
        ``make_rules(make_mesh((1, 1)), cfg)``: each loss within LOGIT_TOL
        of 10c's at the same step (whether bit-equal printed), step ms
        beside 10c's, peak GB; (b) granite-moe-3b-a800m's MoE layer at full
        width (MOE_FORMS): ``apply_moe_shardmap`` equal to ``apply_moe`` bit
        for bit, ``apply_moe_a2a`` within LOGIT_TOL at a capacity where
        neither drops, ms of each; (c) ring attention at internlm2's width
        (RING_ATTN, causal, bf16) against SDPA within LOGIT_TOL, the ring
        collective matmul (RING_MATMUL) equal to ``torch.matmul``, the
        pipeline (PIPE) on a (1, 1, 1) pod/data/model mesh within LOGIT_TOL
        of ``forward``, ms beside each plain version's; (d) the CPU ranks'
        run (ELASTIC_ARGS, ``--model-parallel 2``: mesh 4 × 2, checkpoints
        at steps 10 and 12) joined, its step_10 resumed on the card on one
        rank through the driver: the parameters after the restore equal
        the checkpoint's bit for bit, steps 10 and 11 within LOGIT_TOL of
        the CPU run's;
  11. sharded LM serving over a one-rank NCCL mesh
     (``serve_parallel_phase``; prints ``{"sharded_serving": {...}}``):
     a. at the decode shape of every registered config with attention,
        the flash kernel's split route with its lse against the plain
        version (ATTN_TOL's decode bound, LSE_TOL), and the cache cut into
        2, 4 and 8 sequence blocks (the last ones past kv_len: out 0, lse
        −inf), each block through the kernel, merged by
        ``comm.merge_partials_local``, against the uncut kernel's output
        (``split_merge_checks``);
     b. internlm2-1.8b at full width and depth under ``make_rules`` (the
        ``kv_heads`` form) and with ``kv_heads=None`` (``kv_seq``): 6b's
        prompt, prefill and LM_NEW greedy eager ``decode_step``s, the flash
        launches counted from 0: 6b's eager tokens, every step's logits
        within LOGIT_TOL of 6b's, two more steps under sync-debug "error";
        ms a step and peak GB beside 6b's (``sharded_serving``); the
        kernels line's ``flash_attention_decode_lse`` row at 11b's
        ``kv_seq`` call (``lse_row``);
  12. ``{"cpu_refs": {...}}`` (each CPU reference's seconds in its
     worker), ``{"phase_seconds": {...}}`` (the wall seconds of every phase
     and sub-phase: a phase whose check waits for a CPU reference counts
     its card side and its check; ``cpu_refs_wait`` is the wait for the
     workers before phase 7; ``7`` leaves out ``3d``), the
     ``{"kernels": [...]}`` summary, the card line, and
     ``{"ok": true, "device": {...}}`` as the last line.

It imports neither JAX nor the JAX package.

``--compare SRC`` also times another tree's force kernels (``SRC`` is a
``src/`` directory that holds a ``repro_torch``, such as an earlier commit
unpacked by ``git archive`` into the gitignored ``scratch_chip/``) on all of
phase 3's inputs, right after phase 3b: that tree's kernels, then this
checkout's again, in one process on one card. It may be given more than
once: each tree in turn, then this checkout. Those rows say ``"tree"`` and
stay out of the ``{"kernels": [...]}`` line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
FLOPS_PER_PAIR = 11              # 2 sub, 2 mul + 2 add (d2), 1 div, 2 fma
                                 # (a multiply-add counts 2)
# reciprocals a second on the MUFU pipe: 16 lanes a clock per SM, 132 SMs,
# 1.98 GHz boost (H100 SXM): the force kernels' ceiling, one a pair
MUFU_PER_S = 16 * 132 * 1.98e9
RTOL = 1e-4                      # kernel vs plain: sums in another order
ATOL_FRAC = 1e-5                 # atol = ATOL_FRAC * max|plain|
NELD_DELTA, CRE_DELTA = 0.05, 0.15
# a batched lane's final CRE against its other run: each lane within
# max(CRE_DELTA, CRE_SPREAD_MULT × CRE's spread over the seed), the median
# over the lanes of the gap between the batched run and one of the same
# graphs with every seed moved by SPREAD_SEED (phase 4e's rule: twice a
# median spread); the lanes' mean gap within max(CRE_MEAN_DELTA,
# CRE_MEAN_SES standard errors of that mean, from the lanes' own gaps).
# The final CRE is chaotic: any change of rounding order (the sequential
# driver's ``index_add_`` atomics, the placer's) may tip a lane into another
# basin. On an NVIDIA H100 80GB HBM3 (700 W), suite A's lanes moved from
# their sequential runs by up to 0.72 (gila) and 0.57 (stress), while two
# batched runs of them, cold and warm, differed by up to 0.35 and 0.57 in
# one call and by 0.18 and 0.088 in another: how many lanes the placer's
# atomics tip over varies from run to run, so that gap is no yardstick (a
# stress lane 0.37 from its sequential run failed a bound of 3 × a
# cold-vs-warm gap under 0.05). A moved seed tips every lane, so the
# median of 64 gaps is steady. The mean over 64 lanes moved by
# 0.033 (standard error 0.015), over phase 5d's 8 lanes, card against CPU,
# by 0.016 and 0.017 (0.018 and 0.017), sequential and batched
CRE_SPREAD_MULT, CRE_MEAN_DELTA, CRE_MEAN_SES = 2.0, 0.05, 4.0
SPREAD_SEED = 1
# flat driver, card vs CPU after 5 iterations from one random init: max
# |Δpos|. On the CPU, the port's distance from JAX there is 0.0039 and JAX's
# distance from its own rerun from an init moved by one float32 ulp 0.014
# (tests/test_torch_drivers.py); later the run is chaotic (final CRE moves
# by up to 9 on delaunay(5000) when the init moves by one ulp)
FLAT_EARLY_TOL = 0.05
WEIGHT_LO, WEIGHT_HI = 0.5, 2.0       # per-edge weights, uniform from seed 0
# eager runs (and as many replays) whose pairwise distances give the spread
# a replay is held to. A distance is the mean over the valid vertices of
# max(|Δx|, |Δy|): the largest |Δpos| of two runs after k chaotic
# iterations is set by a few vertices whose grid cell flips, so it takes a
# few discrete values (0.037, 0.05, 0.10, 0.135 at level 0 of delaunay(1M)
# on an H100) and varies ~7× from pair to pair at level 2. Medians are
# compared: of the 100 replay-to-eager distances and of the 45 distances
# between two replays, each against the 45 between two eager runs
EAGER_RUNS = 10
# how far those medians may lie from the eager runs' (phases 4e, 4b).
# Replays order their ``index_add_`` sums from another distribution than
# eager calls: at level 2 of delaunay(1M) (neighbor, k = 10; NVIDIA H100
# 80GB HBM3, 700 W) the median distance between two replays ran 1.52 and
# 2.20× that between two eager runs in two calls of one tree, the
# replay-to-eager median 1.40 and 2.09×, from 6 runs of each. A
# captured step that reads a stale buffer or races moves a vertex by a
# force step, orders of magnitude past either
REPLAY_FACTOR = 4.0
# the floor of that eager spread, in float32 terms: the distance of two
# runs in which FLOOR_ULPS vertices moved by one ulp of the level's largest
# |coordinate|. At an exact level the eager runs mostly repeat their bits
# (a spread of 0) while a replay sums its edges in another order: at level
# 4 of delaunay(1M) (632 vertices, k = 10) a replay moved by at most
# 9.5367431640625e-07 from six eager runs that agreed, a distance of
# 7.2148029772733935e-09, about 2.4 such ulps over the level (NVIDIA H100
# 80GB HBM3, 700 W)
FLOOR_ULPS = 8
N_MAIN = 1_000_000
# the batched driver's suites: (graphs, vertices, first seed) of
# generators.delaunay, as a layout service's tenants submit them. Suite A
# had 64 graphs until phase 8 joined the script and 32 until phase 11 did,
# for both its passes. At 32, phase 7 took 356.7-475.2 s of whole runs of
# 951.8-1216.1 s (NVIDIA H100 80GB HBM3, 700 W), past the 1200 s limit on
# a slow host; now the gila pass takes SUITE_A's graphs and the stress
# pass their first SUITE_A_STRESS
SUITE_A = (16, 5_000, 100)
SUITE_A_STRESS = 8
SUITE_B = (8, 50_000, 200)
LANES_5D = 8                          # suite A's first graphs, card vs CPU
# the card-free CPU references of phases 4d, 5, 5b, 5d and 9c run in
# CPU_WORKERS spawned processes of CPU_THREADS torch threads each
# (``CpuRefs``), started after phase 4c and joined before phase 7: they
# overlap the card's phases 4d-6 and none of the walls that phases 4, 7, 8
# and 9 measure. Each check keeps its inputs, comparison and tolerance; in
# PR 23's runs (NVIDIA H100 80GB HBM3, 700 W) these CPU sides took the
# script 40 (4d), 89 (5b), 95-148 (5d) and 16 (9c) s in the main process
CPU_WORKERS, CPU_THREADS = 3, 2
# the LM serving path's models, in turn: internlm2-1.8b (GQA group 2),
# starcoder2-7b (36 heads over 4 KV heads: group 9), starcoder2-15b (48
# over 4: group 12), gemma-2b (8 over 1 at hd 256: group 8),
# granite-moe-3b-a800m (24 over 8 at hd 64: group 3), deepseek-moe-16b
# (16 over 16: group 1), mamba2-1.3b (48 SSD layers, no attention) and
# jamba-v0.1-52b (SSD layers with attention at position 4 of each period
# of 8, 32 over 8: group 4), seamless-m4t-medium (12 encoder and 12
# decoder layers with cross-attention, 16 over 16 at hd 64: non-causal
# flash on both routes) and internvl2-76b (64 over 8: group 8, a prefix of
# patch embeddings), each at its published width and depth
LM_ARCH = "internlm2-1.8b"
LM_ARCHS = (LM_ARCH, "starcoder2-7b", "starcoder2-15b", "gemma-2b",
            "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-1.3b",
            "jamba-v0.1-52b", "seamless-m4t-medium", "internvl2-76b")
# phase 6b's depth cuts, each at full width: deepseek-moe-16b runs its
# dense layer 0 and 7 MoE layers (of 27): a whole run of the script at full
# depth took 1199 s of its 1200 on a slow host of an NVIDIA H100 80GB HBM3
# (700 W), most of it in the layout phases' host work (5d's CPU side 148 s,
# 8c 68 s). jamba-v0.1-52b runs one period of its pattern (8 of 32 layers:
# 7 SSD layers, 1 attention layer, 4 MoE layers of 16 experts; ~26.5 GB):
# its 51.5 B parameters (~103 GB in bf16) do not fit one 80 GB card.
# internvl2-76b runs its first 16 of 80 layers (~15.8 B parameters with the
# embedding and the head, ~31.6 GB in bf16; 6b prints the exact count):
# its ~70.5 B parameters (~141 GB) do not fit one card either
LM_DEPTH = {"deepseek-moe-16b": 8, "jamba-v0.1-52b": 8, "internvl2-76b": 16}
# phase 6c holds 2 layers of each model at full width, card against CPU.
# For jamba it also measures, and does not hold, its first 5 layers (four
# SSD layers, two with MoE, then its attention layer; ~14.3 GB a side):
# the logits' distance after each layer, the card following the CPU's
# routes (``lm_depth_distance``). The bf16 distance grows with depth and
# reaches LOGIT_TOL's bound near 4 layers of jamba's width
LM_DEPTH_SWEEP = {"jamba-v0.1-52b": 5}
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_CACHE = LM_PROMPT + LM_NEW + 8     # decode reads a strided cache slice
# an encoder-decoder model's LM_PROMPT positions split as the JAX package's
# input specs split a shape cell's seq_len (``models/model.py:_dec_len``):
# LM_FRAMES audio-frame embeddings [4, 1024, d_model] for the encoder
# (normal × 0.05 in bf16 from a seed, as its tests draw frames) and a
# 1024-token decoder prompt, so its cache is 1024 + LM_NEW + 8 rows
LM_FRAMES = LM_PROMPT // 2
# a VLM's prompt carries ``models.model.VLM_PATCHES`` patch embeddings
# [4, 256, d_model] (normal × 0.05 in bf16 from a seed) in its first
# positions; phase 6c's 2 × 130-token prompt carries this many
LM_CHECK_PATCHES = 64
# decode rotates over as many caches as give this many bytes of k and v
# together, twice the 50 MB L2: 3 for internlm2 (34 MB a cache), 6 for
# starcoder2 and granite (17 MB: KV 4 at hd 128, KV 8 at hd 64), 12 for
# gemma (8.6 MB: KV 1 at hd 256), 2 for deepseek (68 MB: KV 16)
DECODE_KV_BYTES = 100e6
# decode's device kv_len at phase 6a's checks, after the decoder prompt:
# the path's first and last (2049 reads one key of the last split chunk)
# and one between; it is timed at the last
DECODE_KV_STEPS = (1, 17, LM_NEW)
# attention kernel vs plain, bf16: both round the output to bf16 (one ulp is
# 2^-8 relative) and round p to bf16 at different points. The atol follows
# each shape's output size: a prefill row near the diagonal averages few
# values of v (|out| up to ~4), a decode row averages 2080 of them, so its
# outputs are ~0.04 and an atol of 1e-2 there would hide a wrong key. A
# non-causal row (the encoder-decoder's) averages every one of ~1000 frames.
ATTN_TOL = dict(flash_attention_prefill=dict(rtol=1e-2, atol=1e-2),
                flash_attention_decode=dict(rtol=1e-2, atol=2e-3),
                flash_attention_noncausal_prefill=dict(rtol=1e-2, atol=2e-3),
                flash_attention_noncausal_decode=dict(rtol=1e-2, atol=2e-3))
# card vs CPU logits of the 2-layer full-width model, both bf16: the same
# function with sums in another order (cuBLAS vs the CPU's GEMMs), the
# kernel's p rounding, and bf16 activations between layers; a logit near 4
# has a bf16 ulp of 0.016
LOGIT_TOL = dict(rtol=0.02, atol=0.1)
# phase 6c, MoE models: the card's expert choices equal the CPU's on every
# token whose CPU router margin (k-th minus (k+1)-th probability) is at
# least this. The card and the CPU round the bf16 activations at other
# points, which moves a router input by ~2^-8 relative: a router logit of
# ~1 by ~0.004, a probability of ~1/E by ~1e-4, so a flip needs a margin
# ten times smaller than this
ROUTE_MARGIN = 1e-3
# phase 4g: iterations of each cached refine program under sync-debug
# "error" (more than a schedule buffer's 128 rows, so a chunk reload falls
# inside), then eager calls of its step
SYNC_ITERS, EAGER_STEPS = 136, 4


#: wall seconds of each phase and sub-phase, printed before the last lines
PHASE_SECONDS: dict = {}
#: phase 6b's eager decode of LM_ARCH (tokens [B, 1 + LM_NEW], the prefill's
#: and every step's logits [B, 1 + LM_NEW, V] on the CPU, ms a step, peak
#: GB), which phase 11 holds sharded serving to
LM_EAGER: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Add the wall seconds of the ``with`` body to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - t0)


def _cpu_worker_init(src: str) -> None:
    """A CPU-reference worker: the card hidden, CPU_THREADS threads."""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(CPU_THREADS)
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(CPU_THREADS)


def _cpu_ref(kind: str, *args):
    """One CPU reference, in a worker: (its result, its seconds)."""
    t0 = time.perf_counter()
    out = _CPU_REFS[kind](*args)
    return out, time.perf_counter() - t0


class CpuRefs:
    """The card-free CPU references (see the module docstring), each
    computed in one of CPU_WORKERS spawned worker processes while the
    main process drives the card. ``start`` submits the tasks {name: (kind,
    args)}, longest first; ``get(name)`` is a task's result; ``join`` waits
    for every task; ``close`` ends the workers, whatever state they are
    in, and removes ``dir``, a temporary directory for the tasks' large
    outputs."""

    def __init__(self, src: Path):
        import tempfile
        self.src, self._pool, self._res, self.seconds = str(src), None, {}, {}
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_refs_")

    def start(self, tasks: dict) -> None:
        import multiprocessing as mp
        self._pool = mp.get_context("spawn").Pool(
            CPU_WORKERS, initializer=_cpu_worker_init, initargs=(self.src,))
        self._res = {name: self._pool.apply_async(_cpu_ref, (kind, *args))
                     for name, (kind, args) in tasks.items()}

    def join(self) -> None:
        self._pool.close()
        self._pool.join()
        for name in self._res:
            self.get(name)

    def get(self, name: str):
        out, self.seconds[name] = self._res[name].get()
        return out

    def close(self) -> None:
        import shutil
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
        shutil.rmtree(self.dir, ignore_errors=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _kernel_name(sym: str) -> str:
    """``fa_split_kernel<128,128>`` out of its mangled symbol: the name is
    the length-prefixed identifier that ends in ``kernel``; integer and
    bool template arguments follow it as ``I Li128E Lb1E … E``."""
    import re
    for m in re.finditer(r"\d+", sym):
        # the length prefix may follow other digits (a hash): try each tail
        lengths = {int(m.group()[j:]) for j in range(len(m.group()))}
        name = next((sym[m.end():m.end() + n] for n in sorted(lengths)
                     if sym[m.end():m.end() + n].endswith("kernel")), "")
        if name:
            args = re.match(r"I((?:L[ib]\d+E)+)E", sym[m.end() + len(name):])
            return name + (f"<{','.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"
                           if args else "")
    return sym


def _ptxas_report(log: str) -> list:
    """(kernel, "registers, shared memory, spills") for each entry function
    in the ``nvcc -Xptxas -v`` output of one source."""
    import re
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append((_kernel_name(m.group(1)), []))
        elif out and ("registers" in line or "spill" in line):
            out[-1][1].append(line.split(":", 1)[-1].strip())
    return [(k, ", ".join(info)) for k, info in out]


def _per_call_ms(fn, reps: int, batches: int = 5) -> float:
    """Median over ``batches`` of (event time of ``reps`` calls made back to
    back) / ``reps``: the queue stays full, so a call's host work overlaps
    the previous call's device time instead of adding to it."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def _bound_ms(nbytes: float, flops: float,
              peak: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _compare(name: str, out, ref) -> float:
    import torch
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL_FRAC * scale)
    return float((out - ref).abs().max())


def _near_pairs(bucket, table, n_pad: int) -> int:
    """Pairs the near field computes: each bucketed row against the valid
    slots of its cell's 3×3 neighborhood."""
    import torch
    nc = table.shape[0] - 1
    cnt = torch.cat([(bucket[:nc] < n_pad).sum(dim=1),
                     bucket.new_zeros((1,), dtype=torch.int64)])
    return int((cnt[:nc] * cnt[table[:nc].long()].sum(dim=1)).sum())


# (source, Pallas function) of each force kernel
_FORCE_KERNELS = dict(
    nbody=("src/repro_torch/kernels/nbody/csrc/nbody.cu",
           "src/repro/kernels/nbody/kernel.py:45"),
    neighbor_force=(
        "src/repro_torch/kernels/neighbor_force/csrc/neighbor_force.cu",
        "src/repro/kernels/neighbor_force/kernel.py:32"),
    grid_near=("src/repro_torch/kernels/grid_force/csrc/grid_near.cu",
               "src/repro/kernels/grid_force/kernel.py:45"),
    grid_far=("src/repro_torch/kernels/grid_force/csrc/grid_far.cu",
              "src/repro/kernels/grid_force/kernel.py:89"),
)
# per kernel: (calls a CUDA graph, replays, eager calls a batch, plain calls)
_REPS = dict(nbody=(50, 10, 200, 5), neighbor_force=(50, 10, 200, 5),
             grid_near=(10, 10, 50, 2), grid_far=(2, 5, 10, 1))


def _force_case(name, args, consts):
    """(kernel call, plain call, bytes, pairs, one-lane call) of one force
    kernel on the tensors ``args`` with the force constants ``consts``: host
    (C, L, min_dist), staged on the card, or a tensor (C·L², md²) on the
    card as the path passes them. A tree whose wrappers take host ``C, L,
    min_dist`` (``--compare``) is handed those, and has no one-lane call
    (None). The one-lane call hands the wrapper the same inputs with a lane
    axis of 1 (the batched driver's form). Bytes count each input once and
    the output once, for the valid vertices where padding rows are skipped;
    pairs are those that this input needs."""
    import inspect

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.grid_force import ops as grid_ops
    from repro_torch.kernels.grid_force.ref import grid_far_ref, grid_near_ref
    from repro_torch.kernels.nbody.ops import nbody_repulsion
    from repro_torch.kernels.nbody.ref import nbody_repulsion_ref
    from repro_torch.kernels.neighbor_force.ops import neighbor_repulsion
    from repro_torch.kernels.neighbor_force.ref import neighbor_repulsion_ref

    if isinstance(consts, tuple):             # host (C, L, min_dist)
        host = consts
        consts = torch.tensor(_build.force_consts(*host),
                              dtype=torch.float32, device=args[0].device)
    else:                                     # a path record's
        host = None
    cl2, md2 = consts[0], consts[1]
    if "C" in inspect.signature(nbody_repulsion).parameters:
        kw = dict(zip(("C", "L", "min_dist"),
                      host or _host_consts(consts)))
        lane = None
    else:
        kw = dict(consts=consts)
        lane = dict(consts=consts[None])

    def one_lane(fn, *tensors, shared=()):
        """``fn`` on ``tensors`` as one lane (``shared`` passed as they
        are, after them)."""
        if lane is None:
            return None
        t = [x[None] for x in tensors]
        return lambda: fn(*t, *shared, **lane)
    if name == "nbody":
        pos, mass, vmask = args
        nv = int(vmask.sum())
        f = lambda: nbody_repulsion(pos, mass, vmask, **kw)
        f1 = one_lane(nbody_repulsion, pos, mass, vmask)
        p = lambda: nbody_repulsion_ref(pos, mass, vmask, cl2, md2)
        nbytes, pairs = 21 * pos.shape[0], nv * nv
    elif name == "neighbor_force":
        pos, mass, nbr_idx, nbr_mask, vmask = args
        K = int(nbr_idx.shape[1])
        f = lambda: neighbor_repulsion(pos, mass, nbr_idx, nbr_mask, vmask,
                                       **kw)
        f1 = one_lane(neighbor_repulsion, pos, mass, nbr_idx, nbr_mask,
                      vmask)
        p = lambda: neighbor_repulsion_ref(pos, mass, nbr_idx, nbr_mask,
                                           vmask, cl2, md2)
        nv = int(vmask.sum())        # rows outside vmask skip their list
        nbytes = 21 * pos.shape[0] + 5 * nv * K
        pairs = int((nbr_mask & vmask[:, None]).sum())
    elif name == "grid_near":
        pos, mass, vmask, bucket, table = args
        nc, cap = bucket.shape[0] - 1, bucket.shape[1]
        f = lambda: grid_ops.grid_near(pos, mass, vmask, bucket, table,
                                       **kw)
        f1 = (None if lane is None else
              lambda: grid_ops.grid_near(pos[None], mass[None], vmask[None],
                                         bucket[None], table, **lane))
        p = lambda: grid_near_ref(pos, mass, vmask, bucket, table, cl2, md2)
        nbytes = 21 * pos.shape[0] + 4 * (nc + 1) * cap + 36 * (nc + 1)
        pairs = _near_pairs(bucket, table, pos.shape[0])
    elif name == "grid_far":
        pos, cell_xyw, vmask = args
        nc = cell_xyw.shape[0]
        f = lambda: grid_ops.grid_far(pos, cell_xyw, **kw)
        f1 = one_lane(grid_ops.grid_far, pos, cell_xyw)
        p = lambda: grid_far_ref(pos, cell_xyw, cl2, md2)
        nv = int(vmask.sum())        # padding rows' output is discarded
        nbytes, pairs = 16 * nv + 12 * nc, nv * nc
    else:
        raise ValueError(name)
    return f, p, nbytes, pairs, f1


def _shape_label(shape: dict) -> str:
    """``level 4: 632 of 1024`` (and the grid's ``G``/``cap`` or the
    far field's ``cells``) for a row's ``shape``."""
    more = "".join(f", {k} {v}" for k, v in shape.items()
                   if k not in ("level", "n", "n_pad"))
    return f"level {shape['level']}: {shape['n']} of {shape['n_pad']}{more}"


def time_force_case(name, args, consts, shape, inputs, launches=0,
                    time_plain=True, tree=None) -> dict:
    """One force kernel on one input: checked against its plain version
    (and against itself: two calls must agree bit for bit), then timed as
    device time per call (``ms``, CUDA-graph replay) and eagerly
    (``eager_ms``: calls made back to back, the wrapper's host work
    included), beside the plain version's time (unless ``time_plain`` is
    false) and the bound. Returns the row for the ``{"kernels": [...]}``
    line; the printed line adds the pairs, for the grid kernels the MUFU
    ceiling, the ``tree`` timed where it is not this checkout, and
    ``b1_ms``: the same inputs handed over as one lane (``[None]``), timed
    as ``ms`` is, whose bits must equal the call's."""
    import torch
    f, p, nbytes, pairs, f1 = _force_case(name, args, consts)
    if tree is not None:                # another tree's wrappers: no lanes
        f1 = None
    out, again = f(), f()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls on one input differ")
    if f1 is not None and not torch.equal(f1()[0], out):
        raise AssertionError(f"{name}: the one-lane call differs")
    err = _compare(name, out, p())
    calls, replays, eager, plain_reps = _REPS[name]
    ms = _graph_ms(f, calls, replays)
    b1_ms = None if f1 is None else _graph_ms(f1, calls, replays)
    eager_ms = _per_call_ms(f, eager)
    plain_ms = _per_call_ms(p, plain_reps,
                            batches=1 if name == "grid_far" else 3) \
        if time_plain else None
    bound, by = _bound_ms(nbytes, FLOPS_PER_PAIR * pairs)
    source, replaces = _FORCE_KERNELS[name]
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by, library_ms=None, inputs=inputs,
               shape=_shape_label(shape), eager_ms=eager_ms)
    more = dict(pairs=pairs, b1_ms=b1_ms)
    if name != "nbody":
        more["mufu_ms"] = pairs / MUFU_PER_S * 1e3
    if tree is not None:
        more["tree"] = tree
    print(json.dumps(dict(row, **more, tol=dict(
        rtol=RTOL, atol_frac_of_max=ATOL_FRAC))), flush=True)
    return row


def random_input_cases(graphs, scheds, device) -> list:
    """Phase 3a's inputs, (name, args, consts, shape) each: the largest
    exact, neighbor and grid levels of the main path's hierarchy, with
    positions drawn from a seed."""
    import torch
    from repro_torch.core import gila
    from repro_torch.core.engine import get_engine
    from repro_torch.kernels.grid_force import ops as grid_ops

    consts = (1.0, 1.0, 1e-3)

    def level(mode):
        i = max((i for i, s in enumerate(scheds) if s.mode == mode),
                key=lambda i: graphs[i].n)
        g = graphs[i]
        pos = gila.random_init(g, max(g.n, 4) ** 0.5, seed=1000 + i)
        return i, g, pos

    cases = []
    i, g, pos = level("exact")
    cases.append(("nbody", (pos, g.mass, g.vmask), consts,
                  dict(level=i, n=g.n, n_pad=g.n_pad)))
    i, g, pos = level("neighbor")
    nbr_idx, nbr_mask = get_engine("gila").init_state(g, scheds[i], seed=i)
    cases.append(("neighbor_force", (pos, g.mass, nbr_idx, nbr_mask, g.vmask),
                  consts, dict(level=i, n=g.n, n_pad=g.n_pad,
                               K=int(nbr_idx.shape[1]))))
    i, g, pos = level("grid")
    G, cap = scheds[i].grid_dim, scheds[i].cell_cap
    nc = G * G
    cid, bucket, _ = grid_ops.bin_vertices(pos, g.vmask, G, cap)
    table = grid_ops.neighbor_table(G, pos.device)
    cases.append(("grid_near", (pos, g.mass, g.vmask, bucket, table), consts,
                  dict(level=i, n=g.n, n_pad=g.n_pad, G=G, cap=cap)))
    w = torch.where(g.vmask, g.mass, 0.0)
    M, _, mu = grid_ops._cell_aggregates(pos, w, cid.long(), nc + 1)
    cell_xyw = torch.cat([mu[:nc], M[:nc, None]], dim=1)
    cases.append(("grid_far", (pos, cell_xyw, g.vmask), consts,
                  dict(level=i, n=g.n, n_pad=g.n_pad, cells=nc)))
    return cases


class PathInputs:
    """For the length of one run, wraps the force entry points that
    ``core/gila.py`` (nbody, neighbor_force) and
    ``kernels/grid_force/ops.py`` (grid_near, grid_far) call: keeps the
    arguments of the first call at each level and counts the calls at each.
    A level is its graph's vmask storage, held here so its address stays
    its own; grid_far takes no vmask and is filed under the level of the
    grid_near call that ``grid_repulsion`` makes just before it.
    ``grid_repulsion`` hands both grid kernels its level as one lane
    (``[1, ...]``), which is taken off here. The constants are the call's
    last argument (C·L², md²), a view of the level's schedule row, copied. Record during a run whose refine is the eager loop
    (``EagerRefine``): a replayed step makes no Python call. The package
    itself has no hook: the names are put back on exit."""

    def __init__(self):
        self.cases = {}     # (name, vmask address) → (args, consts, vmask)
        self.calls = {}     # (name, vmask address) → calls
        self._near = None   # the last grid_near call's vmask

    def _wrap(self, module, attr, name, record):
        real = getattr(module, attr)

        def wrapper(*args):
            vmask, keep = record(*args)
            key = (name, vmask.data_ptr())
            if key not in self.cases:
                self.cases[key] = (keep(), args[-1].reshape(2).clone(),
                                   vmask)
            self.calls[key] = self.calls.get(key, 0) + 1
            return real(*args)
        self._saved.append((module, attr, real))
        setattr(module, attr, wrapper)

    def _grid_far(self, pos, cells, *c):
        if pos.dim() == 3:                       # one lane
            pos, cells = pos[0], cells[0]
        if self._near is None or self._near.shape[0] != pos.shape[0]:
            raise AssertionError("grid_far without its level's grid_near")
        vmask = self._near
        return vmask, lambda: (pos.clone(), cells.clone(), vmask)

    def _grid_near(self, pos, mass, vmask, bucket, table, *c):
        if pos.dim() == 3:                       # one lane
            pos, mass, vmask, bucket = pos[0], mass[0], vmask[0], bucket[0]
        self._near = vmask
        return vmask, lambda: (pos.clone(), mass, vmask, bucket, table)

    def __enter__(self):
        from repro_torch.core import gila
        from repro_torch.kernels.grid_force import ops as grid_ops
        self._saved = []
        self._wrap(gila, "nbody_repulsion", "nbody",
                   lambda pos, mass, vmask, *c:
                   (vmask, lambda: (pos.clone(), mass, vmask)))
        self._wrap(gila, "neighbor_repulsion", "neighbor_force",
                   lambda pos, mass, nbr_idx, nbr_mask, vmask, *c:
                   (vmask, lambda: (pos.clone(), mass, nbr_idx, nbr_mask,
                                    vmask)))
        self._wrap(grid_ops, "grid_near", "grid_near", self._grid_near)
        self._wrap(grid_ops, "grid_far", "grid_far", self._grid_far)
        return self

    def __exit__(self, *exc):
        for module, attr, real in reversed(self._saved):
            setattr(module, attr, real)
        return False

    def by_level(self, level_sizes) -> list:
        """(name, args, consts, shape, launches) of every recorded level;
        the level is the one index in ``level_sizes`` whose vertex count is
        the vmask's, and each kernel has one record a level."""
        out = []
        for key, (args, consts, vmask) in self.cases.items():
            name = key[0]
            nv = int(vmask.sum())
            level = [i for i, (n, _) in enumerate(level_sizes) if n == nv]
            if len(level) != 1:
                raise AssertionError(f"{name}: {nv} valid vertices match "
                                     f"levels {level}")
            shape = dict(level=level[0], n=nv, n_pad=int(args[0].shape[0]))
            if name == "neighbor_force":
                shape.update(K=int(args[2].shape[1]))
            elif name == "grid_near":
                nc, cap = args[3].shape[0] - 1, int(args[3].shape[1])
                shape.update(G=int(round(nc ** 0.5)), cap=cap)
            elif name == "grid_far":
                shape.update(cells=int(args[1].shape[0]))
            out.append((name, args, consts, shape, self.calls[key]))
        seen = [(c[0], c[3]["level"]) for c in out]
        if len(set(seen)) != len(seen):
            raise AssertionError(f"two records of one kernel and level: {seen}")
        return sorted(out, key=lambda c: (c[0], c[3]["level"]))


def _device_events(fn) -> tuple:
    """(wall s, [(name, start µs, end µs)] of every device activity) of one
    run of ``fn`` under torch.profiler, read from its raw results."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]


def _ms_by_name(events) -> dict:
    """{name: (device ms, count)} of ``_device_events``' events."""
    by_name = {}
    for name, s, t in events:
        ms, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (t - s) / 1e3, cnt + 1)
    return by_name


def profile_run(fn) -> dict:
    """One more run of ``fn`` under torch.profiler — device time by kernel
    and the device's busy share of the wall clock. Only device activity is
    recorded, and read from the profiler's raw results: host ops would
    inflate the idle share, and building the profiler's Python event tree
    for the batched phase's runs takes longer than the runs. The profiler
    still slows the host, so the wall here is longer than the unprofiled
    run's."""
    return _profile_summary(*_device_events(fn))


def _profile_summary(wall: float, events: list) -> dict:
    """``profile_run``'s summary of ``_device_events``' output."""
    spans, by_name = [(s, t) for _, s, t in events], _ms_by_name(events)
    if not spans:
        raise AssertionError("profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):                 # union of device intervals
        if t > end:
            busy_us += t - max(s, end)
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(wall_s=wall, device_busy_s=busy_us / 1e6,
                idle_share=1.0 - busy_us / 1e6 / wall, kernels=len(events),
                top=[[name[:90], ms, cnt] for name, (ms, cnt) in top])


def _graph_ms(fn, calls: int, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events. Unlike ``_per_call_ms``
    this leaves out the wrapper's host work, which at decode is longer than
    the kernel itself."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (replays * calls)


def _attn_row_name(kind: str, arch: str) -> str:
    """``flash_attention_prefill`` / ``_decode`` for internlm2-1.8b (the
    rows' names since PR 12), the model's name appended for the others."""
    name = f"flash_attention_{kind}"
    return name if arch == LM_ARCH else f"{name}_{arch}"


def _lm_shapes(cfg) -> tuple:
    """(decoder prompt length, cache rows, encoder frames) of phase 6's
    prompt for ``cfg``: LM_PROMPT tokens and an LM_CACHE-row cache; an
    encoder-decoder model's LM_PROMPT positions split into LM_FRAMES
    frames and the rest as its decoder prompt, its cache that prompt +
    LM_NEW + 8 rows."""
    frames = LM_FRAMES if cfg.enc_layers else 0
    prompt = LM_PROMPT - frames
    return prompt, prompt + LM_CACHE - LM_PROMPT, frames


def _lm_batch(cfg, b: int, s: int, frames: int, patches: int, seed: int,
              device) -> dict:
    """Phase 6's prompt: tokens [b, s] from ``seed``; then, drawn from the
    same generator, normal × 0.05 in bf16, an encoder-decoder model's
    ``frames`` [b, frames, d_model] and a VLM's ``patches`` [b, patches,
    d_model], the stub frontends' embeddings."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s))).to(device)}

    def embeds(n):
        x = rng.standard_normal((b, n, cfg.d_model), dtype=np.float32) * 0.05
        return torch.from_numpy(x).to(device, torch.bfloat16)
    if cfg.enc_layers:
        batch["frames"] = embeds(frames)
    if cfg.modality == "vlm":
        batch["patches"] = embeds(patches)
    return batch


def _enc_out(model, batch):
    """The encoder output of the batch's frames, or None for a model
    without an encoder."""
    from repro_torch.models import model as M
    return M._encode(model, batch["frames"]) if model.cfg.enc_layers else None


def attention_checks(device, arch: str = LM_ARCH) -> list:
    """Phase 6a: the flash-attention kernel against its plain version at
    ``arch``'s prefill and decode shapes, on the path's own layout and
    calls (``_lm_shapes``): prefill reads slices ``cache[:, :prompt]`` of
    the path's caches; decode reads the whole cache with ``kv_len`` on the
    device (checked at the prompt + each of DECODE_KV_STEPS against the
    plain version on ``cache[:, :kv_len]``, timed at the last) and rotates
    over caches of DECODE_KV_BYTES together (twice the 50 MB L2), as the
    layers each read their own. An encoder-decoder model adds its
    non-causal calls: the encoder's self-attention and the cross prefill
    (Sq = Sk = LM_FRAMES, contiguous k/v) and cross decode (Sq 1 against
    the LM_FRAMES frames, no kv_len, rotating over as many frames' k/v as
    give DECODE_KV_BYTES), and checks, with no row, a chunk of the decoder
    against every frame (Sq 512) and a ragged frame count (Sk 1000) on the
    wgmma route. SDPA is timed on the keys the kernel reads as a yardstick.
    ``ms`` and ``library_ms`` are device time per call (CUDA-graph replay);
    ``eager_ms`` and ``library_eager_ms`` time the same calls made back to
    back from Python, host work included. Each row carries ``count_key``,
    its (phase, (B, Sq, Sk, causal)) in the wrappers' counts by shape,
    which ``lm_main_path``'s run fills in as its launches."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = get_config(arch)
    if "attn" not in cfg.layer_pattern():
        print(json.dumps(dict(attention_checks=arch, flash_calls=0,
                              reason="no attention layer: the path makes "
                                     "no flash call")), flush=True)
        return []
    B, H, KV, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    prompt, cache, frames = _lm_shapes(cfg)
    rng = np.random.default_rng(7)

    def draw(*shape):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return x.to(device, torch.bfloat16)

    def caches(rows, n=None):
        n = n or -(-int(DECODE_KV_BYTES) // (2 * B * rows * KV * hd * 2))
        return [(draw(B, rows, KV, hd), draw(B, rows, KV, hd))
                for _ in range(n)]

    kv_len = prompt + LM_NEW
    decode_caches = caches(cache)
    cases = [
        # name, q, caches, keys read, kv_lens checked (None: the cache is
        # sliced on the host), causal, (query, key) pairs, calls per graph
        ("prefill", draw(B, prompt, H, hd), caches(cache, 1),
         prompt, None, True, prompt * (prompt + 1) // 2, 10),
        ("decode", draw(B, 1, H, hd), decode_caches, kv_len,
         tuple(prompt + n for n in DECODE_KV_STEPS), True, kv_len,
         3 * len(decode_caches)),
    ]
    if frames:
        cross = caches(frames)
        cases += [
            ("noncausal_prefill", draw(B, frames, H, hd),
             caches(frames, 1), frames, None, False, frames * frames, 10),
            ("noncausal_decode", draw(B, 1, H, hd), cross, frames, None,
             False, frames, 3 * len(cross)),
        ]
    rows = []
    for kind, q, cs, Sk, checked, causal, pairs, calls in cases:
        name, tol = _attn_row_name(kind, arch), ATTN_TOL[
            f"flash_attention_{kind}"]
        Sq = q.shape[1]
        # prefill hands the kernel cache[:, :Sk]; decode hands it the whole
        # cache with kv_len on the device, as decode_step does
        kvs = cs if checked else [(ck[:, :Sk], cv[:, :Sk]) for ck, cv in cs]
        extra = {} if checked is None else dict(
            kv_len=torch.tensor(Sk, dtype=torch.int32, device=device))
        turn = [0]

        def rotate():
            turn[0] += 1
            return kvs[turn[0] % len(kvs)]

        def f():
            k, v = rotate()
            return flash_attention(q, k, v, causal=causal, **extra)

        # SDPA on the keys the kernel reads, cache[:, :Sk]. Its is_causal
        # aligns top-left: the same mask when Sq == Sk, and none is needed
        # for one query row at the end of the keys
        def lib():
            k, v = rotate()
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k[:, :Sk].transpose(1, 2),
                v[:, :Sk].transpose(1, 2),
                is_causal=causal and Sq == Sk, enable_gqa=True)

        k, v = kvs[0]
        err = 0.0
        for n in checked or (Sk,):
            # the kernel at kv_len n against the plain version on the keys
            # it may read, cache[:, :n]
            kw = {} if checked is None else dict(
                kv_len=torch.tensor(n, dtype=torch.int32, device=device))
            out = flash_attention(q, k, v, causal=causal, **kw)
            ref = flash_attention_ref(q, k[:, :n].contiguous(),
                                      v[:, :n].contiguous(), causal=causal)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            err = max(err, float((out.float() - ref.float()).abs().max()))
        lib_out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :Sk].transpose(1, 2),
            v[:, :Sk].transpose(1, 2),
            is_causal=causal and Sq == Sk, enable_gqa=True)
        lib_err = float((lib_out.transpose(1, 2).float()
                         - ref.float()).abs().max())
        ms = _graph_ms(f, calls)
        library_ms = _graph_ms(lib, calls)
        eager_ms = _per_call_ms(f, 20 * calls)
        library_eager_ms = _per_call_ms(lib, 20 * calls)
        plain_ms = _per_call_ms(
            lambda: flash_attention_ref(q, k, v, causal=causal, **extra), 3,
            batches=3)
        handed = k.shape[1]                   # Sk as the wrapper counts it
        k, v = k[:, :Sk], v[:, :Sk]           # the keys this call reads
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * B * H * hd * pairs
        bound, by = _bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        row = dict(name=name, route="cuda",
                   source="src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention.cu",
                   replaces="src/repro/kernels/flash_attention/kernel.py:63",
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, library_ms=library_ms,
                   flash_route=flash_ops.route(Sq, H, KV))
        print(json.dumps(dict(row, lm=arch, shape=dict(
            B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, G=H // KV, hd=hd, causal=causal,
            k_batch_stride=k.stride(0), caches=len(kvs),
            capacity=cs[0][0].shape[1],
            kv_len_on_device=checked is not None,
            kv_lens_checked=list(checked or (Sk,))),
            eager_ms=eager_ms, library_eager_ms=library_eager_ms,
            library_max_abs_err=lib_err, tol=tol)), flush=True)
        phase_of = "decode" if Sq == 1 else "prefill"
        rows.append(dict(row, count_key=(phase_of, (B, Sq, handed,
                                                   int(causal)))))
    if frames:
        # no row: a chunk of the decoder (chunked prefill) against every
        # frame, and a ragged frame count, on the wgmma route
        for Sq, Sk in ((prompt // 2, frames), (300, 1000)):
            q = draw(B, Sq, H, hd)
            k, v = draw(B, Sk, KV, hd), draw(B, Sk, KV, hd)
            out = flash_attention(q, k, v, causal=False)
            ref = flash_attention_ref(q, k, v, causal=False)
            torch.cuda.synchronize()
            tol = ATTN_TOL["flash_attention_noncausal_prefill"]
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            print(json.dumps(dict(
                attention_check=f"flash_attention_noncausal_{Sq}x{Sk}",
                lm=arch, shape=dict(B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, hd=hd,
                                    causal=False),
                flash_route=flash_ops.route(Sq, H, KV),
                max_abs_err=float((out.float() - ref.float()).abs().max()),
                tol=tol)), flush=True)
    return rows


def _shape_key(shape) -> str:
    """"B Sq Sk causal" of a flash call's shape."""
    return " ".join(map(str, shape))


def _flash_shapes() -> dict:
    """The flash wrapper's launches by shape since the counts were last
    cleared: {"B Sq Sk causal": count}."""
    from repro_torch.kernels import _build
    return {_shape_key(k[1:]): c for k, c in _build.shape_launches.items()
            if k[0] == "flash_attention"}


def lm_main_path(device, arch: str = LM_ARCH) -> dict:
    """Phase 6b: ``arch`` at full width and depth (or LM_DEPTH's cut of
    it), bf16: prefill of a LM_BATCH × LM_PROMPT prompt (an
    encoder-decoder model's split into LM_FRAMES frames and its decoder
    prompt; a VLM's first VLM_PATCHES positions patch embeddings;
    ``_lm_batch``), then LM_NEW greedy steps of the captured decode
    (``compile_decode``; an encoder-decoder model's graph takes the
    prompt's ``_encode`` output in its static buffer) beside LM_NEW eager
    ``decode_step``s, with the flash launches of each counted from 0, in
    all and by shape (one a layer with attention a call, one more a
    cross-attention, and one an encoder layer a prefill; none for
    mamba2-1.3b). The captured decode runs twice: the first sequence
    captures the step (its first step runs eagerly), the second is timed;
    all three give the same tokens. An encoder-decoder model's encoder is
    timed alone as well (``encode_s``), and the cross-attention's keys and
    values that every step computes again from the encoder output
    (``cross_kv_ms``: their products' device time a step). A model with
    SSD layers, an encoder or patches also prefills in two chunks
    (``chunked_prefill_check``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    import dataclasses
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=LM_DEPTH.get(arch, cfg.n_layers))
    prompt, cache, frames = _lm_shapes(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = _lm_batch(cfg, LM_BATCH, prompt, frames, M.VLM_PATCHES, 0, device)
    # warm-up (cuBLAS handles and kernels' first launches), not counted
    warm = {k: t[:, :64] for k, t in batch.items()}
    M.decode_step(model, warm["tokens"][:, :1],
                  M.prefill(model, warm, 128)[1], 64,
                  enc_out=_enc_out(model, warm))
    torch.cuda.synchronize()

    _build.launches.clear()
    _build.shape_launches.clear()
    t0 = time.perf_counter()
    logits, state, pos = M.prefill(model, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(_build.launches)
    prefill_shapes = _flash_shapes()
    finite = torch.isfinite(logits).all()
    first = logits[:, -1].argmax(-1, keepdim=True)
    encode_s = enc_out = None
    if cfg.enc_layers:
        t0 = time.perf_counter()
        enc_out = _enc_out(model, batch)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0

    # the eager step, LM_NEW times
    tok, out, step_logits = first, [first], [logits]
    _build.launches.clear()
    t0 = time.perf_counter()
    for i in range(LM_NEW):
        logits, state = M.decode_step(model, tok, state, pos + i,
                                      enc_out=enc_out)
        finite &= torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
        step_logits.append(logits)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_launches = dict(_build.launches)
    eager_seq = torch.cat(out, dim=1).cpu()
    if logits.shape != (LM_BATCH, 1, cfg.vocab_padded):
        raise AssertionError(f"LM path: logits shape {tuple(logits.shape)}")
    del state

    # the captured step: a cold sequence (capture), then a warm one (timed)
    dec = M.compile_decode(model, LM_BATCH, cache, frames)
    seqs, secs, launches = [], [], []
    for _ in range(2):
        _, state, pos = M.prefill(model, batch, cache)
        dec.start(state, first, pos, enc_out=enc_out)
        del state
        out = [first]
        torch.cuda.synchronize()
        _build.launches.clear()
        _build.shape_launches.clear()
        t0 = time.perf_counter()
        for i in range(LM_NEW):
            finite &= torch.isfinite(dec.step()).all()
            out.append(dec.token.clone())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(dict(_build.launches))
        seqs.append(torch.cat(out, dim=1).cpu())
    decode_shapes = _flash_shapes()
    graph_s = secs[1]

    if not bool(finite):
        raise AssertionError("LM path: non-finite logits")
    for s in seqs:
        if not torch.equal(s, eager_seq):
            raise AssertionError(f"captured decode tokens {s[:, :12]}, "
                                 f"eager {eager_seq[:, :12]}")
    n_attn = sum(layer.kind == "attn" for layer in model.layers)
    n_cross = sum(layer.cross is not None for layer in model.layers)
    n_flash = n_attn + n_cross + cfg.enc_layers
    want = {"flash_attention": n_flash} if n_flash else {}
    if prefill_launches != want:
        raise AssertionError(f"prefill launches {prefill_launches}, "
                             f"expected {want}")
    want = ({"flash_attention": (n_attn + n_cross) * LM_NEW} if n_attn
            else {})
    for got in (eager_launches, *launches):
        if got != want:
            raise AssertionError(f"decode launches {got}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    chunked = (chunked_prefill_check(model, batch, cache)
               if any(layer.kind == "ssm" for layer in model.layers)
               or cfg.enc_layers or "patches" in batch else None)

    prof_prefill = profile_run(lambda: M.prefill(model, batch, cache))
    st = M.prefill(model, batch, cache)[1]
    t = eager_seq[:, :1].to(device)

    def decode8():
        for i in range(8):
            M.decode_step(model, t, st, prompt + i, enc_out=enc_out)

    def graph8():
        for _ in range(8):
            dec.step()
    prof_decode = profile_run(decode8)
    prof_graph = profile_run(graph8)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    res = dict(
        lm=arch, layers=cfg.n_layers, params=cfg.param_count(),
        dtype="bfloat16", weight_gb=weight_bytes / 1e9,
        weight_floor_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        kernels_per_step=prof_graph["kernels"] / 8,
        eager_kernels_per_step=prof_decode["kernels"] / 8,
        batch=LM_BATCH, prompt=prompt, new_tokens=LM_NEW,
        cache_len=cache, init_s=init_s, prefill_s=prefill_s,
        prefill_tok_per_s=LM_BATCH * prompt / prefill_s,
        decode_s=graph_s, decode_tok_per_s=LM_BATCH * LM_NEW / graph_s,
        decode_ms_per_step=graph_s / LM_NEW * 1e3,
        decode_capture_sequence_s=secs[0],
        eager_decode_s=eager_s,
        eager_decode_ms_per_step=eager_s / LM_NEW * 1e3,
        eager_decode_tok_per_s=LM_BATCH * LM_NEW / eager_s,
        tokens_equal_eager=True,
        launches=dict(prefill=prefill_launches.get("flash_attention", 0),
                      decode=launches[1].get("flash_attention", 0),
                      eager_decode=eager_launches.get("flash_attention", 0)),
        launches_by_shape=dict(prefill=prefill_shapes, decode=decode_shapes),
        chunked_prefill=chunked,
        logits_finite=True, sample=eager_seq[0, :12].tolist(),
        peak_mem_gb=peak / 1e9,
        profile_prefill=prof_prefill, profile_decode_8_steps=prof_decode,
        profile_graph_decode_8_steps=prof_graph)
    if "patches" in batch:
        res["patches"] = list(batch["patches"].shape)
    if cfg.enc_layers:
        # the decoder's step reads neither the encoder's weights nor its
        # norm; the cross products redo 2 · n_cross [B·S_enc, D] × [D,
        # KV·hd] matmuls a step (bf16 bytes: enc_out read by each, the
        # weights, k and v written)
        step_bytes = sum(p.numel() * p.element_size()
                         for name, p in model.named_parameters()
                         if not name.startswith(("encoder.", "enc_norm.")))

        def cross_kvs():
            for layer in model.layers:
                if layer.cross is not None:
                    L.cross_kv(layer.cross, enc_out)
        flops = (2 * n_cross * 2 * LM_BATCH * frames * cfg.d_model
                 * cfg.n_kv_heads * cfg.hd)
        cross_ms = _graph_ms(cross_kvs, 1)
        res.update(frames=frames, encode_s=encode_s,
                   step_weight_floor_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
                   cross_kv_ms=cross_ms, cross_kv_gflop=flops / 1e9,
                   cross_kv_bound_ms=_bound_ms(
                       4 * n_cross * (LM_BATCH * frames * cfg.d_model
                                      + (cfg.d_model + LM_BATCH * frames)
                                      * cfg.n_kv_heads * cfg.hd),
                       flops, BF16_FLOPS_PER_S)[0],
                   cross_kv_share=cross_ms / (graph_s / LM_NEW * 1e3))
    if arch == LM_ARCH:        # phase 11 holds sharded serving to these
        LM_EAGER.update(tokens=eager_seq,
                        logits=torch.cat(step_logits, dim=1).cpu(),
                        ms_per_step=res["eager_decode_ms_per_step"],
                        peak_gb=res["peak_mem_gb"])
    # the captured decode holds the model: break the cycle, so that the
    # weights (~32 GB for starcoder2-15b) leave the card when this returns
    model.__dict__.pop("_decode_graphs", None)
    return res


def chunked_prefill_check(model, batch, cache: int) -> dict:
    """Phase 6b, a model with SSD layers, an encoder or patches: the
    prompt prefilled in two chunks (``chunks=2``: the SSD state and the KV
    caches carried from the first chunk to the second; the frames encoded
    once for both chunks; the patches in the first chunk) against one
    prefill of it, last-token logits within LOGIT_TOL, each prefill's
    seconds printed. An MoE layer's capacity is per chunk (⌈cf · S · k /
    E⌉ slots an expert), so one chunk and two drop different tokens by
    design: both prefills run with the capacity factor at E / k, where an
    expert takes every token of its chunk and none is dropped."""
    import dataclasses

    import torch
    from repro_torch.models import model as M
    cfg = model.cfg
    if cfg.moe is not None:
        model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    torch.cuda.reset_peak_memory_stats()
    try:
        out, secs = {}, {}
        for chunks in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[chunks] = M.prefill(model, batch, cache,
                                    chunks=chunks)[0].float()
            torch.cuda.synchronize()
            secs[chunks] = time.perf_counter() - t0
    finally:
        model.cfg = cfg
    a, b = out[2], out[1]
    res = dict(chunks=2, max_abs_err=float((a - b).abs().max()),
               max_abs_logit=float(b.abs().max()),
               argmax_agree=float((a.argmax(-1) == b.argmax(-1)).float()
                                  .mean()),
               prefill_s=secs[1], chunked_prefill_s=secs[2],
               capacity_factor=(None if cfg.moe is None
                                else cfg.moe.n_experts / cfg.moe.top_k),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               tol=LOGIT_TOL)
    print(json.dumps({"chunked_prefill": res, "lm": cfg.name}), flush=True)
    if not torch.isfinite(a).all():
        raise AssertionError("chunked prefill: non-finite logits")
    torch.testing.assert_close(a, b, **LOGIT_TOL)
    return res


class RouteRecorder:
    """Within ``with``: every MoE layer call's router output (probs and
    expert indices, copied to the CPU) appended to ``calls``, by wrapping
    ``repro_torch.models.moe.route``, which ``apply_moe`` calls. Given
    ``follow`` (another recorder's ``calls``), each call records its own
    router output and dispatches to the expert indices of ``follow`` at
    its place instead, the gates gathered from its own probabilities and
    renormalised as ``route`` does (so the router keeps its gradient): the
    layer then dispatches as the other run did."""

    def __init__(self, follow=None):
        self.follow = follow

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.calls = []
        self._moe, self._route = MOE, MOE.route

        def route(p, x, m):
            probs, gates, idx = self._route(p, x, m)
            self.calls.append((probs.detach().float().cpu(), idx.cpu()))
            if self.follow is None:
                return probs, gates, idx
            idx = self.follow[len(self.calls) - 1][1].to(x.device)
            g = probs.gather(-1, idx)
            return probs, g / g.sum(-1, keepdim=True).clamp_min(1e-9), idx
        MOE.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def _route_flips(card_calls, cpu_calls, k: int, positions, first) -> list:
    """[(call, sequence, position, CPU margin)] of every token whose set of
    top-k experts differs between the card's and the CPU's run of the same
    MoE calls, the tokens of call c at positions ``positions[c]``. A flip
    changes the value of its token from that layer on, and through
    attention those of the later positions: ``first`` (one entry a
    sequence, updated in place) holds each sequence's first flipped
    position, and a flip at or past it in a later call follows from it.
    Raises where a token before it flips at a CPU margin of ROUTE_MARGIN or
    more."""
    flips = []
    for c, ((_, e_card), (p_cpu, e_cpu)) in enumerate(zip(card_calls,
                                                          cpu_calls)):
        srt = p_cpu.sort(dim=-1, descending=True).values
        margin = srt[..., k - 1] - srt[..., k]
        differ = (e_card.sort(-1).values != e_cpu.sort(-1).values).any(-1)
        new = dict(first)
        for b, s in differ.nonzero().tolist():
            pos = positions[c] + s
            if pos < first[b] and float(margin[b, s]) >= ROUTE_MARGIN:
                raise AssertionError(
                    f"card vs CPU: MoE call {c}, sequence {b}, position "
                    f"{pos}: experts {e_card[b, s].tolist()} against "
                    f"{e_cpu[b, s].tolist()} at a margin of "
                    f"{float(margin[b, s])}")
            flips.append((c, b, pos, float(margin[b, s])))
            new[b] = min(new[b], pos)
        first.update(new)
    return flips


def _card_and_cpu_lm(device, arch: str, n_layers: int) -> tuple:
    """(the card's model, the CPU's with the same bf16 weights, the 2 × 130
    prompt on the CPU: an encoder-decoder model's with 128 frames, a VLM's
    with LM_CHECK_PATCHES patches) of ``arch``'s first ``n_layers`` layers
    at full width (and as many encoder layers)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers,
                              enc_layers=min(cfg.enc_layers, n_layers))
    card = M.init_params(cfg, seed=1, device=device)
    cpu = M.LM(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    return card, cpu, _lm_batch(cfg, 2, 130, 128, LM_CHECK_PATCHES, 1, "cpu")


def lm_card_vs_cpu(device, arch: str = LM_ARCH) -> dict:
    """Phase 6c: a 2-layer ``arch`` at full width (an encoder-decoder
    model's 2 encoder and 2 decoder layers), the same bf16 weights on the
    card and on the CPU: prefill's last-token logits and the first decode
    step's logits agree within LOGIT_TOL (2 × 130 tokens, with 128 frames
    or LM_CHECK_PATCHES patches; the decode step takes each side's own
    encoder output; the CPU side's seconds printed). For an MoE model each MoE layer's expert
    choices agree (``_route_flips``); a sequence whose own last token
    flipped (at prefill's last position or at the decode step) is left out
    of the LOGIT_TOL check, at most one of the two."""
    import torch
    from repro_torch.models import model as M

    card, cpu, batch = _card_and_cpu_lm(device, arch, 2)
    on_card = {k: t.to(device) for k, t in batch.items()}
    cfg = card.cfg
    S = batch["tokens"].shape[1]
    res = {}
    with RouteRecorder() as r_card:
        lg_card, st_card, pos = M.prefill(card, on_card, 144)
    t0 = time.perf_counter()
    with RouteRecorder() as r_cpu:
        lg_cpu, st_cpu, _ = M.prefill(cpu, batch, 144)
    cpu_prefill_s = time.perf_counter() - t0
    tok = lg_cpu[:, -1].argmax(-1, keepdim=True)
    with RouteRecorder() as d_r_card:
        d_card, _ = M.decode_step(card, tok.to(device), st_card, pos,
                                  enc_out=_enc_out(card, on_card))
    with RouteRecorder() as d_r_cpu:
        d_cpu, _ = M.decode_step(cpu, tok, st_cpu, pos,
                                 enc_out=_enc_out(cpu, batch))
    left_out, flips = set(), []
    if cfg.moe is not None:
        k, first = cfg.moe.top_k, {0: S + 1, 1: S + 1}
        flips = _route_flips(r_card.calls, r_cpu.calls, k,
                             [0] * len(r_card.calls), first)
        d_flips = _route_flips(d_r_card.calls, d_r_cpu.calls, k,
                               [S] * len(d_r_card.calls), first)
        # a sequence whose own last token flipped, at prefill's last
        # position or at the decode step
        left_out = {b for _, b, s, _ in flips + d_flips if s >= S - 1}
        flips += d_flips
        res["routing"] = dict(moe_calls=len(r_card.calls)
                              + len(d_r_card.calls),
                              tokens_routed=(len(r_card.calls) * 2 * S
                                             + len(d_r_card.calls) * 2),
                              flips=len(flips), flipped=flips,
                              left_out=sorted(left_out),
                              margin=ROUTE_MARGIN)
        print(json.dumps({"card_vs_cpu_routing": res["routing"], "lm": arch}),
              flush=True)
        if len(left_out) > 1:
            raise AssertionError(f"card vs CPU: both sequences' last tokens "
                                 f"flipped: {flips}")
    keep = [b for b in range(2) if b not in left_out]
    for name, a, b in (("prefill", lg_card, lg_cpu), ("decode", d_card, d_cpu)):
        a, b = a.float().cpu(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"card vs CPU {name}: non-finite logits")
        res[name] = dict(max_abs_err=float((a - b)[keep].abs().max()),
                         max_abs_logit=float(b.abs().max()),
                         argmax_agree=float((a.argmax(-1) == b.argmax(-1))
                                            .float().mean()),
                         sequences_checked=keep)
        print(json.dumps({f"card_vs_cpu_{name}": res[name], "lm": arch}),
              flush=True)
        torch.testing.assert_close(a[keep], b[keep], **LOGIT_TOL)
    return dict(res, lm=arch, layers=cfg.n_layers,
                enc_layers=cfg.enc_layers, d_model=cfg.d_model,
                tokens=list(batch["tokens"].shape),
                **{k: list(t.shape) for k, t in batch.items()
                   if k != "tokens"},
                cpu_prefill_s=cpu_prefill_s, tol=LOGIT_TOL)


def lm_depth_distance(device, arch: str, n_layers: int) -> dict:
    """Phase 6c, measured and not held: ``arch``'s first ``n_layers``
    layers at full width on the card and on the CPU (6c's weights and
    prompt), the card's MoE layers dispatching as the CPU's did
    (``RouteRecorder(follow=…)``), so that no routing near-tie moves a
    value: after each layer, the prompt's last-token logits (the final
    norm and the head on that layer's output, as a model cut there
    computes them), card against CPU, as the largest |Δ| and the largest
    |Δ| over LOGIT_TOL's bound (atol + rtol·|CPU logit|)."""
    from repro_torch.models import model as M

    card, cpu, batch = _card_and_cpu_lm(device, arch, n_layers)
    real = M._apply_sublayer
    logits, routes = {}, None
    for side, model, on in (("cpu", cpu, batch),
                            ("card", card, {k: t.to(device)
                                            for k, t in batch.items()})):
        lasts = []

        def sublayer(layer, x, *args, **kw):
            x, aux = real(layer, x, *args, **kw)
            lasts.append(x[:, -1:])
            return x, aux
        M._apply_sublayer = sublayer
        try:
            with RouteRecorder(routes) as rec:
                M.prefill(model, on, 144)
        finally:
            M._apply_sublayer = real
        routes = rec.calls
        logits[side] = [M._head(model, x).float().cpu() for x in lasts]
    rows = []
    for layer, a, b in zip(card.layers, logits["card"], logits["cpu"]):
        d = (a - b).abs()
        bound = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * b.abs()
        rows.append(dict(depth=len(rows) + 1, kind=layer.kind,
                         moe=layer.moe is not None,
                         max_abs=float(d.max()), mean_abs=float(d.mean()),
                         max_over_bound=float((d / bound).max())))
    res = dict(lm=arch, layers=n_layers, d_model=card.cfg.d_model,
               follows_cpu_routes=True, by_depth=rows, tol=LOGIT_TOL)
    print(json.dumps({"card_vs_cpu_by_depth": res}), flush=True)
    return res


def lm_phase(device, arch: str) -> list:
    """Phase 6 for ``arch``: 6a, 6b (its model freed after), each flash
    row's launches those of its shape in 6b's run, then 6c (and the depth
    sweep where LM_DEPTH_SWEEP names one), with the three sub-phases'
    seconds printed → the model's flash rows."""
    import torch
    secs = {}
    t = time.perf_counter()
    with phase(f"6a:{arch}"):
        lm_rows = attention_checks(device, arch)
    secs["6a"] = time.perf_counter() - t
    t = time.perf_counter()
    with phase(f"6b:{arch}"):
        lm = lm_main_path(device, arch)
        gc.collect()
        torch.cuda.empty_cache()
    secs["6b"] = time.perf_counter() - t
    for r in lm_rows:
        # the row's shape's launches in 6b's prefill or warm captured
        # decode, as the flash wrapper counted them by shape
        kind, shape = r.pop("count_key")
        r["launches"] = lm["launches_by_shape"][kind].get(_shape_key(shape),
                                                          0)
        if not r["launches"]:
            raise AssertionError(f"{r['name']}: no launch at {shape} in "
                                 f"6b's {kind}")
    print(json.dumps(lm), flush=True)
    t = time.perf_counter()
    with phase(f"6c:{arch}"):
        print(json.dumps(dict(card_vs_cpu=lm_card_vs_cpu(device, arch))),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        if arch in LM_DEPTH_SWEEP:
            lm_depth_distance(device, arch, LM_DEPTH_SWEEP[arch])
            gc.collect()
            torch.cuda.empty_cache()
    secs["6c"] = time.perf_counter() - t
    print(json.dumps({"lm_seconds": {arch: secs}}), flush=True)
    return lm_rows


def stress_constant_checks(cases) -> list:
    """Phase 3c: each force kernel against its plain version on phase 3a's
    inputs at the stress engine's first and last entropy constants, C = α·C
    for α = ALPHA0 and ALPHA0·ALPHA_SHRINK, rounded to float32 as the stress
    loop rounds them. The force is linear in C, so phase 3's tolerance (rtol
    RTOL, atol ATOL_FRAC·max|plain|) holds at any C."""
    import numpy as np
    import torch
    from repro_torch.core.stress import ALPHA0, ALPHA_SHRINK

    out_rows = []
    for name, args, consts, shape in cases:
        C, L, md = consts
        for alpha in (ALPHA0, ALPHA0 * ALPHA_SHRINK):
            ca = float(np.float32(alpha) * np.float32(C))
            f, p, _, _, _ = _force_case(name, args, (ca, L, md))
            out, again = f(), f()
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"{name} at C={ca}: two calls differ")
            ref = p()
            row = dict(stress_constant=name, alpha=alpha, C=ca,
                       shape=_shape_label(shape),
                       max_abs_err=_compare(name, out, ref),
                       max_abs_plain=float(ref.abs().max()),
                       tol=dict(rtol=RTOL, atol_frac_of_max=ATOL_FRAC))
            print(json.dumps(row), flush=True)
            out_rows.append(row)
    return out_rows


def _path_run(label, fn, n, want_kernels) -> tuple:
    """One run of a layout path with the launch counts set to 0 just before
    it and read just after: (pos, stats, wall seconds, launches). Fails if a
    kernel of ``want_kernels`` was never launched, or unless the positions
    are n finite rows."""
    import numpy as np
    from repro_torch.kernels import _build
    _build.launches.clear()
    t0 = time.perf_counter()
    pos, stats = fn()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    if pos.shape != (n, 2) or not np.isfinite(pos).all():
        raise AssertionError(f"{label}: positions not finite / wrong shape")
    missing = [k for k in want_kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{label} never launched: {missing}")
    return pos, stats, wall, launches


class EagerRefine:
    """For the length of one run, ``core.bucketing.refine_level`` — what the
    multilevel driver calls for each level — is the engine's eager loop
    (``RefinementEngine.refine``) on the same padded level: the layout
    without the step cache, every other step the same. The package itself
    has no knob for it: the name is put back on exit."""

    def __enter__(self):
        from repro_torch.core import bucketing
        from repro_torch.core.engine import get_engine
        from repro_torch.utils.device import synchronize
        self._real = bucketing.refine_level

        def eager(g, pos0, sched, *, ideal_len, rep_const, min_dist=1e-3,
                  seed=0, phases=None):
            t0 = time.perf_counter()
            eng = get_engine(sched.engine)
            nbr_idx, nbr_mask = eng.init_state(g, sched, seed)
            pos = eng.refine(g, pos0, nbr_idx, nbr_mask, sched,
                             ideal_len=ideal_len, rep_const=rep_const,
                             min_dist=min_dist)
            if phases is not None:
                synchronize(g.device)
                phases["refine"] += time.perf_counter() - t0
            return pos
        bucketing.refine_level = eager
        return self

    def __exit__(self, *exc):
        from repro_torch.core import bucketing
        bucketing.refine_level = self._real
        return False


def cached_and_eager(label, run, n, edges, want_kernels) -> dict:
    """A layout path through the step cache, cold (cache cleared) and warm,
    and through ``EagerRefine``: each with the launch counts set to 0 just
    before it and read just after, and the allocator's peak. Fails unless
    the three agree in levels, modes and launches and the cached runs' NELD
    is within NELD_DELTA of the eager run's."""
    import torch
    from repro_torch.core import bucketing
    from repro_torch.graphs.metrics import neld

    out = {}
    bucketing.STEP_CACHE.clear()
    torch.cuda.empty_cache()
    for name in ("cold", "warm", "eager"):
        torch.cuda.reset_peak_memory_stats()
        if name == "eager":
            with EagerRefine():
                pos, stats, wall, launches = _path_run(
                    f"{label} ({name})", run, n, want_kernels)
        else:
            pos, stats, wall, launches = _path_run(
                f"{label} ({name})", run, n, want_kernels)
        out[name] = dict(wall_s=wall, phase_s=dict(stats.phase_seconds),
                         level_sizes=stats.level_sizes,
                         level_modes=stats.level_modes, launches=launches,
                         neld=neld(pos, edges),
                         cache=bucketing.cache_stats(),
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                         resident_gb=torch.cuda.memory_allocated() / 1e9)
        print(json.dumps({f"{label}_{name}": out[name]}), flush=True)
    for name in ("cold", "warm"):
        a, e = out[name], out["eager"]
        for key in ("level_sizes", "level_modes", "launches"):
            if a[key] != e[key]:
                raise AssertionError(f"{label} {name}: {key} {a[key]}, "
                                     f"eager {e[key]}")
        if abs(a["neld"] - e["neld"]) > NELD_DELTA:
            raise AssertionError(f"{label} {name}: NELD {a['neld']}, eager "
                                 f"{e['neld']}")
    if out["warm"]["cache"]["misses"] != out["cold"]["cache"]["misses"]:
        raise AssertionError(f"{label}: the warm run missed the cache: "
                             f"{out['cold']['cache']} → {out['warm']['cache']}")
    return out


def refine_breakdown(graphs, scheds, engine) -> dict:
    """Phase 4f (gila; stress in 4b): where the refine phase's time goes,
    level by level, on the main path's hierarchy with its schedules from
    drawn positions: the host seconds of ``init_state`` (the k-hop lists),
    then the level's iterations through its warm cache entry and through
    the eager loop, each as wall seconds (ended by a synchronize) and as the
    device's span between CUDA events around it, which includes any gap
    while the device waits for the host."""
    import dataclasses

    import torch
    from repro_torch.core import bucketing, gila
    from repro_torch.core.engine import get_engine

    eng = get_engine(engine)
    levels = []

    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return time.perf_counter() - t0, a.elapsed_time(b) / 1e3

    for i, (g, sched) in enumerate(zip(graphs, scheds)):
        sched = dataclasses.replace(sched, engine=engine)
        pos0 = gila.random_init(g, max(g.n, 4) ** 0.5, seed=3000 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbr_idx, nbr_mask = eng.init_state(g, sched, seed=i)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        _, prog, fresh, args = bucketing.cached_refine(
            g, pos0, sched, nbr_idx, nbr_mask, ideal_len=1.0, rep_const=1.0)
        if fresh:
            prog.run(*args)
        cached = timed(lambda: prog.run(*args))
        eager = timed(lambda: eng.refine(g, pos0, nbr_idx, nbr_mask, sched,
                                         ideal_len=1.0, rep_const=1.0))
        levels.append(dict(level=i, n=g.n, n_pad=g.n_pad, mode=sched.mode,
                           iters=sched.iters, init_state_s=init_s,
                           cached_wall_s=cached[0], cached_span_s=cached[1],
                           eager_wall_s=eager[0], eager_span_s=eager[1]))
    res = dict(refine_breakdown=engine, levels=levels, total={
        k: sum(lv[k] for lv in levels)
        for k in ("init_state_s", "cached_wall_s", "cached_span_s",
                  "eager_wall_s", "eager_span_s")})
    print(json.dumps(res), flush=True)
    return res


def _spread_floor(pos, vmask) -> float:
    """FLOOR_ULPS float32 ulps of the largest |coordinate| of ``pos``'s
    valid rows, over the count of those rows: the distance of two runs in
    which FLOOR_ULPS vertices moved by one such ulp."""
    import math
    scale = float(pos[vmask].abs().max())
    ulp = 2.0 ** (math.frexp(scale)[1] - 24) if scale > 0 else 2.0 ** -149
    return FLOOR_ULPS * ulp / int(vmask.sum())


def replay_vs_eager(graphs, scheds, engine, k=10) -> list:
    """Phase 4e (gila; stress in 4b): at the largest level of each mode of
    the main path's hierarchy, k iterations replayed from the cached entry,
    EAGER_RUNS times, against EAGER_RUNS runs of the engine's eager loop,
    from one drawn pos0. The yardstick is the median distance (mean over
    the valid vertices of max(|Δx|, |Δy|)) between two eager runs — the
    spread of ``index_add_``'s atomics — floored at FLOOR_ULPS float32 ulps
    (``_spread_floor``: at an exact level the eager runs mostly agree while
    a replay sums in another order, ``ROADMAP.md`` queue 3). Within
    REPLAY_FACTOR times it must lie the median replay-to-eager distance and
    the median distance between two replays (so replays that scatter among
    themselves fail too); a replay's launches must equal an eager run's.
    The largest |Δpos| of each sample is printed beside them."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import bucketing, gila
    from repro_torch.core.engine import get_engine
    from repro_torch.kernels import _build

    eng = get_engine(engine)
    rows = []
    for mode in ("grid", "neighbor", "exact"):
        i = max((i for i, s in enumerate(scheds) if s.mode == mode),
                key=lambda i: graphs[i].n)
        g = graphs[i]
        sched = dataclasses.replace(scheds[i], engine=engine, iters=k)
        pos0 = gila.random_init(g, max(g.n, 4) ** 0.5, seed=2000 + i)
        nbr_idx, nbr_mask = eng.init_state(g, sched, seed=i)
        _build.launches.clear()
        eager = [eng.refine(g, pos0, nbr_idx, nbr_mask, sched, ideal_len=1.0,
                            rep_const=1.0) for _ in range(EAGER_RUNS)]
        torch.cuda.synchronize()
        eager_launches = {name: c // EAGER_RUNS
                          for name, c in _build.launches.items()}
        _, prog, fresh, args = bucketing.cached_refine(
            g, pos0, sched, nbr_idx, nbr_mask, ideal_len=1.0, rep_const=1.0)
        if fresh:
            prog.run(*args)                      # warm-up and capture
        _build.launches.clear()
        outs = [prog.run(*args) for _ in range(EAGER_RUNS)]
        torch.cuda.synchronize()
        dist = lambda a, b: float((a - b).abs().amax(dim=1)[g.vmask].mean())
        within = lambda xs: [dist(a, b) for j, a in enumerate(xs)
                             for b in xs[j + 1:]]
        pairs, rpairs = within(eager), within(outs)
        replay = [dist(o, e) for o in outs for e in eager]
        floor = _spread_floor(eager[0], g.vmask)
        row = dict(replay_vs_eager=engine, mode=mode, level=i, n=g.n,
                   n_pad=g.n_pad, iterations=k, fresh_entry=fresh,
                   replay_distance=float(np.median(replay)),
                   eager_spread=float(np.median(pairs)),
                   replay_spread=float(np.median(rpairs)),
                   spread_floor=floor,
                   replay_distances=replay, eager_distances=pairs,
                   replay_pair_distances=rpairs,
                   max_abs_diff=max(float((o - e).abs().max())
                                    for o in outs for e in eager),
                   eager_max_abs_diff=max(float((a - b).abs().max())
                                          for j, a in enumerate(eager)
                                          for b in eager[j + 1:]),
                   launches={name: c // EAGER_RUNS
                             for name, c in _build.launches.items()},
                   eager_launches=eager_launches)
        row["bound"] = REPLAY_FACTOR * max(row["eager_spread"], floor)
        print(json.dumps(row), flush=True)
        if max(row["replay_distance"], row["replay_spread"]) > row["bound"]:
            raise AssertionError(f"replay vs eager: {row}")
        if row["launches"] != eager_launches:
            raise AssertionError(f"replay launches: {row}")
        rows.append(row)
    return rows


@contextlib.contextmanager
def _sync_debug_error():
    """``torch.cuda.set_sync_debug_mode("error")`` for the length of a
    block (any host sync in it raises), the default mode restored after."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _sync_free_run(label, prog, fresh, args, kernels) -> dict:
    """One warm ``run`` of a cached refine program whose iteration loop (the
    graph replays and the schedule's chunk reloads) runs under sync-debug
    "error", then EAGER_STEPS calls of its step function made eagerly on
    the current stream under the same mode. The loop's launches of each of
    ``kernels`` must equal its iterations."""
    import torch
    from repro_torch.kernels import _build

    if fresh:
        prog.run(*args)                      # warm-up and capture
    iters = args[-2].shape[-2]               # the schedule's rows

    def guarded(*a, _loop=prog._iterate, **kw):
        with _sync_debug_error():
            return _loop(*a, **kw)
    prog._iterate = guarded
    _build.launches.clear()
    t0 = time.perf_counter()
    try:
        pos = prog.run(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: _build.launches[k] for k in kernels}
        with _sync_debug_error():
            for _ in range(EAGER_STEPS):
                prog._iteration()
    finally:
        del prog._iterate
    torch.cuda.synchronize()
    res = dict(sync_free_refine=label, fresh_entry=fresh, iterations=iters,
               eager_steps=EAGER_STEPS, launches=launches, wall_s=wall,
               sync_debug_mode="error")
    print(json.dumps(res), flush=True)
    after = prog._bufs["pos"]
    if not (bool(torch.isfinite(pos).all())
            and bool(torch.isfinite(after).all())):
        raise AssertionError(f"phase 4g {label}: non-finite positions")
    if any(c != iters for c in launches.values()):
        raise AssertionError(f"phase 4g {label}: launches {launches}, "
                             f"{iters} iterations")
    return res


MODE_KERNELS = dict(exact=("nbody",), neighbor=("neighbor_force",),
                    grid=("grid_near", "grid_far"))


def sync_free_refine(graphs, scheds) -> list:
    """Phase 4g: every cached refine step of the layout path under
    ``torch.cuda.set_sync_debug_mode("error")``, for both engines: the
    single-graph ``RefineProgram`` at the largest level of each mode of the
    1M hierarchy, and the batched ``RefineManyProgram`` on two lanes of the
    smallest level of each mode (each lane its own drawn positions). An
    entry not in the cache (gila's, which 4b's cold run cleared; every
    batched one) is captured first, outside the sync-debug mode.
    Each runs SYNC_ITERS iterations (more than a schedule buffer's ROWS, so
    a chunk reload falls inside) and EAGER_STEPS eager steps
    (``_sync_free_run``)."""
    import dataclasses

    from repro_torch.core import bucketing, gila
    from repro_torch.core.engine import get_engine

    out = []
    for engine in ("gila", "stress"):
        eng = get_engine(engine)
        for mode in ("exact", "neighbor", "grid"):
            idx = [i for i, s in enumerate(scheds) if s.mode == mode]
            for i, many in ((max(idx, key=lambda i: graphs[i].n), False),
                            (min(idx, key=lambda i: graphs[i].n), True)):
                g = graphs[i]
                sched = dataclasses.replace(scheds[i], engine=engine,
                                            iters=SYNC_ITERS)
                pos0 = gila.random_init(g, max(g.n, 4) ** 0.5, seed=3000 + i)
                program = ("RefineManyProgram, 2 lanes" if many
                           else "RefineProgram")
                label = f"{engine} {mode} L{i} ({g.n} of {g.n_pad}) {program}"
                if many:
                    reqs = [bucketing.make_request(g, p, sched, i) for p in (
                        pos0, gila.random_init(g, max(g.n, 4) ** 0.5,
                                               seed=4000 + i))]
                    nbrs = [eng.init_state(r.g, r.sched, r.seed)
                            for r in reqs]
                    _, prog, fresh, args = bucketing.cached_refine_many(
                        reqs, nbrs, ideal_len=1.0, rep_const=1.0)
                else:
                    nbr_idx, nbr_mask = eng.init_state(g, sched, seed=i)
                    _, prog, fresh, args = bucketing.cached_refine(
                        g, pos0, sched, nbr_idx, nbr_mask, ideal_len=1.0,
                        rep_const=1.0)
                out.append(_sync_free_run(label, prog, fresh, args,
                                          MODE_KERNELS[mode]))
    return out


def stress_path(edges, n, weights, gila, graphs, scheds) -> dict:
    """Phase 4b: the weighted stress layout of the main path's graph —
    cached cold and warm, and eager (``cached_and_eager``), the warm cached
    and the eager run profiled, the refine breakdown and the replay check
    at the main path's levels. ``gila`` is phase 4's (stats, launches): the stress engine
    keeps the gila path's schedule, so its levels, modes and launches must
    be the same."""
    from repro_torch.core import LayoutConfig, multigila_layout
    from repro_torch.kernels import _build

    cfg = LayoutConfig(engine="stress")
    run = lambda: multigila_layout(edges, n, cfg, weights=weights)
    runs = cached_and_eager("stress_path", run, n, edges, _FORCE_KERNELS)
    g_stats, g_launches = gila
    warm = runs["warm"]
    if (warm["level_sizes"], warm["level_modes"], warm["launches"]) != (
            g_stats.level_sizes, g_stats.level_modes, g_launches):
        raise AssertionError(f"stress path: levels {warm['level_sizes']} "
                             f"{warm['level_modes']}, launches "
                             f"{warm['launches']}; the gila path's "
                             f"{g_launches}")
    profiles = {}
    for name in ("warm", "eager"):
        _build.launches.clear()
        if name == "eager":
            with EagerRefine():
                profiles[name] = profile_run(run)
        else:
            profiles[name] = profile_run(run)
        if dict(_build.launches) != warm["launches"]:
            raise AssertionError(f"profiled stress run ({name}) launched "
                                 f"{dict(_build.launches)}, the timed "
                                 f"{warm['launches']}")
    res = dict(stress_path=f"delaunay({n}), weights U({WEIGHT_LO}, "
                           f"{WEIGHT_HI}) from seed 0",
               wall_s=warm["wall_s"], launches=warm["launches"],
               launches_equal_gila_path=True, positions_finite=True,
               profile_cached_warm=profiles["warm"],
               profile_eager=profiles["eager"],
               refine_breakdown=refine_breakdown(graphs, scheds, "stress"),
               replay_vs_eager=replay_vs_eager(graphs, scheds, "stress"))
    print(json.dumps(res), flush=True)
    return dict(res, runs=runs)


def flat_path(edges, n, main_wall, main_neld) -> dict:
    """Phase 4c: the single-level ``flat`` driver on the main path's graph,
    through the step cache and eagerly, beside phase 4's multilevel
    numbers (the paper's multilevel-versus-single-level comparison)."""
    from repro_torch.core import LayoutConfig, multigila_layout
    from repro_torch.graphs.metrics import neld

    res = dict(flat_path=f"delaunay({n})", multigila_wall_s=main_wall,
               multigila_neld=main_neld)
    run = lambda: multigila_layout(edges, n, LayoutConfig(driver="flat"))
    for name in ("cached", "eager"):
        if name == "eager":
            with EagerRefine():
                pos, stats, wall, launches = _path_run(
                    "flat path (eager)", run, n, ("grid_near", "grid_far"))
        else:
            pos, stats, wall, launches = _path_run(
                "flat path", run, n, ("grid_near", "grid_far"))
        res[name] = dict(wall_s=wall, phase_s=stats.phase_seconds,
                         level_sizes=stats.level_sizes,
                         level_modes=stats.level_modes, launches=launches,
                         neld=neld(pos, edges))
    if res["cached"]["launches"] != res["eager"]["launches"]:
        raise AssertionError(f"flat path: launches {res}")
    print(json.dumps(res), flush=True)
    print(f"centralized: not run at delaunay({n}): exact all-pairs repulsion "
          f"over all {n} vertices at each of the finest level's 50 "
          f"iterations ({n * n:.3g} pairs an iteration)", flush=True)
    return res


_GRAPH_FIELDS = ("src", "dst", "vmask", "emask", "mass", "ewt")
_INFO_FIELDS = ("parent_coarse", "sun_of", "depth", "state", "sun_pos_index")


def _plain_hierarchy(h) -> dict:
    """A hierarchy (graphs, infos) as host numpy arrays — the form a CPU
    worker returns; a plain hierarchy is returned as it is."""
    if isinstance(h, dict):
        return h
    graphs, infos = h
    return dict(sizes=[(g.n, g.m) for g in graphs],
                graphs=[{f: getattr(g, f).cpu().numpy() for f in _GRAPH_FIELDS}
                        for g in graphs],
                infos=[{f: getattr(i, f).cpu().numpy() for f in _INFO_FIELDS}
                       for i in infos])


def _same(a, b) -> bool:
    """Two numpy arrays equal in dtype, shape and every element."""
    import numpy as np
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _assert_hierarchies_equal(label, card, cpu) -> None:
    """Level sizes and every coarse-graph and LevelInfo array equal, bit for
    bit (two hierarchies on any devices, or their ``_plain_hierarchy``:
    card against CPU, or two runs)."""
    a, b = _plain_hierarchy(card), _plain_hierarchy(cpu)
    if a["sizes"] != b["sizes"]:
        raise AssertionError(f"{label}: level sizes differ")
    for x, y in zip(a["infos"], b["infos"]):
        for field in _INFO_FIELDS:
            if not _same(x[field], y[field]):
                raise AssertionError(f"{label}: {field} differs")
    for x, y in zip(a["graphs"], b["graphs"]):
        for field in _GRAPH_FIELDS:
            if not _same(x[field], y[field]):
                raise AssertionError(f"{label}: coarse graph {field} differs")


def _hierarchy(edges, n, cfg, device, weights=None):
    """(graphs, infos) of the pruned, weighted hierarchy, and its seconds
    (the device synchronised at the end)."""
    import torch
    from repro_torch.core import build_hierarchy
    from repro_torch.core.pruning import prune_degree_one
    from repro_torch.graphs.graph import build_graph
    t0 = time.perf_counter()
    pr = prune_degree_one(edges, n, weights=weights)
    g = build_graph(pr.edges, pr.n, mass=pr.mass, ewt=pr.ewt, bucket=True,
                    device=device)
    h = build_hierarchy(g, cfg, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return h, time.perf_counter() - t0


def weighted_hierarchy_card(edges, n, weights) -> tuple:
    """Phase 4d's card side: (the main path's graph's weighted hierarchy,
    plain, its build seconds on the card)."""
    from repro_torch.core import LayoutConfig
    h, secs = _hierarchy(edges, n, LayoutConfig(), "cuda", weights)
    return _plain_hierarchy(h), secs


def weighted_hierarchy_card_vs_cpu(n, card, cpu) -> dict:
    """Phase 4d: the weighted hierarchy built on the card and on the CPU
    (``CpuRefs``' "4d"): equal bit for bit, ``ewt`` included."""
    (card_h, card_s), (cpu_h, cpu_s) = card, cpu
    _assert_hierarchies_equal(f"weighted delaunay({n})", card_h, cpu_h)
    res = dict(weighted_hierarchy=f"delaunay({n})",
               level_sizes=card_h["sizes"],
               card_build_s=card_s, cpu_build_s=cpu_s, equal=True)
    print(json.dumps(res), flush=True)
    return res


def _weights5(e5):
    """Phases 5b and 9c's per-edge weights of the 5k graph."""
    import numpy as np
    return np.random.default_rng(0).uniform(WEIGHT_LO, WEIGHT_HI,
                                            len(e5)).astype(np.float32)


def small_card(e5, n5, cfg5) -> dict:
    """Phase 5's card side: the 5k graph's hierarchy (plain) and layout."""
    import numpy as np
    from repro_torch.core import multigila_layout
    from repro_torch.graphs.metrics import cre, neld
    h = _plain_hierarchy(_hierarchy(e5, n5, cfg5, "cuda")[0])
    pos, stats = multigila_layout(e5, n5, cfg5)
    if not np.isfinite(pos).all():
        raise AssertionError("small layout on the card: non-finite")
    return dict(hierarchy=h, stats=stats, neld_cre=(neld(pos, e5),
                                                    cre(pos, e5)))


def small_card_vs_cpu(n5, card, cpu) -> dict:
    """Phase 5: the 5k graph's hierarchy built on the card equals the one
    built on the CPU (``CpuRefs``' "5"), and the card's layout scores
    within NELD_DELTA and CRE_DELTA of the CPU layout's."""
    _assert_hierarchies_equal("delaunay(5000)", card["hierarchy"],
                              cpu["hierarchy"])
    q = {"cuda": card["neld_cre"], "cpu": cpu["neld_cre"]}
    if (abs(q["cuda"][0] - q["cpu"][0]) > NELD_DELTA
            or abs(q["cuda"][1] - q["cpu"][1]) > CRE_DELTA):
        raise AssertionError(f"small layout quality differs: {q}")
    res = dict(small=f"delaunay(5000) n={n5}",
               level_sizes=card["stats"].level_sizes,
               level_modes=card["stats"].level_modes,
               hierarchy_equal=True, neld_cre=q)
    print(json.dumps(res), flush=True)
    return res


def _engine_cases(cfg5) -> tuple:
    """Phase 5b's cases: (name, config, weighted, CRE compared)."""
    import dataclasses
    from repro_torch.core import LayoutConfig
    return (("stress_weighted", dataclasses.replace(cfg5, engine="stress"),
             True, True),
            ("centralized", LayoutConfig(driver="centralized"), False, True),
            ("flat", LayoutConfig(driver="flat"), False, False))


def _flat_early(e5, n5, cfg, device) -> tuple:
    """The flat driver's own random init on ``device`` and 5 iterations of
    its level from it, the schedule from the graph built on the CPU:
    (init, positions) as numpy."""
    import dataclasses
    from repro_torch.core import bucketing, gila
    from repro_torch.core.multilevel import _schedule
    from repro_torch.graphs.graph import build_graph
    g_cpu = build_graph(e5, n5, bucket=True, device="cpu")
    g = (g_cpu if device == "cpu"
         else build_graph(e5, n5, bucket=True, device=device))
    sched = dataclasses.replace(_schedule(cfg, 0, 1, g_cpu), iters=5)
    scale = cfg.ideal_len * max(n5, 4) ** 0.5
    p0 = gila.random_init(g, scale, cfg.seed)
    early = bucketing.refine_level(g, p0, sched, ideal_len=cfg.ideal_len,
                                   rep_const=cfg.rep_const, seed=cfg.seed)
    return p0.cpu().numpy(), early.cpu().numpy()


def engines_card(e5, n5, cfg5) -> dict:
    """Phase 5b's card side, case by case: the weighted hierarchy (plain),
    the layout and its seconds, and the flat driver's early iterations."""
    import numpy as np
    from repro_torch.core import multigila_layout
    from repro_torch.graphs.metrics import cre, neld
    w5 = _weights5(e5)
    out = {}
    for name, cfg, weighted, _ in _engine_cases(cfg5):
        w = w5 if weighted else None
        row = out[name] = {}
        if weighted:
            row["hierarchy"] = _plain_hierarchy(
                _hierarchy(e5, n5, cfg, "cuda", w)[0])
        t0 = time.perf_counter()
        pos, row["stats"] = multigila_layout(e5, n5, cfg, weights=w)
        row["card_s"] = time.perf_counter() - t0
        if not np.isfinite(pos).all():
            raise AssertionError(f"{name} on the card: non-finite")
        row["neld_cre"] = (neld(pos, e5), cre(pos, e5))
        if name == "flat":
            row["early"] = _flat_early(e5, n5, cfg, "cuda")
    return out


def engines_card_vs_cpu(n5, cfg5, card, refs) -> dict:
    """Phase 5b: the ported engine and drivers, card (``engines_card``)
    against CPU (``CpuRefs``' "5b:…"), on the phase-5 graph (see the
    module docstring)."""
    import numpy as np
    res = {}
    for name, _, weighted, cre_compared in _engine_cases(cfg5):
        c, h = card[name], refs.get(f"5b:{name}")
        if weighted:
            _assert_hierarchies_equal(f"{name} delaunay({n5})",
                                      c["hierarchy"], h["hierarchy"])
        if c["stats"].level_sizes != h["stats"].level_sizes:
            raise AssertionError(f"{name}: level sizes differ")
        q = {"cuda": c["neld_cre"], "cpu": h["neld_cre"]}
        row = dict(level_sizes=c["stats"].level_sizes,
                   level_modes=c["stats"].level_modes, neld_cre=q,
                   card_s=c["card_s"], cpu_s=h["cpu_s"],
                   hierarchy_equal=True if weighted else None,
                   cre_compared=cre_compared)
        if name == "flat":
            # the driver's own random init, then 5 iterations of its level
            (p0_card, early_card), (p0_cpu, early_cpu) = (
                c["early"], refs.get("5b:flat_early"))
            if not _same(p0_card, p0_cpu):
                raise AssertionError("flat: random init differs")
            row["first_5_iterations_max_abs_diff"] = float(
                np.abs(early_card - early_cpu).max())
            row["flat_early_tol"] = FLAT_EARLY_TOL
            if row["first_5_iterations_max_abs_diff"] > FLAT_EARLY_TOL:
                raise AssertionError(f"flat: {row}")
        print(json.dumps({f"small_{name}": row}), flush=True)
        if (abs(q["cuda"][0] - q["cpu"][0]) > NELD_DELTA
                or (cre_compared
                    and abs(q["cuda"][1] - q["cpu"][1]) > CRE_DELTA)):
            raise AssertionError(f"{name}: quality differs, card vs CPU: {q}")
        res[name] = row
    return res


def cli_on_card() -> dict:
    """Phase 5c: the layout CLI in process, on the card by default."""
    import contextlib
    import io
    from repro_torch.kernels import _build
    from repro_torch.launch import layout as cli

    argv = ["--graph", "delaunay", "--args", "20000", "3", "--engine",
            "stress", "--no-cre"]
    _build.launches.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = cli.main(argv)
    lines = buf.getvalue().splitlines()
    launches = dict(_build.launches)
    if not launches or not (rep["neld"] == rep["neld"]):
        raise AssertionError(f"CLI: launches {launches}, report {rep}")
    res = dict(cli=" ".join(argv), printed=lines, report=rep,
               launches=launches)
    print(json.dumps(res), flush=True)
    return res


# -- the batched driver (phases 3d, 5d, 7) ----------------------------------------

def cre_card(pos, edges, block: int = 2048) -> float:
    """``graphs.metrics.cre`` (crossings per edge over the canonical edge
    list) computed on the card with the same float32 orientation tests:
    the host count takes seconds a 5k layout, and the batched phase scores
    hundreds. Checked against the host count in ``many_suite``."""
    import numpy as np
    import torch
    from repro_torch.graphs.graph import canonical_edges

    e = canonical_edges(edges)
    m = int(e.shape[0])
    if m < 2:
        return 0.0
    E = torch.from_numpy(e).cuda()
    P = torch.from_numpy(np.asarray(pos, np.float32)).cuda()
    P1, P2 = P[E[:, 0]], P[E[:, 1]]

    def orient(a, b, c):
        return ((b[:, None, 0] - a[:, None, 0]) * (c[None, :, 1] - a[:, None, 1])
                - (b[:, None, 1] - a[:, None, 1]) * (c[None, :, 0] - a[:, None, 0]))

    total = 0
    ids = torch.arange(m, device="cuda")
    for i0 in range(0, m, block):
        i1 = min(i0 + block, m)
        ei, ej = E[i0:i1], E[i0:]
        share = ((ei[:, 0, None] == ej[None, :, 0])
                 | (ei[:, 0, None] == ej[None, :, 1])
                 | (ei[:, 1, None] == ej[None, :, 0])
                 | (ei[:, 1, None] == ej[None, :, 1])
                 | (ids[i0:] [None, :] <= ids[i0:i1, None]))
        a1, a2, b1, b2 = P1[i0:i1], P2[i0:i1], P1[i0:], P2[i0:]
        proper = ((orient(a1, a2, b1) * orient(a1, a2, b2) < 0)
                  & (orient(b1, b2, a1).T * orient(b1, b2, a2).T < 0))
        total += int((proper & ~share).sum())
    return 2.0 * total / m


class ManyRecorder:
    """For the length of one run, wraps what the batched driver reaches
    through module attributes, and puts each back on exit (the package has
    no hook): ``WaveScheduler.step`` (each wave's groups),
    ``bucketing.refine_level_many`` (each group: its key, lane bucket, live
    lanes and largest iteration budget; with ``requests``, its requests,
    keywords and outputs too) and ``multilevel.build_hierarchy`` (each
    hierarchy built, in call order). With ``kernels`` (a dict), the force
    kernels' arguments at their first eager call at each lane shape are
    kept there, with the group that made the call — calls during a CUDA
    graph capture read no data and are skipped (phase 3d)."""

    def __init__(self, requests=False, kernels=None):
        self.requests, self.kernels = requests, kernels
        self.waves, self.groups, self.hierarchies = [], [], []
        self._group = None

    def _patch(self, owner, attr, fn):
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def __enter__(self):
        import torch
        from repro_torch.core import bucketing, gila, multilevel
        from repro_torch.graphs import packing
        from repro_torch.kernels.grid_force import ops as grid_ops
        self._saved = []
        real_step = multilevel.WaveScheduler.step
        real_many = bucketing.refine_level_many
        real_hier = multilevel.build_hierarchy

        def step(sched, **kw):
            out = real_step(sched, **kw)
            if out["lanes"]:
                self.waves.append([n for _, n in out["groups"]])
            return out

        def many(reqs, **kw):
            grp = dict(key=bucketing.group_key(reqs[0]),
                       lanes=packing.lane_bucket(len(reqs),
                                                 kw.get("lanes_min", 8)),
                       live=len(reqs),
                       max_iters=max(r.sched.iters for r in reqs))
            self.groups.append(grp)
            self._group = grp
            out = real_many(reqs, **kw)
            if self.requests:
                grp.update(reqs=reqs, kw=kw, out=[o.clone() for o in out])
            return out

        def hier(g0, cfg, *, device=None):
            h = real_hier(g0, cfg, device=device)
            self.hierarchies.append(h)
            return h

        self._patch(multilevel.WaveScheduler, "step", step)
        self._patch(bucketing, "refine_level_many", many)
        self._patch(multilevel, "build_hierarchy", hier)
        if self.kernels is not None:
            shapes = dict(
                nbody=lambda pos, *a: (),
                neighbor_force=lambda pos, mass, nbr, *a: (nbr.shape[2],),
                grid_near=lambda pos, mass, vmask, bucket, *a:
                    tuple(bucket.shape[1:]),
                grid_far=lambda pos, cells, *a: (cells.shape[1],))
            for owner, attr, name in (
                    (gila, "nbody_repulsion", "nbody"),
                    (gila, "neighbor_repulsion", "neighbor_force"),
                    (grid_ops, "grid_near", "grid_near"),
                    (grid_ops, "grid_far", "grid_far")):
                self._patch(owner, attr, self._kernel(
                    getattr(owner, attr), name, shapes[name], torch))
        return self

    def _kernel(self, real, name, shape_of, torch):
        def wrapper(*args):
            pos = args[0]
            if pos.dim() == 3 and not torch.cuda.is_current_stream_capturing():
                key = (name, pos.shape[0], pos.shape[1]) + shape_of(*args)
                if key not in self.kernels:
                    self.kernels[key] = (
                        tuple(a.clone() for a in args[:-1]), args[-1].clone(),
                        self._group)
            return real(*args)
        return wrapper

    def __exit__(self, *exc):
        for owner, attr, real in reversed(self._saved):
            setattr(owner, attr, real)
        return False

    def launches(self) -> dict:
        """What the recorded groups launch, by shape as the wrappers count
        it (``_build.shape_launches``): each group its largest budget of
        iterations, one launch an iteration of its mode's kernels, at
        (name, lanes, n_pad, the kernel's other extents)."""
        out = {}
        for g in self.groups:
            _, n_pad, _, K, _, mode, G, cap = g["key"]
            B = g["lanes"]
            shapes = dict(exact=[("nbody", B, n_pad)],
                          neighbor=[("neighbor_force", B, n_pad, K)],
                          grid=[("grid_near", B, n_pad, G * G + 1, cap),
                                ("grid_far", B, n_pad, G * G)])[mode]
            for key in shapes:
                out[key] = out.get(key, 0) + g["max_iters"]
        return out


def _suite(n_graphs, n, seed0):
    from repro_torch.graphs import generators
    return [generators.delaunay(n, seed=seed0 + i) for i in range(n_graphs)]


def _suite_weights(graphs):
    import numpy as np
    return [np.random.default_rng(i).uniform(WEIGHT_LO, WEIGHT_HI, len(e))
            .astype(np.float32) for i, (e, _) in enumerate(graphs)]


def _batched_run(label, graphs, cfg, *, engines=None, weights=None,
                 device=None, kernels=None, requests=False,
                 seeds=None, profiled=False) -> dict:
    """One ``multigila_layout_many`` call with the launch counts set to 0
    just before it and read just after, under a ``ManyRecorder``: wall,
    graphs/s, phase seconds (the graphs' sums), the cache's
    entries/hits/misses, resident and peak GB, waves and groups a wave,
    launches by kernel and by shape (on the card, each shape's count must
    equal the budgets of the groups at that shape), and every position
    finite. With ``profiled`` the call is ``profile_run``'s, its summary
    returned under "profile"."""
    import numpy as np
    import torch
    from repro_torch.core import bucketing, multigila_layout_many
    from repro_torch.kernels import _build

    cuda = device is None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with ManyRecorder(requests=requests, kernels=kernels) as rec:
        _build.launches.clear()
        _build.shape_launches.clear()
        run = lambda: multigila_layout_many(graphs, cfg, seeds=seeds,
                                            engines=engines, weights=weights,
                                            device=device)
        prof = None
        if profiled:
            got = []
            prof = profile_run(lambda: got.append(run()))
            outs, wall = got[0], prof["wall_s"]
        else:
            t0 = time.perf_counter()
            outs = run()
            wall = time.perf_counter() - t0
        launches = dict(_build.launches)
        shape_launches = dict(_build.shape_launches)
    for (e, n), (pos, _) in zip(graphs, outs):
        if pos.shape != (n, 2) or not np.isfinite(pos).all():
            raise AssertionError(f"{label}: positions not finite")
    want = rec.launches()
    by_name = {}
    for key, c in shape_launches.items():
        by_name[key[0]] = by_name.get(key[0], 0) + c
    if cuda and (shape_launches != want or launches != by_name):
        raise AssertionError(f"{label}: launched {shape_launches}, the "
                             f"groups' budgets make {want}")
    phases = {k: sum(s.phase_seconds[k] for _, s in outs)
              for k in outs[0][1].phase_seconds}
    res = dict(wall_s=wall, graphs_per_s=len(graphs) / wall,
               phase_s=phases, waves=len(rec.waves),
               groups_per_wave=[len(w) for w in rec.waves],
               lanes_per_group=[g["live"] for g in rec.groups],
               lane_buckets=[g["lanes"] for g in rec.groups],
               launches=launches,
               shape_launches={" ".join(map(str, k)): c
                               for k, c in shape_launches.items()},
               cache=bucketing.cache_stats())
    if cuda:
        res.update(resident_gb=torch.cuda.memory_allocated() / 1e9,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps({label: res}), flush=True)
    return dict(res, outs=outs, rec=rec, shape_counts=shape_launches,
                profile=prof)


def _sequential_run(label, graphs, cfg, *, engines=None, weights=None,
                    device=None) -> dict:
    """The same graphs through ``multigila_layout`` one at a time."""
    import dataclasses

    import numpy as np
    from repro_torch.core import multigila_layout
    from repro_torch.kernels import _build
    with ManyRecorder() as rec:
        _build.launches.clear()
        t0 = time.perf_counter()
        outs = [multigila_layout(
            e, n, cfg if engines is None else dataclasses.replace(
                cfg, engine=engines[i]),
            weights=None if weights is None else weights[i], device=device)
            for i, (e, n) in enumerate(graphs)]
        wall = time.perf_counter() - t0
        launches = dict(_build.launches)
    for (e, n), (pos, _) in zip(graphs, outs):
        if pos.shape != (n, 2) or not np.isfinite(pos).all():
            raise AssertionError(f"{label}: positions not finite")
    phases = {k: sum(s.phase_seconds[k] for _, s in outs)
              for k in outs[0][1].phase_seconds}
    res = dict(wall_s=wall, graphs_per_s=len(graphs) / wall,
               phase_s=phases, launches=launches)
    print(json.dumps({label: res}), flush=True)
    return dict(res, outs=outs, rec=rec)


def _lanes_against(label, graphs, batched, other, *,
                   cre_spread=None, lane_cre=True) -> dict:
    """Each lane against the same graph's other run: hierarchy (level
    sizes, modes, every array) bit for bit and NELD within NELD_DELTA.
    With ``cre_spread`` (the median CRE gap between two batched runs of the
    same graphs on the card, the seeds moved in one, ``_cre_gaps``), CRE
    too (crossings counted on the card, ``cre_card``): each lane within
    max(CRE_DELTA, CRE_SPREAD_MULT × cre_spread) (unless ``lane_cre`` is
    False: then the lanes are printed, not held) and the lanes' mean gap
    within max(CRE_MEAN_DELTA, CRE_MEAN_SES × its standard error).
    A lane's final CRE is chaotic under the card's atomics (the placer's
    and the sequential driver's ``index_add_``), so two batched runs of
    one seed on the card differ by more than CRE_DELTA on some lanes
    (``ROADMAP.md`` queue 3). Each lane's NELD and CRE on both sides are
    printed, with both gaps, the bounds and the count of lanes past
    CRE_DELTA."""
    import numpy as np
    from repro_torch.graphs.metrics import neld
    ha, hb = batched["rec"].hierarchies, other["rec"].hierarchies
    if len(ha) != len(graphs) or len(hb) != len(graphs):
        raise AssertionError(f"{label}: {len(ha)} and {len(hb)} hierarchies "
                             f"for {len(graphs)} graphs")
    q = {"neld": [], "cre": []}
    for i, ((e, n), (pa, sa), (pb, sb)) in enumerate(
            zip(graphs, batched["outs"], other["outs"])):
        _assert_hierarchies_equal(f"{label} graph {i}", ha[i], hb[i])
        if (sa.level_sizes, sa.level_modes) != (sb.level_sizes,
                                                sb.level_modes):
            raise AssertionError(f"{label} graph {i}: levels or modes differ")
        q["neld"].append((neld(pa, e), neld(pb, e)))
        if cre_spread is not None:
            q["cre"].append((cre_card(pa, e), cre_card(pb, e)))
    gap = {k: [abs(a - b) for a, b in v] for k, v in q.items()}
    res = dict(hierarchies_equal=len(graphs), levels_and_modes_equal=True,
               max_neld_diff=max(gap["neld"]), neld=q["neld"],
               cre=q["cre"] or None)
    if cre_spread is not None:
        d = np.array([a - b for a, b in q["cre"]])
        se = float(d.std(ddof=1) / len(d) ** 0.5) if len(d) > 1 else 0.0
        res.update(
            max_cre_diff=max(gap["cre"]),
            lane_cre_bound=(max(CRE_DELTA, CRE_SPREAD_MULT * cre_spread)
                            if lane_cre else None),
            cre_spread=cre_spread,
            lanes_past_cre_delta=sum(x > CRE_DELTA for x in gap["cre"]),
            mean_cre_diff=abs(float(d.mean())), mean_cre_se=se,
            mean_cre_bound=max(CRE_MEAN_DELTA, CRE_MEAN_SES * se))
    print(json.dumps({f"{label}_lanes": res}), flush=True)
    if res["max_neld_diff"] > NELD_DELTA:
        raise AssertionError(f"{label}: NELD {res['max_neld_diff']} apart")
    if cre_spread is not None and (
            (lane_cre and res["max_cre_diff"] > res["lane_cre_bound"])
            or res["mean_cre_diff"] > res["mean_cre_bound"]):
        raise AssertionError(f"{label}: CRE a lane {res['max_cre_diff']} "
                             f"(bound {res['lane_cre_bound']}), the mean "
                             f"{res['mean_cre_diff']} apart")
    return res


def _cre_gaps(label, graphs, one, two) -> dict:
    """The card against itself: each lane's CRE in two batched runs of the
    same graphs, their largest, median and mean gap printed and
    returned."""
    import numpy as np
    gaps = [cre_card(a, e) - cre_card(b, e) for (e, _), (a, _), (b, _)
            in zip(graphs, one["outs"], two["outs"])]
    res = dict(max_abs=max(map(abs, gaps)),
               median_abs=float(np.median(np.abs(gaps))),
               mean=float(sum(gaps) / len(gaps)),
               over_delta=sum(abs(x) > CRE_DELTA for x in gaps))
    print(json.dumps({label: res}), flush=True)
    return res


def _repeats_its_bits(label, batched) -> dict:
    """Each exact and neighbor group of a run with incidence tables (its
    edge sums take no atomics) run again on its recorded requests: the
    same bits. Grid groups sum their cells with ``index_add_``."""
    import torch
    from repro_torch.core import bucketing
    checked = []
    for g in batched["rec"].groups:
        key = g["key"]
        if key[5] == "grid" or key[4] == 0:
            continue
        again = bucketing.refine_level_many(g["reqs"], **g["kw"])
        same = all(torch.equal(a, b) for a, b in zip(g["out"], again))
        checked.append(dict(mode=key[5], n_pad=key[1], lanes=g["lanes"],
                            live=g["live"], same_bits=same))
        if not same:
            raise AssertionError(f"{label}: a {key[5]} group at n_pad "
                                 f"{key[1]} did not repeat its bits")
    print(json.dumps({f"{label}_repeats_its_bits": checked}), flush=True)
    return checked


def batched_vs_single_step(label, batched, mode, k=10) -> dict:
    """One level's k batched iterations (the first recorded group of
    ``mode``) against the single-graph cached step on lane 0's request:
    the median of the batched lane's distances from EAGER_RUNS
    single-graph runs within twice the single step's own spread, the
    larger of the median distance between two of its runs and the median
    distance of its runs from the same step on the CPU, floored at
    ``_spread_floor``. Replays of one captured step order their
    ``index_add_`` sums alike, so two of them may agree far more closely
    than either does with any other order of the same sums; the CPU sums
    a level's edges in the batched lane's order (batched equals single
    there bit for bit), so its distance from the card's single step
    measures how far that other order moves a correct run in k
    iterations (``ROADMAP.md`` queue 3)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import bucketing

    g = next(g for g in batched["rec"].groups if g["key"][5] == mode)
    reqs = [dataclasses.replace(r, sched=dataclasses.replace(r.sched,
                                                             iters=k))
            for r in g["reqs"]]
    cfg_kw = dict(ideal_len=1.0, rep_const=1.0)
    lane = bucketing.refine_level_many(reqs, **cfg_kw)[0]
    r = reqs[0]
    runs = [bucketing.refine_level(r.g, r.pos0, r.sched, seed=r.seed,
                                   **cfg_kw) for _ in range(EAGER_RUNS)]
    torch.cuda.synchronize()
    g_cpu = dataclasses.replace(r.g, **{
        f.name: getattr(r.g, f.name).cpu()
        for f in dataclasses.fields(r.g)
        if isinstance(getattr(r.g, f.name), torch.Tensor)})
    on_cpu = bucketing.refine_level(g_cpu, r.pos0.cpu(), r.sched,
                                    seed=r.seed, **cfg_kw)
    vm = r.g.vmask.cpu()
    dist = lambda a, b: float((a.cpu() - b.cpu()).abs().amax(dim=1)[vm]
                              .mean())
    pairs = [dist(a, b) for j, a in enumerate(runs) for b in runs[j + 1:]]
    to_lane = [dist(lane, x) for x in runs]
    to_cpu = [dist(on_cpu, x) for x in runs]
    floor = _spread_floor(runs[0], r.g.vmask)
    spread = max(float(np.median(pairs)), float(np.median(to_cpu)), floor)
    row = dict(batched_vs_single=label, mode=mode, n_pad=r.g.n_pad,
               lanes=g["lanes"], iterations=k,
               batched_distance=float(np.median(to_lane)),
               single_spread=float(np.median(pairs)),
               single_to_cpu=float(np.median(to_cpu)),
               batched_to_cpu=dist(lane, on_cpu), spread_floor=floor,
               bound=2 * spread)
    print(json.dumps(row), flush=True)
    if row["batched_distance"] > row["bound"]:
        raise AssertionError(f"batched vs single step: {row}")
    return row


def many_suite(label, graphs, cfg, *, kernels=None, engines=None,
               weights=None, cre_too=False, single_step_mode=None) -> dict:
    """Phase 7 for one suite: ``multigila_layout_many`` cold (cache
    cleared) and warm, a warm run profiled (with ``cre_too`` the one with
    the seeds moved, else one more), then the same graphs through
    warm sequential ``multigila_layout`` calls; each lane against its
    sequential run (``_lanes_against``), the groups' bits repeated, and the
    speed of both. With ``cre_too``, the lanes' CRE too, held to a bound
    set from the warm run against one with every seed moved by SPREAD_SEED
    (CRE's spread over the seed on the card; the cold run against the warm
    one is printed beside it), and ``cre_card`` is checked against the
    host's count on one lane."""
    import torch
    from repro_torch.core import bucketing
    from repro_torch.core import multigila_layout_many
    from repro_torch.graphs.metrics import cre

    runs = {}
    bucketing.STEP_CACHE.clear()
    torch.cuda.empty_cache()
    runs["cold"] = _batched_run(f"{label}_batched_cold", graphs, cfg,
                                engines=engines, weights=weights,
                                kernels=kernels)
    runs["warm"] = _batched_run(f"{label}_batched_warm", graphs, cfg,
                                engines=engines, weights=weights,
                                requests=True)
    prof = None if cre_too else profile_run(lambda: multigila_layout_many(
        graphs, cfg, engines=engines, weights=weights))
    # the single-graph entries warmed by the first graph, then timed
    _sequential_run(f"{label}_sequential_warm_up", graphs[:1], cfg,
                    engines=engines, weights=weights and weights[:1])
    runs["seq"] = _sequential_run(f"{label}_sequential", graphs, cfg,
                                  engines=engines, weights=weights)
    spread = cold_warm = None
    if cre_too:
        moved = _batched_run(f"{label}_batched_seeds_moved", graphs, cfg,
                             engines=engines, weights=weights,
                             seeds=[cfg.seed + SPREAD_SEED] * len(graphs),
                             profiled=True)
        prof = moved["profile"]
        spread = _cre_gaps(f"{label}_cre_seed_spread", graphs, runs["warm"],
                           moved)
        del moved
        cold_warm = _cre_gaps(f"{label}_cre_cold_vs_warm", graphs,
                              runs["cold"], runs["warm"])
    lanes = _lanes_against(label, graphs, runs["warm"], runs["seq"],
                           cre_spread=spread and spread["median_abs"])
    if cre_too:
        lanes["cre_seed_spread"] = spread
        lanes["cre_cold_vs_warm"] = cold_warm
        e, _ = graphs[0]
        pos = runs["warm"]["outs"][0][0]
        if abs(cre_card(pos, e) - cre(pos, e)) > 1e-3:
            raise AssertionError(f"{label}: cre_card {cre_card(pos, e)}, "
                                 f"host {cre(pos, e)}")
    repeats = _repeats_its_bits(label, runs["warm"])
    single = (batched_vs_single_step(label, runs["warm"], single_step_mode)
              if single_step_mode else None)
    w, s = runs["warm"], runs["seq"]
    res = dict(suite=label, graphs=len(graphs), wall_s=w["wall_s"],
               graphs_per_s=w["graphs_per_s"],
               sequential_wall_s=s["wall_s"],
               sequential_graphs_per_s=s["graphs_per_s"],
               speedup=s["wall_s"] / w["wall_s"], launches=w["launches"],
               sequential_launches=s["launches"], waves=w["waves"],
               groups_per_wave=w["groups_per_wave"],
               profile_batched_warm=prof, lanes=lanes,
               groups_repeated=len(repeats), single_step=single,
               cold={k: runs["cold"][k] for k in ("wall_s", "phase_s",
                                                  "cache", "peak_gb")})
    print(json.dumps(res), flush=True)
    return dict(res, runs=runs)


def _lane_force_case(name, args, consts, live):
    """(kernel call, plain call, one-lane call of lane b, bytes, pairs) of
    one force kernel over lanes, the bound's bytes and pairs counting the
    ``live`` lanes (a group's dead lanes replicate lane 0)."""
    import torch
    from repro_torch.kernels.grid_force import ops as grid_ops
    from repro_torch.kernels.grid_force.ref import (grid_far_lanes_ref,
                                                    grid_near_lanes_ref)
    from repro_torch.kernels.nbody.ops import nbody_repulsion
    from repro_torch.kernels.nbody.ref import nbody_repulsion_lanes_ref
    from repro_torch.kernels.neighbor_force.ops import neighbor_repulsion
    from repro_torch.kernels.neighbor_force.ref import \
        neighbor_repulsion_lanes_ref

    n = args[0].shape[1]
    if name == "nbody":
        pos, mass, vmask = args
        fn, plain = nbody_repulsion, nbody_repulsion_lanes_ref
        nv = vmask[:live].sum(dim=1)
        nbytes, pairs = 21 * n * live, int((nv * nv).sum())
        shared = ()
    elif name == "neighbor_force":
        pos, mass, nbr_idx, nbr_mask, vmask = args
        fn, plain = neighbor_repulsion, neighbor_repulsion_lanes_ref
        K = nbr_idx.shape[2]
        nv = int(vmask[:live].sum())
        nbytes = 21 * n * live + 5 * nv * K
        pairs = int((nbr_mask & vmask[..., None])[:live].sum())
        shared = ()
    elif name == "grid_near":
        pos, mass, vmask, bucket, table = args
        args = args[:4]
        shared = (table,)
        fn = lambda *a: grid_ops.grid_near(*a[:4], table, a[-1])
        plain = lambda *a: grid_near_lanes_ref(*a[:4], table, a[-1])
        nc, cap = bucket.shape[1] - 1, bucket.shape[2]
        nbytes = live * (21 * n + 4 * (nc + 1) * cap) + 36 * (nc + 1)
        pairs = sum(_near_pairs(bucket[b], table, n) for b in range(live))
    else:
        pos, cells = args
        fn, plain = grid_ops.grid_far, grid_far_lanes_ref
        nc = cells.shape[1]
        nbytes, pairs = live * (16 * n + 12 * nc), live * n * nc
        shared = ()
    f = lambda: fn(*args, consts)
    p = lambda: plain(*args, consts)
    one = lambda b: fn(*(a[b] for a in args), consts[b])
    return f, p, one, nbytes, pairs


def lane_rows(cases, launches) -> list:
    """Phase 3d: each lane kernel on the arguments of its first call at each
    batched group shape of phase 7 (``ManyRecorder(kernels=...)``): against
    its plain version within phase 3's tolerance, against B one-lane calls
    bit for bit, against itself, then timed as phase 3 times a row: ``ms``
    by graph replay, ``eager_ms``, the plain version's ms and, beside them,
    ``one_lane_ms``: lane 0 alone at the same shape. ``launches`` maps a
    case's key to its launches in the suite's warm batched run, as the
    wrappers counted them by shape (``_build.shape_launches``)."""
    import torch
    rows = []
    for key, (args, consts, grp) in sorted(cases.items(),
                                           key=lambda kv: str(kv[0])):
        name, B, n = key[:3]
        live = grp["live"]
        f, p, one, nbytes, pairs = _lane_force_case(name, args, consts, live)
        out, again = f(), f()
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"{key}: two calls differ")
        for b in range(B):
            if not torch.equal(out[b], one(b)):
                raise AssertionError(f"{key}: lane {b} differs from the "
                                     f"lane alone")
        err = _compare(name, out, p())
        calls, replays, eager, plain_reps = _REPS[name]
        ms = _graph_ms(f, calls, replays)
        one_ms = _graph_ms(lambda: one(0), calls, replays)
        eager_ms = _per_call_ms(f, eager)
        plain_ms = _per_call_ms(p, 1, batches=1)
        bound, by = _bound_ms(nbytes, FLOPS_PER_PAIR * pairs)
        source, replaces = _FORCE_KERNELS[name]
        more = {"neighbor_force": lambda k: f", K {k[3]}",
                "grid_near": lambda k: f", G {round((k[3] - 1) ** 0.5)}, "
                                       f"cap {k[4]}",
                "grid_far": lambda k: f" × {k[3]} cells"}.get(
                    name, lambda k: "")(key)
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=launches.get(key, 0), max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=None, inputs="lanes",
                   shape=f"{B} lanes ({live} live) × n_pad {n}{more}",
                   eager_ms=eager_ms)
        extra = dict(pairs=pairs, one_lane_ms=one_ms,
                     lanes_equal_one_lane_calls=True)
        if name != "nbody":
            extra["mufu_ms"] = pairs / MUFU_PER_S * 1e3
        print(json.dumps(dict(row, **extra, tol=dict(
            rtol=RTOL, atol_frac_of_max=ATOL_FRAC))), flush=True)
        rows.append(row)
    return rows


def many_card() -> dict:
    """Phase 5d's card side: the first LANES_5D graphs of suite A with
    exact_threshold=64, grid_threshold=512 (all three modes) through
    ``multigila_layout_many`` on the card (and again with every seed moved
    by SPREAD_SEED) and through the sequential driver; each batched lane
    against its sequential run: hierarchy equal bit for bit, NELD within
    NELD_DELTA, CRE within max(CRE_DELTA, CRE_SPREAD_MULT × the median
    gap between the card's batched runs with the seeds as given and
    moved)."""
    from repro_torch.core import LayoutConfig
    graphs = _suite(LANES_5D, SUITE_A[1], SUITE_A[2])
    cfg = LayoutConfig(exact_threshold=64, grid_threshold=512)
    card = _batched_run("many_5d_card", graphs, cfg)
    moved = _batched_run("many_5d_card_seeds_moved", graphs, cfg,
                         seeds=[cfg.seed + SPREAD_SEED] * len(graphs))
    modes = {m for _, s in card["outs"] for m in s.level_modes}
    if modes != {"exact", "neighbor", "grid"}:
        raise AssertionError(f"phase 5d: modes {modes}")
    spread = _cre_gaps("many_5d_card_seed_spread", graphs, card,
                       moved)["median_abs"]
    seq = _sequential_run("many_5d_card_sequential", graphs, cfg)
    _lanes_against("many_5d_card_vs_card_sequential", graphs, card, seq,
                   cre_spread=spread)
    return dict(graphs=graphs, card=card, seq=seq, spread=spread)


def many_card_vs_cpu(card, cpu) -> dict:
    """Phase 5d against the CPU (``CpuRefs``' "5d", the same batched run
    on the CPU): each lane's hierarchy equal bit for bit and NELD within
    NELD_DELTA, for the batched and the sequential driver on the card.
    Against the CPU each driver's lanes' mean CRE is held
    (``_lanes_against``) and each lane printed: the card's arithmetic
    moves one lane's CRE from the CPU's by 0.10–0.18 under either driver
    while two card runs differ by at most 0.06 there (``ROADMAP.md`` queue
    3)."""
    import types
    graphs, spread = card["graphs"], card["spread"]
    cpu = dict(outs=cpu["outs"],
               rec=types.SimpleNamespace(hierarchies=cpu["hierarchies"]))
    _lanes_against("many_5d_card_sequential_vs_cpu", graphs, card["seq"],
                   cpu, cre_spread=spread, lane_cre=False)
    return _lanes_against("many_5d_card_vs_cpu", graphs, card["card"], cpu,
                          cre_spread=spread, lane_cre=False)


def many_phase() -> tuple:
    """Phase 7 (suites A and B), then 3d on the shapes it launched. Returns
    (suite results, lane rows)."""
    import dataclasses

    from repro_torch.core import LayoutConfig
    cfg = LayoutConfig()
    cases, out = {}, {}
    a = _suite(*SUITE_A)
    out["A_gila"] = many_suite("suite_A_gila", a, cfg, kernels=cases,
                               cre_too=True, single_step_mode="neighbor")
    launches = dict(out["A_gila"]["runs"]["warm"]["shape_counts"])
    a = a[:SUITE_A_STRESS]
    out["A_stress"] = many_suite(
        "suite_A_stress", a, cfg, engines=["stress"] * len(a),
        weights=_suite_weights(a), cre_too=True)
    del a
    b = _suite(*SUITE_B)
    b_cases = {}
    out["B_gila"] = many_suite("suite_B_gila", b, cfg, kernels=b_cases,
                               single_step_mode="grid")
    b_cases = {k: v for k, v in b_cases.items() if k not in cases}
    launches.update({k: c for k, c in out["B_gila"]["runs"]["warm"]
                     ["shape_counts"].items() if k in b_cases})
    cases.update(b_cases)
    kernels = {k[0] for k in cases}
    if kernels != set(_FORCE_KERNELS):
        raise AssertionError(f"phase 7 launched only {kernels} over lanes")
    with phase("3d"):
        rows = lane_rows(cases, launches)
    return out, rows


# -- phase 8: serving on the card --------------------------------------------

# the serve CLI's defaults (``launch/serve.py``)
PYR_CAPS = dict(tile_cap=64, edge_cap=96, max_zoom=8)
QUERIES, QUERY_BATCHES = 512, (1, 16, 64)
N_STORE = 100_000                     # the serve CLI's documented example
# the continuous engine's trace: ``benchmarks/service_bench.py``'s mix
# (delaunay minnows of 90 and 120 vertices, a 420-vertex whale every 6th
# request, graph i from seed 2000 + i), Poisson arrivals from seed 17
SERVICE_REQS, SERVICE_HZ, SERVICE_LANES = 60, 6.0, 16
MINNOWS, WHALE, WHALE_EVERY = (90, 120), 420, 6


def _export_levels(exp) -> list:
    return [(lv.n, lv.edges, lv.parent, lv.rep) for lv in exp.levels]


def _assert_levels_equal(label, got, want) -> None:
    """Two exports' levels: n, and edges, parent and rep bit for bit."""
    import numpy as np
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} levels, {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a[0] != b[0] or not all(
                (x is None and y is None) or (
                    x is not None and y is not None and x.dtype == y.dtype
                    and np.array_equal(x, y)) for x, y in zip(a[1:], b[1:])):
            raise AssertionError(f"{label}: level {i} differs")


def _assert_pyramids_equal(label, a, b) -> None:
    import numpy as np
    if not (np.array_equal(a.lo, b.lo) and np.array_equal(a.hi, b.hi)
            and len(a.bands) == len(b.bands)):
        raise AssertionError(f"{label}: boxes or band counts differ")
    for i, (x, y) in enumerate(zip(a.bands, b.bands)):
        if (x.zoom, x.level, x.n, x.m) != (y.zoom, y.level, y.n, y.m):
            raise AssertionError(f"{label}: band {i} metadata differs")
        for f in ("tile_vid", "tile_rep", "tile_pos", "tile_mass",
                  "tile_count", "tile_total", "tile_eid", "tile_epos",
                  "tile_ecount"):
            u, v = getattr(x, f), getattr(y, f)
            if u.dtype != v.dtype or u.tobytes() != v.tobytes():
                raise AssertionError(f"{label}: band {i} {f} differs")


def _assert_queries_exact(label, pyr, out, boxes, zs, i0=0) -> None:
    """Each request of a batched result equals ``reference_resolve``, bit
    for bit."""
    from repro_torch.serve import reference_resolve, trim_result
    for i in range(len(zs)):
        got = trim_result(out, i)
        want = reference_resolve(pyr, boxes[i], int(zs[i]))
        if (got["band"], got["covered"]) != (want["band"], want["covered"]):
            raise AssertionError(f"{label}: request {i0 + i} band/cover")
        for k in ("vid", "rep", "inside", "eid", "tiles", "vpos", "epos",
                  "vmass"):
            if (got[k].shape != want[k].shape
                    or got[k].tobytes() != want[k].tobytes()):
                raise AssertionError(f"{label}: request {i0 + i} {k}")


def export_and_pyramid(edges, n, ref_levels) -> tuple:
    """Phase 8a: ``multigila_layout(export=True)`` of the main path's graph,
    warm: its levels equal those ``_build_export`` derives on the host from
    phase 4's hierarchy; the pyramid binned on the card equals the one
    binned on the CPU, array for array."""
    import torch
    from repro_torch.core import LayoutConfig, multigila_layout
    from repro_torch.serve import build_pyramid
    cfg = LayoutConfig()
    multigila_layout(edges, n, cfg)                   # warm the cache
    t0 = time.perf_counter()
    pos, stats, exp = multigila_layout(edges, n, cfg, export=True)
    layout_s = time.perf_counter() - t0
    _assert_levels_equal("phase 8a export", _export_levels(exp), ref_levels)
    if exp.pos.shape != (n, 2) or exp.pos.tobytes() != pos.tobytes():
        raise AssertionError("phase 8a: export pos is not the layout's")
    t0 = time.perf_counter()
    pyr = build_pyramid(exp, **PYR_CAPS)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = build_pyramid(exp, **PYR_CAPS, device="cpu")
    cpu_build_s = time.perf_counter() - t0
    _assert_pyramids_equal("phase 8a pyramid card vs CPU", pyr, cpu)
    torch.cuda.synchronize()
    bands = [dict(zoom=b.zoom, n=b.n, m=b.m,
                  overfull=int((b.tile_total > b.tile_count).sum()))
             for b in pyr.bands]
    res = dict(export_layout_s=layout_s, levels=[lv[0] for lv in ref_levels],
               levels_equal=True, pyramid_build_s=build_s,
               pyramid_build_cpu_binning_s=cpu_build_s, bands=bands,
               card_equals_cpu=True)
    print(json.dumps({"serve_8a": res}), flush=True)
    return pyr, res


def query_phase(pyr, card: str) -> dict:
    """Phase 8b: ``QueryEngine`` on the card over the 1M pyramid, QUERIES
    ``random_viewports(seed=0)`` at each batch size after ``warmup``: every
    request bit-equal to ``reference_resolve``; p50/p99 ms and queries/s
    (host clock around each batch, results on the host). Then a
    ``MicroBatcher`` over the same engine with 4 concurrent submitters."""
    import threading

    import numpy as np
    from repro_torch.serve import MicroBatcher, QueryEngine
    from repro_torch.serve.query import random_viewports
    eng = QueryEngine(pyr)
    zoom_max = max(b.zoom for b in pyr.bands)
    boxes, zs = random_viewports(pyr.lo, pyr.hi, zoom_max, QUERIES, seed=0)
    eng.warmup(QUERY_BATCHES)
    rows = []
    for B in QUERY_BATCHES:
        lat, outs = [], []
        t_start = time.perf_counter()
        for i in range(0, QUERIES, B):
            t0 = time.perf_counter()
            outs.append(eng.query(boxes[i:i + B], zs[i:i + B]))
            lat.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_start
        for j, out in enumerate(outs):
            _assert_queries_exact(f"phase 8b B={B}", pyr, out,
                                  boxes[j * B:(j + 1) * B],
                                  zs[j * B:(j + 1) * B], j * B)
        per_req = np.repeat(lat, B)
        rows.append(dict(batch=B, requests=QUERIES, qps=QUERIES / total,
                         p50_ms=float(np.percentile(per_req, 50) * 1e3),
                         p99_ms=float(np.percentile(per_req, 99) * 1e3),
                         exact=True, card=card))
    mb = MicroBatcher(eng, max_batch=64, window_s=0.002)
    futs = [None] * QUERIES

    def submitter(k):
        for i in range(k, QUERIES, 4):
            futs[i] = mb.submit(boxes[i], int(zs[i]))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = [f.result(timeout=120) for f in futs]
    mb_s = time.perf_counter() - t0
    mb.close()
    from repro_torch.serve import reference_resolve
    for i, r in enumerate(got):
        want = reference_resolve(pyr, boxes[i], int(zs[i]))
        if any(r[k].tobytes() != want[k].tobytes()
               for k in ("vid", "rep", "eid", "vpos", "epos")):
            raise AssertionError(f"phase 8b micro-batcher: request {i}")
    res = dict(rows=rows, micro_batcher=dict(
        submitters=4, requests=mb.requests, batches=mb.batches,
        wall_s=mb_s, qps=QUERIES / mb_s, exact=True))
    print(json.dumps({"serve_8b": res}), flush=True)
    return res


def store_round_trip() -> dict:
    """Phase 8c: delaunay(N_STORE) laid out with its export on the card,
    its pyramid built at the serve CLI's defaults, ``save_pyramid`` →
    ``load_pyramid(validate=True)``: the loaded pyramid equals the one in
    memory, and so do its query results, bit for bit."""
    import tempfile

    from repro_torch.core import LayoutConfig, multigila_layout
    from repro_torch.graphs import generators
    from repro_torch.serve import (QueryEngine, build_pyramid, load_pyramid,
                                   save_pyramid)
    from repro_torch.serve.query import random_viewports
    e, n = generators.delaunay(N_STORE, seed=0)
    _, _, exp = multigila_layout(e, n, LayoutConfig(), export=True)
    pyr = build_pyramid(exp, **PYR_CAPS)
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "pyr")
        t0 = time.perf_counter()
        save_pyramid(path, pyr)
        save_s = time.perf_counter() - t0
        shards = len(list(Path(path).iterdir())) - 1
        t0 = time.perf_counter()
        loaded = load_pyramid(path, validate=True)
        load_s = time.perf_counter() - t0
    _assert_pyramids_equal("phase 8c store round trip", loaded, pyr)
    boxes, zs = random_viewports(pyr.lo, pyr.hi,
                                 max(b.zoom for b in pyr.bands), 256, seed=1)
    a = QueryEngine(pyr).query(boxes, zs)
    b = QueryEngine(loaded).query(boxes, zs)
    if any(a[k].tobytes() != b[k].tobytes() for k in a):
        raise AssertionError("phase 8c: loaded pyramid answers differently")
    res = dict(graph=f"delaunay({N_STORE})", bands=len(pyr.bands),
               shards=shards, save_s=save_s, load_validate_s=load_s,
               equal=True)
    print(json.dumps({"serve_8c": res}), flush=True)
    return res


def _service_workload() -> list:
    from repro_torch.graphs import generators
    return [generators.delaunay(
        WHALE if i % WHALE_EVERY == 3 else MINNOWS[i % len(MINNOWS)],
        seed=2000 + i) for i in range(SERVICE_REQS)]


def _warm_engine_buckets(graphs, seeds, cfg) -> int:
    """Warm every (group key, lane bucket) the engine can reach on these
    graphs: walk them through a ``WaveScheduler`` whose dispatch records
    one request a group key, then run each key at both lane buckets the
    engine's cap allows (8 and SERVICE_LANES). Returns the keys."""
    from repro_torch.core import WaveScheduler, bucketing
    one = {}

    def record(reqs):
        for r in reqs:
            one.setdefault(bucketing.group_key(r), r)
        return [r.pos0 for r in reqs]

    sched = WaveScheduler(cfg, dispatch=record)
    t0 = time.perf_counter()
    for (e, n), s in zip(graphs, seeds):
        sched.admit(e, n, seed=s)
    sched.drain()
    print(json.dumps({"serve_8d_keys": dict(
        keys=[list(map(str, k)) for k in one],
        seconds=time.perf_counter() - t0)}), flush=True)
    for r in one.values():
        for lanes in (8, SERVICE_LANES):
            bucketing.refine_level_many([r] * lanes, ideal_len=cfg.ideal_len,
                                        rep_const=cfg.rep_const)
    return len(one)


def continuous_engine(card: str) -> dict:
    """Phase 8d: ``ContinuousLayoutService`` on the card, open loop: the
    seeded Poisson trace of SERVICE_REQS requests of the service mix at
    SERVICE_HZ, ``max_lanes`` SERVICE_LANES, the process tracer on. Every
    request completes and holds to its dedicated call
    (``launch.service.hold_to_dedicated``: hierarchy bit-equal, NELD
    within NELD_DELTA; CRE held to its spread over the seed, no more
    requests past max(CRE_DELTA, CRE_SPREAD_MULT × the median seed gap)
    than seed gaps are, and the mean as phase 7 holds it); no step-cache
    miss after the warm-up; the trace's ``wave`` spans number
    ``gila_waves_total``'s increase. p50/p99 latency (submit to result,
    host clock) and completed/s."""
    import numpy as np
    from repro_torch.core import LayoutConfig, bucketing
    from repro_torch.launch.service import hold_to_dedicated
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.engine import (ContinuousLayoutService,
                                          poisson_trace)
    cfg = LayoutConfig(seed=0)
    graphs = _service_workload()
    events = poisson_trace(SERVICE_HZ, SERVICE_REQS,
                           lambda i, rng: graphs[i], seed=17)
    t0 = time.perf_counter()
    keys = _warm_engine_buckets(graphs, [ev.seed for ev in events], cfg)
    warm_s = time.perf_counter() - t0
    print(json.dumps({"serve_8d_warm": dict(keys=keys, seconds=warm_s)}),
          flush=True)
    before = bucketing.cache_stats()
    waves = obs_metrics.REGISTRY.get("gila_waves_total")
    w0 = waves.value()
    obs_trace.reset()
    obs_trace.enable()
    svc = ContinuousLayoutService(cfg, max_lanes=SERVICE_LANES)
    reqs, lat = [], [None] * len(events)
    try:
        t_start = time.perf_counter()
        for i, ev in enumerate(events):
            dt = t_start + ev.t - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            t_sub = time.perf_counter()
            req = svc.submit(ev.edges, ev.n, seed=ev.seed)
            req.future.add_done_callback(
                lambda _f, i=i, t_sub=t_sub:
                    lat.__setitem__(i, time.perf_counter() - t_sub))
            reqs.append(req)
        results = [r.result(600) for r in reqs]
        wall = time.perf_counter() - t_start
    finally:
        svc.close()
        obs_trace.disable()
    after = bucketing.cache_stats()
    events_json = obs_trace.get_tracer().to_dict()["traceEvents"]
    wave_spans = sum(e["name"] == "wave" for e in events_json)
    obs_trace.reset()
    if after["misses"] != before["misses"]:
        raise AssertionError(f"phase 8d: {after['misses'] - before['misses']}"
                             f" cache misses after the warm-up")
    if wave_spans != waves.value() - w0:
        raise AssertionError(f"phase 8d: {wave_spans} wave spans, "
                             f"{waves.value() - w0} waves counted")
    stats = svc.stats()
    if stats["completed"] != SERVICE_REQS:
        raise AssertionError(f"phase 8d: {stats['completed']} completed")
    t0 = time.perf_counter()
    parity = hold_to_dedicated(
        [(ev.edges, ev.n, ev.seed, pos, r.job)
         for ev, (pos, _), r in zip(events, results, reqs)], cfg, None)
    parity["seconds"] = time.perf_counter() - t0
    res = dict(requests=SERVICE_REQS, rate_hz=SERVICE_HZ,
               max_lanes=SERVICE_LANES, warm_keys=keys, warm_s=warm_s,
               wall_s=wall, completed_per_s=SERVICE_REQS / wall,
               p50_ms=float(np.percentile(lat, 50) * 1e3),
               p99_ms=float(np.percentile(lat, 99) * 1e3),
               waves=wave_spans, cache_misses=0,
               straggler_waves=stats["straggler_waves"], parity=parity,
               card=card)
    print(json.dumps({"serve_8d": res}), flush=True)
    return res


def http_front_door() -> dict:
    """Phase 8e: ``launch/service.py``'s ``smoke()`` on the card: 3 graphs
    over HTTP, each held to its dedicated call, ``/stats`` and
    ``/metrics`` read, and the ``--trace`` file written and parsed."""
    import tempfile

    from repro_torch.launch.service import smoke
    with tempfile.TemporaryDirectory() as d:
        res = smoke(None, str(Path(d) / "trace.json"))
    print(json.dumps({"serve_8e": res}), flush=True)
    return res


def serving_phase(edges, n, ref_levels, card: str) -> dict:
    """Phase 8, serving on the card: 8a-8e, each timed."""
    import torch
    out, secs = {}, {}
    t = time.perf_counter()
    pyr, out["8a"] = export_and_pyramid(edges, n, ref_levels)
    secs["8a"] = time.perf_counter() - t
    t = time.perf_counter()
    out["8b"] = query_phase(pyr, card)
    secs["8b"] = time.perf_counter() - t
    del pyr
    torch.cuda.empty_cache()
    for key, fn in (("8c", store_round_trip),
                    ("8d", lambda: continuous_engine(card)),
                    ("8e", http_front_door)):
        t = time.perf_counter()
        out[key] = fn()
        secs[key] = time.perf_counter() - t
        print(json.dumps({"serve_seconds": secs}), flush=True)
    PHASE_SECONDS.update(secs)
    return out


# -- phase 9: the sharded driver on a one-rank NCCL mesh ------------------------

# near_field's rows: (calls a CUDA graph, replays, eager calls a batch)
_NEAR_REPS = (5, 5, 10)


class NearFieldInputs:
    """For the length of one run, wraps ``grid_force.ops.near_field`` (what
    the sharded grid step calls): keeps
    the arguments of the first call at each row count (one a grid level)
    and counts the calls at each. The package itself has no hook: the name
    is put back on exit."""

    def __enter__(self):
        from repro_torch.kernels.grid_force import ops as grid_ops
        self.cases, self.calls = {}, {}
        self._real = real = grid_ops.near_field

        def wrapper(rows, near9, cells, consts, **kw):
            R = int(rows.shape[0])
            if R not in self.cases:
                self.cases[R] = (rows.clone(), near9, cells, consts.clone(),
                                 kw)
            self.calls[R] = self.calls.get(R, 0) + 1
            return real(rows, near9, cells, consts, **kw)
        grid_ops.near_field = wrapper
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.grid_force import ops as grid_ops
        grid_ops.near_field = self._real
        return False


def _near_pairs_rows(near9, cnt) -> int:
    """Pairs the row-form near field computes: each row against the valid
    slots of its 9 cells (every column: a one-rank mesh)."""
    return int(cnt[near9.long()].sum())


def _near_field_split(f, calls: int) -> dict:
    """Device ms a call of the op ``f`` spends in its three parts, from a
    profile of ``calls`` eager calls: the pack kernel, the near kernel, and
    the grouping (every other device activity of csrc/near_field.cu: the
    memset and the counting sort's three kernels). Each name's mean over
    the events recorded: a profile on the H100 has kept the events of only
    some of the calls."""
    _, events = _device_events(lambda: [f() for _ in range(calls)])
    split = dict(pack=0.0, grouping=0.0, near=0.0)
    for name, (ms, cnt) in _ms_by_name(events).items():  # once a call each
        part = ("pack" if "nf_pack_kernel" in name else
                "near" if "nf_near_kernel" in name else "grouping")
        split[part] += ms / cnt
    return split


def time_near_field(args, shape, form, launches, per_cell_ms) -> dict:
    """One near_field input: against its plain version and itself (bit for
    bit, and each row bit for bit with the rows permuted), timed as phase 3
    times a row; ``per_cell_ms`` is the per-cell
    ``grid_near`` kernel's device time on the same level's positions."""
    import torch
    from repro_torch.kernels.grid_force import ops as grid_ops
    from repro_torch.kernels.grid_force.ref import near_field_ref
    rows, near9, cells, consts, kw = args
    f = lambda: grid_ops.near_field(rows, near9, cells, consts, **kw)
    p = lambda: near_field_ref(rows, near9, cells, consts[0], consts[1],
                               **kw)
    out, again = f(), f()
    perm = torch.randperm(rows.shape[0], device=rows.device,
                          generator=torch.Generator(rows.device).manual_seed(0))
    shuffled = grid_ops.near_field(rows[perm], near9[perm], cells, consts,
                                   **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"near_field {form}: two calls differ")
    if not torch.equal(shuffled, out[perm]):
        raise AssertionError(f"near_field {form}: rows permuted differ")
    err = _compare("near_field", out, p())
    calls, replays, eager = _NEAR_REPS
    R, ncell, cap = rows.shape[0], cells.shape[0], cells.shape[1]
    if form == "index":
        N = kw["pos"].shape[0]
        cnt = (kw["w"][cells.long()] > 0).sum(dim=1)
        table = 4 * ncell * cap + 12 * N
    else:
        cnt = (cells[..., 2] > 0).sum(dim=1)
        table = 12 * ncell * cap
    pairs = _near_pairs_rows(near9, cnt)
    rows_of = torch.bincount(near9[:, 4].long(), minlength=ncell)[:-1]
    bound, by = _bound_ms(52 * R + table, FLOPS_PER_PAIR * pairs)
    row = dict(name="near_field", route="cuda",
               source="src/repro_torch/kernels/grid_force/csrc/near_field.cu",
               replaces="src/repro/kernels/grid_force/kernel.py:45",
               launches=launches, max_abs_err=err,
               ms=_graph_ms(f, calls, replays),
               plain_ms=_per_call_ms(p, 1, batches=1), bound_ms=bound,
               bound_by=by, library_ms=None, inputs=f"path, {form} form",
               shape=_shape_label(shape), eager_ms=_per_call_ms(f, eager))
    print(json.dumps(dict(row, pairs=pairs, mufu_ms=pairs / MUFU_PER_S * 1e3,
                          grid_near_per_cell_ms=per_cell_ms,
                          cells_over_cap=int((rows_of > cap).sum()),
                          rows_over_cap=int((rows_of - cap).clamp_min(0)
                                            .sum()),
                          split_ms=_near_field_split(f, eager),
                          plain_grouping_ms=_graph_ms(
                              lambda: grid_ops.group_rows(near9, ncell),
                              calls, replays),
                          tol=dict(rtol=RTOL, atol_frac_of_max=ATOL_FRAC))),
          flush=True)
    return row


def near_field_rows(mesh, rec, level_of, launches_of) -> list:
    """Phase 9a: near_field on the arguments of its first call at each grid
    level of the warm 1M run (the all-gather variant's index form), and on
    the halo variant's direct form built from the same positions (a one-rank
    mesh: the band is the whole grid, the halo rows empty), each beside the
    per-cell grid_near kernel on the same level's replicated arrays."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels.grid_force import ops as grid_ops
    out = []
    for R, (rows, near9, cells, consts, kw) in sorted(rec.cases.items(),
                                                     reverse=True):
        level, n_valid = level_of[R]
        pos_p, w_p = kw["pos"], kw["w"]
        w_blk = w_p[:-1]
        ncell, cap = cells.shape[0], cells.shape[1]
        G = int(round((ncell - 1) ** 0.5))
        shape = dict(level=level, n=n_valid, n_pad=R, G=G, cap=cap)
        table = grid_ops.neighbor_table(G, rows.device)
        per_cell = lambda: grid_ops.grid_near(rows, w_blk, w_blk > 0, cells,
                                              table, consts)
        per_cell_ms = _graph_ms(per_cell, 10, 10)
        out.append(time_near_field((rows, near9, cells, consts, kw), shape,
                                   "index", launches_of[R], per_cell_ms))
        lo, hi = D._box(mesh, rows, w_blk > 0)
        bins = D._halo_binning(mesh, rows, w_blk, lo, hi, G, cap)
        near9_h, ext = D._halo_near(mesh, rows, w_blk, *bins, G, cap)
        col0, ncols = D._near_columns(mesh, cap)
        out.append(time_near_field((rows, near9_h, ext, consts,
                                    dict(col0=col0, ncols=ncols)), shape,
                                   "direct", 0, per_cell_ms))
        del near9_h, ext, bins
        torch.cuda.empty_cache()
    return out


def sync_free_loop(mesh, edges, n, level) -> dict:
    """The refine loop of one grid level of the 1M hierarchy, staged through
    ``distributed.prepare_level`` from drawn positions on a warm cache
    entry, run under ``torch.cuda.set_sync_debug_mode("error")``: any host
    sync in it raises."""
    import torch
    from repro_torch.core import LayoutConfig, distributed as D, gila
    from repro_torch.core.multilevel import _schedule
    cfg = LayoutConfig(driver="multigila_dist", mesh_shape=(1, 1))
    (graphs, _), _ = _hierarchy(edges, n, cfg, "cuda")
    g = graphs[level]
    sched = _schedule(cfg, level, len(graphs), g)
    if sched.mode != "grid":
        raise AssertionError(f"level {level} is {sched.mode}")
    pos0 = gila.random_init(g, max(g.n, 4) ** 0.5, seed=level)
    run = D.prepare_level(mesh, g, pos0, sched, ideal_len=1.0, rep_const=1.0)
    if run.fresh:
        raise AssertionError("sync-free loop: a cold cache entry")
    torch.cuda.synchronize()
    start = run.pos.clone()
    t0 = time.perf_counter()
    with _sync_debug_error():
        run.iterate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pos = run.gather()
    if not bool(torch.isfinite(pos).all()) or torch.equal(run.pos, start):
        raise AssertionError("sync-free loop: positions not finite/unmoved")
    res = dict(sync_free_loop=f"level {level}: {g.n} of {g.n_pad}",
               iterations=run.iters, wall_s=wall, sync_debug_mode="error")
    print(json.dumps(res), flush=True)
    return res


def _dist_cases(cfg5) -> tuple:
    """Phase 9c's cases: (name, config, weighted)."""
    import dataclasses
    base = dataclasses.replace(cfg5, driver="multigila_dist",
                               mesh_shape=(1, 1))
    return (("gila", base, False),
            ("stress_weighted", dataclasses.replace(base, engine="stress"),
             True))


def dist_card_vs_cpu(e5, n5, cfg5, refs) -> dict:
    """Phase 9c: the sharded driver on phase 5's graph (all three modes),
    mesh 1x1, gila then stress with phase 5b's weights, on the card (NCCL)
    against the CPU (``CpuRefs``' "9c:…", over a one-rank gloo group of the
    worker's own): the hierarchy equal bit for bit (``ewt`` included),
    levels and modes equal, NELD and CRE within phase 5's deltas."""
    import numpy as np
    from repro_torch.core import multigila_layout
    from repro_torch.graphs.metrics import cre, neld
    w5 = _weights5(e5)
    res = {}
    for name, cfg, weighted in _dist_cases(cfg5):
        w = w5 if weighted else None
        h = refs.get(f"9c:{name}")
        _assert_hierarchies_equal(
            f"dist {name} delaunay({n5})",
            _hierarchy(e5, n5, cfg, "cuda", w)[0], h["hierarchy"])
        t0 = time.perf_counter()
        p_card, s_card = multigila_layout(e5, n5, cfg, weights=w)
        card_s = time.perf_counter() - t0
        s_cpu = h["stats"]
        if not np.isfinite(p_card).all():
            raise AssertionError(f"dist {name} on the card: non-finite")
        if (s_card.level_sizes, s_card.level_modes) != (s_cpu.level_sizes,
                                                        s_cpu.level_modes):
            raise AssertionError(f"dist {name}: levels differ")
        q = {"cuda": (neld(p_card, e5), cre(p_card, e5)),
             "cpu": h["neld_cre"]}
        row = dict(level_sizes=s_card.level_sizes,
                   level_modes=s_card.level_modes, neld_cre=q,
                   card_s=card_s, cpu_s=h["cpu_s"], hierarchy_equal=True,
                   gaps=dict(neld=q["cuda"][0] - q["cpu"][0],
                             cre=q["cuda"][1] - q["cpu"][1]))
        print(json.dumps({f"dist_small_{name}": row}), flush=True)
        if (abs(q["cuda"][0] - q["cpu"][0]) > NELD_DELTA
                or abs(q["cuda"][1] - q["cpu"][1]) > CRE_DELTA):
            raise AssertionError(f"dist {name}: quality differs, card vs "
                                 f"CPU: {q}")
        res[name] = row
    return res


# -- the CPU references, computed in CpuRefs' workers ---------------------------

def _cpu_hierarchy_ref(edges, n, cfg, weights=None) -> tuple:
    """(the hierarchy built on the CPU, plain, and its seconds)."""
    h, secs = _hierarchy(edges, n, cfg, "cpu", weights)
    return _plain_hierarchy(h), secs


def _cpu_layout_ref(edges, n, cfg, weights=None, hierarchy=False) -> dict:
    """``multigila_layout`` on the CPU: positions, stats, seconds and
    (NELD, CRE), the hierarchy (plain) first when asked; the sharded
    driver over a one-rank gloo group made here and taken down after."""
    from repro_torch.core import multigila_layout
    from repro_torch.graphs.metrics import cre, neld
    from repro_torch.launch import mesh as mesh_mod
    dist = cfg.driver == "multigila_dist"
    if dist:
        mesh_mod.make_host_mesh(device="cpu")
    try:
        out = {}
        if hierarchy:
            out["hierarchy"] = _cpu_hierarchy_ref(edges, n, cfg, weights)[0]
        t0 = time.perf_counter()
        pos, stats = multigila_layout(edges, n, cfg, weights=weights,
                                      device="cpu")
        out.update(cpu_s=time.perf_counter() - t0, pos=pos, stats=stats,
                   neld_cre=(neld(pos, edges), cre(pos, edges)))
    finally:
        if dist:
            mesh_mod.shutdown()
    return out


def _cpu_many_ref(cfg) -> dict:
    """Phase 5d's batched run on the CPU: positions, stats, hierarchies."""
    graphs = _suite(LANES_5D, SUITE_A[1], SUITE_A[2])
    run = _batched_run("many_5d_cpu", graphs, cfg, device="cpu")
    return dict(outs=run["outs"], hierarchies=[
        _plain_hierarchy(h) for h in run["rec"].hierarchies])


_CPU_REFS = dict(hierarchy=_cpu_hierarchy_ref, layout=_cpu_layout_ref,
                 many=_cpu_many_ref, flat_early=_flat_early,
                 train=lambda *a: _train_cpu_ref(*a),   # phase 10's, below
                 dryrun=lambda *a: _cpu_dryrun_ref(*a))  # phase 9e's


def cpu_ref_tasks(edges, n, weights, e5, n5, cfg5, out_dir) -> dict:
    """The CPU references of phases 4d, 5, 5b, 5d, 9c, 9e and 10b, {name:
    (kind, args)}: 10b's first (their files go to ``out_dir``), then the
    longest first (by their measured seconds; 9e's dry-run counts, a few
    seconds, last)."""
    from repro_torch.core import LayoutConfig
    w5 = _weights5(e5)
    cases = {name: (cfg, w5 if weighted else None, weighted)
             for name, cfg, weighted, _ in _engine_cases(cfg5)}
    tasks = {f"10b:{arch}": ("train", (arch, 2, TRAIN_WIDE_SEQ, out_dir))
             for arch in TRAIN_WIDE}
    tasks["5d"] = ("many", (LayoutConfig(exact_threshold=64,
                                         grid_threshold=512),))
    tasks["5b:centralized"] = ("layout", (e5, n5, *cases["centralized"]))
    tasks["4d"] = ("hierarchy", (edges, n, LayoutConfig(), weights))
    tasks["5b:flat"] = ("layout", (e5, n5, *cases["flat"]))
    tasks["5b:flat_early"] = ("flat_early",
                              (e5, n5, cases["flat"][0], "cpu"))
    tasks["5b:stress_weighted"] = ("layout",
                                   (e5, n5, *cases["stress_weighted"]))
    tasks["5"] = ("layout", (e5, n5, cfg5, None, True))
    for name, cfg, weighted in _dist_cases(cfg5):
        tasks[f"9c:{name}"] = ("layout", (e5, n5, cfg, w5 if weighted
                                          else None, True))
    tasks["9e"] = ("dryrun", (dryrun_card_rows(),))
    return tasks


def dist_cli_on_card() -> dict:
    """Phase 9d: the layout CLI with ``--driver multigila_dist --mesh 1x1``
    in process on the card, on a graph with a grid level."""
    import contextlib
    import io
    from repro_torch.kernels import _build
    from repro_torch.launch import layout as cli
    argv = ["--graph", "delaunay", "--args", "40000", "3", "--driver",
            "multigila_dist", "--mesh", "1x1", "--no-cre"]
    _build.launches.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = cli.main(argv)
    launches = dict(_build.launches)
    if (set(launches) != {"grid_far", "near_field"}
            or not (rep["neld"] == rep["neld"])):
        raise AssertionError(f"dist CLI: launches {launches}, report {rep}")
    res = dict(dist_cli=" ".join(argv), printed=buf.getvalue().splitlines(),
               report=rep, launches=launches)
    print(json.dumps(res), flush=True)
    return res


# phase 9e: the dry run's layout rows run for real at mesh (1, 1). The exact
# row's cut: on one rank ``_exact_rep`` holds [n_pad, n_pad] float32
# intermediates, 17.2 GB each at the suite's 65536 and several live at once
# (the dry run counts 86 GB at its peak), past the card's 80 GB
DRYRUN_EXACT_CARD_N = 16384
DRYRUN_WARM = 5                       # timed warm steps after one cold step
DRYRUN_PARAMS = (1.0, 1.0, 1e-3)      # (C, L, min_dist)
DRYRUN_TEMP = 1.0
# the all-gather row each halo row is held to
DRYRUN_PAIRS = {"halo": "neighbor", "grid_halo": "grid"}
# the rows whose grid kernel calls phase 9e times (``dryrun_kernel_rows``)
DRYRUN_KERNEL_ROWS = ("layout_hugetric_like_grid",
                      "layout_hugetric_like_grid_halo")


def dryrun_card_rows() -> list:
    """[(tag, mode, n_pad, m_pad, cap)]: the dry run's layout rows
    (``launch.dryrun.layout_rows``) at their ``BIG_GRAPH_DRYRUN`` sizes,
    the exact row's n_pad cut to DRYRUN_EXACT_CARD_N."""
    from repro_torch.launch import dryrun
    out = []
    for g, mode in dryrun.layout_rows():
        s = dryrun.BIG_GRAPH_DRYRUN[g]
        n = DRYRUN_EXACT_CARD_N if mode == "exact" else s["n_pad"]
        out.append((f"layout_{g}_{mode}", mode, n, s["m_pad"], s["cap"]))
    return out


def _cpu_dryrun_ref(rows) -> dict:
    """The dry run's own counts of phase 9e's rows at mesh (1, 1): each
    row's step on meta over a one-rank fake group (made here and taken
    down after) under ``roofline.count_ops``: argument bytes, counted peak
    live bytes, FLOPs and HBM bytes."""
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import layout_row_step
    from repro_torch.launch.mesh import make_fake_mesh, shutdown
    from repro_torch.utils.tree import tree_bytes
    mesh = make_fake_mesh((1, 1))
    try:
        out = {}
        for tag, mode, n, m, cap in rows:
            step, args = layout_row_step(mesh, n, m, cap, mode)
            _, cost = RL.count_ops(step, *args.values(),
                                   live=list(args.values()))
            out[tag] = dict(argument_bytes=tree_bytes(args),
                            peak_bytes=cost.peak_bytes, flops=cost.flops,
                            bytes=cost.bytes)
    finally:
        shutdown()
    return out


def _dryrun_base(n: int, m: int, cap: int, seed: int, dev) -> dict:
    """Shape-true random inputs of one graph size, made on the card from a
    seeded ``torch.Generator``: positions uniform in a square of side √n,
    neighbour lists and edge endpoints uniform over the vertices."""
    import math
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    i32 = dict(dtype=torch.int32, device=dev, generator=gen)
    return dict(pos=torch.rand((n, 2), device=dev, generator=gen)
                * math.sqrt(n),
                nbr=torch.randint(0, n, (n, cap), **i32),
                src=torch.randint(0, n, (m,), **i32),
                dst=torch.randint(0, n, (m,), **i32))


def _dryrun_args(specs: dict, base: dict, dev) -> list:
    """A row's inputs in its specs' order, each of its spec's shape and
    dtype, from ``base``: w 1, every edge on with weight 1, one rank's
    ``send_idx`` all sentinel (a one-rank halo has no peer)."""
    import torch
    n = base["pos"].shape[0]
    made = dict(pos=base["pos"], src=base["src"], src_local=base["src"],
                dst_local=base["dst"],
                params=torch.tensor(DRYRUN_PARAMS, device=dev),
                temp=torch.tensor(DRYRUN_TEMP, device=dev))
    out = []
    for name, spec in specs.items():
        if name in made:
            t = made[name]
        elif name in ("nbr_idx", "nbr_local"):
            t = base["nbr"][:, :spec.shape[1]].contiguous()
        elif name == "send_idx":
            t = torch.full(tuple(spec.shape), n, dtype=torch.int32,
                           device=dev)
        else:                                     # w, emask, ewt
            t = torch.ones(tuple(spec.shape), dtype=spec.dtype, device=dev)
        if (tuple(t.shape), t.dtype) != (tuple(spec.shape), spec.dtype):
            raise AssertionError(f"9e {name}: {tuple(t.shape)} {t.dtype}, "
                                 f"spec {tuple(spec.shape)} {spec.dtype}")
        out.append(t)
    return out


def _max_floor(pos) -> float:
    """FLOOR_ULPS float32 ulps of the largest |coordinate| of ``pos``: the
    floor of a spread measured as a largest |Δpos| (``_spread_floor`` is
    that of a mean over the vertices)."""
    import math
    scale = float(pos.abs().max())
    return FLOOR_ULPS * 2.0 ** (math.frexp(scale)[1] - 24)


class GridCallInputs:
    """For the length of a run, wraps ``grid_force.ops.grid_far`` and
    ``near_field`` (what the sharded grid step calls, through the module)
    and keeps the arguments of the first call of each: {name: (args,
    kwargs)}. The names are put back on exit, which raises if a wrapper saw
    no call (a caller that bound the function by name is not seen)."""

    NAMES = ("grid_far", "near_field")

    def __enter__(self):
        from repro_torch.kernels.grid_force import ops as grid_ops
        self.cases, self._real = {}, {}
        for name in self.NAMES:
            real = self._real[name] = getattr(grid_ops, name)

            def wrapper(*args, _name=name, _real=real, **kw):
                if _name not in self.cases:
                    self.cases[_name] = (args, kw)
                return _real(*args, **kw)
            setattr(grid_ops, name, wrapper)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.grid_force import ops as grid_ops
        for name, real in self._real.items():
            setattr(grid_ops, name, real)
        missing = [n for n in self.NAMES if n not in self.cases]
        if exc[0] is None and missing:
            raise AssertionError(
                f"9e: no call of grid_force.ops.{missing} was seen; the "
                "step must call them through the module")
        return False


def _dryrun_kernel_row(name, form, f, p, nbytes, pairs, shape,
                       launches) -> dict:
    """A grid kernel on phase 9e's arguments at ``hugetric_like``'s shape:
    against its plain version (one call, its wall between a synchronize
    and another the plain ms) and itself, timed as device time per call
    (two calls captured, three replays). ``launches``: its count in the
    row of phase 9e that gave the arguments, which must not be 0."""
    import torch
    if not launches:
        raise AssertionError(f"9e {name} {form}: no launch in its row")
    out, again = f(), f()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"9e {name} {form}: two calls differ")
    t0 = time.perf_counter()
    ref = p()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _compare(name, out, ref)
    del ref
    bound, by = _bound_ms(nbytes, FLOPS_PER_PAIR * pairs)
    source = ("src/repro_torch/kernels/grid_force/csrc/near_field.cu"
              if name == "near_field" else _FORCE_KERNELS[name][0])
    row = dict(name=name, route="cuda", source=source,
               replaces=_FORCE_KERNELS["grid_near" if name == "near_field"
                                       else name][1],
               launches=launches, max_abs_err=err, ms=_graph_ms(f, 2, 3),
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               library_ms=None, inputs=f"9e, {form}", shape=shape)
    print(json.dumps(dict(row, pairs=pairs,
                          mufu_ms=pairs / MUFU_PER_S * 1e3,
                          tol=dict(rtol=RTOL, atol_frac_of_max=ATOL_FRAC))),
          flush=True)
    return row


def dryrun_kernel_rows(grid_calls: dict, halo_calls: dict, n: int,
                       grid_launches: dict, halo_launches: dict) -> list:
    """Phase 9e's kernel rows: grid_far and near_field's index form on the
    arguments of their first call in ``hugetric_like``'s grid row, and
    near_field's direct form on those of its grid_halo row; each row's
    launches are its kernel's count in that phase 9e row."""
    from repro_torch.kernels.grid_force import ops as grid_ops
    from repro_torch.kernels.grid_force.ref import (grid_far_ref,
                                                    near_field_ref)
    rows = []
    (pos, cell_xyw, consts), _ = grid_calls["grid_far"]
    nc = cell_xyw.shape[0]
    shape = f"hugetric_like: {n} rows, cells {nc}"
    rows.append(_dryrun_kernel_row(
        "grid_far", "all-gather variant",
        lambda: grid_ops.grid_far(pos, cell_xyw, consts),
        lambda: grid_far_ref(pos, cell_xyw, consts[0], consts[1]),
        16 * n + 12 * nc, n * nc, shape, grid_launches.get("grid_far", 0)))
    for form, (args, kw), counts in (
            ("index", grid_calls["near_field"], grid_launches),
            ("direct", halo_calls["near_field"], halo_launches)):
        r, near9, cells, c = args
        ncell, cap = cells.shape[0], cells.shape[1]
        if form == "index":
            cnt = (kw["w"][cells.long()] > 0).sum(dim=1)
            table = 4 * ncell * cap + 12 * kw["pos"].shape[0]
        else:
            cnt = (cells[..., 2] > 0).sum(dim=1)
            table = 12 * ncell * cap
        rows.append(_dryrun_kernel_row(
            "near_field", f"{form} form",
            lambda: grid_ops.near_field(r, near9, cells, c, **kw),
            lambda: near_field_ref(r, near9, cells, c[0], c[1], **kw),
            52 * r.shape[0] + table, _near_pairs_rows(near9, cnt),
            f"hugetric_like: {n} rows, cap {cap}",
            counts.get("near_field", 0)))
    return rows


def dryrun_layout_card(mesh, refs) -> tuple:
    """Phase 9e: each layout row of the dry run (``dryrun_card_rows``) run
    for real on the card over phase 9's one-rank NCCL mesh, through the
    same ``layout_train_step`` / ``layout_train_step_halo`` on inputs of
    its specs' shapes (``_dryrun_args``: shape-true random data, since the
    dry run checks shapes, not a layout). Per row: one cold step, then
    DRYRUN_WARM warm steps on the same inputs, each between CUDA events
    (the median printed); the peak allocated GB (reset before the cold
    step) and the step's own peak with its inputs (``step_peak_gb``: the
    graph's base arrays that are no input of the row taken out); the
    kernel launches, which must be one
    grid_far and one near_field call a step in the grid rows and none in
    the others; every position finite. Each halo row's positions must lie
    within REPLAY_FACTOR × the all-gather row's own spread of that row's
    (DRYRUN_PAIRS): the largest |Δpos| between two of its steps, floored
    at FLOOR_ULPS ulps of the largest coordinate (``_max_floor``: the
    check compares maxima, and ``_spread_floor`` floors a mean). Beside
    each row, the dry run's own counts at mesh (1, 1) from a CPU worker
    (``_cpu_dryrun_ref``): argument bytes and counted peak, printed, not
    held. The grid kernels are also timed on the arguments of their
    first call in ``hugetric_like``'s grid and grid_halo rows
    (``dryrun_kernel_rows``: rows of the ``{"kernels": [...]}`` line, with
    the launches those rows counted). → ({row: its record}, the kernel
    rows)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import layout_row_step
    dev = mesh.device
    counted = refs.get("9e")
    res, ref_out, spread, recorded, kernel_rows = {}, {}, {}, {}, []
    base_key, base = None, None
    for i, (tag, mode, n, m, cap) in enumerate(dryrun_card_rows()):
        graph = tag[len("layout_"):-len(mode) - 1]
        if base_key != (graph, n):
            base = None
            torch.cuda.empty_cache()
            base_key = (graph, n)
            base = _dryrun_base(n, m, cap, i, dev)
        step, specs = layout_row_step(mesh, n, m, cap, mode)
        args = _dryrun_args(specs, base, dev)
        _build.launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        outs, ms = [], []
        for _ in range(1 + DRYRUN_WARM):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            record = (GridCallInputs() if tag in DRYRUN_KERNEL_ROWS
                      and not outs else contextlib.nullcontext())
            with record:
                a.record()
                out = step(*args)
                b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            if tag in DRYRUN_KERNEL_ROWS and not outs:
                recorded[tag] = record.cases
            if len(outs) < 2:
                outs.append(out)
        launches = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        calls = 1 + DRYRUN_WARM
        want = ({"grid_far": calls, "near_field": calls}
                if mode.startswith("grid") else {})
        if launches != want:
            raise AssertionError(f"9e {tag}: launches {launches}, want "
                                 f"{want}")
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            raise AssertionError(f"9e {tag}: a position is not finite")
        # the step's own peak with its inputs: the allocator's, less what
        # was resident before that is no input of the row (the graph's
        # base arrays, which its other rows cut their inputs from)
        arg_gb = sum(t.numel() * t.element_size() for t in args) / 1e9
        step_peak = peak - before / 1e9 + arg_gb
        row = dict(n_pad=n, m_pad=m, cap=cap, cold_ms=ms[0],
                   ms=float(sorted(ms[1:])[len(ms[1:]) // 2]),
                   warm_ms=ms[1:], peak_gb=peak, argument_gb=arg_gb,
                   step_peak_gb=step_peak, launches=launches,
                   dryrun_argument_gb=counted[tag]["argument_bytes"] / 1e9,
                   dryrun_peak_gb=counted[tag]["peak_bytes"] / 1e9,
                   dryrun_flops=counted[tag]["flops"],
                   dryrun_bytes=counted[tag]["bytes"])
        row["step_peak_over_dryrun"] = step_peak / row["dryrun_peak_gb"]
        if mode in DRYRUN_PAIRS.values():
            ref_out[(graph, mode)] = outs[0]
            spread[(graph, mode)] = max(
                float((outs[0] - outs[1]).abs().max()), _max_floor(outs[0]))
            row["spread"] = spread[(graph, mode)]
        if mode in DRYRUN_PAIRS:
            key = (graph, DRYRUN_PAIRS[mode])
            d = float((outs[0] - ref_out[key]).abs().max())
            row.update(vs=DRYRUN_PAIRS[mode], max_dpos=d,
                       bound=REPLAY_FACTOR * spread[key])
            if not d <= row["bound"]:
                raise AssertionError(f"9e {tag}: max |Δpos| {d} from the "
                                     f"{DRYRUN_PAIRS[mode]} row, bound "
                                     f"{row['bound']}")
        print(json.dumps({"dryrun_layout_row": tag, **row}), flush=True)
        res[tag] = row
        del args, outs, out
        if len(recorded) == len(DRYRUN_KERNEL_ROWS) and not kernel_rows:
            kernel_rows = dryrun_kernel_rows(
                *(recorded[t] for t in DRYRUN_KERNEL_ROWS), n,
                *(res[t]["launches"] for t in DRYRUN_KERNEL_ROWS))
            recorded.clear()
        if mode in ("grid_halo", "exact"):
            ref_out = {k: v for k, v in ref_out.items() if k[0] != graph}
    del base, ref_out
    torch.cuda.empty_cache()
    print(json.dumps({"dryrun_layout_card": res}), flush=True)
    return res, kernel_rows


def dist_phase(edges, n, main, scheds, e5, n5, cfg5, refs) -> tuple:
    """Phase 9, the sharded driver on the card over a one-rank NCCL group
    (made through a FileStore by ``launch.mesh.make_host_mesh`` and
    destroyed at the end): 9b the 1M layout with
    ``LayoutConfig(driver="multigila_dist", mesh_shape=(1, 1))``, cold then
    warm (the latter recording near_field's arguments); 9a the near_field
    rows; the sync-free loop of grid level 1; 9c card against CPU at 5k;
    9d the CLI. ``main`` is phase 4's warm run, ``scheds`` its schedules,
    ``refs`` the CPU references (9c's).
    Returns (the near_field rows, the phase's summary)."""
    import torch
    from repro_torch.core import LayoutConfig, bucketing, multigila_layout
    from repro_torch.graphs.graph import bucket_pad
    from repro_torch.graphs.metrics import neld
    from repro_torch.launch import mesh as mesh_mod
    t_phase = time.perf_counter()
    secs = {}
    mesh = mesh_mod.make_host_mesh(device="cuda")
    try:
        import torch.distributed as dist
        if dist.get_world_size() != 1 or "nccl" not in dist.get_backend():
            raise AssertionError(f"phase 9: group {dist.get_backend()}, "
                                 f"{dist.get_world_size()} ranks")
        cfg = LayoutConfig(driver="multigila_dist", mesh_shape=(1, 1))
        grid_iters = sum(s.iters for s in scheds if s.mode == "grid")
        want = {"grid_far": grid_iters, "near_field": grid_iters}
        bucketing.STEP_CACHE.clear()
        torch.cuda.empty_cache()
        runs = {}
        t = time.perf_counter()
        for name in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            run = lambda: multigila_layout(edges, n, cfg)
            if name == "warm":
                with NearFieldInputs() as rec:
                    pos, stats, wall, launches = _path_run(
                        f"dist_{name}", run, n, list(want))
            else:
                pos, stats, wall, launches = _path_run(
                    f"dist_{name}", run, n, list(want))
            runs[name] = r = dict(
                wall_s=wall, phase_s=dict(stats.phase_seconds),
                level_sizes=stats.level_sizes, level_modes=stats.level_modes,
                launches=launches, neld=neld(pos, edges),
                neld_main_warm=main["neld"], cache=bucketing.cache_stats(),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            print(json.dumps({f"dist_1m_{name}": r}), flush=True)
            if (r["level_sizes"], r["level_modes"]) != (main["level_sizes"],
                                                        main["level_modes"]):
                raise AssertionError(f"dist {name}: levels/modes differ "
                                     "from phase 4's")
            if launches != want:
                raise AssertionError(f"dist {name}: launches {launches}, "
                                     f"want {want}")
            if abs(r["neld"] - main["neld"]) > NELD_DELTA:
                raise AssertionError(f"dist {name}: NELD {r['neld']}, phase "
                                     f"4 {main['neld']}")
        if runs["warm"]["cache"]["misses"] != runs["cold"]["cache"]["misses"]:
            raise AssertionError("dist warm run missed the step cache")
        secs["9b"] = time.perf_counter() - t
        del pos
        t = time.perf_counter()
        grid_levels = [i for i, m in enumerate(main["level_modes"])
                       if m == "grid"]
        level_of = {}
        for i in grid_levels:
            nv = main["level_sizes"][i][0]
            level_of[bucket_pad(nv)] = (i, nv)
        if set(rec.cases) != set(level_of) or sum(rec.calls.values()) != \
                grid_iters:
            raise AssertionError(f"near_field recorded {rec.calls}, grid "
                                 f"levels {level_of}")
        rows = near_field_rows(mesh, rec, level_of, rec.calls)
        del rec
        torch.cuda.empty_cache()
        secs["9a"] = time.perf_counter() - t
        t = time.perf_counter()
        loop = sync_free_loop(mesh, edges, n, max(grid_levels))
        secs["sync_free"] = time.perf_counter() - t
        t = time.perf_counter()
        small = dist_card_vs_cpu(e5, n5, cfg5, refs)
        secs["9c"] = time.perf_counter() - t
        t = time.perf_counter()
        cli = dist_cli_on_card()
        secs["9d"] = time.perf_counter() - t
        t = time.perf_counter()
        dryrun, dryrun_rows = dryrun_layout_card(mesh, refs)
        secs["9e"] = time.perf_counter() - t
    finally:
        bucketing.STEP_CACHE.clear()
        mesh_mod.shutdown()
    secs["phase"] = time.perf_counter() - t_phase
    PHASE_SECONDS.update({k: v for k, v in secs.items() if k[0] == "9"})
    PHASE_SECONDS["9_sync_free"] = secs["sync_free"]
    summary = dict(runs=runs, sync_free=loop, small=small, cli=cli,
                   dryrun=dryrun, seconds=secs)
    print(json.dumps({"dist_seconds": secs}), flush=True)
    return rows + dryrun_rows, summary


def _host_consts(consts) -> tuple:
    """The default LayoutConfig's (C, L, min_dist), for a tree whose
    wrappers take host numbers, in place of a path record's device
    constants (C·L², md²) — checked to be the same numbers."""
    from repro_torch.kernels import _build
    host = (1.0, 1.0, 1e-3)
    if _build.force_consts(*host) != tuple(consts.tolist()):
        raise AssertionError(f"path constants {consts.tolist()} are not "
                             f"those of {host}")
    return host


def compare_trees(srcs, cases) -> None:
    """``--compare SRC``: the force kernels of the ``repro_torch`` under
    each of ``srcs`` on ``cases`` — (name, args, consts, shape, launches)
    each — then this checkout's again, so that the trees meet the same
    tensors on one card, the other trees between two turns of this one.
    Another tree's modules take the place of this one's for the length of
    its turn; its build lands in its own ``kernels/build/``. A tree is
    handed its wrappers' form of the constants (``_force_case``)."""
    mine = {k: m for k, m in sys.modules.items()
            if k == "repro_torch" or k.startswith("repro_torch.")}
    for tree in (*srcs, None):
        for k in list(sys.modules):
            if k == "repro_torch" or k.startswith("repro_torch."):
                del sys.modules[k]
        if tree is None:
            sys.modules.update(mine)
        else:
            sys.path.insert(0, str(tree))
        try:
            from repro_torch.kernels import _build
            _build.load()
            print(f"compare: kernels of {Path(_build.__file__).parent}",
                  flush=True)
            for source, log in sorted(_build.build_log.items()):
                for kernel, info in _ptxas_report(log):
                    print(f"  ptxas {source} {kernel}: {info}", flush=True)
            for name, args, consts, shape, launches in cases:
                time_force_case(name, args, consts, shape,
                                "path" if launches else "random",
                                launches=launches, time_plain=False,
                                tree=str(tree or "this checkout"))
        finally:
            if tree is not None:
                sys.path.remove(str(tree))


# -- phase 10: LM training -----------------------------------------------------

# phase 10b's full-width models, 2 layers each: attention's backward through
# SDPA (internlm2), the SSD's backward (mamba2), the encoder and
# cross-attention (seamless), at TRAIN_WIDE_SEQ positions of batch 2 (an
# encoder-decoder model's split as the driver splits --seq: frames + tokens)
TRAIN_WIDE = ("internlm2-1.8b", "mamba2-1.3b", "seamless-m4t-medium")
TRAIN_WIDE_SEQ = 128
# phase 10c: internlm2-1.8b at full width and depth through the training
# driver, --batch 4 --seq 1024: 30 steps at --remat none, then 7 each at
# full and dots; the step time is the median over the steps from the third
# to the last but one (the last is profiled): 4 steps at full and dots
TRAIN_FULL = dict(batch=4, seq=1024, steps=30, remat_steps=7)
# phase 10a/10b: the optimizer's schedule (the driver's for 30 steps)
TRAIN_OPTIM = dict(lr=3e-4, warmup_steps=5, total_steps=30)
# card vs CPU gradients, both bf16: each leaf within rtol·|CPU| + atol ×
# the leaf's largest |CPU value| (LOGIT_TOL taken relative to the leaf). A
# leaf outside it whose bf16 CPU gradient is itself further than that from
# the CPU's float32 gradient of the same weights, batch and routes (a sum
# over every position, where bf16 rounding cancels: the CPU tests met one,
# jamba's per-head ssm.A_log) is held to lie no further from the float32
# gradient than twice the CPU's bf16 one
GRAD_TOL = LOGIT_TOL
# the card's AdamW on the CPU's gradients from the same state: its masters,
# mu and nu within OPTIM_TOL × the CPU leaf's largest |value| (float32
# elementwise arithmetic in one order on both; the grad norm's sum order
# moves the clip scale by ~5e-7 and nu by twice that, and the device's pow
# and cos differ by ulps)
OPTIM_TOL = 1e-5
# the card's own step: where both sides' gradients agree in sign and
# |g| × the clip scale is at least AGREE_EPS × AdamW's eps, step 1 moves an
# element by lr × (1 ± 1%) on both sides, so the masters agree within
# MASTER_AGREE × lr (an element inside the bf16 noise may move by +lr on
# one side and −lr on the other: 2 × lr there)
AGREE_EPS = 100
MASTER_AGREE = 0.02
# phase 10a's MoE smoke configs route among 5-8 experts of d_model 64-72 at
# probabilities ~0.2, where bf16 noise of ~2^-8 in a router logit of O(1)
# moves a probability by ~1e-3: ROUTE_MARGIN (set for the published
# widths' 40-64 experts at ~1/E) would count noise as a fault there, so
# these take the CPU tests' bf16 margin against the JAX package
SMOKE_ROUTE_MARGIN = 0.02


class GradRecorder:
    """Within ``with``: the gradients each training step hands to AdamW
    (``train_step.apply_updates`` wrapped), the last step's kept in
    ``grads``."""

    def __enter__(self):
        from repro_torch.train import train_step
        self._mod, self._apply = train_step, train_step.apply_updates

        def apply_updates(cfg, params, grads, st, **kw):
            self.grads = {k: g.detach().clone() for k, g in grads.items()}
            return self._apply(cfg, params, grads, st, **kw)
        train_step.apply_updates = apply_updates
        return self

    def __exit__(self, *exc):
        self._mod.apply_updates = self._apply


def _train_batch(cfg, b: int, s: int, device) -> dict:
    """The training driver's batch 0 at b × s: ``batch_at`` tokens and
    labels (an encoder-decoder model's cut to s // 2 with s // 2 frames)
    and ``extra_inputs``, on ``device``."""
    from repro_torch.train import DataConfig, batch_at, extra_inputs
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b), 0)
    if cfg.enc_layers:
        batch = {k: v[:, :s // 2] for k, v in batch.items()}
    batch.update(extra_inputs(cfg, b, s // 2 if cfg.enc_layers else s))
    return {k: v.to(device) for k, v in batch.items()}


def _grads_against(label: str, got: dict, ref: dict, truth) -> dict:
    """Every gradient leaf of ``got`` against ``ref``'s (GRAD_TOL relative
    to the leaf's largest |value|; ``truth()`` gives the float32 gradients
    for a leaf outside it) → the largest |Δ| over a leaf's max, and the
    leaves held to the float32 gradient. Compared on ``got``'s device."""
    import torch
    worst, via_f32 = 0.0, []
    for name, b in ref.items():
        a = got[name].float()
        b = b.to(a.device).float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} gradient {name}: not finite")
        scale = float(b.abs().max())
        if scale == 0:
            if float(a.abs().max()):
                raise AssertionError(f"{label} gradient {name}: zero in "
                                     "the reference only")
            continue
        d = (a - b).abs()
        worst = max(worst, float(d.max()) / scale)
        if bool((d <= GRAD_TOL["rtol"] * b.abs()
                 + GRAD_TOL["atol"] * scale).all()):
            continue
        t = truth()[name].to(a.device).float()
        bt = (b - t).abs()
        if bool((bt <= GRAD_TOL["rtol"] * t.abs()
                 + GRAD_TOL["atol"] * float(t.abs().max())).all()):
            raise AssertionError(f"{label} gradient {name}: largest |Δ| "
                                 f"{float(d.max())} of a max {scale}")
        if float((a - t).abs().max()) > 2 * float(bt.max()):
            raise AssertionError(f"{label} gradient {name}: further from "
                                 "the float32 gradient than twice the "
                                 "reference's")
        via_f32.append(name)
    return dict(max_err_over_leaf_max=worst, held_to_float32=via_f32)


def train_cpu_side(cfg, b: int, s: int) -> dict:
    """The CPU side of ``train_step_card_vs_cpu``, up to the optimizer:
    bf16 weights drawn on the CPU from seed 1 (``init``), the training
    driver's batch 0, the loss (and ce, aux) and every gradient there, the
    MoE calls' probs and choices (``RouteRecorder``), its seconds."""
    import torch
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cpu = M.init_params(cfg, seed=1, device="cpu")
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    cpu.requires_grad_(True)
    params = dict(cpu.named_parameters())
    batch = _train_batch(cfg, b, s, "cpu")
    t1 = time.perf_counter()
    with RouteRecorder() as rec:
        loss, parts = M.loss_fn(cpu, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    return dict(init=init, grads=dict(zip(params, grads)),
                metrics={"loss": float(loss.detach()),
                         **{k: float(v.detach()) for k, v in parts.items()}},
                routes=rec.calls, tokens=list(batch["tokens"].shape),
                cpu_step_s=time.perf_counter() - t1, cpu_init_s=t1 - t0)


def _train_cpu_ref(arch: str, b: int, s: int, out_dir: str) -> dict:
    """Phase 10b's CPU side in a worker (``train_cpu_side`` of TRAIN_WIDE's
    2-layer cut of ``arch``). Its weights and gradients, ~2 GB a model in
    bf16, go to an npz file in ``out_dir`` (bf16 as int16 words) and the
    result names the file: a result of that size through the pool's pipe
    is read in ~64 KB chunks by a thread of the main process, each chunk
    taking the interpreter lock from the thread that drives the card
    (beside it phase 5d's first coarsen took 74.6 s instead of 1.4 on an
    NVIDIA H100 80GB HBM3 at 700 W).
    AdamW's float32 state, three times the weights again, is not made
    here: the CPU's AdamW step runs where the card side runs."""
    import os

    import numpy as np
    import torch
    out = train_cpu_side(_wide_cfg(arch), b, s)
    arrays = {}
    for key in ("init", "grads"):
        for k, t in out.pop(key).items():
            t = t.detach()
            bf16 = t.dtype == torch.bfloat16
            arrays[f"{key}:{'bf16' if bf16 else ''}:{k}"] = (
                t.view(torch.int16) if bf16 else t).numpy()
    out["file"] = os.path.join(out_dir, f"10b_{arch}.npz")
    np.savez(out["file"], **arrays)
    out["routes"] = [(p.numpy(), e.numpy()) for p, e in out["routes"]]
    return out


def _cpu_side_loaded(out: dict) -> dict:
    """``_train_cpu_ref``'s result with its weights and gradients read back
    from its file (then deleted) as tensors."""
    import os

    import numpy as np
    import torch
    out["init"], out["grads"] = {}, {}
    with np.load(out["file"]) as z:
        for key in z.files:
            part, kind, name = key.split(":", 2)
            t = torch.from_numpy(z[key])
            out[part][name] = t.view(torch.bfloat16) if kind else t
    os.remove(out["file"])
    out["routes"] = [(torch.from_numpy(p), torch.from_numpy(e))
                     for p, e in out["routes"]]
    return out


def train_step_card_vs_cpu(device, cfg, b: int, s: int, remat_modes=(),
                           margin: float = ROUTE_MARGIN, cpu_side=None):
    """One training step of ``cfg`` on the card and on the CPU from the
    same bf16 weights (drawn on the CPU from seed 1 and copied) and the
    training driver's batch 0: the loss (and ce, aux) within LOGIT_TOL,
    the grad norm within LOGIT_TOL, every gradient leaf
    (``_grads_against``), the card's ``apply_updates`` on the CPU's
    gradients from the same initial state giving the CPU's masters, mu and
    nu (OPTIM_TOL), the card's own masters after its step within
    MASTER_AGREE × lr where both sides' gradients agree in sign past
    AGREE_EPS × eps (2 × lr elsewhere), and the weights equal to the cast
    masters. MoE models: the card follows the CPU's
    expert choices (``RouteRecorder``), and its own must equal them on
    every token whose CPU margin is at least ``margin`` (flips below it
    are counted). ``remat_modes``: before the step, on the card, each
    mode's loss equal to "none"'s bit for bit and its gradients within
    GRAD_TOL of them. The CPU's loss and gradients are ``cpu_side``'s
    when given (``train_cpu_side`` computed in a CPU worker), else computed
    here; the CPU's AdamW step on them runs here. → the numbers, the CPU's
    seconds included."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.train import (AdamWConfig, TrainConfig, apply_updates,
                                   init_opt_state, init_train_state,
                                   make_train_step)
    from repro_torch.utils.device import synchronize

    if cpu_side is None:
        cpu_side = train_cpu_side(cfg, b, s)
    t0 = time.perf_counter()
    init = cpu_side["init"]
    card = M.LM(cfg, device=device)
    card.load_state_dict(init)
    tcfg = TrainConfig(optim=AdamWConfig(**TRAIN_OPTIM))
    step = make_train_step(tcfg)
    batch = _train_batch(cfg, b, s, "cpu")
    on_card = {k: v.to(device) for k, v in batch.items()}
    res = dict(layers=cfg.n_layers, d_model=cfg.d_model,
               tokens=list(batch["tokens"].shape),
               init_s=time.perf_counter() - t0 + cpu_side["cpu_init_s"],
               cpu_step_s=cpu_side["cpu_step_s"])
    if res["tokens"] != cpu_side["tokens"]:
        raise AssertionError(f"the CPU side's batch {cpu_side['tokens']}")
    # the CPU's AdamW step on its gradients, from the drawn weights
    t0 = time.perf_counter()
    g_cpu = cpu_side["grads"]
    cpu_params = {k: v.clone() for k, v in init.items()
                  if k in g_cpu}
    opt_c = init_opt_state(tcfg.optim, cpu_params)
    _, opt_c, om = apply_updates(tcfg.optim, cpu_params, g_cpu, opt_c)
    m_cpu = dict(cpu_side["metrics"], **om)
    res["cpu_step_s"] += time.perf_counter() - t0
    del cpu_params
    r_cpu_calls = cpu_side["routes"]
    follow = r_cpu_calls or None

    t0 = time.perf_counter()
    opt_k, _ = init_train_state(card, tcfg)
    if remat_modes:
        params = list(card.parameters())
        ref = None
        for remat in ("none", *remat_modes):     # the card's own routes:
            loss, _ = M.loss_fn(card, on_card, remat=remat)   # a replay
            grads = torch.autograd.grad(loss, params)   # recomputes them
            grads = dict(zip(dict(card.named_parameters()), grads))
            if ref is None:
                ref = (loss.detach(), grads)
                continue
            if not torch.equal(loss.detach(), ref[0]):
                raise AssertionError(f"remat {remat}: loss {float(loss)} "
                                     f"against none's {float(ref[0])}")
            res[f"remat_{remat}"] = _grads_against(
                f"remat {remat} vs none", grads, ref[1], lambda: ref[1])
        del ref, grads
    with RouteRecorder(follow) as r_card, GradRecorder() as g_card:
        _, opt_k, _, m_card = step(card, opt_k, None, on_card)
    synchronize(device)
    res["card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    for key in ("loss", "ce", "aux", "grad_norm"):
        a, c = float(m_card[key]), float(m_cpu[key])
        res[key] = dict(card=a, cpu=c)
        if not abs(a - c) <= LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * abs(c):
            raise AssertionError(f"card vs CPU {key}: {a} against {c}")

    f32 = {}

    def truth():
        if not f32:
            cpu32 = M.LM(cfg, dtype=torch.float32, device="cpu")
            cpu32.load_state_dict(init)
            cpu32.requires_grad_(True)
            p32 = dict(cpu32.named_parameters())
            with RouteRecorder(follow):
                loss32, _ = M.loss_fn(cpu32, batch)
            f32.update(zip(p32, torch.autograd.grad(
                loss32, list(p32.values()))))
        return f32
    res["grads"] = _grads_against("card vs CPU", g_card.grads, g_cpu,
                                  truth)

    # the card's AdamW on the CPU's gradients, from the same state
    names = [name for name, _ in card.named_parameters()]
    params = {name: init[name].to(device) for name in names}
    replay = init_opt_state(tcfg.optim, params)
    _, replay, _ = apply_updates(
        tcfg.optim, params,
        {name: g.to(device) for name, g in g_cpu.items()}, replay)
    worst = 0.0
    for key in ("master", "mu", "nu"):
        for name in names:
            a = getattr(replay, key)[name]
            c = getattr(opt_c, key)[name].to(device)
            scale = float(c.abs().max())
            d = float((a - c).abs().max())
            worst = max(worst, d / scale if scale else d)
            if d > OPTIM_TOL * scale:
                raise AssertionError(f"card AdamW on the CPU's gradients: "
                                     f"{key} {name} |Δ| {d} of a max "
                                     f"{scale}")
    res["adamw_replay_max_err_over_leaf_max"] = worst
    del params, replay

    opt = tcfg.optim
    lr1 = float(m_cpu["lr"])
    clip = [min(1.0, opt.clip_norm / max(float(m["grad_norm"]), 1e-12))
            for m in (m_card, m_cpu)]
    worst, agree, n_el = 0.0, 0, 0
    for name, p in card.named_parameters():
        mk, mc = opt_k.master[name], opt_c.master[name].to(device)
        gk = g_card.grads[name].float()
        gc = g_cpu[name].to(device).float()
        ok = ((gk.sign() == gc.sign())
              & (gk.abs() * clip[0] >= AGREE_EPS * opt.eps)
              & (gc.abs() * clip[1] >= AGREE_EPS * opt.eps))
        d = (mk - mc).abs()
        slack = 1e-6 * float(mc.abs().max())
        if bool((d[ok] > MASTER_AGREE * lr1 + slack).any()):
            raise AssertionError(f"master {name}: |Δ| {float(d[ok].max())} "
                                 f"where the gradients agree, past "
                                 f"{MASTER_AGREE}·lr {lr1}")
        if float(d.max()) > 2 * lr1 + slack:
            raise AssertionError(f"master {name}: |Δ| {float(d.max())} "
                                 f"past 2·lr {lr1}")
        if bool(ok.any()):
            worst = max(worst, float(d[ok].max()))
        agree += int(ok.sum())
        n_el += ok.numel()
        if not torch.equal(p.detach(), mk.to(p.dtype)):
            raise AssertionError(f"{name}: weight is not the cast master")
    res["master_agree_max_abs_over_lr"] = worst / lr1
    res["master_agree_share"] = agree / n_el
    if cfg.moe is not None:
        k, flips = cfg.moe.top_k, 0
        for (p_cpu, e_cpu), (_, e_card) in zip(r_cpu_calls, r_card.calls):
            srt = p_cpu.sort(dim=-1, descending=True).values
            gap = srt[..., k - 1] - srt[..., k]
            differ = (e_card.sort(-1).values
                      != e_cpu.sort(-1).values).any(-1)
            bad = differ & (gap >= margin)
            if bool(bad.any()):
                raise AssertionError(f"card vs CPU: an expert choice "
                                     f"differs at CPU margins "
                                     f"{gap[bad].tolist()} ≥ {margin}")
            flips += int(differ.sum())
        res["routing"] = dict(moe_calls=len(r_cpu_calls), flips=flips,
                              margin=margin)
    res["compare_s"] = time.perf_counter() - t0
    return res


def train_smoke_phase(device) -> dict:
    """Phase 10a: every registered model's smoke config, one step card
    against CPU at B 2 × S 64, remat full and dots checked on the card."""
    from repro_torch.configs import get_smoke_config
    out = {}
    for arch in LM_ARCHS:
        r = train_step_card_vs_cpu(device, get_smoke_config(arch), 2, 64,
                                   remat_modes=("full", "dots"),
                                   margin=SMOKE_ROUTE_MARGIN)
        print(json.dumps({"train_card_vs_cpu": r, "lm": arch,
                          "config": "smoke"}), flush=True)
        out[arch] = r
    return out


def _wide_cfg(arch: str):
    """TRAIN_WIDE's cut of ``arch``: full width, 2 layers (and at most 2
    encoder layers)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=2,
                               enc_layers=min(cfg.enc_layers, 2))


def train_wide_phase(device, refs) -> dict:
    """Phase 10b: TRAIN_WIDE at full width, 2 layers (and 2 encoder
    layers), one step card against CPU at B 2 × S TRAIN_WIDE_SEQ
    (``train_step_card_vs_cpu``), the CPU sides computed in ``refs``'
    workers (tasks "10b:<arch>")."""
    import torch
    out = {}
    for arch in TRAIN_WIDE:
        cpu_side = _cpu_side_loaded(refs.get(f"10b:{arch}"))
        r = train_step_card_vs_cpu(device, _wide_cfg(arch), 2,
                                   TRAIN_WIDE_SEQ, cpu_side=cpu_side)
        r["cpu_worker_s"] = refs.seconds[f"10b:{arch}"]
        del cpu_side
        print(json.dumps({"train_card_vs_cpu": r, "lm": arch,
                          "config": "full width, 2 layers"}), flush=True)
        out[arch] = r
        gc.collect()
        torch.cuda.empty_cache()
    return out


_ATTN_WORDS = ("flash", "fmha", "attention", "cudnn", "efficient", "sdpa",
               "attn")


class StepTimes:
    """Within ``with``: the training driver's steps
    (``launch.train.make_train_step`` wrapped), each followed by a
    synchronize: its wall seconds and loss in ``seconds`` and ``losses``;
    the step at index ``profile_at`` runs under torch.profiler instead (its
    time left out of ``seconds``: None there): ``profile`` holds its
    ``_profile_summary`` and, as ``attention``, [name, ms, launches] of
    every kernel whose name says attention (SDPA's backend). The optimizer
    (``train_step.apply_updates``) is timed by CUDA events around its
    launches, from the end of the backward's on: ``optim_ms``."""

    def __init__(self, profile_at=None):
        self.profile_at = profile_at

    def __enter__(self):
        import torch
        from repro_torch.launch import train as T
        from repro_torch.train import train_step as TS
        self._mod, self._make = T, T.make_train_step
        self._ts, self._apply = TS, TS.apply_updates
        self.seconds, self.losses, self.profile = [], [], None
        self.optim_ms, marks = [], []

        def apply_updates(*args, **kw):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            out = self._apply(*args, **kw)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            return out
        TS.apply_updates = apply_updates

        def make_train_step(tcfg):
            real = self._make(tcfg)

            def step(*args):
                if len(self.losses) == self.profile_at:
                    out = []
                    wall, events = _device_events(
                        lambda: out.append(real(*args)))
                    self.profile = _profile_summary(wall, events)
                    self.profile["attention"] = [
                        [name, ms, cnt] for name, (ms, cnt)
                        in _ms_by_name(events).items()
                        if any(w in name.lower() for w in _ATTN_WORDS)]
                    self.seconds.append(None)
                    out = out[0]
                else:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = real(*args)
                    torch.cuda.synchronize()
                    self.seconds.append(time.perf_counter() - t0)
                self.losses.append(float(out[3]["loss"]))
                a, b = marks[-2:]
                self.optim_ms.append(a.elapsed_time(b))
                return out
            return step
        T.make_train_step = make_train_step
        return self

    def __exit__(self, *exc):
        self._mod.make_train_step = self._make
        self._ts.apply_updates = self._apply


def train_full_phase() -> dict:
    """Phase 10c: internlm2-1.8b at full width and depth through
    ``repro_torch.launch.train.main`` (TRAIN_FULL): --remat none for
    ``steps`` steps, then ``remat_steps`` each at full and dots, the last
    step of each profiled (SDPA's kernels named). For each mode: the
    median step ms over the steps from the third (the profiled one left
    out), the optimizer's device ms, tokens/s, the allocator's peak GB,
    and 6·N·tokens over the step time. Every loss finite; the 30-step
    run's mean over its last 5 losses below its step 0's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T

    cfg = get_config(LM_ARCH)
    n_params = cfg.param_count()
    tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq"]
    out = {}
    for remat, steps in (("none", TRAIN_FULL["steps"]),
                         ("full", TRAIN_FULL["remat_steps"]),
                         ("dots", TRAIN_FULL["remat_steps"])):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with StepTimes(profile_at=steps - 1) as rec:
            final = T.main(["--arch", LM_ARCH, "--batch",
                            str(TRAIN_FULL["batch"]), "--seq",
                            str(TRAIN_FULL["seq"]), "--steps", str(steps),
                            "--remat", remat, "--log-every", "10"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        timed = [i for i, t in enumerate(rec.seconds)
                 if i >= 2 and t is not None]
        step_s = float(np.median([rec.seconds[i] for i in timed]))
        r = dict(remat=remat, steps=steps, step_ms=step_s * 1e3,
                 optim_ms=float(np.median([rec.optim_ms[i] for i in timed])),
                 step_ms_all=[None if t is None else t * 1e3
                              for t in rec.seconds],
                 tokens_per_s=tokens / step_s, peak_gb=peak,
                 model_flops_per_s=6 * n_params * tokens / step_s,
                 model_flops_share=6 * n_params * tokens / step_s
                 / BF16_FLOPS_PER_S, losses=rec.losses, final_loss=final,
                 wall_s=wall, params=n_params, tokens_per_step=tokens)
        if not all(np.isfinite(rec.losses)):
            raise AssertionError(f"10c {remat}: a loss is not finite: "
                                 f"{rec.losses}")
        if remat == "none":
            if not np.mean(rec.losses[-5:]) < rec.losses[0]:
                raise AssertionError(f"10c: the last 5 losses' mean "
                                     f"{np.mean(rec.losses[-5:])} is not "
                                     f"below step 0's {rec.losses[0]}")
        r["profile"] = rec.profile
        print(json.dumps({"train_full": r, "lm": LM_ARCH}), flush=True)
        out[remat] = r
    return out


def train_resume_phase() -> dict:
    """Phase 10d: internlm2-1.8b's smoke config through the driver on the
    card (B 4 × S 128): run A, 40 steps without checkpoints; run B, 40
    steps checkpointed every 20, its step_40 deleted, then resumed with
    --resume auto: B restores step 20 and its final loss lies within
    LOGIT_TOL of A's."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    from repro_torch.ckpt import latest_step
    from repro_torch.launch import train as T

    args = ["--arch", LM_ARCH, "--smoke", "--steps", "40", "--seq", "128",
            "--batch", "4", "--log-every", "100"]
    loss_a = T.main(args)
    with tempfile.TemporaryDirectory() as d:
        loss_b_first = T.main([*args, "--ckpt", d, "--ckpt-every", "20"])
        shutil.rmtree(os.path.join(d, "step_40"))
        if latest_step(d) != 20:
            raise AssertionError(f"10d: latest step {latest_step(d)}")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            loss_b = T.main([*args, "--ckpt", d, "--resume", "auto"])
        print(log.getvalue(), end="", flush=True)
        if "[resume] restored step 20" not in log.getvalue():
            raise AssertionError("10d: the resumed run did not restore "
                                 "step 20")
        if latest_step(d) != 40:
            raise AssertionError("10d: no step_40 after the resume")
    res = dict(loss_uninterrupted=loss_a, loss_checkpointed=loss_b_first,
               loss_resumed=loss_b, tol=LOGIT_TOL)
    if not abs(loss_b - loss_a) <= (LOGIT_TOL["atol"]
                                    + LOGIT_TOL["rtol"] * abs(loss_a)):
        raise AssertionError(f"10d: resumed loss {loss_b} against {loss_a}")
    print(json.dumps({"train_resume": res, "lm": LM_ARCH}), flush=True)
    return res


def train_phase(device, refs, elastic) -> None:
    """Phase 10, each sub-phase in PHASE_SECONDS."""
    import torch
    with phase("10a"):
        train_smoke_phase(device)
    with phase("10b"):
        train_wide_phase(device, refs)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("10c"):
        full = train_full_phase()
    gc.collect()
    torch.cuda.empty_cache()
    with phase("10d"):
        train_resume_phase()
    gc.collect()
    torch.cuda.empty_cache()
    with phase("10e"):
        train_parallel_phase(device, full, elastic)


# -- phase 10e: the sharded trainer and parallel/ on a one-rank NCCL mesh -----

# 10e(a): the sharded step at full width and depth, on 10c's batches and
# schedule (TRAIN_FULL), this many steps; the step ms is the median from
# the third
SHARDED_STEPS = 6
# 10e(b): granite-moe-3b-a800m's MoE layer at full width, B × S; the a2a
# form (and apply_moe beside it) at a capacity where no choice drops
MOE_FORMS = dict(arch="granite-moe-3b-a800m", batch=4, seq=2048,
                 dropless_cf=4.0)
# 10e(c): ring attention at internlm2's width, B 1 × S 8192, causal; the
# ring collective matmul [S, K] @ [K, N]; the pipeline at internlm2's full
# width, 2 layers, M microbatches of B 4 × S 1024
RING_ATTN = dict(B=1, S=8192, H=16, KV=8, hd=128)
RING_MATMUL = dict(S=4096, K=2048, N=8192)
PIPE = dict(layers=2, batch=4, seq=1024, microbatches=4)
# 10e(d): ELASTIC_RANKS gloo ranks on the CPU train internlm2's smoke
# config through the driver and torchrun from the script's start
# (``ElasticCpuRun``); the card resumes their step_10 on one rank
ELASTIC_RANKS = 8
ELASTIC_ARGS = ["--arch", LM_ARCH, "--smoke", "--model-parallel", "2",
                "--batch", "8", "--seq", "64", "--steps", "12",
                "--ckpt-every", "10", "--log-every", "1"]


class ElasticCpuRun:
    """Phase 10e(d)'s CPU side: ``torch.distributed.run`` (torchrun,
    ``--standalone``: a rendezvous on localhost) starts ELASTIC_RANKS
    gloo ranks of ``repro_torch.launch.train`` with ELASTIC_ARGS and
    ``--device cpu`` in a temporary directory, the card hidden, one thread
    a rank, their output in files there. ``start`` launches them, ``wait``
    → (rank 0's printed text, the seconds from start to end), ``close``
    ends them if they still run and removes the directory. The seconds
    are those to their last line of output (the file's time)."""

    def __init__(self, src: Path):
        self.src, self.proc, self.dir = str(src), None, None

    def start(self) -> None:
        import os
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
        self.ckpt = os.path.join(self.dir, "run")
        env = dict(os.environ, PYTHONPATH=self.src, OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="")
        self._out = open(os.path.join(self.dir, "out.txt"), "w")
        self._err = open(os.path.join(self.dir, "err.txt"), "w")
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(ELASTIC_RANKS), "-m",
             "repro_torch.launch.train", *ELASTIC_ARGS, "--ckpt",
             self.ckpt, "--device", "cpu"], env=env, stdout=self._out,
            stderr=self._err)

    def wait(self, timeout: float = 300) -> tuple:
        import os
        rc = self.proc.wait(timeout=timeout)
        self._out.close()
        self._err.close()
        # their last line of output: the end of their run
        secs = os.path.getmtime(os.path.join(self.dir, "out.txt")) - self.t0
        with open(os.path.join(self.dir, "out.txt")) as f:
            out = f.read()
        if rc != 0:
            with open(os.path.join(self.dir, "err.txt")) as f:
                raise AssertionError(f"10e(d): the CPU ranks exited {rc}:\n"
                                     f"{f.read()[-4000:]}")
        return out, secs

    def close(self) -> None:
        import shutil
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)


def _printed_losses(text: str) -> dict:
    """{step: loss} of the training driver's printed lines."""
    import re
    return {int(a): float(b) for a, b in
            re.findall(r"step\s+(\d+) loss (\S+)", text)}


def _within(a: float, b: float) -> bool:
    return abs(a - b) <= LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * abs(b)


def sharded_step_phase(device, full) -> dict:
    """10e(a): internlm2-1.8b at full width and depth, B 4 × S 1024,
    SHARDED_STEPS steps of ``train_step.make_train_step`` under
    ``make_rules(mesh, cfg)`` on a one-rank NCCL mesh ``make_mesh((1,
    1))``, the parameters cut by ``shard_model`` (whole on one rank): every
    loss within LOGIT_TOL of 10c's at the same step (the same seed-0
    weights, batches and schedule), whether they are bit-equal, step ms
    beside 10c's, the peak GB."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import (make_rules, shard_model,
                                               use_shardings)
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   batch_at, init_train_state,
                                   make_train_step)
    cfg = get_config(LM_ARCH)
    steps = TRAIN_FULL["steps"]
    tcfg = TrainConfig(optim=AdamWConfig(lr=3e-4, total_steps=steps,
                                         warmup_steps=max(steps // 20, 5)))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_FULL["seq"],
                      global_batch=TRAIN_FULL["batch"])
    mesh = make_mesh((1, 1), device=device)
    rules = make_rules(mesh, cfg)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    with use_shardings(mesh, rules):
        model = init_params(cfg, seed=0, device=device)
        shard_model(model, rules)
        opt, err = init_train_state(model, tcfg)
        step = make_train_step(tcfg)
        for i in range(SHARDED_STEPS):
            batch = {k: v.to(device) for k, v in batch_at(dcfg, i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt, err, m = step(model, opt, err, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
    ref = full["none"]["losses"][:SHARDED_STEPS]
    for i, (a, b) in enumerate(zip(losses, ref)):
        if not _within(a, b):
            raise AssertionError(f"10e(a) step {i}: loss {a} against "
                                 f"10c's {b}")
    res = dict(losses=losses, losses_10c=ref, bit_equal=losses == ref,
               step_ms=float(np.median(secs[2:])) * 1e3,
               step_ms_all=[t * 1e3 for t in secs],
               step_ms_10c=full["none"]["step_ms"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               mesh=[1, 1], tol=LOGIT_TOL)
    del model, opt, err, step
    return res


def moe_forms_phase(device) -> dict:
    """10e(b): granite-moe-3b-a800m's MoE layer at full width (40 experts
    top-8, d 1536, F 512; weights at ``init_moe``'s scales from seed 0),
    x [4, 2048, 1536] bf16, on the one-rank mesh: ``apply_moe_shardmap``
    under ``make_rules`` (EP) equal to ``apply_moe`` bit for bit at the
    config's capacity; ``apply_moe_a2a`` under fsdp_dp with
    ``moe_impl="all_to_all"`` within LOGIT_TOL of ``apply_moe`` at
    capacity factor MOE_FORMS["dropless_cf"], where no choice drops in
    either; device ms of each."""
    import dataclasses
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.parallel.sharding import make_rules, use_shardings
    cfg = get_config(MOE_FORMS["arch"])
    m = cfg.moe
    D, B, S = cfg.d_model, MOE_FORMS["batch"], MOE_FORMS["seq"]
    gen = torch.Generator(device=device).manual_seed(0)
    p = MOE.MoE(D, m, torch.bfloat16, device)
    with torch.no_grad():
        for name, std in (("router", D ** -0.5), ("wup", D ** -0.5),
                          ("wgate", D ** -0.5), ("wdown", m.d_expert ** -0.5)):
            w = getattr(p, name)
            w.copy_(torch.randn(w.shape, generator=gen, device=device) * std)
    x = torch.randn((B, S, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    mesh = make_mesh((1, 1), device=device)
    res = dict(arch=MOE_FORMS["arch"], x=[B, S, D], experts=m.n_experts,
               top_k=m.top_k)
    with torch.no_grad():
        plain, aux = MOE.apply_moe(p, x, m)
        with use_shardings(mesh, make_rules(mesh, cfg)):
            ep, ep_aux = MOE.apply_moe_shardmap(p, x, m)
            res["shardmap_ms"] = _per_call_ms(
                lambda: MOE.apply_moe_shardmap(p, x, m), 3, 3)
        if not (torch.equal(ep, plain) and torch.equal(ep_aux, aux)):
            raise AssertionError("10e(b): apply_moe_shardmap differs from "
                                 "apply_moe")
        res["apply_moe_ms"] = _per_call_ms(lambda: MOE.apply_moe(p, x, m),
                                           3, 3)
        m4 = dataclasses.replace(m, capacity_factor=MOE_FORMS["dropless_cf"])
        _, _, idx = MOE.route(p, x, m4)
        most = int(torch.stack([torch.bincount(r.reshape(-1),
                                               minlength=m.n_experts)
                                for r in idx]).max())
        cap = MOE.capacity(S, m4)
        # the a2a form on one rank: every choice fits the send buffer
        # (C_pair = cf·S·k), then at most C_big land on an expert
        c_big = math.ceil(m4.capacity_factor * math.ceil(
            m4.capacity_factor * S * m.top_k) / m.n_experts)
        if most > min(cap, c_big):
            raise AssertionError(f"10e(b): an expert takes {most} choices, "
                                 f"past capacity {cap} / {c_big}")
        plain4, _ = MOE.apply_moe(p, x, m4)
        rules = make_rules(mesh, cfg, strategy="fsdp_dp",
                           moe_impl="all_to_all")
        with use_shardings(mesh, rules):
            a2a, _ = MOE.apply_moe_a2a(p, x, m4)
            res["a2a_ms"] = _per_call_ms(
                lambda: MOE.apply_moe_a2a(p, x, m4), 3, 3)
        res["a2a_apply_moe_ms"] = _per_call_ms(
            lambda: MOE.apply_moe(p, x, m4), 3, 3)
        torch.testing.assert_close(a2a, plain4, **LOGIT_TOL)
        res.update(a2a_max_abs_err=float((a2a - plain4).abs().max()),
                   shardmap_bit_equal=True, most_choices=most,
                   capacity=cap, a2a_expert_capacity=c_big)
    return res


def rings_phase(device) -> dict:
    """10e(c): the rings and the pipeline on one-rank axes: ring attention
    (RING_ATTN, causal, bf16) against SDPA within LOGIT_TOL; the ring
    collective matmul (RING_MATMUL, bf16) equal to ``torch.matmul``; the
    pipeline (PIPE) on a (1, 1, 1) pod/data/model mesh against ``forward``
    within LOGIT_TOL; device ms of each beside its plain version's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    from repro_torch.models.layers import sdpa_attention
    from repro_torch.parallel.collectives import ring_collective_matmul
    from repro_torch.parallel.pipeline import pipeline_forward
    from repro_torch.parallel.ring_attention import ring_attention
    from repro_torch.parallel.sharding import (make_rules, shard_model,
                                               use_shardings)
    from repro_torch.train import DataConfig, batch_at
    gen = torch.Generator(device=device).manual_seed(1)
    mesh = make_mesh((1, 1), device=device)
    a = RING_ATTN
    q = torch.randn((a["B"], a["S"], a["H"], a["hd"]), generator=gen,
                    device=device).bfloat16()
    k, v = (torch.randn((a["B"], a["S"], a["KV"], a["hd"]), generator=gen,
                        device=device).bfloat16() for _ in range(2))
    ring = ring_attention(mesh, axis="model", causal=True)
    out = ring(q, k, v)
    ref = sdpa_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, **LOGIT_TOL)
    res = dict(ring_attention=dict(
        shape=a, max_abs_err=float((out.float() - ref.float()).abs().max()),
        ms=_per_call_ms(lambda: ring(q, k, v), 3, 3),
        sdpa_ms=_per_call_ms(lambda: sdpa_attention(q, k, v, causal=True),
                             3, 3)))
    del q, k, v, out, ref
    r = RING_MATMUL
    x = torch.randn((r["S"], r["K"]), generator=gen, device=device).bfloat16()
    w = torch.randn((r["K"], r["N"]), generator=gen, device=device).bfloat16()
    rcm = ring_collective_matmul(mesh, "model")
    if not torch.equal(rcm(x, w), torch.matmul(x, w)):
        raise AssertionError("10e(c): the one-rank ring matmul differs from "
                             "torch.matmul")
    res["ring_matmul"] = dict(shape=r, bit_equal=True,
                              ms=_per_call_ms(lambda: rcm(x, w), 5, 3),
                              matmul_ms=_per_call_ms(
                                  lambda: torch.matmul(x, w), 5, 3))
    del x, w
    import dataclasses
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=PIPE["layers"])
    model = init_params(cfg, seed=0, device=device)
    batch = {"tokens": batch_at(DataConfig(
        vocab=cfg.vocab, seq_len=PIPE["seq"], global_batch=PIPE["batch"]),
        0)["tokens"].to(device)}
    with torch.no_grad():
        ref, _ = M.forward(model, batch, train=True)
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"),
                          device=device)
        with use_shardings(mesh3, make_rules(mesh3, cfg)):
            shard_model(model, make_rules(mesh3, cfg))
            pp = lambda: pipeline_forward(
                model, batch, mesh3, n_microbatches=PIPE["microbatches"])
            out = pp()
            res["pipeline"] = dict(ms=_per_call_ms(pp, 2, 3))
        torch.testing.assert_close(out, ref, **LOGIT_TOL)
        res["pipeline"].update(
            PIPE, max_abs_err=float((out.float() - ref.float()).abs().max()),
            forward_ms=_per_call_ms(
                lambda: M.forward(model, batch, train=True), 2, 3))
    return res


def elastic_phase(elastic: ElasticCpuRun) -> dict:
    """10e(d): the CPU ranks' run (ELASTIC_ARGS at mesh 4 × 2, started at
    the script's start) joined; its step_10 resumed on the card on one
    rank through the driver (``--resume auto``): the parameters after the
    restore equal the checkpoint's bit for bit (read at the first step,
    ``launch.train.make_train_step`` wrapped), and the steps 10 and 11
    losses within LOGIT_TOL of the CPU run's."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.launch import train as T
    text, cpu_s = elastic.wait()
    cpu = _printed_losses(text)
    if sorted(cpu) != list(range(12)):
        raise AssertionError(f"10e(d): the CPU run printed steps "
                             f"{sorted(cpu)}")
    checked = []
    real = T.make_train_step

    def make_train_step(tcfg):
        step = real(tcfg)

        def first(model, *args):
            if not checked:
                src = os.path.join(d, "step_10")
                for name, p in model.named_parameters():
                    want = np.load(os.path.join(src, f"params__{name}.npy"))
                    got = p.detach().cpu()
                    if got.dtype == torch.bfloat16:
                        got = got.view(torch.int16).numpy().view(want.dtype)
                    else:
                        got = got.numpy()
                    if got.tobytes() != want.tobytes():
                        raise AssertionError(f"10e(d): {name} after the "
                                             "restore is not the "
                                             "checkpoint's")
                checked.append(len(list(model.parameters())))
            return step(model, *args)
        return first
    with tempfile.TemporaryDirectory() as d:
        shutil.copytree(os.path.join(elastic.ckpt, "step_10"),
                        os.path.join(d, "step_10"))
        T.make_train_step = make_train_step
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                T.main([*ELASTIC_ARGS, "--ckpt", d, "--resume", "auto"])
        finally:
            T.make_train_step = real
    text_card = log.getvalue()
    print(text_card, end="", flush=True)
    if "[resume] restored step 10" not in text_card or not checked:
        raise AssertionError("10e(d): the card did not restore step 10")
    card = _printed_losses(text_card)
    for i in (10, 11):
        if not _within(card[i], cpu[i]):
            raise AssertionError(f"10e(d) step {i}: card {card[i]} against "
                                 f"the CPU ranks' {cpu[i]}")
    return dict(cpu_ranks=ELASTIC_RANKS, cpu_mesh=[4, 2], cpu_run_s=cpu_s,
                cpu_losses=[cpu[i] for i in (10, 11)],
                card_losses=[card[i] for i in (10, 11)],
                params_checked=checked[0], tol=LOGIT_TOL)


def train_parallel_phase(device, full, elastic) -> dict:
    """Phase 10e (after 10c's model is freed): the sharded trainer and
    ``parallel/`` on a one-rank NCCL mesh, each part a function; prints
    ``{"parallel": {...}}``; the group is taken down at the end."""
    import torch
    from repro_torch.launch import mesh as mesh_mod
    res = {}
    try:
        for name, fn in (("sharded_step", lambda: sharded_step_phase(
                              device, full)),
                         ("moe_forms", lambda: moe_forms_phase(device)),
                         ("rings", lambda: rings_phase(device))):
            t0 = time.perf_counter()
            res[name] = fn()
            res[name]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        mesh_mod.shutdown()
    t0 = time.perf_counter()
    res["elastic"] = elastic_phase(elastic)
    res["elastic"]["seconds"] = time.perf_counter() - t0
    print(json.dumps({"parallel": res}), flush=True)
    return res


# -- phase 11: sharded LM serving on a one-rank NCCL mesh -----------------------

# 11a: the cache of each decode check, its filled rows and the sequence
# blocks it is cut into (P blocks of LM_CACHE / P rows; at 0.6 of the cache
# the last blocks of P 4 and 8 lie past kv_len, local kv_len 0)
SPLIT_BLOCKS = (2, 4, 8)
SPLIT_KV_LEN = int(0.6 * LM_CACHE)
# the lse of the kernel against the plain version's: both are float32 sums
# of 2^x terms (the kernel's ex2.approx, ~2 ulp); one key of ~1250 more or
# less moves an lse by ~8e-4, so this bound would show a wrong key
LSE_TOL = dict(rtol=0.0, atol=2e-4)


def split_merge_checks(device) -> dict:
    """11a: at the decode shape of every registered config with attention
    (B LM_BATCH, Sq 1, its H, KV and hd; a cache of LM_CACHE rows, kv_len
    SPLIT_KV_LEN on the device): the kernel's out and lse
    (``return_lse``) against the plain version's (ATTN_TOL's decode bound,
    LSE_TOL); then the cache cut into P sequence blocks (SPLIT_BLOCKS),
    each block through the kernel with its local kv_len (0 past the filled
    rows: out 0, lse −inf, no NaN), merged by ``merge_partials_local``
    — what the ranks of a ``kv_seq`` mesh compute — against the uncut
    kernel's out within ATTN_TOL's decode bound."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.parallel.comm import merge_partials_local
    rng = np.random.default_rng(11)
    tol = ATTN_TOL["flash_attention_decode"]
    res = {}
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        if "attn" not in cfg.layer_pattern():
            continue
        B, H, KV, hd, C = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
            LM_CACHE

        def draw(*shape):
            x = rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(x).to(device, torch.bfloat16)
        q, k, v = draw(B, 1, H, hd), draw(B, C, KV, hd), draw(B, C, KV, hd)
        L = torch.tensor(SPLIT_KV_LEN, dtype=torch.int32, device=device)
        out, lse = flash_attention(q, k, v, kv_len=L, return_lse=True)
        ref, ref_lse = flash_attention_ref(q, k[:, :SPLIT_KV_LEN],
                                           v[:, :SPLIT_KV_LEN],
                                           return_lse=True)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
        row = dict(H=H, KV=KV, G=H // KV, hd=hd, cache=C,
                   kv_len=SPLIT_KV_LEN,
                   out_err=float((out.float() - ref.float()).abs().max()),
                   lse_err=float((lse - ref_lse).abs().max()))
        for P in SPLIT_BLOCKS:
            blk = C // P
            outs, lses, empty = [], [], 0
            for r in range(P):
                local = (L - r * blk).clamp(0, blk).to(torch.int32)
                o, l = flash_attention(q, k[:, r * blk:(r + 1) * blk],
                                       v[:, r * blk:(r + 1) * blk],
                                       kv_len=local, return_lse=True)
                if r * blk >= SPLIT_KV_LEN:      # a block past kv_len
                    empty += 1
                    if not (bool((o == 0).all())
                            and bool(torch.isneginf(l).all())):
                        raise AssertionError(f"11a {arch} P {P}: block {r} "
                                             "past kv_len is not 0 / -inf")
                outs.append(o)
                lses.append(l)
            merged = merge_partials_local(torch.stack(outs),
                                          torch.stack(lses))
            if not bool(torch.isfinite(merged).all()):
                raise AssertionError(f"11a {arch} P {P}: non-finite merge")
            torch.testing.assert_close(merged.float(), out.float(), **tol)
            row[f"P{P}"] = dict(
                blocks_past_kv_len=empty,
                merge_err=float((merged.float() - out.float()).abs().max()))
        res[arch] = row
    torch.cuda.synchronize()
    return dict(tol=tol, lse_tol=LSE_TOL, checks=res)


def lse_row(device, cache: int) -> dict:
    """The kernels line's row of the split-KV route with its lse, at the
    path's call in 11b's ``kv_seq`` decode (LM_ARCH: q [LM_BATCH, 1, H,
    hd] of every head, the whole one-rank cache block, kv_len on the
    device at the prompt + LM_NEW), rotating over caches of
    DECODE_KV_BYTES together as 6a's decode row does (so that its ms
    compares with that row's): ms (graph replay), the plain version's ms,
    SDPA's on the visible keys (its output only), the bound (q, the
    visible k and v, out and lse once)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    cfg = get_config(LM_ARCH)
    B, H, KV, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n = LM_PROMPT + LM_NEW
    rng = np.random.default_rng(12)

    def draw(*shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to(device, torch.bfloat16)
    q = draw(B, 1, H, hd)
    n_caches = -(-int(DECODE_KV_BYTES) // (2 * B * cache * KV * hd * 2))
    kvs = [(draw(B, cache, KV, hd), draw(B, cache, KV, hd))
           for _ in range(n_caches)]
    L = torch.tensor(n, dtype=torch.int32, device=device)
    turn = [0]

    def rotate():
        turn[0] += 1
        return kvs[turn[0] % n_caches]

    def f():
        return flash_attention(q, *rotate(), kv_len=L, return_lse=True)

    def lib():
        k, v = rotate()
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :n].transpose(1, 2),
            v[:, :n].transpose(1, 2), enable_gqa=True)
    k, v = kvs[0]
    out, lse = flash_attention(q, k, v, kv_len=L, return_lse=True)
    ref, ref_lse = flash_attention_ref(q, k[:, :n], v[:, :n],
                                       return_lse=True)
    err = float((out.float() - ref.float()).abs().max())
    torch.testing.assert_close(out.float(), ref.float(),
                               **ATTN_TOL["flash_attention_decode"])
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
    nbytes = 2 * (2 * q.numel() + 2 * B * n * KV * hd) + 4 * B * H
    bound, by = _bound_ms(nbytes, 4 * B * H * hd * n, BF16_FLOPS_PER_S)
    return dict(
        name="flash_attention_decode_lse", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:63",
        launches=0, max_abs_err=err, ms=_graph_ms(f, 3 * n_caches),
        plain_ms=_per_call_ms(lambda: flash_attention_ref(
            q, k, v, kv_len=L, return_lse=True), 3, batches=3),
        bound_ms=bound, bound_by=by,
        library_ms=_graph_ms(lib, 3 * n_caches),
        lse_err=float((lse - ref_lse).abs().max()),
        count_key=_shape_key((B, 1, cache, 1)),
        shape=dict(B=B, Sq=1, Sk=cache, kv_len=n, H=H, KV=KV, hd=hd,
                   caches=n_caches))


def sharded_serving(device, model, mesh, form: str) -> dict:
    """11b, one cache form: LM_ARCH at full width and depth from seed 0
    (6b's weights; ``model``, cut by ``shard_model`` on the one-rank NCCL
    mesh ``mesh``, whole: the blocks of both forms), bf16, under
    ``make_rules`` (``"kv_heads"``) or the same rules with
    ``kv_heads=None`` (``"kv_seq"``: the cache cut along its sequence, one
    block here, each step's attention through the split route with its
    lse and ``merge_partials``): ``prefill`` of 6b's prompt, then LM_NEW
    greedy ``decode_step``s, eager, the flash launches counted from 0 over
    the prefill and the steps; the tokens equal 6b's eager decode and
    every step's logits lie within LOGIT_TOL of 6b's; two more steps run
    under ``torch.cuda.set_sync_debug_mode("error")`` (no host read), and
    four under the profiler (kernels a step, the device's idle share)."""
    import dataclasses
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import make_rules, use_shardings
    cfg = model.cfg
    prompt, cache, frames = _lm_shapes(cfg)
    rules = make_rules(mesh, cfg)
    if form == "kv_seq":
        rules = dataclasses.replace(rules, kv_heads=None)
    torch.cuda.reset_peak_memory_stats()
    batch = _lm_batch(cfg, LM_BATCH, prompt, frames, M.VLM_PATCHES, 0,
                      device)
    with use_shardings(mesh, rules):
        warm = {k: t[:, :64] for k, t in batch.items()}
        _, st, _ = M.prefill(model, warm, 128)
        M.decode_step(model, warm["tokens"][:, :1], st, 64)
        del st
        torch.cuda.synchronize()
        _build.launches.clear()
        _build.shape_launches.clear()
        logits, state, pos = M.prefill(model, batch, cache)
        tok, toks, kept = logits[:, -1].argmax(-1, keepdim=True), [], [logits]
        toks.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LM_NEW):
            logits, state = M.decode_step(model, tok, state, pos + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
            kept.append(logits)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / LM_NEW * 1e3
        launches = dict(_build.launches)
        shapes = _flash_shapes()
        p = torch.tensor(pos + LM_NEW, dtype=torch.int32, device=device)
        torch.cuda.synchronize()
        with _sync_debug_error():
            for _ in range(2):
                logits, state = M.decode_step(model, tok, state, p)
                tok = logits[:, -1].argmax(-1, keepdim=True)
                p = p + 1
        torch.cuda.synchronize()

        def steps4():
            for _ in range(4):
                M.decode_step(model, tok, state, p)
        prof = profile_run(steps4)
    peak = torch.cuda.max_memory_allocated() / 1e9
    seq = torch.cat(toks, dim=1).cpu()
    got = torch.cat(kept, dim=1).float().cpu()
    if not torch.equal(seq, LM_EAGER["tokens"]):
        raise AssertionError(f"11b {form}: tokens {seq[:, :12]}, 6b's "
                             f"{LM_EAGER['tokens'][:, :12]}")
    want = LM_EAGER["logits"].float()
    torch.testing.assert_close(got, want, **LOGIT_TOL)
    n_attn = sum(layer.kind == "attn" for layer in model.layers)
    if launches != {"flash_attention": n_attn * (1 + LM_NEW)}:
        raise AssertionError(f"11b {form}: launches {launches}, expected "
                             f"{n_attn} a prefill and a step")
    del state
    return dict(form=form, rules=dict(heads=rules.heads,
                                      kv_heads=rules.kv_heads,
                                      kv_seq=rules.kv_seq),
                mesh=[1, 1], layers=cfg.n_layers, batch=LM_BATCH,
                prompt=prompt, cache_len=cache, new_tokens=LM_NEW,
                tokens_equal_6b=True,
                logits_max_abs_diff_6b=float((got - want).abs().max()),
                logits_bit_equal_6b=bool(torch.equal(got, want)),
                eager_ms_per_step=step_ms,
                eager_ms_per_step_6b=LM_EAGER["ms_per_step"],
                peak_gb=peak, peak_gb_6b=LM_EAGER["peak_gb"],
                launches=launches, launches_by_shape=shapes,
                sync_free_steps=2, kernels_per_step=prof["kernels"] / 4,
                profile_4_steps=prof)


def serve_parallel_phase(device) -> list:
    """Phase 11: 11a (``split_merge_checks``), then 11b
    (``sharded_serving`` in both cache forms) and the lse row; prints
    ``{"sharded_serving": {...}}``; the group is taken down at the end →
    the kernels line's lse row, its launches those of its shape in 11b's
    ``kv_seq`` run."""
    import torch
    from repro_torch.launch import mesh as mesh_mod
    res = {}
    with phase("11a"):
        res["split_merge"] = split_merge_checks(device)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("11b"):
        from repro_torch.configs import get_config
        from repro_torch.models import model as M
        from repro_torch.parallel.sharding import make_rules, shard_model
        try:
            mesh = mesh_mod.make_mesh((1, 1), device=device)
            cfg = get_config(LM_ARCH)
            model = M.init_params(cfg, seed=0, device=device)
            shard_model(model, make_rules(mesh, cfg))
            for form in ("kv_heads", "kv_seq"):
                res[form] = sharded_serving(device, model, mesh, form)
                gc.collect()
                torch.cuda.empty_cache()
            del model
        finally:
            mesh_mod.shutdown()
        row = lse_row(device, res["kv_seq"]["cache_len"])
    row["launches"] = res["kv_seq"]["launches_by_shape"].get(
        row.pop("count_key"), 0)
    if not row["launches"]:
        raise AssertionError("11b: no launch at the lse row's shape")
    print(json.dumps({"sharded_serving": res, "lse_row": row}), flush=True)
    row.pop("lse_err")
    row.pop("shape")
    return [row]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="SRC", action="append", default=[],
                    help="also time the force kernels of the repro_torch "
                         "in the src/ directory SRC on phase 3's inputs "
                         "(repeatable)")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    others = [Path(p).resolve() for p in opts.compare]
    src = Path(__file__).resolve().parent / "src"
    for tree in (src, *others):
        if not (tree / "repro_torch").is_dir():
            print(f"chip_smoke: {tree}/repro_torch not found",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, str(src))
    refs = CpuRefs(src)
    elastic = ElasticCpuRun(src)
    try:
        return _phases(torch, others, refs, elastic)
    finally:
        refs.close()
        elastic.close()


def _phases(torch, others, refs, elastic) -> int:
    """Phases 1-12 (the module docstring), the CPU references in ``refs``'
    workers."""
    t_all = time.perf_counter()
    import numpy as np
    from repro_torch.core import (LayoutConfig, LayoutStats,
                                  build_hierarchy, multigila_layout)
    from repro_torch.core.multilevel import _build_export, _schedule
    from repro_torch.core.pruning import prune_degree_one
    from repro_torch.graphs import generators
    from repro_torch.graphs.graph import build_graph
    from repro_torch.kernels import _build
    from repro_torch.utils.device import resolve_device

    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # 10e(d)'s CPU ranks, in the background from here
    elastic.start()

    # 1. the card
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    with phase("2"):
        t0 = time.perf_counter()
        _build.load()
        print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
              f"{_build.build_seconds:.2f} s)", flush=True)
    for src, log in sorted(_build.build_log.items()):
        for kernel, info in _ptxas_report(log):
            print(f"  ptxas {src} {kernel}: {info}", flush=True)

    # the main path's graph and its hierarchy (kernel shapes come from it)
    with phase("graph"):
        t0 = time.perf_counter()
        edges, n = generators.delaunay(N_MAIN, seed=0)
        print(f"graph: delaunay({N_MAIN}) n={n} m={len(edges)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        cfg = LayoutConfig()
        pr = prune_degree_one(edges, n)
        g0 = build_graph(pr.edges, pr.n, mass=pr.mass, bucket=True,
                         device=device)
        graphs, infos = build_hierarchy(g0, cfg, device=device)
        scheds = [_schedule(cfg, i, len(graphs), g)
                  for i, g in enumerate(graphs)]
        # phase 8a's reference: the export's levels, derived on the host
        ref_levels = _export_levels(_build_export(
            edges, n, pr, graphs, infos, np.zeros((n, 2), np.float32)))
        del infos

    # 3a. kernels against their plain versions on drawn positions
    with phase("3a"):
        random_cases = random_input_cases(graphs, scheds, device)
        rows = [time_force_case(name, args, consts, shape, "random")
                for name, args, consts, shape in random_cases]
    # 3c. the same inputs at the stress engine's entropy constants
    with phase("3c"):
        stress_constant_checks(random_cases)
    random_cases = [c + (0,) for c in random_cases]
    del g0
    torch.cuda.empty_cache()

    # 4. the main path: through the step cache, cold and warm, and eagerly
    with phase("4"):
        run = lambda: multigila_layout(edges, n, cfg)
        runs = cached_and_eager("main_path", run, n, edges,
                                [r["name"] for r in rows])
        launches, main_neld = runs["cold"]["launches"], runs["cold"]["neld"]
        wall = runs["warm"]["wall_s"]
        for r in rows:
            r["launches"] = launches[r["name"]]
        stats = LayoutStats(levels=len(runs["cold"]["level_sizes"]),
                            level_sizes=runs["cold"]["level_sizes"],
                            level_modes=runs["cold"]["level_modes"])
        print(json.dumps(dict(
            main_path=f"delaunay({N_MAIN})", n=n, m=int(len(edges)),
            level_sizes=stats.level_sizes, level_modes=stats.level_modes,
            launches=launches, neld=main_neld)), flush=True)
        # profiled: the warm cached run, then the eager run with its force
        # calls' first arguments at each level kept
        _build.launches.clear()
        prof = profile_run(run)
        if dict(_build.launches) != launches:
            raise AssertionError(f"profiled run launched "
                                 f"{dict(_build.launches)}, the timed run "
                                 f"{launches}")
        _build.launches.clear()
        with EagerRefine(), PathInputs() as rec:
            prof_eager = profile_run(run)
        if dict(_build.launches) != launches:
            raise AssertionError(f"profiled eager run launched "
                                 f"{dict(_build.launches)}, the timed "
                                 f"{launches}")
        print(json.dumps(dict(profile=prof, profile_eager=prof_eager)),
              flush=True)
    # 4f. the refine phase level by level; 4e. replayed iterations against
    # the eager loop at each mode's level
    with phase("4f"):
        refine_breakdown(graphs, scheds, "gila")
    with phase("4e"):
        replay_vs_eager(graphs, scheds, "gila")

    # 3b. the force kernels on the path's own inputs, one row a shape with
    # that shape's launches
    with phase("3b"):
        path_cases = rec.by_level(stats.level_sizes)
        for name in _FORCE_KERNELS:
            per_shape = sum(c[4] for c in path_cases if c[0] == name)
            if per_shape != launches[name]:
                raise AssertionError(f"{name}: {per_shape} calls recorded, "
                                     f"{launches[name]} launched")
        for name, args, consts, shape, calls in path_cases:
            rows.append(time_force_case(name, args, consts, shape, "path",
                                        launches=calls))
    if others:
        compare_trees(others, random_cases + path_cases)
    del rec, path_cases, random_cases
    torch.cuda.empty_cache()

    # 4b-4d. the weighted stress path, the flat driver, the weighted
    # hierarchy card vs CPU, all on the main path's graph
    weights = np.random.default_rng(0).uniform(
        WEIGHT_LO, WEIGHT_HI, len(edges)).astype(np.float32)
    with phase("4b"):
        stress = stress_path(edges, n, weights, (stats, launches), graphs,
                             scheds)
    for r in rows:              # a random row carries the kernel's totals
        if r["inputs"] == "random":
            r["stress_launches"] = stress["launches"][r["name"]]
    # 4g. every cached refine step under sync-debug "error"
    with phase("4g"):
        t = time.perf_counter()
        sync_free_refine(graphs, scheds)
        print(json.dumps({"sync_free_refine_s": time.perf_counter() - t}),
              flush=True)
    del graphs
    with phase("4c"):
        flat_path(edges, n, wall, main_neld)

    # the CPU references of 4d, 5, 5b, 5d and 9c, in workers from here to
    # phase 7, beside the card's phases 4d-6
    e5, n5 = generators.delaunay(5000, seed=3)
    cfg5 = LayoutConfig(exact_threshold=64, grid_threshold=512)
    refs.start(cpu_ref_tasks(edges, n, weights, e5, n5, cfg5, refs.dir))
    with phase("4d"):
        hier_4d = weighted_hierarchy_card(edges, n, weights)
    torch.cuda.empty_cache()

    # 5. small graph: card hierarchy == CPU hierarchy; layouts agree (the
    # checks after phase 6); 5b-5c. the stress engine and the other
    # drivers; the CLI; 5d. the batched driver
    with phase("5"):
        small = small_card(e5, n5, cfg5)
    with phase("5b"):
        engines = engines_card(e5, n5, cfg5)
    with phase("5c"):
        cli_on_card()
    with phase("5d"):
        many5d = many_card()

    # 6. the LM serving path, one model after another
    torch.cuda.empty_cache()
    for arch in LM_ARCHS:
        rows += lm_phase(device, arch)

    # every CPU reference done before phase 7's walls; then the checks of
    # 4d, 5, 5b and 5d against theirs (9c's in phase 9)
    with phase("cpu_refs_wait"):
        refs.join()
    with phase("4d"):
        weighted_hierarchy_card_vs_cpu(n, hier_4d, refs.get("4d"))
    with phase("5"):
        small_card_vs_cpu(n5, small, refs.get("5"))
    with phase("5b"):
        engines_card_vs_cpu(n5, cfg5, engines, refs)
    with phase("5d"):
        many_card_vs_cpu(many5d, refs.get("5d"))
    del hier_4d, small, engines, many5d
    print(json.dumps({"cpu_refs": refs.seconds}), flush=True)

    # 7. the batched driver: suites A and B; 3d. the lane kernels on the
    # shapes it launched
    torch.cuda.empty_cache()
    with phase("7"):
        many, lane = many_phase()
    PHASE_SECONDS["7"] -= PHASE_SECONDS["3d"]
    rows += lane
    del many
    torch.cuda.empty_cache()

    # 8. serving on the card: export and pyramid at 1M, viewport queries,
    # the store, the continuous engine, the HTTP front door
    serving_phase(edges, n, ref_levels, card)
    del ref_levels
    torch.cuda.empty_cache()

    # 9. the sharded driver over a one-rank NCCL group
    near_rows, _ = dist_phase(edges, n, runs["warm"], scheds, e5, n5, cfg5,
                              refs)
    rows += near_rows
    torch.cuda.empty_cache()

    # 10. LM training: every smoke config and three full-width models card
    # vs CPU, internlm2-1.8b at full size through the driver, a resume, the
    # sharded trainer and parallel/ on a one-rank mesh
    train_phase(device, refs, elastic)
    torch.cuda.empty_cache()

    # 11. sharded serving over a one-rank NCCL mesh
    with phase("11"):
        rows += serve_parallel_phase(device)
    torch.cuda.empty_cache()

    # 12. summary
    if any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
           for m in sys.modules):
        raise AssertionError("JAX or the JAX package was imported")
    PHASE_SECONDS["total"] = time.perf_counter() - t_all
    print(json.dumps({"phase_seconds": PHASE_SECONDS}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
