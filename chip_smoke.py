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
  6. the LM serving path, internlm2-1.8b at its published width and depth
     (24 layers) in bf16, weights drawn from a seed on the card:
     a. the flash-attention kernel against its plain version at the path's
        two shapes, on its layout — prefill (B 4, Sq = Sk = 2048, 16 heads
        over 8 KV heads, hd 128, causal; k/v = cache[:, :2048] of a
        2088-row cache: the wgmma route) and decode (Sq 1 against the
        whole 2088-row cache with ``kv_len`` an int32 on the device, as
        ``decode_step`` calls it, checked at kv_len 2049, 2065 and 2080 and
        timed at 2080, rotating over 3 caches that together exceed the L2:
        the split-KV route) — timed as device time per call (CUDA-graph
        replay) and eagerly (host work included), beside
        ``scaled_dot_product_attention`` timed the same ways as a
        yardstick, with the bound max(bytes / 3.35 TB/s, flops / 989
        TFLOP/s bf16);
     b. ``repro_torch.models.prefill`` of a 4 × 2048-token prompt, then 32
        greedy steps of the captured decode (``models.compile_decode``: one
        CUDA graph of a step, ``pos`` and ``kv_len`` on the device; a cold
        sequence that captures, then a warm one that is timed) beside 32
        eager ``decode_step``s: the same greedy tokens, prefill seconds,
        decode ms a step and tokens/s of both, flash launches (24 per
        prefill, 24 per step, replays included), every logit finite; then
        prefill and each decode under torch.profiler (device busy share);
     c. a 2-layer model at full width, the same weights on the card and on
        the CPU (plain attention there): prefill's last-token logits and the
        first decode step's agree within LOGIT_TOL;
  7. the batched driver, ``multigila_layout_many``, at the size a layout
     service's tenants submit: suite A, SUITE_A graphs
     ``generators.delaunay(5_000, seed=100+i)`` (L0 neighbor, coarser
     levels exact; L0 lanes at n_pad 8192), default ``LayoutConfig()``,
     cold (cache cleared), warm (profiled: device busy and idle share) and
     through as many warm sequential ``multigila_layout`` calls; then the
     same with ``engines=["stress"]`` for every graph and weights U(0.5, 2) from
     ``default_rng(i)``; suite B, SUITE_B graphs
     ``generators.delaunay(50_000, seed=200+i)`` (L0 grid, L1 neighbor),
     the same runs. Each prints wall, graphs/s, phase seconds, the cache's
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
        beside it;
        then the refine loop of grid level 1, staged on its warm entry,
        runs under ``torch.cuda.set_sync_debug_mode("error")``;
     c. phase 5's graph (all three modes), gila then stress with phase
        5b's weights, on the card against the CPU's run over the same
        one-rank group (gloo): hierarchy equal bit for bit, ``ewt``
        included, NELD and CRE within phase 5's deltas;
     d. the layout CLI with ``--driver multigila_dist --mesh 1x1`` in
        process on the card;
  10. the ``{"kernels": [...]}`` summary, the card line, and
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
# had 64 graphs until phase 8 joined the script; 32 keep it inside the
# time limit (each of its runs took ~30 s at 64 graphs)
SUITE_A = (32, 5_000, 100)
SUITE_B = (8, 50_000, 200)
LANES_5D = 8                          # suite A's first graphs, card vs CPU
LM_ARCH = "internlm2-1.8b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_CACHE = LM_PROMPT + LM_NEW + 8     # decode reads a strided cache slice
DECODE_CACHES = 3                     # 3 × 34 MB of k/v: more than the L2
# decode's device kv_len at phase 6a's checks: the path's first and last
# (2049 reads one key of the last split chunk) and one between; it is timed
# at the last
DECODE_KV_LENS = (LM_PROMPT + 1, LM_PROMPT + 17, LM_PROMPT + LM_NEW)
# attention kernel vs plain, bf16: both round the output to bf16 (one ulp is
# 2^-8 relative) and round p to bf16 at different points. The atol follows
# each shape's output size: a prefill row near the diagonal averages few
# values of v (|out| up to ~4), a decode row averages 2080 of them, so its
# outputs are ~0.04 and an atol of 1e-2 there would hide a wrong key.
ATTN_TOL = dict(flash_attention_prefill=dict(rtol=1e-2, atol=1e-2),
                flash_attention_decode=dict(rtol=1e-2, atol=2e-3))
# card vs CPU logits of the 2-layer full-width model, both bf16: the same
# function with sums in another order (cuBLAS vs the CPU's GEMMs), the
# kernel's p rounding, and bf16 activations between layers; a logit near 4
# has a bf16 ulp of 0.016
LOGIT_TOL = dict(rtol=0.02, atol=0.1)


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


def profile_run(fn) -> dict:
    """One more run of ``fn`` under torch.profiler — device time by kernel
    and the device's busy share of the wall clock. Only device activity is
    recorded, and read from the profiler's raw results: host ops would
    inflate the idle share, and building the profiler's Python event tree
    for the batched phase's runs takes longer than the runs. The profiler
    still slows the host, so the wall here is longer than the unprofiled
    run's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3       # µs
        spans.append((s, t))
        ms, cnt = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + (t - s) / 1e3, cnt + 1)
    if not spans:
        raise AssertionError("profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):                 # union of device intervals
        if t > end:
            busy_us += t - max(s, end)
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(wall_s=wall, device_busy_s=busy_us / 1e6,
                idle_share=1.0 - busy_us / 1e6 / wall,
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


def attention_checks(device) -> list:
    """Phase 6a: the flash-attention kernel against its plain version at the
    LM path's prefill and decode shapes, on the path's own layout and
    calls: prefill reads slices ``cache[:, :2048]`` of LM_CACHE-row caches;
    decode reads the whole cache with ``kv_len`` on the device (checked at
    each of DECODE_KV_LENS against the plain version on ``cache[:, :kv_len]``,
    timed at the last) and rotates over DECODE_CACHES caches (more than the
    50 MB L2 together), as the 24 layers each read their own. SDPA is timed
    on the keys the kernel reads as a yardstick.
    ``ms`` and ``library_ms`` are device time per call (CUDA-graph replay);
    ``eager_ms`` and ``library_eager_ms`` time the same calls made back to
    back from Python, host work included."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = get_config(LM_ARCH)
    B, H, KV, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(7)

    def draw(*shape):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return x.to(device, torch.bfloat16)

    def caches(n):
        return [(draw(B, LM_CACHE, KV, hd), draw(B, LM_CACHE, KV, hd))
                for _ in range(n)]

    kv_len = LM_PROMPT + LM_NEW
    cases = [
        # name, q, caches, keys read, kv_lens checked (None: the cache is
        # sliced on the host), causal, (query, key) pairs, calls per graph
        ("flash_attention_prefill", draw(B, LM_PROMPT, H, hd), caches(1),
         LM_PROMPT, None, True, LM_PROMPT * (LM_PROMPT + 1) // 2, 10),
        ("flash_attention_decode", draw(B, 1, H, hd), caches(DECODE_CACHES),
         kv_len, DECODE_KV_LENS, True, kv_len, 3 * DECODE_CACHES),
    ]
    rows = []
    for name, q, cs, Sk, checked, causal, pairs, calls in cases:
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
            torch.testing.assert_close(out.float(), ref.float(),
                                       **ATTN_TOL[name])
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
        print(json.dumps(dict(row, shape=dict(
            B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, hd=hd, causal=causal,
            k_batch_stride=k.stride(0), caches=len(kvs),
            capacity=cs[0][0].shape[1],
            kv_len_on_device=checked is not None,
            kv_lens_checked=list(checked or (Sk,))),
            eager_ms=eager_ms, library_eager_ms=library_eager_ms,
            library_max_abs_err=lib_err, tol=ATTN_TOL[name])), flush=True)
        rows.append(row)
    return rows


def lm_main_path(device) -> dict:
    """Phase 6b: internlm2-1.8b, full width and depth, bf16: prefill of a
    LM_BATCH × LM_PROMPT prompt, then LM_NEW greedy steps of the captured
    decode (``compile_decode``) beside LM_NEW eager ``decode_step``s, with
    the flash launches of each counted from 0. The captured decode runs
    twice: the first sequence captures the step (its first step runs
    eagerly), the second is timed; all three give the same tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    # warm-up (cuBLAS handles and kernels' first launches), not counted
    M.decode_step(model, tokens[:, :1],
                  M.prefill(model, {"tokens": tokens[:, :64]}, 128)[1], 64)
    torch.cuda.synchronize()

    _build.launches.clear()
    t0 = time.perf_counter()
    logits, state, pos = M.prefill(model, {"tokens": tokens}, LM_CACHE)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(_build.launches)
    finite = torch.isfinite(logits).all()
    first = logits[:, -1].argmax(-1, keepdim=True)

    # the eager step, LM_NEW times
    tok, out = first, [first]
    _build.launches.clear()
    t0 = time.perf_counter()
    for i in range(LM_NEW):
        logits, state = M.decode_step(model, tok, state, pos + i)
        finite &= torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_launches = dict(_build.launches)
    eager_seq = torch.cat(out, dim=1).cpu()
    if logits.shape != (LM_BATCH, 1, cfg.vocab_padded):
        raise AssertionError(f"LM path: logits shape {tuple(logits.shape)}")
    del state

    # the captured step: a cold sequence (capture), then a warm one (timed)
    dec = M.compile_decode(model, LM_BATCH, LM_CACHE)
    seqs, secs, launches = [], [], []
    for _ in range(2):
        _, state, pos = M.prefill(model, {"tokens": tokens}, LM_CACHE)
        dec.start(state, first, pos)
        del state
        out = [first]
        torch.cuda.synchronize()
        _build.launches.clear()
        t0 = time.perf_counter()
        for i in range(LM_NEW):
            finite &= torch.isfinite(dec.step()).all()
            out.append(dec.token.clone())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(dict(_build.launches))
        seqs.append(torch.cat(out, dim=1).cpu())
    graph_s = secs[1]

    if not bool(finite):
        raise AssertionError("LM path: non-finite logits")
    for s in seqs:
        if not torch.equal(s, eager_seq):
            raise AssertionError(f"captured decode tokens {s[:, :12]}, "
                                 f"eager {eager_seq[:, :12]}")
    want = {"flash_attention": cfg.n_layers}
    if prefill_launches != want:
        raise AssertionError(f"prefill launches {prefill_launches}, "
                             f"expected {want}")
    want = {"flash_attention": cfg.n_layers * LM_NEW}
    for got in (eager_launches, *launches):
        if got != want:
            raise AssertionError(f"decode launches {got}, expected {want}")

    prof_prefill = profile_run(
        lambda: M.prefill(model, {"tokens": tokens}, LM_CACHE))
    st = M.prefill(model, {"tokens": tokens}, LM_CACHE)[1]
    t = eager_seq[:, :1].to(device)

    def decode8():
        for i in range(8):
            M.decode_step(model, t, st, LM_PROMPT + i)

    def graph8():
        for _ in range(8):
            dec.step()
    prof_decode = profile_run(decode8)
    prof_graph = profile_run(graph8)
    return dict(
        lm=LM_ARCH, params=cfg.param_count(), dtype="bfloat16",
        batch=LM_BATCH, prompt=LM_PROMPT, new_tokens=LM_NEW,
        cache_len=LM_CACHE, init_s=init_s, prefill_s=prefill_s,
        prefill_tok_per_s=LM_BATCH * LM_PROMPT / prefill_s,
        decode_s=graph_s, decode_tok_per_s=LM_BATCH * LM_NEW / graph_s,
        decode_ms_per_step=graph_s / LM_NEW * 1e3,
        decode_capture_sequence_s=secs[0],
        eager_decode_s=eager_s,
        eager_decode_ms_per_step=eager_s / LM_NEW * 1e3,
        eager_decode_tok_per_s=LM_BATCH * LM_NEW / eager_s,
        tokens_equal_eager=True,
        launches=dict(prefill=prefill_launches["flash_attention"],
                      decode=launches[1]["flash_attention"],
                      eager_decode=eager_launches["flash_attention"]),
        logits_finite=True, sample=eager_seq[0, :12].tolist(),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile_prefill=prof_prefill, profile_decode_8_steps=prof_decode,
        profile_graph_decode_8_steps=prof_graph)


def lm_card_vs_cpu(device) -> dict:
    """Phase 6c: a 2-layer internlm2-1.8b at full width, the same bf16
    weights on the card and on the CPU: prefill's last-token logits and the
    first decode step's logits agree within LOGIT_TOL."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2)
    card = M.init_params(cfg, seed=1, device=device)
    cpu = M.LM(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 130)))
    res = {}
    lg_card, st_card, pos = M.prefill(card, {"tokens": tokens.to(device)}, 144)
    lg_cpu, st_cpu, _ = M.prefill(cpu, {"tokens": tokens}, 144)
    tok = lg_cpu[:, -1].argmax(-1, keepdim=True)
    d_card, _ = M.decode_step(card, tok.to(device), st_card, pos)
    d_cpu, _ = M.decode_step(cpu, tok, st_cpu, pos)
    for name, a, b in (("prefill", lg_card, lg_cpu), ("decode", d_card, d_cpu)):
        a, b = a.float().cpu(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"card vs CPU {name}: non-finite logits")
        res[name] = dict(max_abs_err=float((a - b).abs().max()),
                         max_abs_logit=float(b.abs().max()),
                         argmax_agree=float((a.argmax(-1) == b.argmax(-1))
                                            .float().mean()))
        print(json.dumps({f"card_vs_cpu_{name}": res[name]}), flush=True)
        torch.testing.assert_close(a, b, **LOGIT_TOL)
    return dict(res, layers=2, d_model=cfg.d_model, tokens=list(tokens.shape),
                tol=LOGIT_TOL)


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


def _assert_hierarchies_equal(label, card, cpu) -> None:
    """Level sizes and every coarse-graph and LevelInfo array equal, bit for
    bit (two hierarchies on any devices: card against CPU, or two runs)."""
    import torch
    (gc, ic), (gh, ih) = card, cpu
    if [(g.n, g.m) for g in gc] != [(g.n, g.m) for g in gh]:
        raise AssertionError(f"{label}: level sizes differ")
    for a, b in zip(ic, ih):
        for field in ("parent_coarse", "sun_of", "depth", "state",
                      "sun_pos_index"):
            if not torch.equal(getattr(a, field).cpu(),
                               getattr(b, field).cpu()):
                raise AssertionError(f"{label}: {field} differs")
    for a, b in zip(gc, gh):
        for field in ("src", "dst", "vmask", "emask", "mass", "ewt"):
            if not torch.equal(getattr(a, field).cpu(),
                               getattr(b, field).cpu()):
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


def weighted_hierarchy_card_vs_cpu(edges, n, weights) -> dict:
    """Phase 4d: the main path's graph with its weights, hierarchy built on
    the card and on the CPU: equal bit for bit, ``ewt`` included."""
    from repro_torch.core import LayoutConfig
    cfg = LayoutConfig()
    card, card_s = _hierarchy(edges, n, cfg, "cuda", weights)
    cpu, cpu_s = _hierarchy(edges, n, cfg, "cpu", weights)
    _assert_hierarchies_equal(f"weighted delaunay({n})", card, cpu)
    res = dict(weighted_hierarchy=f"delaunay({n})",
               level_sizes=[(g.n, g.m) for g in card[0]],
               card_build_s=card_s, cpu_build_s=cpu_s, equal=True)
    print(json.dumps(res), flush=True)
    return res


def engines_card_vs_cpu(e5, n5, cfg5) -> dict:
    """Phase 5b: the ported engine and drivers, card against CPU, on the
    phase-5 graph (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import LayoutConfig, bucketing, gila
    from repro_torch.core import multigila_layout
    from repro_torch.core.multilevel import _build_export, _schedule
    from repro_torch.graphs.graph import build_graph
    from repro_torch.graphs.metrics import cre, neld

    w5 = np.random.default_rng(0).uniform(WEIGHT_LO, WEIGHT_HI,
                                          len(e5)).astype(np.float32)
    res = {}
    cases = (("stress_weighted", dataclasses.replace(cfg5, engine="stress"),
              w5, True),
             ("centralized", LayoutConfig(driver="centralized"), None, True),
             ("flat", LayoutConfig(driver="flat"), None, False))
    for name, cfg, w, cre_compared in cases:
        if w is not None:
            _assert_hierarchies_equal(
                f"{name} delaunay({n5})", _hierarchy(e5, n5, cfg, "cuda", w)[0],
                _hierarchy(e5, n5, cfg, "cpu", w)[0])
        t0 = time.perf_counter()
        p_card, s_card = multigila_layout(e5, n5, cfg, weights=w)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p_cpu, s_cpu = multigila_layout(e5, n5, cfg, weights=w, device="cpu")
        cpu_s = time.perf_counter() - t0
        if not np.isfinite(p_card).all():
            raise AssertionError(f"{name} on the card: non-finite")
        if s_card.level_sizes != s_cpu.level_sizes:
            raise AssertionError(f"{name}: level sizes differ")
        q = {k: (neld(p, e5), cre(p, e5)) for k, p in
             (("cuda", p_card), ("cpu", p_cpu))}
        row = dict(level_sizes=s_card.level_sizes,
                   level_modes=s_card.level_modes, neld_cre=q,
                   card_s=card_s, cpu_s=cpu_s,
                   hierarchy_equal=True if w is not None else None,
                   cre_compared=cre_compared)
        if name == "flat":
            # the driver's own random init, then 5 iterations of its level
            gs = {d: build_graph(e5, n5, bucket=True, device=d)
                  for d in ("cuda", "cpu")}
            sched = dataclasses.replace(
                _schedule(cfg, 0, 1, gs["cpu"]), iters=5)
            scale = cfg.ideal_len * max(n5, 4) ** 0.5
            p0 = {d: gila.random_init(g, scale, cfg.seed)
                  for d, g in gs.items()}
            if not torch.equal(p0["cuda"].cpu(), p0["cpu"]):
                raise AssertionError("flat: random init differs")
            early = {d: bucketing.refine_level(
                g, p0[d], sched, ideal_len=cfg.ideal_len,
                rep_const=cfg.rep_const, seed=cfg.seed).cpu()
                for d, g in gs.items()}
            row["first_5_iterations_max_abs_diff"] = float(
                (early["cuda"] - early["cpu"]).abs().max())
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
                 seeds=None) -> dict:
    """One ``multigila_layout_many`` call with the launch counts set to 0
    just before it and read just after, under a ``ManyRecorder``: wall,
    graphs/s, phase seconds (the graphs' sums), the cache's
    entries/hits/misses, resident and peak GB, waves and groups a wave,
    launches by kernel and by shape (on the card, each shape's count must
    equal the budgets of the groups at that shape), and every position
    finite."""
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
        t0 = time.perf_counter()
        outs = multigila_layout_many(graphs, cfg, seeds=seeds,
                                     engines=engines, weights=weights,
                                     device=device)
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
    return dict(res, outs=outs, rec=rec, shape_counts=shape_launches)


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
    cleared) and warm, the warm run profiled, then the same graphs through
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
    prof = profile_run(lambda: (multigila_layout_many(
        graphs, cfg, engines=engines, weights=weights), None))
    # the single-graph entries warmed by the first graph, then timed
    _sequential_run(f"{label}_sequential_warm_up", graphs[:1], cfg,
                    engines=engines, weights=weights and weights[:1])
    runs["seq"] = _sequential_run(f"{label}_sequential", graphs, cfg,
                                  engines=engines, weights=weights)
    spread = cold_warm = None
    if cre_too:
        moved = _batched_run(f"{label}_batched_seeds_moved", graphs, cfg,
                             engines=engines, weights=weights,
                             seeds=[cfg.seed + SPREAD_SEED] * len(graphs))
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


def many_card_vs_cpu() -> dict:
    """Phase 5d: the first LANES_5D graphs of suite A with
    exact_threshold=64, grid_threshold=512 (all three modes) through
    ``multigila_layout_many`` on the card (and again with every seed moved
    by SPREAD_SEED) and on the CPU: each lane's hierarchy equal bit for
    bit and NELD within NELD_DELTA, for the batched and the sequential
    driver on the card against the CPU. CRE is held lane by lane on one
    device, where its spread over the seed is measured: the batched lanes
    against the sequential driver's on the card within max(CRE_DELTA,
    CRE_SPREAD_MULT × the median gap between the card's batched runs with
    the seeds as given and moved). Against the CPU each driver's lanes'
    mean is held (``_lanes_against``) and each lane printed: the card's
    arithmetic moves one lane's CRE from the CPU's by 0.10–0.18 under
    either driver while two card runs differ by at most 0.06 there
    (``ROADMAP.md`` queue 3)."""
    from repro_torch.core import LayoutConfig
    graphs = _suite(LANES_5D, SUITE_A[1], SUITE_A[2])
    cfg = LayoutConfig(exact_threshold=64, grid_threshold=512)
    card = _batched_run("many_5d_card", graphs, cfg)
    moved = _batched_run("many_5d_card_seeds_moved", graphs, cfg,
                         seeds=[cfg.seed + SPREAD_SEED] * len(graphs))
    cpu = _batched_run("many_5d_cpu", graphs, cfg, device="cpu")
    modes = {m for _, s in card["outs"] for m in s.level_modes}
    if modes != {"exact", "neighbor", "grid"}:
        raise AssertionError(f"phase 5d: modes {modes}")
    spread = _cre_gaps("many_5d_card_seed_spread", graphs, card,
                       moved)["median_abs"]
    seq = _sequential_run("many_5d_card_sequential", graphs, cfg)
    _lanes_against("many_5d_card_vs_card_sequential", graphs, card, seq,
                   cre_spread=spread)
    _lanes_against("many_5d_card_sequential_vs_cpu", graphs, seq, cpu,
                   cre_spread=spread, lane_cre=False)
    return _lanes_against("many_5d_card_vs_cpu", graphs, card, cpu,
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
    return out, lane_rows(cases, launches)


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


def time_near_field(args, shape, form, launches, per_cell_ms) -> dict:
    """One near_field input: against its plain version and itself (bit for
    bit), timed as phase 3 times a row; ``per_cell_ms`` is the per-cell
    ``grid_near`` kernel's device time on the same level's positions."""
    import torch
    from repro_torch.kernels.grid_force import ops as grid_ops
    from repro_torch.kernels.grid_force.ref import near_field_ref
    rows, near9, cells, consts, kw = args
    f = lambda: grid_ops.near_field(rows, near9, cells, consts, **kw)
    p = lambda: near_field_ref(rows, near9, cells, consts[0], consts[1],
                               **kw)
    out, again = f(), f()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"near_field {form}: two calls differ")
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
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.iterate()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pos = run.gather()
    if not bool(torch.isfinite(pos).all()) or torch.equal(run.pos, start):
        raise AssertionError("sync-free loop: positions not finite/unmoved")
    res = dict(sync_free_loop=f"level {level}: {g.n} of {g.n_pad}",
               iterations=run.iters, wall_s=wall, sync_debug_mode="error")
    print(json.dumps(res), flush=True)
    return res


def dist_card_vs_cpu(e5, n5, cfg5) -> dict:
    """Phase 9c: the sharded driver on phase 5's graph (all three modes),
    mesh 1x1, gila then stress with phase 5b's weights, on the card (NCCL)
    against the CPU (gloo, the same one-rank group): the hierarchy equal
    bit for bit (``ewt`` included), levels and modes equal, NELD and CRE
    within phase 5's deltas."""
    import dataclasses

    import numpy as np
    from repro_torch.core import multigila_layout
    from repro_torch.graphs.metrics import cre, neld
    w5 = np.random.default_rng(0).uniform(WEIGHT_LO, WEIGHT_HI,
                                          len(e5)).astype(np.float32)
    base = dataclasses.replace(cfg5, driver="multigila_dist",
                               mesh_shape=(1, 1))
    res = {}
    for name, cfg, w in (("gila", base, None),
                         ("stress_weighted",
                          dataclasses.replace(base, engine="stress"), w5)):
        _assert_hierarchies_equal(
            f"dist {name} delaunay({n5})",
            _hierarchy(e5, n5, cfg, "cuda", w)[0],
            _hierarchy(e5, n5, cfg, "cpu", w)[0])
        t0 = time.perf_counter()
        p_card, s_card = multigila_layout(e5, n5, cfg, weights=w)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p_cpu, s_cpu = multigila_layout(e5, n5, cfg, weights=w, device="cpu")
        cpu_s = time.perf_counter() - t0
        if not np.isfinite(p_card).all():
            raise AssertionError(f"dist {name} on the card: non-finite")
        if (s_card.level_sizes, s_card.level_modes) != (s_cpu.level_sizes,
                                                        s_cpu.level_modes):
            raise AssertionError(f"dist {name}: levels differ")
        q = {k: (neld(p, e5), cre(p, e5)) for k, p in
             (("cuda", p_card), ("cpu", p_cpu))}
        row = dict(level_sizes=s_card.level_sizes,
                   level_modes=s_card.level_modes, neld_cre=q,
                   card_s=card_s, cpu_s=cpu_s, hierarchy_equal=True,
                   gaps=dict(neld=q["cuda"][0] - q["cpu"][0],
                             cre=q["cuda"][1] - q["cpu"][1]))
        print(json.dumps({f"dist_small_{name}": row}), flush=True)
        if (abs(q["cuda"][0] - q["cpu"][0]) > NELD_DELTA
                or abs(q["cuda"][1] - q["cpu"][1]) > CRE_DELTA):
            raise AssertionError(f"dist {name}: quality differs, card vs "
                                 f"CPU: {q}")
        res[name] = row
    return res


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


def dist_phase(edges, n, main, scheds, e5, n5, cfg5) -> tuple:
    """Phase 9, the sharded driver on the card over a one-rank NCCL group
    (made through a FileStore by ``launch.mesh.make_host_mesh`` and
    destroyed at the end): 9b the 1M layout with
    ``LayoutConfig(driver="multigila_dist", mesh_shape=(1, 1))``, cold then
    warm (the latter recording near_field's arguments); 9a the near_field
    rows; the sync-free loop of grid level 1; 9c card against CPU at 5k;
    9d the CLI. ``main`` is phase 4's warm run, ``scheds`` its schedules.
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
        small = dist_card_vs_cpu(e5, n5, cfg5)
        secs["9c"] = time.perf_counter() - t
        t = time.perf_counter()
        cli = dist_cli_on_card()
        secs["9d"] = time.perf_counter() - t
    finally:
        bucketing.STEP_CACHE.clear()
        mesh_mod.shutdown()
    secs["phase"] = time.perf_counter() - t_phase
    summary = dict(runs=runs, sync_free=loop, small=small, cli=cli,
                   seconds=secs)
    print(json.dumps({"dist_seconds": secs}), flush=True)
    return rows, summary


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
    import numpy as np
    from repro_torch.core import (LayoutConfig, LayoutStats,
                                  build_hierarchy, multigila_layout)
    from repro_torch.core.multilevel import _build_export, _schedule
    from repro_torch.core.pruning import prune_degree_one
    from repro_torch.graphs import generators
    from repro_torch.graphs.graph import build_graph
    from repro_torch.graphs.metrics import cre, neld
    from repro_torch.kernels import _build
    from repro_torch.utils.device import resolve_device

    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)",
          flush=True)
    for src, log in sorted(_build.build_log.items()):
        for kernel, info in _ptxas_report(log):
            print(f"  ptxas {src} {kernel}: {info}", flush=True)

    # the main path's graph and its hierarchy (kernel shapes come from it)
    t0 = time.perf_counter()
    edges, n = generators.delaunay(N_MAIN, seed=0)
    print(f"graph: delaunay({N_MAIN}) n={n} m={len(edges)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cfg = LayoutConfig()
    pr = prune_degree_one(edges, n)
    g0 = build_graph(pr.edges, pr.n, mass=pr.mass, bucket=True, device=device)
    graphs, infos = build_hierarchy(g0, cfg, device=device)
    scheds = [_schedule(cfg, i, len(graphs), g) for i, g in enumerate(graphs)]
    # phase 8a's reference: the export's levels, derived on the host
    ref_levels = _export_levels(_build_export(
        edges, n, pr, graphs, infos, np.zeros((n, 2), np.float32)))
    del infos

    # 3a. kernels against their plain versions on drawn positions
    random_cases = random_input_cases(graphs, scheds, device)
    rows = [time_force_case(name, args, consts, shape, "random")
            for name, args, consts, shape in random_cases]
    # 3c. the same inputs at the stress engine's entropy constants
    stress_constant_checks(random_cases)
    random_cases = [c + (0,) for c in random_cases]
    del g0
    torch.cuda.empty_cache()

    # 4. the main path: through the step cache, cold and warm, and eagerly
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
        raise AssertionError(f"profiled run launched {dict(_build.launches)}"
                             f", the timed run {launches}")
    _build.launches.clear()
    with EagerRefine(), PathInputs() as rec:
        prof_eager = profile_run(run)
    if dict(_build.launches) != launches:
        raise AssertionError(f"profiled eager run launched "
                             f"{dict(_build.launches)}, the timed {launches}")
    print(json.dumps(dict(profile=prof, profile_eager=prof_eager)),
          flush=True)
    # 4f. the refine phase level by level; 4e. replayed iterations against
    # the eager loop at each mode's level
    refine_breakdown(graphs, scheds, "gila")
    replay_vs_eager(graphs, scheds, "gila")

    # 3b. the force kernels on the path's own inputs, one row a shape with
    # that shape's launches
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
    stress = stress_path(edges, n, weights, (stats, launches), graphs,
                         scheds)
    for r in rows:              # a random row carries the kernel's totals
        if r["inputs"] == "random":
            r["stress_launches"] = stress["launches"][r["name"]]
    del graphs
    flat_path(edges, n, wall, main_neld)
    weighted_hierarchy_card_vs_cpu(edges, n, weights)
    torch.cuda.empty_cache()

    # 5. small graph: card hierarchy == CPU hierarchy; layouts agree
    e5, n5 = generators.delaunay(5000, seed=3)
    cfg5 = LayoutConfig(exact_threshold=64, grid_threshold=512)
    _assert_hierarchies_equal("delaunay(5000)",
                              _hierarchy(e5, n5, cfg5, "cuda")[0],
                              _hierarchy(e5, n5, cfg5, "cpu")[0])
    p_card, s_card = multigila_layout(e5, n5, cfg5)
    p_cpu, _ = multigila_layout(e5, n5, cfg5, device="cpu")
    q = {k: (neld(p, e5), cre(p, e5)) for k, p in
         (("cuda", p_card), ("cpu", p_cpu))}
    if not np.isfinite(p_card).all():
        raise AssertionError("small layout on the card: non-finite")
    if (abs(q["cuda"][0] - q["cpu"][0]) > NELD_DELTA
            or abs(q["cuda"][1] - q["cpu"][1]) > CRE_DELTA):
        raise AssertionError(f"small layout quality differs: {q}")
    print(json.dumps(dict(small=f"delaunay(5000) n={n5}",
                          level_sizes=s_card.level_sizes,
                          level_modes=s_card.level_modes,
                          hierarchy_equal=True, neld_cre=q)), flush=True)
    # 5b-5c. the stress engine and the other drivers, card vs CPU; the CLI
    engines_card_vs_cpu(e5, n5, cfg5)
    cli_on_card()
    # 5d. the batched driver, card vs CPU
    many_card_vs_cpu()

    # 6. the LM serving path
    del p_card, p_cpu
    torch.cuda.empty_cache()
    rows += attention_checks(device)
    lm = lm_main_path(device)
    for r in rows:
        if r["name"] == "flash_attention_prefill":
            r["launches"] = lm["launches"]["prefill"]
        elif r["name"] == "flash_attention_decode":
            r["launches"] = lm["launches"]["decode"]
    print(json.dumps(lm), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps(dict(card_vs_cpu=lm_card_vs_cpu(device))), flush=True)

    # 7. the batched driver: suites A and B; 3d. the lane kernels on the
    # shapes it launched
    torch.cuda.empty_cache()
    many, lane = many_phase()
    rows += lane
    del many
    torch.cuda.empty_cache()

    # 8. serving on the card: export and pyramid at 1M, viewport queries,
    # the store, the continuous engine, the HTTP front door
    serving_phase(edges, n, ref_levels, card)
    del ref_levels
    torch.cuda.empty_cache()

    # 9. the sharded driver over a one-rank NCCL group
    near_rows, _ = dist_phase(edges, n, runs["warm"], scheds, e5, n5, cfg5)
    rows += near_rows
    torch.cuda.empty_cache()

    # 10. summary
    if any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
           for m in sys.modules):
        raise AssertionError("JAX or the JAX package was imported")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
