#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when all
of them passed):

  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. build the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
  3. each kernel against its plain PyTorch version at the shapes the main
     path gives it on delaunay(1_000_000): the largest exact, neighbor and
     grid levels of that graph's hierarchy, with positions drawn from a seed.
     One JSON line per kernel: ms per call (CUDA events around a batch of
     calls made back to back, the median of a few batches), the plain
     version's ms, and the least time the card could take (bytes over
     3.35 TB/s or flops over 67 TFLOP/s fp32, whichever is larger, both
     counted for the valid vertices only);
  4. the main path, ``repro_torch.core.multigila_layout`` with the default
     ``LayoutConfig()``, on delaunay(1_000_000) on the card: every position
     finite and every kernel launched; level sizes, modes, phase seconds and
     launch counts are printed; then one more run under torch.profiler:
     device time by kernel and the device's busy share of the wall;
  5. a ~5,000-vertex delaunay with exact_threshold=64, grid_threshold=512
     (all three modes): the hierarchy built on the card equals the one built
     on the CPU, and the card's layout scores within the stated deltas of the
     CPU layout's NELD and CRE;
  6. the LM serving path, internlm2-1.8b at its published width and depth
     (24 layers) in bf16, weights drawn from a seed on the card:
     a. the flash-attention kernel against its plain version at the path's
        two shapes — prefill (B 4, Sq = Sk = 2048, 16 heads over 8 KV heads,
        hd 128, causal) and decode (Sq 1 against cache[:, :2080] of a
        2088-long cache) — timed like phase 3, beside
        ``scaled_dot_product_attention`` as a yardstick, with the bound
        max(bytes / 3.35 TB/s, flops / 989 TFLOP/s bf16);
     b. ``repro_torch.models.prefill`` of a 4 × 2048-token prompt, then 32
        greedy ``decode_step``s: prefill seconds, decode tokens/s, flash
        launches in each (24 per prefill, 24 per step), every logit finite;
        then each once more under torch.profiler (device busy share);
     c. a 2-layer model at full width, the same weights on the card and on
        the CPU (plain attention there): prefill's last-token logits and the
        first decode step's agree within LOGIT_TOL;
  7. the ``{"kernels": [...]}`` summary, the card line, and
     ``{"ok": true, "device": {...}}`` as the last line.

It imports neither JAX nor the JAX package.
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
RTOL = 1e-4                      # kernel vs plain: sums in another order
ATOL_FRAC = 1e-5                 # atol = ATOL_FRAC * max|plain|
NELD_DELTA, CRE_DELTA = 0.05, 0.15
N_MAIN = 1_000_000
LM_ARCH = "internlm2-1.8b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_CACHE = LM_PROMPT + LM_NEW + 8     # decode reads a strided cache slice
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


def kernel_checks(graphs, scheds, device):
    """Phase 3: every kernel against its plain version at main-path shapes."""
    import numpy as np
    import torch
    from repro_torch.core import bucketing, gila
    from repro_torch.kernels import _build
    from repro_torch.kernels.grid_force import ops as grid_ops
    from repro_torch.kernels.grid_force.ref import grid_far_ref, grid_near_ref
    from repro_torch.kernels.nbody.ops import nbody_repulsion
    from repro_torch.kernels.nbody.ref import nbody_repulsion_ref
    from repro_torch.kernels.neighbor_force.ops import neighbor_repulsion
    from repro_torch.kernels.neighbor_force.ref import neighbor_repulsion_ref

    C, L, md = 1.0, 1.0, 1e-3
    cl2, md2 = _build.force_consts(C, L, md)

    def level(mode):
        i = max((i for i, s in enumerate(scheds) if s.mode == mode),
                key=lambda i: graphs[i].n)
        g = graphs[i]
        pos = gila.random_init(g, max(g.n, 4) ** 0.5, seed=1000 + i)
        return i, g, pos

    rows = []

    def record(name, source, replaces, fn, plain, out, ref, nbytes, flops,
               shape, reps, plain_reps):
        err = _compare(name, out, ref)
        ms = _per_call_ms(fn, reps)
        plain_ms = _per_call_ms(plain, plain_reps, batches=3)
        bound, by = _bound_ms(nbytes, flops)
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, library_ms=None)
        print(json.dumps(dict(row, shape=shape, tol=dict(
            rtol=RTOL, atol_frac_of_max=ATOL_FRAC))), flush=True)
        rows.append(row)

    # nbody: the largest exact level
    i, g, pos = level("exact")
    f = lambda: nbody_repulsion(pos, g.mass, g.vmask, C, L, md)
    p = lambda: nbody_repulsion_ref(pos, g.mass, g.vmask, cl2, md2)
    nv = int(g.vmask.sum())
    record("nbody", "src/repro_torch/kernels/nbody/csrc/nbody.cu",
           "src/repro/kernels/nbody/kernel.py:45", f, p, f(), p(),
           21 * g.n_pad, FLOPS_PER_PAIR * nv * nv,
           dict(level=i, n=g.n, n_pad=g.n_pad), 200, 5)

    # neighbor_force: the largest neighbor level, its real k-hop lists
    i, g, pos = level("neighbor")
    nbr_idx, nbr_mask = bucketing.init_state(g, scheds[i], seed=i)
    K = int(nbr_idx.shape[1])
    f = lambda: neighbor_repulsion(pos, g.mass, nbr_idx, nbr_mask, g.vmask,
                                   C, L, md)
    p = lambda: neighbor_repulsion_ref(pos, g.mass, nbr_idx, nbr_mask,
                                       g.vmask, cl2, md2)
    slots = int((nbr_mask & g.vmask[:, None]).sum())
    nv = int(g.vmask.sum())          # rows outside vmask skip their list
    record("neighbor_force",
           "src/repro_torch/kernels/neighbor_force/csrc/neighbor_force.cu",
           "src/repro/kernels/neighbor_force/kernel.py:32", f, p, f(), p(),
           21 * g.n_pad + 5 * nv * K, FLOPS_PER_PAIR * slots,
           dict(level=i, n=g.n, n_pad=g.n_pad, K=K), 200, 5)

    # grid_near and grid_far: the largest grid level
    i, g, pos = level("grid")
    G, cap = scheds[i].grid_dim, scheds[i].cell_cap
    nc = G * G
    cid, bucket, inb = grid_ops.bin_vertices(pos, g.vmask, G, cap)
    table = grid_ops.neighbor_table(G, device)
    f = lambda: grid_ops.grid_near(pos, g.mass, g.vmask, bucket, table,
                                   C, L, md)
    p = lambda: grid_near_ref(pos, g.mass, g.vmask, bucket, table, cl2, md2)
    cnt = torch.cat([(bucket[:nc] < g.n_pad).sum(dim=1),
                     bucket.new_zeros((1,), dtype=torch.int64)])
    pairs = int((cnt[:nc] * cnt[table[:nc].long()].sum(dim=1)).sum())
    near_bytes = 21 * g.n_pad + 4 * (nc + 1) * cap + 36 * (nc + 1)
    record("grid_near", "src/repro_torch/kernels/grid_force/csrc/grid_near.cu",
           "src/repro/kernels/grid_force/kernel.py:45", f, p, f(), p(),
           near_bytes, FLOPS_PER_PAIR * pairs,
           dict(level=i, n=g.n, n_pad=g.n_pad, G=G, cap=cap), 50, 2)

    w = torch.where(g.vmask, g.mass, 0.0)
    M, _, mu = grid_ops._cell_aggregates(pos, w, cid.long(), nc)
    cell_xyw = torch.cat([mu[:nc], M[:nc, None]], dim=1)
    f = lambda: grid_ops.grid_far(pos, cell_xyw, C, L, md)
    p = lambda: grid_far_ref(pos, cell_xyw, cl2, md2)
    nv = int(g.vmask.sum())          # padding rows' output is discarded
    record("grid_far", "src/repro_torch/kernels/grid_force/csrc/grid_far.cu",
           "src/repro/kernels/grid_force/kernel.py:89", f, p, f(), p(),
           16 * nv + 12 * nc, FLOPS_PER_PAIR * nv * nc,
           dict(level=i, n=g.n, n_pad=g.n_pad, cells=nc), 10, 1)
    return rows


def profile_run(fn) -> dict:
    """One more run of ``fn`` under torch.profiler — device time by kernel
    and the device's busy share of the wall clock. The profiler slows the
    host, so the wall here is longer than the unprofiled run's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           cnt + 1)
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


def attention_checks(device) -> list:
    """Phase 6a: the flash-attention kernel against its plain version at the
    LM path's prefill and decode shapes, with SDPA timed as a yardstick."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = get_config(LM_ARCH)
    B, H, KV, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(7)

    def draw(*shape):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return x.to(device, torch.bfloat16)

    kv_len = LM_PROMPT + LM_NEW
    cache_k = draw(B, LM_CACHE, KV, hd)
    cache_v = draw(B, LM_CACHE, KV, hd)
    cases = [
        ("flash_attention_prefill", draw(B, LM_PROMPT, H, hd),
         draw(B, LM_PROMPT, KV, hd), draw(B, LM_PROMPT, KV, hd), True,
         LM_PROMPT * (LM_PROMPT + 1) // 2, 20, 3),
        ("flash_attention_decode", draw(B, 1, H, hd),
         cache_k[:, :kv_len], cache_v[:, :kv_len], True, kv_len, 200, 20),
    ]
    rows = []
    for name, q, k, v, causal, pairs, reps, plain_reps in cases:
        Sq, Sk = q.shape[1], k.shape[1]
        f = lambda: flash_attention(q, k, v, causal=causal)
        p = lambda: flash_attention_ref(q, k, v, causal=causal)
        out, ref = f(), p()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), **ATTN_TOL[name])
        err = float((out.float() - ref.float()).abs().max())
        ms = _per_call_ms(f, reps)
        plain_ms = _per_call_ms(p, plain_reps, batches=3)
        # SDPA's is_causal aligns top-left: the same mask when Sq == Sk, and
        # none is needed for one query row at the end of the cache
        lib = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal and Sq == Sk, enable_gqa=True)
        lib_err = float((lib().transpose(1, 2).float()
                         - ref.float()).abs().max())
        library_ms = _per_call_ms(lib, reps)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * B * H * hd * pairs
        bound, by = _bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        row = dict(name=name, route="cuda",
                   source="src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention.cu",
                   replaces="src/repro/kernels/flash_attention/kernel.py:63",
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, library_ms=library_ms)
        print(json.dumps(dict(row, shape=dict(
            B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, hd=hd, causal=causal,
            k_batch_stride=k.stride(0)), library_max_abs_err=lib_err,
            tol=ATTN_TOL[name])), flush=True)
        rows.append(row)
    return rows


def lm_main_path(device) -> dict:
    """Phase 6b: internlm2-1.8b, full width and depth, bf16: prefill of a
    LM_BATCH × LM_PROMPT prompt and LM_NEW greedy decode steps, with the
    flash launches of each counted from 0."""
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
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out = [tok]

    _build.launches.clear()
    t0 = time.perf_counter()
    for i in range(LM_NEW):
        logits, state = M.decode_step(model, tok, state, pos + i)
        finite &= torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = dict(_build.launches)

    if not bool(finite):
        raise AssertionError("LM path: non-finite logits")
    if logits.shape != (LM_BATCH, 1, cfg.vocab_padded):
        raise AssertionError(f"LM path: logits shape {tuple(logits.shape)}")
    want = {"flash_attention": cfg.n_layers}
    if prefill_launches != want:
        raise AssertionError(f"prefill launches {prefill_launches}, "
                             f"expected {want}")
    want = {"flash_attention": cfg.n_layers * LM_NEW}
    if decode_launches != want:
        raise AssertionError(f"decode launches {decode_launches}, "
                             f"expected {want}")
    seq = torch.cat(out, dim=1).cpu()

    prof_prefill = profile_run(
        lambda: M.prefill(model, {"tokens": tokens}, LM_CACHE))
    st = M.prefill(model, {"tokens": tokens}, LM_CACHE)[1]
    t = seq[:, :1].to(device)

    def decode8():
        for i in range(8):
            M.decode_step(model, t, st, LM_PROMPT + i)
    prof_decode = profile_run(decode8)
    return dict(
        lm=LM_ARCH, params=cfg.param_count(), dtype="bfloat16",
        batch=LM_BATCH, prompt=LM_PROMPT, new_tokens=LM_NEW,
        cache_len=LM_CACHE, init_s=init_s, prefill_s=prefill_s,
        prefill_tok_per_s=LM_BATCH * LM_PROMPT / prefill_s,
        decode_s=decode_s, decode_tok_per_s=LM_BATCH * LM_NEW / decode_s,
        decode_ms_per_step=decode_s / LM_NEW * 1e3,
        launches=dict(prefill=prefill_launches["flash_attention"],
                      decode=decode_launches["flash_attention"]),
        logits_finite=True, sample=seq[0, :12].tolist(),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile_prefill=prof_prefill, profile_decode_8_steps=prof_decode)


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    from repro_torch.core import (LayoutConfig, build_hierarchy,
                                  multigila_layout)
    from repro_torch.core.multilevel import _schedule
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)

    # the main path's graph and its hierarchy (kernel shapes come from it)
    t0 = time.perf_counter()
    edges, n = generators.delaunay(N_MAIN, seed=0)
    print(f"graph: delaunay({N_MAIN}) n={n} m={len(edges)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cfg = LayoutConfig()
    pr = prune_degree_one(edges, n)
    g0 = build_graph(pr.edges, pr.n, mass=pr.mass, bucket=True, device=device)
    graphs, _ = build_hierarchy(g0, cfg, device=device)
    scheds = [_schedule(cfg, i, len(graphs), g) for i, g in enumerate(graphs)]

    # 3. kernels against their plain versions
    rows = kernel_checks(graphs, scheds, device)
    del graphs, g0
    torch.cuda.empty_cache()

    # 4. the main path
    _build.launches.clear()
    t0 = time.perf_counter()
    pos, stats = multigila_layout(edges, n, cfg)
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    if pos.shape != (n, 2) or not np.isfinite(pos).all():
        raise AssertionError("main path: positions not finite / wrong shape")
    missing = [r["name"] for r in rows if launches.get(r["name"], 0) == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps(dict(
        main_path=f"delaunay({N_MAIN})", n=n, m=int(len(edges)),
        wall_s=wall, phase_s=stats.phase_seconds,
        level_sizes=stats.level_sizes, level_modes=stats.level_modes,
        launches=launches, neld=neld(pos, edges))), flush=True)
    print(json.dumps(dict(profile=profile_run(
        lambda: multigila_layout(edges, n, cfg)))), flush=True)

    # 5. small graph: card hierarchy == CPU hierarchy; layouts agree
    e5, n5 = generators.delaunay(5000, seed=3)
    cfg5 = LayoutConfig(exact_threshold=64, grid_threshold=512)
    hier = {}
    for dev in ("cuda", "cpu"):
        pr5 = prune_degree_one(e5, n5)
        g5 = build_graph(pr5.edges, pr5.n, mass=pr5.mass, bucket=True,
                         device=dev)
        hier[dev] = build_hierarchy(g5, cfg5, device=dev)
    (gc, ic), (gh, ih) = hier["cuda"], hier["cpu"]
    if [(g.n, g.m) for g in gc] != [(g.n, g.m) for g in gh]:
        raise AssertionError("hierarchy level sizes differ: card vs CPU")
    for a, b in zip(ic, ih):
        for field in ("parent_coarse", "sun_of", "depth", "state",
                      "sun_pos_index"):
            if not torch.equal(getattr(a, field).cpu(), getattr(b, field)):
                raise AssertionError(f"hierarchy {field} differs: card vs CPU")
    for a, b in zip(gc, gh):
        for field in ("src", "dst", "vmask", "emask", "mass", "ewt"):
            if not torch.equal(getattr(a, field).cpu(), getattr(b, field)):
                raise AssertionError(f"coarse graph {field} differs")
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

    # 6. the LM serving path
    del p_card, p_cpu, hier
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

    # 7. summary
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
