"""Multi-card dry run: every (arch × shape cell × mesh) cell's step on
``meta`` tensors, the JAX package's ``launch/dryrun.py`` with its three
suites: ``lm``, ``layout`` and ``pp``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --suite lm --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --suite layout --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --suite pp
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --cell train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch jamba-v0.1-52b --mesh 1x8

Where the JAX package lowers and compiles each cell for 512 placeholder
devices, the port runs it: rank 0 of a process group of the mesh's size
whose collectives do nothing (``launch.mesh.make_production_mesh``) builds
its blocks of the weights on ``meta`` from ``param_specs`` (and, for a
train cell, AdamW's state and the gradients), the decode state from
``decode_state_specs`` and the inputs from ``input_specs``, and runs the
cell's step under the rules: ``loss_fn``, its gradients and the optimizer
update for a train cell, ``prefill`` for a prefill cell, ``decode_step``
for a decode cell. Nothing is allocated and no kernel is launched; a step
that raises is the cell's failure, recorded as the JAX package records
one. Per cell it writes results/dryrun/<mesh>/<arch>__<cell>.json:

* the bytes a rank holds, counted from its blocks: the weights, the
  optimizer state and the gradients (a train cell), the decode state (a
  prefill or decode cell), each under the layout the cell's options give
  (``CellOpts``: FSDP and ZeRO-1 cut them over the batch axes as the JAX
  package's ``zero_spec`` does);
* ``analytic_cell``'s HBM bytes and peak (``launch/analytic.py``), and
  whether the peak fits one H100's 80 GB;
* the counted FLOPs and collective bytes and the roofline terms against
  the H100's data-sheet rates (``launch/roofline.py``).

``--mesh`` also takes a shape, ``DxM`` over (data, model) or ``PxDxM``
over (pod, data, model), such as ``1x8`` for one host's eight cards; the
options of such a mesh escalate against its own shape, where those of the
production meshes escalate against (16, 16), as the JAX package's do.

The ``layout`` suite (``run_layout_suite``) runs the sharded layout step
(``core/distributed.py``) once a row on rank 0's blocks
(``layout_step_specs``, ``layout_halo_specs``): each ``BIG_GRAPH_DRYRUN``
size of ``configs/multigila.py`` in each mode of ``LAYOUT_MODES`` that
applies to it, under ``roofline.count_ops``. Its records hold the
argument bytes, the counted peak live bytes and whether they fit one
H100's 80 GB, the counted FLOPs, HBM bytes and collectives, and
``counted_by``, which names the count each figure comes from. The ``pp``
suite (``run_pp_suite``) runs gemma-2b's pipeline over a fake (2, 16, 16)
mesh, forward and gradient, and ring attention at 32k over a fake (16,
16) mesh. ``--suite all`` runs ``layout`` and ``lm``; ``pp`` runs alone,
as in the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, cells_for, get_config, list_archs
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.configs.multigila import BIG_GRAPH_DRYRUN
from repro_torch.core import distributed as DI
from repro_torch.launch.analytic import analytic_cell
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (HBM_BW, HBM_PER_CARD, PEAK_FLOPS_BF16,
                                     make_fake_mesh, make_production_mesh,
                                     shutdown)
from repro_torch.models import model as M
from repro_torch.parallel import sharding as SH
from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state
from repro_torch.train.train_step import update
from repro_torch.utils.tree import tree_bytes

DEVICE = {"name": "NVIDIA H100 80GB HBM3 (data sheet)",
          "peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW,
          "hbm_bytes": HBM_PER_CARD}


@dataclasses.dataclass
class CellOpts:
    remat: str = "dots"
    seq_shard: bool = False
    params_dtype: str = "bfloat16"
    zero_opt: bool = True      # ZeRO-1: optimizer states sharded over DP
    fsdp: bool = False         # ZeRO-3: params themselves sharded over DP
    accum: int = 1             # gradient-accumulation microbatches
    strategy: str = "tp"       # tp | fsdp_dp
    moe_impl: str = "gspmd"    # gspmd | shard_map | all_to_all


def _dec_len(cfg: ArchConfig, cell: ShapeCell) -> int:
    return cell.seq_len // 2 if cfg.enc_layers else cell.seq_len


def model_flops_per_device(cfg: ArchConfig, cell: ShapeCell, n_dev: int):
    N = cfg.active_param_count()
    if cell.kind == "train":
        total = 6.0 * N * cell.global_batch * _dec_len(cfg, cell)
    elif cell.kind == "prefill":
        total = 2.0 * N * cell.global_batch * _dec_len(cfg, cell)
    else:
        total = 2.0 * N * cell.global_batch
    return total / n_dev


def cell_opts_for(cfg: ArchConfig, cell: ShapeCell,
                  mesh_shape: dict | None = None) -> CellOpts:
    """The JAX package's baseline options with memory-driven escalation,
    against one H100's 80 GB: if the analytic peak exceeds it, turn on (in
    order) sequence-parallel residuals, FSDP, then gradient accumulation
    (a prefill cell: chunked prefill)."""
    mesh_shape = mesh_shape or {"data": 16, "model": 16}
    opts = CellOpts(remat="full" if cell.kind == "train" else "none",
                    seq_shard=False,
                    fsdp=(cell.kind == "train"
                          and cfg.param_count() * 2 / 16 > 4 * 2 ** 30))

    def peak(o):
        return analytic_cell(cfg, cell, mesh_shape,
                             remat=(o.remat != "none"), zero_opt=o.zero_opt,
                             fsdp=o.fsdp, seq_shard=o.seq_shard,
                             accum=o.accum)["peak"]

    if cell.kind == "decode":
        return opts
    if cell.kind == "prefill":
        for escalation in (dict(accum=2), dict(accum=4)):
            if peak(opts) < HBM_PER_CARD * 0.95:
                break
            opts = dataclasses.replace(opts, **escalation)
        return opts
    for escalation in (dict(seq_shard=True), dict(fsdp=True),
                       dict(accum=2), dict(accum=4), dict(accum=8)):
        if peak(opts) < HBM_PER_CARD * 0.95:
            break
        opts = dataclasses.replace(opts, **escalation)
    return opts


# -- a rank's blocks -----------------------------------------------------------

def layout_specs(cfg: ArchConfig, mesh, rules, opts: CellOpts) -> tuple:
    """({name: spec} of the weights as the cell holds them, {name: spec}
    of AdamW's mu, nu and master): the rules' specs; FSDP (or the
    ``fsdp_dp`` strategy) cuts the weights over the batch axes (over every
    axis their spec leaves free), ZeRO-1 the optimizer state — the JAX
    package's ``lower_cell``."""
    specs = M.param_specs(cfg, rules)
    shapes = {n: tuple(p.shape) for n, p in
              M.LM(cfg, device="meta").named_parameters()}
    if opts.strategy == "fsdp_dp":
        def free(spec):
            used = {a for e in spec for a in SH.spec_axes(e)}
            return tuple(a for a in mesh.axis_names if a not in used)
        weights = {n: SH.zero_spec(s, shapes[n], mesh, axes=free(s))
                   for n, s in specs.items()}
    elif opts.fsdp:
        weights = SH.zero_shardings(mesh, specs, shapes)
    else:
        weights = dict(specs)
    opt = (SH.zero_shardings(mesh, specs, shapes) if opts.zero_opt
           else dict(weights))
    return weights, opt


def _blocks(shapes: dict, specs: dict, mesh, dtype_of) -> dict:
    return {n: torch.empty(M.block_shape(shapes[n], specs[n], mesh),
                           dtype=dtype_of(n), device="meta")
            for n in shapes}


def resident(cfg: ArchConfig, cell: ShapeCell, mesh, rules,
             opts: CellOpts) -> dict:
    """The bytes rank 0 holds, by part, from its blocks (meta tensors):
    weights; a train cell's optimizer state (mu, nu and master float32,
    the step) and gradients (in the weights' dtype and layout); a prefill
    or decode cell's decode state."""
    pdtype = getattr(torch, opts.params_dtype)
    model = M.LM(cfg, dtype=pdtype, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    wspec, ospec = layout_specs(cfg, mesh, rules, opts)
    out = {"weights": tree_bytes(_blocks(shapes, wspec, mesh, dtypes.get))}
    if cell.kind == "train":
        f32 = _blocks(shapes, ospec, mesh, lambda n: torch.float32)
        out["optimizer"] = 3 * tree_bytes(f32) + 4       # + the int32 step
        out["gradients"] = out["weights"]
    else:
        with SH.use_shardings(mesh, rules):
            state = M.init_decode_state(model, cell.global_batch,
                                        _dec_len(cfg, cell))
        out["decode_state"] = tree_bytes(state)
    out["total"] = sum(out.values())
    return out


def _meta_model(cfg: ArchConfig, rules, dtype):
    """The LM on ``meta``, each parameter this rank's block under the
    rules (``param_specs``), as ``sharding.shard_model`` leaves them."""
    model = M.LM(cfg, dtype=dtype, device="meta")
    specs = M.param_specs(cfg, rules)
    for name, p in model.named_parameters():
        p.data = torch.empty(M.block_shape(tuple(p.shape), specs[name],
                                           rules.mesh),
                             dtype=p.dtype, device="meta")
    return model


# -- the cell's step -------------------------------------------------------------

def _train_step(model, cfg: ArchConfig, batch: dict, rules,
                opts: CellOpts) -> None:
    """loss_fn on this rank's rows (in ``accum`` microbatches), the
    gradients, their sums over the batch axes and one AdamW update."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    specs = M.param_specs(cfg, rules)
    rows = SH.batch_rows(batch, rules)
    n = rows["tokens"].shape[0] // opts.accum
    grads = None
    for i in range(opts.accum):
        mb = {k: v[i * n:(i + 1) * n] for k, v in rows.items()}
        loss, _ = M.loss_fn(model, mb, remat=opts.remat)
        g = torch.autograd.grad(loss, list(params.values()))
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    grads = {k: g / opts.accum for k, g in zip(params, grads)}
    grads = SH.reduce_grads(grads, specs, rules)
    tcfg = TrainConfig(optim=AdamWConfig(), remat=opts.remat)
    with torch.no_grad():
        opt = init_opt_state(tcfg.optim, params)
        update(tcfg, params, grads, opt, None, specs)


def run_step(cfg: ArchConfig, cell: ShapeCell, mesh, rules,
             opts: CellOpts) -> None:
    """The cell's step on ``meta`` under the rules, at the cell's inputs
    (``input_specs``)."""
    model = _meta_model(cfg, rules, getattr(torch, opts.params_dtype))
    spec = M.input_specs(cfg, cell)
    with SH.use_shardings(mesh, rules):
        if cell.kind == "train":
            _train_step(model, cfg, spec, rules, opts)
        elif cell.kind == "prefill":
            M.prefill(model, spec, _dec_len(cfg, cell), chunks=opts.accum)
        else:
            state = M.init_decode_state(model, cell.global_batch,
                                        _dec_len(cfg, cell))
            M.decode_step(model, spec["token"], state, spec["pos"],
                          enc_out=spec.get("enc_out"))


def run_cell(cfg: ArchConfig, cell: ShapeCell, mesh, opts: CellOpts) -> dict:
    """One cell on ``mesh`` (any ``launch.mesh.Mesh``; the dry run's are
    ``make_production_mesh``'s) → its record."""
    rules = SH.make_rules(mesh, cfg, seq_shard=opts.seq_shard,
                          strategy=opts.strategy, moe_impl=opts.moe_impl)
    t0 = time.time()
    _, cost = RL.count_step(run_step, cfg, cell, mesh, rules, opts)
    step_s = time.time() - t0
    n_dev = mesh.size
    an = analytic_cell(cfg, cell, mesh.shape, remat=(opts.remat != "none"),
                       zero_opt=opts.zero_opt, fsdp=opts.fsdp,
                       seq_shard=opts.seq_shard, accum=opts.accum,
                       strategy=opts.strategy)
    mf = model_flops_per_device(cfg, cell, n_dev)
    cost.bytes = an["bytes"]
    terms = RL.roofline_terms(cost, model_flops_per_device=mf)
    total = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    if cell.kind == "decode":   # bandwidth-normalized, as the JAX package
        terms["roofline_frac"] = terms["memory_s"] / total if total else 0.0
    terms["bytes_analytic"] = terms.pop("bytes")
    res = resident(cfg, cell, mesh, rules, opts)
    return {
        "arch": cfg.name, "cell": cell.name,
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
        "opts": dataclasses.asdict(opts),
        "step_s": round(step_s, 2),
        "memory": {
            "resident_bytes": res,
            "peak_bytes_analytic": int(an["peak"]),
            "fits_hbm": bool(an["peak"] < HBM_PER_CARD),
            "resident_fits_hbm": bool(res["total"] < HBM_PER_CARD),
        },
        "roofline": terms,
        "collectives": RL.summarize_collectives(cost),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "device": DEVICE,
    }


# -- the layout suite ------------------------------------------------------------

LAYOUT_MODES = ("neighbor", "exact", "halo", "grid", "grid_halo")
#: the largest n_pad of a coarse level: exact N-body at or below it, the
#: halo and grid modes above it
EXACT_MAX_N = 1 << 16
#: where each figure of a layout or pp record comes from
COUNTED_BY = {
    "flops": "FlopCounterMode (matrix products) + launch/opcount.py "
             "OpCounter (one a pointwise op's output element, one a "
             "reduction's, scan's or scatter-add's input element) + the "
             "grid kernels' meta routes (11 a pair)",
    "bytes": "OpCounter: each op's tensor inputs and outputs once, nothing "
             "fused (an upper bound), plus the kernels' own",
    "argument_bytes": "the step's inputs: rank 0's blocks",
    "peak_bytes": "OpCounter: the high-water mark of the live meta storages, "
                  "the inputs among them",
    "collectives": "parallel/comm.py counting (ring model, bytes a rank)",
}


def layout_rows() -> list:
    """(graph, mode) of the suite's rows on a mesh, in the JAX package's
    order: exact N-body only at n_pad ≤ EXACT_MAX_N (the coarse level),
    the halo and grid modes only above it (the fine levels)."""
    rows = []
    for gname, spec in BIG_GRAPH_DRYRUN.items():
        for mode in LAYOUT_MODES:
            coarse = spec["n_pad"] <= EXACT_MAX_N
            if mode == "exact" and not coarse:
                continue
            if mode in ("halo", "grid", "grid_halo") and coarse:
                continue
            rows.append((gname, mode))
    return rows


def layout_row_step(mesh, n_pad: int, m_pad: int, cap: int,
                    mode: str) -> tuple:
    """(the row's step, its inputs as rank 0's meta blocks, by name) for
    one of LAYOUT_MODES on ``mesh``: ``layout_train_step`` for neighbor,
    exact and grid, ``layout_train_step_halo`` for halo (neighbor lists)
    and grid_halo (its grid variant), the grid sized by ``choose_grid``
    (grid_halo's grid_dim a multiple of the vertex ranks), the halo
    ``max(n_pad / vsize / 8, 128)`` rows a peer."""
    from repro_torch.kernels.grid_force.ops import choose_grid
    vsize = mesh.vtx_size
    G, cc = choose_grid(n_pad,
                        multiple_of=vsize if mode == "grid_halo" else 1)
    if mode in ("halo", "grid_halo"):
        halo = max(n_pad // vsize // 8, 128)
        inner = "grid" if mode == "grid_halo" else "neighbor"
        specs = DI.layout_halo_specs(mesh, n_pad, m_pad, cap, halo,
                                     mode=inner)
        step = DI.layout_train_step_halo(
            mesh, n_pad, m_pad, specs["nbr_local"].shape[1], halo,
            mode=inner, grid_dim=G, cell_cap=cc)
    else:
        specs = DI.layout_step_specs(mesh, n_pad, m_pad, cap, mode=mode)
        step = DI.layout_train_step(mesh, n_pad, m_pad,
                                    specs["nbr_idx"].shape[1], mode=mode,
                                    grid_dim=G, cell_cap=cc)
    return step, specs


def _counted_record(arch: str, cell: str, mesh, cost, step_s: float,
                    arg_bytes: int, opts: dict | None = None) -> dict:
    """A layout or pp record from ``count_ops``'s ``cost``."""
    rec = {"arch": arch, "cell": cell,
           "mesh": "x".join(str(s) for s in mesh.shape.values())}
    if opts is not None:
        rec["opts"] = opts
    rec.update({
        "step_s": round(step_s, 2),
        "memory": {"argument_bytes": arg_bytes,
                   "peak_bytes": int(cost.peak_bytes),
                   "fits_hbm": bool(cost.peak_bytes < HBM_PER_CARD)},
        "roofline": RL.roofline_terms(cost),
        "flops_by": cost.flops_by,
        "collectives": RL.summarize_collectives(cost),
        "counted_by": COUNTED_BY, "device": DEVICE})
    return rec


def run_layout_row(mesh, gname: str, mode: str) -> dict:
    """One layout row on ``mesh`` → its record: the step once on rank 0's
    meta blocks under ``count_ops``; raises unless it returns rank 0's
    new positions [n_loc, 2] float32."""
    spec = BIG_GRAPH_DRYRUN[gname]
    t0 = time.time()
    step, args = layout_row_step(mesh, spec["n_pad"], spec["m_pad"],
                                 spec["cap"], mode)
    out, cost = RL.count_ops(step, *args.values(),
                             live=list(args.values()))
    step_s = time.time() - t0
    want = (spec["n_pad"] // mesh.vtx_size, 2)
    if tuple(out.shape) != want or out.dtype != torch.float32:
        raise AssertionError(f"{gname} {mode}: out {tuple(out.shape)} "
                             f"{out.dtype}, want {want} float32")
    return _counted_record(f"layout_{gname}_{mode}", "layout_step", mesh,
                           cost, step_s, tree_bytes(args))


def run_layout_suite(meshes, outdir) -> list:
    """The JAX package's layout suite: every row of ``layout_rows`` on
    each of ``meshes`` ([(name, mesh spec of ``_mesh_for``)]), a record
    each; a row that raises is recorded as FAIL and the suite goes on."""
    results = []
    for mesh_name, which in meshes:
        mesh, _ = _mesh_for(which)
        for gname, mode in layout_rows():
            tag = f"layout_{gname}_{mode}"
            try:
                rec = run_layout_row(mesh, gname, mode)
                _save(outdir, mesh_name, tag, "layout_step", rec)
                r = rec["roofline"]
                results.append((f"{tag} × {mesh_name}", "OK",
                                r["bottleneck"], rec["memory"]["fits_hbm"]))
                print(f"[layout] {tag} {mesh_name}: OK "
                      f"({r['bottleneck']}-bound, peak "
                      f"{rec['memory']['peak_bytes'] / 1e9:.2f}GB, "
                      f"{rec['step_s']:.1f}s)", flush=True)
            except Exception as e:
                results.append((f"{tag} × {mesh_name}", "FAIL",
                                str(e)[:100], False))
                print(f"[layout] {tag} {mesh_name}: FAIL {e}", flush=True)
                traceback.print_exc()
    return results


# -- the pp suite ----------------------------------------------------------------

PP = dict(arch="gemma-2b", batch=256, seq=4096, microbatches=8)
RING = dict(B=32, S=32768, H=16, KV=8, hd=128)


def pp_record(mesh=None, cfg=None, pp: dict = PP) -> dict:
    """gemma-2b in 2 stages over "pod" × TP16 × DP16 (a fake (2, 16, 16)
    mesh): ``pipeline_forward`` with 8 microbatches on tokens and labels
    [256, 4096], then the gradient of mean(logits²) over rank 0's rows and
    its sum over "data". Rank 0 holds its stage's layers (the JAX package
    stage-shards the layer groups over "pod") and the embedding, norm and
    head under the rules. The weights and activations are float32: the
    JAX package's suite sets REPRO_ACT_DTYPE=float32 to get round an
    XLA:CPU crash on bf16 in partial-manual regions, which the port does
    not have; it keeps float32 so that the record counts the same work.
    ``mesh``, ``cfg`` and ``pp`` (batch, seq, microbatches) override the
    production ones."""
    from repro_torch.parallel.pipeline import pipeline_forward
    mesh = mesh or make_production_mesh(multi_pod=True)
    cfg = cfg or get_config(pp["arch"])
    rules = SH.make_rules(mesh, cfg)
    dtype = torch.float32
    model = _meta_model(cfg, rules, dtype)
    per = cfg.n_layers // mesh.shape["pod"]
    first = mesh.axis_index("pod") * per
    held = {n: p for n, p in model.named_parameters()
            if not n.startswith("layers.")
            or first <= int(n.split(".")[1]) < first + per}
    specs = M.param_specs(cfg, rules)
    batch = {k: torch.empty((pp["batch"], pp["seq"]), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    data_rules = dataclasses.replace(rules, batch=("data",))

    def step():
        model.requires_grad_(True)
        with SH.use_shardings(mesh, rules):
            lg = pipeline_forward(model, batch, mesh,
                                  n_microbatches=pp["microbatches"])
            loss = (lg.float() ** 2).mean()
            grads = torch.autograd.grad(loss, list(held.values()))
            SH.reduce_grads(dict(zip(held, grads)), specs, data_rules)

    t0 = time.time()
    _, cost = RL.count_ops(step, live=[*held.values(), *batch.values()])
    return _counted_record(
        f"{cfg.name}-pp{mesh.shape['pod']}", "train_fwd_bwd", mesh, cost,
        time.time() - t0, tree_bytes(held) + tree_bytes(batch),
        dict(stages=mesh.shape["pod"], microbatches=pp["microbatches"],
             dtype="float32", stage_layers=per))


def ring_record(mesh=None, r: dict = RING) -> dict:
    """Ring attention at 32k context on a fake (16, 16) mesh: B 32, S
    32768, H 16, KV 8, hd 128, float32, causal; rank 0's blocks [2, 2048,
    ...] (the batch over "data", the sequence over "model"). ``mesh`` and
    ``r`` override them."""
    from repro_torch.parallel.ring_attention import ring_attention
    mesh = mesh or make_production_mesh(multi_pod=False)
    b, s = r["B"] // mesh.shape["data"], r["S"] // mesh.shape["model"]
    q = torch.empty((b, s, r["H"], r["hd"]), device="meta")
    k, v = (torch.empty((b, s, r["KV"], r["hd"]), device="meta")
            for _ in range(2))
    fn = ring_attention(mesh, causal=True)
    t0 = time.time()
    _, cost = RL.count_ops(fn, q, k, v, live=[q, k, v])
    return _counted_record(
        "ring-attention-32k", "prefill_attn_layer", mesh, cost,
        time.time() - t0, tree_bytes([q, k, v]),
        dict(r, dtype="float32", causal=True))


def run_pp_suite(outdir) -> list:
    """The JAX package's pp suite: ``pp_record`` and ``ring_record``, each
    saved (a record that raises is a FAIL, and the suite goes on)."""
    out = []
    for mesh_name, fn in (("pods2x16x16", pp_record),
                          ("pod16x16", ring_record)):
        try:
            rec = fn()
            _save(outdir, mesh_name, rec["arch"], rec["cell"], rec)
            coll = rec["roofline"]["coll_bytes"] / 1e9
            print(f"[pp] {rec['arch']} × {rec['mesh']}: OK (step "
                  f"{rec['step_s']:.1f}s, coll {coll:.2f} GB/dev, peak "
                  f"{rec['memory']['peak_bytes'] / 1e9:.1f} GB)", flush=True)
            out.append((f"{rec['arch']} × {rec['mesh']}", "OK",
                        rec["roofline"]["bottleneck"],
                        rec["memory"]["fits_hbm"]))
        except Exception as e:
            print(f"[pp] {fn.__name__}: FAIL {e}", flush=True)
            traceback.print_exc()
            out.append((fn.__name__, "FAIL", str(e)[:100], False))
    return out


def _mesh_for(which) -> tuple:
    """(the fake mesh, the shape its options escalate against: None for a
    production mesh) of ``which``: True/False (multi-pod or not) or a
    shape tuple."""
    if isinstance(which, tuple):
        axes = ("data", "model") if len(which) == 2 else (
            "pod", "data", "model")
        mesh = make_fake_mesh(which, axes)
        return mesh, mesh.shape
    return make_production_mesh(multi_pod=which), None


def _save(outdir, mesh_name, arch, cell, rec):
    d = os.path.join(outdir, mesh_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{arch}__{cell}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def _run_lm_suite(meshes, args) -> list:
    """The ``lm`` suite: every (arch, cell) of ``args`` on each mesh, a
    record each; a cell that raises is a FAIL, and the suite goes on."""
    summary = []
    archs = [args.arch] if args.arch else list_archs()
    for mesh_name, which in meshes:
        mesh, own = _mesh_for(which)
        for name in archs:
            cfg = get_config(name)
            cells = [SHAPES[args.cell]] if args.cell else cells_for(cfg)
            for cell in cells:
                opts = cell_opts_for(cfg, cell, own)
                if args.seq_shard != "auto":
                    opts = dataclasses.replace(
                        opts, seq_shard=args.seq_shard == "on")
                if args.remat:
                    opts = dataclasses.replace(opts, remat=args.remat)
                if args.strategy:
                    opts = dataclasses.replace(opts, strategy=args.strategy)
                if args.moe_impl:
                    opts = dataclasses.replace(opts, moe_impl=args.moe_impl)
                tag = f"{name} × {cell.name} × {mesh_name}"
                try:
                    rec = run_cell(cfg, cell, mesh, opts)
                    _save(args.out, mesh_name, name, cell.name, rec)
                    r, mem = rec["roofline"], rec["memory"]
                    print(f"[OK]   {tag}: {r['bottleneck']}-bound "
                          f"frac={r['roofline_frac']:.2f} "
                          f"resident="
                          f"{mem['resident_bytes']['total'] / 1e9:.1f}GB "
                          f"peak={mem['peak_bytes_analytic'] / 1e9:.1f}GB "
                          f"fits={mem['fits_hbm']} "
                          f"step={rec['step_s']:.0f}s", flush=True)
                    summary.append((tag, "OK", r["bottleneck"],
                                    mem["fits_hbm"]))
                except Exception as e:
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
                    summary.append((tag, "FAIL", str(e)[:100], False))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", default="lm",
                    choices=["lm", "layout", "pp", "all"])
    ap.add_argument("--arch", default="")
    ap.add_argument("--cell", default="")
    ap.add_argument("--mesh", default="both",
                    help="single, multi, both, or a shape DxM / PxDxM")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--seq-shard", default="auto",
                    choices=["auto", "on", "off"])
    ap.add_argument("--remat", default="")
    ap.add_argument("--strategy", default="", choices=["", "tp", "fsdp_dp"])
    ap.add_argument("--moe-impl", default="",
                    choices=["", "gspmd", "shard_map", "all_to_all"])
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod16x16", False))
    if args.mesh in ("multi", "both"):
        meshes.append(("pods2x16x16", True))
    if not meshes:
        shape = tuple(int(n) for n in args.mesh.split("x"))
        if len(shape) not in (2, 3):
            raise ValueError(f"--mesh {args.mesh}: single, multi, both, "
                             "DxM or PxDxM")
        meshes.append((f"mesh{args.mesh}", shape))
    summary = []
    try:
        if args.suite in ("layout", "all"):
            summary += run_layout_suite(meshes, args.out)
        if args.suite == "pp":
            summary += run_pp_suite(args.out)
        if args.suite in ("lm", "all"):
            summary += _run_lm_suite(meshes, args)
    finally:
        shutdown()
    n_ok = sum(1 for s in summary if s[1] == "OK")
    print(f"\n=== dry-run summary: {n_ok}/{len(summary)} OK ===")
    for s in summary:
        if s[1] != "OK":
            print("  FAILED:", s[0], s[2])
    return 0 if n_ok == len(summary) else 1


if __name__ == "__main__":
    raise SystemExit(main())
