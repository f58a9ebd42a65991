"""Multi-card dry run: every (arch × shape cell × mesh) cell's step on
``meta`` tensors, the JAX package's ``launch/dryrun.py`` ``lm`` suite.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --suite lm --mesh both
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
The JAX package's ``layout`` and ``pp`` suites are not yet ported (ROADMAP
queue 1, item 17.2).
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

NOT_PORTED = ("the {} suite is not yet ported: ROADMAP queue 1, item 17.2 "
              "(the layout suite with configs/multigila.py, then the pp "
              "suite)")


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
        "device": {"name": "NVIDIA H100 80GB HBM3 (data sheet)",
                   "peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW,
                   "hbm_bytes": HBM_PER_CARD},
    }


def _save(outdir, mesh_name, arch, cell, rec):
    d = os.path.join(outdir, mesh_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{arch}__{cell}.json"), "w") as f:
        json.dump(rec, f, indent=1)


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
    if args.suite != "lm":
        raise NotImplementedError(NOT_PORTED.format(args.suite))

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
    archs = [args.arch] if args.arch else list_archs()
    try:
        for mesh_name, which in meshes:
            if isinstance(which, tuple):
                axes = ("data", "model") if len(which) == 2 else (
                    "pod", "data", "model")
                mesh = make_fake_mesh(which, axes)
                own = mesh.shape
            else:
                mesh, own = make_production_mesh(multi_pod=which), None
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
                        opts = dataclasses.replace(opts,
                                                   strategy=args.strategy)
                    if args.moe_impl:
                        opts = dataclasses.replace(opts,
                                                   moe_impl=args.moe_impl)
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
