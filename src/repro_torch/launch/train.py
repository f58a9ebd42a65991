"""End-to-end LM training driver with fault tolerance: the JAX package's
``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --batch 4 --seq 1024 --steps 30 --ckpt /path/to/run --resume auto

    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch internlm2-1.8b --smoke --model-parallel 2 --device cpu

Runs on the card (``--device cpu`` runs the plain PyTorch versions):
  * checkpoint/restart: async, atomic, digest-validated checkpoints;
    ``--resume auto`` picks the newest valid one (corrupt ones are skipped);
  * deterministic stateless data: a restart resumes the exact batch stream;
  * straggler monitor: per-step EWMA, slow steps logged with the rank;
  * elastic restore: parameters saved on mesh A are cut for mesh B
    (``--model-parallel`` may differ across restarts, and so may the number
    of ranks: one rank restores what eight saved);
  * optional int8 gradient compression with error feedback.

With more than one rank (``torchrun``'s environment, or a default group
the caller made) the driver builds ``make_host_mesh(--model-parallel)``
and ``make_rules(mesh, cfg)``, cuts the parameters to each rank's blocks
and trains each rank on its rows of the global batch; on one rank there is
no mesh, as the JAX package's driver has none on one device. Rank 0
prints. The schedule is ``AdamWConfig(lr, total_steps=steps,
warmup_steps=max(steps // 20, 5))``; an encoder-decoder model splits
``--seq`` into frames and tokens, a VLM takes ``min(256, seq // 2)``
patches, as in the JAX package. Returns the last step's loss.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import init_from_env, make_host_mesh
from repro_torch.models import init_params
from repro_torch.parallel.sharding import (make_rules, shard_model,
                                           use_shardings)
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                               batch_at, extra_inputs, init_train_state,
                               make_train_step)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import StepTimer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", type=str, default="none",
                    choices=["none", "auto"])
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    init_from_env(dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = (make_host_mesh(args.model_parallel, device=dev) if world > 1
            else None)
    rules = make_rules(mesh, cfg)
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    tcfg = TrainConfig(
        optim=AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5)),
        remat=args.remat, compress_grads=args.compress_grads)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)

    with use_shardings(mesh, rules):
        model = init_params(cfg, seed=0, device=dev)
        shardings = shard_model(model, rules) if mesh is not None else None
        opt_state, err_state = init_train_state(model, tcfg)
        params = dict(model.named_parameters())
        step_fn = make_train_step(tcfg)

        start = 0
        mgr = CheckpointManager(args.ckpt) if args.ckpt else None
        if mgr and args.resume == "auto":
            found, tree = mgr.restore_latest(
                {"params": params, "opt": opt_state}, shardings)
            if found is not None:
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(tree["params"][name])
                opt_state = tree["opt"]
                start = found
                say(f"[resume] restored step {found} from {args.ckpt}")

        timer = StepTimer()
        extras = {k: v.to(dev) for k, v in extra_inputs(
            cfg, args.batch, args.seq // 2 if cfg.enc_layers else args.seq
        ).items()}
        metrics = None
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = batch_at(dcfg, step)
            if cfg.enc_layers:  # encoder-decoder splits the budget
                batch = {k: v[:, : args.seq // 2] for k, v in batch.items()}
            batch = {k: v.to(dev) for k, v in batch.items()}
            if cfg.enc_layers or cfg.modality == "vlm":
                batch.update(extras)
            model, opt_state, err_state, metrics = step_fn(
                model, opt_state, err_state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                say(f"step {step:5d} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):.2f}")
            dt = time.perf_counter() - t0
            if timer.record(dt):
                print(f"[straggler] rank {rank} step {step} took {dt:.2f}s "
                      f"(ewma {timer.ewma:.2f}s)")
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt_state},
                               shardings)
        if mgr:
            mgr.save_async(args.steps, {"params": params, "opt": opt_state},
                           shardings)
            mgr.wait()
            mgr.close()
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
