"""End-to-end LM training driver with fault tolerance, on one device: the
JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --batch 4 --seq 1024 --steps 30 --ckpt /path/to/run --resume auto

Runs on the card (``--device cpu`` runs the plain PyTorch versions):
  * checkpoint/restart: async, atomic, digest-validated checkpoints;
    ``--resume auto`` picks the newest valid one (corrupt ones are skipped);
  * deterministic stateless data: a restart resumes the exact batch stream;
  * straggler monitor: per-step EWMA, slow steps logged with the rank;
  * optional int8 gradient compression with error feedback.

The schedule is ``AdamWConfig(lr, total_steps=steps, warmup_steps=max(steps
// 20, 5))``; an encoder-decoder model splits ``--seq`` into frames and
tokens, a VLM takes ``min(256, seq // 2)`` patches, as in the JAX package.
``--model-parallel`` other than 1 (the sharded trainer, with the elastic
restore onto another mesh) waits for the port's ``parallel/`` sharding,
ROADMAP.md item 13.7's third slice, and is refused. Returns the last
step's loss.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import init_params
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
    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: the sharded trainer "
            "waits for the port's parallel/ sharding (ROADMAP.md item "
            "13.7's third slice); this driver trains on one device")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    tcfg = TrainConfig(
        optim=AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5)),
        remat=args.remat, compress_grads=args.compress_grads)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)

    model = init_params(cfg, seed=0, device=dev)
    opt_state, err_state = init_train_state(model, tcfg)
    params = dict(model.named_parameters())
    step_fn = make_train_step(tcfg)

    start = 0
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    if mgr and args.resume == "auto":
        found, tree = mgr.restore_latest({"params": params, "opt": opt_state})
        if found is not None:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(tree["params"][name])
            opt_state = tree["opt"]
            start = found
            print(f"[resume] restored step {found} from {args.ckpt}")

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
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        dt = time.perf_counter() - t0
        if timer.record(dt):
            print(f"[straggler] rank 0 step {step} took {dt:.2f}s "
                  f"(ewma {timer.ewma:.2f}s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state})
    if mgr:
        mgr.save_async(args.steps, {"params": params, "opt": opt_state})
        mgr.wait()
        mgr.close()
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
