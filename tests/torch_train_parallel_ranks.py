"""The rank program of ``test_torch_train_parallel.py``: the port's sharded
trainer on WORLD gloo ranks on the CPU — every smoke config's sharded loss
and gathered gradients, the sequence-parallel and fsdp_dp strategies, one
sharded AdamW step with and without compression, and the launcher at
``--model-parallel 2`` with its checkpoint resumed at other meshes.

    python tests/torch_train_parallel_ranks.py INPUTS.npz OUT_DIR

spawns the ranks (``torch.multiprocessing``), which meet through a
``FileStore`` in OUT_DIR, and leaves rank 0's results in OUT_DIR/torch.npz
and the launcher's checkpoints in OUT_DIR/run*.
"""
import contextlib
import io
import os
import shutil
import sys

import numpy as np

WORLD = 8
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCHS = ("internlm2-1.8b", "starcoder2-7b", "starcoder2-15b", "gemma-2b",
         "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-1.3b",
         "jamba-v0.1-52b", "seamless-m4t-medium", "internvl2-76b")
MESHES = ((4, 2), (2, 4))
LAUNCH = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "20", "--seq",
          "64", "--batch", "8", "--log-every", "1", "--ckpt-every", "10",
          "--device", "cpu"]


def _model(inp, arch, cfg, dtype):
    import torch
    from repro_torch.models import model as M
    mdl = M.LM(cfg, dtype=dtype, device="cpu")
    with torch.no_grad():
        for name, p in mdl.named_parameters():
            p.copy_(torch.from_numpy(inp[f"{arch}:w:{name}"]))
    return mdl


def _batch(inp, arch):
    import torch
    out = {}
    for key in inp:
        if key.startswith(f"{arch}:b:"):
            t = torch.from_numpy(inp[key])
            out[key.rsplit(":", 1)[1]] = (t.bfloat16() if t.is_floating_point()
                                          else t)
    return out


@contextlib.contextmanager
def _following(routes):
    """Within ``with``: each MoE call's router takes the recorded top-k
    experts of its rows (``routes``, one [B, S, k] array a call in call
    order), gated by the port's own probabilities."""
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.parallel.sharding import current_rules
    real, calls = MOE.route, [0]

    def route(p, x, m):
        probs, _, _ = real(p, x, m)
        r = current_rules()
        lo = r.mesh.index(r.batch) * x.shape[0]
        idx = torch.from_numpy(routes[calls[0] % len(routes)]
                               [lo:lo + x.shape[0]]).long()
        calls[0] += 1
        gates = probs.gather(-1, idx)
        return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx
    MOE.route = route
    try:
        yield
    finally:
        MOE.route = real


def _loss_and_grads(inp, arch, mesh, dtype, **flags):
    """(loss, {name: full gradient}) of the sharded loss at ``mesh``; in
    bf16 an MoE model's routers follow JAX's recorded choices."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as SH
    cfg = get_smoke_config(arch)
    mdl = _model(inp, arch, cfg, dtype)
    rules = SH.make_rules(mesh, cfg, **flags)
    routes = []
    while f"{arch}:route:{len(routes)}" in inp:
        routes.append(inp[f"{arch}:route:{len(routes)}"])
    follow = (_following(routes) if routes and dtype == torch.bfloat16
              else contextlib.nullcontext())
    with SH.use_shardings(mesh, rules), follow:
        sh = SH.shard_model(mdl, rules)
        mdl.requires_grad_(True)
        loss, parts = M.loss_fn(mdl, SH.batch_rows(_batch(inp, arch), rules))
        ps = dict(mdl.named_parameters())
        grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
        grads = SH.reduce_grads(grads, M.param_specs(cfg, rules), rules)
        return loss.detach(), {k: sh.gather(k, g) for k, g in grads.items()}


def _adamw(inp, mesh, out):
    """One sharded ``train_step.update`` at ``mesh`` from JAX's initial
    state on the drawn gradients, with and without compression."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state
    from repro_torch.train import train_step as TS
    arch = "internlm2-1.8b"
    cfg = get_smoke_config(arch)
    for compress in (False, True):
        mdl = _model(inp, arch, cfg, torch.float32)
        rules = SH.make_rules(mesh, cfg)
        tcfg = TrainConfig(optim=AdamWConfig(lr=3e-4, warmup_steps=5,
                                             total_steps=30),
                           compress_grads=compress)
        with SH.use_shardings(mesh, rules):
            sh = SH.shard_model(mdl, rules)
            params = dict(mdl.named_parameters())
            specs = M.param_specs(cfg, rules)
            grads = {k: sh.shard(k, torch.from_numpy(inp["adamw:g:" + k]))
                     for k in params}
            opt = init_opt_state(tcfg.optim, params)
            err = ({k: torch.zeros_like(g) for k, g in grads.items()}
                   if compress else None)
            opt, err, om = TS.update(tcfg, params, grads, opt, err, specs)
            tag = f"adamw_{compress}"
            out[tag + "_gnorm"] = om["grad_norm"].numpy()
            for k in params:
                for key in ("master", "mu", "nu"):
                    out[f"{tag}_{key}:{k}"] = sh.gather(
                        k, getattr(opt, key)[k]).numpy()
                if compress:
                    out[f"{tag}_err:{k}"] = sh.gather(k, err[k]).numpy()


def _launch(argv, out_dir, tag, out):
    """The launcher on every rank; rank 0's printed lines in out[tag]."""
    from repro_torch.launch import train as T
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        T.main(argv)
    out[tag] = np.asarray(buf.getvalue())


def _cases(rank: int, inp, out: dict, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import LM

    meshes = {s: make_mesh(s, ("data", "model"), device="cpu")
              for s in MESHES}
    for arch in ARCHS:
        for shape, mesh in meshes.items():
            for dt in ("float32", "bfloat16"):
                loss, grads = _loss_and_grads(inp, arch, mesh,
                                              getattr(torch, dt))
                tag = f"{arch}:{shape[0]}x{shape[1]}:{dt}"
                out[tag + ":loss"] = loss.float().numpy()
                for k, g in grads.items():
                    out[f"{tag}:g:{k}"] = g.float().numpy()
    m42 = meshes[(4, 2)]
    for name, flags in (("seq", dict(seq_shard=True)),
                        ("fsdp", dict(strategy="fsdp_dp"))):
        loss, grads = _loss_and_grads(inp, "internlm2-1.8b", m42,
                                      torch.float32, **flags)
        out[f"{name}:loss"] = loss.numpy()
        for k, g in grads.items():
            out[f"{name}:g:{k}"] = g.numpy()
    _adamw(inp, m42, out)

    # the launcher from JAX's initial weights; then its step_10 resumed at
    # meshes 2 x 4 and 8 x 1
    weights = {k.split(":w:", 1)[1]: v for k, v in inp.items()
               if k.startswith("internlm2-1.8b:w:")}

    def jax_init(cfg_, seed=0, device=None, dtype=torch.bfloat16):
        mdl = LM(cfg_, dtype=dtype, device=device)
        with torch.no_grad():
            for name, p in mdl.named_parameters():
                p.copy_(torch.from_numpy(weights[name]))
        return mdl
    T.init_params = jax_init
    run = os.path.join(out_dir, "run")
    _launch(LAUNCH + ["--model-parallel", "2", "--ckpt", run], out_dir,
            "launch", out)
    for mp in (4, 1):
        d = os.path.join(out_dir, f"run_mp{mp}")
        if rank == 0:
            shutil.copytree(os.path.join(run, "step_10"),
                            os.path.join(d, "step_10"))
        dist.barrier()
        _launch(LAUNCH + ["--model-parallel", str(mp), "--ckpt", d,
                          "--resume", "auto"], out_dir, f"resume_mp{mp}",
                out)


def rank_main(rank: int, in_path: str, out_dir: str) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        inp = dict(np.load(in_path))
        out = {}
        _cases(rank, inp, out, out_dir)
        if rank == 0:
            np.savez(os.path.join(out_dir, "torch.npz"), **out)
        elif rank == 1:        # rank 1 printed nothing
            np.savez(os.path.join(out_dir, "rank1.npz"),
                     **{k: out[k] for k in out if k.startswith(
                         ("launch", "resume"))})
    finally:
        from repro_torch.launch.mesh import shutdown
        shutdown()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD)
