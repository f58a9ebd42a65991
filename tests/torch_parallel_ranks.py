"""The rank program of ``test_torch_parallel.py``: the port's side of
``parallel/`` (the ring collective matmul, ring attention, both MoE forms,
the GPipe pipeline, the one-rank rings and an uneven split), run by WORLD
gloo ranks on the CPU.

    python tests/torch_parallel_ranks.py INPUTS.npz OUT_DIR

spawns the ranks (``torch.multiprocessing``), which meet through a
``FileStore`` in OUT_DIR, compute each case from the inputs the test wrote
and leave rank 0's gathered results in OUT_DIR/torch.npz.
"""
import dataclasses
import os
import sys

import numpy as np

WORLD = 8
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _cases(rank: int, inp, out: dict) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.collectives import ring_collective_matmul
    from repro_torch.parallel.pipeline import pipeline_forward
    from repro_torch.parallel.ring_attention import ring_attention

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    m18 = make_mesh((1, 8), ("data", "model"), device="cpu")
    m24 = make_mesh((2, 4), ("data", "model"), device="cpu")
    m81 = make_mesh((8, 1), ("data", "model"), device="cpu")
    m222 = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    m142 = make_mesh((1, 4, 2), ("pod", "data", "model"), device="cpu")

    def gather(x, mesh, axes, dim):
        return comm._gather(x.detach(), mesh.group(axes), dim)

    # the ring collective matmul at (1, 8): x by rows, w by columns
    x, w = t(inp["rcm_x"]), t(inp["rcm_w"])
    i = m18.axis_index("model")
    y = ring_collective_matmul(m18, "model")(x[i * 8:(i + 1) * 8],
                                             w[:, i * 6:(i + 1) * 6])
    out["rcm"] = gather(y, m18, "model", 1).numpy()
    # … on a one-rank axis: the block's own product, bit for bit
    out["rcm1"] = ring_collective_matmul(m81, "model")(x, w).numpy()
    out["rcm1_plain"] = (x @ w).numpy()

    # ring attention at (2, 4): B over data, S over model
    d, i = m24.axis_index("data"), m24.axis_index("model")
    for dt in ("float32", "bfloat16"):
        q, k, v = (t(inp[f"ra_{n}"]).to(getattr(torch, dt))
                   for n in "qkv")
        for causal in (True, False):
            f = ring_attention(m24, causal=causal)
            blk = [a[d:d + 1, i * 64:(i + 1) * 64] for a in (q, k, v)]
            o = gather(gather(f(*blk), m24, "model", 1), m24, "data", 0)
            out[f"ra_{dt}_{causal}"] = o.float().numpy()
            # a one-rank axis: the whole sequence of the rank's rows
            r = m81.axis_index("data")
            rows = [a[r % 2:r % 2 + 1] for a in (q, k, v)]
            o1 = ring_attention(m81, causal=causal)(*rows)
            out[f"ra1_{dt}_{causal}"] = gather(o1, m81, "data", 0
                                               ).float().numpy()
            out[f"ra1_plain_{dt}_{causal}"] = torch.cat([
                flash_attention_ref(*[a[j % 2:j % 2 + 1] for a in (q, k, v)],
                                    causal=causal)
                for j in range(8)]).float().numpy()

    # both MoE forms at (2, 4)
    m = MoEConfig(n_experts=8, top_k=2, d_expert=16, capacity_factor=2.0)
    full = MOE.MoE(32, m, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name in ("router", "wup", "wgate", "wdown"):
            getattr(full, name).copy_(t(inp[f"moe_{name}"]))
    local = MOE.MoE(32, m, torch.float32, torch.device("cpu"))
    local.load_state_dict(full.state_dict())
    with torch.no_grad():
        for name in ("wup", "wgate", "wdown"):
            p = getattr(local, name)
            p.data = p.data[i * 2:(i + 1) * 2].clone()
    rules = dataclasses.replace(SH.make_rules(m24, None), experts="model")
    x1 = t(inp["moe_x1"])
    with SH.use_shardings(m24, rules):
        y, aux = MOE.apply_moe_shardmap(local, x1[d * 2:(d + 1) * 2], m)
        y_gspmd, _ = MOE.apply_moe(local, x1[d * 2:(d + 1) * 2], m)
    out["moe_shardmap"] = gather(y, m24, "data", 0).numpy()
    out["moe_shardmap_gspmd"] = gather(y_gspmd, m24, "data", 0).numpy()
    out["moe_shardmap_plain"] = MOE.apply_moe(full, x1, m)[0].numpy()
    m4 = dataclasses.replace(m, capacity_factor=4.0)
    rules = dataclasses.replace(SH.make_rules(m24, None), experts="model",
                                batch=("data", "model"),
                                moe_impl="all_to_all")
    x2 = t(inp["moe_x2"])
    j = m24.index(("data", "model"))
    with SH.use_shardings(m24, rules):
        y, _ = MOE.apply_moe_a2a(local, x2[j:j + 1], m4)
    out["moe_a2a"] = gather(y, m24, ("data", "model"), 0).numpy()
    out["moe_a2a_plain"] = MOE.apply_moe(full, x2, m4)[0].numpy()

    # the pipeline at (2, 2, 2) and at one stage (1, 4, 2), float32
    cfg = get_smoke_config("internlm2-1.8b")
    tokens = t(inp["pp_tokens"]).long()

    def model_of():
        mdl = M.LM(cfg, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            for name, p in mdl.named_parameters():
                p.copy_(t(inp["pp_" + name]))
        return mdl

    ref = model_of()
    ref.requires_grad_(True)
    logits, _ = M.forward(ref, {"tokens": tokens}, train=True)
    rp = dict(ref.named_parameters())
    g_ref = torch.autograd.grad((logits ** 2).sum() * 1e-6,
                                list(rp.values()))
    out["pp_forward"] = logits.detach().numpy()
    for k, g in zip(rp, g_ref):
        out["pp_ref_grad_" + k] = g.numpy()
    for tag, mesh, remat in (("pp", m222, "none"), ("pp_remat", m222, "full"),
                             ("pp1", m142, "none")):
        rules = SH.make_rules(mesh, cfg)
        mdl = model_of()
        with SH.use_shardings(mesh, rules):
            sh = SH.shard_model(mdl, rules)
            mdl.requires_grad_(True)
            lg = pipeline_forward(mdl, {"tokens": tokens}, mesh,
                                  n_microbatches=4 if tag != "pp1" else 2,
                                  remat=remat)
            loss = comm.psum((lg ** 2).sum(), mesh.group(("data", "model")))
            ps = dict(mdl.named_parameters())
            grads = torch.autograd.grad(loss * 1e-6, list(ps.values()),
                                        allow_unused=True)
            full_lg = gather(gather(lg, mesh, "model", 2), mesh, "data", 0)
            out[tag] = full_lg.detach().numpy()
            if tag == "pp1":
                continue
            for k, g in zip(ps, grads):
                g = torch.zeros_like(ps[k]) if g is None else g.clone()
                dist.all_reduce(g, group=mesh.group("data"))
                if k.startswith("layers."):
                    dist.all_reduce(g, group=mesh.group("pod"))
                out[f"{tag}_grad_{k}"] = sh.gather(k, g).numpy()

    # an uneven split: d_ff 100 over a model axis of 8 (blocks of 13, the
    # last of 9), the sharded loss and gradients against the unsharded
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), d_ff=100)
    batch = {"tokens": t(inp["un_tokens"]), "labels": t(inp["un_labels"])}
    plain = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    plain.requires_grad_(True)
    loss, _ = M.loss_fn(plain, batch)
    pp = dict(plain.named_parameters())
    out["un_loss_plain"] = loss.detach().numpy()
    for k, g in zip(pp, torch.autograd.grad(loss, list(pp.values()))):
        out["un_plain_grad_" + k] = g.numpy()
    mdl = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    rules = SH.make_rules(m18, cfg)
    with SH.use_shardings(m18, rules):
        sh = SH.shard_model(mdl, rules)
        out["un_dff_block"] = np.asarray(mdl.layers[0].mlp["wup"].shape[1])
        mdl.requires_grad_(True)
        loss, _ = M.loss_fn(mdl, SH.batch_rows(batch, rules))
        ps = dict(mdl.named_parameters())
        grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
        grads = SH.reduce_grads(grads, M.param_specs(cfg, rules), rules)
    out["un_loss"] = loss.detach().numpy()
    for k, g in grads.items():
        out["un_grad_" + k] = sh.gather(k, g).numpy()
    blocks = [None] * WORLD
    dist.all_gather_object(blocks, out["un_dff_block"].item())
    out["un_dff_blocks"] = np.asarray(blocks)


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
        _cases(rank, inp, out)
        if rank == 0:
            np.savez(os.path.join(out_dir, "torch.npz"), **out)
    finally:
        from repro_torch.launch.mesh import shutdown
        shutdown()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD)
