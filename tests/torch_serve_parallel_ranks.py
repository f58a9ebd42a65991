"""The rank program of ``test_torch_serve_parallel.py``: the port's sharded
serving on WORLD gloo ranks on the CPU — every smoke config's ``prefill``
and four ``decode_step``s under the rules at each mesh and cache form, in
float32 and bf16, with the gathered decode state, beside the unsharded
port's run of the same inputs.

    python tests/torch_serve_parallel_ranks.py INPUTS.npz OUT_DIR

spawns the ranks (``torch.multiprocessing``), which meet through a
``FileStore`` in OUT_DIR, and leaves rank 0's results in
OUT_DIR/torch.npz. Every rank is handed the whole batch; the logits come
back whole on every rank.
"""
import dataclasses
import os
import sys

import numpy as np

WORLD = 8
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCHS = ("internlm2-1.8b", "starcoder2-7b", "starcoder2-15b", "gemma-2b",
         "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-1.3b",
         "jamba-v0.1-52b", "seamless-m4t-medium", "internvl2-76b")
MESHES = ((4, 2), (1, 8))
DTYPES = ("float32", "bfloat16")
B, S, STEPS, CACHE = 8, 16, 4, 24      # CACHE: 3 rows a rank at (1, 8)
FRAMES, PATCHES = 8, 4


def forms(cfg, shape) -> list:
    """The cache forms served at a mesh: the rules as ``make_rules`` gives
    them, and, where they cut the KV heads, the same rules with
    ``kv_heads=None`` (the cache cut along its sequence)."""
    from repro_torch.parallel import sharding as SH

    class _M:
        axis_names = ("data", "model")
    mesh = _M()
    mesh.shape = dict(zip(mesh.axis_names, shape))
    r = SH.make_rules(mesh, cfg)
    return ["kv_heads", "kv_seq"] if r.kv_heads else ["kv_seq"]


def cases() -> list:
    """(arch, mesh shape, form, dtype) of every sharded run."""
    from repro_torch.configs import get_smoke_config
    return [(arch, shape, form, dt) for arch in ARCHS for shape in MESHES
            for form in forms(get_smoke_config(arch), shape)
            for dt in DTYPES]


def tag(arch, shape, form, dt) -> str:
    return f"{arch}:{shape[0]}x{shape[1]}:{form}:{dt}"


class Routes:
    """Within ``with``: every MoE router call records its top-k experts
    [B_loc, S, k] of this rank's rows; ``step()`` closes a step (the
    prefill or a decode step) → ``calls``: one list of records a step."""

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.real, self.calls = MOE.route, [[]]

        def route(p, x, m):
            probs, gates, idx = self.real(p, x, m)
            self.calls[-1].append(idx)
            return probs, gates, idx
        MOE.route = route
        return self

    def step(self):
        self.calls.append([])

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE.route = self.real


def _serve(model, inp, arch, b: int = B, routes=None):
    """prefill of the prompt, then STEPS decode steps fed the recorded
    tokens → (logits [b, 1 + STEPS, V] float32, the state)."""
    import torch
    from repro_torch.models import model as M
    batch = {k.rsplit(":", 1)[1]: torch.from_numpy(v[:b])
             for k, v in inp.items() if k.startswith(f"{arch}:b:")}
    steps = torch.from_numpy(inp[f"{arch}:steps"][:b])
    tick = routes.step if routes is not None else (lambda: None)
    logits, state, pos = M.prefill(model, batch, CACHE)
    tick()
    enc = (M.encode(model, batch["frames"]) if model.cfg.enc_layers
           else None)
    out = [logits]
    for i in range(STEPS):
        logits, state = M.decode_step(
            model, steps[:, i:i + 1], state,
            torch.tensor(pos + i, dtype=torch.int32), enc_out=enc)
        tick()
        out.append(logits)
    return torch.cat(out, dim=1).float().numpy(), state


def _model(inp, arch, dtype):
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import LM
    mdl = LM(get_smoke_config(arch), dtype=dtype, device="cpu")
    with torch.no_grad():
        for name, p in mdl.named_parameters():
            p.copy_(torch.from_numpy(inp[f"{arch}:w:{name}"]))
    return mdl


def _gathered(state, cfg, rules, b: int) -> list:
    """Every layer's state pair put back together, whole, float32."""
    from repro_torch.parallel import sharding as SH
    out = []
    for pair, specs in zip(state, SH.decode_state_specs(cfg, rules, b)):
        for t, spec in zip(pair, specs):
            full = list(t.shape)
            for d, e in enumerate(spec):
                full[d] = t.shape[d] * rules.mesh.axis_size(SH.spec_axes(e))
            g = SH.gather_leaf(t, spec, rules.mesh, tuple(full))
            out.append(g.float().numpy())
    return out


def _cases(rank: int, inp, out: dict) -> None:
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as SH

    meshes = {s: make_mesh(s, ("data", "model"), device="cpu")
              for s in MESHES}
    for arch in ARCHS:
        for dt in DTYPES:
            with Routes() as rec:
                logits, state = _serve(_model(inp, arch, getattr(torch, dt)),
                                       inp, arch, routes=rec)
            key = f"{arch}:one:{dt}"
            out[key] = logits
            for i, t in enumerate(x for pair in state for x in pair):
                out[f"{key}:state:{i}"] = t.float().numpy()
            for t, calls in enumerate(rec.calls):
                for c, idx in enumerate(calls):
                    out[f"{key}:route:{t}:{c}"] = idx.numpy()
    for arch, shape, form, dt in cases():
        mdl = _model(inp, arch, getattr(torch, dt))
        mesh = meshes[shape]
        rules = SH.make_rules(mesh, mdl.cfg)
        if form == "kv_seq":
            rules = dataclasses.replace(rules, kv_heads=None)
        key = tag(arch, shape, form, dt)
        with SH.use_shardings(mesh, rules), Routes() as rec:
            SH.shard_model(mdl, rules)
            logits, state = _serve(mdl, inp, arch, routes=rec)
            out[key] = logits
            bs = SH._batch_spec(rules, B)
            for t, calls in enumerate(rec.calls):   # the MoE models' routes
                for c, idx in enumerate(calls):
                    out[f"{key}:route:{t}:{c}"] = SH.gather_leaf(
                        idx, (bs, None, None), mesh,
                        (B, *idx.shape[1:])).numpy()
            for i, t in enumerate(_gathered(state, mdl.cfg, rules, B)):
                # the padded rows of an uneven sequence cut are cut off
                want = out[f"{arch}:one:{dt}:state:{i}"].shape
                out[f"{key}:state:{i}"] = t[tuple(slice(0, n) for n in want)]
    # a batch the batch axes do not divide is whole on every rank
    mesh = meshes[(4, 2)]
    mdl = _model(inp, "internlm2-1.8b", torch.float32)
    rules = SH.make_rules(mesh, mdl.cfg)
    with SH.use_shardings(mesh, rules):
        SH.shard_model(mdl, rules)
        out["b2"], _ = _serve(mdl, inp, "internlm2-1.8b", b=2)


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
    sys.path.insert(0, SRC)
    import torch.multiprocessing as mp
    mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD)
