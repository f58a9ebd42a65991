"""The rank program of ``test_torch_distributed.py``: the port's side of every
sharded case, run by WORLD gloo ranks on the CPU.

    python tests/torch_dist_ranks.py INPUTS.npz OUT_DIR

spawns the ranks (``torch.multiprocessing``), which meet through a
``FileStore`` in OUT_DIR, compute each case from the inputs the test wrote
and leave rank 0's results in OUT_DIR/torch.npz (arrays, plus the CLI's
printed text and the ranks' errors). A case's output is the all-gathered
array, the same on every rank; rank 1 records whether it matched rank 0's.
"""
import contextlib
import io
import os
import sys

import numpy as np

WORLD = 8
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _cases(rank: int, inp, out: dict) -> None:
    import torch

    from repro_torch.core import LayoutConfig, multigila_layout
    from repro_torch.core import distributed as D
    from repro_torch.launch import layout as cli
    from repro_torch.launch.mesh import make_mesh

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    b = lambda a: torch.from_numpy(np.asarray(a, bool))
    m42 = make_mesh((4, 2), ("data", "model"), device="cpu")
    m81 = make_mesh((8, 1), ("data", "model"), device="cpu")
    m222 = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    full = lambda mesh, blk: D._all_gather(blk, mesh.vtx_group).numpy()
    sh = m42.shard_rows
    params = f32([1.0, 1.0, 1e-3])

    # the four superstep building blocks at 4x2
    pos, w = f32(inp["nb_pos"]), f32(inp["nb_w"])
    out["nbody"] = full(m42, D.sharded_nbody(m42, 256)(sh(pos), sh(w),
                                                       params))
    src, dl, em, ew, m_pad = D.partition_edges(
        inp["at_src"], inp["at_dst"], inp["at_emask"], inp["at_ewt"], 256, 4)
    out["attraction"] = full(m42, D.sharded_attraction(m42, 256, m_pad)(
        sh(pos), sh(i32(src)), sh(i32(dl)), sh(b(em)), sh(f32(ew)), params))
    out["push_max"] = full(m42, D.sharded_push_max(m42, 256)(
        sh(i32(inp["pm_vals"])), sh(i32(src)), sh(i32(dl)), sh(b(em))))
    out["neighbor"] = full(m42, D.sharded_neighbor_force(m42, 256, 8)(
        sh(pos), sh(w), sh(i32(inp["nf_nbr"])), params))

    # the grid force, both variants
    gp = f32([1.2, 0.9, 1e-2])
    for name in ("uniform", "overflow"):
        G, cap = (int(x) for x in inp["grid_gc"])
        fn = D.sharded_grid_force(m42, 512, G, cap)
        out[f"grid_{name}"] = full(m42, fn(sh(f32(inp[f"grid_{name}_pos"])),
                                           sh(f32(inp[f"grid_{name}_w"])),
                                           gp))
    fn = D.sharded_grid_force(m42, 512, 8, 16, variant="halo")
    for name in ("band", "violation"):
        out[f"halo_{name}"] = full(m42, fn(sh(f32(inp[f"{name}_pos"])),
                                           sh(f32(inp["band_w"])), gp))

    # one full step a (mesh, engine, mode)
    for mname, mesh in (("4x2", m42), ("8x1", m81)):
        s = mesh.shard_rows
        vs = mesh.vtx_size
        src, dl, em, ew, m_pad = D.partition_edges(
            inp["st_src"], inp["st_dst"], inp["st_emask"], inp["st_ewt"],
            512, vs)
        for mode in ("exact", "neighbor", "grid"):
            nbr = (inp["st_nbr"] if mode == "neighbor"
                   else np.full((512, 1), 512, np.int32))
            G, cap = ((int(x) for x in inp["grid_gc"]) if mode == "grid"
                      else (0, 0))
            for engine in ("gila", "stress"):
                step = D.layout_train_step(
                    mesh, 512, m_pad, nbr.shape[1], mode=mode, grid_dim=G,
                    cell_cap=cap, engine=engine)
                args = [s(f32(inp["st_pos"])), s(f32(inp["st_w"])),
                        s(i32(nbr)), s(i32(src)), s(i32(dl)), s(b(em)),
                        s(f32(ew)), gp, 0.5]
                if engine == "stress":
                    args.append(0.3)
                out[f"step_{mname}_{engine}_{mode}"] = full(mesh, step(*args))

    # the halo step: full halo (every peer sends its whole block) against
    # the all-gather step, neighbor mode; the grid halo step, band inputs
    s = m42.shard_rows
    no_edges_g = (i32(np.full(8, 64)), i32(np.zeros(8)), b(np.zeros(8)),
                  f32(np.ones(8)))
    no_edges = tuple(s(x) for x in no_edges_g)
    hp = f32([1.0, 1.0, 1e-2])
    step = D.layout_train_step(m42, 64, 8, 8, mode="neighbor")
    out["halo_step_ag"] = full(m42, step(
        s(f32(inp["hs_pos"])), s(f32(np.ones(64))), s(i32(inp["hs_nbr"])),
        *no_edges, hp, 0.5))
    step = D.layout_train_step_halo(m42, 64, 8, 8, 16)
    out["halo_step"] = full(m42, step(
        s(f32(inp["hs_pos"])), s(f32(np.ones(64))), s(i32(inp["hs_local"])),
        s(i32(inp["hs_send"])), *no_edges, hp, 0.5))
    # the same on a pod mesh: vertex axes (pod, data), the all-to-all a
    # stage an axis
    s = m222.shard_rows
    step = D.layout_train_step(m222, 64, 8, 8, mode="neighbor")
    out["halo_step_ag_pod"] = full(m222, step(
        s(f32(inp["hs_pos"])), s(f32(np.ones(64))), s(i32(inp["hs_nbr"])),
        *(s(x) for x in no_edges_g), hp, 0.5))
    step = D.layout_train_step_halo(m222, 64, 8, 8, 16)
    out["halo_step_pod"] = full(m222, step(
        s(f32(inp["hs_pos"])), s(f32(np.ones(64))), s(i32(inp["hs_local"])),
        s(i32(inp["hs_send"])), *(s(x) for x in no_edges_g), hp, 0.5))
    s = m42.shard_rows
    step = D.layout_train_step_halo(m42, 512, 8, 1, 1, mode="grid",
                                       grid_dim=8, cell_cap=16)
    out["halo_step_grid"] = full(m42, step(
        s(f32(inp["band_pos"])), s(f32(inp["band_w"])),
        s(i32(np.full((512, 1), 512))), s(i32(np.full((16, 1), 128))),
        *no_edges, gp, 0.5))

    # the driver end to end, both engines: grid(18, 18) at mesh 4x2 (exact
    # levels), and a delaunay in all three modes at mesh 8x1
    for tag, shape, kw in (("ml", (4, 2), {}),
                           ("ml3", (8, 1), dict(exact_threshold=64,
                                                grid_threshold=512))):
        edges, n = inp[f"{tag}_edges"], int(inp[f"{tag}_n"])
        for engine in ("gila", "stress"):
            p, st, exp = multigila_layout(edges, n, LayoutConfig(
                seed=0, driver="multigila_dist", engine=engine,
                mesh_shape=shape, **kw), export=True, device="cpu")
            out[f"{tag}_{engine}_pos"] = p
            out[f"{tag}_{engine}_modes"] = np.asarray(st.level_modes)
            for i, lvl in enumerate(exp.levels):
                out[f"{tag}_{engine}_exp{i}_edges"] = lvl.edges
                out[f"{tag}_{engine}_exp{i}_rep"] = lvl.rep
                if lvl.parent is not None:
                    out[f"{tag}_{engine}_exp{i}_parent"] = lvl.parent

    # the CLI: rank 0 prints; a mesh of another size than the world raises
    base = ["--graph", "grid", "--args", "12", "12", "--device", "cpu",
            "--driver", "multigila_dist", "--no-cre"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = cli.main(base + ["--mesh", "4x2"])
    out["cli_text"] = np.asarray(buf.getvalue())
    out["cli_neld"] = np.asarray(rep["neld"])
    try:
        cli.main(base + ["--mesh", "2x2"])
        out["cli_mismatch"] = np.asarray("no error")
    except ValueError as e:
        out["cli_mismatch"] = np.asarray(f"ValueError: {e}")


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
        # every rank's results must be the same: rank 1 checks its own
        # against rank 0's through the store
        if rank == 0:
            np.savez(os.path.join(out_dir, "torch.npz"), **out)
        dist.barrier()
        if rank == 1:
            ref = dict(np.load(os.path.join(out_dir, "torch.npz")))
            same = [k for k in out if k != "cli_text"
                    and np.array_equal(ref[k], out[k])]
            with open(os.path.join(out_dir, "rank1.txt"), "w") as f:
                f.write(f"{len(same)} {len(out) - 1} "
                        f"printed={out['cli_text'].item()!r}")
    finally:
        from repro_torch.launch.mesh import shutdown
        shutdown()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD)
