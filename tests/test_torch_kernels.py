"""The port's plain kernel versions against the JAX package's kernels on the
CPU: each against the JAX op's reference path and against the Pallas
function run with ``interpret=True``, on the same numpy-seeded inputs.

Tolerance: rtol = 1e-5 with atol = 1e-5 · max|f|. Both sides compute each
pair term in float32 with the same order of operations; only the order of
the sums over sources differs (XLA's reduction tree vs torch's), which moves
a force by a few float32 ulps of the largest term it sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.grid_force import ops as jax_grid
from repro.kernels.grid_force.kernel import grid_far_pallas, grid_near_pallas
from repro.kernels.grid_force.ref import grid_far_ref as jax_far_ref
from repro.kernels.grid_force.ref import grid_near_ref as jax_near_ref
from repro.kernels.nbody.kernel import nbody_repulsion_pallas
from repro.kernels.nbody.ref import nbody_repulsion_ref as jax_nbody_ref
from repro.kernels.neighbor_force.kernel import neighbor_repulsion_pallas
from repro.kernels.neighbor_force.ref import \
    neighbor_repulsion_ref as jax_neighbor_ref
from repro_torch.kernels import _build
from repro_torch.kernels.grid_force import ops as grid_ops
from repro_torch.kernels.nbody.ops import nbody_repulsion
from repro_torch.kernels.neighbor_force.ops import (neighbor_repulsion,
                                                    neighbor_split)

C, L, MD = 1.3, 0.8, 1e-2
CONSTS = _build.consts_tensor(C, L, MD, "cpu")     # what the wrappers take
RTOL = 1e-5


def _close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=1e-5 * float(np.abs(ref).max()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _vertices(n, seed, scale=10.0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 2)) * scale).astype(np.float32)
    mass = (rng.random(n) + 0.5).astype(np.float32)
    vmask = rng.random(n) > 0.15
    return pos, mass, vmask


@pytest.mark.parametrize("n", [200, 256, 389])
def test_nbody_plain_matches_jax(n):
    pos, mass, vmask = _vertices(n, n)
    port = nbody_repulsion(_t(pos), _t(mass), _t(vmask), CONSTS).numpy()
    _close(port, jax_nbody_ref(jnp.asarray(pos), jnp.asarray(mass),
                               jnp.asarray(vmask), C, L, MD))
    if n % 128 == 0:
        _close(port, nbody_repulsion_pallas(
            jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(vmask), C, L,
            MD, block_rows=128, block_cols=128, interpret=True))


@pytest.mark.parametrize("n,K", [(200, 32), (384, 64), (256, 128), (512, 192)])
def test_neighbor_plain_matches_jax(n, K):
    pos, mass, vmask = _vertices(n, K, scale=5.0)
    rng = np.random.default_rng(n)
    nbr = rng.integers(0, n + 1, size=(n, K)).astype(np.int32)
    nmask = rng.random((n, K)) > 0.25
    nbr = np.where(nmask, nbr, n).astype(np.int32)
    port = neighbor_repulsion(_t(pos), _t(mass), _t(nbr), _t(nmask),
                              _t(vmask), CONSTS).numpy()
    _close(port, jax_neighbor_ref(jnp.asarray(pos), jnp.asarray(mass),
                                  jnp.asarray(nbr), jnp.asarray(nmask),
                                  jnp.asarray(vmask), C, L, MD))
    if n % 128 == 0:
        w = np.where(vmask, mass, 0).astype(np.float32)
        pos_p = np.concatenate([pos, np.zeros((1, 2), np.float32)])
        w_p = np.concatenate([w, np.zeros(1, np.float32)])
        nw = np.where(nmask, w_p[nbr], 0).astype(np.float32)
        out = np.asarray(neighbor_repulsion_pallas(
            jnp.asarray(pos), jnp.asarray(pos_p[nbr]), jnp.asarray(nw),
            C, L, MD, block_rows=128, interpret=True))
        _close(port, out * vmask[:, None])


@pytest.mark.parametrize("n,K", [(200, 32), (389, 37)])
def test_neighbor_plain_matches_jax_on_out_of_range_slots(n, K):
    """Masked-in slots holding the sentinel n, indices past it, −1, −n, and
    indices below −(n+1): the port resolves each as JAX's gather from the
    (n+1)-row tables does (a negative index gets n+1 added, then clamp to
    [0, n]), so row 0 is read for the last kind."""
    pos, mass, vmask = _vertices(n, K, scale=5.0)
    vmask[0] = True                       # row 0 must carry weight
    rng = np.random.default_rng(n + 1)
    nbr = rng.integers(0, n, size=(n, K))
    nmask = rng.random((n, K)) > 0.25
    bad = nmask & (rng.random((n, K)) < 0.3)
    odd = rng.choice([n, n + 1, n + 3, 2 ** 31 - 1, -1, -2, -n, -(n + 1),
                      -(n + 2), -3 * n, -2 ** 31], (n, K))
    nbr = np.where(bad, odd, nbr).astype(np.int32)
    assert (nbr[nmask] < -(n + 1)).any()
    port = neighbor_repulsion(_t(pos), _t(mass), _t(nbr), _t(nmask),
                              _t(vmask), CONSTS).numpy()
    _close(port, jax_neighbor_ref(jnp.asarray(pos), jnp.asarray(mass),
                                  jnp.asarray(nbr), jnp.asarray(nmask),
                                  jnp.asarray(vmask), C, L, MD))


@pytest.mark.parametrize("K", [1, 32, 37, 40, 64, 128, 192, 256])
def test_neighbor_split_covers_a_row_in_one_pass(K):
    """The wrapper's (rows a warp, groups a lane) for the schedule's caps and
    ragged K: a pair the kernel is built for, whose lanes cover a row of K
    slots in one pass."""
    R, G = neighbor_split(K)
    assert (R, G) in {(4, 1), (2, 1), (1, 1), (1, 2)}
    assert 4 * G * (32 // R) >= K


def _binned(n, seed, G, cap):
    pos, mass, vmask = _vertices(n, seed)
    cid_j, bucket_j, inb_j = jax_grid.bin_vertices(
        jnp.asarray(pos), jnp.asarray(vmask), G, cap)
    cid, bucket, inb = grid_ops.bin_vertices(_t(pos), _t(vmask), G, cap)
    np.testing.assert_array_equal(cid.numpy(), np.asarray(cid_j))
    np.testing.assert_array_equal(bucket.numpy(), np.asarray(bucket_j))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(inb_j))
    return pos, mass, vmask, bucket


@pytest.mark.parametrize("n,G,cap", [(300, 6, 8), (500, 4, 16)])
def test_bin_vertices_and_grid_near_match_jax(n, G, cap):
    pos, mass, vmask, bucket = _binned(n, n, G, cap)
    table = grid_ops.neighbor_table(G, torch.device("cpu"))
    np.testing.assert_array_equal(table.numpy(), jax_grid.neighbor_table(G))
    port = grid_ops.grid_near(_t(pos), _t(mass), _t(vmask), bucket, table,
                              CONSTS).numpy()
    # the JAX package's pre-gather + scatter around its near kernel
    nc = G * G
    b = bucket.numpy()
    w = np.where(vmask, mass, 0).astype(np.float32)
    pos_p = np.concatenate([pos, np.zeros((1, 2), np.float32)])
    w_p = np.concatenate([w, np.zeros(1, np.float32)])
    nbr = b[table.numpy()[:nc]].reshape(nc, 9 * cap)
    args = (jnp.asarray(pos_p[b[:nc]]), jnp.asarray(pos_p[nbr]),
            jnp.asarray(w_p[nbr]), C, L, MD)
    for near in (jax_near_ref(*args),
                 grid_near_pallas(*args, block_cells=1, interpret=True)):
        f = np.zeros((n + 1, 2), np.float32)
        f[b[:nc].reshape(-1)] = np.asarray(near).reshape(-1, 2)
        _close(port, f[:n])
    assert (port[~np.isin(np.arange(n), b[:nc])] == 0).all()


@pytest.mark.parametrize("n,nc", [(300, 37), (256, 128)])
def test_grid_far_plain_matches_jax(n, nc):
    pos, _, _ = _vertices(n, nc)
    rng = np.random.default_rng(nc)
    cells = np.concatenate([rng.random((nc, 2)) * 10,
                            rng.random((nc, 1)) * 5], 1).astype(np.float32)
    port = grid_ops.grid_far(_t(pos), _t(cells), CONSTS).numpy()
    _close(port, jax_far_ref(jnp.asarray(pos), jnp.asarray(cells), C, L, MD))
    npad, ncpad = -(-n // 128) * 128, -(-nc // 128) * 128
    pp = np.zeros((npad, 2), np.float32)
    pp[:n] = pos
    cp = np.zeros((ncpad, 3), np.float32)
    cp[:nc] = cells
    out = grid_far_pallas(jnp.asarray(pp), jnp.asarray(cp), C, L, MD,
                          block_rows=128, block_cols=128, interpret=True)
    _close(port, np.asarray(out)[:n])


@pytest.mark.parametrize("n,G,cap", [(800, 9, 12)])
def test_grid_repulsion_matches_jax(n, G, cap):
    """The composed op (binning, near, far, corrections); ~10 vertices per
    cell against a cap of 12 overflows some buckets and not others, so both
    kinds of cell and the overflow terms are exercised."""
    pos, mass, vmask = _vertices(n, G)
    port = grid_ops.grid_repulsion(_t(pos), _t(mass), _t(vmask), CONSTS,
                                   grid_dim=G, cell_cap=cap).numpy()
    ref = np.asarray(jax_grid.grid_repulsion(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(vmask), C, L, MD,
        grid_dim=G, cell_cap=cap))
    _close(port, ref)


def test_choose_grid_matches_jax():
    for n in (256, 4096, 32768, 1 << 18, 1 << 20, 1 << 22):
        assert grid_ops.choose_grid(n) == jax_grid.choose_grid(n)


def test_grid_repulsion_overflow_cells_present():
    pos, _, vmask = _vertices(800, 9)
    _, bucket, inb = grid_ops.bin_vertices(_t(pos), _t(vmask), 9, 12)
    full = (bucket[:81] < 800).all(dim=1)
    assert 0 < int(full.sum()) < 81 and not bool(inb[_t(vmask)].all())


# -- the path's shapes and the near kernel's split table ----------------------

def _scattered_mask(n, valid, seed):
    """``valid`` true entries of n at random places: not a prefix."""
    vmask = np.zeros(n, bool)
    vmask[np.random.default_rng(seed).choice(n, valid, replace=False)] = True
    assert not vmask[:valid].all()
    return vmask


@pytest.mark.parametrize("n,valid", [(256, 1), (256, 9), (256, 253),
                                     (1024, 632)])
def test_nbody_plain_matches_jax_at_path_shapes(n, valid):
    """The exact levels' shapes (9 and 253 of 256, 632 of 1024) and a
    single valid vertex, with the valid vertices scattered instead of a
    prefix."""
    pos, mass, _ = _vertices(n, valid)
    vmask = _scattered_mask(n, valid, n + valid)
    port = nbody_repulsion(_t(pos), _t(mass), _t(vmask), CONSTS).numpy()
    args = (jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(vmask), C, L, MD)
    _close(port, jax_nbody_ref(*args))
    _close(port, nbody_repulsion_pallas(*args, block_rows=128,
                                        block_cols=128, interpret=True))
    assert (port[~vmask] == 0).all()


def test_bin_vertices_and_grid_near_match_jax_at_the_path_grid():
    """G 105, cap 48 (the grid of the path's second level) on a skewed
    drawing: half the vertices spread, half in four tight clumps whose cells
    overflow the cap. The JAX side runs over the occupied cells only, as
    the empty ones have no rows."""
    n, G, cap = 4096, 105, 48
    rng = np.random.default_rng(105)
    pos = rng.random((n, 2)) * 100.0
    clumps = rng.random((4, 2)) * 100.0
    pos[n // 2:] = (clumps[rng.integers(0, 4, n - n // 2)]
                    + rng.normal(scale=0.2, size=(n - n // 2, 2)))
    pos = pos.astype(np.float32)
    mass = (rng.random(n) + 0.5).astype(np.float32)
    vmask = rng.random(n) > 0.15
    cid_j, bucket_j, inb_j = jax_grid.bin_vertices(
        jnp.asarray(pos), jnp.asarray(vmask), G, cap)
    _, bucket, inb = grid_ops.bin_vertices(_t(pos), _t(vmask), G, cap)
    np.testing.assert_array_equal(bucket.numpy(), np.asarray(bucket_j))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(inb_j))
    nc = G * G
    b = bucket.numpy()
    full = (b[:nc] < n).all(axis=1)
    assert full.sum() >= 4 and not inb.numpy()[vmask].all()
    table = grid_ops.neighbor_table(G, torch.device("cpu"))
    port = grid_ops.grid_near(_t(pos), _t(mass), _t(vmask), bucket, table,
                              CONSTS).numpy()

    occ = np.nonzero((b[:nc] < n).any(axis=1))[0]
    occ = np.concatenate([occ, np.full(-len(occ) % 8, nc)])  # 8 a block
    w = np.where(vmask, mass, 0).astype(np.float32)
    pos_p = np.concatenate([pos, np.zeros((1, 2), np.float32)])
    w_p = np.concatenate([w, np.zeros(1, np.float32)])
    nbr = b[table.numpy()[occ]].reshape(len(occ), 9 * cap)
    args = (jnp.asarray(pos_p[b[occ]]), jnp.asarray(pos_p[nbr]),
            jnp.asarray(w_p[nbr]), C, L, MD)
    for near in (jax_near_ref(*args),
                 grid_near_pallas(*args, block_cells=8, interpret=True)):
        f = np.zeros((n + 1, 2), np.float32)
        f[b[occ].reshape(-1)] = np.asarray(near).reshape(-1, 2)
        _close(port, f[:n])
    assert (port[~np.isin(np.arange(n), b[:nc])] == 0).all()


@pytest.mark.parametrize("cap", [8, 48, 120, 512])
def test_grid_near_split_table(cap):
    """The table the near kernel reads, (RT << 8) | s for each row count a
    cell may hold: RT rows a lane within near_rows<1..4>, s lanes a row
    within a warp, and the splits the kernel's header names for the path's
    two grids (~61 and ~10 rows a cell)."""
    split = grid_ops.near_split_table(cap, torch.device("cpu")).tolist()
    assert len(split) == cap + 1 and split[0] == 0
    for rows in range(1, cap + 1):
        rt, s = grid_ops.near_split(rows)
        assert 1 <= rt <= grid_ops.NEAR_MAX_RT and 1 <= s <= 32
        assert split[rows] == rt << 8 | s
    assert grid_ops.near_split(61) == (4, 2)
    assert grid_ops.near_split(10) == (2, 5)


@pytest.mark.parametrize("R,ncell,bad", [
    (1, 1, 0.0),
    (500, 7, 0.0),
    (3000, 130, 0.1),      # a tenth of the centres outside [0, ncell)
    (257, 1, 0.5),         # one cell and the last group only
])
def test_near_field_grouping(R, ncell, bad):
    """The near_field kernel's grouping of its rows (``group_rows``): the
    rows in stable order of their centre cell ``near9[:, 4]``, every centre
    outside [0, ncell) (below 0 or at and past ncell) in one last group
    ``ncell``, and each group's start — what the kernel's warps read to
    find their rows."""
    rng = np.random.default_rng(R)
    near9 = rng.integers(0, ncell, (R, 9)).astype(np.int32)
    out = rng.random(R) < bad
    near9[out, 4] = rng.choice([-3, -1, ncell, ncell + 5], out.sum())
    order, keys, starts = grid_ops.group_rows(_t(near9), ncell)
    want = np.where(out, ncell, near9[:, 4])
    assert order.dtype == torch.int64 and keys.dtype == torch.int32
    assert starts.dtype == torch.int32 and starts.shape == (ncell + 2,)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(want, kind="stable"))
    np.testing.assert_array_equal(keys.numpy(), want[order.numpy()])
    np.testing.assert_array_equal(
        starts.numpy(), np.searchsorted(np.sort(want), np.arange(ncell + 2)))
    assert starts[-1] == R and starts[-2] == R - out.sum()
