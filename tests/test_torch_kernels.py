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
from repro_torch.kernels.grid_force import ops as grid_ops
from repro_torch.kernels.nbody.ops import nbody_repulsion
from repro_torch.kernels.neighbor_force.ops import neighbor_repulsion

C, L, MD = 1.3, 0.8, 1e-2
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
    port = nbody_repulsion(_t(pos), _t(mass), _t(vmask), C, L, MD).numpy()
    _close(port, jax_nbody_ref(jnp.asarray(pos), jnp.asarray(mass),
                               jnp.asarray(vmask), C, L, MD))
    if n % 128 == 0:
        _close(port, nbody_repulsion_pallas(
            jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(vmask), C, L,
            MD, block_rows=128, block_cols=128, interpret=True))


@pytest.mark.parametrize("n,K", [(200, 32), (384, 64)])
def test_neighbor_plain_matches_jax(n, K):
    pos, mass, vmask = _vertices(n, K, scale=5.0)
    rng = np.random.default_rng(n)
    nbr = rng.integers(0, n + 1, size=(n, K)).astype(np.int32)
    nmask = rng.random((n, K)) > 0.25
    nbr = np.where(nmask, nbr, n).astype(np.int32)
    port = neighbor_repulsion(_t(pos), _t(mass), _t(nbr), _t(nmask),
                              _t(vmask), C, L, MD).numpy()
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
                              C, L, MD).numpy()
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
    port = grid_ops.grid_far(_t(pos), _t(cells), C, L, MD).numpy()
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
    port = grid_ops.grid_repulsion(_t(pos), _t(mass), _t(vmask), C, L, MD,
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
