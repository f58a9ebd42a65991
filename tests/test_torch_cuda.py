"""The port's CUDA kernels on the card, each against its plain PyTorch version.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card (and
``nvcc`` to build the kernels at first use); without one each test skips
with its reason. The plain versions themselves are held to the JAX package
in ``test_torch_kernels.py``. On a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Sizes here are ragged on purpose (not multiples of the block widths), and
one grid case has a bucket cap large enough that the near kernel needs more
than 48 KB of dynamic shared memory. Tolerance: rtol 1e-4 with atol
1e-5 · max|plain| — the kernels sum over sources in another order than the
plain versions' reductions (one test, on the composed grid op, states its
own bound).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build
from repro_torch.kernels.grid_force import ops as grid_ops
from repro_torch.kernels.grid_force.ref import grid_far_ref, grid_near_ref
from repro_torch.kernels.nbody.ops import nbody_repulsion
from repro_torch.kernels.nbody.ref import nbody_repulsion_ref
from repro_torch.kernels.neighbor_force.ops import neighbor_repulsion
from repro_torch.kernels.neighbor_force.ref import neighbor_repulsion_ref

C, L, MD = 1.3, 0.8, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _close(out, ref, atol_frac=1e-5):
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=atol_frac * float(ref.abs().max()))


def _vertices(n, seed, dev, scale=10.0):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy((rng.random((n, 2)) * scale).astype(np.float32))
    mass = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    vmask = torch.from_numpy(rng.random(n) > 0.15)
    return pos.to(dev), mass.to(dev), vmask.to(dev)


def _launched(name, fn):
    before = _build.launches[name]
    out = fn()
    assert _build.launches[name] == before + 1
    return out


@pytest.mark.parametrize("n", [1, 255, 1000, 2048])
def test_nbody_kernel_matches_plain(cuda, n):
    pos, mass, vmask = _vertices(n, n, cuda)
    out = _launched("nbody", lambda: nbody_repulsion(pos, mass, vmask,
                                                     C, L, MD))
    cl2, md2 = _build.force_consts(C, L, MD)
    _close(out, nbody_repulsion_ref(pos, mass, vmask, cl2, md2))


@pytest.mark.parametrize("n,K", [(1001, 40), (4096, 128)])
def test_neighbor_kernel_matches_plain(cuda, n, K):
    pos, mass, vmask = _vertices(n, K, cuda, scale=5.0)
    rng = np.random.default_rng(n)
    nbr = rng.integers(0, n + 1, size=(n, K))
    nmask = rng.random((n, K)) > 0.25
    nbr = torch.from_numpy(np.where(nmask, nbr, n).astype(np.int32)).to(cuda)
    nmask = torch.from_numpy(nmask).to(cuda)
    out = _launched("neighbor_force", lambda: neighbor_repulsion(
        pos, mass, nbr, nmask, vmask, C, L, MD))
    cl2, md2 = _build.force_consts(C, L, MD)
    _close(out, neighbor_repulsion_ref(pos, mass, nbr, nmask, vmask,
                                       cl2, md2))


@pytest.mark.parametrize("n,G,cap", [(3001, 9, 48), (3000, 2, 512)])
def test_grid_near_kernel_matches_plain(cuda, n, G, cap):
    pos, mass, vmask = _vertices(n, G, cuda)
    _, bucket, _ = grid_ops.bin_vertices(pos, vmask, G, cap)
    table = grid_ops.neighbor_table(G, cuda)
    out = _launched("grid_near", lambda: grid_ops.grid_near(
        pos, mass, vmask, bucket, table, C, L, MD))
    cl2, md2 = _build.force_consts(C, L, MD)
    _close(out, grid_near_ref(pos, mass, vmask, bucket, table, cl2, md2))


@pytest.mark.parametrize("n,nc", [(777, 100), (5000, 4096)])
def test_grid_far_kernel_matches_plain(cuda, n, nc):
    pos, _, _ = _vertices(n, nc, cuda)
    rng = np.random.default_rng(nc)
    cells = np.concatenate([rng.random((nc, 2)) * 10,
                            rng.random((nc, 1)) * 5], 1).astype(np.float32)
    cells = torch.from_numpy(cells).to(cuda)
    out = _launched("grid_far", lambda: grid_ops.grid_far(pos, cells,
                                                          C, L, MD))
    cl2, md2 = _build.force_consts(C, L, MD)
    _close(out, grid_far_ref(pos, cells, cl2, md2))


def test_grid_repulsion_on_card_matches_cpu(cuda):
    """The composed op on the card against the same op on the CPU. The cell
    aggregates are ``index_add_`` sums, taken with atomics in any order on
    the card, and the far corrections subtract the near cells' aggregates
    from the all-cells term, so the bound is 1e-4 · max|f| here."""
    pos, mass, vmask = _vertices(4000, 5, torch.device("cpu"))
    kw = dict(grid_dim=16, cell_cap=24)
    ref = grid_ops.grid_repulsion(pos, mass, vmask, C, L, MD, **kw)
    out = grid_ops.grid_repulsion(pos.to(cuda), mass.to(cuda),
                                  vmask.to(cuda), C, L, MD, **kw)
    _close(out.cpu(), ref, atol_frac=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    pos, mass, vmask = _vertices(300, 0, cuda)
    with pytest.raises(ValueError, match="dtype"):
        nbody_repulsion(pos.double(), mass, vmask, C, L, MD)
    with pytest.raises(ValueError, match="contiguous"):
        nbody_repulsion(pos.t().contiguous().t(), mass, vmask, C, L, MD)
    with pytest.raises(ValueError, match="on cpu"):
        nbody_repulsion(pos, mass.cpu(), vmask, C, L, MD)
    nbr = torch.zeros((300, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        neighbor_repulsion(pos, mass, nbr, nbr.bool(), vmask, C, L, MD)
