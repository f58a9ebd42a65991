"""The port's CUDA kernels on the card, each against its plain PyTorch version.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card (and
``nvcc`` to build the kernels at first use); without one each test skips
with its reason. The plain versions themselves are held to the JAX package
in ``test_torch_kernels.py``. On a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Sizes here are ragged on purpose (not multiples of the block widths), and
one grid case has a bucket cap of 512, so the near kernel's warps take
their cell's rows in several passes. Tolerance of the force kernels: rtol
1e-4 with atol 1e-5 · max|plain| — the kernels sum over sources in another
order than the plain versions' reductions (one test, on the composed grid
op, states its own bound). Tolerance of the bf16 attention kernel: rtol =
atol = 1e-2 — both versions round the output to bf16 (one ulp is 2^-8
relative), and the kernel rounds the unnormalised p to bf16 where the plain
version rounds the normalised p.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.grid_force import ops as grid_ops
from repro_torch.kernels.grid_force.ref import (grid_far_lanes_ref,
                                                grid_far_ref,
                                                grid_near_lanes_ref,
                                                grid_near_ref,
                                                near_field_ref)
from repro_torch.kernels.nbody.ops import nbody_repulsion
from repro_torch.kernels.nbody.ref import (nbody_repulsion_lanes_ref,
                                           nbody_repulsion_ref)
from repro_torch.kernels.neighbor_force.ops import neighbor_repulsion
from repro_torch.kernels.neighbor_force.ref import (
    neighbor_repulsion_lanes_ref, neighbor_repulsion_ref)

C, L, MD = 1.3, 0.8, 1e-2


def _consts(dev):
    """The force wrappers' constants: f32[2] = (C·L², md²) on ``dev``."""
    return _build.consts_tensor(C, L, MD, dev)


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


def _mask(n, kind, seed, dev):
    """vmask of n: "random" (~85% true), "prefix<k>" (the first k, as
    build_graph makes it), "scattered" (n // 3 true at random places) or
    "none"."""
    rng = np.random.default_rng(seed)
    m = np.zeros(n, bool)
    if kind == "random":
        m = rng.random(n) > 0.15
    elif kind.startswith("prefix"):
        m[:int(kind[6:])] = True
    elif kind == "scattered":
        m[rng.choice(n, n // 3, replace=False)] = True
    return torch.from_numpy(m).to(dev)


def _twice(name, fn):
    """The kernel's output, after checking that a second call on the same
    input gives the same bits."""
    out = _launched(name, fn)
    again = fn()
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    return out


@pytest.mark.parametrize("n,mask", [
    (1, "random"), (255, "random"), (1000, "random"), (2048, "random"),
    (256, "prefix9"),         # the coarsest exact level of delaunay(1M)
    (256, "prefix253"),
    (1024, "prefix632"),
    (1000, "scattered"),      # valid vertices not a prefix
    (300, "none"),            # no valid vertex: every force 0
])
def test_nbody_kernel_matches_plain(cuda, n, mask):
    pos, mass, _ = _vertices(n, n, cuda)
    vmask = _mask(n, mask, n, cuda)
    out = _twice("nbody", lambda: nbody_repulsion(pos, mass, vmask,
                                                  _consts(cuda)))
    cl2, md2 = _build.force_consts(C, L, MD)
    _close(out, nbody_repulsion_ref(pos, mass, vmask, cl2, md2))
    assert (out[~vmask] == 0).all()


def _lists(n, K, kind, seed, dev):
    """(nbr_idx, nbr_mask) of n rows of K slots, sentinel n: "random" masks
    ~75% of the slots anywhere, "prefix" fills each row from slot 0 to a
    random length (0 to K) as the k-hop lists do, "holes" masks a third of a
    prefix's slots in its middle, and "bad" adds masked-in slots that hold
    the sentinel, an index past it, −1, −n, −(n+1) or one below it (read as
    JAX's gather reads them: a negative index gets n+1 added, then the
    index is clamped to [0, n])."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, size=(n, K))
    if kind == "random":
        nmask = rng.random((n, K)) > 0.25
    else:
        length = rng.integers(0, K + 1, size=(n, 1))
        nmask = np.arange(K)[None, :] < length
        if kind == "holes":
            nmask &= ~((rng.random((n, K)) < 0.33)
                       & (np.arange(K)[None, :] < length - 1))
    nbr = np.where(nmask, nbr, n)
    if kind == "bad":
        bad = nmask & (rng.random((n, K)) < 0.1)
        odd = rng.choice([n, n + 3, 2 ** 31 - 1, -1, -2, -n, -(n + 1),
                          -(n + 2), -2 ** 31], (n, K))
        nbr = np.where(bad, odd, nbr)
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt)
                                          ).to(dev)
    return as_t(nbr, np.int32), as_t(nmask, bool)


@pytest.mark.parametrize("n,K,lists", [
    (1001, 40, "random"),     # K not a power of two
    (4096, 128, "random"),
    (777, 32, "prefix"),      # the schedule's caps 32 … 256
    (2000, 64, "prefix"),
    (11932, 128, "prefix"),   # the layout path's level-2 lists
    (2062, 192, "prefix"),    # and its level-3 lists
    (3000, 256, "prefix"),
    (4096, 192, "holes"),     # masked slots inside a row
    (1500, 128, "bad"),       # out-of-range and negative indices, masked
    (2062, 256, "bad"),       # in: the vector path, 1 and 2 groups a lane
    (500, 37, "bad"),         # K % 4 ≠ 0: the scalar path, with a tail
])
def test_neighbor_kernel_matches_plain(cuda, n, K, lists):
    pos, mass, vmask = _vertices(n, K, cuda, scale=5.0)
    vmask[0] = True           # row 0, which indices below −(n+1) read
    nbr, nmask = _lists(n, K, lists, n, cuda)
    out = _twice("neighbor_force", lambda: neighbor_repulsion(
        pos, mass, nbr, nmask, vmask, _consts(cuda)))
    cl2, md2 = _build.force_consts(C, L, MD)
    _close(out, neighbor_repulsion_ref(pos, mass, nbr, nmask, vmask,
                                       cl2, md2))
    assert (out[~vmask] == 0).all()
    # the lists hold neighbors outside vmask too
    ok = nmask & (nbr >= 0) & (nbr < n)
    assert (~vmask[nbr.clamp(0, n - 1).long()] & ok).any()
    if lists == "bad":
        assert (nmask & (nbr < -(n + 1))).any()
        assert (nmask & (nbr >= n)).any()


def _skewed(n, seed, dev):
    """Most vertices in six tight clumps (their cells over the cap), the
    rest spread thin over a wide box (many cells empty)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2)) * 100.0
    k = n * 4 // 5
    clumps = rng.random((6, 2)) * 100.0
    pos[:k] = clumps[rng.integers(0, 6, k)] + rng.normal(scale=0.3,
                                                         size=(k, 2))
    pos = torch.from_numpy(pos.astype(np.float32))
    mass = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    vmask = torch.from_numpy(rng.random(n) > 0.15)
    return pos.to(dev), mass.to(dev), vmask.to(dev)


@pytest.mark.parametrize("n,G,cap,drawing", [
    (3001, 9, 48, "uniform"),
    (3000, 2, 512, "uniform"),      # ~640 a cell, 512 kept: 4 passes a warp
    (131072, 105, 48, "uniform"),   # the path's second grid level: ~9.5 rows
    (50000, 64, 48, "skewed"),
])
def test_grid_near_kernel_matches_plain(cuda, n, G, cap, drawing):
    if drawing == "uniform":
        pos, mass, vmask = _vertices(n, G, cuda)
    else:
        pos, mass, vmask = _skewed(n, G, cuda)
    _, bucket, _ = grid_ops.bin_vertices(pos, vmask, G, cap)
    table = grid_ops.neighbor_table(G, cuda)
    if drawing == "skewed":
        rows = (bucket[:G * G] < n).sum(dim=1)
        assert int((rows == cap).sum()) >= 6 and int((rows == 0).sum()) > 0
    out = _twice("grid_near", lambda: grid_ops.grid_near(
        pos, mass, vmask, bucket, table, _consts(cuda)))
    cl2, md2 = _build.force_consts(C, L, MD)
    _close(out, grid_near_ref(pos, mass, vmask, bucket, table, cl2, md2))


@pytest.mark.parametrize("n,nc", [(777, 100), (5000, 4096)])
def test_grid_far_kernel_matches_plain(cuda, n, nc):
    pos, _, _ = _vertices(n, nc, cuda)
    rng = np.random.default_rng(nc)
    cells = np.concatenate([rng.random((nc, 2)) * 10,
                            rng.random((nc, 1)) * 5], 1).astype(np.float32)
    cells = torch.from_numpy(cells).to(cuda)
    out = _twice("grid_far", lambda: grid_ops.grid_far(pos, cells,
                                                       _consts(cuda)))
    cl2, md2 = _build.force_consts(C, L, MD)
    _close(out, grid_far_ref(pos, cells, cl2, md2))


@pytest.mark.parametrize("n,nc,extent", [
    (1025, 1, 10.0),          # one cell; n one past a block of 4·256 targets
    (3000, 300, 10.0),        # nc not a multiple of the 256-source tile
    (4099, 777, 1e4),         # d² from md² to ~1e8: the approximate
                              # reciprocal at every magnitude
])
def test_grid_far_kernel_ragged_and_wide(cuda, n, nc, extent):
    rng = np.random.default_rng(n + nc)
    pos = torch.from_numpy((rng.random((n, 2)) * extent).astype(np.float32))
    cells = np.concatenate([rng.random((nc, 2)) * extent,
                            rng.random((nc, 1)) * 5 + 0.1], 1)
    cells = torch.from_numpy(cells.astype(np.float32)).to(cuda)
    pos = pos.to(cuda)
    out = _launched("grid_far", lambda: grid_ops.grid_far(pos, cells,
                                                          _consts(cuda)))
    cl2, md2 = _build.force_consts(C, L, MD)
    _close(out, grid_far_ref(pos, cells, cl2, md2))


def test_grid_repulsion_on_card_matches_cpu(cuda):
    """The composed op on the card against the same op on the CPU. The cell
    aggregates are ``index_add_`` sums, taken with atomics in any order on
    the card, and the far corrections subtract the near cells' aggregates
    from the all-cells term, so the bound is 1e-4 · max|f| here."""
    pos, mass, vmask = _vertices(4000, 5, torch.device("cpu"))
    kw = dict(grid_dim=16, cell_cap=24)
    ref = grid_ops.grid_repulsion(pos, mass, vmask, _consts("cpu"), **kw)
    out = grid_ops.grid_repulsion(pos.to(cuda), mass.to(cuda),
                                  vmask.to(cuda), _consts(cuda), **kw)
    _close(out.cpu(), ref, atol_frac=1e-4)


def _near_rows(R, N, ncell, cap, seed, dev):
    """Rows, near9 (a fifth of them the empty last cell), a replicated
    (pos, w) table with a zero sentinel row, and the slot table in both
    forms: indices into it, and its (x, y, w) gathered."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    rows = (rng.random((R, 2)) * 10).astype(np.float32)
    near9 = rng.integers(0, ncell, (R, 9)).astype(np.int32)
    near9[rng.random((R, 9)) < 0.2] = ncell - 1
    pos = (rng.random((N + 1, 2)) * 10).astype(np.float32)
    w = (rng.random(N + 1) + 0.5).astype(np.float32)
    pos[N], w[N] = 0, 0
    slots = rng.integers(0, N + 1, (ncell, cap)).astype(np.int32)
    slots[ncell - 1] = N
    xyw = np.concatenate([pos[slots], w[slots][..., None]], -1)
    return (t(rows), t(near9), t(slots), t(pos), t(w),
            t(xyw.astype(np.float32)))


@pytest.mark.parametrize("R,N,ncell,cap", [
    (1, 10, 3, 1),
    (777, 3000, 200, 7),        # 9·cap = 63: not a multiple of 4 or 32
    (5003, 20000, 1025, 48),
    (4099, 9000, 300, 120),     # the 1M path's cap: 1080 slots a row
])
@pytest.mark.parametrize("form", ["index", "direct"])
def test_near_field_kernel_matches_plain(cuda, R, N, ncell, cap, form):
    """The near field a row at a time on the card against its plain
    version, both slot-table forms, at all columns and at a "model" rank's
    chunk (the last one running past 9·cap); two calls give the same
    bits."""
    rows, near9, slots, pos, w, xyw = _near_rows(R, N, ncell, cap, R, cuda)
    cl2, md2 = _build.force_consts(C, L, MD)
    K = 9 * cap
    for col0, ncols in ((0, K), (0, (K + 1) // 2), ((K + 1) // 2,
                                                   (K + 1) // 2)):
        if form == "index":
            cells, kw = slots, dict(pos=pos, w=w)
        else:
            cells, kw = xyw, {}
        out = _twice("near_field", lambda: grid_ops.near_field(
            rows, near9, cells, _consts(cuda), col0=col0, ncols=ncols,
            **kw))
        _close(out, near_field_ref(rows, near9, cells, cl2, md2, col0=col0,
                                   ncols=ncols, **kw))


def _path_near_rows(n, n_pad, seed, form, dev):
    """near_field's arguments as the sharded grid step builds them on a
    one-rank mesh (all columns), from n drawn positions (a tenth of them in
    one spot, so that cell holds more rows than ``cap`` and than a warp's
    chunk) and n_pad − n padding rows: the index form from ``bin_vertices``
    and ``neighbor_table`` over the replicated arrays, the direct form from
    ``_halo_binning``/``_halo_near``. Then one row in a hundred gets one of
    its 9 cells moved to another (never at the call sites)."""
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh as mesh_mod
    rng = np.random.default_rng(seed)
    pos = (rng.random((n_pad, 2)) * 10).astype(np.float32)
    pos[:n // 10] = 3.3 + rng.random((n // 10, 2)).astype(np.float32) * 1e-3
    w = np.where(np.arange(n_pad) < n, rng.random(n_pad) + 0.5,
                 0).astype(np.float32)
    pos, w = torch.from_numpy(pos).to(dev), torch.from_numpy(w).to(dev)
    G, cap = grid_ops.choose_grid(n)
    if form == "index":
        cid, bucket, _ = grid_ops.bin_vertices(pos, w > 0, G, cap)
        near9 = grid_ops.neighbor_table(G, dev)[cid.long()]
        zero = torch.zeros(1, device=dev)
        cells, kw = bucket, dict(pos=torch.cat([pos, zero.expand(1, 2)]),
                                 w=torch.cat([w, zero]))
    else:
        mesh = mesh_mod.make_host_mesh(device=dev)
        try:
            lo, hi = D._box(mesh, pos, w > 0)
            bins = D._halo_binning(mesh, pos, w, lo, hi, G, cap)
            near9, cells = D._halo_near(mesh, pos, w, *bins, G, cap)
        finally:
            mesh_mod.shutdown()
        kw = {}
    moved = torch.from_numpy(rng.random(n_pad) < 0.01).to(dev)
    t = torch.from_numpy(rng.integers(0, 9, n_pad)).to(dev)
    other = torch.from_numpy(rng.integers(0, cells.shape[0], n_pad)).to(dev)
    near9 = near9.clone()
    near9[moved, t[moved]] = other[moved].to(torch.int32)
    return pos, near9.contiguous(), cells, kw, cap


@pytest.mark.parametrize("n,n_pad", [(3000, 4096), (9000, 9216)])
@pytest.mark.parametrize("form", ["index", "direct"])
def test_near_field_kernel_on_path_inputs(cuda, n, n_pad, form):
    """The near field on inputs with the sharded path's structure: rows
    binned from drawn positions, a cell holding more rows than ``cap``,
    padding rows (more than a warp's chunk of them), a few rows with an
    altered near9; all columns and two "model" chunks. Against the plain
    version, bit for bit across two calls, and each row bit for bit when
    the rows are permuted."""
    rows, near9, cells, kw, cap = _path_near_rows(n, n_pad, n, form, cuda)
    cl2, md2 = _build.force_consts(C, L, MD)
    K = 9 * cap
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n_pad)).to(
        cuda)
    for col0, ncols in ((0, K), (0, (K + 1) // 2), ((K + 1) // 2,
                                                   (K + 1) // 2)):
        out = _twice("near_field", lambda: grid_ops.near_field(
            rows, near9, cells, _consts(cuda), col0=col0, ncols=ncols,
            **kw))
        _close(out, near_field_ref(rows, near9, cells, cl2, md2, col0=col0,
                                   ncols=ncols, **kw))
        shuffled = grid_ops.near_field(rows[perm], near9[perm], cells,
                                       _consts(cuda), col0=col0,
                                       ncols=ncols, **kw)
        torch.cuda.synchronize()
        assert torch.equal(shuffled, out[perm])


def test_near_field_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    rows, near9, slots, pos, w, xyw = _near_rows(300, 900, 40, 8, 0, cuda)
    with pytest.raises(ValueError, match="dtype"):
        grid_ops.near_field(rows, near9.long(), slots, _consts(cuda),
                            pos=pos, w=w)
    with pytest.raises(ValueError, match="shape"):
        grid_ops.near_field(rows, near9, xyw[..., :2].contiguous(),
                            _consts(cuda))
    odd = torch.zeros(601, device=cuda)[1:].view(300, 2)
    with pytest.raises(ValueError, match="aligned"):
        grid_ops.near_field(odd, near9, slots, _consts(cuda), pos=pos, w=w)


def test_sharded_grid_step_on_card_matches_cpu(cuda):
    """One grid-mode iteration of the sharded step on a one-rank mesh,
    NCCL on the card against gloo on the CPU (one group with both), from
    the same inputs: within 1e-4 · the largest move (the cell sums and the
    attraction are ``index_add_`` atomics on the card)."""
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh as mesh_mod
    rng = np.random.default_rng(4)
    n_pad, m_pad = 4096, 256
    pos = (rng.random((n_pad, 2)) * 40).astype(np.float32)
    w = (rng.random(n_pad) + 0.5).astype(np.float32)
    G_, cap = grid_ops.choose_grid(n_pad)
    src = rng.integers(0, n_pad, m_pad).astype(np.int32)
    dst = rng.integers(0, n_pad, m_pad).astype(np.int32)
    outs = {}
    try:
        for dev in (cuda, torch.device("cpu")):
            mesh = mesh_mod.make_host_mesh(device=dev)
            step = D.layout_train_step(mesh, n_pad, m_pad, 1, mode="grid",
                                       grid_dim=G_, cell_cap=cap)
            t = lambda a: torch.from_numpy(a).to(dev)
            before = _build.launches["near_field"]
            outs[dev.type] = step(
                t(pos), t(w), t(np.full((n_pad, 1), n_pad, np.int32)),
                t(src), t(dst), t(np.ones(m_pad, bool)),
                t(np.ones(m_pad, np.float32)),
                t(np.asarray([1.0, 1.0, 1e-3], np.float32)), 0.7).cpu()
            assert _build.launches["near_field"] == before + (
                dev.type == "cuda")
    finally:
        mesh_mod.shutdown()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0, atol=1e-4 * 0.7)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    pos, mass, vmask = _vertices(300, 0, cuda)
    with pytest.raises(ValueError, match="dtype"):
        nbody_repulsion(pos.double(), mass, vmask, _consts(cuda))
    with pytest.raises(ValueError, match="contiguous"):
        nbody_repulsion(pos.t().contiguous().t(), mass, vmask,
                        _consts(cuda))
    with pytest.raises(ValueError, match="on cpu"):
        nbody_repulsion(pos, mass.cpu(), vmask, _consts(cuda))
    with pytest.raises(ValueError, match="on cpu"):
        nbody_repulsion(pos, mass, vmask, _consts("cpu"))
    with pytest.raises(ValueError, match="shape"):
        grid_ops.grid_far(pos, torch.zeros((4, 3), device=cuda),
                          _consts(cuda)[:1])
    with pytest.raises(ValueError, match="aligned"):
        nbody_repulsion(torch.zeros(601, device=cuda)[1:].view(300, 2),
                        mass, vmask, _consts(cuda))
    nbr = torch.zeros((300, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        neighbor_repulsion(pos, mass, nbr, nbr.bool(), vmask,
                           _consts(cuda))
    # lists that are views 4 bytes (1 byte) past a 16-byte (4-byte)
    # boundary take the scalar path: the same bits as the vector path
    nbr, nmask = _lists(300, 64, "prefix", 1, cuda)
    flat = torch.zeros(300 * 64 + 1, dtype=torch.int32, device=cuda)
    flat[1:] = nbr.reshape(-1)
    flat_m = torch.zeros(300 * 64 + 1, dtype=torch.bool, device=cuda)
    flat_m[1:] = nmask.reshape(-1)
    odd_nbr, odd_mask = flat[1:].view(300, 64), flat_m[1:].view(300, 64)
    assert odd_nbr.data_ptr() % 16 and odd_mask.data_ptr() % 4
    want = neighbor_repulsion(pos, mass, nbr, nmask, vmask, _consts(cuda))
    for nb, nm in ((odd_nbr, nmask), (nbr, odd_mask), (odd_nbr, odd_mask)):
        got = _launched("neighbor_force", lambda: neighbor_repulsion(
            pos, mass, nb, nm, vmask, _consts(cuda)))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    odd = torch.zeros(601, device=cuda)[1:].view(300, 2)   # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        grid_ops.grid_far(odd, torch.zeros((4, 3), device=cuda),
                          _consts(cuda))
    with pytest.raises(ValueError, match="aligned"):
        neighbor_repulsion(odd, mass, nbr, nmask, vmask, _consts(cuda))


def _attn_inputs(B, Sq, Sk, H, KV, hd, seed, dev):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(dev, torch.bfloat16)
    return draw(B, Sq, H, hd), draw(B, Sk, KV, hd), draw(B, Sk, KV, hd)


def _close_bf16(out, ref):
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (2, 77, 77, 4, 2, 64, True),
    (1, 200, 333, 8, 2, 128, True),      # longer cache: bottom-right mask
    (2, 130, 70, 2, 1, 64, False),
    (1, 9, 4, 4, 4, 128, True),          # Sq > Sk: fully masked rows → 0
    (3, 1000, 1000, 16, 8, 128, True),
])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, hd, causal):
    q, k, v = _attn_inputs(B, Sq, Sk, H, KV, hd, Sq + Sk, cuda)
    out = _launched("flash_attention",
                    lambda: flash_attention(q, k, v, causal=causal))
    ref = flash_attention_ref(q, k, v, causal=causal)
    _close_bf16(out, ref)
    if Sq > Sk and causal:
        assert (out[:, :Sq - Sk] == 0).all()


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_kernel_decode_on_a_cache_slice(cuda, hd):
    """Sq = 1 against cache[:, :kv_len]: a strided view, read in place."""
    B, H, KV, cache_len, kv_len = 3, 8, 2, 300, 257
    q, ck, cv = _attn_inputs(B, 1, cache_len, H, KV, hd, hd, cuda)
    k, v = ck[:, :kv_len], cv[:, :kv_len]
    assert not k.is_contiguous()
    out = _launched("flash_attention",
                    lambda: flash_attention(q, k, v, causal=True))
    _close_bf16(out, flash_attention_ref(q, k.contiguous(), v.contiguous(),
                                         causal=True))


def _flash_case(cuda, B, Sq, Sk, H, KV, hd, causal, cache_len=None, seed=0):
    """The kernel against its plain version; with ``cache_len``, k/v are
    ``cache[:, :Sk]`` of a longer cache (a strided view, read in place)."""
    q, ck, cv = _attn_inputs(B, Sq, cache_len or Sk, H, KV, hd,
                             seed or Sq + Sk, cuda)
    k, v = ck[:, :Sk], cv[:, :Sk]
    out = _launched("flash_attention",
                    lambda: flash_attention(q, k, v, causal=causal))
    ref = flash_attention_ref(q, k.contiguous(), v.contiguous(),
                              causal=causal)
    _close_bf16(out, ref)
    return out


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("above", [False, True])
def test_flash_kernel_both_sides_of_the_route_threshold(cuda, G, above):
    """Sq·G = 64 takes the split-KV route, the next Sq the wgmma route."""
    Sq = flash_ops.SPLIT_ROWS // G + int(above)
    assert flash_ops.route(Sq, 2 * G, 2) == ("wgmma" if above
                                             else "split_kv")
    _flash_case(cuda, 2, Sq, 300, 2 * G, 2, 128, True)


@pytest.mark.parametrize("H,KV", [(16, 8), (36, 4), (48, 4)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_kernel_prefill_shape_on_a_cache_slice(cuda, hd, H, KV):
    """The LM path's prefill: Sq = Sk = 2048, the heads of internlm2-1.8b
    (16 over 8), starcoder2-7b (36 over 4) and -15b (48 over 4), k/v a
    slice cache[:, :2048] of a 2088-row cache."""
    out = _flash_case(cuda, 2, 2048, 2048, H, KV, hd, True, cache_len=2088)
    assert flash_ops.route(2048, H, KV) == "wgmma"
    assert torch.isfinite(out.float()).all()


def test_flash_kernel_chunked_prefill(cuda):
    """Sq 512 against Sk 2048: the chunk's rows sit at the end of the keys
    (bottom-right mask)."""
    _flash_case(cuda, 2, 512, 2048, 16, 8, 128, True, cache_len=2100)


@pytest.mark.parametrize("Sq,Sk,H,KV,hd", [
    (1, 40, 16, 8, 128),      # Sk shorter than one split chunk
    (1, 1, 16, 8, 64),        # one key
    (1, 1000, 16, 8, 128),    # Sk not a multiple of the chunk
    (3, 2049, 8, 2, 64),      # a ragged last chunk, several rows
    (200, 1, 8, 2, 128),      # wgmma: one key, every row but the last masked
    (100, 333, 4, 2, 64),     # wgmma: Sk not a multiple of the TMA tile
])
def test_flash_kernel_ragged_keys(cuda, Sq, Sk, H, KV, hd):
    _flash_case(cuda, 3, Sq, Sk, H, KV, hd, True, cache_len=Sk + 24)
    _flash_case(cuda, 2, Sq, Sk, H, KV, hd, False)


@pytest.mark.parametrize("Sq,Sk,G", [(9, 4, 4), (80, 30, 2), (300, 7, 1)])
def test_flash_kernel_fully_masked_rows_give_zero(cuda, Sq, Sk, G):
    """Sq > Sk, causal: the first Sq − Sk rows see no key (split-KV route
    for 36 packed rows, wgmma for 160 and 300)."""
    out = _flash_case(cuda, 2, Sq, Sk, 2 * G, 2, 128, True)
    assert (out[:, :Sq - Sk] == 0).all()


# starcoder2's GQA groups, 9 (36 heads over 4) and 12 (48 over 4), and
# multiples of them: a 16-row MMA tile holds rows of several positions, a
# 128-row wgmma tile starts mid-position, and the split route's tile has
# 16 − 9 or 16 − 12 dead rows at Sq 1
GQA_GROUPS = [(9, 1, 64), (18, 2, 128), (12, 1, 128), (36, 4, 128),
              (48, 4, 128), (24, 2, 64)]


@pytest.mark.parametrize("H,KV,hd", GQA_GROUPS)
@pytest.mark.parametrize("Sq,Sk", [(1, 130), (5, 300), (77, 77), (77, 200),
                                   (128, 128), (128, 1000), (301, 301)])
def test_flash_kernel_at_groups_9_and_12(cuda, H, KV, hd, Sq, Sk):
    """Both routes (Sq·G ≤ 64: split-KV; above: wgmma), causal on a longer
    cache's slice and not causal."""
    _flash_case(cuda, 3, Sq, Sk, H, KV, hd, True, cache_len=Sk + 24)
    _flash_case(cuda, 2, Sq, Sk, H, KV, hd, False)


# gemma-2b's MQA at hd 256 (8 heads over 1: group 8), granite-moe-3b-a800m's
# group 3 at hd 64 (24 heads over 8) and deepseek-moe-16b's MHA at hd 128
# (16 over 16: group 1), and smaller multiples of each. hd 256 takes 64-key
# wgmma tiles and one q buffer, and 64-key split chunks (ops.SPLIT_CHUNKS)
HD_256_AND_GROUPS = [(8, 1, 256), (16, 2, 256), (24, 8, 64), (6, 2, 64),
                     (16, 16, 128), (2, 2, 128)]


@pytest.mark.parametrize("H,KV,hd", HD_256_AND_GROUPS)
@pytest.mark.parametrize("Sq,Sk", [(1, 130), (5, 300), (8, 1000), (77, 77),
                                   (77, 200), (128, 1000), (301, 301)])
def test_flash_kernel_at_hd_256_and_groups_8_3_1(cuda, H, KV, hd, Sq, Sk):
    """Both routes (Sq·G ≤ 64: split-KV; above: wgmma), causal on a longer
    cache's slice and not causal, Sk not a multiple of the 64-key tile;
    a second call on the same inputs gives the same bits."""
    out = _flash_case(cuda, 3, Sq, Sk, H, KV, hd, True, cache_len=Sk + 24)
    q, ck, cv = _attn_inputs(3, Sq, Sk + 24, H, KV, hd, Sq + Sk, cuda)
    again = flash_attention(q, ck[:, :Sk], cv[:, :Sk], causal=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _flash_case(cuda, 2, Sq, Sk, H, KV, hd, False)


@pytest.mark.parametrize("H,KV,hd", [(8, 1, 256), (24, 8, 64),
                                     (16, 16, 128)])
def test_flash_kernel_prefill_shape_of_gemma_and_the_moe_models(cuda, H, KV,
                                                                  hd):
    """The LM path's prefill for gemma-2b, granite-moe-3b-a800m and
    deepseek-moe-16b: Sq = Sk = 2048, k/v a slice cache[:, :2048] of a
    2088-row cache."""
    out = _flash_case(cuda, 2, 2048, 2048, H, KV, hd, True, cache_len=2088)
    assert flash_ops.route(2048, H, KV) == "wgmma"
    assert torch.isfinite(out.float()).all()


def test_flash_kernel_decode_shape_spreads_over_the_card(cuda):
    """The LM path's decode (B 4, 8 KV heads, 2080 keys): at least 256
    blocks of the split-KV route."""
    splits, chunk = flash_ops.split_plan(4, 8, 2080, flash_ops._sm_count(
        cuda.index or 0), 128)
    assert 4 * 8 * splits >= 256 and splits * chunk >= 2080
    _flash_case(cuda, 4, 1, 2080, 16, 8, 128, True, cache_len=2088)


# the encoder-decoder's non-causal calls (seamless-m4t-medium: 16 heads over
# 16 at hd 64): the encoder's self-attention and the single-shot cross
# prefill (Sq = Sk = 1024), a chunk of the decoder against every frame (Sq
# 512, Sk 1024), cross decode (Sq 1: the split-KV route, no kv_len), and a
# ragged frame count on both routes. Each output row averages ≥ 1000
# values of v (|out| ~0.05), so atol is phase 6a's decode one
@pytest.mark.parametrize("B,Sq,Sk,route", [
    (4, 1024, 1024, "wgmma"),
    (4, 512, 1024, "wgmma"),
    (2, 300, 1000, "wgmma"),
    (2, 1, 1000, "split_kv"),
    (4, 1, 1024, "split_kv"),
])
def test_flash_kernel_not_causal_on_the_encoder_decoder_shapes(cuda, B, Sq,
                                                                Sk, route):
    """``causal=False`` against the plain version within rtol 1e-2, atol
    2e-3; a second call on the same inputs gives the same bits."""
    H = KV = 16
    assert flash_ops.route(Sq, H, KV) == route
    q, k, v = _attn_inputs(B, Sq, Sk, H, KV, 64, Sq + Sk, cuda)
    out = _launched("flash_attention",
                    lambda: flash_attention(q, k, v, causal=False))
    again = flash_attention(q, k, v, causal=False)
    ref = flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=2e-3)
    assert torch.equal(out, again)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _attn_inputs(1, 16, 16, 4, 2, 64, 0, cuda)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.float(), k.float(), v.float())
    q96, k96, v96 = _attn_inputs(1, 16, 16, 4, 2, 96, 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q96, k96, v96)
    with pytest.raises(ValueError, match="on cpu"):
        flash_attention(q, k.cpu(), v)


# -- constants and kv_len from device memory; captured steps ------------------

def test_force_kernels_device_constants_equal_host_constants(cuda):
    """Each force kernel reading its constants from a row of a schedule
    buffer on the device, as the refine step hands them (a view 4 bytes
    into the row a device counter selects, the buffer's other row holding
    other values), gives the bits of the same kernel with the host-rounded
    constants ``_build.consts_tensor`` stages."""
    from repro_torch.core import gila
    pos, mass, vmask = _vertices(3000, 11, cuda)
    rows = torch.from_numpy(gila.schedule_rows([0.5, 0.25], [3 * C, C], L,
                                               MD)).to(cuda)
    row = rows.index_select(0, torch.ones(1, dtype=torch.long,
                                          device=cuda))[0]
    nbr, nmask = _lists(3000, 128, "prefix", 11, cuda)
    _, bucket, _ = grid_ops.bin_vertices(pos, vmask, 16, 40)
    table = grid_ops.neighbor_table(16, cuda)
    cells = torch.cat([pos[:200], mass[:200, None]], dim=1).contiguous()
    cases = [
        ("nbody", lambda k: nbody_repulsion(pos, mass, vmask, k)),
        ("neighbor_force", lambda k: neighbor_repulsion(
            pos, mass, nbr, nmask, vmask, k)),
        ("grid_near", lambda k: grid_ops.grid_near(
            pos, mass, vmask, bucket, table, k)),
        ("grid_far", lambda k: grid_ops.grid_far(pos, cells, k)),
    ]
    for name, f in cases:
        host = _launched(name, lambda: f(_consts(cuda)))
        dev = _launched(name, lambda: f(row[1:]))
        torch.cuda.synchronize()
        assert torch.equal(host, dev), name


@pytest.mark.parametrize("H,KV,hd", [(16, 8, 128), (36, 4, 128),
                                     (48, 4, 128), (8, 1, 256), (24, 8, 64),
                                     (16, 16, 128)])
@pytest.mark.parametrize("kv_len", [1, 17, 2049, 2080])
def test_flash_split_kv_reads_kv_len_from_the_device(cuda, kv_len, H, KV,
                                                     hd):
    """The split-KV route over a 2088-row cache with ``kv_len`` an int32 on
    the device (the splits planned from the capacity) against the plain
    version, at the decode heads of internlm2-1.8b (16 over 8: 2 packed
    rows), starcoder2-7b (36 over 4: 9) and -15b (48 over 4: 12), gemma-2b
    (8 over 1 at hd 256: 8), granite-moe-3b-a800m (24 over 8 at hd 64: 3)
    and deepseek-moe-16b (16 over 16: 1), within
    phase 6a's tolerance for the output's size: rtol 1e-2 and atol 2e-3
    where a row averages 2049 or 2080 values (|out| ~0.04), atol 1e-2
    where it averages 1 or 17 (|out| up to ~1, a bf16 ulp ~0.004)."""
    tol = dict(rtol=1e-2, atol=2e-3 if kv_len > 1024 else 1e-2)
    q, ck, cv = _attn_inputs(4, 1, 2088, H, KV, hd, kv_len, cuda)
    n = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    out = _launched("flash_attention", lambda: flash_attention(
        q, ck, cv, causal=True, kv_len=n))
    ref = flash_attention_ref(q, ck[:, :kv_len].contiguous(),
                              cv[:, :kv_len].contiguous(), causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(
        flash_attention_ref(q, ck, cv, causal=True, kv_len=n).float(),
        ref.float(), **tol)
    with pytest.raises(ValueError, match="split-KV route only"):
        flash_attention(q.expand(4, 128, H, hd).contiguous(), ck, cv,
                        kv_len=n)


DECODE_HEADS = [(16, 8, 128), (36, 4, 128), (48, 4, 128), (8, 1, 256),
                (24, 8, 64), (16, 16, 128), (32, 8, 128), (16, 16, 64),
                (64, 8, 128)]


@pytest.mark.parametrize("H,KV,hd", DECODE_HEADS)
@pytest.mark.parametrize("kv_len", [0, 1, 37, 2049])
def test_flash_split_kv_lse_matches_plain(cuda, kv_len, H, KV, hd):
    """``return_lse=True`` on the split-KV route at the decode heads of
    every registered config with attention (jamba 32 over 8, seamless 16
    over 16 at hd 64 and internvl2 64 over 8 beside the above), over a
    2088-row cache with a device ``kv_len``: out as above, and lse within
    2e-4 of the plain version's (float32 sums of the same 2^x terms; one
    key more or less moves an lse of ~2000 keys by ~5e-4); at kv_len 0
    out 0 and lse −inf, with no NaN."""
    tol = dict(rtol=1e-2, atol=2e-3 if kv_len > 1024 else 1e-2)
    q, ck, cv = _attn_inputs(4, 1, 2088, H, KV, hd, max(kv_len, 1), cuda)
    n = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    out, lse = _launched("flash_attention", lambda: flash_attention(
        q, ck, cv, kv_len=n, return_lse=True))
    ref, ref_lse = flash_attention_ref(q, ck, cv, kv_len=n, return_lse=True)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (4, 1, H)
    if kv_len == 0:
        assert (out == 0).all() and torch.isneginf(lse).all()
        return
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=2e-4)
    # the same bits of out as the call without lse
    assert torch.equal(out, flash_attention(q, ck, cv, kv_len=n))


@pytest.mark.parametrize("H,KV,hd", DECODE_HEADS)
@pytest.mark.parametrize("P", [2, 4, 8])
def test_flash_split_blocks_merge_to_the_uncut_kernel(cuda, P, H, KV, hd):
    """A 2048-row cache with 1229 rows filled, cut into P sequence blocks
    (the last ones past the filled rows: local kv_len 0), each through the
    kernel with its lse, merged by ``comm.merge_partials_local``: the
    uncut kernel's out within rtol 1e-2, atol 2e-3 (bf16 outputs of ~0.04
    merged in float32)."""
    from repro_torch.parallel.comm import merge_partials_local
    C, kv = 2048, 1229
    q, ck, cv = _attn_inputs(4, 1, C, H, KV, hd, kv, cuda)
    n = torch.tensor(kv, dtype=torch.int32, device=cuda)
    want = flash_attention(q, ck, cv, kv_len=n)
    blk, outs, lses = C // P, [], []
    for r in range(P):
        local = (n - r * blk).clamp(0, blk).to(torch.int32)
        o, l = flash_attention(q, ck[:, r * blk:(r + 1) * blk],
                               cv[:, r * blk:(r + 1) * blk], kv_len=local,
                               return_lse=True)
        outs.append(o)
        lses.append(l)
    got = merge_partials_local(torch.stack(outs), torch.stack(lses))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=2e-3)


def test_flash_lse_is_refused_on_the_wgmma_route(cuda):
    """The wgmma route writes no lse: ``return_lse`` at a prefill shape
    raises rather than computing it another way."""
    q, ck, cv = _attn_inputs(2, 128, 256, 16, 8, 128, 256, cuda)
    with pytest.raises(ValueError, match="return_lse"):
        flash_attention(q, ck, cv, return_lse=True)


@pytest.mark.parametrize("engine_name", ["gila", "stress"])
@pytest.mark.parametrize("mode", ["exact", "neighbor", "grid"])
def test_captured_refine_step_matches_eager(cuda, engine_name, mode):
    """k = 10 iterations replayed from a captured step against the eager
    loop: the median of the replay's distances from 6 eager runs within
    twice the median distance between two of them, the eager-vs-eager
    spread over the same k iterations (``index_add_`` sums with atomics on
    the card, so eager does not repeat its own bits). A distance is the
    mean over the valid vertices of max(|Δx|, |Δy|): the largest |Δpos| of
    two runs is set by a few vertices whose grid cell flips and varies ~5×
    from pair to pair (``chip_smoke.EAGER_RUNS``). Where eager runs mostly
    repeat each other's bits (a median spread of 0), the replay must repeat
    one of them. The launches of the replays equal the eager loop's."""
    import dataclasses
    from repro_torch.core import bucketing, schedule
    from repro_torch.core.engine import get_engine
    from repro_torch.graphs import generators as G
    from repro_torch.graphs.graph import build_graph

    edges, n = G.delaunay(5000, seed=2)
    g = build_graph(edges, n, bucket=True, device=cuda)
    kw = dict(exact=dict(exact_threshold=10 ** 6),
              neighbor=dict(exact_threshold=64, grid_threshold=10 ** 6),
              grid=dict(exact_threshold=64, grid_threshold=512))[mode]
    sched = schedule.make_schedule(0, 3, g.n, g.m, n_pad=g.n_pad,
                                   engine=engine_name, **kw)
    sched = dataclasses.replace(sched, iters=10, temp0=0.5)
    assert sched.mode == mode
    eng = get_engine(engine_name)
    rng = np.random.default_rng(3)
    pos0 = torch.from_numpy((rng.random((g.n_pad, 2)) * 70).astype(
        np.float32)).to(cuda)
    nbr_idx, nbr_mask = eng.init_state(g, sched, 4)
    _build.launches.clear()
    eager = [eng.refine(g, pos0, nbr_idx, nbr_mask, sched, ideal_len=1.0,
                        rep_const=1.0) for _ in range(6)]
    torch.cuda.synchronize()
    eager_launches = {k: v // 6 for k, v in _build.launches.items()}
    dist = lambda a, b: float((a - b).abs().amax(dim=1)[g.vmask].mean())
    spread = np.median([dist(a, b) for i, a in enumerate(eager)
                        for b in eager[i + 1:]])
    bucketing.STEP_CACHE.clear()
    _, prog, fresh, args = bucketing.cached_refine(
        g, pos0, sched, nbr_idx, nbr_mask, ideal_len=1.0, rep_const=1.0)
    assert fresh
    prog.run(*args)                              # warm-up and capture
    _build.launches.clear()
    out = prog.run(*args)                        # replays only
    torch.cuda.synchronize()
    assert dict(_build.launches) == eager_launches
    replay = [dist(out, e) for e in eager]
    assert np.median(replay) <= 2 * spread or min(replay) == 0.0, (replay,
                                                                    spread)


def test_captured_decode_gives_the_eager_greedy_tokens(cuda):
    """32 greedy steps of a 2-layer model with hd 64 in bf16: the captured
    ``DecodeGraph`` picks the eager ``decode_step``'s tokens."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"),
                              head_dim=64, n_layers=2)
    model = M.init_params(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40))).to(cuda)
    logits, state, pos = M.prefill(model, {"tokens": tokens}, 80)
    first = logits[:, -1].argmax(-1, keepdim=True)
    dec = M.compile_decode(model, 2, 80)
    dec.start(state, first, pos)
    tok, eager = first, []
    for i in range(32):
        lg, state = M.decode_step(model, tok, state, pos + i)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        eager.append(tok)
    graph = []
    _build.launches.clear()
    for _ in range(32):
        dec.step()
        graph.append(dec.token.clone())
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(graph, 1), torch.cat(eager, 1))
    assert _build.launches["flash_attention"] == 2 * 32
    assert int(dec.pos) == pos + 32


@pytest.mark.parametrize("arch,hd", [("gemma-2b", 256),
                                     ("granite-moe-3b-a800m", 64),
                                     ("deepseek-moe-16b", 128)])
def test_captured_decode_of_gemma_and_the_moe_models(cuda, arch, hd):
    """The smoke configs of gemma-2b (MQA, GeGLU, tied head) and the two
    MoE models (deepseek's dense layer 0 and shared experts), their head
    dim raised to one the kernel takes, in bf16: 32 replayed steps of the
    captured ``DecodeGraph`` pick the eager ``decode_step``'s tokens, the
    MoE layers' routing (top-k, dispatch scatter, expert products) captured
    with the rest of the step."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_smoke_config(arch), head_dim=hd)
    model = M.init_params(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (3, 40))).to(cuda)
    logits, state, pos = M.prefill(model, {"tokens": tokens}, 80)
    first = logits[:, -1].argmax(-1, keepdim=True)
    dec = M.compile_decode(model, 3, 80)
    dec.start(state, first, pos)
    tok, eager = first, []
    for i in range(32):
        lg, state = M.decode_step(model, tok, state, pos + i)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        eager.append(tok)
    graph = []
    _build.launches.clear()
    for _ in range(32):
        dec.step()
        graph.append(dec.token.clone())
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(graph, 1), torch.cat(eager, 1))
    assert _build.launches["flash_attention"] == cfg.n_layers * 32


@pytest.mark.parametrize("arch,hd", [("mamba2-1.3b", 0),
                                     ("jamba-v0.1-52b", 64)])
def test_captured_decode_of_the_ssm_models(cuda, arch, hd):
    """The smoke configs of mamba2-1.3b (SSD layers only) and the hybrid
    jamba-v0.1-52b (its attention layers' head dim raised to one the flash
    kernel takes), bf16: 32 replayed steps of the captured ``DecodeGraph``
    pick the eager ``decode_step``'s tokens, and after k = 8 replays every
    layer's state — an SSD layer's conv window and h, written in place by
    ``copy_`` inside the graph — equals k eager steps' from the same
    prefill within the LM tests' bf16 tolerance (rtol 0.02, atol 0.1)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    cfg = get_smoke_config(arch)
    if hd:
        cfg = dataclasses.replace(cfg, head_dim=hd)
    model = M.init_params(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 40))).to(cuda)
    logits, state, pos = M.prefill(model, {"tokens": tokens}, 80)
    first = logits[:, -1].argmax(-1, keepdim=True)
    dec = M.compile_decode(model, 3, 80)
    dec.start(state, first, pos)
    eager_state = [tuple(t.clone() for t in pair) for pair in state]
    tok, eager, k = first, [], 8
    for i in range(32):
        lg, eager_state = M.decode_step(model, tok, eager_state, pos + i)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        eager.append(tok)
        if i == k - 1:
            after_k = [tuple(t.clone() for t in pair) for pair in eager_state]
    graph = []
    _build.launches.clear()
    for i in range(32):
        dec.step()
        graph.append(dec.token.clone())
        if i == k - 1:
            torch.cuda.synchronize()
            for got, want in zip(dec.state, after_k, strict=True):
                for a, b in zip(got, want, strict=True):
                    torch.testing.assert_close(a.float(), b.float(),
                                               rtol=0.02, atol=0.1)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(graph, 1), torch.cat(eager, 1))
    n_attn = sum(layer.kind == "attn" for layer in model.layers)
    assert _build.launches["flash_attention"] == n_attn * 32
    assert any(layer.kind == "ssm" for layer in model.layers)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-76b"])
def test_captured_decode_of_the_encoder_decoder_and_the_vlm(cuda, arch):
    """The smoke configs of seamless-m4t-medium (2 encoder and 2 decoder
    layers, cross-attention over 48 frames) and internvl2-76b (16 patches
    in front of the prompt), head dim raised to 64, bf16: 32 replayed steps
    of the captured ``DecodeGraph`` pick the eager ``decode_step``'s
    tokens, one flash launch a layer a step and one more for each
    cross-attention. The encoder-decoder's graph then starts again on
    another prompt's frames: its static ``enc_out``, copied in by
    ``start``, is what the replayed cross-attention reads."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_smoke_config(arch), head_dim=64)
    model = M.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(4)

    def prompt():
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (3, 40))).to(cuda)}
        key, n = ("frames", 48) if cfg.enc_layers else ("patches", 16)
        batch[key] = torch.from_numpy(rng.normal(
            size=(3, n, cfg.d_model)) * 0.05).to(cuda, torch.bfloat16)
        logits, state, pos = M.prefill(model, batch, 80)
        enc_out = M._encode(model, batch["frames"]) if cfg.enc_layers else None
        return logits[:, -1].argmax(-1, keepdim=True), state, pos, enc_out

    dec = M.compile_decode(model, 3, 80, 48 if cfg.enc_layers else 0)
    per_step = cfg.n_layers * (2 if cfg.enc_layers else 1)
    for steps in (32, 8) if cfg.enc_layers else (32,):
        first, state, pos, enc_out = prompt()
        dec.start(state, first, pos, enc_out=enc_out)
        tok, eager = first, []
        for i in range(steps):
            lg, state = M.decode_step(model, tok, state, pos + i,
                                      enc_out=enc_out)
            tok = lg[:, -1].argmax(-1, keepdim=True)
            eager.append(tok)
        graph = []
        _build.launches.clear()
        for _ in range(steps):
            dec.step()
            graph.append(dec.token.clone())
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(graph, 1), torch.cat(eager, 1))
        assert _build.launches["flash_attention"] == per_step * steps


# -- the lane axis: the batched driver's [B, n_pad] groups ------------------------

def _lane_case(name, B, n, dev):
    """(wrapper, lane args, one-lane args of lane b, plain version) of one
    force kernel on B lanes of n rows, each lane its own drawing and
    constants (C grows with the lane)."""
    rng = np.random.default_rng(B * n)
    lanes = [_vertices(n, 7 * b + n, dev) for b in range(B)]
    pos, mass, vmask = (torch.stack(t) for t in zip(*lanes))
    consts = torch.stack([_build.consts_tensor(C * (1 + 0.25 * b), L, MD, dev)
                          for b in range(B)])
    if name == "nbody":
        args = (pos, mass, vmask)
        f, plain = nbody_repulsion, nbody_repulsion_lanes_ref
    elif name == "neighbor_force":
        K = 32 if n <= 64 else 40
        lists = [_lists(n, K, "prefix" if b % 2 else "random", b, dev)
                 for b in range(B)]
        nbr, nmask = (torch.stack(t) for t in zip(*lists))
        args = (pos, mass, nbr, nmask, vmask)
        f, plain = neighbor_repulsion, neighbor_repulsion_lanes_ref
    elif name == "grid_near":
        G, cap = (4, 16) if n <= 64 else (9, 48)
        _, bucket, _ = grid_ops.bin_vertices(pos, vmask, G, cap)
        table = grid_ops.neighbor_table(G, dev)
        f = lambda p, m, v, bk, k: grid_ops.grid_near(p, m, v, bk, table, k)
        plain = lambda p, m, v, bk, k: grid_near_lanes_ref(p, m, v, bk, table,
                                                           k)
        args = (pos, mass, vmask, bucket)
    else:
        nc = 37 if n <= 64 else 4096
        cells = np.concatenate([rng.random((B, nc, 2)) * 10,
                                rng.random((B, nc, 1)) * 5], 2)
        args = (pos, torch.from_numpy(cells.astype(np.float32)).to(dev))
        f, plain = grid_ops.grid_far, grid_far_lanes_ref
    return f, args, consts, plain


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("name,n", [
    ("nbody", 64), ("nbody", 1000),           # 64: one cluster a lane
    ("neighbor_force", 64), ("neighbor_force", 777),
    ("grid_near", 64), ("grid_near", 3001),
    ("grid_far", 64), ("grid_far", 5000)])
def test_lane_kernel_matches_single_calls_and_plain(cuda, name, n, B):
    """One launch over B lanes: each lane the bits of the same kernel
    launched on that lane alone, and within the force tolerance of the
    plain version over lanes; at B = 1 the single-graph call's bits."""
    f, args, consts, plain = _lane_case(name, B, n, cuda)
    out = _twice(name, lambda: f(*args, consts))
    assert out.shape == (B, n, 2)
    for b in range(B):
        alone = f(*(a[b] for a in args), consts[b])
        torch.cuda.synchronize()
        assert torch.equal(out[b], alone), b
    _close(out, plain(*args, consts))


def test_batched_driver_on_card(cuda):
    """``multigila_layout_many`` on the card in all three modes: every
    graph's hierarchy, modes and levels those of its sequential layout,
    positions finite, NELD within 0.05 of the sequential layout's; each
    exact and neighbor group with incidence tables (no atomics) repeats its
    own bits when run again on its recorded requests."""
    from repro_torch.core import (LayoutConfig, bucketing,
                                  multigila_layout, multigila_layout_many)
    from repro_torch.graphs import generators as G
    from repro_torch.graphs.metrics import neld

    graphs = [G.delaunay(3000, seed=60 + i) for i in range(3)]
    cfg = LayoutConfig(exact_threshold=64, grid_threshold=512)
    groups, real = [], bucketing.refine_level_many

    def record(reqs, **kw):
        out = real(reqs, **kw)
        groups.append((reqs, kw, [o.clone() for o in out]))
        return out

    bucketing.refine_level_many = record
    try:
        outs = multigila_layout_many(graphs, cfg)
    finally:
        bucketing.refine_level_many = real
    for (e, n), (pb, sb) in zip(graphs, outs):
        ps, ss = multigila_layout(e, n, cfg)
        assert (sb.level_sizes, sb.level_modes) == (ss.level_sizes,
                                                    ss.level_modes)
        assert np.isfinite(pb).all() and pb.shape == (n, 2)
        assert abs(neld(pb, e) - neld(ps, e)) <= 0.05
    assert {g[0][0].sched.mode for g in groups} == {"exact", "neighbor",
                                                   "grid"}
    for reqs, kw, out in groups:
        if reqs[0].sched.mode == "grid" or reqs[0].inc_k == 0:
            continue                 # cell sums by index_add_: atomics
        again = real(reqs, **kw)
        assert all(torch.equal(a, b) for a, b in zip(out, again))


# -- the serving layer on the card ----------------------------------------------

def _served_pyramid(cuda):
    """A pyramid binned on the card from a CPU layout's export, which must
    equal the one binned on the CPU, array for array."""
    from repro_torch.core import LayoutConfig, multigila_layout
    from repro_torch.graphs import generators as G
    from repro_torch.serve import build_pyramid

    e, n = G.delaunay(3000, seed=5)
    _, _, exp = multigila_layout(e, n, LayoutConfig(), export=True,
                                 device="cpu")
    pyr = build_pyramid(exp, tile_cap=32, edge_cap=48, max_zoom=6,
                        device=cuda)
    ref = build_pyramid(exp, tile_cap=32, edge_cap=48, max_zoom=6,
                        device="cpu")
    for a, b in zip(pyr.bands, ref.bands):
        for f in ("tile_vid", "tile_rep", "tile_pos", "tile_mass",
                  "tile_count", "tile_total", "tile_eid", "tile_epos",
                  "tile_ecount"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    return pyr


def _assert_queries_exact(pyr, out, boxes, zs):
    from repro_torch.serve import reference_resolve, trim_result
    for i in range(len(boxes)):
        got = trim_result(out, i)
        want = reference_resolve(pyr, boxes[i], int(zs[i]))
        assert (got["band"], got["covered"]) == (want["band"],
                                                 want["covered"])
        for k in ("vid", "rep", "inside", "eid", "tiles", "vpos", "epos",
                  "vmass"):
            assert got[k].shape == want[k].shape, (i, k)
            assert got[k].tobytes() == want[k].tobytes(), (i, k)


@pytest.mark.parametrize("B", [1, 5, 64])
def test_query_batch_on_card_equals_reference(cuda, B):
    """Tile ids divide in float32 on the card as numpy does: every result
    of a batch is the numpy oracle's, bit for bit."""
    from repro_torch.serve import QueryEngine
    from repro_torch.serve.query import random_viewports

    pyr = _served_pyramid(cuda)
    eng = QueryEngine(pyr)
    assert eng.bands[0]["tile_vid"].device.type == "cuda"
    zoom_max = max(b.zoom for b in pyr.bands)
    boxes, zs = random_viewports(pyr.lo, pyr.hi, zoom_max + 2, B, seed=B)
    _assert_queries_exact(pyr, eng.query(boxes, zs), boxes, zs)


def test_layout_and_queries_from_two_threads(cuda):
    """A cold batched layout (its step programs warm up and are captured)
    on one thread while another thread runs query batches and force
    kernels on the card: both results right, and the launch counts those
    of the layout alone plus the other thread's launches."""
    import threading

    from repro_torch.core import (LayoutConfig, bucketing,
                                  multigila_layout_many)
    from repro_torch.graphs import generators as G
    from repro_torch.graphs.metrics import neld
    from repro_torch.serve import QueryEngine
    from repro_torch.serve.query import random_viewports

    pyr = _served_pyramid(cuda)
    eng = QueryEngine(pyr)
    zoom_max = max(b.zoom for b in pyr.bands)
    boxes, zs = random_viewports(pyr.lo, pyr.hi, zoom_max, 64, seed=3)
    graphs = [G.delaunay(3000, seed=70 + i) for i in range(3)]
    cfg = LayoutConfig(exact_threshold=64, grid_threshold=512)

    bucketing.STEP_CACHE.clear()
    _build.launches.clear()
    alone = multigila_layout_many(graphs, cfg)
    torch.cuda.synchronize()
    want = dict(_build.launches)

    pos = torch.rand(1, 1024, 2, device=cuda) * 30
    mass = torch.ones(1, 1024, device=cuda)
    vmask = torch.ones(1, 1024, dtype=torch.bool, device=cuda)
    consts = _consts(cuda).reshape(1, 2)
    bucketing.STEP_CACHE.clear()
    _build.launches.clear()
    stop, errors, calls, outs = threading.Event(), [], [0], []

    def other():
        try:
            while not stop.is_set():
                _assert_queries_exact(pyr, eng.query(boxes, zs), boxes, zs)
                nbody_repulsion(pos, mass, vmask, consts)
                calls[0] += 1
        except Exception as e:             # reported on the main thread
            errors.append(e)

    t = threading.Thread(target=other)
    t.start()
    try:
        outs = multigila_layout_many(graphs, cfg)
        torch.cuda.synchronize()
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert calls[0] > 0
    got = dict(_build.launches)
    assert got.pop("nbody") - want["nbody"] == calls[0]
    assert got == {k: v for k, v in want.items() if k != "nbody"}
    for (e, n), (pa, sa), (pb, sb) in zip(graphs, alone, outs):
        assert (sa.level_sizes, sa.level_modes) == (sb.level_sizes,
                                                    sb.level_modes)
        assert np.isfinite(pb).all()
        assert abs(neld(pa, e) - neld(pb, e)) <= 0.05


# -- training ---------------------------------------------------------------------

def test_flash_kernel_refuses_inputs_that_need_a_gradient(cuda):
    """The kernel has no backward: on inputs that require grad it raises
    instead of returning an output without a ``grad_fn``; under no_grad,
    or on inputs that need none, it runs."""
    q = torch.randn(1, 128, 2, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(1, 128, 2, 64, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    for t in (q, k, v):
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(q, k, v, causal=True)
        with torch.no_grad():
            flash_attention(q, k, v, causal=True)
        t.requires_grad_(False)
    assert flash_attention(q, k, v, causal=True).grad_fn is None


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "seamless-m4t-medium"])
def test_train_route_gradients_match_the_cpu(cuda, arch):
    """``loss_fn`` on the card (attention through SDPA) against the CPU
    (the plain attention) from the same bf16 weights of the smoke config
    and the training driver's batch: the loss within rtol 0.02 / atol 0.1 and every
    gradient leaf within rtol 0.02, atol 0.1 × the leaf's largest |CPU
    value|, none of them zero where the CPU's is not."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.train import DataConfig, batch_at, extra_inputs

    cfg = get_smoke_config(arch)
    cpu = M.init_params(cfg, seed=3, device="cpu")
    card = M.LM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=64,
                                global_batch=2), 1)
    batch.update(extra_inputs(cfg, 2, 64))
    out = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        loss, _ = M.loss_fn(model, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(params.values()))
        out.append((float(loss.detach()), dict(zip(params, grads))))
    (l_cpu, g_cpu), (l_card, g_card) = out
    assert abs(l_card - l_cpu) <= 0.1 + 0.02 * abs(l_cpu)
    for name, b in g_cpu.items():
        a, b = g_card[name].float().cpu(), b.float()
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0.02, atol=0.1 * scale,
                                   msg=name)
        assert scale == 0 or float(a.abs().max()) > 0, name


def test_a_model_in_training_serves_through_the_kernel(cuda):
    """After a training step (gradients on), prefill and decode run under
    no_grad through the flash kernel (launches counted), with no autograd
    graph on their logits."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.train import (DataConfig, TrainConfig, batch_at,
                                   init_train_state, make_train_step)

    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"),
                              d_model=256)            # hd 64
    model = M.init_params(cfg, seed=0, device=cuda)
    tcfg = TrainConfig()
    opt, err = init_train_state(model, tcfg)
    batch = {k: v.to(cuda) for k, v in batch_at(
        DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2), 0).items()}
    make_train_step(tcfg)(model, opt, err, batch)
    assert all(p.requires_grad for p in model.parameters())
    _build.launches.clear()
    logits, state, pos = M.prefill(model, {"tokens": batch["tokens"]}, 72)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    step_logits, _ = M.decode_step(model, tok, state, pos)
    assert _build.launches["flash_attention"] == 2 * cfg.n_layers
    for t in (logits, step_logits):
        assert t.grad_fn is None and torch.isfinite(t.float()).all()


# -- the sharded trainer and parallel/ on a one-rank NCCL mesh ----------------

@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL (data, model) mesh (``launch.mesh.make_mesh``),
    taken down after the test."""
    from repro_torch.launch import mesh as mesh_mod
    yield mesh_mod.make_mesh((1, 1), device=cuda)
    mesh_mod.shutdown()


def test_sharded_step_on_one_rank_equals_the_unsharded(cuda, nccl_mesh):
    """internlm2's smoke config, float32, 3 training steps: under
    ``make_rules`` on the one-rank mesh (vocab-parallel loss, the
    collectives on one rank) the losses and the weights after the steps
    equal the unsharded step's within 1e-5 (the loss's logsumexp is taken
    in another order)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import (make_rules, shard_model,
                                               use_shardings)
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   batch_at, init_train_state,
                                   make_train_step)
    cfg = get_smoke_config("internlm2-1.8b")
    tcfg = TrainConfig(optim=AdamWConfig(warmup_steps=2, total_steps=6))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    runs = []
    for rules in (None, make_rules(nccl_mesh, cfg)):
        with use_shardings(nccl_mesh, rules):
            model = init_params(cfg, seed=0, device=cuda, dtype=torch.float32)
            if rules is not None:
                shard_model(model, rules)
            opt, err = init_train_state(model, tcfg)
            step = make_train_step(tcfg)
            losses = []
            for i in range(3):
                batch = {k: v.to(cuda) for k, v in batch_at(dcfg, i).items()}
                model, opt, err, m = step(model, opt, err, batch)
                losses.append(float(m["loss"]))
            runs.append((losses, dict(model.named_parameters())))
    (l0, p0), (l1, p1) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for name, p in p0.items():
        p = p.detach()
        torch.testing.assert_close(p1[name].detach(), p, rtol=1e-5,
                                   atol=1e-5 * float(p.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_forms_on_one_rank_equal_apply_moe(cuda, nccl_mesh, dtype):
    """``apply_moe_shardmap`` (EP over one rank) is ``apply_moe`` bit for
    bit; ``apply_moe_a2a`` (fsdp_dp, the tokens over data × model) at a
    dropless capacity within 1e-5 in float32, the bf16 logit tolerance in
    bf16."""
    import dataclasses
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as MOE
    from repro_torch.parallel.sharding import make_rules, use_shardings
    m = MoEConfig(n_experts=8, top_k=2, d_expert=16, capacity_factor=4.0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = MOE.MoE(32, m, dtype, cuda)
    with torch.no_grad():
        for name in ("router", "wup", "wgate", "wdown"):
            w = getattr(p, name)
            w.copy_(torch.randn(w.shape, generator=gen, device=cuda) * 0.2)
    x = torch.randn((4, 48, 32), generator=gen, device=cuda).to(dtype)
    plain, aux = MOE.apply_moe(p, x, m)
    rules = dataclasses.replace(make_rules(nccl_mesh, None), experts="model")
    with use_shardings(nccl_mesh, rules):
        ep, ep_aux = MOE.apply_moe_shardmap(p, x, m)
    assert torch.equal(ep, plain) and torch.equal(ep_aux, aux)
    rules = dataclasses.replace(rules, batch=("data", "model"),
                                moe_impl="all_to_all")
    with use_shardings(nccl_mesh, rules):
        a2a, _ = MOE.apply_moe_a2a(p, x, m)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=0.02, atol=0.1))
    torch.testing.assert_close(a2a, plain, **tol)


def test_rings_of_one_rank_equal_sdpa_and_matmul(cuda, nccl_mesh):
    """On a one-rank axis ring attention sends nothing and equals SDPA
    (float32, causal and not, GQA 8/2), and the ring collective matmul is
    ``torch.matmul`` bit for bit."""
    from repro_torch.models.layers import sdpa_attention
    from repro_torch.parallel.collectives import ring_collective_matmul
    from repro_torch.parallel.ring_attention import ring_attention
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 300, 8, 64), generator=gen, device=cuda)
    k, v = (torch.randn((2, 300, 2, 64), generator=gen, device=cuda)
            for _ in range(2))
    for causal in (True, False):
        out = ring_attention(nccl_mesh, causal=causal)(q, k, v)
        torch.testing.assert_close(out, sdpa_attention(q, k, v,
                                                       causal=causal),
                                   rtol=2e-5, atol=2e-5)
    x = torch.randn((96, 64), generator=gen, device=cuda).bfloat16()
    w = torch.randn((64, 80), generator=gen, device=cuda).bfloat16()
    assert torch.equal(ring_collective_matmul(nccl_mesh)(x, w),
                       torch.matmul(x, w))


def test_one_stage_pipeline_equals_forward(cuda, nccl_mesh):
    """``pipeline_forward`` on a (1, 1, 1) pod/data/model mesh, 4
    microbatches, internlm2's smoke config in float32: the ``forward``'s
    logits within 1e-5."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.model import forward
    from repro_torch.parallel.pipeline import pipeline_forward
    from repro_torch.parallel.sharding import make_rules, use_shardings
    cfg = get_smoke_config("internlm2-1.8b")
    model = init_params(cfg, seed=0, device=cuda, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab, (8, 64), device=cuda)
    with torch.no_grad():
        ref, _ = forward(model, {"tokens": tokens}, train=True)
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device=cuda)
        with use_shardings(mesh, make_rules(mesh, cfg)):
            out = pipeline_forward(model, {"tokens": tokens}, mesh,
                                   n_microbatches=4)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
