"""The port's CUDA kernels on the card, each against its plain PyTorch version.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card (and
``nvcc`` to build the kernels at first use); without one each test skips
with its reason. The plain versions themselves are held to the JAX package
in ``test_torch_kernels.py``. On a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Sizes here are ragged on purpose (not multiples of the block widths), and
one grid case has a bucket cap large enough that the near kernel needs more
than 48 KB of dynamic shared memory. Tolerance of the force kernels: rtol
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
    odd = torch.zeros(601, device=cuda)[1:].view(300, 2)   # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        grid_ops.grid_far(odd, torch.zeros((4, 3), device=cuda), C, L, MD)


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


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_kernel_prefill_shape_on_a_cache_slice(cuda, hd):
    """The LM path's prefill: Sq = Sk = 2048, 16 heads over 8, k/v a slice
    cache[:, :2048] of a 2088-row cache."""
    out = _flash_case(cuda, 2, 2048, 2048, 16, 8, hd, True, cache_len=2088)
    assert flash_ops.route(2048, 16, 8) == "wgmma"
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


def test_flash_kernel_decode_shape_spreads_over_the_card(cuda):
    """The LM path's decode (B 4, 8 KV heads, 2080 keys): at least 256
    blocks of the split-KV route."""
    splits, chunk = flash_ops.split_plan(4, 8, 2080, flash_ops._sm_count(
        cuda.index or 0))
    assert 4 * 8 * splits >= 256 and splits * chunk >= 2080
    _flash_case(cuda, 4, 1, 2080, 16, 8, 128, True, cache_len=2088)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _attn_inputs(1, 16, 16, 4, 2, 64, 0, cuda)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.float(), k.float(), v.float())
    q96, k96, v96 = _attn_inputs(1, 16, 16, 4, 2, 96, 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q96, k96, v96)
    with pytest.raises(ValueError, match="on cpu"):
        flash_attention(q, k.cpu(), v)
