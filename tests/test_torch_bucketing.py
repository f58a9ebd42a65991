"""The port's step cache and ``LayoutConfig.bucketing`` against the live JAX
package on the CPU.

On the CPU a cached step program runs its step eagerly on its static
buffers (only the card captures a CUDA graph), so keys, hits, misses and
any value wrongly baked into an entry show here as they would on the card.

Tolerances:

* bucketed against exact-shape layouts of the port: 1e-5, as the JAX
  package's own ``tests/test_bucketing.py`` holds its two paths (graphs
  of n ≤ 512, whose n_pad is the same under both paddings);
* each of them against JAX's layout with the same config: level sizes
  equal, quality_report NELD within 0.05 and CRE within 0.15
  (``test_torch_layout.py``), except CRE on scale_free_480 within 0.5:
  there JAX's own final CRE moves by 0.41 when its random init moves by
  one float32 ulp (36.337 → 35.925), and the port sits 0.27 from JAX on
  both paths;
* the exact-shape hierarchy against JAX's: bit for bit, ``ewt`` and every
  ``LevelInfo`` array included (integer and compounded-weight arithmetic
  in the same order);
* a warm entry after a change of ideal_len, rep_const, seed and iteration
  count against a cold one, and the program's iteration against the eager
  loop's: bit for bit (the same float32 arithmetic on the same values);
* ``decode_step`` with a device ``pos``: ``test_torch_lm.py``'s tolerances
  (float32 1e-4; bf16 rtol 0.02, atol 0.1);
* the plain attention with ``kv_len``: ``test_torch_attention.py``'s
  (2e-5 in float32, 2e-2 in bf16).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
import repro.models.model as jax_model
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core import multigila_layout as jax_layout
from repro.core.multilevel import LayoutConfig as JaxConfig
from repro.core.multilevel import build_hierarchy as jax_build_hierarchy
from repro.graphs import generators as G
from repro.graphs.graph import build_graph as jax_build_graph
from repro.graphs.metrics import quality_report as jax_quality
from repro.models.layers import _sdpa as jax_sdpa
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import LayoutConfig, bucketing, build_hierarchy
from repro_torch.core import multigila_layout, schedule
from repro_torch.core.engine import RefineProgram, get_engine
from repro_torch.graphs.graph import build_graph
from repro_torch.graphs.metrics import quality_report
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import model as M

NELD_DELTA, CRE_DELTA = 0.05, 0.15
INFO_FIELDS = ("parent_coarse", "sun_of", "depth", "state", "sun_pos_index")
GRAPH_FIELDS = ("src", "dst", "vmask", "emask", "mass", "ewt")
MODES = dict(exact=dict(exact_threshold=10 ** 6),
             neighbor=dict(exact_threshold=64, grid_threshold=10 ** 6),
             grid=dict(exact_threshold=64, grid_threshold=256))


# -- bucketing=True against bucketing=False, and each against JAX -------------

PARITY = [
    pytest.param(*G.grid(20, 20), {}, id="grid_20_20"),
    pytest.param(*G.delaunay(450, 3), {}, id="delaunay_450"),
    pytest.param(*G.scale_free(480, 2, 4), dict(cre_delta=0.5),
                 id="scale_free_480"),
    pytest.param(*G.grid(20, 20), dict(exact_threshold=128),
                 id="neighbor-mode"),
    pytest.param(*G.grid(20, 20), dict(grid_threshold=256), id="grid-mode"),
]


@pytest.mark.parametrize("edges,n,kw", PARITY)
def test_bucketed_matches_exact_shape_and_jax(edges, n, kw):
    kw = dict(kw)
    cre_delta = kw.pop("cre_delta", CRE_DELTA)
    pb, sb = multigila_layout(edges, n, LayoutConfig(seed=7, **kw),
                              device="cpu")
    pe, se = multigila_layout(edges, n, LayoutConfig(seed=7, bucketing=False,
                                                     **kw), device="cpu")
    assert sb.level_sizes == se.level_sizes
    np.testing.assert_allclose(pb, pe, atol=1e-5)
    qj = {}
    for b in (True, False):
        pj, sj = jax_layout(edges, n, JaxConfig(seed=7, bucketing=b, **kw))
        assert sj.level_sizes == sb.level_sizes
        qj[b] = jax_quality(jax_build_graph(edges, n), pj)
    gt = build_graph(edges, n, device="cpu")
    for b, p in ((True, pb), (False, pe)):
        qt = quality_report(gt, p)
        assert abs(qt["neld"] - qj[b]["neld"]) <= NELD_DELTA, (b, qt, qj)
        assert abs(qt["cre"] - qj[b]["cre"]) <= cre_delta, (b, qt, qj)


@pytest.mark.parametrize("weighted", [False, True])
def test_exact_shape_hierarchy_equals_jax(weighted):
    """``bucketing=False``: round-256 padding and ``next_level_host`` give
    JAX's exact-shape hierarchy bit for bit."""
    edges, n = G.delaunay(3000, seed=4)
    w = (np.random.default_rng(1).uniform(0.5, 2.0, len(edges))
         .astype(np.float32) if weighted else None)
    gj = jax_build_graph(edges, n, ewt=w)
    gt = build_graph(edges, n, ewt=w, device="cpu")
    graphs_j, infos_j = jax_build_hierarchy(gj, JaxConfig(bucketing=False))
    graphs_t, infos_t = build_hierarchy(gt, LayoutConfig(bucketing=False),
                                        device="cpu")
    assert len(graphs_t) >= 3
    assert [(g.n, g.m, g.n_pad, g.m_pad) for g in graphs_t] == \
        [(g.n, g.m, g.n_pad, g.m_pad) for g in graphs_j]
    assert all(g.n_pad % 256 == 0 and g.n_pad - g.n < 256 for g in graphs_t)
    for a, b in zip(graphs_t, graphs_j):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)), f)
    for a, b in zip(infos_t, infos_j):
        for f in INFO_FIELDS:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)), f)


# -- the cache ------------------------------------------------------------------

def test_warm_path_adds_no_miss():
    """A fresh graph whose levels land in warm buckets reuses every entry:
    no new miss, some hits (the JAX package's
    ``test_warm_path_zero_new_compiles``), and the layout of a cold cache,
    bit for bit."""
    e1, n1 = G.delaunay(3000, 5)
    multigila_layout(e1, n1, LayoutConfig(seed=5), device="cpu")
    before = bucketing.cache_stats()
    e2, n2 = G.delaunay(3000, 9)
    pos, st = multigila_layout(e2, n2, LayoutConfig(seed=6), device="cpu")
    after = bucketing.cache_stats()
    assert pos.shape == (n2, 2) and st.levels >= 2
    assert after["misses"] == before["misses"], (before, after)
    assert after["entries"] == before["entries"]
    assert after["hits"] > before["hits"]
    assert set(before) == {"entries", "hits", "misses"}
    bucketing.STEP_CACHE.clear()
    cold, _ = multigila_layout(e2, n2, LayoutConfig(seed=6), device="cpu")
    assert bucketing.cache_stats()["hits"] == 0
    assert np.array_equal(pos, cold)


def _level(mode, engine, seed, iters, graph=2):
    edges, n = G.delaunay(600, seed=graph)
    g = build_graph(edges, n, bucket=True, device="cpu")
    sched = schedule.make_schedule(0, 3, g.n, g.m, n_pad=g.n_pad,
                                   engine=engine, **MODES[mode])
    assert sched.mode == mode
    rng = np.random.default_rng(seed)
    pos0 = torch.from_numpy((rng.random((g.n_pad, 2)) * 25).astype(
        np.float32))
    return g, pos0, dataclasses.replace(sched, iters=iters, temp0=0.7)


def _refine(mode, engine, *, ideal_len, rep_const, seed, iters, graph=2):
    g, pos0, sched = _level(mode, engine, seed, iters, graph)
    return bucketing.refine_level(g, pos0, sched, ideal_len=ideal_len,
                                  rep_const=rep_const, min_dist=2e-3,
                                  seed=seed)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ["gila", "stress"])
def test_warm_entry_bakes_in_no_value(mode, engine, monkeypatch):
    """One entry, warmed with one graph, ideal_len, rep_const, seed and
    iteration count, then reused with others — another graph of the same
    bucket (delaunay(600) of another seed: the same n_pad, m_pad and K,
    other edges) — gives the bits of a cold cache. The schedule buffer
    holds 8 rows here, so both runs refill it in chunks."""
    monkeypatch.setattr(RefineProgram, "ROWS", 8)
    bucketing.STEP_CACHE.clear()
    _refine(mode, engine, ideal_len=1.0, rep_const=1.0, seed=3, iters=12)
    new = dict(ideal_len=1.7, rep_const=0.6, seed=5, iters=21, graph=7)
    g2, g7 = (_level(mode, engine, 0, 1, graph)[0] for graph in (2, 7))
    assert (g2.n_pad, g2.m_pad) == (g7.n_pad, g7.m_pad)
    assert not torch.equal(g2.src, g7.src)
    warm = _refine(mode, engine, **new)
    assert bucketing.cache_stats() == dict(entries=1, hits=1, misses=1)
    bucketing.STEP_CACHE.clear()
    cold = _refine(mode, engine, **new)
    assert bucketing.cache_stats() == dict(entries=1, hits=0, misses=1)
    assert torch.equal(warm, cold)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ["gila", "stress"])
def test_program_iteration_equals_eager_loop(mode, engine):
    """The cached program's iterations (row by the device counter, static
    buffers) give the bits of ``engine.refine``'s eager loop."""
    g, pos0, sched = _level(mode, engine, seed=8, iters=14)
    eng = get_engine(engine)
    nbr_idx, nbr_mask = eng.init_state(g, sched, 1)
    eager = eng.refine(g, pos0, nbr_idx, nbr_mask, sched, ideal_len=1.3,
                       rep_const=0.8, min_dist=2e-3)
    bucketing.STEP_CACHE.clear()
    key, prog, fresh, args = bucketing.cached_refine(
        g, pos0, sched, nbr_idx, nbr_mask, ideal_len=1.3, rep_const=0.8,
        min_dist=2e-3)
    assert fresh and key == ("refine", engine, g.n_pad, g.m_pad,
                             int(nbr_idx.shape[1]), mode, sched.grid_dim,
                             sched.cell_cap, "cpu")
    assert torch.equal(prog.run(*args), eager)
    assert torch.equal(prog.run(*args), eager)      # warm: the same again
    assert not torch.equal(eager, pos0)


# -- the LM: device pos and device kv_len ----------------------------------------

LM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
          "bfloat16": dict(rtol=0.02, atol=0.1)}


@pytest.mark.parametrize("dtype", sorted(LM_TOL))
def test_decode_step_with_device_pos_matches_jax(dtype, monkeypatch):
    """Four greedy steps, ``pos`` an int32 tensor on both sides, the port's
    ``DecodeGraph`` beside its ``decode_step``: logits against JAX's at the
    dtype's tolerance, the graph's tokens equal to the step's."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    monkeypatch.setattr(jax_layers, "ACT_DTYPE", jdt)
    monkeypatch.setattr(jax_model, "ACT", jdt)
    arch = "internlm2-1.8b"
    cfg = jax_get_smoke_config(arch)
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    model = convert.lm_params(jax.tree.map(np.asarray, params),
                              get_smoke_config(arch), device="cpu",
                              dtype=getattr(torch, dtype))
    tokens = np.random.default_rng(2).integers(0, 512, (2, 33)).astype(
        np.int32)
    lj, sj, pos = jax_model.prefill(params, cfg, {"tokens": jnp.asarray(
        tokens)}, cache_len=48)
    lp, sp, _ = M.prefill(model, {"tokens": torch.from_numpy(tokens).long()},
                          cache_len=48)
    dec = M.compile_decode(model, 2, 48)
    tok = np.asarray(jnp.argmax(lj[:, -1], -1), np.int32)[:, None]
    dec.start(sp, torch.from_numpy(tok).long(), torch.tensor(pos,
                                                            dtype=torch.int32))
    for i in range(4):
        p = torch.tensor(pos + i, dtype=torch.int32)
        lj, sj = jax_model.decode_step(params, cfg, jnp.asarray(tok), sj,
                                       jnp.asarray(pos + i, jnp.int32))
        lp, sp = M.decode_step(model, torch.from_numpy(tok).long(), sp, p)
        np.testing.assert_allclose(lp.float().numpy(),
                                   np.asarray(lj, np.float32),
                                   **LM_TOL[dtype])
        dec.step()
        assert torch.equal(dec.logits, lp)
        assert torch.equal(dec.token, lp[:, -1].argmax(-1, keepdim=True))
        # both follow JAX's greedy tokens, so a near tie cannot fork them
        tok = np.asarray(jnp.argmax(lj[:, -1], -1), np.int32)[:, None]
        dec.token.copy_(torch.from_numpy(tok))
    assert int(dec.pos) == pos + 4


@pytest.mark.parametrize("Sq,kv_len", [(1, 1), (1, 17), (1, 40), (1, 64),
                                       (3, 3), (3, 17), (3, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_with_kv_len_matches_sdpa(Sq, kv_len, dtype):
    """The plain version over a whole 64-row cache with ``kv_len`` a 0-d
    tensor against ``_sdpa(q_offset=kv_len − Sq, kv_len=kv_len)``."""
    jdt, tdt, tol = dict(float32=(jnp.float32, torch.float32, 2e-5),
                         bfloat16=(jnp.bfloat16, torch.bfloat16, 2e-2))[dtype]
    rng = np.random.default_rng(kv_len + Sq)
    B, H, KV, hd, cache = 2, 4, 2, 16, 64
    q, k, v = (np.asarray(jnp.asarray(rng.normal(size=s), jdt), np.float32)
               for s in ((B, Sq, H, hd), (B, cache, KV, hd),
                         (B, cache, KV, hd)))
    ref = jax_sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True,
                   q_offset=kv_len - Sq, kv_len=kv_len)
    out = flash_attention_ref(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                              causal=True,
                              kv_len=torch.tensor(kv_len, dtype=torch.int32))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)
