"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``apply_moe`` on the CPU.

The JAX package's ``init_moe`` weights are carried across with
``repro_torch.convert.moe_params`` and both layers run on the same
numpy-seeded input, rounded to the working dtype first, so both routers see
the same float32 values:

- the router: the top-k expert indices equal exactly, in float32 and bf16
  (both route the float32 input through the float32 router); the
  probabilities and renormalised gates within rtol = atol = 1e-6;
- the dispatch slots (``dispatch_slots``) equal a plain count over (position,
  rank) exactly, and the JAX package's cumsum formula on its own indices;
- the layer's output and aux loss, with a capacity factor small enough to
  drop tokens (0.5: each expert takes at most half its fair share) and one
  large enough to drop none (8.0), with and without shared experts, SwiGLU
  and the GELU branch, and at decode (S 1, C 1). Float32: rtol = atol =
  1e-5 (the same float32 function, sums in another order). bf16: rtol
  2e-2 and atol two bf16 ulps of the output's largest magnitude,
  2^-7 · max|y|: the activations round to bf16 at each product (a bf16
  ulp is 2^-8 relative), XLA and torch round the SiLU/GELU at different
  points, and y sums the routed and the shared experts' outputs, each
  rounded at its own magnitude, so a small y can carry their rounding
  (measured: at most 0.031 at max|y| 5.0). The aux loss is float32 on
  both sides: rtol 1e-5;
- ``convert.lm_params`` of a deepseek-shaped model: the unstacked dense
  layer 0 (``params["prefix"][0]``, width ``first_dense_ff``), the stacked
  MoE layers after it, the shared experts, the router kept float32.

The file takes about a minute on one CPU core, most of it the JAX side's
compiles of its bf16 ops.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models.moe as jax_moe
import repro.models.model as jax_model
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro_torch import convert
from repro_torch.configs import MoEConfig, get_smoke_config
from repro_torch.models import moe as port_moe

D = 48
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _assert_y(y, yj, dtype):
    """The layer's output against JAX's, at the dtype's tolerance."""
    tol = DTYPES[dtype][2]
    yj = np.asarray(yj, np.float32)
    atol = tol if dtype == "float32" else 2 ** -7 * float(np.abs(yj).max())
    np.testing.assert_allclose(y.float().numpy(), yj, rtol=tol, atol=atol)


def _layer(E=6, k=2, n_shared=0, d_expert=24, cf=1.25, seed=0):
    kw = dict(n_experts=E, top_k=k, n_shared=n_shared, d_expert=d_expert,
              capacity_factor=cf)
    jm, m = JaxMoEConfig(**kw), MoEConfig(**kw)
    p = jax_moe.init_moe(jax.random.PRNGKey(seed), D, jm)
    return jm, m, p, jax.tree.map(np.asarray, p)


def _x(B, S, dtype, seed=1):
    jdt, _, _ = DTYPES[dtype]
    x = np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)
    return np.asarray(jnp.asarray(x, jdt), np.float32)


def _jax_slots(expert_idx, E, C):
    """The JAX package's dispatch formula (``apply_moe``), on its indices."""
    B, S, k = expert_idx.shape
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.float32)
    flat = onehot.reshape(B, S * k, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(B, S, k)
    keep = pos < C
    slot = jnp.where(keep, expert_idx * C + pos.astype(jnp.int32), E * C)
    return np.asarray(keep).reshape(B, S * k), np.asarray(slot).reshape(
        B, S * k)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("E,k,S", [(6, 2, 40), (40, 8, 17), (64, 6, 1)])
def test_route_and_slots_match_jax(dtype, E, k, S):
    jdt, tdt, _ = DTYPES[dtype]
    jm, m, p, np_p = _layer(E, k)
    x = _x(3, S, dtype, seed=E + S)
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x, jdt).astype(jnp.float32),
                        p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gates, idx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    layer = convert.moe_params(np_p, m, D, device="cpu", dtype=tdt)
    assert layer.router.dtype == torch.float32
    pp, pg, pi = port_moe.route(layer, torch.tensor(x).to(tdt), m)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(idx))
    np.testing.assert_allclose(pp.numpy(), np.asarray(probs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(gates), rtol=1e-6,
                               atol=1e-6)
    C = jax_moe.capacity(S, jm)
    assert port_moe.capacity(S, m) == C
    keep, slot = port_moe.dispatch_slots(pi, E, C)
    jkeep, jslot = _jax_slots(idx, E, C)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(slot.numpy(), jslot)


@pytest.mark.parametrize("C", [1, 2, 5, 100])
def test_slots_match_a_plain_count(C):
    """Each choice in (position, rank) order takes its expert's next slot
    until the expert holds C; the rest go to the overflow bin E·C. Every
    kept slot holds exactly one choice."""
    E, k, B, S = 7, 3, 2, 30
    rng = np.random.default_rng(C)
    idx = np.stack([[rng.choice(E, k, replace=False) for _ in range(S)]
                    for _ in range(B)])
    keep, slot = port_moe.dispatch_slots(torch.from_numpy(idx), E, C)
    for b in range(B):
        taken = np.zeros(E, int)
        want = []
        for e in idx[b].reshape(-1):
            want.append(e * C + taken[e] if taken[e] < C else E * C)
            taken[e] += 1
        np.testing.assert_array_equal(slot[b].numpy(), want)
        np.testing.assert_array_equal(keep[b].numpy(),
                                      np.array(want) < E * C)
        kept = slot[b][keep[b]].numpy()
        assert len(set(kept)) == len(kept)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cf,drops", [(0.5, True), (8.0, False)])
@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_apply_moe_matches_jax(dtype, cf, drops, n_shared, activation):
    jdt, tdt, _ = DTYPES[dtype]
    jm, m, p, np_p = _layer(E=6, k=2, n_shared=n_shared, cf=cf)
    x = _x(2, 33, dtype)
    yj, auxj = jax_moe.apply_moe(p, jnp.asarray(x, jdt), jm, activation)
    layer = convert.moe_params(np_p, m, D, device="cpu", dtype=tdt)
    xt = torch.tensor(x).to(tdt)
    y, aux = port_moe.apply_moe(layer, xt, m, activation)
    assert y.dtype == tdt and aux.dtype == torch.float32
    _assert_y(y, yj, dtype)
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-5)
    _, _, idx = port_moe.route(layer, xt, m)
    keep, _ = port_moe.dispatch_slots(idx, 6, port_moe.capacity(33, m))
    assert bool((~keep).any()) == drops


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_apply_moe_at_the_published_routing_and_decode(dtype, arch):
    """The published configs' routing (40 experts top-8; 64 top-6 with 2
    shared experts) at a narrow width, over a prompt (S 24) and at decode
    (S 1, C 1: every expert's weights read for one token)."""
    jdt, tdt, _ = DTYPES[dtype]
    from repro.configs import get_config as jax_get_config
    jm = dataclasses.replace(jax_get_config(arch).moe, d_expert=16)
    m = MoEConfig(**dataclasses.asdict(jm))
    p = jax_moe.init_moe(jax.random.PRNGKey(3), D, jm)
    layer = convert.moe_params(jax.tree.map(np.asarray, p), m, D,
                               device="cpu", dtype=tdt)
    for S in (24, 1):
        x = _x(4, S, dtype, seed=S)
        yj, auxj = jax_moe.apply_moe(p, jnp.asarray(x, jdt), jm)
        y, aux = port_moe.apply_moe(layer, torch.tensor(x).to(tdt), m)
        _assert_y(y, yj, dtype)
        np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-5)
    assert port_moe.capacity(1, m) == 1


def test_aux_and_no_passthrough():
    """The JAX package's MoE properties, on the port: the Switch loss is at
    least 1 (1 at perfect balance); with capacity past the tokens, zeroed
    expert weights zero the output (nothing passes through the layer)."""
    _, m, _, np_p = _layer(E=8, k=2, cf=1.0)
    layer = convert.moe_params(np_p, m, D, device="cpu", dtype=torch.float32)
    y, aux = port_moe.apply_moe(layer, torch.tensor(_x(2, 64, "float32")), m)
    assert y.shape == (2, 64, D) and torch.isfinite(y).all()
    assert float(aux) >= 0.99
    _, m, _, np_p = _layer(E=4, k=2, cf=8.0)
    layer = convert.moe_params(np_p, m, D, device="cpu", dtype=torch.float32)
    x = torch.tensor(_x(1, 32, "float32"))
    assert float(port_moe.apply_moe(layer, x, m)[0].abs().max()) > 1e-6
    with torch.no_grad():
        layer.wdown.zero_()
    assert float(port_moe.apply_moe(layer, x, m)[0].abs().max()) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_a_deepseek_prefix(dtype):
    cfg = jax_get_smoke_config("deepseek-moe-16b")
    params = jax.tree.map(np.asarray, jax_model.init_params(
        cfg, jax.random.PRNGKey(5)))
    tdt = getattr(torch, dtype)
    model = convert.lm_params(params, get_smoke_config("deepseek-moe-16b"),
                              device="cpu", dtype=tdt)
    first = model.layers[0]
    assert first.moe is None
    assert first.mlp["wup"].shape == (cfg.d_model, cfg.moe.first_dense_ff)
    for name, a in params["prefix"][0]["mlp"].items():
        assert torch.equal(first.mlp[name], torch.tensor(a).to(tdt))
    groups = params["groups"][0]
    for i, layer in enumerate(model.layers[1:]):
        assert layer.mlp is None
        assert layer.moe.router.dtype == torch.float32
        assert torch.equal(layer.moe.router,
                           torch.tensor(groups["moe"]["router"][i]))
        for name in ("wup", "wgate", "wdown"):
            assert torch.equal(getattr(layer.moe, name), torch.tensor(
                groups["moe"][name][i]).to(tdt))
            assert torch.equal(layer.moe.shared[name], torch.tensor(
                groups["moe"]["shared"][name][i]).to(tdt))
        assert torch.equal(layer.attn["wq"],
                           torch.tensor(groups["attn"]["wq"][i]).to(tdt))
    assert len(model.layers) == cfg.n_layers
