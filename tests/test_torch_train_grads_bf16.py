"""The port's training path against the JAX package's on the CPU, in bf16
(both sides' activations and the port's matmul weights in bf16, JAX's
params float32 cast at use): ``loss_fn``, every gradient leaf and one
``make_train_step`` step for every registered model's smoke config
(``torch_train_cases.run_case``, which also holds the MoE routing: the
port follows JAX's expert choices, and its own must equal them on every
token whose JAX margin is at least 0.02).

Tolerances (the LM's bf16 tolerances, as in ``test_torch_lm.py``):
- loss, ce, aux, grad_norm, lr: rtol 0.02, atol 0.1 (measured |Δloss|
  ≤ 0.0015 with the routes followed);
- each gradient leaf: rtol 0.02, atol 0.1 × the leaf's largest |JAX
  value|: the packages round to bf16 at different points (JAX rounds the
  attention scores to bf16), and its parameter gradients are bf16
  cotangents cast to float32 where the port's are bf16 (measured largest
  |Δ| 0.029 of a leaf's max on all but one leaf). Where JAX's own bf16
  gradient lies further than that from the float32 gradient of the same
  function (the port's float32 gradient, which ``test_torch_train_grads``
  holds to JAX's within 1e-4), the port's is held to be no further from
  it than twice JAX's. One leaf takes that branch: jamba's layer-0
  ``ssm.A_log``, 8 per-head sums over every position, where the float32
  gradient's first entry is 0.0011, JAX's bf16 −0.0057 and the port's
  −0.0036;
- the float32 masters after one step: atol 0.02 × the step's lr (plus
  1e-6 of the leaf's largest |value|) on every element whose gradients on
  the two sides agree in sign and, times each side's clip scale, lie at
  least 100 × eps from zero; 2 × lr elsewhere. At step 1 Adam moves an
  element by lr · g/(|g| + eps), within 1% of ±lr past 100 × eps, so
  agreeing elements move alike; an element whose gradient has opposite
  signs on the two sides (a gradient near zero, inside the bf16 noise)
  moves by +lr on one and −lr on the other;
- the port's ``apply_updates`` on JAX's gradients from JAX's state:
  masters, mu and nu within 1e-5 × the leaf's largest |JAX value| of
  JAX's: the same float32 arithmetic, but the grad norm's sum order
  differs, which moves the clip scale by ~5e-7 and nu by twice that
  (measured up to 1.06e-6 of an element on internlm2's ``lm_head.w``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_train_cases import (ARCHS, _np, assert_adamw_replay_matches_jax,
                               run_case)

TOL = dict(rtol=0.02, atol=0.1)


def assert_grads_close(grads, jax_grads, float32_grads, rtol, atol):
    """Each leaf within rtol·|JAX| + atol·max|JAX leaf|, or, where JAX's
    bf16 leaf lies further from the float32 one than that, within twice
    JAX's largest distance from it."""
    assert set(grads) == set(jax_grads) == set(float32_grads)
    for name, g in grads.items():
        a, b = _np(g), np.asarray(jax_grads[name], np.float32)
        t = _np(float32_grads[name])
        scale = np.abs(b).max()
        if scale == 0:
            assert np.abs(a).max() == 0, name
            continue
        if (np.abs(a - b) <= rtol * np.abs(b) + atol * scale).all():
            continue
        assert not (np.abs(b - t) <= rtol * np.abs(t)
                    + atol * np.abs(t).max()).all(), name
        assert np.abs(a - t).max() <= 2 * np.abs(b - t).max(), name


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return run_case(request.param, "bfloat16")


def test_loss_matches_jax(case):
    np.testing.assert_allclose(float(case["loss"]), float(case["jax_loss"]),
                               **TOL)
    for part in ("ce", "aux"):
        np.testing.assert_allclose(float(case["parts"][part]),
                                   float(case["jax_parts"][part]), **TOL)


def test_grads_match_jax(case):
    assert_grads_close(case["grads"], case["jax_grads"],
                       case["float32_grads"], **TOL)


def test_grads_reach_attention_and_router(case):
    names = [n for n in case["grads"]
             if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "router")]
    assert names or case["cfg"].family == "ssm"
    for n in names:
        assert float(case["grads"][n].float().abs().max()) > 0, n
    assert_grads_close(*({n: case[key][n] for n in names} for key in
                         ("grads", "jax_grads", "float32_grads")), **TOL)


def test_train_step_matches_jax(case):
    m, jm = case["metrics"], case["jax_metrics"]
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    opt = case["opt"]
    assert int(opt.step) == case["jax_step"] == 1
    lr, eps, clip_norm = case["lr1"], case["optim"].eps, case["optim"].clip_norm
    clip = [min(1.0, clip_norm / max(float(g), 1e-12))
            for g in (m["grad_norm"], jm["grad_norm"])]
    for name, p in case["params"].items():
        master, jmaster = _np(opt.master[name]), case["jax_master"][name]
        g, jg = _np(case["grads"][name]), case["jax_grads"][name]
        agree = ((np.sign(g) == np.sign(jg)) & (np.abs(g) * clip[0]
                 >= 100 * eps) & (np.abs(jg) * clip[1] >= 100 * eps))
        d = np.abs(master - jmaster)
        slack = 1e-6 * np.abs(jmaster).max()
        assert (d[agree] <= 0.02 * lr + slack).all(), name
        assert (d <= 2 * lr + slack).all(), name
        assert torch.equal(p.detach(), opt.master[name].to(p.dtype)), name


def test_adamw_on_jax_grads_matches_jax(case):
    assert_adamw_replay_matches_jax(case, 1e-5)
