"""The port's sharded serving against the live JAX package on the CPU:
``prefill`` and ``decode_step`` under the sharding rules, the flash
kernel's log-sum-exp and the flash-decoding merge, and the decode state's
specs.

Sharded serving: every registered model's smoke config (JAX's
``init_params`` weights, carried by name as ``convert.lm_leaves`` maps
them), a B 8 × S 16 prompt (with 8 frames or 4 patches where the family
takes them), then 4 decode steps fed the same recorded tokens, into a
cache of 24 rows. The port runs on 8 gloo ranks
(``tests/torch_serve_parallel_ranks.py``) at meshes (4, 2) and (1, 8),
under ``make_rules`` (the ``kv_heads`` cache form where the rules cut the
KV heads) and under the same rules with ``kv_heads=None`` (the ``kv_seq``
form: the cache cut along its sequence, flash-decoding merged over the
ranks; at (1, 8) and for gemma-2b's single KV head it is the rules' own
form), in float32 and bf16. JAX runs ``prefill`` and ``decode_step`` under
``make_rules`` at the same mesh on 8 host devices, in two subprocesses
(one a dtype), all three at once: both of the port's cache forms are held
to that one run (JAX's rules place its arrays; its values do not depend on
them). The unsharded port runs the same inputs on each rank.

Tolerances: float32 logits rtol = atol = 1e-4 (the JAX side switched to
float32 through its two activation-dtype globals, as ``test_torch_lm.py``
does); bf16 the LM tolerances, rtol 0.02, atol 0.1. MoE routing in bf16
(both sides record every router call: the port its top-k experts on the
ranks, JAX its probabilities through ``jax.debug.callback``, its layer scan
run as a Python loop so that each call is told apart): the packages round
the router's bf16 input at other points, so a near-tie may pick another
expert — a different value, not a drift. As in ``test_torch_lm.py``, the
choices must be equal on every token whose k-th/(k+1)-th margin (JAX's)
is at least ROUTE_MARGIN = 0.02; a row where a choice differs (a flip,
below the margin) is compared only at the steps before it, and at least
half the rows are compared at every step. In float32 every choice is
equal. The gathered decode
state against the unsharded port's, in float32: within 1e-5 of each
tensor's largest |value| (the same function, with the row-parallel sums
over the ranks), every MoE choice equal. (In bf16 the two runs round at
other points, and jamba's SSD state, summed over every position, drifts
past the LM tolerance: the layout is what this holds, and float32 shows
it.)

In process: ``decode_state_specs`` and ``_batch_spec`` against the JAX
dry run's for every registered config at meshes (4, 2), (1, 8), (2, 2, 2),
(16, 16) and (2, 16, 16) and B in {1, 8, 128} (stand-in meshes; the JAX
module sets ``XLA_FLAGS`` at import, which is restored after it); the
plain flash versions' lse within 1e-5 of a float64 numpy log-sum-exp, rows
with ``kv_len`` 0 included (lse −inf, output 0); ``merge_partials_local``
over P blocks of the keys within 1e-5 of the uncut output (float32).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import jax

import repro.models.model as jax_model
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs import list_archs
from repro.parallel.sharding import make_rules as jax_make_rules
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_attention_split_ref)
from repro_torch.models import model as M
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as SH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_serve_parallel_ranks import (ARCHS, B, CACHE, DTYPES,  # noqa
                                        FRAMES, PATCHES, S, STEPS, cases,
                                        tag)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.02, atol=0.1)
STATE_F32 = 1e-5
ROUTE_MARGIN = 0.02

JAX_SERVE = """
import numpy as np, jax, jax.numpy as jnp
import repro.models.layers as L
import repro.models.model as M
import repro.models.moe as MOE
from repro.configs import get_smoke_config
from repro.launch.mesh import make_compat_mesh
from repro.parallel.sharding import make_rules, use_shardings
inp = dict(np.load(INP))
out = {}
meshes = {s: make_compat_mesh(s, ("data", "model")) for s in MESHES}

# every MoE call's router probabilities, keyed (step, call) with the call's
# number fixed at trace time; the layer scans unrolled so that each layer's
# call is traced on its own
real_moe, real_scan = MOE.apply_moe, jax.lax.scan
rec, now = {}, {"step": 0, "call": 0}


def recorded_moe(p, x, m, activation="swiglu"):
    cid = now["call"]
    now["call"] += 1
    probs = jax.nn.softmax(jnp.einsum(
        "bsd,de->bse", x.astype(jnp.float32), p["router"]), axis=-1)
    jax.debug.callback(
        lambda a, cid=cid: rec.__setitem__((now["step"], cid),
                                           np.asarray(a)), probs)
    return real_moe(p, x, m, activation)


def unrolled(f, init, xs):
    n = jax.tree.leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    if jax.tree.leaves(ys[0]) == []:
        return carry, ys[0]
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


MOE.apply_moe = recorded_moe
for arch, shape, dt in CASES:
    L.ACT_DTYPE = M.ACT = getattr(jnp, dt)
    cfg = get_smoke_config(arch)
    jax.lax.scan = unrolled if cfg.moe is not None else real_scan
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k.rsplit(":", 1)[1]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(arch + ":b:")}
    batch["tokens"] = batch["tokens"].astype(jnp.int32)
    steps = jnp.asarray(inp[arch + ":steps"], jnp.int32)
    mesh = meshes[tuple(shape)]
    rules = make_rules(mesh, cfg)
    key = "%s:%dx%d:%s" % (arch, shape[0], shape[1], dt)
    rec.clear()
    with use_shardings(mesh, rules):
        now.update(step=0, call=0)
        logits, state, pos = jax.jit(
            lambda p, b: M.prefill(p, cfg, b, CACHE))(params, batch)
        jax.effects_barrier()
        enc = (jax.jit(lambda p, f: M._encode(p, cfg, f))(
            params, batch["frames"]) if cfg.enc_layers else None)
        step = jax.jit(lambda p, t, s, q, e: M.decode_step(
            p, cfg, t, s, q, enc_out=e))
        got = [logits]
        for i in range(steps.shape[1]):
            now.update(step=i + 1, call=0)
            logits, state = step(params, steps[:, i:i + 1], state,
                                 jnp.int32(pos + i), enc)
            jax.effects_barrier()
            got.append(logits)
    out[key] = np.asarray(jnp.concatenate(got, axis=1), np.float32)
    for (t, c), a in rec.items():
        out["%s:probs:%d:%d" % (key, t, c)] = a
np.savez(OUT, **out)
"""


def _inputs() -> dict:
    """Each model's JAX weights (float32, by the port's names), its prompt
    (tokens, frames, patches) and its decode steps' tokens."""
    inp = {}
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        cfg = jax_get_smoke_config(arch)
        p = jax.tree.map(np.asarray, jax_model.init_params(
            cfg, jax.random.PRNGKey(0)))
        model = M.LM(get_smoke_config(arch), device="meta")
        for k, v in convert.lm_leaves(p, model).items():
            inp[f"{arch}:w:{k}"] = np.asarray(v, np.float32)
        inp[f"{arch}:b:tokens"] = rng.integers(0, cfg.vocab, (B, S))
        inp[f"{arch}:steps"] = rng.integers(0, cfg.vocab, (B, STEPS))
        if cfg.enc_layers:
            inp[f"{arch}:b:frames"] = (rng.standard_normal(
                (B, FRAMES, cfg.d_model)) * 0.05).astype(np.float32)
        if cfg.modality == "vlm":
            inp[f"{arch}:b:patches"] = (rng.standard_normal(
                (B, PATCHES, cfg.d_model)) * 0.05).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's sharded logits, the port's results)."""
    d = tmp_path_factory.mktemp("serve_parallel")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = []
    for dt in DTYPES:
        jax_cases = sorted({(a, s, t) for a, s, _, t in cases() if t == dt})
        jax_cases = [(a, list(s), t) for a, s, t in jax_cases]
        code = (f"INP = {str(d / 'inputs.npz')!r}\n"
                f"OUT = {str(d / f'jax_{dt}.npz')!r}\n"
                f"CASES = {jax_cases!r}\nMESHES = {[(4, 2), (1, 8)]!r}\n"
                f"CACHE = {CACHE}\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code + textwrap.dedent(JAX_SERVE)],
            env=jenv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    procs.append(subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_serve_parallel_ranks.py"),
         str(d / "inputs.npz"), str(d)], env=dict(env, OMP_NUM_THREADS="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=900)
            assert p.returncode == 0, err[-6000:]
    finally:
        for p in procs:
            p.kill()
    jax_out = {}
    for dt in DTYPES:
        jax_out.update(np.load(d / f"jax_{dt}.npz"))
    return jax_out, dict(np.load(d / "torch.npz"))


@pytest.mark.parametrize("case", cases(), ids=lambda c: tag(*c))
def test_sharded_serving_matches_jax(runs, case):
    """The port's sharded prefill and decode logits [B, 5, V] against
    JAX's under the same rules and mesh."""
    jax_out, got = runs
    key = tag(*case)
    arch, shape, _, dt = case
    jkey = f"{arch}:{shape[0]}x{shape[1]}:{dt}"
    tol = F32 if dt == "float32" else BF16
    a, b = got[key], jax_out[jkey]
    clear = _unflipped(jax_out, got, key, jkey, dt == "bfloat16")
    if clear is not None:
        assert (clear.sum(0) >= B // 2).all(), clear
        a, b = a[clear], b[clear]
    np.testing.assert_allclose(a, b, **tol)


def _unflipped(jax_out, got, key, jkey, bf16: bool):
    """[B, steps] whether each row's router choices so far equal JAX's
    (a MoE model), else None. A differing choice where JAX's margin is at
    least ROUTE_MARGIN fails, as does any in float32."""
    calls = sorted(k for k in got if k.startswith(key + ":route:"))
    if not calls:
        return None
    steps = got[key].shape[1]
    bad = np.zeros(B, bool)
    clear = np.zeros((B, steps), bool)
    n = 0
    for t in range(steps):
        c = 0
        while f"{key}:route:{t}:{c}" in got:
            idx = got[f"{key}:route:{t}:{c}"]
            probs = jax_out[f"{jkey}:probs:{t}:{c}"]
            k = idx.shape[-1]
            order = np.argsort(-probs, axis=-1, kind="stable")
            top = np.take_along_axis(probs, order, -1)
            margin = top[..., k - 1] - top[..., k]
            flip = (np.sort(order[..., :k], -1) != np.sort(idx, -1)).any(-1)
            assert not (flip & ((margin >= ROUTE_MARGIN) | (not bf16))).any(
            ), (t, c, np.argwhere(flip), margin[flip])
            bad |= flip.any(-1)
            c += 1
            n += 1
        clear[:, t] = ~bad
    assert n == len(calls) == sum(1 for k in jax_out
                                  if k.startswith(jkey + ":probs:"))
    return clear


@pytest.mark.parametrize("case", [c for c in cases() if c[3] == "float32"],
                         ids=lambda c: tag(*c))
def test_sharded_state_is_the_unsharded_state(runs, case):
    """Every layer's decode state gathered from the ranks' blocks equals
    the unsharded port's after the same prefill and steps; the logits
    too."""
    _, got = runs
    arch, _, _, dt = case
    key = tag(*case)
    one = f"{arch}:one:{dt}"
    n = sum(1 for k in got if k.startswith(one + ":state:"))
    assert n and n == sum(1 for k in got if k.startswith(key + ":state:"))
    t = 0
    while f"{key}:route:{t}:0" in got:          # the same MoE choices
        c = 0
        while f"{key}:route:{t}:{c}" in got:
            np.testing.assert_array_equal(
                np.sort(got[f"{key}:route:{t}:{c}"], -1),
                np.sort(got[f"{one}:route:{t}:{c}"], -1))
            c += 1
        t += 1
    for i in range(n):
        a, b = got[f"{key}:state:{i}"], got[f"{one}:state:{i}"]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=STATE_F32 * np.abs(b).max())
    np.testing.assert_allclose(got[key], got[one], **F32)


def test_uncut_batch_is_whole_on_every_rank(runs):
    """B 2 at mesh (4, 2): the batch axes (4) do not divide it, so every
    rank serves both rows (``_batch_spec`` None), as the unsharded run."""
    _, got = runs
    np.testing.assert_allclose(got["b2"], got["internlm2-1.8b:one:float32"]
                               [:2], **F32)


# -- decode_state_specs and _batch_spec ------------------------------------------

class _Mesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


SPEC_MESHES = {"4x2": ((4, 2), ("data", "model")),
               "1x8": ((1, 8), ("data", "model")),
               "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
               "16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def jax_dryrun():
    """The JAX dry-run module, imported with ``XLA_FLAGS`` restored after
    its first lines set 512 devices (JAX is initialized already in this
    process, and subprocesses must not inherit the flag)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as D
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return D


def _jax_state_specs(tree, cfg) -> list:
    """JAX's ``decode_state_specs`` tree as the port's per-layer list of
    pairs, each spec a tuple without the group axis."""
    groups = tree["groups"]
    n_pre = len(tree.get("prefix", []))
    pat = cfg.layer_pattern()
    out = [tuple(tuple(s) for s in ((d["kv"]["k"], d["kv"]["v"])
                                    if "kv" in d else
                                    (d["ssm"]["conv"], d["ssm"]["h"])))
           for d in tree.get("prefix", [])]
    for li in range(n_pre, cfg.n_layers):
        d = groups[(li - n_pre) % len(pat)]
        pair = ((d["kv"]["k"], d["kv"]["v"]) if "kv" in d
                else (d["ssm"]["conv"], d["ssm"]["h"]))
        out.append(tuple(tuple(s)[1:] for s in pair))
    return out


@pytest.mark.parametrize("mesh_name", list(SPEC_MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_decode_state_specs_equal_jax(jax_dryrun, mesh_name, smoke):
    mesh = _Mesh(*SPEC_MESHES[mesh_name])
    for arch in list_archs():
        jcfg = (jax_get_smoke_config if smoke else jax_get_config)(arch)
        cfg = (get_smoke_config if smoke else get_config)(arch)
        jr, r = jax_make_rules(mesh, jcfg), SH.make_rules(mesh, cfg)
        for b in (1, 8, 128):
            assert SH._batch_spec(r, b) == jax_dryrun._batch_spec(jr, b)
            want = _jax_state_specs(
                jax_dryrun.decode_state_specs(jcfg, jr, b), jcfg)
            got = SH.decode_state_specs(cfg, r, b)
            assert _canon(got) == _canon(want), (arch, b)


def _canon(specs):
    """Each spec entry as its tuple of mesh axes (JAX writes a one-axis
    tuple as the axis's name)."""
    return [tuple(tuple(SH.spec_axes(e) for e in s) for s in pair)
            for pair in specs]


# -- the flash kernel's lse and the merge -----------------------------------------

def _np_lse(q, k, kv_len, causal):
    """float64 numpy log-sum-exp of each row's scaled scores, [B, Sq, H]."""
    q, k = q.astype(np.float64), k.astype(np.float64)
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    kk = np.repeat(k, G, axis=2)
    s = np.einsum("bqhd,bkhd->bqhk", q, kk) * hd ** -0.5
    kpos = np.arange(k.shape[1])
    qpos = np.arange(Sq) + kv_len - Sq
    mask = kpos[None, :] < kv_len
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    s = np.where(mask[None, :, None, :], s, -np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.logaddexp.reduce(s, axis=-1)


@pytest.mark.parametrize("kv_len", [0, 1, 37, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_plain_lse_matches_numpy(kv_len, causal, G):
    """``flash_attention_ref(return_lse=True)`` and
    ``flash_attention_split_ref`` on the keys [:kv_len]: lse within 1e-5
    of numpy's float64 log-sum-exp (−inf where no key is seen, with the
    output 0 there)."""
    rng = np.random.default_rng(kv_len + 10 * G)
    q = rng.standard_normal((2, 1, 2 * G, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    want = _np_lse(q, k, kv_len, causal)
    t = lambda a: torch.from_numpy(a)
    out, lse = flash_attention_ref(
        t(q), t(k), t(v), causal=causal,
        kv_len=torch.tensor(kv_len, dtype=torch.int32), return_lse=True)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    if kv_len == 0:
        assert torch.isneginf(lse).all() and not out.isnan().any()
        assert (out == 0).all()
        return
    o2, lse2 = flash_attention_split_ref(
        t(q), t(k[:, :kv_len]), t(v[:, :kv_len]), causal=causal, chunk=16,
        return_lse=True)
    np.testing.assert_allclose(lse2.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(o2.numpy(), out.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("kv_len", [1, 20, 96])
def test_block_merge_equals_the_uncut_attention(P, kv_len):
    """A cache of 96 rows cut into P sequence blocks (those past kv_len
    see no key: local kv_len 0), each block's plain attention with its
    lse, merged by ``merge_partials_local``: within 1e-5 of the uncut
    attention at kv_len (float32), as each rank computes it under
    ``kv_seq``."""
    rng = np.random.default_rng(P * 100 + kv_len)
    B, H, KV, hd, n = 3, 8, 2, 16, 96
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, n, KV, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, n, KV, hd), np.float32))
    L = torch.tensor(kv_len, dtype=torch.int32)
    want = flash_attention_ref(q, k, v, causal=True, kv_len=L)
    blk = n // P
    outs, lses = [], []
    for r in range(P):
        local = (L - r * blk).clamp(0, blk).to(torch.int32)
        o, lse = flash_attention_ref(q, k[:, r * blk:(r + 1) * blk],
                                     v[:, r * blk:(r + 1) * blk],
                                     causal=True, kv_len=local,
                                     return_lse=True)
        outs.append(o)
        lses.append(lse)
    got = comm.merge_partials_local(torch.stack(outs), torch.stack(lses))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_merge_of_nothing_is_zero():
    """Partials that all saw no key (lse −inf) merge to 0, not NaN."""
    out = torch.zeros(3, 2, 1, 4, 8)
    lse = torch.full((3, 2, 1, 4), float("-inf"))
    got = comm.merge_partials_local(out, lse)
    assert (got == 0).all()


def test_flash_meta_route_launches_nothing():
    """A meta tensor gets empty meta outputs of the kernel's shapes (and
    lse float32 [B, Sq, H]) and no launch is counted."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    before = dict(_build.launches)
    q = torch.empty(2, 1, 8, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 40, 2, 64, dtype=torch.bfloat16, device="meta")
    out, lse = flash_attention(q, k, k, return_lse=True)
    assert out.device.type == lse.device.type == "meta"
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert lse.shape == (2, 1, 8) and lse.dtype == torch.float32
    assert flash_attention(q, k, k).shape == q.shape
    assert dict(_build.launches) == before


def test_decode_graph_refuses_a_mesh():
    """A ``DecodeGraph`` built under rules raises (NCCL inside a CUDA
    graph capture is untried); sharded decode runs eagerly."""
    cfg = get_smoke_config("internlm2-1.8b")
    model = M.LM(cfg, device="meta")
    rules = SH.make_rules(_Mesh((1, 1), ("data", "model")), cfg)
    with SH.use_shardings(rules.mesh, rules):
        with pytest.raises(NotImplementedError, match="eagerly"):
            M.DecodeGraph(model, 1, 8)
