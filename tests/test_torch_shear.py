"""The port's plain T-chain versions (repro_torch.kernels.ref, which the
CUDA wrappers of kernels/shear.py use on CPU tensors) against the JAX
package's Pallas kernels in interpret mode and its jnp oracle, for all
four T-chain entry points at every ladder cut, single and batched.

Tolerance: f32, ``1e-5 * max(1, max|y|)`` — the two sides round the
stage products in different orders across up to 2S stages, and operator
outputs scale with the spectrum.  The Pallas kernels cannot run an empty
(0-stage) cut, so the 0 cut is held to the jnp oracle only."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import staging as jst
from repro.core.types import TFactors as JT
from repro.kernels import ref as jref
from repro.kernels import shear as jsh
from repro_torch.core import staging as tst
from repro_torch.core.types import TFactors
from repro_torch.kernels import launcher
from repro_torch.kernels import shear as sh
from repro_torch.kernels.plan import ApplyPlan

SIZES = [(16, 3, 64), (48, 2, 160)]      # (n, B, m)


def t_chain(n, m, seed, batch=None):
    """Random valid T chains as numpy fields: scalings (j == i) by
    +-[0.8, 1.25], shears (j != i) by [-0.5, 0.5] — conditioned like a
    fit's chains."""
    rng = np.random.default_rng(seed)
    shape = (m,) if batch is None else (batch, m)
    kind = rng.integers(0, 2, shape).astype(np.int32)
    i = rng.integers(0, n, shape).astype(np.int32)
    j = np.where(kind == 0, i, (i + rng.integers(1, n, shape)) % n)
    scale = rng.uniform(0.8, 1.25, shape) * rng.choice([-1.0, 1.0], shape)
    a = np.where(kind == 0, scale, rng.uniform(-0.5, 0.5, shape))
    return kind, i, j.astype(np.int32), a.astype(np.float32)


def _fit(n, batch, m):
    fields = t_chain(n, m, seed=n, batch=batch)
    jfwd, jinv = jst.pack_t_batch_pair(JT(*map(jnp.asarray, fields)), n)
    jsfwd, jsinv = jst.pack_t_pair(JT(*(jnp.asarray(f[0]) for f in fields)),
                                   n)
    fwd, inv = tst.pack_t_batch_pair(TFactors(*fields), n, device="cpu")
    sfwd, sinv = tst.pack_t_pair(TFactors(*(f[0] for f in fields)), n,
                                 device="cpu")
    diag = np.random.default_rng(n + 1).uniform(
        0.0, 2.0 * n, (batch, n)).astype(np.float32)
    return dict(jfwd=jfwd, jinv=jinv, fwd=fwd, inv=inv, sfwd=sfwd,
                sinv=sinv, jsfwd=jsfwd, jsinv=jsinv, diag=diag)


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"n{s[0]}")
def fitted(request):
    n, batch, m = request.param
    return n, batch, _fit(n, batch, m)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _signal(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cuts(staged):
    return sorted({0, *staged.cuts[:, 0].tolist()})


@pytest.mark.parametrize("keep", ["head", "tail"])
def test_batched_shear_apply(fitted, keep):
    n, batch, f = fitted
    x = _signal((batch, 130, n))
    for k in _cuts(f["fwd"]):
        for t, jt in ((f["fwd"], f["jfwd"]), (f["inv"], f["jinv"])):
            got = sh.batched_shear_apply(t, torch.from_numpy(x), k, keep)
            _close(got, jref.batched_t_apply(jt, jnp.asarray(x), k, keep))
            if k and n == 16:
                _close(got, jsh.batched_shear_apply(
                    jt, jnp.asarray(x), interpret=True, num_stages=k,
                    keep=keep))


@pytest.mark.parametrize("keep", ["head", "tail"])
def test_shear_apply(fitted, keep):
    n, _, f = fitted
    x = _signal((130, n))
    for k in _cuts(f["sfwd"]):
        for t, jt in ((f["sfwd"], f["jsfwd"]), (f["sinv"], f["jsinv"])):
            got = sh.shear_apply(t, torch.from_numpy(x), k, keep)
            _close(got, jref.staged_t_apply(jt, jnp.asarray(x), k, keep))
            if k and n == 16:
                _close(got, jsh.shear_apply(jt, jnp.asarray(x),
                                            interpret=True, num_stages=k,
                                            keep=keep))


def test_batched_gen_operator_apply(fitted):
    n, batch, f = fitted
    x = _signal((batch, 130, n))
    d, jd = torch.from_numpy(f["diag"]), jnp.asarray(f["diag"])
    for k in _cuts(f["fwd"]):
        got = sh.batched_gen_operator_apply(f["fwd"], f["inv"], d,
                                            torch.from_numpy(x), k)
        _close(got, jref.batched_gen_operator_apply(
            f["jfwd"], f["jinv"], jd, jnp.asarray(x), k))
        if k and n == 16:
            _close(got, jsh.batched_gen_operator_apply(
                f["jfwd"], f["jinv"], jd, jnp.asarray(x), interpret=True,
                num_stages=k))


def test_gen_operator_apply(fitted):
    n, _, f = fitted
    x = _signal((130, n))
    d = f["diag"][0]
    for k in _cuts(f["sfwd"]):
        got = sh.gen_operator_apply(f["sfwd"], f["sinv"], torch.from_numpy(d),
                                    torch.from_numpy(x), k)
        _close(got, jref.gen_operator_apply(f["jsfwd"], f["jsinv"],
                                            jnp.asarray(d), jnp.asarray(x),
                                            k))
        if k and n == 16:
            _close(got, jsh.gen_operator_apply(
                f["jsfwd"], f["jsinv"], jnp.asarray(d), jnp.asarray(x),
                interpret=True, num_stages=k))


def test_inverse_tables_invert_the_chain(fitted):
    """Tbar^{-1} Tbar x = x at the full chain (up to f32 rounding)."""
    n, batch, f = fitted
    x = torch.from_numpy(_signal((batch, 7, n)))
    y = sh.batched_shear_apply(f["inv"], sh.batched_shear_apply(f["fwd"], x))
    _close(y, x)
    ones = torch.ones((batch, n))
    _close(sh.batched_gen_operator_apply(f["fwd"], f["inv"], ones, x), x)


def test_plain_versions_keep_shapes_and_launch_no_kernel(fitted):
    """CPU tensors take the plain versions: inputs untouched, shapes
    kept, and no entry point counts a launch."""
    n, batch, f = fitted
    x = torch.from_numpy(_signal((batch, 2, 5, n)))
    x0 = x.clone()
    d = torch.from_numpy(f["diag"])
    launcher.reset_launch_counts()
    assert sh.batched_shear_apply(f["fwd"], x).shape == x.shape
    assert sh.batched_gen_operator_apply(f["fwd"], f["inv"], d,
                                         x).shape == x.shape
    sh.shear_apply(f["sfwd"], x[0, 0])
    sh.gen_operator_apply(f["sfwd"], f["sinv"], d[0], x[0, 0])
    assert torch.equal(x, x0)
    assert set(launcher.entry_launch_counts().values()) == {0}
    assert launcher.launch_counts() == dict.fromkeys(launcher.KERNELS, 0)


@pytest.mark.parametrize("fused", [True, False])
def test_general_plans_match_jax_plans(fitted, fused):
    """The port's "general" ApplyPlan (CPU backend "torch") against the
    JAX package's plan on its xla backend: apply at both keeps and the
    operator, fused and three-pass, at every cut."""
    from repro.kernels.plan import ApplyPlan as JaxPlan
    n, batch, f = fitted
    x = _signal((batch, 3, 4, n))
    d, jd = torch.from_numpy(f["diag"]), jnp.asarray(f["diag"])
    for k in _cuts(f["fwd"]):
        op = ApplyPlan.for_staged(f["fwd"], "operator", num_stages=k,
                                  fused=fused)
        assert op.family == "general" and op.backend == "torch"
        jop = JaxPlan.for_staged(f["jfwd"], "operator", backend="xla",
                                 num_stages=k, fused=fused)
        _close(op.operator(f["fwd"], f["inv"], d, torch.from_numpy(x)),
               jop.operator(f["jfwd"], f["jinv"], jd, jnp.asarray(x)))
        for keep in ("head", "tail"):
            ap = ApplyPlan.for_staged(f["inv"], "apply", num_stages=k,
                                      keep=keep)
            jap = JaxPlan.for_staged(f["jinv"], "apply", backend="xla",
                                     num_stages=k, keep=keep)
            _close(ap.apply(f["inv"], torch.from_numpy(x)),
                   jap.apply(f["jinv"], jnp.asarray(x)))


def test_wrapper_validation_for_t_tables(fitted):
    n, batch, f = fitted
    cpu = torch.device("cpu")
    assert launcher._check_tables(f["fwd"], cpu, batch, n, "t") == tuple(
        f["fwd"].idx_i.shape[1:])
    with pytest.raises(TypeError, match="float32"):
        launcher._check_tables(f["fwd"]._replace(beta=f["fwd"].beta.double()),
                         cpu, batch, n, "t")
    with pytest.raises(ValueError, match="do not match"):
        launcher._check_tables(f["sfwd"], cpu, batch, n, "t")
    with pytest.raises(ValueError, match="diag shape"):
        launcher._check_diag(torch.ones(n + 1), torch.zeros((1, 2, n)), False,
                             "t_operator_kernel")
    x = torch.zeros((batch, 4, n), device="meta")
    meta = tst.StagedT(*(t.to("meta") for t in f["fwd"][:4]),
                       f["fwd"].cuts, n)
    with pytest.raises(ValueError, match="CUDA"):
        sh.batched_shear_apply(meta, x)
    with pytest.raises(ValueError, match="CUDA"):
        sh.batched_gen_operator_apply(meta, meta, torch.ones(
            (batch, n), device="meta"), x)
