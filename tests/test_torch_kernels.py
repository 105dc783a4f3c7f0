"""The port's plain kernel versions (repro_torch.kernels.ref, which the
CUDA wrappers use on CPU tensors) against the JAX package's Pallas
kernels in interpret mode and its jnp oracle, for all four G-chain entry
points at every ladder cut.

Tolerance: f32, ``1e-5 * max(1, max|y|)`` — the two sides round the
stage FMAs in different orders across up to 2S stages, and operator
outputs scale with the spectrum.  The Pallas kernels cannot run an empty
(0-stage) cut, so the 0 cut is held to the jnp oracle only."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import staging as jst
from repro.core.types import GFactors as JG
from repro.kernels import butterfly as jbf
from repro.kernels import ref as jref
from repro_torch.core import staging as tst
from repro_torch.core.types import GFactors
from repro_torch.kernels import butterfly as bf
from repro_torch.kernels import launcher

SIZES = [(16, 3, 64), (48, 2, 160)]      # (n, B, g)


def _fit(n, batch, g):
    """Tables of random valid G chains, packed by both packers (bitwise
    equal, tests/test_torch_staging.py), plus a random spectrum."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, n, (batch, g))
    b = (a + rng.integers(1, n, (batch, g))) % n
    theta = rng.uniform(-np.pi, np.pi, (batch, g))
    fields = (np.minimum(a, b).astype(np.int32),
              np.maximum(a, b).astype(np.int32),
              np.cos(theta).astype(np.float32),
              np.sin(theta).astype(np.float32),
              rng.choice([-1.0, 1.0], (batch, g)).astype(np.float32))
    jfwd, jadj = jst.pack_g_batch_pair(JG(*map(jnp.asarray, fields)), n)
    jsfwd, jsadj = jst.pack_g_pair(JG(*(jnp.asarray(f[0]) for f in fields)),
                                   n=n)
    fwd, adj = tst.pack_g_batch_pair(GFactors(*fields), n, device="cpu")
    sfwd, sadj = tst.pack_g_pair(GFactors(*(f[0] for f in fields)), n=n,
                                 device="cpu")
    diag = rng.uniform(0.0, 2.0 * n, (batch, n)).astype(np.float32)
    return dict(jfwd=jfwd, jadj=jadj, fwd=fwd, adj=adj, sfwd=sfwd,
                sadj=sadj, jsfwd=jsfwd, jsadj=jsadj, diag=diag)


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"n{s[0]}")
def fitted(request):
    n, batch, g = request.param
    return n, batch, _fit(n, batch, g)


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
def test_batched_butterfly_apply(fitted, keep):
    n, batch, f = fitted
    x = _signal((batch, 130, n))
    for k in _cuts(f["fwd"]):
        got = bf.batched_butterfly_apply(f["fwd"], torch.from_numpy(x), k,
                                         keep)
        _close(got, jref.batched_g_apply(f["jfwd"], jnp.asarray(x), k,
                                         keep))
        if k and n == 16:
            _close(got, jbf.batched_butterfly_apply(
                f["jfwd"], jnp.asarray(x), interpret=True, num_stages=k,
                keep=keep))


@pytest.mark.parametrize("keep", ["head", "tail"])
def test_butterfly_apply(fitted, keep):
    n, _, f = fitted
    x = _signal((130, n))
    for k in _cuts(f["sfwd"]):
        got = bf.butterfly_apply(f["sfwd"], torch.from_numpy(x), k, keep)
        _close(got, jref.staged_g_apply(f["jsfwd"], jnp.asarray(x), k, keep))
        if k and n == 16:
            _close(got, jbf.butterfly_apply(f["jsfwd"], jnp.asarray(x),
                                            interpret=True, num_stages=k,
                                            keep=keep))


def test_batched_sym_operator_apply(fitted):
    n, batch, f = fitted
    x = _signal((batch, 130, n))
    d = torch.from_numpy(f["diag"])
    for k in _cuts(f["fwd"]):
        got = bf.batched_sym_operator_apply(f["fwd"], f["adj"], d,
                                            torch.from_numpy(x), k)
        jd = jnp.asarray(f["diag"])
        _close(got, jref.batched_sym_operator_apply(
            f["jfwd"], f["jadj"], jd, jnp.asarray(x), k))
        if k and n == 16:
            _close(got, jbf.batched_sym_operator_apply(
                f["jfwd"], f["jadj"], jd, jnp.asarray(x), interpret=True,
                num_stages=k))


def test_sym_operator_apply(fitted):
    n, _, f = fitted
    x = _signal((130, n))
    d = f["diag"][0]
    for k in _cuts(f["sfwd"]):
        got = bf.sym_operator_apply(f["sfwd"], f["sadj"], torch.from_numpy(d),
                                    torch.from_numpy(x), k)
        _close(got, jref.sym_operator_apply(f["jsfwd"], f["jsadj"],
                                            jnp.asarray(d), jnp.asarray(x), k))
        if k and n == 16:
            _close(got, jbf.sym_operator_apply(
                f["jsfwd"], f["jsadj"], jnp.asarray(d), jnp.asarray(x),
                interpret=True, num_stages=k))


def test_plain_versions_keep_shapes_and_inputs(fitted):
    n, batch, f = fitted
    x = torch.from_numpy(_signal((batch, 2, 5, n)))
    x0 = x.clone()
    y = bf.batched_butterfly_apply(f["fwd"], x)
    assert y.shape == x.shape and torch.equal(x, x0)
    y = bf.batched_sym_operator_apply(f["fwd"], f["adj"],
                                      torch.from_numpy(f["diag"]), x)
    assert y.shape == x.shape and torch.equal(x, x0)


def test_plain_versions_launch_no_kernel(fitted):
    """CPU tensors take the plain versions: no entry point counts a
    launch."""
    n, batch, f = fitted
    x = torch.from_numpy(_signal((batch, 4, n)))
    d = torch.from_numpy(f["diag"])
    launcher.reset_launch_counts()
    bf.batched_butterfly_apply(f["fwd"], x)
    bf.butterfly_apply(f["sfwd"], x[0])
    bf.batched_sym_operator_apply(f["fwd"], f["adj"], d, x)
    bf.sym_operator_apply(f["sfwd"], f["sadj"], d[0], x[0])
    assert set(launcher.entry_launch_counts().values()) == {0}
    assert launcher.launch_counts() == dict.fromkeys(launcher.KERNELS, 0)


def test_argument_validation(fitted):
    n, batch, f = fitted
    s_tot = f["fwd"].num_stages
    assert launcher._leg_range(s_tot, None, "head") == (0, s_tot)
    assert launcher._leg_range(s_tot, 3, "tail") == (s_tot - 3, 3)
    assert launcher._leg_range(s_tot, 0, "tail") == (s_tot, 0)
    with pytest.raises(ValueError):
        launcher._leg_range(s_tot, s_tot + 1, "head")
    with pytest.raises(ValueError):
        launcher._leg_range(s_tot, 2, "middle")
    cpu = torch.device("cpu")
    assert launcher._check_tables(f["fwd"], cpu, batch, n, "t") == tuple(
        f["fwd"].idx_i.shape[1:])
    with pytest.raises(ValueError, match="do not match"):
        launcher._check_tables(f["fwd"], cpu, batch + 1, n, "t")
    with pytest.raises(ValueError, match="n="):
        launcher._check_tables(f["fwd"], cpu, batch, n + 1, "t")
    with pytest.raises(TypeError, match="int32"):
        launcher._check_tables(f["fwd"]._replace(idx_i=f["fwd"].idx_i.long()),
                         cpu, batch, n, "t")
    with pytest.raises(TypeError, match="float32"):
        launcher._check_tables(f["fwd"]._replace(c=f["fwd"].c.double()),
                         cpu, batch, n, "t")
    with pytest.raises(ValueError, match="contiguous"):
        launcher._check_tables(tst.truncate_staged(f["fwd"], 2, "tail"), cpu,
                         batch, n, "t")
    with pytest.raises(ValueError, match="CUDA"):
        launcher._check_signal(torch.zeros(batch, 4, n), 3, "t")
