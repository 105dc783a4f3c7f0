"""The port's butterfly layers and compressed projections
(``repro_torch.core.fastlinear``) against the JAX package's on the CPU.

The JAX package's own cases (tests/test_fastlinear.py) run on the port.
Then parity on carried parameters (``repro_torch.interop``; the port's
draws are torch's, not ``jax.random``'s), inputs from numpy seeds:
``fft_pattern`` bitwise; ``butterfly_apply`` forward within 1e-6 and its
gradients in theta, d and x within 1e-5 of ``jax.grad`` — at widths that
are not a power of two too, where a stage carries several no-op pad
pairs on one index (n = 12, 20: 2 a stage; n = 24: 4); ``compress_linear``'s
``rel_err`` within 5% relative of the JAX fit's; the JAX package's
``CompressedLinear`` tables bitwise from the carried factors, and
``compressed_linear_apply`` within 1e-5 of the JAX call on both of its
backends (``"pallas"`` in interpret mode)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import fastlinear as jfl
from repro.core import baselines as jbl
from repro.core import gtransform as jgt
from repro.core.staging import pack_g, pack_g_adjoint
from repro_torch.core import (ButterflyParams, CompressedLinear,
                              butterfly_apply, butterfly_init,
                              compress_linear, compressed_linear_apply,
                              fft_pattern)
from repro_torch.core.staging import table_arrays
from repro_torch.interop import (butterfly_params_from_numpy,
                                 compressed_linear_from_numpy)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the JAX package's cases, on the port ---------------------------------

def test_fft_pattern_conflict_free():
    pat = fft_pattern(32, device="cpu")
    ii, jj = pat.idx_i.numpy(), pat.idx_j.numpy()
    for s in range(ii.shape[0]):
        touched = []
        for a, b in zip(ii[s], jj[s]):
            if a == b:
                continue
            touched.extend([int(a), int(b)])
        assert len(touched) == len(set(touched))


def test_butterfly_mix_orthonormal():
    pat = fft_pattern(16, device="cpu")
    params = butterfly_init(_gen(0), pat)
    x = torch.from_numpy(_x((4, 16), 0))
    y = butterfly_apply(params, pat, x, mix_only=True)
    np.testing.assert_allclose(y.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), rtol=1e-5)


def test_butterfly_symmetric_op():
    """U diag(d) U^T is symmetric PSD when d >= 0."""
    n = 16
    pat = fft_pattern(n, device="cpu")
    params = butterfly_init(_gen(1), pat)
    params = ButterflyParams(theta=params.theta,
                             diag=params.diag.abs() + 0.5)
    mat = butterfly_apply(params, pat, torch.eye(n)).numpy()
    np.testing.assert_allclose(mat, mat.T, atol=1e-5)
    assert np.linalg.eigvalsh(mat).min() > 0


def test_butterfly_gradients_flow():
    pat = fft_pattern(16, device="cpu")
    params = butterfly_init(_gen(2), pat)
    theta = params.theta.clone().requires_grad_(True)
    diag = params.diag.clone().requires_grad_(True)
    loss = (butterfly_apply(ButterflyParams(theta, diag), pat,
                            torch.ones((2, 16))) ** 2).sum()
    loss.backward()
    assert float(theta.grad.abs().sum()) > 0
    assert float(diag.grad.abs().sum()) > 0


def test_compress_linear_reconstruction_improves():
    rng = np.random.default_rng(3)
    n = 24
    w = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    _, info_small = compress_linear(w, g_orth=16, g_sym=16, n_iter=2)
    comp, info_big = compress_linear(w, g_orth=120, g_sym=120, n_iter=3)
    assert info_big["rel_err"] < info_small["rel_err"]
    x = torch.from_numpy(rng.standard_normal((5, n)).astype(np.float32))
    y = compressed_linear_apply(comp, x)
    assert bool(torch.isfinite(y).all())


def test_odd_sized_pattern_handles_padding():
    pat = fft_pattern(18, device="cpu")  # non power of two, even
    params = butterfly_init(_gen(4), pat)
    x = torch.from_numpy(_x((3, 18), 5))
    y = butterfly_apply(params, pat, x, mix_only=True)
    np.testing.assert_allclose(y.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), rtol=1e-4)


# -- parity with the JAX package ------------------------------------------

@pytest.mark.parametrize("n", [12, 16, 18, 20, 24, 32])
def test_fft_pattern_bitwise(n):
    jp = jfl.fft_pattern(n)
    tp = fft_pattern(n, device="cpu")
    assert tp.n == jp.n == n
    for t, j in ((tp.idx_i, jp.idx_i), (tp.idx_j, jp.idx_j)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_fft_pattern_rejects_odd_width():
    with pytest.raises(ValueError, match="even width"):
        fft_pattern(7, device="cpu")


def _carried(n, seed):
    """The same layer on both sides: JAX params (init, then a random
    diagonal) carried to the port."""
    jp = jfl.butterfly_init(jax.random.PRNGKey(seed), jfl.fft_pattern(n))
    jp = jfl.ButterflyParams(theta=jp.theta * 10.0,
                             diag=jnp.asarray(_x((n,), seed + 1)))
    tp = butterfly_params_from_numpy(np.asarray(jp.theta),
                                     np.asarray(jp.diag), device="cpu")
    return jp, tp


@pytest.mark.parametrize("mix_only", [False, True])
@pytest.mark.parametrize("n", [12, 16, 18, 20, 24])
def test_butterfly_forward_matches_jax(n, mix_only):
    jp, tp = _carried(n, n)
    x = _x((5, n), n + 2)
    want = np.asarray(jfl.butterfly_apply(jp, jfl.fft_pattern(n),
                                          jnp.asarray(x), mix_only))
    got = butterfly_apply(tp, fft_pattern(n, device="cpu"),
                          torch.from_numpy(x), mix_only).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("mix_only", [False, True])
@pytest.mark.parametrize("n", [12, 16, 20, 24])
def test_butterfly_gradients_match_jax(n, mix_only):
    """d/dtheta, d/dd and d/dx of a loss against jax.grad; at n = 12, 20
    and 24 the pattern pads stages with several no-op pairs on one
    index."""
    jpat = jfl.fft_pattern(n)
    pads = (np.asarray(jpat.idx_i) == np.asarray(jpat.idx_j)).sum(1)
    assert pads.max() == {12: 2, 16: 0, 20: 2, 24: 4}[n]
    jp, tp = _carried(n, 2 * n)
    x = _x((3, n), n)
    wgt = _x((3, n), n + 1)

    def jloss(theta, diag, xx):
        y = jfl.butterfly_apply(jfl.ButterflyParams(theta, diag), jpat, xx,
                                mix_only)
        return jnp.sum(jnp.asarray(wgt) * y) + jnp.sum(y ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jp.theta, jp.diag,
                                              jnp.asarray(x))
    theta = tp.theta.clone().requires_grad_(True)
    diag = tp.diag.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = butterfly_apply(ButterflyParams(theta, diag),
                        fft_pattern(n, device="cpu"), xt, mix_only)
    (torch.sum(torch.from_numpy(wgt) * y) + torch.sum(y ** 2)).backward()
    if mix_only:                   # U(theta) x does not read the diagonal
        assert diag.grad is None and not np.asarray(want[1]).any()
    for got, w in zip((theta.grad, diag.grad, xt.grad), want):
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       atol=1e-5)


def _w(n, seed):
    """A square projection with a decaying spectrum."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((u * np.exp(-np.arange(n) / (n / 4))) @ v.T).astype(np.float32)


def test_compress_linear_rel_err_matches_jax():
    n = 24
    w = _w(n, 11)
    _, jinfo = jfl.compress_linear(jnp.asarray(w), g_orth=120, g_sym=120,
                                   n_iter=3)
    comp, info = compress_linear(torch.from_numpy(w), g_orth=120,
                                 g_sym=120, n_iter=3)
    assert abs(info["rel_err"] - jinfo["rel_err"]) <= \
        0.05 * jinfo["rel_err"], (info, jinfo)
    assert isinstance(comp, CompressedLinear)
    assert comp.q_fwd.n == comp.h_fwd.n == comp.h_adj.n == n
    assert comp.diag.dtype == torch.float32


def _jax_compressed(w, g_orth, g_sym, n_iter):
    """The JAX package's compress_linear pieces: its factors and bundle."""
    u, sv, vt = np.linalg.svd(w.astype(np.float64))
    q = (u @ vt).astype(np.float32)
    h = ((vt.T * sv[None, :]) @ vt).astype(np.float32)
    qf = jbl.factorize_orthonormal(jnp.asarray(q), g_orth)
    hf, sbar, _ = jgt.approximate_symmetric(jnp.asarray(h), g=g_sym,
                                            n_iter=n_iter)
    comp = jfl.CompressedLinear(q_fwd=pack_g(qf), h_fwd=pack_g(hf),
                                h_adj=pack_g_adjoint(hf), diag=sbar)
    return qf, hf, sbar, comp


@pytest.mark.parametrize("n,g", [(16, 64), (24, 120)])
def test_compressed_linear_apply_matches_jax(n, g):
    w = _w(n, n)
    qf, hf, sbar, jcomp = _jax_compressed(w, g, g, 2)
    fields = "i j c s sigma".split()
    comp = compressed_linear_from_numpy(
        {f: np.asarray(v) for f, v in zip(fields, qf)},
        {f: np.asarray(v) for f, v in zip(fields, hf)},
        np.asarray(sbar), n, device="cpu")
    for tt, jt in ((comp.q_fwd, jcomp.q_fwd), (comp.h_fwd, jcomp.h_fwd),
                   (comp.h_adj, jcomp.h_adj)):
        assert tt.n == jt.n == n
        for a, b in zip(table_arrays(tt), jt[:5]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tt.cuts, np.asarray(jt.cuts))
    x = _x((7, n), n + 3)
    got = compressed_linear_apply(comp, torch.from_numpy(x)).numpy()
    for backend in ("xla", "pallas"):
        want = np.asarray(jfl.compressed_linear_apply(jcomp, jnp.asarray(x),
                                                      backend=backend))
        np.testing.assert_allclose(got, want, atol=1e-5)
    # leading axes pass through
    got3 = compressed_linear_apply(comp, torch.from_numpy(
        x.reshape(1, 7, n))).numpy()
    np.testing.assert_allclose(got3[0], got, atol=1e-6)


def test_carried_params_are_checked():
    with pytest.raises(ValueError, match="not"):
        butterfly_params_from_numpy(np.zeros((3, 4)), np.zeros(7),
                                    device="cpu")
    with pytest.raises(ValueError, match="lack fields"):
        compressed_linear_from_numpy({"i": np.zeros(1)}, {}, np.zeros(4), 4,
                                     device="cpu")
