"""The port's general-case (T-transform) fit against the JAX package's
``repro.core.ttransform`` on the CPU.

Tolerances, each with its reason:
  * given-factor pieces (``tapply``, ``t_to_dense``, ``t_reconstruct``,
    ``t_objective``, ``lemma2_spectrum``, the polynomial helpers):
    ``1e-5`` relative to ``max(1, max|y|)`` — both sides round the same
    f32 operations in different orders;
  * the greedy scores on a given state B: parameters to ``1e-5``
    relative; scale scores to ``1e-5`` of the score's largest term
    (``N_i + M_i``), because ``phi`` sums terms of that size in f32 and
    cancels them down to the (much smaller) score;
  * fits: greedy chains part ways on f32 near-ties (a graph Laplacian has
    many exactly tied pair scores), as the JAX package's own batched and
    single fits do, so a fit is held to the JAX fit's objective: each
    matrix within 5% relative, and the per-matrix iteration counts of
    the refinement loop equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import eigenbasis as jeb
from repro.core import fgft as jfgft
from repro.core import polyutil as jpu
from repro.core import ttransform as jt
from repro.core.types import TFactors as JT
from repro.graphs import community_graph as j_community
from repro.graphs import directed_variant as j_directed
from repro_torch.core import ApproxEigenbasis, build_fgft, laplacian
from repro_torch.core import polyutil as pu
from repro_torch.core import ttransform as tt
from repro_torch.core.fgft import prefix_relative_error, relative_error
from repro_torch.core.types import SCALE, TFactors, tfactors_identity
from repro_torch.graphs import community_graph, directed_variant

from test_torch_shear import t_chain

N, B = 16, 3
M = int(2 * N * np.log2(N))


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _directed_laps(n, batch):
    return np.stack([laplacian(directed_variant(community_graph(n, seed=s),
                                                seed=s))
                     for s in range(batch)])


def _factors(n, m, seed):
    fields = t_chain(n, m, seed)
    return JT(*map(jnp.asarray, fields)), TFactors(*map(torch.from_numpy,
                                                        fields))


def test_directed_variant_matches_jax():
    for s in range(3):
        adj = community_graph(24, seed=s)
        np.testing.assert_array_equal(
            directed_variant(adj, seed=s),
            j_directed(j_community(24, seed=s), seed=s))


def test_identity_factors_match_jax():
    j = jt.tfactors_identity(5)
    t = tfactors_identity(5, device="cpu")
    for a, b in zip(j, t):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("n,m", [(16, 60), (32, 200)])
@pytest.mark.parametrize("inverse", [False, True])
def test_given_factor_pieces(n, m, inverse):
    jf, tf = _factors(n, m, seed=n + m)
    x = np.random.default_rng(1).standard_normal((n, 5)).astype(np.float32)
    _close(tt.tapply(tf, torch.from_numpy(x), inverse=inverse, axis=0),
           jt.tapply(jf, jnp.asarray(x), inverse=inverse, axis=0))
    _close(tt.tapply(tf, torch.from_numpy(x.T.copy()), inverse=inverse),
           jt.tapply(jf, jnp.asarray(x.T), inverse=inverse))
    _close(tt.t_to_dense(tf, n, inverse=inverse),
           jt.t_to_dense(jf, n, inverse=inverse))
    cbar = np.random.default_rng(2).uniform(0, 5, n).astype(np.float32)
    _close(tt.t_reconstruct(tf, torch.from_numpy(cbar)),
           jt.t_reconstruct(jf, jnp.asarray(cbar)))
    lap = _directed_laps(n, 1)[0]
    _close(tt.t_objective(torch.from_numpy(lap), tf, torch.from_numpy(cbar)),
           jt.t_objective(jnp.asarray(lap), jf, jnp.asarray(cbar)))
    _close(tt.lemma2_spectrum(torch.from_numpy(lap), tf),
           jt.lemma2_spectrum(jnp.asarray(lap), jf))


def test_batched_pieces_equal_single_ones():
    fields = [t_chain(N, 40, seed=s) for s in range(2)]
    batch = TFactors(*(torch.from_numpy(np.stack(f)) for f in zip(*fields)))
    lap = torch.from_numpy(_directed_laps(N, 2))
    cbar = torch.rand((2, N))
    dense = tt.t_to_dense(batch, N)
    recon = tt.t_reconstruct(batch, cbar)
    spec = tt.lemma2_spectrum(lap, batch)
    for b, f in enumerate(fields):
        tf = TFactors(*map(torch.from_numpy, f))
        _close(dense[b], tt.t_to_dense(tf, N))
        _close(recon[b], tt.t_reconstruct(tf, cbar[b]))
        _close(spec[b], tt.lemma2_spectrum(lap[b], tf))


def test_polynomial_helpers_match_jax():
    rng = np.random.default_rng(0)
    coeffs = [rng.standard_normal(200).astype(np.float32) for _ in range(4)]
    coeffs[0][:20] = 0.0                          # quadratic fallback
    coeffs[1][:10] = 0.0                          # linear fallback
    got = pu.real_cubic_roots(*map(torch.from_numpy, coeffs))
    _close(got, jpu.real_cubic_roots(*map(jnp.asarray, coeffs)))
    a, v = pu.minimize_quartic(*map(torch.from_numpy, coeffs), clip=32.0)
    ja, jv = jpu.minimize_quartic(*map(jnp.asarray, coeffs), clip=32.0)
    _close(v, jv)
    _close(a, ja)
    vals = rng.standard_normal((7, 5)).astype(np.float32)
    _close(pu.fit_quartic(torch.from_numpy(vals)),
           jpu.fit_quartic(jnp.asarray(vals)))


def test_quartic_roots_are_the_companion_eigenvalues():
    """The closed-form quartic roots equal the eigenvalues of the JAX
    package's companion matrix (computed here by numpy in f64)."""
    rng = np.random.default_rng(1)
    c = rng.standard_normal((4, 300))
    c[2] = 0.0                                   # the scale score's Q(a)
    c[:, :5] = [[2.0] * 5, [0.0] * 5, [-1e-3] * 5, [0.0] * 5]   # near-double
    got = tt._quartic_roots(*map(torch.from_numpy, c)).numpy()
    for k in range(c.shape[1]):
        comp = np.zeros((4, 4))
        comp[1, 0] = comp[2, 1] = comp[3, 2] = 1.0
        comp[:, 3] = -c[::-1, k]
        want = np.linalg.eigvals(comp)
        # each eigenvalue has a root within 1e-5 relative
        dist = np.abs(want[:, None] - got[k][None, :]).min(1)
        assert (dist <= 1e-5 * (1 + np.abs(want))).all(), (k, want, got[k])


def _state(seed):
    rng = np.random.default_rng(seed)
    lap = _directed_laps(N, 1)[0]
    cbar = np.asarray(jt.default_cbar(jnp.asarray(lap)))
    bm = (np.diag(cbar) + 0.3 * rng.standard_normal((N, N))).astype(
        np.float32)
    e = lap - bm
    st = (bm, e, e @ bm.T, e.T @ bm, (bm * bm).sum(1), (bm * bm).sum(0))
    return (tuple(map(jnp.asarray, st)),
            tuple(torch.from_numpy(np.ascontiguousarray(x))[None]
                  for x in st))


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_scores_on_a_given_state(seed):
    jstate, tstate = _state(seed)
    ja, jv = jt._shear_scores(*jstate)
    ta, tv = tt._shear_scores(*tstate)
    off = ~np.eye(N, dtype=bool)
    _close(ta[0].numpy()[off], np.asarray(ja)[off])
    _close(tv[0].numpy()[off], np.asarray(jv)[off])
    assert np.isinf(tv[0].numpy()[~off]).all()
    ja, jv = jt._scale_scores(*jstate)
    ta, tv = tt._scale_scores(*tstate)
    _close(ta[0], ja)
    terms = float(np.abs(np.asarray(jstate[4]) + np.asarray(jstate[5])).max())
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv), rtol=0,
                               atol=1e-5 * terms)


@pytest.fixture(scope="module")
def jax_batch_fit():
    laps = _directed_laps(N, B)
    prog = jeb._gen_fit_program(M, 2, True, 1e-3, True)
    out = prog(jnp.asarray(laps), jt.default_cbar(jnp.asarray(laps)))
    return laps, tuple(np.asarray(o) for o in out[2:])


def test_batched_fit_matches_jax_objective(jax_batch_fit):
    laps, (jobj, _, jit_) = jax_batch_fit
    tb = ApproxEigenbasis.fit(laps, M, kind="general", n_iter=2, eps=1e-3,
                              device="cpu")
    assert tb.kind == "general" and tb.batched
    obj = tb.objective.numpy()
    np.testing.assert_allclose(obj, jobj, rtol=0.05)
    np.testing.assert_array_equal(tb.info["iterations"].numpy(), jit_)
    # the reported objective is the dense one of the fitted factors
    _close(tb.frobenius_error(laps), obj, tol=1e-4)
    _close(tt.t_objective(torch.from_numpy(laps), tb.factors, tb.spectrum),
           obj)
    den = (laps * laps).sum((1, 2))
    assert (obj / den < 0.08).all()
    # "auto" resolves a non-symmetric stack to the general family
    assert ApproxEigenbasis.fit(laps[:1], 8, n_iter=1,
                                device="cpu").kind == "general"


def test_single_fit_matches_jax_objective():
    lap = _directed_laps(N, 1)[0]
    jf, jc, jinfo = jt.approximate_general(jnp.asarray(lap), M, n_iter=2,
                                           eps=1e-3)
    tf, tc, tinfo = tt.approximate_general(torch.from_numpy(lap), M,
                                           n_iter=2, eps=1e-3)
    np.testing.assert_allclose(float(tinfo["objective"]),
                               float(jinfo["objective"]), rtol=0.05)
    assert int(tinfo["iterations"]) == int(jinfo["iterations"])
    assert tf.kind.dtype == torch.int32 and tf.kind.shape == (M,)
    scale = tf.kind == SCALE
    assert torch.equal(tf.i[scale], tf.j[scale])


def test_per_matrix_freeze_matches_jax():
    """A diagonal matrix is fitted exactly and freezes after one sweep
    while a directed Laplacian goes on: the batched loop stops each
    matrix on its own, as the JAX package's vmapped while loop does."""
    lap = _directed_laps(N, 1)[0]
    diag = np.diag(np.arange(N, dtype=np.float32) + 1.0)
    mats = np.stack([diag, lap])
    n_iter, eps = 3, 1e-3
    prog = jeb._gen_fit_program(48, n_iter, True, eps, True)
    jout = prog(jnp.asarray(mats), jt.default_cbar(jnp.asarray(mats)))
    tb = ApproxEigenbasis.fit(mats, 48, kind="general", n_iter=n_iter,
                              eps=eps, device="cpu")
    it = tb.info["iterations"].numpy()
    np.testing.assert_array_equal(it, np.asarray(jout[4]))
    assert it[0] < it[1] == n_iter
    assert float(tb.objective[0]) < 1e-6
    hist = tb.info["history"].numpy()
    assert np.isnan(hist[0, it[0] + 1:]).all()


def test_directed_fgft_matches_jax():
    lap = _directed_laps(N, 1)[0]
    jf = jfgft.build_fgft(jnp.asarray(lap), M, directed=True, n_iter=2)
    f = build_fgft(lap, M, directed=True, n_iter=2, device="cpu")
    assert f.directed and f.g_factors is None
    rel, jrel = relative_error(lap, f), jfgft.relative_error(
        jnp.asarray(lap), jf)
    np.testing.assert_allclose(rel, jrel, rtol=0.05)
    assert rel < 0.08
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, N)).astype(np.float32))
    xr = f.synthesis(f.analysis(x))
    # Tbar is not orthogonal: the round trip holds up to f32 rounding
    # amplified by cond(Tbar) (~20-30 at these sizes)
    _close(xr, x, tol=1e-4)
    recon = tt.t_reconstruct(f.t_factors, f.spectrum)
    _close(f.project(x), x @ recon.T, tol=1e-4)
    for k in (M // 4, M // 2, M):
        pre = prefix_relative_error(lap, f, k)
        assert np.isfinite(pre)
    assert prefix_relative_error(lap, f, M) <= rel * (1 + 1e-5)
    assert f.flops_per_matvec() == jfgft.FGFT(
        n=N, directed=True, spectrum=None,
        t_factors=JT(*(jnp.asarray(t.numpy()) for t in f.t_factors))
    ).flops_per_matvec()


def test_general_basis_apply_project_and_dense():
    laps = _directed_laps(N, 2)
    tb = ApproxEigenbasis.fit(laps, 64, kind="general", n_iter=1,
                              device="cpu")
    x = torch.randn((2, 4, N))
    dense = tt.t_to_dense(tb.factors, N)
    _close(tb.to_dense(), dense)
    _close(tb.apply(x), torch.einsum("bij,brj->bri", dense, x))
    _close(tb.apply(tb.apply(x, inverse=True)), x, tol=1e-4)
    recon = tt.t_reconstruct(tb.factors, tb.spectrum)
    _close(tb.reconstruct(), recon, tol=1e-4)
    _close(tb.project(x), torch.einsum("bij,brj->bri", recon, x), tol=1e-4)
    _close(tb.project(x, fused=False), tb.project(x), tol=1e-4)
    with pytest.raises(ValueError, match="score"):
        ApproxEigenbasis.fit(laps, 8, kind="general", score="gamma",
                             device="cpu")
