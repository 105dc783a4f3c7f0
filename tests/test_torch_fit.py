"""The port's symmetric fit against the JAX package.

Deterministic pieces on GIVEN factors (dense basis, chain apply, Lemma-1
spectrum, objective) agree to 1e-6 (relative to the operand's scale for
the Laplacian-valued ones).  The greedy fit itself is gated on its
RELATIVE OBJECTIVE within 5% of the JAX fit on the same Laplacians (f32
differences can flip a greedy tie, so factor tables are not compared).
A batch freezes each matrix at its own convergence, as the JAX package's
vmapped while loop does."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ApproxEigenbasis as JaxBasis
from repro.core import gtransform as jgt
from repro.core import laplacian as jlaplacian
from repro.core.types import GFactors as JG
from repro.graphs import community_graph as jcommunity
from repro_torch.core import ApproxEigenbasis, gtransform as tgt
from repro_torch.core import build_fgft, laplacian, relative_error
from repro_torch.core.types import GFactors
from repro_torch.graphs import community_graph


def _laps(n, batch):
    return np.stack([laplacian(community_graph(n, seed=s))
                     for s in range(batch)])


def _chain(n, g, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, g)
    b = (a + rng.integers(1, n, g)) % n
    theta = rng.uniform(-np.pi, np.pi, g)
    return (np.minimum(a, b).astype(np.int32),
            np.maximum(a, b).astype(np.int32),
            np.cos(theta).astype(np.float32),
            np.sin(theta).astype(np.float32),
            rng.choice([-1.0, 1.0], g).astype(np.float32))


def test_generator_and_laplacian_match_jax():
    for n, seed in [(16, 0), (32, 3), (48, 7)]:
        np.testing.assert_array_equal(community_graph(n, seed=seed),
                                      jcommunity(n, seed=seed))
        a = community_graph(n, seed=seed)
        np.testing.assert_array_equal(laplacian(a), jlaplacian(a))
        np.testing.assert_array_equal(laplacian(a, normalized=True),
                                      jlaplacian(a, normalized=True))


@pytest.mark.parametrize("g", [1, 7])
def test_identity_factors_match_jax(g):
    from repro.core.types import gfactors_identity as jidentity
    from repro_torch.core import gfactors_identity
    tf, jf = gfactors_identity(g, device="cpu"), jidentity(g)
    for t, j in zip(tf, jf):
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tgt.g_to_dense(tf, 4).numpy(),
                                  np.eye(4, dtype=np.float32))


@pytest.mark.parametrize("n,g", [(16, 64), (32, 160), (48, 96)])
def test_given_factor_pieces_match(n, g):
    fields = _chain(n, g, seed=n)
    jf, tf = JG(*map(jnp.asarray, fields)), GFactors(
        *map(torch.from_numpy, fields))
    u = tgt.g_to_dense(tf, n).numpy()
    np.testing.assert_allclose(u, np.asarray(jgt.g_to_dense(jf, n)),
                               rtol=0, atol=1e-6)
    x = np.random.default_rng(1).standard_normal((n, 5)).astype(np.float32)
    for adjoint in (False, True):
        np.testing.assert_allclose(
            tgt.gapply(tf, torch.from_numpy(x), adjoint, axis=0).numpy(),
            np.asarray(jgt.gapply(jf, jnp.asarray(x), adjoint, axis=0)),
            rtol=0, atol=1e-6)
    lap = laplacian(community_graph(n, seed=2))
    scale = float(np.abs(lap).max())
    np.testing.assert_allclose(
        tgt.lemma1_spectrum(torch.from_numpy(lap), tf).numpy(),
        np.asarray(jgt.lemma1_spectrum(jnp.asarray(lap), jf)),
        rtol=0, atol=1e-6 * scale)
    sbar = np.linspace(0.0, scale, n).astype(np.float32)
    t_obj = float(tgt.g_objective(torch.from_numpy(lap), tf,
                                  torch.from_numpy(sbar)))
    j_obj = float(jgt.g_objective(jnp.asarray(lap), jf, jnp.asarray(sbar)))
    assert abs(t_obj - j_obj) <= 1e-6 * max(1.0, abs(j_obj))
    # batched chains give each matrix its own dense basis
    two = GFactors(*(torch.stack([t, t.flip(0)]) for t in tf))
    ub = tgt.g_to_dense(two, n).numpy()
    np.testing.assert_allclose(ub[0], u, rtol=0, atol=0)


def test_default_sbar_matches_population_std():
    lap = _laps(32, 3)
    np.testing.assert_allclose(
        tgt.default_sbar(torch.from_numpy(lap)).numpy(),
        np.asarray(jgt.default_sbar(jnp.asarray(lap))), rtol=1e-7, atol=0)


@pytest.mark.parametrize("n,batch", [(16, 3), (32, 2)])
@pytest.mark.parametrize("score", [None, "paper"])
def test_batched_fit_objective_matches_jax(n, batch, score):
    g = int(2 * n * np.log2(n))
    laps = _laps(n, batch)
    spectrum = (None if score is None
                else np.linalg.eigvalsh(laps).astype(np.float32))
    kw = dict(n_iter=2, score=score,
              spectrum=None if spectrum is None else spectrum)
    jb = JaxBasis.fit(jnp.asarray(laps), g,
                      **{**kw, "spectrum": None if spectrum is None
                         else jnp.asarray(spectrum)})
    tb = ApproxEigenbasis.fit(laps, g, device="cpu", **kw)
    denom = (laps * laps).sum((1, 2))
    j_rel = np.asarray(jb.objective) / denom
    t_rel = tb.objective.numpy() / denom
    np.testing.assert_allclose(t_rel, j_rel, rtol=0.05)
    # the reported objective is the dense reconstruction error
    np.testing.assert_allclose(tb.frobenius_error(laps).numpy() / denom,
                               t_rel, rtol=1e-3, atol=1e-7)
    assert tb.fwd.idx_i.shape[0] == batch and tb.num_transforms == g


def test_single_fit_and_fgft_match_jax():
    from repro.core import build_fgft as jbuild, relative_error as jrel
    lap = _laps(32, 1)[0]
    f = build_fgft(lap, 160, n_iter=2, device="cpu")
    jf = jbuild(jnp.asarray(lap), 160, directed=False, n_iter=2)
    assert abs(relative_error(lap, f) - jrel(jnp.asarray(lap), jf)) <= \
        0.05 * jrel(jnp.asarray(lap), jf)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (7, 32)).astype(np.float32))
    # analysis then synthesis is the identity (orthonormal basis)
    np.testing.assert_allclose(f.synthesis(f.analysis(x)).numpy(),
                               x.numpy(), rtol=0, atol=1e-5)


def test_sym_iterate_freezes_converged_matrix_per_matrix():
    n, g, n_iter, eps = 16, 48, 4, 1e-9
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, n)).astype(np.float32)
    mats = np.stack([np.diag(np.arange(n, dtype=np.float32)),   # exact
                     x + x.T]).astype(np.float32)
    tb = ApproxEigenbasis.fit(mats, g, n_iter=n_iter, eps=eps, device="cpu")
    jb = JaxBasis.fit(jnp.asarray(mats), g, n_iter=n_iter, eps=eps)
    it = tb.info["iterations"].numpy()
    np.testing.assert_array_equal(it, np.asarray(jb.info["iterations"]))
    assert it[0] < it[1] == n_iter
    hist = tb.info["history"].numpy()
    assert np.isnan(hist[0, it[0] + 1:]).all()
    assert np.isfinite(hist[1]).all()
    # the frozen matrix keeps the result of its own last sweep, and the
    # other matrix equals its own single fit
    alone = ApproxEigenbasis.fit(mats[1], g, n_iter=n_iter, eps=eps,
                                 device="cpu")
    np.testing.assert_allclose(tb.objective.numpy()[1],
                               alone.objective.numpy(), rtol=1e-5)
    assert float(tb.objective[0]) < 1e-6


def test_fit_rejects_what_is_not_ported():
    from repro_torch.interop import basis_from_numpy
    lap = _laps(16, 2)
    jb = JaxBasis.fit(jnp.asarray(lap), 8, n_iter=0)
    basis = basis_from_numpy(
        "sym", 16, {k: np.asarray(getattr(jb.factors, k))
                    for k in ("i", "j", "c", "s", "sigma")},
        np.asarray(jb.spectrum), device="cpu")
    # bf16 tables are ported: apply and project against the JAX package
    x = np.random.default_rng(3).standard_normal((2, 3, 16)).astype(
        np.float32)
    for inverse in (False, True):
        np.testing.assert_allclose(
            basis.apply(x, inverse=inverse, precision="bf16").numpy(),
            np.asarray(jb.apply(jnp.asarray(x), inverse=inverse,
                                precision="bf16")), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        basis.project(x, h=lambda s: 1.0 / (1.0 + s),
                      precision="bf16").numpy(),
        np.asarray(jb.project(jnp.asarray(x), h=lambda s: 1.0 / (1.0 + s),
                              precision="bf16")), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="precision"):
        basis.apply(x, precision="fp8")
    with pytest.raises(ValueError, match="spectrum shape"):
        ApproxEigenbasis.fit(lap, 8, spectrum=np.zeros(16), device="cpu")
