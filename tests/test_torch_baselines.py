"""The port's baselines (``repro_torch.core.baselines``) against the JAX
package's on the CPU.

The JAX package's own cases (tests/test_baselines.py) run on the port.
Then parity on the same inputs, made from numpy seeds: the greedy chains
(``truncated_jacobi``, ``factorize_orthonormal``) pick the same pair at
every step and agree on (c, s, sigma) within 1e-5, except where the JAX
chain's best two scores lie within 1e-4 of each other (relative): f32
rounding may then pick the other one.  Where the chains part, the test
names the step, checks that the JAX chain had such a near-tie there, and
holds the objective within 1e-4 relative.  Rank-r approximations agree
within 1e-4."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import g_to_dense as jg_to_dense
from repro_torch.core import (approximate_symmetric, factorize_orthonormal,
                              g_objective, g_to_dense, rank_r_general,
                              rank_r_symmetric, truncated_jacobi)

#: a step whose best two JAX scores are this close (relative) may pick
#: either pair in f32
NEAR_TIE = 1e-4


def _sym(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return x + x.T


def _orth(n, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    return q.astype(np.float32)


# -- the JAX package's cases, on the port ---------------------------------

def test_jacobi_reduces_offdiagonal():
    s = _sym(24, 0)
    factors, _ = truncated_jacobi(torch.from_numpy(s), g=60)
    u = g_to_dense(factors, 24).numpy()
    w = u.T @ s @ u
    off_before = float(((s - np.diag(np.diag(s))) ** 2).sum())
    off_after = float(((w - np.diag(np.diag(w))) ** 2).sum())
    assert off_after < off_before


def test_jacobi_spectrum_is_diag_of_working():
    s = _sym(12, 1)
    factors, spec = truncated_jacobi(torch.from_numpy(s), g=30)
    u = g_to_dense(factors, 12).numpy()
    w = u.T @ s @ u
    np.testing.assert_allclose(spec.numpy(), np.diag(w), atol=1e-4)


def test_proposed_beats_jacobi_on_frobenius():
    """Paper Fig. 2: the proposed method dominates truncated Jacobi on the
    reconstruction objective (over seeds)."""
    wins = 0
    for seed in range(4):
        s = torch.from_numpy(_sym(32, seed + 10))
        g = 64
        f_j, spec_j = truncated_jacobi(s, g=g)
        obj_j = float(g_objective(s, f_j, spec_j))
        _, _, info = approximate_symmetric(s, g=g, n_iter=3)
        if float(info["objective"]) <= obj_j * 1.001:
            wins += 1
    assert wins >= 3, f"proposed won only {wins}/4 vs Jacobi"


def test_factorize_orthonormal_converges():
    q = _orth(16, 2)
    errs = []
    for g in (8, 40, 120):
        u = g_to_dense(factorize_orthonormal(torch.from_numpy(q), g),
                       16).numpy()
        errs.append(float(((u - q) ** 2).sum()))
    assert errs[0] > errs[2]
    assert errs[2] < 0.5


def test_factorized_orthonormal_is_orthonormal():
    q = _orth(12, 3)
    u = g_to_dense(factorize_orthonormal(torch.from_numpy(q), 20),
                   12).numpy()
    np.testing.assert_allclose(u @ u.T, np.eye(12), atol=1e-5)


def test_rank_r_baselines():
    s = _sym(16, 4)
    approx, flops = rank_r_symmetric(torch.from_numpy(s), r=16)
    np.testing.assert_allclose(approx.numpy(), s, atol=1e-3)
    assert flops == 2 * 2 * 16 * 16
    c = np.random.default_rng(5).standard_normal((12, 12)).astype(np.float32)
    a4, _ = rank_r_general(torch.from_numpy(c), r=4)
    a8, _ = rank_r_general(torch.from_numpy(c), r=8)
    assert float(((a8.numpy() - c) ** 2).sum()) < \
        float(((a4.numpy() - c) ** 2).sum())


# -- parity with the JAX package ------------------------------------------

def _discovery(factors):
    """(g, 2) pairs and (g, 3) values in discovery order (slot g-1-t)."""
    f = [np.asarray(t) for t in factors]
    ij = np.stack([f[0], f[1]], -1)[::-1]
    vals = np.stack(f[2:], -1)[::-1]
    return ij, vals


def _gap(score: np.ndarray) -> float:
    """Relative gap between the best two pairs (i < j) of a symmetric
    score."""
    top = np.sort(score[np.triu_indices(score.shape[0], 1)])[::-1]
    return float((top[0] - top[1]) / max(abs(top[0]), 1e-30))


def _jacobi_score(s, vals_ij):
    """|off-diagonal| of S after the JAX chain's first steps (f64)."""
    w = s.astype(np.float64)
    for (i, j), (c, sn, _) in vals_ij:
        g = np.eye(w.shape[0])
        g[i, i], g[i, j], g[j, i], g[j, j] = c, sn, -sn, c
        w = g.T @ w @ g
    return np.abs(w - np.diag(np.diag(w)))


def _polar_score(u, vals_ij):
    """The polar gains of W = G^T ... G^T U after the JAX chain's first
    steps (f64)."""
    w = u.astype(np.float64)
    for (i, j), (c, s, sg) in vals_ij:
        ri, rj = w[i].copy(), w[j].copy()
        w[i], w[j] = c * ri - sg * s * rj, s * ri + sg * c * rj
    d = np.diag(w)
    tr2 = d[:, None] + d[None, :]
    hr = np.sqrt(tr2 ** 2 + (w - w.T) ** 2)
    hf = np.sqrt((d[:, None] - d[None, :]) ** 2 + (w + w.T) ** 2)
    return np.maximum(hr, hf) - tr2


def _hold_chains(jax_f, port_f, score_at, objective):
    """Same pairs and values up to where the chains part; a part only
    at a JAX near-tie, and then the objectives within 1e-4 relative."""
    jij, jv = _discovery(jax_f)
    tij, tv = _discovery(port_f)
    split = next((t for t in range(len(jij))
                  if tuple(jij[t]) != tuple(tij[t])), None)
    upto = len(jij) if split is None else split
    np.testing.assert_array_equal(tij[:upto], jij[:upto])
    np.testing.assert_allclose(tv[:upto], jv[:upto], atol=1e-5)
    if split is None:
        return
    gap = _gap(score_at(list(zip(jij[:split], jv[:split]))))
    assert gap < NEAR_TIE, (f"the chains part at step {split} of "
                            f"{len(jij)}, where the JAX scores' best two "
                            f"are {gap:.2e} apart (not a near-tie)")
    want, got = objective(jax_f), objective(port_f)
    assert abs(got - want) <= 1e-4 * abs(want), (split, got, want)


@pytest.mark.parametrize("n", [12, 16, 24])
def test_truncated_jacobi_matches_jax(n):
    s = _sym(n, 40 + n)
    g = 3 * n
    jf, jspec = jbl.truncated_jacobi(jnp.asarray(s), g)
    tf, tspec = truncated_jacobi(torch.from_numpy(s), g)
    assert [t.dtype for t in tf] == [torch.int32] * 2 + [torch.float32] * 3
    np.testing.assert_array_equal(tf.sigma.numpy(), 1.0)

    def off(f):
        u = np.asarray(jg_to_dense(type(jf)(*map(jnp.asarray, f)), n),
                       np.float64)
        w = u.T @ s @ u
        return float(((w - np.diag(np.diag(w))) ** 2).sum())
    _hold_chains(jf, tf, lambda steps: _jacobi_score(s, steps), off)
    # the spectrum is the working matrix's diagonal on each side
    u = g_to_dense(tf, n).numpy()
    np.testing.assert_allclose(tspec.numpy(), np.diag(u.T @ s @ u),
                               atol=1e-4)
    if all(np.array_equal(np.asarray(a), b.numpy())
           for a, b in zip(jf[:2], tf[:2])):
        np.testing.assert_allclose(tspec.numpy(), np.asarray(jspec),
                                   atol=1e-4)


@pytest.mark.parametrize("n", [12, 16, 24])
def test_factorize_orthonormal_matches_jax(n):
    q = _orth(n, 60 + n)
    g = 4 * n
    jf = jbl.factorize_orthonormal(jnp.asarray(q), g)
    tf = factorize_orthonormal(torch.from_numpy(q), g)
    assert set(np.unique(tf.sigma.numpy())) <= {-1.0, 1.0}

    def err(f):
        u = np.asarray(jg_to_dense(type(jf)(*map(jnp.asarray, f)), n),
                       np.float64)
        return float(((u - q) ** 2).sum())
    _hold_chains(jf, tf, lambda steps: _polar_score(q, steps), err)


@pytest.mark.parametrize("g", [1, 2])
def test_short_chains_match_jax(g):
    s, q = _sym(8, 1), _orth(8, 2)
    jf, jspec = jbl.truncated_jacobi(jnp.asarray(s), g)
    tf, tspec = truncated_jacobi(torch.from_numpy(s), g)
    for a, b in zip(jf, tf):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(tspec.numpy(), np.asarray(jspec), atol=1e-5)
    for a, b in zip(jbl.factorize_orthonormal(jnp.asarray(q), g),
                    factorize_orthonormal(torch.from_numpy(q), g)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("n,r", [(12, 3), (16, 5), (24, 24)])
def test_rank_r_matches_jax(n, r):
    s = _sym(n, n)
    c = np.random.default_rng(n + 1).standard_normal((n, n)).astype(
        np.float32)
    for jfn, tfn, m in ((jbl.rank_r_symmetric, rank_r_symmetric, s),
                        (jbl.rank_r_general, rank_r_general, c)):
        ja, jflops = jfn(jnp.asarray(m), r)
        ta, tflops = tfn(torch.from_numpy(m), r)
        assert tflops == jflops
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4)


def test_stacked_chains_equal_single_chains():
    """A (B, n, n) stack runs B chains in lockstep, each bitwise the
    chain its matrix gives alone."""
    s = np.stack([_sym(16, 70 + b) for b in range(3)])
    q = np.stack([_orth(16, 80 + b) for b in range(3)])
    fj, spec = truncated_jacobi(torch.from_numpy(s), 40)
    fo = factorize_orthonormal(torch.from_numpy(q), 50)
    assert tuple(fj.i.shape) == (3, 40) and tuple(spec.shape) == (3, 16)
    assert tuple(fo.sigma.shape) == (3, 50)
    for b in range(3):
        f1, spec1 = truncated_jacobi(torch.from_numpy(s[b]), 40)
        assert torch.equal(spec[b], spec1)
        for got, want in zip(fj, f1):
            assert torch.equal(got[b], want)
        for got, want in zip(fo, factorize_orthonormal(
                torch.from_numpy(q[b]), 50)):
            assert torch.equal(got[b], want)
