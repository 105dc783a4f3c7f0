"""The port's spectral subsystem (repro_torch.spectral) and its four plain
filter-bank versions (repro_torch.kernels.ref, which the CUDA wrappers of
kernels/spectral.py use on CPU tensors) against the JAX package: the
responses and their parser, the bank oracles of ``repro.kernels.ref`` and
the Pallas bank kernels in interpret mode at every ladder cut (G and T,
single and batched), the plan's bank fused and three-pass, and
``SpectralFilterBank``, ``compress`` and the Chebyshev baseline on JAX
fits carried across with ``basis_from_numpy``.

Tolerance: f32, ``1e-5 * max(1, max|y|)`` — the two sides round the
stage products in different orders across up to 2S stages, and operator
outputs scale with the gains.  The Pallas kernels cannot run an empty
(0-stage) cut, so the 0 cut is held to the jnp oracle only."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import spectral as jsp
from repro.core import ApproxEigenbasis as JaxBasis
from repro.core import staging as jst
from repro.core.types import GFactors as JG
from repro.core.types import TFactors as JT
from repro.kernels import ref as jref
from repro.kernels import spectral as jksp
from repro_torch import spectral as sp
from repro_torch.core import laplacian
from repro_torch.core import staging as tst
from repro_torch.core.types import GFactors, TFactors
from repro_torch.graphs import community_graph, directed_variant
from repro_torch.interop import basis_from_numpy
from repro_torch.kernels import launcher
from repro_torch.kernels import spectral as ksp
from repro_torch.kernels.plan import ApplyPlan

N = 32
BANKS = ["heat,tikhonov,lowpass,highpass,bandpass", "wavelets:2",
         "heat:3.0,tikhonov:0.5,lowpass:0.4,bandpass:0.3,wavelets:3"]
SIZES = [(16, 3, 64), (48, 2, 160)]      # (n, B, g) of the table fixtures


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _signal(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cuts(staged):
    return sorted({0, *staged.cuts[:, 0].tolist()})


def _spectrum(batch, n, seed=0):
    """Nonnegative graph-like frequencies with an exact zero per row."""
    lam = np.random.default_rng(seed).uniform(0.0, 3.0 * n, (batch, n))
    lam[:, 0] = 0.0
    return lam.astype(np.float32)


# ---------------------------------------------------------------------------
# responses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", BANKS)
def test_named_responses_match_jax(spec):
    lam = _spectrum(3, N)
    ours, theirs = sp.named_responses(spec), jsp.named_responses(spec)
    assert list(ours) == list(theirs)
    for name in ours:
        for s in (lam, lam[0]):
            _close(ours[name](torch.from_numpy(s)),
                   theirs[name](jnp.asarray(s)))
        np.testing.assert_allclose(
            sp.response_lipschitz(ours[name]),
            jsp.response_lipschitz(theirs[name]), rtol=1e-3)


def test_response_factories_match_jax():
    lam = _spectrum(2, N, seed=3)
    for make in ("heat", "tikhonov", "lowpass", "highpass", "bandpass"):
        _close(getattr(sp, make)()(torch.from_numpy(lam)),
               getattr(jsp, make)()(jnp.asarray(lam)))
    x = np.linspace(0.0, 4.0, 33, dtype=np.float32)
    _close(sp.hammond_kernel(torch.from_numpy(x)),
           jsp.hammond_kernel(jnp.asarray(x)))
    np.testing.assert_array_equal(sp.wavelet_scales(5, 10.0),
                                  jsp.wavelet_scales(5, 10.0))
    assert list(sp.hammond_bank(3)) == list(jsp.hammond_bank(3))
    assert sp.RESPONSES.keys() == jsp.RESPONSES.keys()


@pytest.mark.parametrize("spec,match", [
    ("nosuchfilter", "unknown filter"),
    ("heat,heat", "duplicate filter"),
    ("wavelets:2,wavelets:4", "duplicate filter"),
])
def test_bank_spec_errors(spec, match):
    with pytest.raises(ValueError, match=match) as ours:
        sp.named_responses(spec)
    with pytest.raises(ValueError) as theirs:
        jsp.named_responses(spec)
    assert str(ours.value) == str(theirs.value)


def test_empty_bank_raises(carried):
    with pytest.raises(ValueError, match="empty filter bank"):
        sp.SpectralFilterBank(carried["sym"][1], {})
    assert sp.named_responses(" , ") == {}


# ---------------------------------------------------------------------------
# the four plain bank versions on tables of random chains
# ---------------------------------------------------------------------------

def _g_fields(n, batch, g):
    rng = np.random.default_rng(n)
    a = rng.integers(0, n, (batch, g))
    b = (a + rng.integers(1, n, (batch, g))) % n
    theta = rng.uniform(-np.pi, np.pi, (batch, g))
    return (np.minimum(a, b).astype(np.int32),
            np.maximum(a, b).astype(np.int32),
            np.cos(theta).astype(np.float32),
            np.sin(theta).astype(np.float32),
            rng.choice([-1.0, 1.0], (batch, g)).astype(np.float32))


def _t_fields(n, batch, m):
    """Random valid T chains conditioned like a fit's: scalings by
    +-[0.8, 1.25], shears by [-0.5, 0.5]."""
    rng = np.random.default_rng(n + 7)
    shape = (batch, m)
    kind = rng.integers(0, 2, shape).astype(np.int32)
    i = rng.integers(0, n, shape).astype(np.int32)
    j = np.where(kind == 0, i, (i + rng.integers(1, n, shape)) % n)
    scale = rng.uniform(0.8, 1.25, shape) * rng.choice([-1.0, 1.0], shape)
    a = np.where(kind == 0, scale, rng.uniform(-0.5, 0.5, shape))
    return kind, i, j.astype(np.int32), a.astype(np.float32)


def _tables(family, n, batch, g):
    """Both packers' tables of the same chains (bitwise equal), batched
    and of matrix 0."""
    if family == "sym":
        fields = _g_fields(n, batch, g)
        jc, tc = JG, GFactors
        jpair, jsingle = jst.pack_g_batch_pair, jst.pack_g_pair
        tpair, tsingle = tst.pack_g_batch_pair, tst.pack_g_pair
    else:
        fields = _t_fields(n, batch, g)
        jc, tc = JT, TFactors
        jpair, jsingle = jst.pack_t_batch_pair, jst.pack_t_pair
        tpair, tsingle = tst.pack_t_batch_pair, tst.pack_t_pair
    return dict(
        j=jpair(jc(*map(jnp.asarray, fields)), n),
        js=jsingle(jc(*(jnp.asarray(f[0]) for f in fields)), n=n),
        t=tpair(tc(*fields), n, device="cpu"),
        ts=tsingle(tc(*(f[0] for f in fields)), n=n, device="cpu"))


@pytest.fixture(scope="module", params=[(fam, *s) for fam in
                                        ("sym", "general") for s in SIZES],
                ids=lambda p: f"{p[0]}-n{p[1]}")
def tables(request):
    family, n, batch, g = request.param
    return family, n, batch, _tables(family, n, batch, g)


_ENTRIES = {"sym": ("batched_sym_filter_bank_apply", "sym_filter_bank_apply"),
            "general": ("batched_gen_filter_bank_apply",
                        "gen_filter_bank_apply")}


@pytest.mark.parametrize("filters", [1, 5])
def test_batched_bank_matches_jax(tables, filters):
    family, n, batch, t = tables
    entry = _ENTRIES[family][0]
    x = _signal((batch, 130, n))
    gains = np.random.default_rng(filters).uniform(
        0.0, 2.0, (batch, filters, n)).astype(np.float32)
    (fwd, bwd), (jfwd, jbwd) = t["t"], t["j"]
    for k in _cuts(fwd):
        got = getattr(ksp, entry)(fwd, bwd, torch.from_numpy(gains),
                                  torch.from_numpy(x), k)
        assert got.shape == (batch, filters, 130, n)
        _close(got, getattr(jref, entry)(jfwd, jbwd, jnp.asarray(gains),
                                         jnp.asarray(x), k))
        if k and n == 16:
            _close(got, getattr(jksp, entry)(
                jfwd, jbwd, jnp.asarray(gains), jnp.asarray(x),
                interpret=True, num_stages=k))


@pytest.mark.parametrize("filters", [1, 5])
def test_single_bank_matches_jax(tables, filters):
    family, n, _, t = tables
    entry = _ENTRIES[family][1]
    x = _signal((130, n), seed=2)
    gains = np.random.default_rng(filters + 1).uniform(
        0.0, 2.0, (filters, n)).astype(np.float32)
    (fwd, bwd), (jfwd, jbwd) = t["ts"], t["js"]
    for k in _cuts(fwd):
        got = getattr(ksp, entry)(fwd, bwd, torch.from_numpy(gains),
                                  torch.from_numpy(x), k)
        assert got.shape == (filters, 130, n)
        _close(got, getattr(jref, entry)(jfwd, jbwd, jnp.asarray(gains),
                                         jnp.asarray(x), k))
        if k and n == 16:
            _close(got, getattr(jksp, entry)(
                jfwd, jbwd, jnp.asarray(gains), jnp.asarray(x),
                interpret=True, num_stages=k))


def test_bank_slices_equal_operators(tables):
    """Each filter of the plain bank is the plain operator with that
    filter's gains: bitwise for T (same walks, same multiply), within
    the tolerance for G."""
    family, n, batch, t = tables
    plan = ApplyPlan(family=family, mode="operator", n=n, batched=True,
                     device="cpu")
    bank = ApplyPlan(family=family, mode="bank", n=n, batched=True,
                     device="cpu")
    fwd, bwd = t["t"]
    x = torch.from_numpy(_signal((batch, 2, 7, n), seed=3))
    gains = torch.from_numpy(np.random.default_rng(4).uniform(
        0.0, 2.0, (batch, 3, n)).astype(np.float32))
    y = bank.bank(fwd, bwd, gains, x)
    assert y.shape == (batch, 3, 2, 7, n)
    for f in range(3):
        yf = plan.operator(fwd, bwd, gains[:, f], x)
        if family == "general":
            assert torch.equal(y[:, f], yf)
        else:
            _close(y[:, f], yf)
    assert set(launcher.entry_launch_counts().values()) == {0}


@pytest.mark.parametrize("batched", [True, False])
def test_plan_bank_fused_equals_three_pass_and_jax(tables, batched):
    from repro.kernels.plan import ApplyPlan as JaxPlan
    family, n, batch, t = tables
    (fwd, bwd), (jfwd, jbwd) = ((t["t"], t["j"]) if batched
                                else (t["ts"], t["js"]))
    lead = (batch,) if batched else ()
    x = _signal(lead + (3, 4, n), seed=5)
    gains = np.random.default_rng(6).uniform(
        0.0, 2.0, lead + (4, n)).astype(np.float32)
    for k in _cuts(fwd):
        fused = ApplyPlan.for_staged(fwd, "bank", num_stages=k)
        three = ApplyPlan.for_staged(fwd, "bank", num_stages=k, fused=False)
        assert fused.family == family and fused.backend == "torch"
        got = fused.bank(fwd, bwd, torch.from_numpy(gains),
                         torch.from_numpy(x))
        assert got.shape == lead + (4, 3, 4, n)
        _close(three.bank(fwd, bwd, torch.from_numpy(gains),
                          torch.from_numpy(x)), got)
        jplan = JaxPlan.for_staged(jfwd, "bank", backend="xla",
                                   num_stages=k)
        _close(got, jplan.bank(jfwd, jbwd, jnp.asarray(gains),
                               jnp.asarray(x)))


# ---------------------------------------------------------------------------
# SpectralFilterBank, compress and Chebyshev on carried JAX fits
# ---------------------------------------------------------------------------

def _carry(jb, kind, index=None):
    fields = ("i", "j", "c", "s", "sigma") if kind == "sym" else (
        "kind", "i", "j", "a")
    pick = (lambda a: a) if index is None else (lambda a: a[index])
    factors = {k: pick(np.asarray(getattr(jb.factors, k))) for k in fields}
    return basis_from_numpy(kind, N, factors,
                            pick(np.asarray(jb.spectrum)), device="cpu")


@pytest.fixture(scope="module")
def carried():
    laps = np.stack([laplacian(community_graph(N, seed=s))
                     for s in range(3)])
    jb = JaxBasis.fit(jnp.asarray(laps), 4 * N, n_iter=2)
    dlaps = np.stack([laplacian(directed_variant(community_graph(N, seed=s),
                                                 seed=s))
                      for s in range(2)])
    jg = JaxBasis.fit(jnp.asarray(dlaps), 4 * N, kind="general", n_iter=1)
    factors = JG(*(f[1] for f in jb.factors))
    sfwd, sbwd = jst.pack_g_pair(factors, n=N)
    single = JaxBasis(kind="sym", n=N, batched=False, factors=factors,
                      spectrum=jb.spectrum[1], fwd=sfwd, bwd=sbwd)
    return {"laps": laps, "dlaps": dlaps,
            "sym": (jb, _carry(jb, "sym")),
            "general": (jg, _carry(jg, "general")),
            "single": (single, _carry(jb, "sym", 1))}


@pytest.mark.parametrize("which", ["sym", "general", "single"])
@pytest.mark.parametrize("spec", BANKS[:2])
def test_filter_bank_apply_matches_jax(carried, which, spec):
    jb, tb = carried[which]
    jbank = jsp.SpectralFilterBank(jb, jsp.named_responses(spec))
    tbank = sp.SpectralFilterBank(tb, sp.named_responses(spec))
    assert tbank.names == jbank.names and len(tbank) == len(jbank)
    _close(tbank.gains(), jbank.gains())
    lead = (tb.spectrum.shape[0],) if tb.batched else ()
    x = _signal(lead + (5, N), seed=8)
    want = jbank.apply(jnp.asarray(x), backend="xla")
    _close(tbank.apply(x), want)
    _close(tbank.apply(x, fused=False), want)
    for f, filt in enumerate(tbank.filters):
        axis = (slice(None), f) if tb.batched else (f,)
        _close(filt.apply(x), np.asarray(want)[axis])


def test_identity_response_recovers_projection(carried):
    _, tb = carried["sym"]
    bank = sp.SpectralFilterBank(tb, {"id": lambda lam: lam})
    x = _signal((3, 2, N), seed=9)
    _close(bank.apply(x)[:, 0], tb.project(x))
    _, tg = carried["general"]
    bank = sp.SpectralFilterBank(tg, [("id", lambda lam: lam)])
    x = _signal((2, 2, N), seed=9)
    _close(bank.apply(x)[:, 0], tg.project(x))


def test_topk_coefficients_match_jax():
    coeff = _signal((4, 6, N), seed=10)
    coeff[0, 0, :8] = 1.5                    # ties: lower index wins
    coeff[0, 0, 8:16] = -1.5
    for k in (1, 5, 12, N):
        got = sp.topk_coefficients(torch.from_numpy(coeff), k)
        want = jsp.topk_coefficients(jnp.asarray(coeff), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int((got != 0).sum(-1).min()) == k
    for k in (0, N + 1):
        with pytest.raises(ValueError, match="k must be"):
            sp.topk_coefficients(torch.from_numpy(coeff), k)


@pytest.mark.parametrize("which", ["sym", "general"])
def test_compress_matches_jax(carried, which):
    jb, tb = carried[which]
    batch = tb.spectrum.shape[0]
    x = _signal((batch, 5, N), seed=11)
    x[0, 0] = 0.0                            # an all-zero row keeps 1.0
    for k in (4, 10, N):
        got, want = sp.compress(tb, x, k), jsp.compress(jb, jnp.asarray(x),
                                                        k)
        for name in ("coeff", "kept", "recon", "retained_energy"):
            _close(getattr(got, name), getattr(want, name))
        assert float(got.retained_energy[0, 0]) == 1.0
        _close(sp.compression_error(tb, x, k),
               jsp.compression_error(jb, jnp.asarray(x), k))
    if which == "sym":                       # Parseval in an orthogonal basis
        c = sp.compress(tb, x, 6)
        err2 = ((c.recon - torch.from_numpy(x)) ** 2).sum(-1)
        np.testing.assert_allclose(
            err2.numpy(), ((c.coeff ** 2).sum(-1) * (1 - c.retained_energy)
                           ).numpy(), atol=1e-4)


def test_chebyshev_matches_jax(carried):
    laps = carried["laps"]
    lmax = sp.estimate_lmax(laps[0])
    assert lmax == jsp.estimate_lmax(laps[0])
    assert sp.estimate_lmax(torch.from_numpy(laps[0])) == lmax
    resp = sp.heat(3.0)
    jresp = jsp.heat(3.0)
    for degree in (0, 1, 12):
        _close(sp.chebyshev_coefficients(resp, degree, lmax),
               jsp.chebyshev_coefficients(jresp, degree, lmax))
    coeffs = sp.chebyshev_coefficients(resp, 12, lmax)
    jcoeffs = jsp.chebyshev_coefficients(jresp, 12, lmax)
    x = _signal((3, 4, N), seed=12)
    _close(sp.chebyshev_apply(laps, coeffs, lmax, torch.from_numpy(x)),
           jsp.chebyshev_apply(jnp.asarray(laps), jcoeffs, lmax,
                               jnp.asarray(x)))
    _close(sp.chebyshev_apply(laps[1], coeffs[:1], lmax,
                              torch.from_numpy(x[1])),
           jsp.chebyshev_apply(jnp.asarray(laps[1]), jcoeffs[:1], lmax,
                               jnp.asarray(x[1])))
    _close(sp.chebyshev_filter(laps, resp, torch.from_numpy(x), degree=10),
           jsp.chebyshev_filter(jnp.asarray(laps), jresp, jnp.asarray(x),
                                degree=10))
    _close(sp.chebyshev_filter(laps[2], resp, torch.from_numpy(x[2]),
                               degree=6),
           jsp.chebyshev_filter(jnp.asarray(laps[2]), jresp,
                                jnp.asarray(x[2]), degree=6))
    for g, nnz, kind in ((4096, 1000, "sym"), (4096, 1000, "general"),
                         (1, 10 ** 6, "sym")):
        assert sp.matched_degree(g, nnz, kind) == jsp.matched_degree(
            g, nnz, kind)
