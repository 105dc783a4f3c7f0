"""Serving parity: a JAX fit carried across with ``basis_from_numpy``
serves the same answers in the port (tables bitwise, ``apply``/
``project`` and every tier of ``FGFTServeEngine.step`` within
``1e-5 * max(1, max|y|)`` of the JAX package's ``backend="xla"`` path —
its Pallas tiered path is red on jax 0.9 (ROADMAP §C)), and the port's
CLI serves end to end on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ApproxEigenbasis as JaxBasis
from repro.launch.serve import FGFTServeEngine as JaxEngine
from repro_torch.core import laplacian
from repro_torch.graphs import community_graph
from repro_torch.interop import basis_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.serve import FGFTServeEngine

TIERS = {"full": 1.0, "balanced": 0.5, "draft": 0.25}
N, B, G = 16, 3, 128


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def carried():
    laps = np.stack([laplacian(community_graph(N, seed=s))
                     for s in range(B)])
    jb = JaxBasis.fit(jnp.asarray(laps), G, n_iter=2)
    factors = {k: np.asarray(getattr(jb.factors, k))
               for k in ("i", "j", "c", "s", "sigma")}
    tb = basis_from_numpy("sym", N, factors, np.asarray(jb.spectrum),
                          objective=np.asarray(jb.objective), device="cpu")
    x = np.random.default_rng(0).standard_normal((B, 9, N)).astype(
        np.float32)
    return laps, jb, tb, x


def test_carried_tables_are_bitwise(carried):
    _, jb, tb, _ = carried
    for js, ts in ((jb.fwd, tb.fwd), (jb.bwd, tb.bwd)):
        np.testing.assert_array_equal(np.asarray(js.cuts), ts.cuts)
        for a, b in zip(js[:5], ts[:5]):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert tb.num_transforms == G and tb.batched


def test_carried_single_basis(carried):
    _, jb, _, x = carried
    factors = {k: np.asarray(getattr(jb.factors, k))[1]
               for k in ("i", "j", "c", "s", "sigma")}
    tb = basis_from_numpy("sym", N, factors, np.asarray(jb.spectrum)[1],
                          device="cpu")
    from repro.core import ApproxEigenbasis as JB
    from repro.core.staging import pack_g_pair
    from repro.core.types import GFactors as JG
    jf = JG(*(f[1] for f in jb.factors))
    jfwd, jbwd = pack_g_pair(jf, n=N)
    jsingle = JB(kind="sym", n=N, batched=False, factors=jf,
                 spectrum=jb.spectrum[1], fwd=jfwd, bwd=jbwd)
    _close(tb.project(x[1]), jsingle.project(jnp.asarray(x[1])))
    with pytest.raises(ValueError, match="kind must be"):
        basis_from_numpy("bogus", N, factors, np.zeros(N), device="cpu")
    with pytest.raises(ValueError, match="lack fields"):
        basis_from_numpy("general", N, factors, np.zeros(N), device="cpu")
    with pytest.raises(ValueError, match="spectrum"):
        basis_from_numpy("sym", N, factors, np.zeros(N + 1), device="cpu")


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_matches_jax(carried, inverse):
    _, jb, tb, x = carried
    for k in [None, *tb.stage_cuts[:, 0].tolist()]:
        _close(tb.apply(x, inverse=inverse, num_stages=k),
               jb.apply(jnp.asarray(x), inverse=inverse, num_stages=k))


@pytest.mark.parametrize("fused", [True, False])
def test_project_matches_jax(carried, fused):
    _, jb, tb, x = carried
    for k in [None, *tb.stage_cuts[:, 0].tolist()]:
        _close(tb.project(x, num_stages=k, fused=fused),
               jb.project(jnp.asarray(x), num_stages=k))
    _close(tb.project(x, h=lambda s: torch.exp(-0.3 * s), fused=fused),
           jb.project(jnp.asarray(x), h=lambda s: jnp.exp(-0.3 * s)))
    _close(tb.to_dense(), jb.to_dense())
    _close(tb.reconstruct(), jb.reconstruct())


def test_engine_tiers_match_jax_xla_engine(carried):
    laps, jb, tb, x = carried
    jeng = JaxEngine(jnp.asarray(laps), basis=jb, backend="xla",
                     tiers=TIERS)
    teng = FGFTServeEngine(laps, basis=tb, tiers=TIERS, device="cpu")
    lowpass = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
    assert teng.default_tier == jeng.default_tier == "full"
    for name in TIERS:
        assert (teng.tiers[name]["num_stages"]
                == jeng.tiers[name]["num_stages"])
        _close(teng.tiers[name]["spectrum"], jeng.tiers[name]["spectrum"])
        _close(teng.step(x, tier=name), jeng.step(jnp.asarray(x), tier=name))
        _close(teng.step(x, lowpass, tier=name),
               jeng.step(jnp.asarray(x), lowpass, tier=name))
    y, version = teng.step_versioned(x)
    _close(y, jeng.step(jnp.asarray(x)))
    assert version == 0
    assert teng.stats["steps"] == {"full": 3, "balanced": 2, "draft": 2}


def test_engine_fits_and_warms_up():
    laps = np.stack([laplacian(community_graph(N, seed=s))
                     for s in range(2)])
    eng = FGFTServeEngine(laps, 48, tiers=TIERS, backend="torch",
                          device="cpu")
    x = torch.zeros((2, 3, N))
    assert eng.warmup(x).shape == x.shape
    assert eng.stats["steps"] == {"full": 0, "balanced": 0, "draft": 0}
    with pytest.raises(ValueError, match="num_transforms"):
        FGFTServeEngine(laps, 0, device="cpu")


def test_engine_resolves_the_current_card(monkeypatch):
    """A basis fitted on "cuda" has its tensors on "cuda:0": the engine
    resolves "cuda" to the current card before it compares the two (it
    compared torch.device("cuda") with "cuda:0" and refused)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert serve._resolve("cuda") == torch.device("cuda:0")
    assert serve._resolve(torch.device("cuda", 1)) == torch.device("cuda:1")
    assert serve._resolve("cpu") == torch.device("cpu")


def test_cli_serves_on_cpu(capsys):
    out = serve.main(["--fgft", "--graphs", "2", "--graph-n", "16",
                      "--signals", "4", "--filter-steps", "2",
                      "--tiers", "full:1.0,draft:0.25",
                      "--device", "cpu", "--backend", "torch"])
    assert set(out["tiers"]) == {"full", "draft"}
    assert float(np.mean(out["rel_error"])) < 0.05
    assert out["stats"]["steps"] == {"full": 2, "draft": 2}
    assert "graph-transforms/s [torch]" in capsys.readouterr().out


def test_cli_serves_bf16_tables_on_cpu(capsys):
    out = serve.main(["--fgft", "--precision", "bf16", "--graphs", "2",
                      "--graph-n", "16", "--signals", "4",
                      "--filter-steps", "2", "--tiers", "full:1.0",
                      "--device", "cpu", "--backend", "torch"])
    engine = out["engine"]
    assert engine._live.fwd[2].dtype == torch.bfloat16
    assert engine.basis.fwd.c.dtype == torch.float32
    assert out["stats"]["steps"] == {"full": 2}
    assert "graph-transforms/s [torch]" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--fgft", "--dynamic", "--drift-thresholds", "1,2"],
     "three comma-separated floats"),
    (["--fgft", "--arch", "qwen2-1.5b"], "LM scaffold"),
    (["--fgft", "--serve-async", "--max-batch", "0"], "--max-batch"),
    (["--fgft", "--filter", "nosuch"], "unknown filter"),
    (["--graphs", "2"], "--fgft is required"),
    (["--fgft", "--tiers", "full:2"], "fraction"),
    (["--fgft", "--bogus"], "unrecognized"),
])
def test_cli_rejects_unported_flags(argv, match, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(argv + ["--device", "cpu"])
    assert match in capsys.readouterr().err


# ---------------------------------------------------------------------------
# filter banks: step_bank and serve --filter
# ---------------------------------------------------------------------------

BANK = "heat,tikhonov,wavelets:2"


def test_step_bank_matches_jax_engine(carried):
    laps, jb, tb, x = carried
    jeng = JaxEngine(jnp.asarray(laps), basis=jb, backend="xla",
                     tiers=TIERS, filters=BANK)
    teng = FGFTServeEngine(laps, basis=tb, tiers=TIERS, filters=BANK,
                           device="cpu")
    assert teng.bank.names == jeng.bank.names
    _close(teng._live.bank_gains, jeng._live.bank_gains)
    y, version = teng.step_bank_versioned(x)
    assert y.shape == (B, len(teng.bank), 9, N) and version == 0
    _close(y, jeng.step_bank(jnp.asarray(x)))
    # each filter is the full tier's operator with that filter's gains
    for f, filt in enumerate(teng.bank.filters):
        _close(y[:, f], teng.step(x, filt.response))
    three = FGFTServeEngine(laps, basis=tb, filters=BANK, fused=False,
                            device="cpu")
    _close(three.step_bank(x), y)


def test_step_bank_without_filters_raises(carried):
    laps, _, tb, x = carried
    eng = FGFTServeEngine(laps, basis=tb, device="cpu")
    assert eng.bank is None
    with pytest.raises(ValueError, match="without filters"):
        eng.step_bank(x)
    with pytest.raises(ValueError, match="without filters"):
        eng.step_bank_versioned(x)


@pytest.mark.parametrize("directed", [False, True])
def test_cli_serves_filter_bank_on_cpu(directed, capsys):
    argv = ["--filter", "heat,wavelets:2", "--graphs", "2", "--graph-n",
            "16", "--signals", "4", "--filter-steps", "2", "--device", "cpu",
            "--backend", "torch"]
    if not directed:
        argv = ["--fgft"] + argv
    out = serve.main(argv + ["--directed"] * directed)
    assert out["filters"] == ["heat", "scaling", "wavelet0", "wavelet1"]
    assert out["kind"] == ("general" if directed else "sym")
    assert out["responses_per_s"] > 0
    eng = out["engine"]
    y = eng.step_bank(out["signals"])
    assert y.shape == (2, 4, 4, 16) and bool(torch.isfinite(y).all())
    for f, filt in enumerate(eng.bank.filters):
        _close(y[:, f], eng.step(out["signals"], filt.response))
    assert "responses/s through the fused bank path [torch]" in (
        capsys.readouterr().out)


def test_general_step_bank_matches_jax_engine(carried_general):
    laps, jb, tb, x = carried_general
    jeng = JaxEngine(jnp.asarray(laps), basis=jb, backend="xla",
                     filters=BANK)
    teng = FGFTServeEngine(laps, basis=tb, filters=BANK, device="cpu")
    y = teng.step_bank(x)
    _close(y, jeng.step_bank(jnp.asarray(x)))
    for f, filt in enumerate(teng.bank.filters):
        assert torch.equal(y[:, f], teng.step(x, filt.response))


# ---------------------------------------------------------------------------
# directed graphs: the general (T-transform) family
# ---------------------------------------------------------------------------

def _directed_laps(n, batch):
    from repro_torch.graphs import directed_variant
    return np.stack([laplacian(directed_variant(community_graph(n, seed=s),
                                                seed=s))
                     for s in range(batch)])


@pytest.fixture(scope="module")
def carried_general():
    laps = _directed_laps(N, B)
    jb = JaxBasis.fit(jnp.asarray(laps), G, kind="general", n_iter=1)
    factors = {k: np.asarray(getattr(jb.factors, k))
               for k in ("kind", "i", "j", "a")}
    tb = basis_from_numpy("general", N, factors, np.asarray(jb.spectrum),
                          objective=np.asarray(jb.objective), device="cpu")
    x = np.random.default_rng(1).standard_normal((B, 9, N)).astype(
        np.float32)
    return laps, jb, tb, x


def test_carried_general_basis_matches_jax(carried_general):
    """A JAX T-fit carried across: tables bitwise, and apply (both
    directions), project (fused and three-pass), to_dense and
    reconstruct equal the JAX package's at every cut."""
    _, jb, tb, x = carried_general
    assert tb.kind == "general" and tb.batched
    for js, ts in ((jb.fwd, tb.fwd), (jb.bwd, tb.bwd)):
        np.testing.assert_array_equal(np.asarray(js.cuts), ts.cuts)
        for a, b in zip(js[:4], ts[:4]):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
    for k in [None, *tb.stage_cuts[:, 0].tolist()]:
        for inverse in (False, True):
            _close(tb.apply(x, inverse=inverse, num_stages=k),
                   jb.apply(jnp.asarray(x), inverse=inverse, num_stages=k))
        for fused in (True, False):
            _close(tb.project(x, num_stages=k, fused=fused),
                   jb.project(jnp.asarray(x), num_stages=k))
    _close(tb.to_dense(), jb.to_dense())
    _close(tb.reconstruct(), jb.reconstruct())
    factors = {k: np.asarray(getattr(jb.factors, k))[2]
               for k in ("kind", "i", "j", "a")}
    single = basis_from_numpy("general", N, factors,
                              np.asarray(jb.spectrum)[2], device="cpu")
    assert not single.batched
    _close(single.project(x[2]), jb.project(jnp.asarray(x))[2])


def test_general_engine_tiers_match_jax_xla_engine(carried_general):
    """Every tier of a directed fleet serves the full fit's spectrum (no
    Lemma-1 prefix refit for a non-orthogonal basis) and the JAX
    engine's answers."""
    laps, jb, tb, x = carried_general
    jeng = JaxEngine(jnp.asarray(laps), basis=jb, backend="xla",
                     tiers=TIERS)
    teng = FGFTServeEngine(laps, basis=tb, tiers=TIERS, device="cpu")
    lowpass = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
    for name in TIERS:
        assert (teng.tiers[name]["num_stages"]
                == jeng.tiers[name]["num_stages"])
        assert torch.equal(teng.tiers[name]["spectrum"], tb.spectrum)
        _close(teng.step(x, lowpass, tier=name),
               jeng.step(jnp.asarray(x), lowpass, tier=name))


def test_cli_serves_directed_on_cpu(capsys):
    out = serve.main(["--fgft", "--directed", "--graphs", "2",
                      "--graph-n", "16", "--signals", "4",
                      "--filter-steps", "2", "--tiers", "full:1.0,draft:0.25",
                      "--device", "cpu", "--backend", "torch"])
    assert out["kind"] == "general"
    assert set(out["tiers"]) == {"full", "draft"}
    assert float(np.mean(out["rel_error"])) < 0.08
    assert out["stats"]["steps"] == {"full": 2, "draft": 2}
    eng = out["engine"]
    y = eng.step(out["signals"], tier="full")
    recon = torch.stack([torch.from_numpy(r) for r in np.asarray(
        eng.basis.reconstruct())])
    _close(y, torch.einsum("bij,brj->bri", recon, out["signals"]))
    assert "kind=general" in capsys.readouterr().out
