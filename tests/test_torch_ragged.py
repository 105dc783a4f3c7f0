"""Ragged (mixed-size) fleets in the port against the JAX package.

The masked fit: each padded member's relative objective equals its
own-size fit's within 1e-5 (G, as tests/test_ragged.py holds the JAX
fit), and both families are within 5% of the JAX masked fit's objective
(f32 differences can flip a greedy tie, so factor tables are not
compared).  Pad semantics: ``apply`` passes pad coordinates through
bitwise, ``project`` and the bank give exactly 0 there.  ``extend``
keeps the mask and the original g as a cut.  The router, on the JAX
router's fits carried with ``basis_from_numpy(..., sizes=)``, serves
every graph within ``1e-5 * max(1, max|y|)`` of the JAX router's
``backend="xla"`` path, and router checkpoints restore both ways."""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ApproxEigenbasis as JaxBasis
from repro.core import gtransform as jgt
from repro.launch.serve import RaggedFGFTServeEngine as JaxRouter
from repro_torch.core import ApproxEigenbasis, laplacian, pad_ragged
from repro_torch.core import gtransform as tgt
from repro_torch.graphs import community_graph, directed_variant
from repro_torch.interop import basis_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.serve import (FGFTServeEngine,
                                      RaggedFGFTServeEngine, bucket_width)

TIERS = {"full": 1.0, "draft": 0.25}
ROUTER_SIZES = [10, 16, 24, 12]


def _h(lam):
    return 1.0 / (1.0 + lam)


def _sym(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    return x + x.T


def _gen(n, seed):
    return np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _rel(objective, fleet):
    return np.asarray(objective) / np.asarray([(m * m).sum()
                                               for m in fleet])


@pytest.fixture(scope="module")
def port_ragged(ragged_sym_fit):
    """The port's masked fit of the shared JAX fixture's fleet (sizes
    10/16/9/16, g = 16, n_iter = 1)."""
    fleet, _ = ragged_sym_fit
    return ApproxEigenbasis.fit(fleet, 16, n_iter=1, device="cpu")


# ---------------------------------------------------------------------------
# the masked fit
# ---------------------------------------------------------------------------


def test_masked_sym_fit_matches_own_size_fits(ragged_sym_fit, port_ragged):
    fleet, _ = ragged_sym_fit
    basis = port_ragged
    assert basis.kind == "sym" and basis.batched and basis.n == 16
    assert basis.sizes.tolist() == [10, 16, 9, 16]
    for i, m in enumerate(fleet):
        own = ApproxEigenbasis.fit(m, 16, n_iter=1, device="cpu")
        denom = float((m * m).sum())
        np.testing.assert_allclose(float(basis.objective[i]) / denom,
                                   float(own.objective) / denom, atol=1e-5)


def test_masked_sym_fit_within_5pct_of_jax(ragged_sym_fit, port_ragged):
    fleet, jb = ragged_sym_fit
    np.testing.assert_allclose(_rel(port_ragged.objective.numpy(), fleet),
                               _rel(jb.objective, fleet), rtol=0.05)
    np.testing.assert_array_equal(np.asarray(jb.sizes), port_ragged.sizes)


def test_masked_gen_fit_within_5pct_of_jax():
    fleet = [_gen(10, 1), _gen(14, 2), _gen(7, 3)]
    tb = ApproxEigenbasis.fit(fleet, 12, n_iter=1, device="cpu")
    jb = JaxBasis.fit(fleet, 12, n_iter=1)
    assert tb.kind == jb.kind == "general"
    np.testing.assert_allclose(_rel(tb.objective.numpy(), fleet),
                               _rel(jb.objective, fleet), rtol=0.05)
    fi, fj = tb.factors.i.numpy(), tb.factors.j.numpy()
    for b, s in enumerate(tb.sizes):
        assert fi[b].max() < s and fj[b].max() < s


def test_masked_default_spectrum_matches_jax():
    stack, sizes = pad_ragged([_sym(6, 0), _sym(11, 1), _sym(3, 2)],
                              device="cpu")
    got = tgt.default_sbar(stack, sizes).numpy()
    want = np.asarray(jgt.default_sbar(jnp.asarray(stack.numpy()), sizes))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for b, s in enumerate(sizes):
        assert (got[b, s:] == 0).all()
    one = tgt.default_sbar(stack[1], 11).numpy()
    np.testing.assert_array_equal(one, got[1])


def test_fit_enforces_zero_pad_block(ragged_sym_fit, port_ragged):
    fleet, _ = ragged_sym_fit
    stack, sizes = pad_ragged(fleet, device="cpu")
    dirty = stack.clone()
    gen = torch.Generator().manual_seed(99)
    for b, s in enumerate(sizes):
        dirty[b, s:, :] = torch.randn((16 - s, 16), generator=gen)
        dirty[b, :, s:] = torch.randn((16, 16 - s), generator=gen)
    redo = ApproxEigenbasis.fit(dirty, 16, n_iter=1, sizes=sizes,
                                device="cpu")
    torch.testing.assert_close(redo.objective, port_ragged.objective,
                               rtol=1e-6, atol=0)
    assert torch.equal(redo.factors.i, port_ragged.factors.i)


def test_pad_ragged_and_sizes_validation():
    stack, sizes = pad_ragged([_sym(6, 0), _sym(9, 1)], width=12,
                              device="cpu")
    assert tuple(stack.shape) == (2, 12, 12) and sizes.tolist() == [6, 9]
    assert float(stack[0, 6:].abs().max()) == 0.0
    assert float(stack[0, :, 6:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="square"):
        pad_ragged([np.zeros((3, 4), np.float32)], device="cpu")
    with pytest.raises(ValueError, match="bucket width"):
        pad_ragged([_sym(9, 1)], width=8, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        pad_ragged([], device="cpu")
    with pytest.raises(ValueError, match="sizes"):
        ApproxEigenbasis.fit([_sym(6, 0)], 8, sizes=[6], device="cpu")
    with pytest.raises(ValueError, match="sizes must lie"):
        ApproxEigenbasis.fit(stack, 8, sizes=[6, 13], device="cpu")
    with pytest.raises(ValueError, match="sizes must be"):
        ApproxEigenbasis.fit(stack, 8, sizes=[6], device="cpu")
    # a fleet that fills its bucket fits unmasked
    full = ApproxEigenbasis.fit(stack, 8, sizes=[12, 12], n_iter=0,
                                device="cpu")
    assert full.sizes is None
    one = ApproxEigenbasis.fit(stack[1], 8, sizes=9, n_iter=0, device="cpu")
    assert one.sizes == 9 and int(one.factors.j.max()) < 9


# ---------------------------------------------------------------------------
# pad semantics (the plain versions on the CPU; on the card:
# tests/test_torch_cuda.py and chip_smoke.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["sym", "general"])
def test_apply_passes_pads_and_project_zeroes_them(family, port_ragged):
    if family == "sym":
        basis = port_ragged
    else:
        basis = ApproxEigenbasis.fit([_gen(10, 1), _gen(16, 2), _gen(7, 3)],
                                     24, n_iter=1, device="cpu")
    bsz, n = basis.spectrum.shape
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (bsz, 3, n)).astype(np.float32))
    y = basis.apply(x)
    xr = basis.apply(basis.apply(x, inverse=True))
    p = basis.project(x)
    ph = basis.project(x, h=lambda lam: torch.exp(-lam))     # h(0) = 1
    for b, s in enumerate(basis.sizes):
        assert torch.equal(y[b, :, s:], x[b, :, s:])
        assert torch.equal(xr[b, :, s:], x[b, :, s:])
        assert bool((p[b, :, s:] == 0).all())
        assert bool((ph[b, :, s:] == 0).all())
        assert bool((basis.spectrum[b, s:] == 0).all())


def test_bank_gains_zero_on_padding(port_ragged):
    from repro_torch.spectral import SpectralFilterBank, named_responses
    basis = port_ragged
    # both responses map 0 to 1, and stay finite on this fleet's negative
    # eigenvalues
    bank = SpectralFilterBank(basis, named_responses("heat,lowpass"))
    gains = bank.gains()                                     # (B, F, n)
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (4, 2, 16)).astype(np.float32))
    out = bank.apply(x)
    for b, s in enumerate(basis.sizes):
        assert bool((gains[b, :, s:] == 0).all())
        assert bool((out[b, :, :, s:] == 0).all())
    torch.testing.assert_close(out, bank.apply(x, fused=False), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("family", ["sym", "general"])
def test_extend_keeps_mask_and_original_cut(family, ragged_sym_fit,
                                            port_ragged):
    if family == "sym":
        fleet, base = ragged_sym_fit[0], port_ragged
    else:
        fleet = [_gen(10, 1), _gen(16, 2), _gen(7, 3)]
        base = ApproxEigenbasis.fit(fleet, 16, n_iter=1, device="cpu")
    stack, _ = pad_ragged(fleet, device="cpu")
    grown = base.extend(stack, 24)
    assert grown.num_transforms == 24
    np.testing.assert_array_equal(grown.sizes, base.sizes)
    assert 16 in grown.stage_cuts[:, 1] and grown.info["extended_from"] == 16
    fi, fj = grown.factors.i.numpy(), grown.factors.j.numpy()
    for b, s in enumerate(grown.sizes):
        assert fi[b].max() < s and fj[b].max() < s
    assert bool((grown.objective <= base.objective * (1 + 1e-5) + 1e-5).all())
    # the fitted prefix is kept: prepended (G) or appended (T) components
    old = slice(8, None) if family == "sym" else slice(0, 16)
    for new_f, old_f in zip(grown.factors, base.factors):
        assert torch.equal(new_f[:, old], old_f.to(new_f.dtype))
    with pytest.raises(ValueError, match="exceed"):
        base.extend(stack, 16)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


def test_bucket_width_powers_of_two():
    assert bucket_width(5) == 8 and bucket_width(8) == 8
    assert bucket_width(9) == 16 and bucket_width(33) == 64
    assert bucket_width(3, min_width=4) == 4
    with pytest.raises(ValueError):
        bucket_width(1)


def _fleet(family):
    adjs = [community_graph(n, seed=s) for s, n in enumerate(ROUTER_SIZES)]
    if family == "general":
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    return [laplacian(a) for a in adjs]


@pytest.fixture(scope="module", params=["sym", "general"])
def routers(request):
    """(laps, JAX router, port router on the JAX router's carried fits)."""
    family = request.param
    laps = _fleet(family)
    jr = JaxRouter(laps, 40, n_iter=1, kind=family, tiers=TIERS,
                   filters="heat,tikhonov")
    engines = {}
    fields = (("i", "j", "c", "s", "sigma") if family == "sym"
              else ("kind", "i", "j", "a"))
    for w, eng in jr.engines.items():
        jb = eng.basis
        tb = basis_from_numpy(
            family, w, {f: np.asarray(getattr(jb.factors, f))
                        for f in fields},
            np.asarray(jb.spectrum), objective=np.asarray(jb.objective),
            sizes=jb.sizes, device="cpu")
        engines[w] = FGFTServeEngine(np.asarray(eng._laps_host), basis=tb,
                                     tiers=TIERS, filters="heat,tikhonov",
                                     device="cpu")
    tr = RaggedFGFTServeEngine(laps, _engines=engines, device="cpu")
    return laps, jr, tr


def _signals(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3, n)).astype(np.float32)
            for n in ROUTER_SIZES]


def test_router_matches_jax_router_on_carried_fits(routers):
    laps, jr, tr = routers
    assert sorted(tr.engines) == sorted(jr.engines) == [16, 32]
    np.testing.assert_allclose(tr.rel_errors(), jr.rel_errors(), rtol=1e-6)
    sig = _signals()
    for tier in TIERS:
        for h in (None, _h):
            got = tr.step([torch.from_numpy(s) for s in sig], h, tier=tier)
            want = jr.step(sig, h, tier=tier)
            for g, w, n in zip(got, want, ROUTER_SIZES):
                assert isinstance(g, torch.Tensor) and g.shape == (3, n)
                _close(g.numpy(), w)
    got = tr.step_bank(sig)
    for g, w, n in zip(got, jr.step_bank(sig), ROUTER_SIZES):
        assert g.shape == (2, 3, n)
        _close(g.numpy(), w)


def test_router_step_pads_and_validation(routers):
    _, _, tr = routers
    sig = _signals(1)
    blocks = tr._scatter(sig)
    assert sorted(blocks) == [16, 32]
    for w, members in tr.bucket_of.items():
        for row, pos in enumerate(members):
            n = ROUTER_SIZES[pos]
            np.testing.assert_array_equal(blocks[w][row, :, :n].numpy(),
                                          sig[pos])
            assert bool((blocks[w][row, :, n:] == 0).all())
    with pytest.raises(ValueError, match="signal blocks"):
        tr.step(sig[:-1])
    with pytest.raises(ValueError, match="must be"):
        tr.step(sig[:-1] + [np.zeros((3, 5), np.float32)])
    tr.reset_step_stats()
    tr.step(sig, tier="draft")
    assert all(s["steps"] == {"full": 0, "draft": 1}
               for s in tr.stats.values())


def test_jax_router_checkpoint_serves_in_port(routers, tmp_path):
    _, jr, _ = routers
    jr.save(tmp_path, step=2)
    tr = RaggedFGFTServeEngine.load(tmp_path, device="cpu")
    assert tr.widths == jr.widths and tr.bucket_of == jr.bucket_of
    assert tr.sizes == ROUTER_SIZES
    np.testing.assert_allclose(tr.rel_errors(), jr.rel_errors(), rtol=1e-6)
    sig = _signals(2)
    for tier in TIERS:
        for g, w in zip(tr.step(sig, _h, tier=tier),
                        jr.step(sig, _h, tier=tier)):
            _close(g.numpy(), w)


def test_port_router_checkpoint_loads_in_jax(routers, tmp_path):
    _, _, tr = routers
    tr.save(tmp_path, step=1)
    assert json.loads((tmp_path / "router.json").read_text()) == {
        "sizes": ROUTER_SIZES, "widths": tr.widths, "step": 1}
    jr = JaxRouter.load(tmp_path, backend="xla")
    assert jr.widths == tr.widths
    sig = _signals(3)
    for tier in TIERS:
        for g, w in zip(tr.step(sig, _h, tier=tier),
                        jr.step(sig, _h, tier=tier)):
            _close(g.numpy(), w)
    back = RaggedFGFTServeEngine.load(tmp_path, filters="heat", device="cpu")
    for g, w in zip(back.step(sig, _h), tr.step(sig, _h)):
        assert torch.equal(g, w)
    assert back.step_bank(sig)[0].shape == (1, 3, ROUTER_SIZES[0])


def test_router_restores_persisted_geometry_and_refuses_placement(tmp_path):
    laps = [laplacian(community_graph(n, seed=s))
            for s, n in enumerate([6, 12])]
    router = RaggedFGFTServeEngine(laps, 24, n_iter=0, min_width=16,
                                   tiers={"full": 1.0}, device="cpu")
    assert router.widths == [16, 16] and router.num_buckets == 1
    router.save(tmp_path)
    back = RaggedFGFTServeEngine.load(tmp_path, device="cpu")
    assert back.widths == [16, 16] and back.bucket_of == {16: [0, 1]}
    # placement is ported: a corrupt manifest raises the JAX router's
    # ValueError, word for word, also under placement=False (as the JAX
    # router reads it first); a sound one is skipped by placement=False
    (tmp_path / "placement.json").write_text("{}")
    with pytest.raises(ValueError, match="corrupt placement manifest") as got:
        RaggedFGFTServeEngine.load(tmp_path, device="cpu")
    with pytest.raises(ValueError) as want:
        JaxRouter.load(tmp_path)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="corrupt placement manifest"):
        RaggedFGFTServeEngine.load(tmp_path, placement=False, device="cpu")
    (tmp_path / "placement.json").write_text(json.dumps(
        {"num_devices": 2, "buckets": {"16": {"device_ids": [0, 1],
                                              "batch": 2}}}))
    unplaced = RaggedFGFTServeEngine.load(tmp_path, placement=False,
                                          device="cpu")
    assert unplaced.widths == [16, 16] and unplaced.placement is None
    dyn = RaggedFGFTServeEngine(laps, 24, n_iter=0, min_width=16,
                                dynamic=True, device="cpu")
    assert dyn.dynamic and dyn.versions.tolist() == [0, 0]
    assert dyn.maintain()[16]["action"] == "reuse"
    # placement="auto" without a mesh: the JAX router's rule
    with pytest.raises(ValueError, match="placement='auto' requires a "
                       "mesh"):
        RaggedFGFTServeEngine(laps, 24, placement="auto", device="cpu")
    with pytest.raises(ValueError, match="placement='auto' requires a "
                       "mesh"):
        JaxRouter(laps, 24, placement="auto")


@pytest.mark.parametrize("extra", [[], ["--directed"],
                                   ["--filter", "heat,tikhonov"]],
                         ids=["sym", "directed", "bank"])
def test_cli_ragged_serves_on_cpu(extra, capsys):
    out = serve.main(["--fgft", "--ragged", "--graphs", "6",
                      "--graph-sizes", "12,20,32", "--signals", "3",
                      "--filter-steps", "2", "--tiers", "full:1.0,draft:0.5",
                      "--device", "cpu", "--backend", "torch"] + extra)
    assert out["sizes"] == [12, 20, 32, 12, 20, 32]
    assert out["buckets"] == [16, 32]
    assert out["rel_error"].shape == (6,)
    assert float(out["rel_error"].mean()) < 0.05
    text = capsys.readouterr().out
    if "--filter" in extra:
        assert out["responses_per_s"] > 0 and "responses/s" in text
        return
    assert set(out["tiers"]) == {"full", "draft"}
    assert out["tiers"]["full"]["num_transforms"] == {16: 128, 32: 320}
    assert set(out["tiers"]["draft"]["num_stages"]) == {16, 32}
    for bucket_stats in out["stats"].values():
        assert bucket_stats["steps"] == {"full": 2, "draft": 2}
    assert "graph-transforms/s across 2 bucket dispatches/step" in text


@pytest.mark.parametrize("sizes,match", [
    ("1,8", "at least one size >= 2"), (",", "at least one size >= 2"),
    ("8,x", "comma-separated ints")])
def test_cli_rejects_bad_graph_sizes(sizes, match, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--fgft", "--ragged", "--graph-sizes", sizes,
                          "--device", "cpu"])
    assert match in capsys.readouterr().err
