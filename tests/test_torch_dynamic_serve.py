"""Dynamic serving in the port against the JAX package's: engines built
from one carried basis, fed one update stream under thresholds chosen
wide of the drift values (the two packages' Hutchinson probes differ,
so an estimate is never matched draw for draw), take the same actions,
bump the same versions, keep the same ``stats["dynamic"]`` apart from
``last_drift``, and track bitwise-equal Laplacians; refreshed spectra
agree within 1e-5, EXTEND and REFIT objectives within 5%.  Dynamic
engine and router checkpoints restore across the packages both ways,
and ``serve --fgft --dynamic [--directed] [--ragged]`` runs on the
CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.dynamic as jdyn
from repro.core import ApproxEigenbasis as JaxBasis
from repro.launch.serve import FGFTServeEngine as JaxEngine
from repro.launch.serve import RaggedFGFTServeEngine as JaxRouter
from repro_torch import dynamic as tdyn
from repro_torch.graphs import (community_graph, directed_variant,
                                edge_perturbation, weight_jitter)
from repro_torch.interop import basis_from_numpy
from repro_torch.kernels import launcher
from repro_torch.launch import serve
from repro_torch.launch.serve import FGFTServeEngine, RaggedFGFTServeEngine

N, B, G = 16, 3, 48
TIERS = {"full": 1.0, "draft": 0.25}
FIELDS = {"sym": ("i", "j", "c", "s", "sigma"),
          "general": ("kind", "i", "j", "a")}
H = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _carry(jb):
    factors = {k: np.asarray(getattr(jb.factors, k)) for k in FIELDS[jb.kind]}
    return basis_from_numpy(jb.kind, jb.n, factors, np.asarray(jb.spectrum),
                            objective=np.asarray(jb.objective),
                            sizes=jb.sizes, device="cpu")


def _stream(directed=False, sizes=(N,) * B):
    adjs = [community_graph(n, seed=s) for s, n in enumerate(sizes)]
    if directed:
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    return tdyn.GraphStream(adjs, directed=directed)


def _pair(kind, policy, g=G, tiers=TIERS):
    """(stream, JAX engine, port engine): both dynamic, on ONE JAX fit
    (the port's carried across), under the same policy."""
    stream = _stream(directed=kind == "general")
    laps = np.stack(stream.laplacians())
    jb = JaxBasis.fit(jnp.asarray(laps), g, n_iter=1, kind=kind)
    je = JaxEngine(jnp.asarray(laps), basis=jb, n_iter=1, tiers=tiers,
                   dynamic=True, policy=jdyn.RefitPolicy(**policy))
    te = FGFTServeEngine(laps, basis=_carry(jb), n_iter=1, tiers=tiers,
                         dynamic=True, policy=tdyn.RefitPolicy(**policy),
                         device="cpu")
    return stream, je, te


def _same_state(je, te):
    assert np.asarray(je._laps_host).tobytes() == te._laps.numpy().tobytes()
    jd = {k: v for k, v in je.stats["dynamic"].items() if k != "last_drift"}
    td = {k: v for k, v in te.stats["dynamic"].items() if k != "last_drift"}
    assert td == jd
    assert te.versions.tolist() == je.versions.tolist()
    assert te._dirty.tolist() == je._dirty.tolist()
    assert te.controller.state_dict() == je.controller.state_dict()


def test_dynamic_engines_match_jax_on_one_stream():
    """REUSE, REFRESH, an escalated EXTEND, a budget-forced REFIT and a
    quiet REUSE, in that order, in both packages.  Exact drifts of the
    rounds: ~3e-5, 0.048, 0.069, 0.176, ~1e-4 against thresholds 0.004 /
    0.08 / 0.6; the third round escalates to EXTEND whichever side of
    0.08 an estimate falls (the REFRESH floor stands)."""
    policy = dict(refresh=0.004, extend=0.08, refit=0.6, num_probes=64,
                  hysteresis=1.0, max_extends=1, extend_fraction=0.25)
    stream, je, te = _pair("sym", policy)
    # the pinned tables: the same repack on both sides
    assert te._stage_pad == je._stage_pad
    for js, ts in ((je.basis.fwd, te.basis.fwd), (je.basis.bwd, te.basis.bwd)):
        for a, b in zip(js[:5], ts[:5]):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
    np.testing.assert_allclose(te._baseline, je._baseline, rtol=1e-6)
    _same_state(je, te)
    script = [("jitter", 2, 2, "reuse"), ("edges", 1, 3, "refresh"),
              ("edges", 0, 6, "extend"), ("edges", 2, 20, "refit"),
              ("jitter", 1, 2, "reuse")]
    g0 = te.basis.num_transforms
    for k, (what, gid, count, want) in enumerate(script):
        if what == "jitter":
            batch = weight_jitter(stream.adjs[gid], count, scale=0.01,
                                  seed=k)
        else:
            batch = edge_perturbation(stream.adjs[gid], count, seed=10 + k)
        dl = stream.apply(gid, batch)
        je.apply_updates(gid, dl)
        te.apply_updates(gid, torch.from_numpy(dl))
        jr, tr = je.maintain(), te.maintain()
        assert jr["action"] == tr["action"] == want
        assert tr["swap_version"] == jr["swap_version"]
        assert tr["versions"].tolist() == jr["versions"].tolist()
        _same_state(je, te)
        if want == "refresh":
            _close(te.basis.spectrum, je.basis.spectrum)
            assert te.basis.objective is None
        elif want in ("extend", "refit"):
            np.testing.assert_allclose(te.basis.objective.numpy(),
                                       np.asarray(je.basis.objective),
                                       rtol=0.05)
            np.testing.assert_allclose(te._baseline, je._baseline,
                                       rtol=0.05)
            assert te.basis.num_transforms == je.basis.num_transforms
        assert te.basis.fwd.idx_i.shape == je.basis.fwd.idx_i.shape
    assert te.basis.num_transforms == g0          # REFIT returns to g0
    assert te.controller.extends_since_refit == 0
    assert [e["action"] for e in te.controller.timeline] == [
        e["action"] for e in je.controller.timeline]


def test_directed_engines_escalate_to_extend_as_jax():
    """The T family has no cheap refresh: a refresh-level drift
    escalates to EXTEND in both packages, with objectives within 5%."""
    policy = dict(refresh=0.002, extend=0.5, refit=0.9, num_probes=64,
                  hysteresis=1.0, extend_fraction=0.25)
    stream, je, te = _pair("general", policy, g=40, tiers={"full": 1.0})
    for gid in range(B):
        dl = stream.apply(gid, edge_perturbation(
            stream.adjs[gid], 4, seed=gid, directed=True))
        je.apply_updates(gid, dl)
        te.apply_updates(gid, dl)
    jr, tr = je.maintain(), te.maintain()
    assert jr["action"] == tr["action"] == "extend"
    _same_state(je, te)
    assert te.basis.num_transforms == je.basis.num_transforms == 50
    np.testing.assert_allclose(te.basis.objective.numpy(),
                               np.asarray(je.basis.objective), rtol=0.05)


def test_dynamic_engine_validation():
    stream, _, te = _pair("sym", dict(num_probes=8), g=24)
    with pytest.raises(ValueError, match="exceeds"):
        te.apply_updates(0, np.zeros((32, 32), np.float32))
    static = FGFTServeEngine(np.stack(stream.laplacians()), 12, n_iter=0,
                             device="cpu")
    with pytest.raises(ValueError, match="dynamic"):
        static.apply_updates(0, np.zeros((N, N), np.float32))
    with pytest.raises(ValueError, match="dynamic"):
        static.maintain()
    with pytest.raises(ValueError, match="dynamic"):
        static.drift()
    # an unbatched dynamic engine: no repin, graph 0 only
    single = FGFTServeEngine(stream.laplacian(0), 24, n_iter=1,
                             dynamic=True, device="cpu")
    assert single._stage_pad is None and single.versions.tolist() == [0]
    with pytest.raises(ValueError, match="graph 0"):
        single.apply_updates(1, np.zeros((N, N), np.float32))
    dl = stream.apply(0, edge_perturbation(stream.adjs[0], 4, seed=1))
    single.apply_updates(0, dl)
    assert single.drift().shape == (1,)
    assert single.maintain()["versions"].shape == (1,)


def test_warmup_matches_reference():
    """``warmup`` steps every tier and the bank (the returned block is the
    bank's, as in the JAX engine), and in dynamic mode the drift probe
    and the Lemma-1 refresh, without counting a step or moving state."""
    stream = _stream()
    laps = np.stack(stream.laplacians())
    jb = JaxBasis.fit(jnp.asarray(laps), G, n_iter=1)
    x = np.random.default_rng(0).standard_normal((B, 5, N)).astype(
        np.float32)
    for dynamic in (False, True):
        je = JaxEngine(jnp.asarray(laps), basis=jb, tiers=TIERS,
                       filters="heat,tikhonov", dynamic=dynamic)
        te = FGFTServeEngine(laps, basis=_carry(jb), tiers=TIERS,
                             filters="heat,tikhonov", dynamic=dynamic,
                             device="cpu")
        y = te.warmup(torch.from_numpy(x))
        assert y.shape == (B, 2, 5, N)
        _close(y, je.warmup(jnp.asarray(x)))
        assert te.stats["steps"] == {"full": 0, "draft": 0}
        if dynamic:
            assert te.versions.tolist() == [0] * B
            assert te.controller.counts == je.controller.counts
    static = FGFTServeEngine(laps, basis=_carry(jb), tiers=TIERS,
                             device="cpu")
    _close(static.warmup(torch.from_numpy(x)), static.step(x, tier="draft"))


def test_hot_swaps_reuse_or_rebuild_entry_streams():
    """A REFRESH swap keeps the table tensors, so the cached entry
    streams hit; an EXTEND swap builds new tables and misses once per
    leg (``launcher.stream_cache_counts``)."""
    policy = dict(refresh=0.004, extend=0.08, refit=0.6, num_probes=16,
                  hysteresis=1.0)
    stream, _, te = _pair("sym", policy)
    old = te._live
    for leg in (old.basis.fwd, old.basis.bwd):
        launcher._cached_stream(leg)
    dl = stream.apply(1, edge_perturbation(stream.adjs[1], 3, seed=11))
    te.apply_updates(1, dl)
    assert te.maintain()["action"] == "refresh"
    assert all(a is b for a, b in zip(te._live.fwd, old.fwd))
    launcher.reset_stream_cache_counts()
    for leg in (te.basis.fwd, te.basis.bwd):
        launcher._cached_stream(leg)
    assert launcher.stream_cache_counts() == {"hits": 2, "misses": 0}
    dl = stream.apply(0, edge_perturbation(stream.adjs[0], 6, seed=12))
    te.apply_updates(0, dl)
    assert te.maintain()["action"] == "extend"
    launcher.reset_stream_cache_counts()
    for _ in range(2):
        for leg in (te.basis.fwd, te.basis.bwd):
            launcher._cached_stream(leg)
    assert launcher.stream_cache_counts() == {"hits": 2, "misses": 2}


# ---------------------------------------------------------------------------
# the router: per-bucket swaps, request-order versions
# ---------------------------------------------------------------------------

ROUTER_SIZES = [10, 16, 24, 12]


def test_router_routes_updates_and_swaps_per_bucket():
    stream = _stream(sizes=ROUTER_SIZES)
    policy = tdyn.RefitPolicy(refresh=0.003, extend=0.4, refit=0.8,
                              num_probes=64, hysteresis=1.0)
    router = RaggedFGFTServeEngine(stream.laplacians(), 48, n_iter=1,
                                   tiers={"full": 1.0}, dynamic=True,
                                   policy=policy, device="cpu")
    assert router.dynamic and sorted(router.engines) == [16, 32]
    rng = np.random.default_rng(0)
    signals = [rng.standard_normal((2, n)).astype(np.float32)
               for n in ROUTER_SIZES]
    y0 = router.step(signals, H)
    dl = stream.apply(2, edge_perturbation(stream.adjs[2], 4, seed=4))
    router.apply_updates(2, dl)
    # dirty_only ticks only the bucket of graph 2
    res = router.maintain(dirty_only=True)
    assert list(res) == [32] and res[32]["action"] != "reuse"
    assert router.versions.tolist() == [0, 0, 1, 0]
    assert router.engines[16].stats["dynamic"]["actions"]["reuse"] == 0
    assert router.maintain()[16]["action"] == "reuse"   # idle tick
    assert router.drift().shape == (4,)
    y1 = router.step(signals, H)
    assert [a.shape for a in y1] == [b.shape for b in y0]
    # a smaller ragged graph's dense delta embeds at the leading block
    dl = stream.apply(0, edge_perturbation(stream.adjs[0], 3, seed=5))
    before = router.engines[16]._laps[0].clone()
    router.apply_updates(0, dl)
    after = router.engines[16]._laps[0]
    assert torch.equal(after[:10, :10], before[:10, :10]
                       + torch.from_numpy(dl))
    assert bool((after[10:] == 0).all() and (after[:, 10:] == 0).all())
    assert router.maintain(buckets=[32])[32]["action"] == "reuse"
    with pytest.raises(ValueError, match="not in fleet"):
        router.apply_updates(4, dl)


# ---------------------------------------------------------------------------
# checkpoints both ways
# ---------------------------------------------------------------------------


def _updated_jax_engine():
    stream = _stream(sizes=(12, 12))
    policy = jdyn.RefitPolicy(refresh=0.002, extend=0.4, refit=0.8,
                              num_probes=64, hysteresis=1.0)
    engine = JaxEngine(jnp.asarray(np.stack(stream.laplacians())), 24,
                       n_iter=1, tiers={"full": 1.0}, dynamic=True,
                       policy=policy)
    engine.apply_updates(0, stream.apply(0, edge_perturbation(
        stream.adjs[0], 4, seed=9)))
    engine.maintain()
    engine.apply_updates(1, stream.apply(1, edge_perturbation(
        stream.adjs[1], 2, seed=3)))          # pending: dirty at save
    return engine


def _same_restored(back, src, src_laps):
    assert back.dynamic
    assert back.versions.tolist() == np.asarray(src.versions).tolist()
    assert back._dirty.tolist() == np.asarray(src._dirty).tolist()
    assert back._updates == src._updates
    np.testing.assert_allclose(np.asarray(back._baseline, np.float64),
                               np.asarray(src._baseline, np.float64),
                               rtol=1e-6)
    assert back.controller.state_dict() == src.controller.state_dict()
    assert back._live.version == src._live.version
    assert back._stage_pad == src._stage_pad
    got = (back._laps.numpy() if hasattr(back, "_laps")
           else np.asarray(back._laps_host))
    assert got.tobytes() == np.asarray(src_laps).tobytes()


def test_jax_dynamic_checkpoints_restore_in_port(tmp_path):
    je = _updated_jax_engine()
    je.save(tmp_path / "eng", step=5)
    te = FGFTServeEngine.load(tmp_path / "eng", device="cpu")
    _same_restored(te, je, je._laps_host)
    x = np.random.default_rng(1).standard_normal((2, 3, 12)).astype(
        np.float32)
    _close(te.step(x), je.step(jnp.asarray(x)))
    # the restored pending update is scored on the next tick
    assert te._scored_rev != te._update_rev
    assert te.maintain()["versions"].tolist() == je.maintain()[
        "versions"].tolist()
    stream = _stream(sizes=ROUTER_SIZES[:3])
    jr = JaxRouter(stream.laplacians(), 32, n_iter=0, tiers={"full": 1.0},
                   dynamic=True, policy=jdyn.RefitPolicy(
                       refresh=0.002, num_probes=64, hysteresis=1.0))
    jr.apply_updates(1, stream.apply(1, edge_perturbation(
        stream.adjs[1], 3, seed=2)))
    jr.maintain()
    jr.save(tmp_path / "router", step=2)
    tr = RaggedFGFTServeEngine.load(tmp_path / "router", device="cpu")
    assert tr.dynamic and tr.sizes == jr.sizes
    assert tr.versions.tolist() == jr.versions.tolist()
    for w, eng in tr.engines.items():
        _same_restored(eng, jr.engines[w], jr.engines[w]._laps_host)


def test_port_dynamic_checkpoints_restore_in_jax(tmp_path):
    stream = _stream(sizes=(12, 12))
    te = FGFTServeEngine(np.stack(stream.laplacians()), 24, n_iter=1,
                         tiers={"full": 1.0}, dynamic=True,
                         policy=tdyn.RefitPolicy(refresh=0.002,
                                                 num_probes=64,
                                                 hysteresis=1.0),
                         device="cpu")
    te.apply_updates(0, stream.apply(0, edge_perturbation(
        stream.adjs[0], 4, seed=9)))
    assert te.maintain()["action"] != "reuse"
    te.apply_updates(1, stream.apply(1, edge_perturbation(
        stream.adjs[1], 2, seed=3)))
    te.save(tmp_path / "eng", step=3)
    je = JaxEngine.load(tmp_path / "eng")
    _same_restored(te, je, np.asarray(je._laps_host))
    x = np.random.default_rng(2).standard_normal((2, 3, 12)).astype(
        np.float32)
    _close(te.step(x), je.step(jnp.asarray(x)))
    stream = _stream(sizes=ROUTER_SIZES[:3])
    tr = RaggedFGFTServeEngine(stream.laplacians(), 32, n_iter=0,
                               tiers={"full": 1.0}, dynamic=True,
                               device="cpu")
    tr.apply_updates(2, stream.apply(2, edge_perturbation(
        stream.adjs[2], 3, seed=2)))
    tr.save(tmp_path / "router", step=1)
    jr = JaxRouter.load(tmp_path / "router")
    assert jr.versions.tolist() == tr.versions.tolist()
    for w, eng in jr.engines.items():
        _same_restored(tr.engines[w], eng, np.asarray(eng._laps_host))


def test_static_checkpoint_loads_dynamic(tmp_path):
    """``load(dynamic=True)`` of a static engine or router checkpoint
    repins the tables and starts every version at 0, anchored at the
    restored objective; a plain basis checkpoint with ``laps=`` too."""
    stream = _stream(sizes=ROUTER_SIZES[:3])
    router = RaggedFGFTServeEngine(stream.laplacians(), 32, n_iter=0,
                                   tiers={"full": 1.0}, device="cpu")
    router.save(tmp_path / "router")
    back = RaggedFGFTServeEngine.load(tmp_path / "router", dynamic=True,
                                      policy=tdyn.RefitPolicy(refresh=1e-9),
                                      device="cpu")
    assert back.dynamic and back.versions.tolist() == [0, 0, 0]
    for w, eng in back.engines.items():
        assert eng._stage_pad == (eng._stage_pad[0], w // 2)
        assert eng.basis.fwd.idx_i.shape[-1] == w // 2
        np.testing.assert_allclose(
            eng._baseline, tdyn.relative_objective(
                router.engines[w].basis.objective, router.engines[w]._laps),
            rtol=1e-6)
    back.apply_updates(1, stream.apply(1, edge_perturbation(
        stream.adjs[1], 3, seed=1)))
    acted = back.maintain(dirty_only=True)
    assert list(acted) == [16] and acted[16]["action"] == "refresh"
    assert back.versions.tolist() == [0, 1, 0]
    sig = [np.ones((2, n), np.float32) for n in ROUTER_SIZES[:3]]
    for y, n in zip(back.step(sig, H), ROUTER_SIZES[:3]):
        assert y.shape == (2, n)
    laps = np.stack(_stream().laplacians())
    basis = FGFTServeEngine(laps, 24, n_iter=0, device="cpu").basis
    basis.save(tmp_path / "basis")
    eng = FGFTServeEngine.load(tmp_path / "basis", laps=laps, dynamic=True,
                               device="cpu")
    assert eng.versions.tolist() == [0] * B
    assert eng.controller.counts == {a.value: 0 for a in tdyn.Action}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--directed"], ["--ragged"],
                                   ["--ragged", "--directed"]],
                         ids=["sym", "directed", "ragged",
                              "ragged-directed"])
def test_cli_dynamic_serves_on_cpu(extra, capsys):
    seen = []
    args = serve.parse_args(
        ["--fgft", "--dynamic", "--graphs", "3", "--graph-n", "16",
         "--graph-sizes", "10,16,24", "--update-rounds", "2",
         "--churn", "0.05", "--filter-steps", "2", "--signals", "3",
         "--tiers", "full:1.0,draft:0.5", "--drift-thresholds",
         "0.002,0.02,0.9", "--device", "cpu", "--backend", "torch"] + extra)
    assert args.policy == tdyn.RefitPolicy(refresh=0.002, extend=0.02,
                                           refit=0.9)
    out = serve.serve_fgft_dynamic(
        args, on_round=lambda rnd, eng, rec, x, ys: seen.append(
            (rnd, rec["action"], len(ys) if isinstance(ys, list)
             else tuple(ys.shape))))
    text = capsys.readouterr().out
    assert len(out["rounds"]) == len(out["actions"]) == 2
    assert [s[0] for s in seen] == [0, 1]
    sizes = [10, 16, 24] if "--ragged" in extra else [16] * 3
    assert out["sizes"] == sizes
    assert all(a != "reuse" for a in out["actions"])
    assert out["versions"] == out["engine"].versions.tolist()
    for rec in out["rounds"]:
        assert rec["transforms_per_s"] > 0 and rec["maintain_ms"] > 0
        assert set(rec["maintain_split_ms"]) == {"drift", "action",
                                                 "install", "post_drift"}
    if "--ragged" in extra:
        assert seen[0][2] == 3 and sorted(out["stats"]) == [16, 32]
    else:
        assert seen[0][2] == (3, 3, 16)
        assert out["stats"]["updates"] == 6
    if "--directed" in extra:
        assert "refresh" not in "".join(out["actions"])
    assert "round 1: action=" in text and "graph-transforms/s" in text
    # --dynamic implies --fgft
    assert serve.main(["--dynamic", "--graphs", "2", "--graph-n", "12",
                       "--graph-sizes", "6,12", "--update-rounds", "1",
                       "--filter-steps", "1", "--signals", "2",
                       "--device", "cpu"] + extra)["stats"] is not None
