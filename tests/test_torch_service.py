"""The port's async front end (``repro_torch.launch.service``) against the
JAX package's: the same request script through both services, each with
``auto_start=False``/``drain_once`` and a fake clock, gives the same
batches, occupancy, shed counts, ``stats()`` counters and latency figures
exactly, and answers within ``1e-5 * max(1, max|y|)``; SLO stats saved by
one package are read by the other's ``load_slo_stats``.  Then the JAX
package's fake-clock cases of the service (exact SLO arithmetic,
admission control, coalescing equal to the per-request loop — bitwise
for the G family —, maintenance accounting, persistence) and of its
observability (spans that telescope exactly, the obs snapshot in
``stats()``) on the port's service alone."""
import json

import numpy as np
import pytest

import jax.numpy as jnp
from repro.core import ApproxEigenbasis as JaxBasis
from repro.launch.serve import FGFTServeEngine as JaxEngine
from repro.launch.service import AsyncFGFTService as JaxService
from repro.launch.service import LatencyRecorder as JaxRecorder
from repro.launch.service import load_slo_stats as jax_load_slo_stats
from repro_torch import obs
from repro_torch.interop import basis_from_numpy
from repro_torch.launch import service as svc_mod
from repro_torch.launch.serve import FGFTServeEngine, RaggedFGFTServeEngine
from repro_torch.launch.service import (AsyncFGFTService, LatencyRecorder,
                                        ServiceClosed, ShedError,
                                        load_slo_stats, merge_histograms,
                                        quantize_rows)

lowpass = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
TIERS = {"full": 1.0, "draft": 0.5}
FIELDS = {"sym": ("i", "j", "c", "s", "sigma"),
          "general": ("kind", "i", "j", "a")}


class FakeClock:
    """Injectable monotonic clock: advances only when told to (or by
    ``step`` per read), so every latency figure is exact arithmetic."""

    def __init__(self, t=0.0, step=0.0):
        self.t = float(t)
        self.step = float(step)

    def __call__(self):
        now = self.t
        self.t += self.step
        return now

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _reap_port_services():
    """The thread-leak guard of tests/conftest.py reaps the JAX package's
    services only: close any port service a failing test left open."""
    yield
    svc_mod.shutdown_all_services()


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


@pytest.fixture(scope="module")
def sym_pair(sym_batch48):
    """(JAX engine, port engine) on one JAX fit (B = 3, n = 16, g = 48)."""
    mats, jb = sym_batch48
    je = JaxEngine(mats, basis=jb, tiers=TIERS, filters="heat,lowpass")
    te = FGFTServeEngine(np.array(mats), basis=_carry(jb), tiers=TIERS,
                         filters="heat,lowpass", device="cpu")
    return je, te


@pytest.fixture(scope="module")
def gen_pair():
    mats = np.random.default_rng(7).standard_normal(
        (2, 12, 12)).astype(np.float32)
    jb = JaxBasis.fit(jnp.asarray(mats), 24, n_iter=1, kind="general")
    je = JaxEngine(jnp.asarray(mats), basis=jb, tiers=TIERS)
    te = FGFTServeEngine(mats, basis=_carry(jb), tiers=TIERS, device="cpu")
    return je, te


@pytest.fixture(scope="module")
def ragged_engine():
    def s(n, seed):
        x = np.random.default_rng(seed).standard_normal((n, n)).astype(
            np.float32)
        return x + x.T

    # sizes 6/12/7 -> buckets {8: [0, 2], 16: [1]}: two dispatch groups
    return RaggedFGFTServeEngine([s(6, 0), s(12, 1), s(7, 2)], 16,
                                 n_iter=1, tiers={"full": 1.0},
                                 device="cpu")


def signals_for(engine, gid, rows, seed):
    n = (engine.sizes[gid] if isinstance(engine, RaggedFGFTServeEngine)
         else engine.basis.n)
    return np.random.default_rng(seed).standard_normal(
        (rows, n)).astype(np.float32)


def drain_all(service):
    """Pump the queue inline until empty; returns dispatch batch sizes."""
    sizes = []
    while True:
        n = service.drain_once()
        if n == 0:
            return sizes
        sizes.append(n)


# ---------------------------------------------------------------------------
# One request script through both packages' services
# ---------------------------------------------------------------------------


def _run_script(cls, engine, script, h, **kwargs):
    """Submit ``script`` ((graph, rows, seed, tier, bank) entries; None
    drains one batch; ("tick", dt) advances the clock), then drain; returns
    the batch sizes, shed ids, results and stats without the obs
    snapshot."""
    clock = FakeClock(step=1.0)
    svc = cls(engine, h=h, clock=clock, auto_start=False, **kwargs)
    batches, shed, futs = [], [], []
    for k, item in enumerate(script):
        if item is None:
            batches.append(svc.drain_once())
        elif item[0] == "tick":
            clock.advance(item[1])
        else:
            gid, rows, seed, tier, bank = item
            gid %= len(svc._routes)             # the general fleet has 2
            x = signals_for(engine, gid, rows, seed)
            try:
                futs.append(svc.submit(gid, x, tier=tier, bank=bank))
            except ShedError:
                shed.append(k)
            except Exception as exc:  # the JAX package's ShedError
                assert type(exc).__name__ == "ShedError"
                shed.append(k)
    batches += drain_all(svc)
    results = [f.result(timeout=0) for f in futs]
    stats = svc.stats()
    stats.pop("obs")
    svc.close()
    return batches, shed, results, stats


SCRIPTS = {
    "tiers": [(0, 1, 1, "full", False), (1, 3, 2, "full", False),
              (2, 2, 3, "draft", False), ("tick", 0.25),
              (0, 2, 4, "full", False), None, (1, 1, 5, "draft", False),
              (0, 4, 6, "full", False), (2, 1, 7, "full", False),
              (1, 2, 8, "full", False), (2, 3, 9, "draft", False),
              ("tick", 3.0), (0, 1, 10, None, False)],
    "shed": [(k % 3, 1 + k % 2, 20 + k, "full" if k % 2 else "draft",
              False) for k in range(7)] + [None, (1, 2, 40, "full", False)],
    "bank": [(0, 1, 50, None, True), (1, 2, 51, None, True),
             (0, 3, 52, None, True), (2, 1, 53, "draft", False),
             (2, 2, 54, None, True)],
}


@pytest.mark.parametrize("family,name", [
    ("sym", "tiers"), ("sym", "shed"), ("sym", "bank"),
    ("general", "tiers")])
def test_script_matches_jax_service(family, name, sym_pair, gen_pair):
    je, te = sym_pair if family == "sym" else gen_pair
    script = SCRIPTS[name]
    kwargs = dict(max_queue=5, max_batch=3) if name == "shed" else {}
    h = None if name == "bank" else lowpass
    jb, jshed, jres, jstats = _run_script(JaxService, je, script, h,
                                          **kwargs)
    tb, tshed, tres, tstats = _run_script(AsyncFGFTService, te, script, h,
                                          **kwargs)
    assert tb == jb and tshed == jshed
    assert tstats == jstats                 # counters and latency, exactly
    assert len(tres) == len(jres) > 0
    for a, b in zip(tres, jres):
        assert (a.graph_id, a.tier, a.version, a.batch_size) == \
            (b.graph_id, b.tier, b.version, b.batch_size)
        assert (a.queue_s, a.service_s, a.total_s) == \
            (b.queue_s, b.service_s, b.total_s)
        assert a.y.shape == b.y.shape
        _close(a.y, b.y)
    if name == "shed":
        assert tstats["shed"] == len(tshed) > 0
    assert max(r.batch_size for r in tres) > 1


def test_slo_stats_cross_read(sym_pair, ragged_engine, tmp_path):
    je, te = sym_pair
    for cls, eng, reader in ((JaxService, je, load_slo_stats),
                             (AsyncFGFTService, te, jax_load_slo_stats)):
        svc = cls(eng, auto_start=False, clock=FakeClock(step=1.0))
        svc.submit(0, signals_for(te, 0, 1, 60))
        svc.drain_once()
        out = tmp_path / cls.__module__
        svc.save(out)
        slo = reader(out)
        assert slo["served"] == 1 and slo["dispatches"] == 1
        assert slo["latency"]["full/total"]["max_s"] == 3.0
        assert "service_requests_total" in slo["obs"]
        svc.close()
    svc = AsyncFGFTService(ragged_engine, auto_start=False)
    svc.submit(1, signals_for(ragged_engine, 1, 2, 61))
    svc.drain_once()
    router_dir = svc.save(tmp_path / "router")
    assert (router_dir / "slo.json").exists()
    assert jax_load_slo_stats(router_dir) == load_slo_stats(router_dir)
    assert load_slo_stats(router_dir)["queue"]["max"] == svc.max_queue
    with pytest.raises(FileNotFoundError):
        load_slo_stats(tmp_path / "nothing")


# ---------------------------------------------------------------------------
# quantize_rows and LatencyRecorder: pure arithmetic, as the JAX package's
# ---------------------------------------------------------------------------


def test_quantize_rows_ladder():
    assert [quantize_rows(r) for r in (1, 7, 8, 9, 16, 17)] == \
        [8, 8, 8, 16, 16, 32]
    assert [quantize_rows(r, 3) for r in (1, 3, 4, 6, 7)] == \
        [3, 3, 6, 6, 12]
    for bad in (dict(rows=0), dict(rows=4, quantum=0)):
        with pytest.raises(ValueError):
            quantize_rows(**bad)


def test_recorder_matches_jax():
    recs = (LatencyRecorder(max_samples=4), JaxRecorder(max_samples=4))
    for rec in recs:
        for ms in (10, 1, 7, 3, 3, 9, 0, 2):
            rec.record("t", ms * 1e-3)
        rec.record("u", 1.5)
    a, b = recs
    assert a.summary() == b.summary()
    for q in (0.0, 50.0, 99.0, 100.0):
        assert a.percentile("t", q) == b.percentile("t", q)
    assert a.histogram("t") == b.histogram("t")
    assert a.summary()["t"]["count"] == 8
    assert a.summary()["t"]["max_s"] == pytest.approx(10e-3)
    assert a.percentile("t", 100.0) == pytest.approx(9e-3)   # window of 4
    merged = merge_histograms(a.histogram("t"), a.histogram("u"))
    assert sum(x["count"] for x in merged) == 5
    with pytest.raises(ValueError):
        merge_histograms(a.histogram("t"), a.histogram("t", bucket_count=8))
    with pytest.raises(ValueError):
        a.record("t", -1e-3)
    with pytest.raises(ValueError):
        a.record("t", float("nan"))
    with pytest.raises(KeyError):
        a.percentile("missing", 50.0)
    with pytest.raises(ValueError):
        a.percentile("t", 101.0)
    with pytest.raises(ValueError):
        LatencyRecorder(max_samples=0)


# ---------------------------------------------------------------------------
# The JAX package's fake-clock cases, on the port's service
# ---------------------------------------------------------------------------


def test_queue_latency_is_exact(sym_pair):
    _, eng = sym_pair
    clock = FakeClock()
    svc = AsyncFGFTService(eng, clock=clock, auto_start=False)
    fut = svc.submit(0, signals_for(eng, 0, 2, 0))
    clock.advance(0.25)
    assert svc.drain_once() == 1
    res = fut.result(timeout=0)
    assert res.queue_s == pytest.approx(0.25)
    assert res.service_s == 0.0
    assert res.total_s == pytest.approx(0.25)
    assert res.graph_id == 0 and res.tier == "full" and res.batch_size == 1
    assert res.version == eng._live.version
    lat = svc.stats()["latency"]
    assert lat["full/queue"]["p50_s"] == pytest.approx(0.25)
    assert lat["full/total"]["count"] == 1


def test_percentiles_from_scripted_waits(sym_pair):
    _, eng = sym_pair
    clock = FakeClock()
    svc = AsyncFGFTService(eng, clock=clock, max_batch=1, auto_start=False)
    for w in [0.001 * k for k in range(1, 11)]:
        fut = svc.submit(1, signals_for(eng, 1, 1, 2))
        clock.advance(w)
        svc.drain_once()
        assert fut.result(timeout=0).queue_s == pytest.approx(w)
    lat = svc.stats()["latency"]["full/queue"]
    assert lat["count"] == 10
    assert lat["p50_s"] == pytest.approx(0.005)
    assert lat["p99_s"] == pytest.approx(0.010)
    assert lat["mean_s"] == pytest.approx(0.0055)


def test_admission_control_sheds_typed(sym_pair):
    _, eng = sym_pair
    svc = AsyncFGFTService(eng, max_queue=2, auto_start=False)
    x = signals_for(eng, 0, 1, 3)
    svc.submit(0, x)
    svc.submit(1, x)
    with pytest.raises(ShedError) as err:
        svc.submit(2, x)
    assert (err.value.queue_depth, err.value.max_queue,
            err.value.graph_id) == (2, 2, 2)
    st = svc.stats()
    assert st["shed"] == 1 and st["submitted"] == 2
    assert st["queue"]["depth"] == 2 and st["queue"]["peak"] == 2
    drain_all(svc)
    assert svc.stats()["served"] == 2


def test_coalescing_groups_and_occupancy(sym_pair):
    _, eng = sym_pair
    svc = AsyncFGFTService(eng, max_batch=8, auto_start=False)
    x = signals_for(eng, 0, 2, 4)
    futs = [svc.submit(0, x, tier="full"), svc.submit(1, x, tier="full"),
            svc.submit(2, x, tier="draft"), svc.submit(0, x, tier="full")]
    assert svc.drain_once() == 3
    assert [f.done() for f in futs] == [True, True, False, True]
    assert futs[0].result(timeout=0).batch_size == 3
    assert svc.drain_once() == 1
    st = svc.stats()
    assert st["dispatches"] == 2 and st["served"] == 4
    assert st["batch"]["occupancy_mean"] == pytest.approx(2.0)
    assert st["batch"]["occupancy_max"] == 3
    svc5 = AsyncFGFTService(eng, max_batch=2, auto_start=False)
    for _ in range(5):
        svc5.submit(0, x[:1])
    assert drain_all(svc5) == [2, 2, 1]


def test_submit_validation(sym_pair, gen_pair):
    _, eng = sym_pair
    svc = AsyncFGFTService(eng, auto_start=False)
    x = signals_for(eng, 0, 1, 6)
    for gid in (3, -1):
        with pytest.raises(ValueError, match="not in fleet"):
            svc.submit(gid, x)
    with pytest.raises(ValueError, match="must be"):
        svc.submit(0, x[:, :5])
    with pytest.raises(ValueError, match="unknown tier"):
        svc.submit(0, x, tier="turbo")
    with pytest.raises(ValueError, match="tiered or bank"):
        svc.submit(0, x, tier="full", bank=True)
    fut = svc.submit(0, x[0])               # 1-D promotes to one row
    svc.drain_once()
    assert fut.result(timeout=0).y.shape == (1, eng.basis.n)
    gsvc = AsyncFGFTService(gen_pair[1], auto_start=False)
    with pytest.raises(ValueError, match="bank requests unavailable"):
        gsvc.submit(0, signals_for(gen_pair[1], 0, 1, 7), bank=True)
    for bad in (dict(max_queue=0), dict(max_batch=0)):
        with pytest.raises(ValueError):
            AsyncFGFTService(eng, auto_start=False, **bad)


def test_lifecycle(sym_pair):
    _, eng = sym_pair
    svc = AsyncFGFTService(eng, auto_start=False)
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit(0, signals_for(eng, 0, 1, 8))
    with pytest.raises(ServiceClosed):
        svc.start()
    # a STARTED service answers every accepted future before its
    # dispatcher exits
    svc = AsyncFGFTService(eng)
    x = signals_for(eng, 0, 2, 9)
    futs = [svc.submit(i % 3, x) for i in range(12)]
    svc.close(timeout=30)
    assert all(f.done() for f in futs)
    assert svc.stats()["served"] == 12
    assert svc.maintain_stream is None      # the CPU takes no stream


def test_reset_stats_and_dispatch_errors(sym_pair, monkeypatch):
    _, eng = sym_pair
    svc = AsyncFGFTService(eng, auto_start=False)
    x = signals_for(eng, 0, 1, 11)
    svc.submit(0, x)
    svc.drain_once()
    svc.reset_stats()
    st = svc.stats()
    assert st["submitted"] == st["served"] == st["dispatches"] == 0
    assert st["latency"] == {}
    boom = svc.submit(0, x)
    monkeypatch.setattr(
        svc, "_fused_dispatch",
        lambda batch: (_ for _ in ()).throw(RuntimeError("device lost")))
    svc.drain_once()
    with pytest.raises(RuntimeError, match="device lost"):
        boom.result(timeout=0)
    monkeypatch.undo()
    ok = svc.submit(0, x)
    svc.drain_once()
    assert ok.result(timeout=0).y.shape == (1, eng.basis.n)
    st = svc.stats()
    assert st["errors"] == 1 and st["served"] == 1


# ---------------------------------------------------------------------------
# Coalescing equivalence: fused micro-batch == per-request loop
# ---------------------------------------------------------------------------


def reference_loop(engine, requests, h=None):
    """The same service machinery capped at one request per dispatch."""
    svc = AsyncFGFTService(engine, h=h, max_batch=1, auto_start=False)
    outs = []
    for gid, x, tier, bank in requests:
        fut = svc.submit(gid, x, tier=tier, bank=bank)
        svc.drain_once()
        outs.append(fut.result(timeout=0))
    return outs


def coalesced(engine, requests, h=None, max_batch=8):
    svc = AsyncFGFTService(engine, h=h, max_batch=max_batch,
                           auto_start=False)
    futs = [svc.submit(gid, x, tier=tier, bank=bank)
            for gid, x, tier, bank in requests]
    drain_all(svc)
    return [f.result(timeout=0) for f in futs]


def request_mix(engine, bank=False):
    reqs = []
    for i, (gid, rows) in enumerate(
            [(0, 1), (1, 3), (0, 2), (2, 1), (1, 1), (2, 4)]):
        tier = None if bank else ("full" if i % 2 == 0 else "draft")
        reqs.append((gid, signals_for(engine, gid, rows, 20 + i),
                     tier, bank))
    return reqs


@pytest.mark.parametrize("bank", [False, True], ids=["tiers", "bank"])
def test_equivalence_sym_bitwise(sym_pair, bank):
    _, eng = sym_pair
    reqs = request_mix(eng, bank=bank)
    h = None if bank else lowpass
    ref = reference_loop(eng, reqs, h)
    got = coalesced(eng, reqs, h)
    for a, b in zip(got, ref):
        assert a.y.shape == b.y.shape
        assert np.array_equal(a.y, b.y)
    assert max(r.batch_size for r in got) > 1
    if bank:
        assert got[1].y.shape == (len(eng.bank), 3, eng.basis.n)
    full = [(i % 3, signals_for(eng, i % 3, 2, 31 + i), "full", False)
            for i in range(8)]
    got = coalesced(eng, full, max_batch=8)
    assert got[0].batch_size == 8
    for a, b in zip(got, reference_loop(eng, full)):
        assert np.array_equal(a.y, b.y)


def test_equivalence_general_and_ragged(gen_pair, ragged_engine):
    eng = gen_pair[1]
    reqs = [(i % 2, signals_for(eng, i % 2, 1 + i % 3, 40 + i),
             "full" if i % 2 == 0 else "draft", False) for i in range(6)]
    for a, b in zip(coalesced(eng, reqs, lowpass),
                    reference_loop(eng, reqs, lowpass)):
        assert np.array_equal(a.y, b.y)     # T: every row on its own
    reqs = [(gid, signals_for(ragged_engine, gid, rows, 50 + gid), "full",
             False)
            for gid, rows in [(0, 2), (1, 1), (2, 3), (0, 1), (1, 2)]]
    ref = reference_loop(ragged_engine, reqs, lowpass)
    got = coalesced(ragged_engine, reqs, lowpass)
    for (gid, x, _, _), a, b in zip(reqs, got, ref):
        assert a.y.shape == (x.shape[0], ragged_engine.sizes[gid])
        assert np.array_equal(a.y, b.y)
    # buckets never share a dispatch
    assert [r.batch_size for r, (gid, *_) in zip(got, reqs)
            if gid in (0, 2)] == [3, 3, 3]
    assert [r.batch_size for r, (gid, *_) in zip(got, reqs)
            if gid == 1] == [2, 2]


# ---------------------------------------------------------------------------
# Maintenance accounting and persistence
# ---------------------------------------------------------------------------


@pytest.fixture()
def dyn_engine():
    from repro_torch.core.fgft import laplacian
    from repro_torch.dynamic import RefitPolicy
    from repro_torch.graphs import erdos_renyi
    laps = np.stack([laplacian(erdos_renyi(12, 0.4, seed=s))
                     for s in range(2)])
    return FGFTServeEngine(laps, 24, n_iter=1, dynamic=True,
                           policy=RefitPolicy(refresh=1e-9, extend=10.0,
                                              refit=10.0, num_probes=16,
                                              max_extends=0),
                           device="cpu")


def test_maintain_now_inline_counts_swaps(dyn_engine, sym_pair):
    from repro_torch.graphs import weight_jitter
    svc = AsyncFGFTService(dyn_engine, auto_start=False)
    v0 = dyn_engine._live.version
    assert svc.maintain_now()["action"] == "reuse"
    adj = (np.abs(dyn_engine._laps[0].numpy()) * (1 - np.eye(12))).astype(
        np.float32)
    dyn_engine.apply_updates(0, weight_jitter(adj, 6, scale=0.2, seed=1))
    assert svc.maintain_now()["action"] != "reuse"
    assert dyn_engine._live.version == v0 + 1
    assert svc.stats()["maintain"] == {"enabled": True, "ticks": 2,
                                       "errors": 0, "swaps": 1}
    static = AsyncFGFTService(sym_pair[1], auto_start=False)
    with pytest.raises(ValueError, match="dynamic"):
        static.maintain_now()
    assert static.stats()["maintain"]["enabled"] is False


# ---------------------------------------------------------------------------
# Observability of the service: exact spans, the snapshot in stats()
# ---------------------------------------------------------------------------


def test_service_spans_telescope_exactly(sym_pair):
    _, eng = sym_pair
    tracer = obs.default_tracer()
    svc = AsyncFGFTService(eng, clock=FakeClock(step=1.0), auto_start=False,
                           max_batch=2, name="port-obs-exact")
    rng = np.random.default_rng(0)
    futs = [svc.submit(i % 3, rng.standard_normal((2, 16)).astype(
        np.float32)) for i in range(4)]
    while svc.drain_once():
        pass
    results = [f.result(timeout=0) for f in futs]
    snap = svc.stats()["obs"]
    svc.close()
    assert len({r.trace_id for r in results}) == len(results)
    for res in results:
        sp = {s["name"]: s for s in tracer.spans(trace_id=res.trace_id)}
        q, bt, ex, tot = (sp["request/queue"], sp["request/batch"],
                          sp["request/execute"], sp["request"])
        assert q["ts"] == tot["ts"]
        assert q["ts"] + q["dur"] == bt["ts"]
        assert bt["ts"] + bt["dur"] == ex["ts"]
        assert ex["ts"] + ex["dur"] == tot["ts"] + tot["dur"]
        assert q["dur"] + bt["dur"] + ex["dur"] == tot["dur"] == res.total_s
        assert q["dur"] + bt["dur"] == res.queue_s
        assert ex["dur"] == res.service_s
        assert tot["args"] == {"graph": res.graph_id, "tier": "full",
                               "version": res.version,
                               "batch_size": res.batch_size}
        assert q["args"] == bt["args"] == ex["args"] == {}
    mine = [s for s in snap["service_requests_total"]["series"]
            if s["labels"]["service"] == "port-obs-exact"]
    assert mine and mine[0]["value"] == 4.0
    assert any(s["labels"]["service"] == "port-obs-exact"
               and s["labels"]["stage"] == "execute"
               for s in snap["service_stage_seconds"]["series"])
    assert json.loads(json.dumps(snap)) == snap


@pytest.mark.parametrize("extra", [
    ["--dynamic", "--churn", "0.05"],
    ["--ragged", "--graph-sizes", "6,12", "--graphs", "4"],
    ["--directed", "--filter", "heat,tikhonov"],
], ids=["dynamic", "ragged", "directed-bank"])
def test_cli_serve_async_writes_artifacts(extra, tmp_path, capsys):
    from repro_torch.launch import serve
    trace, mdir = tmp_path / "t.json", tmp_path / "m"
    out = serve.main(["--fgft", "--serve-async", "--graphs", "3",
                      "--graph-n", "12", "--load-requests", "12",
                      "--load-workers", "3", "--device", "cpu",
                      "--backend", "torch", "--trace", str(trace),
                      "--metrics-dir", str(mdir)] + extra)
    assert out["results"] == 12 and out["stats"]["errors"] == 0
    assert out["stats"]["served"] == 12
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e["name"] == "request" for e in events) >= 12
    snap = json.loads((mdir / "metrics.json").read_text())
    prom = (mdir / "metrics.prom").read_text()
    for name in ("service_requests_total", "plan_cache_misses_total"):
        assert name in snap and name in prom
    text = capsys.readouterr().out
    assert "[svc] served" in text and "[obs] chrome trace" in text
