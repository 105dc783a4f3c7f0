"""Versioned hot swaps of the port under real concurrency: threads hammer
the serving path while ``maintain()`` refreshes and swaps underneath.
Every response must be produced by exactly ONE serving version, bitwise
equal to that version's single-threaded answer, with no exception
anywhere, and shutdown returns the thread count to baseline (the JAX
package's ``tests/test_service_concurrency.py``, every wait bounded).
Then the tracked Laplacians under a concurrent update: an action runs on
the Laplacians as they stood when it started, as the JAX engine's
snapshot gives, and the update stays pending for the next tick.

The assertions are all on recorded VALUES (versions, outputs, counters),
never on timing; threads are joined before anything is checked."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import ApproxEigenbasis
from repro_torch.dynamic import GraphStream, RefitPolicy
from repro_torch.graphs import community_graph, erdos_renyi, weight_jitter
from repro_torch.launch.serve import FGFTServeEngine
from repro_torch.launch.service import (AsyncFGFTService,
                                        shutdown_all_services)

WAIT = 60.0


@pytest.fixture(autouse=True)
def _reap_port_services():
    """tests/conftest.py reaps the JAX package's services only."""
    yield
    shutdown_all_services()


def _alive_non_daemon():
    return {t for t in threading.enumerate()
            if t.is_alive() and not t.daemon}


@pytest.fixture()
def dyn_fleet():
    """(engine, stream): a 2-graph dynamic symmetric fleet whose refresh
    threshold is ~0, so every churn round forces a version swap."""
    adjs = [erdos_renyi(12, 0.4, seed=s) for s in range(2)]
    stream = GraphStream(adjs)
    engine = FGFTServeEngine(np.stack(stream.laplacians()), 24, n_iter=1,
                             dynamic=True,
                             policy=RefitPolicy(refresh=1e-9, extend=10.0,
                                                refit=10.0, num_probes=16,
                                                max_extends=0),
                             device="cpu")
    return engine, stream


def _churn(engine, stream, rnd):
    for gid in range(len(stream.adjs)):
        batch = weight_jitter(stream.adjs[gid], 6, scale=0.2,
                              seed=100 * rnd + gid)
        engine.apply_updates(gid, stream.apply(gid, batch))


def test_engine_step_versioned_no_torn_reads(dyn_fleet):
    """Concurrent step_versioned() during swaps returns (y, v) pairs
    where y is BITWISE the single-threaded answer of version v."""
    engine, stream = dyn_fleet
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4, 12)).astype(np.float32))
    engine.warmup(x)
    expected = {}

    def snapshot():
        y, v = engine.step_versioned(x)
        expected[v] = y.numpy().copy()

    snapshot()
    seen, errors = [], []
    stop = threading.Event()

    def hammer():
        try:
            while not stop.is_set():
                y, v = engine.step_versioned(x)
                seen.append((v, y.numpy().copy()))
        except BaseException as exc:  # noqa: BLE001 — joined + re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for rnd in range(5):
            _churn(engine, stream, rnd)
            engine.maintain()
            snapshot()
    finally:
        stop.set()
        for t in threads:
            t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(expected) >= 5
    assert seen
    for v, y in seen:
        assert v in expected, f"response carried unknown version {v}"
        assert np.array_equal(y, expected[v]), \
            f"torn read: output does not match version {v}"


def test_service_stress_versions_monotonic(dyn_fleet):
    """Tenant threads submit through the queue while the maintainer
    thread swaps versions: each tenant's versions are non-decreasing and
    every payload is finite."""
    engine, stream = dyn_fleet
    engine.warmup(torch.zeros((2, 8, 12)))
    baseline = _alive_non_daemon()
    rng = np.random.default_rng(1)
    svc = AsyncFGFTService(engine, max_queue=256, max_batch=4,
                           maintain_interval=None, name="stress")
    assert _alive_non_daemon() > baseline        # dispatcher + maintainer
    per_thread, errors = {}, []
    xs = [rng.standard_normal((2, 12)).astype(np.float32) for _ in range(6)]

    def tenant(k):
        versions = per_thread[k] = []
        try:
            for i in range(12):
                res = svc.submit((k + i) % 2, xs[k]).result(timeout=WAIT)
                assert np.isfinite(res.y).all()
                versions.append(res.version)
        except BaseException as exc:  # noqa: BLE001 — joined + re-raised below
            errors.append(exc)

    tenants = [threading.Thread(target=tenant, args=(k,))
               for k in range(6)]
    for t in tenants:
        t.start()
    try:
        for rnd in range(4):
            _churn(engine, stream, rnd)
            svc.maintain_now(timeout=WAIT)
    finally:
        for t in tenants:
            t.join(2 * WAIT)
    assert not any(t.is_alive() for t in tenants)
    assert not errors
    stats = svc.stats()
    svc.close(timeout=WAIT)
    assert stats["maintain"]["swaps"] >= 4
    assert stats["served"] == 6 * 12 and stats["errors"] == 0
    for k, versions in per_thread.items():
        assert len(versions) == 12
        assert versions == sorted(versions), \
            f"tenant {k} observed a version rollback: {versions}"
    assert _alive_non_daemon() == baseline


def test_maintain_failure_does_not_kill_serving(dyn_fleet, monkeypatch):
    engine, _ = dyn_fleet
    real_maintain = engine.maintain
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("probe matrix went singular")
        return real_maintain()

    monkeypatch.setattr(engine, "maintain", flaky)
    svc = AsyncFGFTService(engine, maintain_interval=None, name="flaky")
    try:
        with pytest.raises(RuntimeError, match="maintenance tick failed") \
                as err:
            svc.maintain_now(timeout=WAIT)
        assert isinstance(err.value.__cause__, ValueError)
        assert svc.maintain_now(timeout=WAIT)["action"] == "reuse"
        x = np.zeros((1, 12), np.float32)
        assert svc.submit(0, x).result(timeout=WAIT).y.shape == (1, 12)
        st = svc.stats()["maintain"]
        assert st["errors"] == 1 and st["ticks"] == 1
    finally:
        svc.close(timeout=WAIT)


def test_close_is_idempotent(dyn_fleet):
    engine, _ = dyn_fleet
    baseline = _alive_non_daemon()
    svc = AsyncFGFTService(engine, name="lifecycle")
    svc.close(timeout=WAIT)
    svc.close(timeout=WAIT)
    assert _alive_non_daemon() == baseline


def test_shutdown_all_services_reaps_leaks(dyn_fleet):
    engine, _ = dyn_fleet
    baseline = _alive_non_daemon()
    svc = AsyncFGFTService(engine, name="leaked")
    assert _alive_non_daemon() > baseline
    assert shutdown_all_services(timeout=WAIT) == 1
    assert _alive_non_daemon() == baseline
    assert shutdown_all_services(timeout=WAIT) == 0
    with pytest.raises(Exception):               # noqa: B017 — closed is closed
        svc.submit(0, np.zeros((1, 12), np.float32))


@pytest.mark.parametrize("action", ["extend", "refit"])
def test_action_runs_on_the_laplacians_it_started_with(action, monkeypatch):
    """An update lands while a forced EXTEND or REFIT runs (applied from
    inside the fit).  The new basis and its re-baseline must be those of
    the Laplacians as they stood when the action started, and the update
    must still be pending (dirty) for the next tick."""
    from repro_torch.dynamic.drift import relative_objective
    adjs = [community_graph(16, seed=s) for s in range(3)]
    stream = GraphStream(adjs)
    policy = (RefitPolicy(refresh=1e-9, extend=2e-9, refit=1.0,
                          max_extends=4) if action == "extend" else
              RefitPolicy(refresh=1e-9, extend=2e-9, refit=3e-9))
    engine = FGFTServeEngine(np.stack(stream.laplacians()), 48, n_iter=1,
                             dynamic=True, policy=policy, device="cpu")
    engine.apply_updates(1, stream.apply(1, weight_jitter(
        stream.adjs[1], 8, scale=0.3, seed=3)))
    late = stream.apply(2, weight_jitter(stream.adjs[2], 8, scale=0.3,
                                         seed=4))
    at_start = engine._laps.clone()
    live = engine.basis
    extra = max(int(round(policy.extend_fraction * engine._g0)), 1)
    if action == "extend":
        want = live.extend(at_start, live.num_transforms + extra, n_iter=0)
    else:
        want = ApproxEigenbasis.fit(at_start, engine._g0, n_iter=1,
                                    kind="sym", score=live.info.get("score"),
                                    stage_pad=engine._stage_pad,
                                    device="cpu")
    name = "extend" if action == "extend" else "fit"
    real = getattr(ApproxEigenbasis, name)
    landed = []

    def racing(*args, **kwargs):
        if not landed:
            landed.append(True)
            engine.apply_updates(2, late)        # a churn thread's update
        return real(*args, **kwargs)

    monkeypatch.setattr(ApproxEigenbasis, name,
                        racing if action == "extend" else
                        staticmethod(racing))
    res = engine.maintain()
    assert landed and res["action"] == action
    got = engine.basis
    assert got.objective.numpy().tobytes() == want.objective.numpy().tobytes()
    for a, b in zip(got.factors, want.factors):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    np.testing.assert_array_equal(
        engine._baseline, relative_objective(want.objective, at_start))
    # the update is tracked and still pending
    assert torch.equal(engine._laps[2],
                       at_start[2] + torch.from_numpy(late))
    assert engine._dirty.tolist() == [False, False, True]
    assert engine.maintain()["action"] != "reuse"
    assert not engine._dirty.any()
