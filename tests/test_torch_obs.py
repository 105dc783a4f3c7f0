"""The port's observability layer (``repro_torch.obs``) against the JAX
package's: the same scripted counter, gauge and histogram operations and
the same spans under a fake clock export byte-equal JSON, Prometheus
text, Chrome traces and JSONL; snapshots of the two packages merge into
what the JAX merge gives; ``configure(enabled=False)`` turns off both of
the port's singletons and none of the JAX package's; and the
instrumented layers of the port (plan cache, checkpoint store, refit
controller, dynamic engine, CLI) record what the JAX package's do.
Each side is read from its own registry and tracer, never the other's."""
import json
import time

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.obs.trace import Tracer as JaxTracer
from repro_torch import obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer


class FakeClock:
    def __init__(self, t=0.0, step=0.0):
        self.t = float(t)
        self.step = float(step)

    def __call__(self):
        now = self.t
        self.t += self.step
        return now


@pytest.fixture
def recording_on():
    """Restore both packages' switches whatever a test does to them."""
    yield
    obs.configure(enabled=True)
    jobs.configure(enabled=True)


def _script(reg):
    """One scripted run of every metric kind, bound and unbound paths."""
    c = reg.counter("reqs_total", "requests", ("tier",))
    c.inc(tier="full")
    c.labels(tier="draft").inc(2.5)
    c.inc(4, tier="full")
    g = reg.gauge("version", "live version", ("family",))
    g.set(3, family="sym")
    g.labels(family="general").set(-1.25)
    h = reg.histogram("stage_seconds", "latency", ("stage",))
    for v in (0.0, 1e-4, 3e-4, 0.02, 7.5):
        h.observe(v, stage="queue")
    h.labels(stage="execute").observe_many(2e-3, 5)
    h.observe_seq([1e-5, 0.5, 100.0], stage="execute")
    e = reg.histogram("edges", "custom ladder", (),
                      edges=(0.0, 1.0, float("inf")))
    e.observe(0.5)
    e.observe(2.0)
    reg.counter("plain_total").inc()
    return reg.collect()


def test_metric_exports_byte_equal():
    jsnap, tsnap = _script(JaxRegistry()), _script(MetricsRegistry())
    assert obs.to_json(tsnap) == jobs.to_json(jsnap)
    assert obs.to_prometheus_text(tsnap) == jobs.to_prometheus_text(jsnap)
    assert obs.format_snapshot(tsnap) == jobs.format_snapshot(jsnap)
    assert obs.geometric_edges(1e-3, 3.0, 7) == jobs.geometric_edges(
        1e-3, 3.0, 7)


def test_merge_snapshots_across_packages():
    jsnap, tsnap = _script(JaxRegistry()), _script(MetricsRegistry())
    for a, b in ((jsnap, tsnap), (tsnap, jsnap)):
        assert obs.merge_snapshots(a, b) == jobs.merge_snapshots(a, b)
    merged = obs.merge_snapshots(jsnap, tsnap)
    assert merged["reqs_total"]["series"][1]["value"] == 10.0
    hist = [{"le_s": le, "count": k} for le, k in
            zip(obs.geometric_edges(), range(28))]
    assert obs.merge_histograms(hist, hist) == jobs.merge_histograms(
        hist, hist)
    other = MetricsRegistry()
    other.gauge("reqs_total", "", ("tier",))
    with pytest.raises(ValueError, match="cannot merge"):
        obs.merge_snapshots(jsnap, other.collect())


def _trace(tracer):
    tracer.add_span("request/queue", 0.0, 2.0, cat="serve", trace_id=7,
                    tid=11)
    tracer.add_spans([("request/batch", 2.0, 3.0, "serve", 7, 11, None),
                      ("request", 0.0, 4.0, "serve", 7, 11,
                       {"graph": 1, "tier": "full"})])
    tracer.event("refit_decision", cat="maintain",
                 args={"action": "refresh", "drift": 0.5})
    with tracer.span("plan_compile", cat="compile", args={"n": 16}):
        pass
    tracer.event("serve_swap", ts=9.0)


def test_trace_exports_byte_equal(tmp_path):
    jt, tt = JaxTracer(clock=FakeClock(step=1.0)), Tracer(
        clock=FakeClock(step=1.0))
    _trace(jt)
    _trace(tt)
    assert tt.spans() == jt.spans()
    assert tt.spans(trace_id=7) == jt.spans(trace_id=7)
    for name in ("export_chrome_trace", "export_jsonl"):
        a = getattr(jt, name)(tmp_path / f"jax_{name}")
        b = getattr(tt, name)(tmp_path / f"torch_{name}")
        assert b.read_bytes() == a.read_bytes()
    loaded = json.loads((tmp_path / "torch_export_chrome_trace")
                        .read_text())
    assert len(loaded["traceEvents"]) == 6
    small = Tracer(capacity=2)
    _trace(small)
    assert len(small) == 2


def test_configure_switches_both_port_singletons(recording_on):
    probe = obs.counter("obs_port_switch_total")
    jprobe = jobs.counter("obs_port_switch_total")
    tracer = obs.default_tracer()
    before = len(tracer)
    obs.configure(enabled=False)
    assert not obs.recording_enabled() and not tracer.enabled
    assert jobs.recording_enabled() and jobs.default_tracer().enabled
    probe.inc()
    tracer.event("ignored")
    jprobe.inc()
    assert probe.value() == 0.0 and len(tracer) == before
    assert jprobe.value() == 1.0
    obs.configure(enabled=True, trace_clock=FakeClock(t=5.0))
    probe.inc()
    tracer.event("kept")
    assert probe.value() == 1.0
    assert tracer.spans(name="kept")[-1]["ts"] == 5.0
    obs.configure(trace_clock=time.monotonic)
    assert obs.default_registry() is not jobs.default_registry()
    assert obs.default_tracer() is not jobs.default_tracer()


def test_export_metrics_merges_on_disk(tmp_path):
    c = obs.counter("obs_port_export_total")
    c.inc()
    first = json.loads(obs.export_metrics(tmp_path)["json"].read_text())
    v0 = first["obs_port_export_total"]["series"][0]["value"]
    c.inc(2.0)
    obs.export_metrics(tmp_path)
    second = json.loads((tmp_path / "metrics.json").read_text())
    assert second["obs_port_export_total"]["series"][0]["value"] \
        == v0 + (v0 + 2.0)
    assert "obs_port_export_total" in (tmp_path / "metrics.prom") \
        .read_text()
    assert obs.METRICS_DIR_ENV == jobs.METRICS_DIR_ENV


def test_compile_spans_equal_plan_cache_misses(sym_batch48):
    from repro_torch.interop import basis_from_numpy
    from repro_torch.kernels.plan import clear_plan_cache, plan_cache_stats
    from repro_torch.launch.serve import FGFTServeEngine
    mats, jb = sym_batch48
    factors = {k: np.asarray(getattr(jb.factors, k))
               for k in ("i", "j", "c", "s", "sigma")}
    basis = basis_from_numpy("sym", jb.n, factors, np.asarray(jb.spectrum),
                             device="cpu")
    tracer = obs.default_tracer()
    clear_plan_cache()
    tracer.clear()
    hits = obs.default_registry().counter(
        "plan_cache_hits_total", "", ("family", "mode", "backend", "n"))
    h0 = hits.value(family="sym", mode="operator", backend="torch", n=16)
    engine = FGFTServeEngine(np.array(mats), basis=basis,
                             tiers={"full": 1.0, "draft": 0.5},
                             filters="heat", device="cpu")
    engine.step(torch.zeros(3, 2, 16))
    stats = plan_cache_stats()
    events = tracer.spans(cat="compile")
    assert stats["misses"] > 0
    assert len(events) == stats["misses"]
    assert {e["name"] for e in events} == {"plan_compile"}
    assert {e["args"]["mode"] for e in events} >= {"operator", "bank"}
    FGFTServeEngine(np.array(mats), basis=basis,
                    tiers={"full": 1.0, "draft": 0.5}, filters="heat",
                    device="cpu")
    after = plan_cache_stats()
    assert len(tracer.spans(cat="compile")) == after["misses"] \
        == stats["misses"]
    assert after["hits"] > stats["hits"]
    assert hits.value(family="sym", mode="operator", backend="torch",
                      n=16) > h0


def test_refit_decisions_land_in_timeline_and_trace():
    from repro_torch.dynamic.refit import Action, RefitController
    tracer = obs.default_tracer()
    before = len(tracer.spans(name="refit_decision"))
    ctl = RefitController()
    ctl.record(Action.REFRESH, post_drift=0.01, drift=0.5)
    ctl.record(Action.REUSE, post_drift=0.0)
    assert [e["action"] for e in ctl.timeline] == ["refresh", "reuse"]
    events = tracer.spans(name="refit_decision")[before:]
    assert [e["args"] for e in events] == list(ctl.timeline)
    assert events[0]["cat"] == "maintain"
    assert events[0]["args"]["drift"] == 0.5


def test_checkpoint_spans_and_counters(tmp_path):
    from repro_torch.checkpoint.store import (restore_checkpoint,
                                              save_checkpoint)
    tracer = obs.default_tracer()
    saves = obs.counter("checkpoint_saves_total")
    restores = obs.counter("checkpoint_restores_total")
    s0, r0 = saves.value(), restores.value()
    n_save = len(tracer.spans(name="checkpoint_save"))
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": np.ones(4, np.int32)}
    save_checkpoint(tmp_path, 3, state, shards=2)
    restored, step, _ = restore_checkpoint(tmp_path, state)
    assert step == 3 and torch.equal(restored["w"], state["w"])
    assert saves.value() == s0 + 1 and restores.value() == r0 + 1
    (save,) = tracer.spans(name="checkpoint_save")[n_save:]
    assert save["cat"] == "checkpoint"
    assert save["args"] == {"step": 3, "leaves": 2, "shards": 2,
                            "bytes": 6 * 4 + 4 * 4}
    restore = tracer.spans(name="checkpoint_restore")[-1]
    assert restore["cat"] == "checkpoint"
    assert restore["args"] == {"step": 3, "leaves": 2, "shards": 2}


def test_maintain_and_swap_events():
    from repro_torch.core.fgft import laplacian
    from repro_torch.dynamic import RefitPolicy
    from repro_torch.graphs import erdos_renyi, weight_jitter
    from repro_torch.launch.serve import FGFTServeEngine
    laps = np.stack([laplacian(erdos_renyi(12, 0.4, seed=s))
                     for s in range(2)])
    engine = FGFTServeEngine(laps, 24, n_iter=1, dynamic=True,
                             policy=RefitPolicy(refresh=1e-9, extend=10.0,
                                                refit=10.0, num_probes=16),
                             device="cpu")
    tracer = obs.default_tracer()
    reg = obs.default_registry()
    actions = reg.counter("maintain_actions_total", "", ("action",))
    swaps = reg.counter("serve_swaps_total", "", ("family",))
    n_maint = len(tracer.spans(name="maintain"))
    n_swap = len(tracer.spans(name="serve_swap"))
    r0, s0 = actions.value(action="reuse"), swaps.value(family="sym")
    assert engine.maintain()["action"] == "reuse"
    adj = np.abs(laps[0]) * (1 - np.eye(12))
    engine.apply_updates(0, weight_jitter(adj.astype(np.float32), 6,
                                          scale=0.2, seed=1))
    res = engine.maintain()
    assert res["action"] == "refresh"
    events = tracer.spans(name="maintain")[n_maint:]
    assert [e["args"]["action"] for e in events] == ["reuse", "refresh"]
    assert events[1]["cat"] == "maintain"
    assert events[1]["args"]["swap_version"] == res["swap_version"] == 1
    assert events[1]["args"]["post_drift_max"] == float(
        np.max(res["post_drift"]))
    (swap,) = tracer.spans(name="serve_swap")[n_swap:]
    assert swap["args"]["version"] == 1 and swap["args"]["family"] == "sym"
    assert actions.value(action="reuse") == r0 + 1
    assert swaps.value(family="sym") == s0 + 1
    assert reg.gauge("serve_version", "", ("family",)).value(
        family="sym") == 1.0
    drift = reg.gauge("serve_drift_score", "", ("graph",))
    assert drift.value(graph=1) == float(res["post_drift"][1])


def test_export_obs_runs_when_serving_raises(tmp_path, monkeypatch):
    from repro_torch.launch import serve

    def boom(args):
        obs.default_tracer().event("before_failure")
        raise RuntimeError("serving failed")

    monkeypatch.setattr(serve, "serve_fgft", boom)
    trace, mdir = tmp_path / "t.json", tmp_path / "m"
    with pytest.raises(RuntimeError, match="serving failed"):
        serve.main(["--fgft", "--device", "cpu", "--trace", str(trace),
                    "--metrics-dir", str(mdir)])
    names = {e["name"] for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "before_failure" in names
    assert json.loads((mdir / "metrics.json").read_text())
    assert (mdir / "metrics.prom").read_text()
