"""Process-wide metrics registry: labeled counters, gauges and
histograms with FIXED bucket edges (the JAX package's registry,
copied for the port).

Three metric kinds, all thread-safe and all labeled:

  * ``Counter`` — monotone accumulator (requests served, plans
    compiled, checkpoints written).
  * ``Gauge`` — last-written value (live serving version, per-graph
    drift score at the last maintenance tick).
  * ``Histogram`` — bucketed distribution over a BOUNDED GEOMETRIC
    LADDER of edges (``geometric_edges``): the edge list is a function
    of (origin, base, count) only, NEVER of the recorded data, so two
    histograms from different runs/processes/machines merge bucket-by-
    position (``merge_histograms`` / ``merge_snapshots``).  A data-
    dependent edge list (one that grows with the largest sample) makes
    positional merge silently wrong; fixing the length is the whole
    point of the ladder.

``MetricsRegistry.collect()`` returns one SNAPSHOT-CONSISTENT dict:
every series is copied under a single registry lock, so a concurrent
recorder can never tear a half-updated histogram into the snapshot.
Snapshots are plain JSON-able dicts (``+inf`` edges survive Python's
json round trip) and feed two exposition formats: ``to_prometheus_text``
(cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` convention) and
``to_json``.  ``merge_snapshots`` folds runs together: counters and
histogram buckets add, gauges last-win — the cross-run story that
accumulates ``metrics.json`` across processes.

Recording can be globally disabled (``set_enabled(False)`` — the
package-level ``obs.configure(enabled=...)`` switch): every record call
becomes an early return, which is what a traced-vs-untraced throughput
comparison toggles.
"""
from __future__ import annotations

import json
import math
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "counter", "gauge", "histogram",
    "geometric_edges", "bucket_counts", "merge_histograms",
    "merge_snapshots", "to_prometheus_text", "to_json", "set_enabled",
    "recording_enabled",
]

#: default bounded geometric ladder: 0, then origin·base^i for
#: i in [0, count), then +inf — 1e-4·2^25 ≈ 3355 s tops out any
#: latency this repo can observe.
DEFAULT_ORIGIN = 1e-4
DEFAULT_BASE = 2.0
DEFAULT_COUNT = 26

_ENABLED = True
_STATE_LOCK = threading.Lock()


def set_enabled(on: bool) -> None:
    """Globally enable/disable metric RECORDING (collection and
    exposition always work; disabled recorders early-return)."""
    global _ENABLED
    with _STATE_LOCK:
        _ENABLED = bool(on)


def recording_enabled() -> bool:
    return _ENABLED


def geometric_edges(origin: float = DEFAULT_ORIGIN,
                    base: float = DEFAULT_BASE,
                    count: int = DEFAULT_COUNT) -> Tuple[float, ...]:
    """The bounded geometric bucket ladder: ``(0.0, origin,
    origin·base, ..., origin·base^(count-1), +inf)``.

    The length is ``count + 2`` — a function of the PARAMETERS only,
    never of any data — so histograms built on the same ladder merge by
    position across runs and processes."""
    if origin <= 0.0 or base <= 1.0 or count < 1:
        raise ValueError(f"need origin > 0, base > 1, count >= 1; got "
                         f"origin={origin}, base={base}, count={count}")
    return ((0.0,) + tuple(origin * base ** i for i in range(count))
            + (float("inf"),))


def bucket_counts(edges: Sequence[float],
                  samples: Iterable[float]) -> List[int]:
    """Per-bucket counts of ``samples`` under le-semantics: bucket i
    counts samples ``<= edges[i]`` and ``> edges[i-1]``."""
    counts = [0] * len(edges)
    for s in samples:
        counts[bisect_left(edges, s)] += 1
    return counts


def merge_histograms(*hists: Sequence[dict]) -> List[dict]:
    """Merge-by-position of ``[{"le_s": edge, "count": k}, ...]``
    histograms (the ``LatencyRecorder.histogram`` shape).  Associative
    and commutative; raises when the edge lists differ — merging
    histograms built on different ladders is the silent-corruption case
    the fixed-length edges exist to make detectable."""
    if not hists:
        raise ValueError("nothing to merge")
    edges = [b["le_s"] for b in hists[0]]
    out = [0] * len(edges)
    for h in hists:
        if [b["le_s"] for b in h] != edges:
            raise ValueError(
                f"histogram edges differ: {[b['le_s'] for b in h][:4]}... "
                f"vs {edges[:4]}... — rebuild both on one "
                f"geometric_edges ladder before merging")
        for i, b in enumerate(h):
            out[i] += int(b["count"])
    return [{"le_s": le, "count": c} for le, c in zip(edges, out)]


class _Metric:
    """Shared series plumbing: label resolution + locked storage."""

    kind = "untyped"
    _BOUND: type = None  # type: ignore[assignment]  # set per subclass

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str, labelnames: Sequence[str]):
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.labelnames = tuple(str(ln) for ln in labelnames)
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels "
                f"{list(self.labelnames)}, got {sorted(labels)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def labels(self, **labels) -> "_Bound":
        """Pre-resolve one label combination; the returned bound child
        records with NO per-call label validation.  The serving hot path
        resolves its children once at construction — per-request label
        kwargs cost more than the lock."""
        return self._BOUND(self, self._key(labels))

    def _snapshot_value(self, stored):
        return stored

    def snapshot(self) -> dict:
        """One metric's share of a registry snapshot (caller holds the
        registry lock)."""
        series = [{"labels": dict(zip(self.labelnames, key)),
                   "value": self._snapshot_value(stored)}
                  for key, stored in sorted(self._series.items())]
        return {"type": self.kind, "help": self.help,
                "labelnames": list(self.labelnames), "series": series}


class _Bound:
    """A metric pinned to one resolved label key (``metric.labels``)."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: _Metric, key: Tuple[str, ...]):
        self._metric = metric
        self._key = key


class Counter(_Metric):
    """Monotone labeled accumulator."""

    kind = "counter"

    def _inc(self, key: Tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _ENABLED:
            return
        self._inc(self._key(labels), amount)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class BoundCounter(_Bound):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if not _ENABLED:
            return
        self._metric._inc(self._key, amount)

    def value(self) -> float:
        m = self._metric
        with m._lock:
            return float(m._series.get(self._key, 0.0))


Counter._BOUND = BoundCounter


class Gauge(_Metric):
    """Last-written labeled value."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not _ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class BoundGauge(_Bound):
    __slots__ = ()

    def set(self, value: float) -> None:
        if not _ENABLED:
            return
        m = self._metric
        with m._lock:
            m._series[self._key] = float(value)

    def value(self) -> float:
        m = self._metric
        with m._lock:
            return float(m._series.get(self._key, 0.0))


Gauge._BOUND = BoundGauge


class Histogram(_Metric):
    """Labeled histogram over a fixed geometric-ladder edge list."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 edges: Optional[Sequence[float]] = None):
        super().__init__(registry, name, help, labelnames)
        self.edges = tuple(edges) if edges is not None else \
            geometric_edges()
        if list(self.edges) != sorted(self.edges) or len(self.edges) < 2:
            raise ValueError(f"edges must be sorted with >= 2 entries, "
                             f"got {self.edges}")
        if not math.isinf(self.edges[-1]):
            raise ValueError("the last edge must be +inf (every sample "
                             "lands in SOME bucket)")

    def _record(self, key: Tuple[str, ...], value: float,
                count: int) -> None:
        v = float(value)
        if not math.isfinite(v):
            raise ValueError(f"histogram samples must be finite, "
                             f"got {value!r}")
        with self._lock:
            stored = self._series.get(key)
            if stored is None:
                stored = self._series[key] = {
                    "counts": [0] * len(self.edges), "sum": 0.0,
                    "count": 0}
            stored["counts"][bisect_left(self.edges, v)] += count
            stored["sum"] += v * count
            stored["count"] += count

    def observe(self, value: float, **labels) -> None:
        if not _ENABLED:
            return
        self._record(self._key(labels), value, 1)

    def observe_many(self, value: float, count: int, **labels) -> None:
        """Record ``count`` identical samples in one locked update — for
        batch-uniform values (every request in a coalesced batch shares
        its batch-wait and execute times)."""
        if not _ENABLED or count < 1:
            return
        self._record(self._key(labels), value, int(count))

    def _record_seq(self, key: Tuple[str, ...],
                    values: Iterable[float]) -> None:
        edges = self.edges
        with self._lock:
            stored = self._series.get(key)
            if stored is None:
                stored = self._series[key] = {
                    "counts": [0] * len(edges), "sum": 0.0, "count": 0}
            counts = stored["counts"]
            total, k = stored["sum"], stored["count"]
            for value in values:
                v = float(value)
                if not math.isfinite(v):
                    raise ValueError(f"histogram samples must be "
                                     f"finite, got {value!r}")
                counts[bisect_left(edges, v)] += 1
                total += v
                k += 1
            stored["sum"], stored["count"] = total, k

    def observe_seq(self, values: Iterable[float], **labels) -> None:
        """Record a sequence of samples under ONE lock acquisition (the
        coalesced-batch hot path: per-request lock round trips cost more
        than the bucketing)."""
        if not _ENABLED:
            return
        self._record_seq(self._key(labels), values)

    def _snapshot_value(self, stored):
        return {"edges": list(self.edges),
                "counts": list(stored["counts"]),
                "sum": float(stored["sum"]),
                "count": int(stored["count"])}


class BoundHistogram(_Bound):
    __slots__ = ()

    def observe(self, value: float) -> None:
        if not _ENABLED:
            return
        self._metric._record(self._key, value, 1)

    def observe_many(self, value: float, count: int) -> None:
        if not _ENABLED or count < 1:
            return
        self._metric._record(self._key, value, int(count))

    def observe_seq(self, values: Iterable[float]) -> None:
        if not _ENABLED:
            return
        self._metric._record_seq(self._key, values)


Histogram._BOUND = BoundHistogram


class MetricsRegistry:
    """Thread-safe family of named metrics with one consistent
    ``collect()`` snapshot (every series copied under ONE lock)."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, kind: str, name: str, help: str,
                       labelnames: Sequence[str], **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind or \
                        existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{list(existing.labelnames)}, "
                        f"cannot re-register as {kind}"
                        f"{list(labelnames)}")
                return existing
            metric = self._KINDS[kind](self, name, help, labelnames,
                                       **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create("histogram", name, help, labelnames,
                                   edges=edges)

    def collect(self) -> dict:
        """Snapshot-consistent ``{name: {type, help, labelnames,
        series}}`` — one lock acquisition covers every copy, so no
        concurrent recorder can interleave."""
        with self._lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        """Drop every metric and series (tests)."""
        with self._lock:
            self._metrics.clear()


def merge_snapshots(a: dict, b: dict) -> dict:
    """Fold two ``collect()`` snapshots (or JSON-loaded files) into one:
    counters and histogram buckets ADD, gauges last-win (``b``).
    Associative, so a caller can left-fold any number of per-process runs.
    Kind/labelname/edge mismatches raise — a silent positional merge
    across different schemas is the failure mode this layer exists to
    rule out."""
    out = {name: _copy_metric(m) for name, m in a.items()}
    for name, mb in b.items():
        ma = out.get(name)
        if ma is None:
            out[name] = _copy_metric(mb)
            continue
        if (ma["type"] != mb["type"]
                or ma["labelnames"] != mb["labelnames"]):
            raise ValueError(
                f"cannot merge metric {name!r}: "
                f"{ma['type']}{ma['labelnames']} vs "
                f"{mb['type']}{mb['labelnames']}")
        by_labels = {tuple(sorted(s["labels"].items())): s
                     for s in ma["series"]}
        for sb in mb["series"]:
            key = tuple(sorted(sb["labels"].items()))
            sa = by_labels.get(key)
            if sa is None:
                ma["series"].append(json.loads(json.dumps(sb)))
                by_labels[key] = ma["series"][-1]
            elif ma["type"] == "counter":
                sa["value"] += sb["value"]
            elif ma["type"] == "gauge":
                sa["value"] = sb["value"]
            else:
                va, vb = sa["value"], sb["value"]
                if va["edges"] != vb["edges"]:
                    raise ValueError(
                        f"metric {name!r}: histogram edges differ — "
                        f"rebuild on one ladder before merging")
                va["counts"] = [x + y for x, y in
                                zip(va["counts"], vb["counts"])]
                va["sum"] += vb["sum"]
                va["count"] += vb["count"]
        ma["series"].sort(key=lambda s: sorted(s["labels"].items()))
    return out


def _copy_metric(m: dict) -> dict:
    return json.loads(json.dumps(m))


def _prom_escape(value: object) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_prom_escape(v)}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _prom_num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if v != int(v) else str(int(v))


def to_prometheus_text(snapshot: dict) -> str:
    """Prometheus text exposition of a ``collect()`` snapshot
    (cumulative ``_bucket{le=...}``/``_sum``/``_count`` for
    histograms)."""
    lines = []
    for name, m in sorted(snapshot.items()):
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['type']}")
        for s in m["series"]:
            if m["type"] in ("counter", "gauge"):
                lines.append(f"{name}{_prom_labels(s['labels'])} "
                             f"{_prom_num(s['value'])}")
                continue
            v = s["value"]
            cum = 0
            for edge, c in zip(v["edges"], v["counts"]):
                cum += c
                le = f'le="{_prom_num(edge)}"'
                lines.append(f"{name}_bucket"
                             f"{_prom_labels(s['labels'], le)} {cum}")
            lines.append(f"{name}_sum{_prom_labels(s['labels'])} "
                         f"{_prom_num(v['sum'])}")
            lines.append(f"{name}_count{_prom_labels(s['labels'])} "
                         f"{v['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_json(snapshot: dict, indent: Optional[int] = 1) -> str:
    """JSON exposition (Python's json round-trips the +inf edges)."""
    return json.dumps(snapshot, indent=indent, sort_keys=True)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """THE process-wide registry every instrumented module records
    into."""
    return _DEFAULT


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _DEFAULT.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return _DEFAULT.gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: Sequence[str] = (),
              edges: Optional[Sequence[float]] = None) -> Histogram:
    return _DEFAULT.histogram(name, help, labelnames, edges=edges)
