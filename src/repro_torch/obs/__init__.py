"""Observability of the port: metrics registry + span tracing + text
reporting, the JAX package's layer in a copy of its own.

Stdlib-only by design — ``repro_torch.obs`` imports nothing from the rest
of the package, so the lowest layers (``kernels/plan.py``,
``checkpoint/store.py``) can instrument themselves without import
cycles.  Everything records into two process-wide singletons — the
default ``MetricsRegistry`` and the default ``Tracer`` — that belong to
this package alone: in a process that imports both packages, the port's
metrics and spans never mix with the JAX package's.
``configure(enabled=...)`` flips BOTH off in one call (what a
traced-vs-untraced throughput comparison toggles).  The exports are the
JAX package's formats, byte for byte.

Artifact helpers: ``export_metrics(dir)`` writes ``metrics.json`` +
``metrics.prom`` (merging into an existing ``metrics.json`` so runs of
one process each accumulate), ``export_trace(path)`` writes the Chrome
trace.  ``METRICS_DIR_ENV`` names the environment variable a caller
sets to collect both.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                               MetricsRegistry, bucket_counts, counter,
                               default_registry, gauge, geometric_edges,
                               histogram, merge_histograms,
                               merge_snapshots, recording_enabled,
                               set_enabled, to_json, to_prometheus_text)
from repro_torch.obs.report import format_slo, format_snapshot
from repro_torch.obs.trace import Tracer, default_tracer, new_trace_id

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
    "bucket_counts", "configure", "counter", "default_registry",
    "default_tracer", "export_metrics", "export_trace", "format_slo",
    "format_snapshot", "gauge", "geometric_edges", "histogram",
    "merge_histograms", "merge_snapshots", "new_trace_id",
    "recording_enabled", "set_enabled", "to_json", "to_prometheus_text",
    "METRICS_DIR_ENV",
]

#: the JAX package's name of the directory variable that collects
#: metrics.json / metrics.prom / trace files
METRICS_DIR_ENV = "REPRO_METRICS_DIR"


def configure(enabled: Optional[bool] = None,
              trace_clock: Optional[Callable[[], float]] = None) -> None:
    """One switch for the whole layer: ``enabled`` toggles metric
    recording AND the default tracer; ``trace_clock`` swaps the default
    tracer's clock (tests inject a fake)."""
    if enabled is not None:
        set_enabled(enabled)
        default_tracer().enabled = bool(enabled)
    if trace_clock is not None:
        default_tracer().clock = trace_clock


def export_metrics(directory, merge: bool = True) -> dict:
    """Write ``metrics.json`` + ``metrics.prom`` snapshots of the
    default registry into ``directory``.  With ``merge`` (default) an
    existing ``metrics.json`` is folded in via ``merge_snapshots`` —
    counters add across runs, which is how a loop of one process per
    run accumulates a single file."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    snap = default_registry().collect()
    json_path = directory / "metrics.json"
    if merge and json_path.exists():
        snap = merge_snapshots(json.loads(json_path.read_text()), snap)
    json_path.write_text(to_json(snap))
    (directory / "metrics.prom").write_text(to_prometheus_text(snap))
    return {"json": json_path, "prom": directory / "metrics.prom",
            "snapshot": snap}


def export_trace(path) -> Path:
    """Write the default tracer's ring as a Chrome trace at ``path``."""
    return default_tracer().export_chrome_trace(path)
