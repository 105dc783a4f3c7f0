"""Text reporters: the ONE formatting path for stats output.

``format_slo`` renders an ``AsyncFGFTService.stats()`` snapshot (the
serving entry points of ``launch/service.py`` print through here).
``format_snapshot`` renders a
``MetricsRegistry.collect()`` snapshot as a compact text table for
quick terminal inspection — the machine-readable forms are
``to_prometheus_text`` / ``to_json`` in ``obs.metrics``.
"""
from __future__ import annotations

from typing import List

__all__ = ["format_slo", "format_snapshot"]


def format_slo(stats: dict) -> str:
    """The serving SLO summary: counters line + one per-tier latency
    line per ``*/total`` key (exact nearest-rank percentiles)."""
    occ = stats["batch"]
    lines = [
        f"[svc] served {stats['served']}/{stats['submitted']} "
        f"(shed {stats['shed']}, errors {stats['errors']}), "
        f"{stats['dispatches']} fused dispatches, occupancy "
        f"{occ['occupancy_mean']:.2f}/{occ['cap']} "
        f"(max {occ['occupancy_max']}), queue peak "
        f"{stats['queue']['peak']}/{stats['queue']['max']}, "
        f"maintenance ticks {stats['maintain']['ticks']} "
        f"(swaps {stats['maintain']['swaps']}, errors "
        f"{stats['maintain']['errors']})"
    ]
    for key, s in stats["latency"].items():
        if not key.endswith("/total"):
            continue
        lines.append(
            f"[svc]   {key.split('/')[0]:>10}: p50 "
            f"{s['p50_s'] * 1e3:.2f}ms  p99 {s['p99_s'] * 1e3:.2f}ms  "
            f"max {s['max_s'] * 1e3:.2f}ms  ({s['count']} reqs)")
    return "\n".join(lines)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}"
                          for k, v in sorted(labels.items())) + "}"


def format_snapshot(snapshot: dict) -> str:
    """Compact human-readable table of a ``collect()`` snapshot."""
    lines: List[str] = []
    for name, m in sorted(snapshot.items()):
        for s in m["series"]:
            label = f"{name}{_fmt_labels(s['labels'])}"
            if m["type"] == "histogram":
                v = s["value"]
                mean = v["sum"] / v["count"] if v["count"] else 0.0
                lines.append(f"{label:<56} count={v['count']} "
                             f"mean={mean:.6g}")
            else:
                lines.append(f"{label:<56} {s['value']:g}")
    return "\n".join(lines)
