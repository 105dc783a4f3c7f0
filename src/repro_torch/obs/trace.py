"""Injectable-clock span tracing into a bounded ring buffer
(the JAX package's tracer, copied for the port).

A ``Tracer`` records SPANS (named intervals with a category, an
optional trace id, and free-form args) into a ``deque(maxlen=capacity)``
ring — recording never allocates unboundedly, old spans fall off the
back.  Two properties carry the whole design:

  * **Explicit timestamps.**  ``add_span(name, start, end)`` takes the
    endpoints VERBATIM — it never consults a clock.  The serving layer
    passes timestamps read from its OWN injectable clock
    (``AsyncFGFTService(clock=...)``), so under a ``FakeClock`` every
    span endpoint is an exact integer and the queue/batch/execute spans
    of one request telescope to the end-to-end span EXACTLY (shared
    endpoints, integer arithmetic — checked with ``==``, not
    ``pytest.approx``).  The tracer's own ``clock`` is only
    used by the convenience ``span()`` context manager and
    ``event()``/``now()``.
  * **Bounded, lock-protected ring.**  One mutex guards append and
    export; ``spans()`` returns copies so callers can never mutate the
    ring through a snapshot.

Exports: ``export_chrome_trace`` writes the Chrome trace-event JSON
(``{"traceEvents": [...]}``, timestamps in µs) that chrome://tracing
and Perfetto load directly; ``export_jsonl`` writes one span per line
in seconds for grep/jq pipelines.

Trace ids come from ``new_trace_id()`` — a process-wide monotone
counter; the service stamps one on each request at submit and threads
it through queue → coalesce → dispatch → reply so the id on a
``ServeResult`` selects exactly that request's spans.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Optional

__all__ = ["Tracer", "default_tracer", "new_trace_id"]

DEFAULT_CAPACITY = 65536

_ID_COUNTER = itertools.count(1)


def new_trace_id() -> int:
    """Process-wide monotone trace id (thread-safe: ``itertools.count``
    holds the GIL across its single bytecode step)."""
    return next(_ID_COUNTER)


class Tracer:
    """Bounded ring buffer of spans with an injectable clock."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 capacity: int = DEFAULT_CAPACITY, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)

    # -- recording ----------------------------------------------------
    def now(self) -> float:
        return self.clock()

    def add_span(self, name: str, start: float, end: float, *,
                 cat: str = "", trace_id: Optional[int] = None,
                 tid: Optional[int] = None,
                 args: Optional[Dict[str, object]] = None) -> None:
        """Record a completed span with EXPLICIT endpoints (the caller's
        clock, not ours — see the module docstring).  ``args`` is held
        by reference until queried (the ring stores flat tuples — the
        serving hot path records four spans per request, so a dict
        build + copy per span is measurable); pass a dict you will not
        mutate afterwards."""
        if not self.enabled:
            return
        rec = (name, cat, "X", float(start),
               float(end) - float(start),
               threading.get_ident() if tid is None else tid,
               trace_id, args)
        with self._lock:
            self._ring.append(rec)

    def add_spans(self, specs) -> None:
        """Bulk ``add_span``: ``specs`` is an iterable of
        ``(name, start, end, cat, trace_id, tid, args)`` tuples, all
        appended under ONE lock acquisition.  The serving dispatcher
        records four spans per request — per-span call + lock overhead
        sits directly on the dispatch critical path, so the hot path
        batches."""
        if not self.enabled:
            return
        ident = threading.get_ident()
        recs = [(name, cat, "X", float(start),
                 float(end) - float(start),
                 ident if tid is None else tid, trace_id, args)
                for name, start, end, cat, trace_id, tid, args in specs]
        with self._lock:
            self._ring.extend(recs)

    def event(self, name: str, *, cat: str = "",
              trace_id: Optional[int] = None, ts: Optional[float] = None,
              args: Optional[Dict[str, object]] = None) -> None:
        """Record an instant event (zero-duration point on the
        tracer's own clock unless ``ts`` is given)."""
        if not self.enabled:
            return
        rec = (name, cat, "i",
               float(self.clock() if ts is None else ts), 0.0,
               threading.get_ident(), trace_id, args)
        with self._lock:
            self._ring.append(rec)

    @contextmanager
    def span(self, name: str, *, cat: str = "",
             trace_id: Optional[int] = None,
             args: Optional[Dict[str, object]] = None):
        """Time a block on the tracer's own clock.  Disabled tracers
        skip the clock reads entirely (the untraced throughput
        measures the disabled path)."""
        if not self.enabled:
            yield self
            return
        t0 = self.clock()
        try:
            yield self
        finally:
            self.add_span(name, t0, self.clock(), cat=cat,
                          trace_id=trace_id, args=args)

    # -- queries ------------------------------------------------------
    def spans(self, cat: Optional[str] = None,
              trace_id: Optional[int] = None,
              name: Optional[str] = None) -> List[dict]:
        """Copy of the ring as dicts, optionally filtered; oldest
        first."""
        with self._lock:
            snap = list(self._ring)
        if cat is not None:
            snap = [r for r in snap if r[1] == cat]
        if trace_id is not None:
            snap = [r for r in snap if r[6] == trace_id]
        if name is not None:
            snap = [r for r in snap if r[0] == name]
        return [{"name": r[0], "cat": r[1], "ph": r[2], "ts": r[3],
                 "dur": r[4], "tid": r[5], "trace_id": r[6],
                 "args": dict(r[7] or {})} for r in snap]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- export -------------------------------------------------------
    def export_chrome_trace(self, path) -> Path:
        """Write the ring as Chrome trace-event JSON (µs timestamps;
        loads in chrome://tracing and Perfetto)."""
        path = Path(path)
        pid = os.getpid()
        events = []
        for r in self.spans():
            ev = {"name": r["name"], "cat": r["cat"] or "default",
                  "ph": r["ph"], "ts": r["ts"] * 1e6,
                  "pid": pid, "tid": r["tid"],
                  "args": {**r["args"],
                           **({"trace_id": r["trace_id"]}
                              if r["trace_id"] is not None else {})}}
            if r["ph"] == "X":
                ev["dur"] = r["dur"] * 1e6
            else:
                ev["s"] = "t"
            events.append(ev)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"}, indent=1))
        return path

    def export_jsonl(self, path) -> Path:
        """One span per line, timestamps in seconds (grep/jq form)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as fh:
            for r in self.spans():
                fh.write(json.dumps(r) + "\n")
        return path


_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    """THE process-wide tracer every instrumented module records
    into."""
    return _DEFAULT
