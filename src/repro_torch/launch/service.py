"""Async serving front end of the port: request queue, admission control,
cross-tenant micro-batching, background maintenance on its own CUDA
stream, SLO instrumentation (the JAX package's ``launch/service.py``).

The engines (``FGFTServeEngine``, ``RaggedFGFTServeEngine``) are library
objects: one caller, one fused dispatch at a time.  A production front door
sees the opposite shape — many independent tenants, each asking for a few
signal rows on ONE graph, arriving asynchronously.  ``AsyncFGFTService``
bridges the two:

  * ``submit(graph_id, signal, tier=...)`` enqueues one request and
    returns a future.  Admission control is a BOUNDED queue: past
    ``max_queue`` pending requests the submit fails fast with a typed
    ``ShedError`` (the caller can retry/degrade) instead of letting the
    queue grow without bound.
  * a dispatcher thread COALESCES queued requests that share a dispatch
    group — same size bucket, same quality tier (or the filter bank) —
    into one zero-padded signal block and answers them all with a single
    fused engine dispatch, on the card ONE operator or bank kernel launch:
    same-graph requests stack along the row axis, different graphs land
    on their own batch rows.  Row counts are quantized
    (``quantize_rows``) so steady-state dispatches cycle through a few
    block shapes.
  * ``maintain()`` (drift scoring, refresh/extend/refit, versioned hot
    swap) runs on a background maintainer thread, never on the serving
    path, and on the card on a CUDA stream the service owns, so that its
    probes, refreshes and fits overlap the dispatcher's launches instead
    of queuing behind them.  The hot path takes no lock around a
    dispatch: it reads the engine's immutable ``_LiveVersion`` once per
    dispatch, so every response is served by exactly one consistent
    version and carries that version number.
  * every stage is instrumented with an INJECTABLE clock: per-tier
    latency recorders (queue wait / service / total, exact nearest-rank
    p50/p99), queue depth + peak, batch occupancy, shed counts and
    version-swap counts, surfaced through ``stats()`` and persisted with
    ``save()`` next to the engine checkpoint; spans and metrics go to the
    port's observability layer (``repro_torch.obs``).

Unit tests drive the whole pipeline deterministically: ``auto_start=False``
plus ``drain_once()`` runs the dispatcher inline on the caller's thread,
and a fake clock makes every latency figure exact.

CPU smoke:
  python -m repro_torch.launch.serve --fgft --serve-async --graphs 4 \\
      --graph-n 32 --load-requests 64 --load-workers 4 --device cpu
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.obs.metrics import (bucket_counts, geometric_edges,
                                     merge_histograms)  # noqa: F401 — re-exported

BANK = "__bank__"          # pseudo-tier routing a request to the filter bank

# -- serving-path telemetry: every live service records into the port's
# process-wide registry; per-service isolation comes from the `service`
# label ---------------------------------------------------------------------
_OBS_SUBMITTED = obs.counter("service_requests_total",
                             "requests admitted to the bounded queue",
                             ("service", "tier"))
_OBS_SHED = obs.counter("service_shed_total",
                        "requests rejected by admission control",
                        ("service",))
_OBS_DISPATCHES = obs.counter("service_dispatches_total",
                              "coalesced fused dispatches",
                              ("service", "tier"))
_OBS_QUEUE_DEPTH = obs.gauge("service_queue_depth",
                             "queue depth sampled at the last dispatch",
                             ("service",))
_OBS_STAGE_S = obs.histogram(
    "service_stage_seconds",
    "per-request stage latency on the obs geometric ladder",
    ("service", "tier", "stage"))

# every live service registers here so a test harness can force-stop
# leaked services instead of hanging the interpreter at exit on their
# non-daemon threads
_LIVE_SERVICES: "weakref.WeakSet" = weakref.WeakSet()


def shutdown_all_services(timeout: float = 5.0) -> int:
    """Best-effort close() of every still-open service; returns how many
    were closed.  An escape hatch for test harnesses — production code
    closes its own services (context manager)."""
    closed = 0
    for svc in list(_LIVE_SERVICES):
        if svc._threads:
            try:
                svc.close(timeout=timeout)
                closed += 1
            except RuntimeError:
                pass
    return closed


class ServiceClosed(RuntimeError):
    """submit() after close(): the service no longer accepts work."""


class ShedError(RuntimeError):
    """Typed admission-control rejection: the bounded request queue is
    full, so this request was shed instead of queued (the caller sees the
    overload immediately and can retry, back off, or drop to a cheaper
    tier).  Carries the observed depth and the configured bound."""

    def __init__(self, queue_depth: int, max_queue: int, graph_id: int):
        super().__init__(
            f"request for graph {graph_id} shed: queue depth "
            f"{queue_depth} >= max_queue {max_queue}")
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        self.graph_id = graph_id


def quantize_rows(rows: int, quantum: int = 8) -> int:
    """Smallest power-of-two multiple of ``quantum`` >= rows: coalesced
    blocks pad their row axis to a quantized count, so the steady state
    cycles through O(log max_rows) block shapes instead of one per
    distinct occupancy."""
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    q = quantum
    while q < rows:
        q *= 2
    return q


class LatencyRecorder:
    """Deterministic latency/size statistics keyed by string.

    Retains up to ``max_samples`` most-recent samples per key (plus exact
    running count/total/max over ALL samples) and computes NEAREST-RANK
    percentiles over the retained window — pure arithmetic over recorded
    durations, no clock of its own, so a fake clock upstream makes every
    figure exact."""

    def __init__(self, max_samples: int = 8192):
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: Dict[str, deque] = {}
        self._count: Dict[str, int] = {}
        self._total: Dict[str, float] = {}
        self._max: Dict[str, float] = {}

    def record(self, key: str, seconds: float):
        s = float(seconds)
        if not math.isfinite(s) or s < 0.0:
            raise ValueError(f"latency sample must be finite and >= 0, "
                             f"got {seconds!r}")
        with self._lock:
            dq = self._samples.get(key)
            if dq is None:
                dq = self._samples[key] = deque(maxlen=self.max_samples)
            dq.append(s)
            self._count[key] = self._count.get(key, 0) + 1
            self._total[key] = self._total.get(key, 0.0) + s
            self._max[key] = max(self._max.get(key, 0.0), s)

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._samples)

    def count(self, key: str) -> int:
        with self._lock:
            return self._count.get(key, 0)

    def percentile(self, key: str, q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) over the retained
        samples: the smallest sample s.t. >= q% of samples are <= it."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        with self._lock:
            xs = sorted(self._samples.get(key, ()))
        if not xs:
            raise KeyError(f"no samples recorded under {key!r}")
        rank = max(int(math.ceil(q / 100.0 * len(xs))), 1)
        return xs[rank - 1]

    def histogram(self, key: str, origin: float = 1e-4,
                  base: float = 2.0,
                  bucket_count: int = 26) -> List[dict]:
        """Geometric-bucket histogram of the retained samples:
        ``[{"le_s": bound, "count": k}, ...]`` over the obs bounded
        geometric ladder (``obs.metrics.geometric_edges``): a 0-bucket,
        ``bucket_count`` edges origin·base^i, and a final +inf bucket.
        The edge list is a function of the PARAMETERS only — length
        ``bucket_count + 2`` no matter what was recorded — so
        histograms from different runs/processes merge by position
        (``merge_histograms``)."""
        with self._lock:
            xs = list(self._samples.get(key, ()))
        edges = geometric_edges(origin, base, bucket_count)
        counts = bucket_counts(edges, xs)
        return [{"le_s": le, "count": c} for le, c in zip(edges, counts)]

    def summary(self) -> Dict[str, dict]:
        """{key: {count, mean_s, p50_s, p99_s, max_s}} over every key."""
        out = {}
        for key in self.keys():
            with self._lock:
                count = self._count[key]
                total = self._total[key]
                mx = self._max[key]
            out[key] = {"count": count, "mean_s": total / count,
                        "p50_s": self.percentile(key, 50.0),
                        "p99_s": self.percentile(key, 99.0),
                        "max_s": mx}
        return out


@dataclass
class ServeResult:
    """One answered request: the filtered block plus its provenance.
    ``version`` is the engine serving version that produced ``y`` — read
    ONCE together with the tables/spectra that served the dispatch, so it
    can never describe a different version than the payload."""

    y: np.ndarray
    graph_id: int
    tier: str
    version: int
    queue_s: float
    service_s: float
    total_s: float
    batch_size: int
    #: the obs trace id stamped at submit and threaded queue ->
    #: coalesce -> dispatch -> reply: ``default_tracer().spans(
    #: trace_id=r.trace_id)`` returns exactly this request's
    #: queue/batch/execute/request spans, and their durations telescope
    #: to ``total_s`` exactly under a fake clock
    trace_id: int = 0


@dataclass
class _Request:
    graph_id: int
    signal: np.ndarray            # (r, n_i) float32, n_i = true graph size
    tier: str                     # resolved tier name, or BANK
    group: Tuple[Any, str]        # (bucket key, tier): the coalescing key
    future: Future = field(default_factory=Future)
    t_submit: float = 0.0
    trace_id: int = 0


@dataclass(frozen=True)
class _Route:
    """Where one graph's requests dispatch: which engine, which batch row,
    its bucket key (None for a uniform fleet) and true size."""

    engine: Any
    bucket: Any
    row: int
    size: int
    batched: bool


def _build_routes(engine) -> List[_Route]:
    """Per-graph dispatch routes for a uniform engine or a ragged router
    (deferred import: serve.py is the module that defines the engines)."""
    from repro_torch.launch.serve import RaggedFGFTServeEngine
    if isinstance(engine, RaggedFGFTServeEngine):
        return [_Route(engine=engine.engines[w], bucket=w,
                       row=engine.bucket_of[w].index(gid),
                       size=engine.sizes[gid], batched=True)
                for gid, w in enumerate(engine.widths)]
    basis = engine.basis
    if basis.batched:
        b = int(basis.spectrum.shape[0])
        sizes = (np.full(b, basis.n) if basis.sizes is None
                 else np.atleast_1d(np.asarray(basis.sizes)))
        return [_Route(engine=engine, bucket=None, row=gid,
                       size=int(sizes[gid]), batched=True)
                for gid in range(b)]
    size = basis.n if basis.sizes is None else int(np.asarray(basis.sizes))
    return [_Route(engine=engine, bucket=None, row=0, size=size,
                   batched=False)]


class AsyncFGFTService:
    """Queue -> coalesce -> fused dispatch -> versioned swap over an
    ``FGFTServeEngine`` or ``RaggedFGFTServeEngine``.

    ``h``: optional spectral response applied on tier dispatches (same
    contract as ``engine.step``).  ``maintain_interval``: seconds between
    background maintenance ticks for dynamic engines (``None`` = only on
    ``request_maintain()``/``maintain_now()``).  ``clock``: injectable
    monotonic clock for all SLO timestamps.  ``auto_start=False`` skips
    the threads; tests then pump the queue inline with ``drain_once()``.
    On a CUDA engine every maintenance tick runs on ``maintain_stream``,
    a stream of the service's own."""

    def __init__(self, engine, *, h: Optional[Callable] = None,
                 max_queue: int = 128, max_batch: int = 8,
                 row_quantum: int = 8,
                 maintain_interval: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 latency_window: int = 8192, auto_start: bool = True,
                 name: str = "fgft-svc"):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.row_quantum = int(row_quantum)
        self.maintain_interval = maintain_interval
        self.name = name
        self._h = h
        self._clock = clock
        self._routes = _build_routes(engine)
        self.maintain_stream = (torch.cuda.Stream(engine.device)
                                if engine.device.type == "cuda" else None)
        self.latency = LatencyRecorder(max_samples=latency_window)
        # hot-path obs handles: label children resolved ONCE here —
        # per-request label kwargs would cost more than the recording
        # itself
        self._obs_shed = _OBS_SHED.labels(service=self.name)
        self._obs_depth = _OBS_QUEUE_DEPTH.labels(service=self.name)
        self._obs_submitted: Dict[str, Any] = {}
        self._obs_dispatch: Dict[str, Any] = {}
        self._obs_stage: Dict[str, dict] = {}
        # one lock guards the queue and every counter; it is NEVER held
        # across an engine dispatch (the engine's atomic _LiveVersion
        # read is the only synchronization the hot path needs)
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        self._submitted = 0
        self._served = 0
        self._shed = 0
        self._errors = 0
        self._depth_peak = 0
        self._dispatches = 0
        self._coalesced = 0
        self._occ_max = 0
        self._maintain_ticks = 0
        self._maintain_errors = 0
        self._swaps = 0
        self._last_action: Any = None
        self._last_maint_error: Optional[BaseException] = None
        self._m_wake = threading.Event()
        self._m_done = threading.Condition()
        self._threads: List[threading.Thread] = []
        _LIVE_SERVICES.add(self)
        if auto_start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Spawn the dispatcher (and, for dynamic engines, the maintainer)
        threads; idempotent."""
        if self._threads:
            return
        if self._closed:
            raise ServiceClosed("service already closed")
        worker = threading.Thread(target=self._dispatch_loop,
                                  name=f"{self.name}-dispatch")
        self._threads.append(worker)
        if getattr(self.engine, "dynamic", False):
            maint = threading.Thread(target=self._maintain_loop,
                                     name=f"{self.name}-maintain")
            self._threads.append(maint)
        for t in self._threads:
            t.start()

    def close(self, timeout: Optional[float] = 30.0):
        """Stop accepting work, drain the queue, join every thread.  The
        dispatcher answers all already-queued requests before exiting, so
        no accepted future is left unresolved."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._m_wake.set()
        for t in self._threads:
            t.join(timeout)
        leaked = [t.name for t in self._threads if t.is_alive()]
        if leaked:
            raise RuntimeError(f"service threads failed to stop: {leaked}")
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- submission (admission control) ------------------------------------

    def submit(self, graph_id: int, signal, tier: Optional[str] = None,
               bank: bool = False) -> Future:
        """Enqueue one request for ``graph_id``: ``signal`` is (r, n_i)
        (or (n_i,), promoted to one row).  ``tier`` picks a quality tier
        (default: the engine's best); ``bank=True`` routes through the
        fused filter bank instead.  Returns a future resolving to a
        ``ServeResult``; raises ``ShedError`` when the bounded queue is
        full and ``ServiceClosed`` after ``close()``."""
        if bank and tier is not None:
            raise ValueError("a request is either tiered or bank, not both")
        try:
            route = self._routes[graph_id] if graph_id >= 0 else None
        except IndexError:
            route = None
        if route is None:
            raise ValueError(f"graph_id {graph_id} not in fleet of "
                             f"{len(self._routes)}")
        x = np.asarray(signal, np.float32)
        if x.ndim == 1:
            x = x[None]
        if x.ndim != 2 or x.shape[1] != route.size:
            raise ValueError(f"signal for graph {graph_id} must be "
                             f"(r, {route.size}), got {x.shape}")
        if bank:
            if route.engine._live.bank is None:
                raise ValueError("engine was built without filter "
                                 "responses; bank requests unavailable")
            tier = BANK
        elif tier is None:
            tier = route.engine.default_tier
        elif tier not in route.engine._live.tiers:
            raise ValueError(f"unknown tier {tier!r}; engine serves "
                             f"{sorted(route.engine._live.tiers)}")
        req = _Request(graph_id=graph_id, signal=x, tier=tier,
                       group=(route.bucket, tier),
                       trace_id=obs.new_trace_id())
        req.t_submit = self._clock()
        with self._cond:
            if self._closed:
                raise ServiceClosed("service is closed")
            depth = len(self._queue)
            if depth >= self.max_queue:
                self._shed += 1
                self._obs_shed.inc()
                raise ShedError(depth, self.max_queue, graph_id)
            self._queue.append(req)
            self._submitted += 1
            self._depth_peak = max(self._depth_peak, depth + 1)
            self._cond.notify()
        label = "bank" if tier == BANK else tier
        child = self._obs_submitted.get(label)
        if child is None:
            child = self._obs_submitted[label] = _OBS_SUBMITTED.labels(
                service=self.name, tier=label)
        child.inc()
        return req.future

    # -- coalescing dispatcher ---------------------------------------------

    def _collect_locked(self):
        """Pop the head request plus up to max_batch-1 queued requests
        sharing its dispatch group (same bucket, same tier), preserving
        FIFO order within the group and leaving the rest queued."""
        head = self._queue.popleft()
        batch = [head]
        if len(batch) < self.max_batch:
            keep = deque()
            while self._queue and len(batch) < self.max_batch:
                req = self._queue.popleft()
                (batch if req.group == head.group else keep).append(req)
            keep.extend(self._queue)
            self._queue = keep
        return batch

    def drain_once(self) -> int:
        """Serve at most one coalesced batch inline on the CALLER's
        thread; returns the number of requests answered (0 if the queue
        was empty).  This is the dispatcher's unit of work, exposed so
        tests can pump the queue deterministically without threads."""
        with self._cond:
            if not self._queue:
                return 0
            batch = self._collect_locked()
        t_collect = self._clock()
        self._run_batch(batch, t_collect)
        return len(batch)

    def _dispatch_loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:
                    return                      # closed and drained
                batch = self._collect_locked()
            t_collect = self._clock()
            self._run_batch(batch, t_collect)

    def _stage_children(self, label: str) -> dict:
        """Per-(tier, stage) bound histogram children, resolved once per
        tier label (benign if two threads race the first resolution —
        both children share one series key)."""
        cached = self._obs_stage.get(label)
        if cached is None:
            cached = self._obs_stage[label] = {
                stage: _OBS_STAGE_S.labels(service=self.name, tier=label,
                                           stage=stage)
                for stage in ("queue", "batch", "execute", "total")}
        return cached

    def _run_batch(self, batch: List[_Request],
                   t_collect: Optional[float] = None):
        t0 = self._clock()
        if t_collect is None:
            t_collect = t0
        try:
            results = self._fused_dispatch(batch)
        except Exception as exc:  # noqa: BLE001 — fail the batch, not the service
            with self._cond:
                self._errors += len(batch)
            for req in batch:
                req.future.set_exception(exc)
            return
        t1 = self._clock()
        tier = batch[0].tier
        label = "bank" if tier == BANK else tier
        with self._cond:
            self._dispatches += 1
            self._coalesced += len(batch)
            self._occ_max = max(self._occ_max, len(batch))
            self._served += len(batch)
            depth_now = len(self._queue)
        tracer = obs.default_tracer()
        if obs.recording_enabled():
            # every registry touch here is per BATCH, not per request:
            # batch-wait and execute are batch-uniform (one locked
            # count += len(batch)), and the per-request queue/total
            # samples go through one locked bucketing pass each
            dchild = self._obs_dispatch.get(label)
            if dchild is None:
                dchild = self._obs_dispatch[label] = \
                    _OBS_DISPATCHES.labels(service=self.name, tier=label)
            dchild.inc()
            self._obs_depth.set(depth_now)
            stage_obs = self._stage_children(label)
            stage_obs["batch"].observe_many(t0 - t_collect, len(batch))
            stage_obs["execute"].observe_many(t1 - t0, len(batch))
            stage_obs["queue"].observe_seq(
                [t_collect - req.t_submit for req in batch])
            stage_obs["total"].observe_seq(
                [t1 - req.t_submit for req in batch])
        tid = threading.get_ident()
        for req, (y, version) in zip(batch, results):
            queue_s = t0 - req.t_submit
            self.latency.record(f"{label}/queue", queue_s)
            self.latency.record(f"{label}/service", t1 - t0)
            self.latency.record(f"{label}/total", t1 - req.t_submit)
            if tracer.enabled:
                # the four spans share their endpoints (t_submit <=
                # t_collect <= t0 <= t1, all read from THIS service's
                # injectable clock), so queue + batch + execute
                # telescopes to the request span exactly when the clock's
                # readings add exactly (a fake clock's integers).  Only
                # the parent request span carries args; the sub-spans
                # are linked by trace_id.
                tr = req.trace_id
                tracer.add_spans((
                    ("request/queue", req.t_submit, t_collect,
                     "serve", tr, tid, None),
                    ("request/batch", t_collect, t0,
                     "serve", tr, tid, None),
                    ("request/execute", t0, t1,
                     "serve", tr, tid, None),
                    ("request", req.t_submit, t1, "serve", tr, tid,
                     {"graph": req.graph_id, "tier": label,
                      "version": version, "batch_size": len(batch)})))
            req.future.set_result(ServeResult(
                y=y, graph_id=req.graph_id, tier=label, version=version,
                queue_s=queue_s, service_s=t1 - t0,
                total_s=t1 - req.t_submit, batch_size=len(batch),
                trace_id=req.trace_id))

    def _fused_dispatch(self, batch: List[_Request]):
        """ONE fused engine dispatch answering every request in ``batch``
        (all share a dispatch group): same-graph requests stack along the
        row axis, each graph fills its own batch row, rows are quantized,
        and the result is cropped back per request.  Every kernel of the
        stack computes each row on its own, so the coalesced answer
        matches the per-request loop."""
        route0 = self._routes[batch[0].graph_id]
        eng, tier = route0.engine, batch[0].tier
        offsets = []                            # request -> its row slice
        used: Dict[int, int] = {}               # batch row -> rows filled
        for req in batch:
            row = self._routes[req.graph_id].row
            off = used.get(row, 0)
            offsets.append((row, off))
            used[row] = off + req.signal.shape[0]
        r_pad = quantize_rows(max(used.values()), self.row_quantum)
        n = eng.basis.n
        if route0.batched:
            b = int(eng.basis.spectrum.shape[0])
            block = np.zeros((b, r_pad, n), np.float32)
        else:
            block = np.zeros((r_pad, n), np.float32)
        for req, (row, off) in zip(batch, offsets):
            r, size = req.signal.shape
            dst = block[row] if route0.batched else block
            dst[off:off + r, :size] = req.signal
        x = torch.from_numpy(block).to(eng.device)
        # one read of the live version serves the whole dispatch, and the
        # reference is held until the answer is on the host: a swap on
        # the maintenance stream then cannot free (and the caching
        # allocator cannot hand that stream) a table block that a kernel
        # launched here still reads
        live = eng._live
        if tier == BANK:
            y = eng._bank_on(live, x)
        else:
            y = eng._step_on(live, x, self._h, tier)
        y = y.cpu().numpy()                     # device sync: work is done
        version = live.version
        results = []
        for req, (row, off) in zip(batch, offsets):
            r, size = req.signal.shape
            yt = y[row] if route0.batched else y
            if tier == BANK:
                results.append((yt[:, off:off + r, :size], version))
            else:
                results.append((yt[off:off + r, :size], version))
        return results

    # -- background maintenance (dynamic engines) --------------------------

    def request_maintain(self):
        """Wake the maintainer for an immediate off-hot-path tick."""
        self._m_wake.set()

    def maintain_now(self, timeout: Optional[float] = 30.0) -> dict:
        """Trigger one maintenance tick and wait for it to complete;
        returns the engine's maintain() result.  With no maintainer
        thread running the tick executes inline on the caller's thread
        (still off the dispatcher's serving path, on the maintenance
        stream)."""
        if not getattr(self.engine, "dynamic", False):
            raise ValueError("engine was built without dynamic=True")
        if not any(t.name.endswith("-maintain") and t.is_alive()
                   for t in self._threads):
            return self._maintain_tick()
        with self._m_done:
            errors0 = self._maintain_errors
            target = self._maintain_ticks + self._maintain_errors + 1
            self._m_wake.set()
            ok = self._m_done.wait_for(
                lambda: self._maintain_ticks + self._maintain_errors
                >= target, timeout)
        if not ok:
            raise TimeoutError("maintenance tick did not complete")
        if self._maintain_errors > errors0:
            raise RuntimeError("maintenance tick failed") \
                from self._last_maint_error
        return self._last_action

    def _swap_version(self) -> int:
        eng = self.engine
        if hasattr(eng, "engines"):             # ragged router
            return sum(e._live.version for e in eng.engines.values())
        return eng._live.version

    def _maintain_tick(self) -> dict:
        before = self._swap_version()
        try:
            # on the card the tick's probes, refreshes and fits run on
            # the service's own stream; the engine finishes that stream
            # before it publishes a version (FGFTServeEngine._install)
            with (torch.cuda.stream(self.maintain_stream)
                  if self.maintain_stream is not None
                  else contextlib.nullcontext()):
                res = self.engine.maintain()
        except Exception as exc:  # noqa: BLE001 — a failed refit must not kill serving
            with self._cond:
                self._maintain_errors += 1
                self._last_maint_error = exc
            with self._m_done:
                self._m_done.notify_all()
            raise
        after = self._swap_version()
        with self._cond:
            self._maintain_ticks += 1
            self._swaps += after - before
            self._last_action = res
        with self._m_done:
            self._m_done.notify_all()
        return res

    def _maintain_loop(self):
        while True:
            self._m_wake.wait(self.maintain_interval)
            if self._closed:
                return
            self._m_wake.clear()
            try:
                self._maintain_tick()
            except Exception:  # noqa: BLE001 — keep ticking; stats record it
                pass

    # -- SLO surface -------------------------------------------------------

    def reset_stats(self):
        """Zero every SLO counter and latency window (the CLI calls this
        after warmup so that first-call costs don't pollute the
        steady-state figures; queue depth/peak restart from the current
        depth)."""
        with self._cond:
            self._submitted = self._served = self._shed = 0
            self._errors = 0
            self._depth_peak = len(self._queue)
            self._dispatches = self._coalesced = self._occ_max = 0
            self._maintain_ticks = self._maintain_errors = 0
            self._swaps = 0
        self.latency = LatencyRecorder(max_samples=self.latency.max_samples)

    def stats(self) -> dict:
        """One consistent snapshot of the SLO surface: counters, queue
        and batching gauges, maintenance/swap counts, per-tier latency
        summaries (exact nearest-rank p50/p99 over the retained window)
        and the obs registry's snapshot."""
        with self._cond:
            snap = {
                "submitted": self._submitted,
                "served": self._served,
                "shed": self._shed,
                "errors": self._errors,
                "queue": {"depth": len(self._queue),
                          "peak": self._depth_peak,
                          "max": self.max_queue},
                "dispatches": self._dispatches,
                "batch": {
                    "cap": self.max_batch,
                    "occupancy_mean": (self._coalesced / self._dispatches
                                       if self._dispatches else 0.0),
                    "occupancy_max": self._occ_max,
                },
                "maintain": {
                    "enabled": bool(getattr(self.engine, "dynamic",
                                            False)),
                    "ticks": self._maintain_ticks,
                    "errors": self._maintain_errors,
                    "swaps": self._swaps,
                },
            }
        snap["latency"] = self.latency.summary()
        # the obs registry rides along, persisted with the slo payload by
        # save() so a checkpoint carries the telemetry of the run that
        # wrote it
        snap["obs"] = obs.default_registry().collect()
        return snap

    def save(self, directory, step: int = 0):
        """Persist the engine checkpoint WITH the service's SLO counters:
        uniform engines carry them as checkpoint metadata (``slo`` key),
        ragged routers get an atomic ``slo.json`` next to router.json.
        Either way ``load_slo_stats`` reads them back."""
        stats = self.stats()
        if hasattr(self.engine, "engines"):     # ragged router
            directory = pathlib.Path(self.engine.save(directory, step))
            tmp = directory / "slo.json.tmp"
            tmp.write_text(json.dumps(stats, indent=1))
            os.replace(tmp, directory / "slo.json")
            return directory
        return self.engine.save(directory, step,
                                extra_metadata={"slo": stats})


def load_slo_stats(directory, step: Optional[int] = None) -> Optional[dict]:
    """SLO stats persisted by ``AsyncFGFTService.save`` (either storage
    shape, written by either package), or None when the checkpoint
    carries none."""
    directory = pathlib.Path(directory)
    slo_json = directory / "slo.json"
    if slo_json.exists():
        return json.loads(slo_json.read_text())
    from repro_torch.checkpoint import read_metadata
    return read_metadata(directory, step).get("slo")


# ---------------------------------------------------------------------------
# Load generators
# ---------------------------------------------------------------------------


def closed_loop_load(service: AsyncFGFTService, requests: List[tuple],
                     workers: int = 4) -> List[ServeResult]:
    """CLOSED-loop load: ``workers`` threads round-robin the request list,
    each submitting its next request only after the previous answer
    arrived (think: that many always-on tenants).  Shed requests are
    retried by the same worker until accepted, so every request is
    eventually answered.  Returns results in request order."""
    results: List[Optional[ServeResult]] = [None] * len(requests)
    errors: List[BaseException] = []
    idx = iter(range(len(requests)))
    idx_lock = threading.Lock()

    def tenant():
        while True:
            with idx_lock:
                i = next(idx, None)
            if i is None:
                return
            gid, signal, tier, bank = requests[i]
            while True:
                try:
                    fut = service.submit(gid, signal, tier=tier, bank=bank)
                    break
                except ShedError:
                    time.sleep(0.0002)          # closed loop: retry
            try:
                results[i] = fut.result()
            except BaseException as exc:  # noqa: BLE001 — surface to caller
                errors.append(exc)
                return

    threads = [threading.Thread(target=tenant, name=f"tenant-{k}")
               for k in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results  # type: ignore[return-value]


def open_loop_load(service: AsyncFGFTService, requests: List[tuple],
                   qps: float) -> dict:
    """OPEN-loop load: arrivals are paced at ``qps`` regardless of how
    fast answers come back (think: independent internet tenants), so
    overload shows up as queue growth and shed requests instead of
    politely slowing the generator.  Returns
    {results, shed, offered_qps}."""
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    period = 1.0 / qps
    futures = []
    shed = 0
    t_start = time.monotonic()
    for i, (gid, signal, tier, bank) in enumerate(requests):
        target = t_start + i * period
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            futures.append(service.submit(gid, signal, tier=tier,
                                          bank=bank))
        except ShedError:
            shed += 1
    results = [f.result() for f in futures]
    elapsed = max(time.monotonic() - t_start, 1e-9)
    return {"results": results, "shed": shed,
            "offered_qps": len(requests) / elapsed}


def _print_slo(stats: dict):
    """ONE formatting path for stats output: the obs text reporter
    (obs/report.py) renders the snapshot; callers only print it."""
    print(obs.format_slo(stats))


def serve_fgft_async(args) -> dict:
    """The CLI entry (``serve --fgft --serve-async``): build the fleet, wrap
    it in the async front end, run a closed- or open-loop load (with
    churn + background maintenance when --dynamic), print the SLO
    summary."""
    from repro_torch.core.fgft import laplacian
    from repro_torch.graphs import (community_graph, directed_variant,
                                    edge_perturbation)
    from repro_torch.launch.serve import (FGFTServeEngine,
                                          RaggedFGFTServeEngine, _resolve)

    device = _resolve(args.device)
    b = args.graphs
    sizes = ([args.size_list[i % len(args.size_list)] for i in range(b)]
             if args.ragged else [args.graph_n] * b)
    adjs = [community_graph(n, seed=s) for s, n in enumerate(sizes)]
    if args.directed:
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    laps = [laplacian(a) for a in adjs]
    kind = "general" if args.directed else "auto"
    t0 = time.perf_counter()
    common = dict(backend=args.backend, kind=kind, filters=args.filter,
                  tiers=args.tier_map, dynamic=args.dynamic,
                  policy=args.policy, precision=args.precision,
                  fused=args.fused, device=device)
    if args.ragged:
        engine = RaggedFGFTServeEngine(laps, args.transforms, **common)
    else:
        g = args.transforms or int(2 * args.graph_n
                                   * np.log2(args.graph_n))
        engine = FGFTServeEngine(np.stack(laps), g, **common)
    print(f"[svc] fitted fleet of {b} graphs in "
          f"{time.perf_counter() - t0:.1f}s on {device}")

    rng = np.random.default_rng(args.seed)
    tiers = sorted(args.tier_map)
    requests = []
    for i in range(args.load_requests):
        gid = i % b
        x = rng.standard_normal((args.signals, sizes[gid])).astype(
            np.float32)
        if args.filter:
            requests.append((gid, x, None, True))
        else:
            requests.append((gid, x, tiers[i % len(tiers)], False))
    lowpass = None if args.filter else (lambda lam: 1.0 / (1.0 + lam))
    interval = args.maintain_interval if args.dynamic else None
    backend = args.backend or ("cuda" if device.type == "cuda"
                               else "torch")
    with AsyncFGFTService(engine, h=lowpass, max_queue=args.max_queue,
                          max_batch=args.max_batch,
                          maintain_interval=interval) as service:
        # warm every (tier, shape) path before the timed load; a tight
        # --max-queue sheds mid-burst, so drain and resubmit instead of
        # crashing before the timed load starts
        warm = []
        for req in requests[:min(len(requests), b * len(tiers))]:
            try:
                warm.append(service.submit(*req[:2], tier=req[2],
                                           bank=req[3]))
            except ShedError:
                for f in warm:
                    f.result()
                warm = [service.submit(*req[:2], tier=req[2],
                                       bank=req[3])]
        for f in warm:
            f.result()
        service.reset_stats()                   # first calls aren't SLO
        churn_stop = threading.Event()
        churn_errors: List[BaseException] = []

        def churn():
            from repro_torch.dynamic import GraphStream
            stream = GraphStream(adjs, directed=args.directed)
            rnd = 0
            try:
                while not churn_stop.is_set():
                    for gid in range(b):
                        budget = max(int(args.churn * sizes[gid]
                                         * (sizes[gid] - 1) / 2), 1)
                        batch = edge_perturbation(
                            stream.adjs[gid], budget,
                            seed=args.seed + 1000 * (rnd + 1) + gid,
                            directed=args.directed)
                        engine.apply_updates(gid, stream.apply(gid, batch))
                    service.request_maintain()
                    rnd += 1
                    churn_stop.wait(0.05)
            except Exception as exc:  # noqa: BLE001 — re-raised after join
                churn_errors.append(exc)

        churner = None
        if args.dynamic:
            churner = threading.Thread(target=churn, name="churn")
            churner.start()
        try:
            t0 = time.perf_counter()
            if args.qps > 0:
                results = open_loop_load(service, requests,
                                         args.qps)["results"]
            else:
                results = closed_loop_load(service, requests,
                                           workers=args.load_workers)
            elapsed = max(time.perf_counter() - t0, 1e-9)
        finally:
            churn_stop.set()
            if churner is not None:
                churner.join()
        if churn_errors:
            raise churn_errors[0]
        stats = service.stats()
    qps = len(results) / elapsed
    print(f"[svc] {len(results)} requests in {elapsed:.2f}s -> "
          f"{qps:.1f} qps sustained "
          f"[{'open' if args.qps > 0 else 'closed'}-loop, {backend}]")
    _print_slo(stats)
    versions = sorted({r.version for r in results})
    return {"qps": qps, "stats": stats, "versions": versions,
            "results": len(results)}
