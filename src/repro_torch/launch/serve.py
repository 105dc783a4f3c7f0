"""Batched fast-graph-Fourier-transform service (the port's --fgft path).

The engine fits a whole fleet of B graph Laplacians in one batched
Algorithm-1 run (core/eigenbasis.py), then serves spectral-filter steps
for all graphs at once: every step is ONE launch of the fused operator
CUDA kernel — ``Ubar diag(d) Ubar^T`` for undirected graphs,
``Tbar diag(d) Tbar^{-1}`` for directed ones (``--directed``) — over a
(B, R, n) signal block.  Named quality TIERS map to anytime prefixes of
the staged tables and bind one cached operator plan over the cut each;
an undirected tier refits its spectrum by Lemma 1 on its prefix basis
(through the batched apply kernel), a directed tier serves the full
fit's spectrum (Lemma 1 holds only for an orthogonal basis).  With
``--filter`` the engine serves a spectral filter BANK instead: every
``step_bank`` is ONE launch of the bank CUDA kernel, which runs the
analysis leg once and scale + synthesis for each of the F filters.

    python -m repro_torch.launch.serve --fgft --graphs 64 --graph-n 256 \\
        --tiers full:1.0,balanced:0.5,draft:0.25 --filter-steps 20 \\
        [--directed]
    python -m repro_torch.launch.serve --filter heat,tikhonov,wavelets:4 \\
        --graphs 64 --graph-n 256 [--directed]

A HETEROGENEOUS fleet (``--ragged``: graph sizes cycled from
``--graph-sizes``) is grouped into power-of-two buckets; each bucket is
fitted once with the greedy masked to every graph's true size and
served by its own engine, one launch per bucket per step
(``RaggedFGFTServeEngine``):

    python -m repro_torch.launch.serve --fgft --ragged --graphs 64 \\
        --graph-sizes 64,100,180,256 --transforms 4096

An EVOLVING fleet (``--dynamic``, with or without ``--ragged`` and
``--directed``) streams edge-update batches into the engine each round
(``apply_updates``), runs the drift-triggered refit controller off the
hot path (``maintain``: a Hutchinson probe pass through the operator
kernel, then reuse, a Lemma-1 spectrum refresh through the chain
kernel, a warm-start extend or a full refit) and keeps serving through
versioned hot swaps:

    python -m repro_torch.launch.serve --fgft --dynamic --graphs 64 \\
        --graph-n 256 --transforms 4096 --signals 256 --update-rounds 4 \\
        --churn 0.002 [--drift-thresholds 0.01,0.08,0.5]

``--precision bf16`` (any of the above) stores the served tables in
bf16, as the JAX package's flag does: the value tables are cast once per
serving version, the kernels widen each entry to f32 and accumulate in
f32, and every dispatch launches the kernels' bf16 forms:

    python -m repro_torch.launch.serve --fgft --precision bf16 \
        --filter heat,tikhonov,wavelets:4 --graphs 64 --graph-n 256

Engines and routers ``save``/``load`` through the checkpoint store in
the JAX package's format, so either package restores the other's
fleets (dynamic state included) without a refit.

``--serve-async`` (with any of the above) serves the fleet through the
async front end (launch/service.py): tenants submit a few signal rows on
one graph each, a bounded queue admits or sheds them, a dispatcher
coalesces them into one fused engine dispatch (one operator or bank
launch on the card), and a dynamic fleet is maintained on a background
thread, on a CUDA stream of its own, while serving continues.
``--trace PATH`` and ``--metrics-dir DIR`` write the run's Chrome trace
and its metrics (``metrics.json``, ``metrics.prom``) on exit, also when
the run fails:

    python -m repro_torch.launch.serve --fgft --serve-async --dynamic \
        --graphs 8 --graph-n 64 --load-requests 256 --load-workers 4 \
        --trace trace.json --metrics-dir metrics

The JAX package's LM flags exit with an error naming the later slice.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import threading
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs

DEFAULT_TIERS = {"full": 1.0, "balanced": 0.5, "draft": 0.25}

#: flags of the JAX package's service that belong to later slices
_LATER_FLAGS = {
    "--arch": "the LM scaffold", "--smoke": "the LM scaffold",
    "--requests": "the LM scaffold", "--batch-slots": "the LM scaffold",
    "--prompt-len": "the LM scaffold", "--gen-len": "the LM scaffold",
    "--max-len": "the LM scaffold",
}

# -- serving-engine telemetry, the JAX engine's metrics ---------------------
_OBS_SWAPS = obs.counter("serve_swaps_total",
                         "versioned hot swaps installed (version > 0)",
                         ("family",))
_OBS_VERSION = obs.gauge("serve_version", "live serving version",
                         ("family",))
_OBS_STEPS = obs.counter("serve_steps_total", "engine steps served",
                         ("tier",))
_OBS_DRIFT = obs.gauge("serve_drift_score",
                       "per-graph drift score after the last maintain "
                       "tick", ("graph",))
_OBS_MAINTAIN = obs.counter("maintain_actions_total",
                            "maintenance controller decisions",
                            ("action",))


@dataclass(frozen=True)
class _LiveVersion:
    """One immutable serving version: everything ``step`` reads, so a
    later swap is a single attribute store."""

    basis: Any
    fwd: tuple
    bwd: tuple
    tiers: Dict[str, dict]
    fns: Dict[str, Any]
    version: int
    bank: Any = None           # SpectralFilterBank over the basis, or None
    bank_gains: Any = None     # its (B, F, n) / (F, n) gains
    bank_fn: Any = None        # the bank plan's program


def parse_tiers(spec: str) -> Dict[str, float]:
    """'full:1.0,balanced:0.5,draft:0.25' -> {name: component fraction}."""
    tiers = {}
    for token in filter(None, spec.split(",")):
        name, _, frac = token.partition(":")
        if not frac:
            raise ValueError(f"tier {token!r} needs name:fraction")
        f = float(frac)
        if not 0.0 < f <= 1.0:
            raise ValueError(f"tier fraction must be in (0, 1], got {f}")
        name = name.strip()
        if not name:
            raise ValueError(f"tier {token!r} has an empty name")
        if name in tiers:
            raise ValueError(f"duplicate tier name {name!r}")
        tiers[name] = f
    if not tiers:
        raise ValueError("empty tier spec")
    return tiers


def _resolve(device) -> torch.device:
    """``device`` with its index: "cuda" names the current card, so that
    a basis fitted on "cuda" (its tensors on "cuda:0") matches an engine
    built for "cuda"."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(device: torch.device) -> None:
    """Wait for the work enqueued on the calling thread's current stream
    (an async service's maintainer runs on a stream of its own; a
    device-wide synchronize would also wait for the dispatcher's
    launches)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"the {slice_name} slice of repro_torch")


def _refuse_unported(placement, mesh) -> None:
    """The engines' arguments that belong to later slices."""
    if placement is not None:
        raise _not_ported("placement=", "multi-GPU placement")
    if mesh is not None:
        raise _not_ported("mesh=", "multi-GPU placement")


class FGFTServeEngine:
    """Batched spectral-filter serving over a fleet of graphs, with
    anytime quality tiers and (optionally) streaming updates.

    One ``ApproxEigenbasis.fit`` factorizes all B Laplacians (or a prefit
    ``basis`` is served as given); every ``step`` then filters a
    (B, R, n) signal block with one fused operator dispatch.  ``tiers``
    maps tier names to component fractions; each resolves to the nearest
    exact stage cut and binds one cached plan over the cut tables, with
    its spectrum refit by Lemma 1 on the prefix basis (a general-family
    tier serves the full fit's spectrum).  ``kind`` ("auto", "sym" or
    "general") and ``hint``: as in ``ApproxEigenbasis.fit``.
    ``backend``: None (the device's default: the CUDA kernels on a
    card), "cuda" or "torch".  ``filters``: a bank spec for
    ``named_responses`` (e.g. "heat,tikhonov,wavelets:4"), served by
    ``step_bank``.  ``sizes`` ((B,) true graph sides) marks a zero-padded
    ragged bucket: the fit is masked to each graph's real coordinates and
    a step's padded signal columns come back zeroed — the router
    (``RaggedFGFTServeEngine``) builds its per-bucket engines so.
    ``precision`` ("f32" or "bf16"): the storage precision of the served
    tables; "bf16" casts the value tables once per serving version
    (``_install``) and accumulates in f32, while the tier refits, the
    drift probe and the Lemma-1 refresh stay on the basis's f32 tables,
    as the JAX engine does.  ``placement`` and ``mesh`` are refused with
    the name of the slice that brings them.

    DYNAMIC mode (``dynamic=True``): the engine tracks the current
    Laplacians on its device, accepts streaming deltas through
    ``apply_updates(graph_id, delta)``, and ``maintain()`` runs the
    drift-triggered refit controller (dynamic/refit.py, ``policy``) OFF
    the hot path: it scores drift (Hutchinson, dynamic/drift.py: one
    operator launch with the probes as signal rows), picks the cheapest
    restoring action (reuse / Lemma-1 spectrum refresh / warm-start
    extend / full refit), builds a complete serving version (tier
    spectra, plan bindings, bank gains) and swaps it in with one
    attribute store, so ``step`` always sees one consistent version.  A
    batched dynamic fit quantizes its table shapes (``_repin``) so that
    every refit lands on the same (B, S, P) tables.  Per-graph basis
    versions and the controller's counters are in ``stats["dynamic"]``
    and persist through ``save``/``load``; ``drift_baseline`` hands a
    restored engine its persisted baselines."""

    def __init__(self, laps, num_transforms: int = 0, n_iter: int = 3,
                 backend: Optional[str] = None, kind: str = "auto",
                 hint: Optional[str] = None,
                 tiers: Optional[Dict[str, float]] = None, basis=None,
                 fused: bool = True, filters: Optional[str] = None,
                 sizes=None, precision: str = "f32", dynamic: bool = False,
                 policy=None, drift_baseline=None, placement=None,
                 mesh=None, device="cuda"):
        from repro_torch.core import ApproxEigenbasis
        from repro_torch.core.gtransform import _valid_mask
        from repro_torch.core.staging import TABLE_PRECISIONS
        _refuse_unported(placement, mesh)
        if precision not in TABLE_PRECISIONS:
            raise ValueError(f"precision must be one of "
                             f"{TABLE_PRECISIONS}, got {precision!r}")
        self.device = _resolve(device)
        self.backend = backend
        self._tier_spec = dict(tiers or {"full": 1.0})
        self._fused = bool(fused)
        self._filters = filters
        self._n_iter = n_iter
        self._precision = precision
        laps = torch.as_tensor(laps, dtype=torch.float32).to(self.device)
        if dynamic:
            laps = laps.clone()         # apply_updates adds into it
        # dynamic engines quantize the staged-table shapes (see _repin)
        self._stage_pad = (4, 8) if dynamic and laps.dim() == 3 else None
        fitted_here = basis is None
        if basis is None:
            if num_transforms <= 0:
                raise ValueError("num_transforms must be positive when "
                                 "no prefit basis is given")
            basis = ApproxEigenbasis.fit(laps, num_transforms,
                                         n_iter=n_iter, kind=kind,
                                         hint=hint, sizes=sizes,
                                         stage_pad=self._stage_pad,
                                         device=self.device)
        elif basis.device != self.device:
            raise ValueError(f"basis lives on {basis.device}, engine on "
                             f"{self.device}")
        self._g0 = basis.num_transforms
        self._kind = basis.kind
        # pad coordinates of a ragged bucket: h(0) need not be 0
        # (heat/Tikhonov map 0 -> 1), so step() zeroes those gains
        self._pad_mask = (None if basis.sizes is None else
                          ~_valid_mask(basis.sizes, basis.n, self.device))
        self.stats: Dict[str, Any] = {"steps": {}}
        self.dynamic = bool(dynamic)
        self._live = None
        if self.dynamic and basis.batched:
            pinned = basis.info.get("stage_pad")
            if fitted_here or not pinned:
                basis = self._repin(basis)
            else:
                # a basis that carries its pin (a restored one) keeps it:
                # re-deriving the quantum from its PADDED depth would
                # inflate the tables ~1.5x per save/load cycle
                self._stage_pad = tuple(int(q) for q in pinned)
        # the tracked Laplacians: the update and refit substrate of a
        # dynamic engine, and what save() persists, so that load()
        # rebuilds the tier spectra without a refit
        self._laps = laps
        self._install(basis, laps)
        if self.dynamic:
            self._init_dynamic(basis, laps, policy, drift_baseline)

    def _init_dynamic(self, basis, laps, policy, drift_baseline):
        from repro_torch.dynamic.drift import (estimate_rel_residual,
                                               relative_objective)
        from repro_torch.dynamic.refit import RefitController, RefitPolicy
        self.controller = RefitController(policy or RefitPolicy())
        nb = laps.shape[0] if basis.batched else 1
        self.versions = np.zeros(nb, np.int64)
        self._dirty = np.zeros(nb, bool)
        self._updates = 0
        # the tracked Laplacians are written in place by apply_updates
        # (any thread) and read by maintain (a service's maintainer
        # thread): the lock orders the host side, and on the card the
        # event recorded after the last add or snapshot orders the
        # streams (see _snapshot); per-graph update counts tell a
        # finished action which graphs were updated while it ran
        self._laps_lock = threading.Lock()
        self._laps_done = None
        self._graph_rev = np.zeros(nb, np.int64)
        # drift is cached per update revision: an idle tick with pending
        # but unchanged updates reuses the last probe pass
        self._update_rev = 0
        self._scored_rev = -1
        self._last_drift = np.zeros(nb)
        #: host ms of the last maintain() tick: the drift probe, the
        #: action, the install of its serving version and the post-action
        #: probe (each ends on a synchronization; maintain runs off the
        #: hot path)
        self.maintain_ms = dict.fromkeys(
            ("drift", "action", "install", "post_drift"), 0.0)
        if drift_baseline is not None:
            # a restored engine hands its persisted baseline through
            self._baseline = np.atleast_1d(
                np.asarray(drift_baseline, np.float64))
        elif basis.objective is not None:
            self._baseline = relative_objective(basis.objective, laps)
        else:
            # a refresh-swapped basis carries no exact objective; anchor
            # the baseline stochastically instead
            p = self.controller.policy
            self._baseline = np.atleast_1d(estimate_rel_residual(
                basis, laps, num_probes=p.num_probes, seed=p.seed))
        self._refresh_dynamic_stats(np.zeros(nb))

    def _repin(self, basis):
        """Repack a batched basis with a depth quantum pinned to its own
        staged depth and the width pinned at its structural maximum."""
        from repro_torch.core.eigenbasis import _pack
        from repro_torch.core.staging import DEFAULT_NUM_CHUNKS
        s0 = int(basis.fwd.num_stages)
        # depth: 1.5x the observed per-chunk depth (refit chains vary tens
        # of percent with graph content); width: disjoint pairs bound a
        # G stage at n/2 entries and a T stage at n, so the width never
        # overflows and every refit lands on the same tables
        q = max(-(-3 * s0 // (2 * DEFAULT_NUM_CHUNKS)), 1)
        w_max = basis.n // 2 if basis.kind == "sym" else basis.n
        pad = (q, max(8 * -(-w_max // 8), 8))
        if self._stage_pad == pad:
            return basis
        self._stage_pad = pad
        cuts = (sorted(set(np.asarray(basis.fwd.cuts)[:, 1].tolist()))
                if basis.fwd.cuts is not None else None)
        fwd, bwd = _pack(basis.kind, True, basis.factors, basis.n, cuts,
                         pad, basis.device)
        return replace(basis, fwd=fwd, bwd=bwd,
                       info={**basis.info, "stage_pad": pad})

    def _install(self, basis, laps):
        """Build a COMPLETE serving version (per-tier refit spectra, plan
        bindings and the filter bank's gains from the live spectrum) and
        swap it in with a single attribute store.  ``laps``: the
        Laplacians the tier spectra refit against — the fit stack at
        construction, the updated stack on a dynamic swap.  The served
        tables are the basis's at the engine's precision: a bf16 cast is
        kept beside the f32 tables (``launcher.cast_tables``), so a swap
        that keeps its tables (a spectrum refresh) keeps its cast and its
        entry streams."""
        from repro_torch.core.staging import table_arrays
        from repro_torch.dynamic.refit import prefix_spectrum
        from repro_torch.kernels.launcher import cast_tables
        from repro_torch.kernels.plan import ApplyPlan

        full_stages = int(basis.fwd.num_stages)
        tiers: Dict[str, dict] = {}
        fns: Dict[str, Any] = {}
        for name, frac in self._tier_spec.items():
            n_stages, n_comp = basis.select_tier(fraction=frac)
            cut = None if n_stages >= full_stages else n_stages
            # Lemma 1 is exact only for an orthogonal (G) basis; a T
            # tier keeps the full fit's spectrum, as the JAX engine does
            spec = (basis.spectrum if cut is None or basis.kind != "sym"
                    else prefix_spectrum(basis, laps, cut))
            tiers[name] = {"num_stages": n_stages,
                           "num_transforms": n_comp, "spectrum": spec}
            fns[name] = ApplyPlan(
                family=basis.kind, mode="operator", n=basis.n,
                batched=basis.batched, backend=self.backend,
                num_stages=cut, precision=self._precision,
                fused=self._fused, device=str(self.device)).program()
        bank = bank_gains = bank_fn = None
        if self._filters:
            from repro_torch.spectral import (SpectralFilterBank,
                                              named_responses)
            # gains come from the (possibly refreshed) spectrum on every
            # swap; the bank program itself is shape-cached
            bank = SpectralFilterBank(basis, named_responses(self._filters))
            bank_gains = bank.gains().contiguous()
            bank_fn = ApplyPlan(
                family=basis.kind, mode="bank", n=basis.n,
                batched=basis.batched, backend=self.backend,
                precision=self._precision, fused=self._fused,
                device=str(self.device)).program()
        version = 0 if self._live is None else self._live.version + 1
        live = _LiveVersion(
            basis=basis,
            fwd=table_arrays(cast_tables(basis.fwd, self._precision)),
            bwd=table_arrays(cast_tables(basis.bwd, self._precision)),
            tiers=tiers, fns=fns,
            version=version, bank=bank, bank_gains=bank_gains,
            bank_fn=bank_fn)
        # the version's tables, spectra and gains are written on this
        # thread's stream (a service's maintenance stream) and read on
        # the dispatcher's: they are complete before anyone can see them
        _sync(self.device)
        self._live = live
        _OBS_VERSION.set(version, family=basis.kind)
        if version > 0:
            _OBS_SWAPS.inc(family=basis.kind)
        obs.default_tracer().event(
            "serve_swap", cat="serve",
            args={"version": version, "family": basis.kind,
                  "num_stages": full_stages, "tiers": sorted(tiers)})
        # default tier = highest quality in the map, whatever its name
        self.default_tier = max(
            tiers, key=lambda k: tiers[k]["num_transforms"])
        for name in tiers:
            self.stats["steps"].setdefault(name, 0)
        self.stats["tiers"] = {name: {k: t[k] for k in
                                      ("num_stages", "num_transforms")}
                               for name, t in tiers.items()}

    @property
    def basis(self):
        """The currently served basis."""
        return self._live.basis

    @property
    def tiers(self) -> Dict[str, dict]:
        """Tier geometry + served spectra of the live version."""
        return self._live.tiers

    @property
    def bank(self):
        """The live version's SpectralFilterBank (None without filters)."""
        return self._live.bank

    def warmup(self, signals):
        """Run the serving and maintenance suite once up front — every
        tier, the filter bank, and in dynamic mode the drift probe and
        the Lemma-1 refresh — so that the kernels are built and the
        entry streams cached before the first real request or update
        round.  Warmup steps are not counted.  Returns the last output:
        the bank's (B, F, R, n) when filters are set, else the last
        tier's step."""
        y = None
        for name in self._live.tiers:
            y = self.step(signals, tier=name)
            self.stats["steps"][name] -= 1
        if self._live.bank is not None:
            y = self.step_bank(signals)
        if self.dynamic:
            self.drift()
            if self._kind == "sym":
                from repro_torch.dynamic.refit import lemma1_refresh
                lemma1_refresh(self._live.basis, self._laps)
        _sync(self.device)
        return y

    def _step_on(self, live: _LiveVersion, signals, h,
                 tier: Optional[str]) -> torch.Tensor:
        tier = tier if tier is not None else self.default_tier
        t = live.tiers[tier]
        d = t["spectrum"] if h is None else h(t["spectrum"])
        if h is not None and self._pad_mask is not None:
            d = d.masked_fill(self._pad_mask, 0.0)
        self.stats["steps"][tier] += 1
        _OBS_STEPS.inc(tier=tier)
        x = torch.as_tensor(signals, dtype=torch.float32).to(self.device)
        return live.fns[tier](live.fwd, live.bwd, d, x)

    def step(self, signals, h=None, tier: Optional[str] = None
             ) -> torch.Tensor:
        """Filter one (B, R, n) signal block on every graph at once at the
        requested tier (default: the highest-quality tier).  ``h`` maps
        the tier's graph frequencies to gains."""
        return self._step_on(self._live, signals, h, tier)

    def step_versioned(self, signals, h=None,
                       tier: Optional[str] = None) -> tuple:
        """``step`` plus the serving version that produced the answer,
        both read from one ``_live`` snapshot."""
        live = self._live
        return self._step_on(live, signals, h, tier), live.version

    def step_bank(self, signals) -> torch.Tensor:
        """All F bank responses on every graph at the full fit: (B, R, n)
        -> (B, F, R, n), one bank dispatch (on the card one launch)."""
        return self.step_bank_versioned(signals)[0]

    def step_bank_versioned(self, signals) -> tuple:
        """``step_bank`` plus the serving version that produced the
        answer, both read from one ``_live`` snapshot."""
        live = self._live
        return self._bank_on(live, signals), live.version

    def _bank_on(self, live: _LiveVersion, signals) -> torch.Tensor:
        if live.bank is None:
            raise ValueError("engine was built without filters (--filter)")
        _OBS_STEPS.inc(tier="bank")
        x = torch.as_tensor(signals, dtype=torch.float32).to(self.device)
        return live.bank_fn(live.fwd, live.bwd, live.bank_gains, x)

    # -- streaming updates + drift-triggered refits ------------------------

    def _require_dynamic(self):
        if not self.dynamic:
            raise ValueError("engine was built without dynamic=True")

    def _graph_size(self, graph_id: int) -> int:
        basis = self._live.basis
        if basis.sizes is None:
            return basis.n
        sizes = np.asarray(basis.sizes)
        return int(sizes[graph_id]) if basis.batched else int(sizes)

    def apply_updates(self, graph_id: int, delta):
        """Absorb one update batch for graph ``graph_id`` into the
        tracked Laplacian: an ``UpdateBatch`` (edge insert/delete/reweight
        list, dynamic/stream.py) or a dense Laplacian delta (an array or
        tensor; an (n_i, n_i) delta of a smaller ragged graph is embedded
        at the leading block).  The delta is added on the device as one
        elementwise f32 add, so the tracked stack equals the JAX engine's
        bitwise under the same stream.  The SERVED basis is untouched
        until the next ``maintain()`` decides an action."""
        self._require_dynamic()
        from repro_torch.dynamic.stream import UpdateBatch, laplacian_delta
        basis = self._live.basis
        n = basis.n
        size = self._graph_size(graph_id)
        if isinstance(delta, UpdateBatch):
            # bounds-checked at the graph's size
            dl = torch.from_numpy(laplacian_delta(delta, size))
        else:
            dl = torch.as_tensor(delta, dtype=torch.float32)
            if dl.shape[0] > size:
                raise ValueError(f"delta side {dl.shape[0]} exceeds graph "
                                 f"{graph_id}'s size {size}")
        if not basis.batched and graph_id != 0:
            raise ValueError("unbatched engine serves graph 0 only")
        dl = dl.to(self.device)
        if dl.shape[0] < n:                     # embed into the bucket
            pad = torch.zeros((n, n), dtype=torch.float32,
                              device=self.device)
            pad[:dl.shape[0], :dl.shape[1]] = dl
            dl = pad
        with self._laps_lock:
            self._after_laps()
            if basis.batched:
                self._laps[graph_id] += dl
            else:
                self._laps += dl
            self._mark_laps()
            self._dirty[graph_id] = True
            self._graph_rev[graph_id] += 1
            self._updates += 1
            self._update_rev += 1

    def _after_laps(self) -> None:
        """Order the current stream after the last add into, or snapshot
        of, the tracked Laplacians (caller holds ``_laps_lock``)."""
        if self._laps_done is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._laps_done)

    def _mark_laps(self) -> None:
        """Record where the last add or snapshot was enqueued (caller
        holds ``_laps_lock``)."""
        if self.device.type == "cuda":
            self._laps_done = torch.cuda.Event()
            self._laps_done.record(torch.cuda.current_stream(self.device))

    def _snapshot(self) -> tuple:
        """``(laps, dirty, graph_revs, update_rev)``: a copy of the
        tracked Laplacians as they stand, with the pending flags and
        update counts it holds.  An action runs on one snapshot, as the
        JAX engine's does (its ``jnp.asarray(self._laps_host)``):
        ``apply_updates`` adds into ``_laps`` in place, so an update
        applied while a refit runs would otherwise change the Laplacians
        under the fit and its re-baseline.  On the card the copy waits
        for every add enqueued before it, and every later add waits for
        the copy."""
        with self._laps_lock:
            self._after_laps()
            laps = self._laps.clone()
            self._mark_laps()
            return (laps, self._dirty.copy(), self._graph_rev.copy(),
                    self._update_rev)

    def drift(self) -> np.ndarray:
        """Per-graph drift scores of the LIVE version on the tracked
        (updated) Laplacians: Hutchinson relative residual minus the
        baseline recorded at the last structural (re)fit, floored at 0."""
        self._require_dynamic()
        return self._drift_on(self._snapshot()[0])

    def _drift_on(self, laps) -> np.ndarray:
        from repro_torch.dynamic.drift import estimate_rel_residual
        p = self.controller.policy
        est = estimate_rel_residual(self._live.basis, laps,
                                    num_probes=p.num_probes, seed=p.seed)
        return np.maximum(np.atleast_1d(est) - self._baseline, 0.0)

    def maintain(self) -> dict:
        """One OFF-hot-path controller tick: score drift, pick the
        cheapest restoring action, execute it and swap the new serving
        version in.  Returns {action, drift, post_drift, versions,
        swap_version} (numpy arrays); ``maintain_ms`` holds the tick's
        time split."""
        self._require_dynamic()
        from repro_torch.dynamic.refit import Action
        self.maintain_ms = dict.fromkeys(self.maintain_ms, 0.0)
        if not self._dirty.any():
            zero = np.zeros_like(self._baseline)
            self.controller.record(Action.REUSE, zero,  # idle tick counts
                                   drift=zero)
            self._refresh_dynamic_stats(zero)
            self._obs_maintain(Action.REUSE.value, zero, zero)
            return {"action": Action.REUSE.value, "drift": zero,
                    "post_drift": zero, "versions": self.versions.copy(),
                    "swap_version": self._live.version}
        t0 = time.perf_counter()
        # the whole tick (drift, action, re-baseline, post-action drift)
        # sees one set of Laplacians
        laps, dirty, graph_rev, rev = self._snapshot()
        if self._scored_rev != rev:
            self._last_drift = self._drift_on(laps)
            self._scored_rev = rev
        drift = self._last_drift
        self.maintain_ms["drift"] = (time.perf_counter() - t0) * 1e3
        # the general family has no cheap spectrum refresh (Lemma 2 needs
        # a dense solve per graph): the controller escalates for it
        action = self.controller.decide(drift,
                                        can_refresh=self._kind == "sym")
        post = drift
        if action is not Action.REUSE:
            self._execute(action, laps)
            with self._laps_lock:
                # a graph updated while the action ran stays pending
                self._dirty = self._graph_rev != graph_rev
            bump = dirty
            if action in (Action.EXTEND, Action.REFIT):
                bump[:] = True      # every chain in the batch was regrown
            self.versions[bump] += 1
            t0 = time.perf_counter()
            post = self._drift_on(laps)
            self.maintain_ms["post_drift"] = (time.perf_counter() - t0) * 1e3
            self._last_drift = post
            self._scored_rev = rev
        self.controller.record(action, post, drift=drift)
        self._refresh_dynamic_stats(post)
        self._obs_maintain(action.value, drift, post)
        return {"action": action.value, "drift": drift, "post_drift": post,
                "versions": self.versions.copy(),
                "swap_version": self._live.version}

    def _obs_maintain(self, action: str, drift, post):
        """Record one maintain decision: the action counter, per-graph
        drift gauges (post-action scores) and one trace event beside the
        controller's timeline entry."""
        _OBS_MAINTAIN.inc(action=action)
        post = np.atleast_1d(np.asarray(post, np.float64))
        for gid, d in enumerate(post):
            _OBS_DRIFT.set(float(d), graph=gid)
        obs.default_tracer().event(
            "maintain", cat="maintain",
            args={"action": action,
                  "drift_max": float(np.max(np.atleast_1d(drift))),
                  "post_drift_max": float(np.max(post)),
                  "swap_version": self._live.version})

    def _execute(self, action, laps):
        """Run one refit action on ``laps`` (the tick's snapshot of the
        tracked Laplacians) and install the resulting serving version."""
        from repro_torch.core import ApproxEigenbasis
        from repro_torch.dynamic.drift import relative_objective
        from repro_torch.dynamic.refit import Action, lemma1_refresh
        basis = self._live.basis
        t0 = time.perf_counter()
        if action is Action.REFRESH:
            # spectrum-only: the factor chain (its staged tables, and the
            # baseline anchored at the last structural fit) survive
            basis = replace(basis, spectrum=lemma1_refresh(basis, laps),
                            objective=None)
        elif action is Action.EXTEND:
            p = self.controller.policy
            extra = max(int(round(p.extend_fraction * self._g0)), 1)
            basis = basis.extend(laps, basis.num_transforms + extra,
                                 n_iter=0)
        elif action is Action.REFIT:
            # keep the fit's RESOLVED greedy criterion: refitting under
            # the default score would switch the criterion mid-stream
            score = basis.info.get("score") if self._kind == "sym" else None
            basis = ApproxEigenbasis.fit(
                laps, self._g0, n_iter=self._n_iter, kind=self._kind,
                score=score, sizes=basis.sizes, stage_pad=self._stage_pad,
                device=self.device)
        else:
            raise ValueError(f"not an executable action: {action}")
        if action in (Action.EXTEND, Action.REFIT):
            # re-baseline at the new structural fit (exact objective)
            self._baseline = relative_objective(basis.objective, laps)
        _sync(self.device)
        t1 = time.perf_counter()
        self._install(basis, laps)
        self.maintain_ms["action"] = (t1 - t0) * 1e3
        self.maintain_ms["install"] = (time.perf_counter() - t1) * 1e3

    def _refresh_dynamic_stats(self, last_drift):
        self.stats["dynamic"] = {
            "updates": int(self._updates),
            "versions": self.versions.tolist(),
            "swap_version": self._live.version,
            "actions": dict(self.controller.counts),
            "last_drift": np.asarray(last_drift).tolist(),
        }

    # -- persistence (repro_torch/checkpoint, the JAX package's format) ---

    def save(self, directory, step: int = 0, extra_metadata=None,
             shards: int = 1):
        """Persist the live basis and the serving state: the tracked
        Laplacians ride as the ``laps`` leaf, the tier spec, filters and
        fit settings as the ``serve`` metadata block, the swap counter as
        the basis version, and a dynamic engine's per-graph versions,
        update count, drift baselines, controller state and pending
        (dirty) flags as the ``dynamic`` block.  ``extra_metadata``
        merges more top-level keys."""
        live = self._live
        basis = replace(live.basis, info={**live.basis.info,
                                          "version": int(live.version)})
        meta: Dict[str, Any] = {
            "serve": {"tier_spec": self._tier_spec,
                      "filters": self._filters,
                      "n_iter": self._n_iter,
                      "num_transforms": int(self._g0),
                      "precision": self._precision,
                      "fused": self._fused}}
        if extra_metadata:
            overlap = {"serve", "dynamic"} & set(extra_metadata)
            if overlap:
                raise ValueError(f"extra_metadata may not override the "
                                 f"engine's own keys: {sorted(overlap)}")
            meta.update(extra_metadata)
        if self.dynamic:
            meta["dynamic"] = {
                "versions": self.versions.tolist(),
                "updates": int(self._updates),
                "baseline": np.asarray(self._baseline).tolist(),
                "controller": self.controller.state_dict(),
                # a restored engine must not silently serve a basis whose
                # updates were never scored
                "dirty": self._dirty.tolist(),
            }
        return basis.save(directory, step, extra_state={"laps": self._laps},
                          extra_metadata=meta, shards=shards)

    @classmethod
    def load(cls, directory, step: Optional[int] = None, *, laps=None,
             backend: Optional[str] = None, filters: Optional[str] = None,
             tiers: Optional[Dict[str, float]] = None,
             dynamic: Optional[bool] = None, policy=None,
             precision: Optional[str] = None,
             fused: Optional[bool] = None, placement=None, mesh=None,
             device="cuda") -> "FGFTServeEngine":
        """Rebuild a serving engine from a checkpoint (written by either
        package) WITHOUT refitting.  ``filters``, ``tiers``,
        ``precision`` and ``fused`` override the saved settings.
        ``laps`` supplies the Laplacians of a checkpoint that carries
        none (one written by ``ApproxEigenbasis.save``).  ``dynamic``
        defaults to whether the checkpoint holds a ``dynamic`` block; a
        dynamic engine restores its per-graph versions, baselines,
        controller state and pending flags (a checkpoint without them
        restores with every version at 0 and fresh counters), under
        ``policy`` (default ``RefitPolicy()``)."""
        from repro_torch.checkpoint import (latest_step, read_metadata,
                                            restore_checkpoint)
        from repro_torch.core import ApproxEigenbasis
        _refuse_unported(placement, mesh)
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint in {directory}")
        meta = read_metadata(directory, step)
        dyn_meta = meta.get("dynamic")
        if dynamic is None:
            dynamic = dyn_meta is not None
        dev = _resolve(device)
        basis = ApproxEigenbasis.load(directory, step, device=dev)
        serve_meta = meta.get("serve", {})
        if laps is None:
            shape = ((int(basis.spectrum.shape[0]), basis.n, basis.n)
                     if basis.batched else (basis.n, basis.n))
            try:
                state, _, _ = restore_checkpoint(
                    directory, {"laps": torch.zeros(shape, device=dev)},
                    step=step)
            except KeyError as exc:
                raise ValueError(
                    "checkpoint carries no tracked Laplacians (written "
                    "by ApproxEigenbasis.save, not engine.save); pass "
                    "laps= explicitly") from exc
            laps = state["laps"]
        engine = cls(laps, n_iter=serve_meta.get("n_iter", 3),
                     backend=backend,
                     filters=(filters if filters is not None
                              else serve_meta.get("filters")),
                     tiers=(tiers if tiers is not None
                            else serve_meta.get("tier_spec")),
                     basis=basis, dynamic=dynamic, policy=policy,
                     drift_baseline=(dyn_meta or {}).get("baseline"),
                     precision=(precision if precision is not None
                                else serve_meta.get("precision", "f32")),
                     fused=(fused if fused is not None
                            else serve_meta.get("fused", True)),
                     device=dev)
        engine._live = replace(engine._live,
                               version=int(basis.info.get("version", 0)))
        # the ORIGINAL fitted budget, not the (maybe extended) chain:
        # REFIT clamps back to it and EXTEND budgets are fractions of it
        engine._g0 = int(serve_meta.get("num_transforms", engine._g0))
        if engine.dynamic:
            dyn = dyn_meta or {}
            versions = dyn.get("versions")
            engine.versions = (np.asarray(versions, np.int64)
                               if versions is not None
                               else np.zeros_like(engine.versions))
            engine._updates = int(dyn.get("updates", 0))
            if dyn.get("dirty") is not None:
                engine._dirty = np.asarray(dyn["dirty"], bool)
                if engine._dirty.any():
                    engine._update_rev += 1   # force a fresh drift pass
            engine.controller.load_state_dict(dyn.get("controller", {}))
            engine._refresh_dynamic_stats(np.zeros_like(engine._baseline))
        return engine


def serve_fgft(args) -> dict:
    """Build B community-graph Laplacians (their directed variants with
    ``--directed``), fit them in one batched run, serve filter steps at
    every configured quality tier, or the filter bank of ``--filter``
    (a mixed-size fleet with ``--ragged``: ``serve_fgft_ragged``; an
    evolving one with ``--dynamic``: ``serve_fgft_dynamic``; any of them
    behind the async front end with ``--serve-async``:
    ``launch/service.py::serve_fgft_async``)."""
    from repro_torch.core.fgft import laplacian
    from repro_torch.graphs import community_graph, directed_variant

    if args.serve_async:
        from repro_torch.launch.service import serve_fgft_async
        return serve_fgft_async(args)
    if args.dynamic:
        return serve_fgft_dynamic(args)
    if args.ragged:
        return serve_fgft_ragged(args)
    device = torch.device(args.device)
    b, n = args.graphs, args.graph_n
    g = args.transforms or int(2 * n * np.log2(n))
    adjs = [community_graph(n, seed=s) for s in range(b)]
    if args.directed:
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    laps = np.stack([laplacian(a) for a in adjs])
    # --directed pins the T family: a numerically symmetric directed
    # Laplacian must not reroute through the G path
    kind = "general" if args.directed else "auto"
    t0 = time.perf_counter()
    engine = FGFTServeEngine(laps, g, backend=args.backend, kind=kind,
                             tiers=args.tier_map, fused=args.fused,
                             filters=args.filter, precision=args.precision,
                             device=device)
    _sync(device)
    fit_s = time.perf_counter() - t0
    denom = (laps * laps).sum((1, 2))
    rel = (engine.basis.objective.detach().cpu().numpy()
           / np.maximum(denom, 1e-30))
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.standard_normal(
        (b, args.signals, n)).astype(np.float32)).to(device)
    backend = engine.backend or ("cuda" if device.type == "cuda"
                                 else "torch")
    print(f"[fgft] fitted {b} graphs (n={n}, g={g}, "
          f"kind={engine.basis.kind}) in one batched run on {device}: "
          f"{fit_s:.1f}s, mean rel error {rel.mean():.4f}")
    if args.filter:
        return _serve_bank(args, engine, x, backend, {
            "rel_error": rel, "kind": engine.basis.kind, "fit_s": fit_s,
            "engine": engine, "laps": laps, "signals": x})
    lowpass = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
    tier_stats = {}
    for name, tier in engine.tiers.items():
        engine.step(x, lowpass, tier=name)       # warmup: not counted
        engine.stats["steps"][name] = 0
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(args.filter_steps):
            engine.step(x, lowpass, tier=name)
        _sync(device)
        dt = max(time.perf_counter() - t0, 1e-9)
        served = args.filter_steps * b
        tier_stats[name] = {"transforms_per_s": served / dt,
                            "num_stages": tier["num_stages"],
                            "num_transforms": tier["num_transforms"]}
        print(f"[fgft]   tier {name!r}: g'={tier['num_transforms']}/{g} "
              f"({tier['num_stages']} stages) — {served / dt:.1f} "
              f"graph-transforms/s [{backend}]")
    base = tier_stats[engine.default_tier]["transforms_per_s"]
    for ts in tier_stats.values():
        ts["speedup_vs_best"] = ts["transforms_per_s"] / base
    print(f"[fgft] served {args.filter_steps * b * len(engine.tiers)} "
          f"graph-filter requests across {len(engine.tiers)} tiers "
          f"({engine.stats['steps']})")
    return {"rel_error": rel, "transforms_per_s": base,
            "kind": engine.basis.kind, "tiers": tier_stats,
            "stats": engine.stats, "fit_s": fit_s, "engine": engine,
            "laps": laps, "signals": x}


def _serve_bank(args, engine, x, backend: str, out: dict) -> dict:
    """Warm up once, then time ``--filter-steps`` bank steps."""
    b, f = x.shape[0], len(engine.bank)
    engine.step_bank(x)                      # warmup: not counted
    _sync(engine.device)
    t0 = time.perf_counter()
    for _ in range(args.filter_steps):
        engine.step_bank(x)
    _sync(engine.device)
    dt = max(time.perf_counter() - t0, 1e-9)
    served = args.filter_steps * b * f
    print(f"[fgft] served {served} filter responses ({f} filters x {b} "
          f"graphs x {args.filter_steps} steps, {args.signals} signals "
          f"each) in {dt:.2f}s — {served / dt:.1f} responses/s through the "
          f"fused bank path [{backend}]")
    return {**out, "responses_per_s": served / dt,
            "filters": engine.bank.names}


def bucket_width(n: int, min_width: int = 8) -> int:
    """Power-of-two bucket of an n-node graph (floored at ``min_width``).

    Power-of-two buckets keep the padding below 2x per graph while the
    number of buckets, each one fit and one engine, stays logarithmic in
    the range of sizes."""
    if n < 2:
        raise ValueError(f"graph size must be >= 2, got {n}")
    w = max(int(min_width), 2)
    while w < n:
        w *= 2
    return w


class RaggedFGFTServeEngine:
    """Size-bucketed serving of a HETEROGENEOUS graph fleet.

    Graphs are grouped into power-of-two buckets (``bucket_width``); each
    bucket's Laplacians are zero-padded to its width and fitted in one
    masked batched fit (``ApproxEigenbasis.fit(..., sizes=)``), so every
    graph's error is its own-size fit's, and each bucket is served by its
    own ``FGFTServeEngine``.  ``step`` builds the zero-padded
    (B_w, R, w) block of each bucket on the device, dispatches every
    bucket (one operator launch each on the card) before it crops any
    output, and returns device tensors cropped to each graph's size, in
    request order; nothing in it waits on the card.

    ``num_transforms``: components per graph of the LARGEST bucket;
    smaller buckets scale as w log2 w (alpha of g = alpha n log2 n stays
    constant across the fleet); 0 -> 2 w log2 w.  ``dynamic`` and
    ``policy`` go to every bucket engine: updates route to the graph's
    bucket (``apply_updates``, request-order ids) and each bucket runs
    its own controller tick and hot swap (``maintain``), so a burst of
    updates to small graphs never blocks the big bucket's serving
    version.  ``precision`` and ``fused`` go to every bucket engine.
    ``placement`` and ``mesh`` are refused with the name of the slice
    that brings them."""

    def __init__(self, laps, num_transforms: int = 0, n_iter: int = 3,
                 backend: Optional[str] = None,
                 filters: Optional[str] = None, kind: str = "auto",
                 hint: Optional[str] = None,
                 tiers: Optional[Dict[str, float]] = None,
                 min_width: int = 8, dynamic: bool = False, policy=None,
                 precision: str = "f32", fused: bool = True,
                 placement=None, mesh=None, device="cuda",
                 _engines: Optional[Dict[int, FGFTServeEngine]] = None,
                 _widths: Optional[List[int]] = None):
        from repro_torch.core import pad_ragged
        _refuse_unported(placement, mesh)
        self.device = _resolve(device)
        self.dynamic = bool(dynamic)
        laps = [torch.as_tensor(lap, dtype=torch.float32) for lap in laps]
        if not laps:
            raise ValueError("empty graph fleet")
        self.sizes = [int(lap.shape[0]) for lap in laps]
        self._denoms = np.asarray([max(float((lap * lap).sum()), 1e-30)
                                   for lap in laps])
        # load() passes the PERSISTED widths: a router built with another
        # min_width would otherwise be regrouped
        self.widths = (list(_widths) if _widths is not None else
                       [bucket_width(s, min_width) for s in self.sizes])
        # bucket -> positions in request order (stable within a bucket)
        self.bucket_of: Dict[int, List[int]] = {}
        for pos, w in enumerate(self.widths):
            self.bucket_of.setdefault(w, []).append(pos)
        # bucket -> [(size, its rows in the bucket, the same on the
        # device, their positions in request order)]: step() moves one
        # group of equal sizes at a time
        self._groups: Dict[int, list] = {}
        for w, members in self.bucket_of.items():
            rows: Dict[int, List[int]] = {}
            for row, pos in enumerate(members):
                rows.setdefault(self.sizes[pos], []).append(row)
            self._groups[w] = [
                (size, r, torch.tensor(r, device=self.device),
                 [members[row] for row in r]) for size, r in rows.items()]
        if _engines is not None:                # load() restores prefit
            self.engines = _engines
            return
        w_max = max(self.bucket_of)

        def scaled_g(w: int) -> int:
            if not num_transforms:
                return int(2 * w * np.log2(w))
            alpha = num_transforms / (w_max * np.log2(w_max))
            return max(int(round(alpha * w * np.log2(w))), 1)

        self.engines: Dict[int, FGFTServeEngine] = {}
        for w, members in sorted(self.bucket_of.items()):
            stack, sizes = pad_ragged([laps[p] for p in members], width=w,
                                      device=self.device)
            self.engines[w] = FGFTServeEngine(
                stack, scaled_g(w), n_iter=n_iter, backend=backend,
                filters=filters, kind=kind, hint=hint, tiers=tiers,
                sizes=None if np.all(sizes == w) else sizes,
                dynamic=dynamic, policy=policy, precision=precision,
                fused=fused, device=self.device)

    def __len__(self) -> int:
        return len(self.sizes)

    @property
    def num_buckets(self) -> int:
        return len(self.engines)

    def rel_errors(self) -> np.ndarray:
        """Per-graph relative Frobenius error, in request order.  A masked
        fit's objective is the graph's own-size objective (the pad block
        adds nothing), so it compares 1:1 with single-graph fits."""
        out = np.zeros(len(self.sizes))
        for w, members in self.bucket_of.items():
            obj = np.atleast_1d(
                self.engines[w].basis.objective.detach().cpu().numpy())
            for row, pos in enumerate(members):
                out[pos] = obj[row] / self._denoms[pos]
        return out

    def _stack(self, signals, positions, rows: int, size: int):
        """The (k, R, size) f32 stack of the graphs at ``positions`` on
        the engines' device; a block of another shape raises."""
        try:
            xs = torch.stack([x if isinstance(x, torch.Tensor)
                              else torch.as_tensor(x)
                              for x in (signals[p] for p in positions)])
        except RuntimeError:            # mixed shapes, devices or dtypes
            xs = None
        if xs is None or tuple(xs.shape[1:]) != (rows, size):
            for pos in positions:
                got = tuple(np.shape(signals[pos]))
                if got != (rows, size):
                    raise ValueError(f"signal block {pos} must be ({rows}, "
                                     f"{size}), got {got}")
            xs = torch.stack([torch.as_tensor(signals[p], dtype=torch.float32
                                              ).to(self.device)
                              for p in positions])
        return xs.to(self.device, torch.float32)

    def _scatter(self, signals) -> Dict[int, torch.Tensor]:
        """Per-graph (R, n_i) blocks -> a zero-padded (B_w, R, w) block per
        bucket, built on the engines' device: one stack and one indexed
        copy per size, nothing per graph."""
        if len(signals) != len(self.sizes):
            raise ValueError(f"expected {len(self.sizes)} signal blocks "
                             f"(one per graph), got {len(signals)}")
        blocks = {}
        for w, groups in self._groups.items():
            rows = int(np.shape(signals[groups[0][3][0]])[0])
            if len(groups) == 1 and groups[0][0] == w:  # fills its bucket
                blocks[w] = self._stack(signals, groups[0][3], rows, w)
                continue
            block = torch.zeros((len(self.bucket_of[w]), rows, w),
                                dtype=torch.float32, device=self.device)
            for size, _, idx, positions in groups:
                block[idx, :, :size] = self._stack(signals, positions, rows,
                                                   size)
            blocks[w] = block
        return blocks

    def _gather(self, pending: Dict[int, torch.Tensor]) -> list:
        """Crop each bucket's output rows to their graphs' sizes, in
        request order: views of the bucket outputs, one crop per size."""
        outs: list = [None] * len(self.sizes)
        for w, y in pending.items():
            for size, rows, _, positions in self._groups[w]:
                cropped = y[..., :size].unbind(0)
                for row, pos in zip(rows, positions):
                    outs[pos] = cropped[row]
        return outs

    def step(self, signals, h=None, tier: Optional[str] = None) -> list:
        """Filter one signal block per graph (a list of (R, n_i) arrays or
        tensors) at the requested tier, one dispatch per bucket.  Returns
        the filtered (R, n_i) blocks in request order."""
        pending = {w: self.engines[w].step(block, h, tier=tier)
                   for w, block in self._scatter(signals).items()}
        return self._gather(pending)

    def step_bank(self, signals) -> list:
        """All F bank responses on every graph (needs ``filters=``): a
        list of (R, n_i) blocks -> a list of (F, R, n_i) blocks in request
        order, one bank dispatch per bucket (the gains are zero at pad
        coordinates, so the crop is exact)."""
        pending = {w: self.engines[w].step_bank(block)
                   for w, block in self._scatter(signals).items()}
        return self._gather(pending)

    def reset_step_stats(self):
        """Zero every bucket engine's per-tier step counters (after a
        warm-up, as the uniform path does)."""
        for eng in self.engines.values():
            eng.stats["steps"] = {name: 0 for name in eng.tiers}

    @property
    def stats(self) -> dict:
        return {w: eng.stats for w, eng in self.engines.items()}

    # -- streaming updates: per-bucket hot swaps ---------------------------

    def _locate(self, graph_id: int) -> tuple:
        if not 0 <= graph_id < len(self.sizes):
            raise ValueError(f"graph_id {graph_id} not in fleet of "
                             f"{len(self.sizes)}")
        w = self.widths[graph_id]
        return w, self.bucket_of[w].index(graph_id)

    def apply_updates(self, graph_id: int, delta):
        """Route one update batch to the graph's bucket engine (request-
        order ``graph_id``; the bucket keeps serving its OTHER graphs on
        the old version until its own ``maintain`` swap)."""
        w, row = self._locate(graph_id)
        self.engines[w].apply_updates(row, delta)

    def drift(self) -> np.ndarray:
        """Per-graph drift scores, request order."""
        out = np.zeros(len(self.sizes))
        for w, members in self.bucket_of.items():
            d = self.engines[w].drift()
            for row, pos in enumerate(members):
                out[pos] = d[row]
        return out

    def maintain(self, buckets=None, dirty_only: bool = False) -> dict:
        """One controller tick per bucket; buckets refit and swap
        independently.  ``buckets`` restricts the tick to those widths;
        ``dirty_only`` skips buckets with no pending updates entirely.
        Returns {width: that engine's maintain result}."""
        sel = (sorted(self.engines) if buckets is None
               else [int(w) for w in buckets])
        out = {}
        for w in sel:
            eng = self.engines[w]
            if dirty_only and not bool(
                    np.any(getattr(eng, "_dirty", False))):
                continue
            out[w] = eng.maintain()
        return out

    @property
    def versions(self) -> np.ndarray:
        """Per-graph basis versions, request order."""
        out = np.zeros(len(self.sizes), np.int64)
        for w, members in self.bucket_of.items():
            v = self.engines[w].versions
            for row, pos in enumerate(members):
                out[pos] = v[row]
        return out

    # -- persistence: one checkpoint per bucket + a router manifest --------

    def save(self, directory, step: int = 0):
        """Persist every bucket engine (basis and dynamic state) plus the
        routing geometry, so that ``load`` rebuilds the fleet without
        refitting."""
        directory = pathlib.Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        for w, eng in self.engines.items():
            eng.save(directory / f"bucket_{w:05d}", step)
        # the manifest is replaced atomically, as the bucket checkpoints
        tmp = directory / "router.json.tmp"
        tmp.write_text(json.dumps(
            {"sizes": self.sizes, "widths": self.widths, "step": step}))
        os.replace(tmp, directory / "router.json")
        return directory

    @classmethod
    def load(cls, directory, step: Optional[int] = None, *,
             backend: Optional[str] = None, filters: Optional[str] = None,
             tiers: Optional[Dict[str, float]] = None,
             dynamic: Optional[bool] = None, policy=None,
             precision: Optional[str] = None,
             fused: Optional[bool] = None, placement=None, mesh=None,
             device="cuda") -> "RaggedFGFTServeEngine":
        """Rebuild a fleet router (saved by either package) from its
        per-bucket checkpoints, with the persisted widths and buckets;
        ``dynamic``/``policy`` as in ``FGFTServeEngine.load`` for every
        bucket (``dynamic=True`` makes a static router's checkpoint
        dynamic).  A checkpoint with a placement manifest
        (``placement.json``) loads only with ``placement=False``
        (unplaced): placement comes with a later slice of the port."""
        directory = pathlib.Path(directory)
        manifest = json.loads((directory / "router.json").read_text())
        if placement is False:
            placement = None
        elif (directory / "placement.json").exists():
            raise _not_ported("restoring a placed fleet (placement.json; "
                              "pass placement=False to load it unplaced)",
                              "multi-GPU placement")
        _refuse_unported(placement, mesh)
        if step is None:
            step = int(manifest["step"])
        sizes = [int(s) for s in manifest["sizes"]]
        widths = [int(w) for w in manifest["widths"]]
        bucket_of: Dict[int, List[int]] = {}
        for pos, w in enumerate(widths):
            bucket_of.setdefault(w, []).append(pos)
        engines = {w: FGFTServeEngine.load(
            directory / f"bucket_{w:05d}", step, backend=backend,
            filters=filters, tiers=tiers, dynamic=dynamic, policy=policy,
            precision=precision, fused=fused, device=device)
            for w in sorted(bucket_of)}
        # request-order Laplacians from the restored buckets (pads are
        # zero, so the per-graph denominators crop for free)
        laps = [None] * len(sizes)
        for w, members in bucket_of.items():
            for row, pos in enumerate(members):
                n_i = sizes[pos]
                laps[pos] = engines[w]._laps[row, :n_i, :n_i]
        return cls(laps, dynamic=any(e.dynamic for e in engines.values()),
                   _engines=engines, _widths=widths, device=device)


def serve_fgft_ragged(args) -> dict:
    """Serve a heterogeneous fleet: ``--graphs`` community graphs whose
    sizes cycle through ``--graph-sizes``, bucketed, fitted and served per
    power-of-two bucket, every tier (or the bank of ``--filter``)
    timed over ``--filter-steps`` steps."""
    from repro_torch.core.fgft import laplacian
    from repro_torch.graphs import community_graph, directed_variant

    device = _resolve(args.device)
    sizes = [args.size_list[i % len(args.size_list)]
             for i in range(args.graphs)]
    adjs = [community_graph(n, seed=s) for s, n in enumerate(sizes)]
    if args.directed:
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    laps = [laplacian(a) for a in adjs]
    kind = "general" if args.directed else "auto"
    t0 = time.perf_counter()
    router = RaggedFGFTServeEngine(
        laps, args.transforms, backend=args.backend, kind=kind,
        filters=args.filter, tiers=args.tier_map, fused=args.fused,
        precision=args.precision, device=device)
    _sync(device)
    fit_s = time.perf_counter() - t0
    rel = router.rel_errors()
    buckets = {w: len(m) for w, m in sorted(router.bucket_of.items())}
    g = {w: e.basis.num_transforms for w, e in sorted(router.engines.items())}
    print(f"[fgft] fitted {len(laps)} graphs (sizes {sorted(set(sizes))}, "
          f"kind={next(iter(router.engines.values())).basis.kind}) into "
          f"{router.num_buckets} buckets {buckets} (g per bucket {g}) on "
          f"{device}: {fit_s:.1f}s, mean rel error {rel.mean():.4f}")
    rng = np.random.default_rng(args.seed)
    signals = [torch.from_numpy(rng.standard_normal(
        (args.signals, n)).astype(np.float32)).to(device) for n in sizes]
    backend = args.backend or ("cuda" if device.type == "cuda" else "torch")
    out = {"rel_error": rel, "sizes": sizes, "buckets": sorted(buckets),
           "fit_s": fit_s, "router": router, "laps": laps,
           "signals": signals}
    steps = args.filter_steps
    if args.filter:
        f = len(next(iter(router.engines.values())).bank)
        router.step_bank(signals)            # warmup: not counted
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            router.step_bank(signals)
        _sync(device)
        dt = max(time.perf_counter() - t0, 1e-9)
        served = steps * len(laps) * f
        print(f"[fgft] served {served} ragged filter responses ({f} filters "
              f"x {len(laps)} graphs x {steps} steps) in {dt:.2f}s — "
              f"{served / dt:.1f} responses/s across {router.num_buckets} "
              f"bank dispatches/step [{backend}]")
        return {**out, "responses_per_s": served / dt}
    lowpass = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
    first = next(iter(router.engines.values()))
    tier_stats = {}
    for name in first.tiers:
        router.step(signals, lowpass, tier=name)     # warmup: not counted
        for eng in router.engines.values():
            eng.stats["steps"][name] = 0
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            router.step(signals, lowpass, tier=name)
        _sync(device)
        dt = max(time.perf_counter() - t0, 1e-9)
        served = steps * len(laps)
        tier_stats[name] = {"transforms_per_s": served / dt, **{
            key: {w: e.tiers[name][key]
                  for w, e in sorted(router.engines.items())}
            for key in ("num_transforms", "num_stages")}}
        print(f"[fgft]   tier {name!r}: g' per bucket "
              f"{tier_stats[name]['num_transforms']} (stages "
              f"{tier_stats[name]['num_stages']}) — {served / dt:.1f} "
              f"graph-transforms/s across {router.num_buckets} bucket "
              f"dispatches/step [{backend}]")
    base = tier_stats[first.default_tier]["transforms_per_s"]
    return {**out, "transforms_per_s": base, "tiers": tier_stats,
            "stats": router.stats}


def serve_fgft_dynamic(args, on_round=None) -> dict:
    """Serve an EVOLVING fleet: per round, apply one edge-update batch per
    graph (``edge_perturbation`` at ``--churn`` of its edge slots, through
    a ``GraphStream``), run the drift-triggered maintenance tick off the
    hot path, then serve ``--filter-steps`` steps through the hot-swapped
    version, timed.  Works for the uniform engine and the ragged router
    (``--ragged``), undirected or ``--directed``.  ``on_round(round,
    engine, record, signals, served)``, when given, is called after each
    round with that round's record and its last served block."""
    from repro_torch.dynamic import GraphStream
    from repro_torch.graphs import (community_graph, directed_variant,
                                    edge_perturbation)

    device = _resolve(args.device)
    b = args.graphs
    sizes = ([args.size_list[i % len(args.size_list)] for i in range(b)]
             if args.ragged else [args.graph_n] * b)
    adjs = [community_graph(n, seed=s) for s, n in enumerate(sizes)]
    if args.directed:
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    stream = GraphStream(adjs, directed=args.directed)
    laps = stream.laplacians()
    kind = "general" if args.directed else "auto"
    t0 = time.perf_counter()
    if args.ragged:
        engine = RaggedFGFTServeEngine(
            laps, args.transforms, backend=args.backend, kind=kind,
            filters=args.filter, tiers=args.tier_map, dynamic=True,
            policy=args.policy, fused=args.fused, precision=args.precision,
            device=device)
        engines = engine.engines
    else:
        g = args.transforms or int(2 * args.graph_n * np.log2(args.graph_n))
        engine = FGFTServeEngine(
            np.stack(laps), g, backend=args.backend, kind=kind,
            filters=args.filter, tiers=args.tier_map, dynamic=True,
            policy=args.policy, fused=args.fused, precision=args.precision,
            device=device)
        engines = {args.graph_n: engine}
    _sync(device)
    fit_s = time.perf_counter() - t0
    backend = args.backend or ("cuda" if device.type == "cuda" else "torch")
    print(f"[fgft] fitted evolving fleet of {b} graphs in {fit_s:.1f}s on "
          f"{device}; streaming {args.update_rounds} rounds at churn "
          f"{args.churn}")
    rng = np.random.default_rng(args.seed)

    def signal_block():
        if args.ragged:
            return [torch.from_numpy(rng.standard_normal(
                (args.signals, n)).astype(np.float32)).to(device)
                for n in sizes]
        return torch.from_numpy(rng.standard_normal(
            (b, args.signals, args.graph_n)).astype(np.float32)).to(device)

    lowpass = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
    engine.step(signal_block(), lowpass)         # warmup: builds kernels
    _sync(device)
    rounds: List[dict] = []
    t_serve = t_maintain = 0.0
    for rnd in range(args.update_rounds):
        for gid in range(b):
            budget = max(int(args.churn * sizes[gid]
                             * (sizes[gid] - 1) / 2), 1)
            batch = edge_perturbation(
                stream.adjs[gid], budget,
                seed=args.seed + 1000 * (rnd + 1) + gid,
                directed=args.directed)
            engine.apply_updates(gid, stream.apply(gid, batch))
        t0 = time.perf_counter()
        res = engine.maintain()
        dt = time.perf_counter() - t0
        t_maintain += dt
        ticks = list(res.values()) if args.ragged else [res]
        acted = list(res) if args.ragged else list(engines)
        split = {k: sum(engines[w].maintain_ms[k] for w in acted)
                 for k in ("drift", "action", "install", "post_drift")}
        record = {
            "round": rnd,
            "action": "+".join(sorted({r["action"] for r in ticks})),
            "drift": max(float(np.max(r["drift"])) for r in ticks),
            "post_drift": max(float(np.max(r["post_drift"]))
                              for r in ticks),
            "versions": engine.versions.tolist(), "maintain_ms": dt * 1e3,
            "maintain_split_ms": split}
        x = signal_block()
        t0 = time.perf_counter()
        for _ in range(args.filter_steps):
            ys = engine.step(x, lowpass)
        _sync(device)
        dt = max(time.perf_counter() - t0, 1e-9)
        t_serve += dt
        record["transforms_per_s"] = args.filter_steps * b / dt
        rounds.append(record)
        # maintain() already scored the post-action drift; no extra probe
        # pass here distorts the serve/maintain split
        print(f"[fgft]   round {rnd}: action={record['action']}, max drift "
              f"{record['drift']:.4f} -> {record['post_drift']:.4f}, "
              f"versions {record['versions']}; maintain "
              f"{record['maintain_ms']:.1f} ms (drift probe "
              f"{split['drift']:.1f}, action {split['action']:.1f}, install "
              f"{split['install']:.1f}, post-action probe "
              f"{split['post_drift']:.1f}); "
              f"{record['transforms_per_s']:.1f} graph-transforms/s after "
              f"the swap [{backend}]")
        if on_round is not None:
            on_round(rnd, engine, record, x, ys)
    served = args.update_rounds * args.filter_steps * b
    print(f"[fgft] served {served} graph-filter requests across "
          f"{args.update_rounds} update rounds (serve {t_serve:.2f}s, "
          f"maintain {t_maintain:.2f}s) [{backend}]")
    dyn_stats = (engine.stats["dynamic"] if not args.ragged
                 else {w: s["dynamic"] for w, s in engine.stats.items()})
    print(f"[fgft] dynamic stats: {dyn_stats}")
    return {"actions": [r["action"] for r in rounds],
            "versions": engine.versions.tolist(), "serve_s": t_serve,
            "maintain_s": t_maintain, "stats": dyn_stats, "rounds": rounds,
            "fit_s": fit_s, "engine": engine, "stream": stream,
            "sizes": sizes}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Batched FGFT service of the PyTorch/CUDA port.",
        # no prefix matching: a later slice's flag must not be read as a
        # prefix of a ported one
        allow_abbrev=False)
    ap.add_argument("--fgft", action="store_true",
                    help="serve batched graph Fourier transforms (the only "
                         "mode this port serves so far)")
    ap.add_argument("--filter", default=None,
                    help="serve a spectral filter BANK through the fused "
                         "bank kernel (implies --fgft); comma-separated "
                         "responses, e.g. 'heat:3.0,tikhonov,wavelets:4' "
                         "(repro_torch/spectral/filters.py::"
                         "named_responses)")
    ap.add_argument("--graphs", type=int, default=8,
                    help="number of graphs served per step (B)")
    ap.add_argument("--graph-n", type=int, default=64)
    ap.add_argument("--ragged", action="store_true",
                    help="serve a HETEROGENEOUS fleet: graphs of mixed "
                         "sizes (--graph-sizes) are grouped into "
                         "power-of-two buckets, each bucket fitted once "
                         "with a masked greedy and served by its own "
                         "engine")
    ap.add_argument("--graph-sizes", default="24,48,64",
                    help="comma-separated graph sizes cycled over "
                         "--graphs when --ragged is given")
    ap.add_argument("--transforms", type=int, default=0,
                    help="g (0 -> 2 n log2 n)")
    ap.add_argument("--signals", type=int, default=32,
                    help="signal rows filtered per graph per step")
    ap.add_argument("--filter-steps", type=int, default=20)
    ap.add_argument("--tiers", default=None,
                    help="named anytime quality tiers as "
                         "'name:fraction,...' (default "
                         "'full:1.0,balanced:0.5,draft:0.25')")
    ap.add_argument("--backend", choices=("cuda", "torch"), default=None,
                    help="cuda: the hand-written kernels (default on a "
                         "card); torch: their plain PyTorch versions")
    ap.add_argument("--precision", choices=("f32", "bf16"), default="f32",
                    help="storage precision of the served tables: bf16 "
                         "halves the value-table bytes and keeps f32 "
                         "accumulation (the filter error stays within "
                         "the 2 Lip(h) delta bound)")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve through the fused one-launch operator "
                         "(default); --no-fused runs three passes")
    ap.add_argument("--directed", action="store_true",
                    help="serve directed graphs through the T-transform "
                         "(scaling/shear) family")
    ap.add_argument("--dynamic", action="store_true",
                    help="serve an EVOLVING fleet (implies --fgft): per "
                         "round, stream edge-update batches into the "
                         "engine (apply_updates), run the drift-triggered "
                         "refit controller (maintain) off the hot path, "
                         "and keep serving through versioned hot swaps")
    ap.add_argument("--update-rounds", type=int, default=5,
                    help="update/serve rounds in --dynamic mode")
    ap.add_argument("--churn", type=float, default=0.02,
                    help="fraction of each graph's edge slots perturbed "
                         "per round in --dynamic mode")
    ap.add_argument("--drift-thresholds", default=None,
                    help="refit-policy thresholds as "
                         "'refresh,extend,refit' drift scores "
                         "(default: the RefitPolicy defaults)")
    ap.add_argument("--serve-async", action="store_true",
                    help="serve through the ASYNC front end (implies "
                         "--fgft): bounded request queue with load "
                         "shedding, cross-tenant micro-batching into "
                         "fused dispatches, background maintenance on "
                         "its own CUDA stream, per-tier SLO stats "
                         "(launch/service.py)")
    ap.add_argument("--load-requests", type=int, default=64,
                    help="requests generated by the --serve-async load")
    ap.add_argument("--load-workers", type=int, default=4,
                    help="closed-loop tenant threads in --serve-async")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop arrival rate for --serve-async "
                         "(0 = closed loop driven by --load-workers)")
    ap.add_argument("--max-queue", type=int, default=128,
                    help="admission-control queue bound (requests past "
                         "it are shed with a typed rejection)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="max requests coalesced into one fused dispatch")
    ap.add_argument("--maintain-interval", type=float, default=0.05,
                    help="background maintenance period in seconds "
                         "(--serve-async --dynamic)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run's "
                         "spans and events to PATH on exit (loads in "
                         "chrome://tracing and Perfetto)")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="write metrics.json + metrics.prom snapshots "
                         "of the obs registry into DIR on exit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to fit and serve on")
    args, rest = ap.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in _LATER_FLAGS:
            ap.error(f"{flag} is not ported yet: it comes with "
                     f"{_LATER_FLAGS[flag]} slice of repro_torch")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.filter is not None:
        from repro_torch.spectral import named_responses
        args.fgft = True
        try:
            if not named_responses(args.filter):
                raise ValueError("empty filter bank")
        except ValueError as e:
            ap.error(str(e))
    if args.ragged or args.dynamic or args.serve_async:
        args.fgft = True
    for flag in ("max_queue", "max_batch", "load_workers"):
        if getattr(args, flag) < 1:
            ap.error(f"--{flag.replace('_', '-')} must be >= 1")
    args.policy = None
    if args.drift_thresholds:
        from repro_torch.dynamic.refit import RefitPolicy
        try:
            lo, mid, hi = (float(t) for t in
                           args.drift_thresholds.split(","))
        except ValueError:
            ap.error("--drift-thresholds must be three comma-separated "
                     "floats: refresh,extend,refit")
        try:
            args.policy = RefitPolicy(refresh=lo, extend=mid, refit=hi)
        except ValueError as e:
            ap.error(str(e))
    if not args.fgft:
        ap.error("--fgft is required: the LM engine comes with the LM "
                 "scaffold slice of repro_torch")
    try:
        args.tier_map = (parse_tiers(args.tiers) if args.tiers
                         else dict(DEFAULT_TIERS))
    except ValueError as e:
        ap.error(str(e))
    try:
        args.size_list = [int(s) for s in
                          filter(None, args.graph_sizes.split(","))]
    except ValueError:
        ap.error(f"--graph-sizes must be comma-separated ints, got "
                 f"{args.graph_sizes!r}")
    if args.ragged and (not args.size_list
                        or any(s < 2 for s in args.size_list)):
        ap.error("--graph-sizes needs at least one size >= 2")
    return args


def _export_obs(args):
    """``--trace`` / ``--metrics-dir``: runs on every exit path (``main``
    wraps the serving functions in try/finally), so a failed run still
    leaves its telemetry behind."""
    if args.trace:
        path = obs.export_trace(args.trace)
        print(f"[obs] chrome trace -> {path}")
    if args.metrics_dir:
        out = obs.export_metrics(args.metrics_dir)
        print(f"[obs] metrics -> {out['json']} + {out['prom']}")


def main(argv=None):
    args = parse_args(argv)
    try:
        return serve_fgft(args)
    finally:
        _export_obs(args)


if __name__ == "__main__":
    main()
