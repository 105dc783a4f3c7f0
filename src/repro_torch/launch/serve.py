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

Engines and routers ``save``/``load`` through the checkpoint store in
the JAX package's format, so either package restores the other's
fleets without a refit.  The static subset of the JAX package's service
is ported; its other flags exit with an error naming the later slice.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

DEFAULT_TIERS = {"full": 1.0, "balanced": 0.5, "draft": 0.25}

#: flags of the JAX package's service that belong to later slices
_LATER_FLAGS = {
    "--arch": "the LM scaffold", "--smoke": "the LM scaffold",
    "--requests": "the LM scaffold", "--batch-slots": "the LM scaffold",
    "--prompt-len": "the LM scaffold", "--gen-len": "the LM scaffold",
    "--max-len": "the LM scaffold",
    "--precision": "the precision (bf16)",
    "--dynamic": "the dynamic maintenance",
    "--update-rounds": "the dynamic maintenance",
    "--churn": "the dynamic maintenance",
    "--drift-thresholds": "the dynamic maintenance",
    "--serve-async": "the async service",
    "--load-requests": "the async service",
    "--load-workers": "the async service", "--qps": "the async service",
    "--max-queue": "the async service", "--max-batch": "the async service",
    "--maintain-interval": "the async service",
    "--trace": "the observability", "--metrics-dir": "the observability",
}


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
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"the {slice_name} slice of repro_torch")


def _refuse_unported(dynamic, placement, mesh) -> None:
    """The engines' arguments that belong to later slices."""
    if dynamic:
        raise _not_ported("dynamic=True (streaming updates, drift and "
                          "maintenance)", "dynamic maintenance")
    if placement is not None:
        raise _not_ported("placement=", "multi-GPU placement")
    if mesh is not None:
        raise _not_ported("mesh=", "multi-GPU placement")


class FGFTServeEngine:
    """Batched spectral-filter serving over a fleet of graphs, with
    anytime quality tiers.

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
    ``precision`` ("f32"; "bf16" tables come with a later slice),
    ``dynamic``, ``placement`` and ``mesh`` are refused with the name of
    the slice that brings them."""

    def __init__(self, laps, num_transforms: int = 0, n_iter: int = 3,
                 backend: Optional[str] = None, kind: str = "auto",
                 hint: Optional[str] = None,
                 tiers: Optional[Dict[str, float]] = None, basis=None,
                 fused: bool = True, filters: Optional[str] = None,
                 sizes=None, precision: str = "f32", dynamic: bool = False,
                 placement=None, mesh=None, device="cuda"):
        from repro_torch.core import ApproxEigenbasis
        from repro_torch.core.gtransform import _valid_mask
        _refuse_unported(dynamic, placement, mesh)
        self.device = _resolve(device)
        self.backend = backend
        self._tier_spec = dict(tiers or {"full": 1.0})
        self._fused = bool(fused)
        self._filters = filters
        self._n_iter = n_iter
        self._precision = precision
        laps = torch.as_tensor(laps, dtype=torch.float32).to(self.device)
        if basis is None:
            if num_transforms <= 0:
                raise ValueError("num_transforms must be positive when "
                                 "no prefit basis is given")
            basis = ApproxEigenbasis.fit(laps, num_transforms,
                                         n_iter=n_iter, kind=kind,
                                         hint=hint, sizes=sizes,
                                         device=self.device)
        elif basis.device != self.device:
            raise ValueError(f"basis lives on {basis.device}, engine on "
                             f"{self.device}")
        self._g0 = basis.num_transforms
        # pad coordinates of a ragged bucket: h(0) need not be 0
        # (heat/Tikhonov map 0 -> 1), so step() zeroes those gains
        self._pad_mask = (None if basis.sizes is None else
                          ~_valid_mask(basis.sizes, basis.n, self.device))
        # the tracked Laplacians: what save() persists, so that load()
        # rebuilds the tier spectra without a refit
        self._laps = laps
        self.stats: Dict[str, Any] = {"steps": {}}
        self._live = None
        self._install(basis, laps)

    def _install(self, basis, laps):
        """Build a COMPLETE serving version (per-tier refit spectra, plan
        bindings and the filter bank's gains from the live spectrum) and
        swap it in with a single attribute store."""
        from repro_torch.core.staging import table_arrays
        from repro_torch.dynamic.refit import prefix_spectrum
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
            bank = SpectralFilterBank(basis, named_responses(self._filters))
            bank_gains = bank.gains().contiguous()
            bank_fn = ApplyPlan(
                family=basis.kind, mode="bank", n=basis.n,
                batched=basis.batched, backend=self.backend,
                precision=self._precision, fused=self._fused,
                device=str(self.device)).program()
        version = 0 if self._live is None else self._live.version + 1
        self._live = _LiveVersion(
            basis=basis, fwd=table_arrays(basis.fwd),
            bwd=table_arrays(basis.bwd), tiers=tiers, fns=fns,
            version=version, bank=bank, bank_gains=bank_gains,
            bank_fn=bank_fn)
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

    def warmup(self, signals: torch.Tensor) -> torch.Tensor:
        """Run every tier once (builds the kernels on first use); warmup
        steps are not counted."""
        y = None
        for name in self._live.tiers:
            y = self.step(signals, tier=name)
            self.stats["steps"][name] -= 1
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
        if live.bank is None:
            raise ValueError("engine was built without filters (--filter)")
        x = torch.as_tensor(signals, dtype=torch.float32).to(self.device)
        return (live.bank_fn(live.fwd, live.bwd, live.bank_gains, x),
                live.version)

    # -- persistence (repro_torch/checkpoint, the JAX package's format) ---

    def save(self, directory, step: int = 0, extra_metadata=None,
             shards: int = 1):
        """Persist the live basis and the serving state: the tracked
        Laplacians ride as the ``laps`` leaf, the tier spec, filters and
        fit settings as the ``serve`` metadata block, and the swap
        counter as the basis version.  ``extra_metadata`` merges more
        top-level keys."""
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
        return basis.save(directory, step, extra_state={"laps": self._laps},
                          extra_metadata=meta, shards=shards)

    @classmethod
    def load(cls, directory, step: Optional[int] = None, *, laps=None,
             backend: Optional[str] = None, filters: Optional[str] = None,
             tiers: Optional[Dict[str, float]] = None,
             dynamic: Optional[bool] = None,
             precision: Optional[str] = None,
             fused: Optional[bool] = None, placement=None, mesh=None,
             device="cuda") -> "FGFTServeEngine":
        """Rebuild a serving engine from a checkpoint (written by either
        package) WITHOUT refitting.  ``filters``, ``tiers``,
        ``precision`` and ``fused`` override the saved settings.
        ``laps`` supplies the Laplacians of a checkpoint that carries
        none (one written by ``ApproxEigenbasis.save``).  A checkpoint
        of a dynamic engine loads only with ``dynamic=False``: streaming
        maintenance comes with a later slice of the port."""
        from repro_torch.checkpoint import (latest_step, read_metadata,
                                            restore_checkpoint)
        from repro_torch.core import ApproxEigenbasis
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint in {directory}")
        meta = read_metadata(directory, step)
        if meta.get("dynamic") is not None and dynamic is not False:
            raise _not_ported("restoring a dynamic engine (its 'dynamic' "
                              "block; pass dynamic=False to serve it "
                              "statically)", "dynamic maintenance")
        _refuse_unported(dynamic, placement, mesh)
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
                     basis=basis,
                     precision=(precision if precision is not None
                                else serve_meta.get("precision", "f32")),
                     fused=(fused if fused is not None
                            else serve_meta.get("fused", True)),
                     device=dev)
        engine._live = replace(engine._live,
                               version=int(basis.info.get("version", 0)))
        # the ORIGINAL fitted budget, not the (maybe extended) chain
        engine._g0 = int(serve_meta.get("num_transforms", engine._g0))
        return engine


def serve_fgft(args) -> dict:
    """Build B community-graph Laplacians (their directed variants with
    ``--directed``), fit them in one batched run, serve filter steps at
    every configured quality tier, or the filter bank of ``--filter``
    (a mixed-size fleet with ``--ragged``: ``serve_fgft_ragged``)."""
    from repro_torch.core.fgft import laplacian
    from repro_torch.graphs import community_graph, directed_variant

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
                             filters=args.filter, device=device)
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
    constant across the fleet); 0 -> 2 w log2 w.  ``dynamic``,
    ``placement`` and ``mesh`` are refused with the name of the slice
    that brings them."""

    def __init__(self, laps, num_transforms: int = 0, n_iter: int = 3,
                 backend: Optional[str] = None,
                 filters: Optional[str] = None, kind: str = "auto",
                 hint: Optional[str] = None,
                 tiers: Optional[Dict[str, float]] = None,
                 min_width: int = 8, dynamic: bool = False,
                 precision: str = "f32", fused: bool = True,
                 placement=None, mesh=None, device="cuda",
                 _engines: Optional[Dict[int, FGFTServeEngine]] = None,
                 _widths: Optional[List[int]] = None):
        from repro_torch.core import pad_ragged
        _refuse_unported(dynamic, placement, mesh)
        self.device = _resolve(device)
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
                precision=precision, fused=fused, device=self.device)

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

    # -- persistence: one checkpoint per bucket + a router manifest --------

    def save(self, directory, step: int = 0):
        """Persist every bucket engine plus the routing geometry, so that
        ``load`` rebuilds the fleet without refitting."""
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
             dynamic: Optional[bool] = None,
             precision: Optional[str] = None,
             fused: Optional[bool] = None, placement=None, mesh=None,
             device="cuda") -> "RaggedFGFTServeEngine":
        """Rebuild a fleet router (saved by either package) from its
        per-bucket checkpoints, with the persisted widths and buckets.
        A checkpoint with a placement manifest (``placement.json``) loads
        only with ``placement=False`` (unplaced): placement comes with a
        later slice of the port."""
        directory = pathlib.Path(directory)
        manifest = json.loads((directory / "router.json").read_text())
        if placement is False:
            placement = None
        elif (directory / "placement.json").exists():
            raise _not_ported("restoring a placed fleet (placement.json; "
                              "pass placement=False to load it unplaced)",
                              "multi-GPU placement")
        _refuse_unported(dynamic, placement, mesh)
        if step is None:
            step = int(manifest["step"])
        sizes = [int(s) for s in manifest["sizes"]]
        widths = [int(w) for w in manifest["widths"]]
        bucket_of: Dict[int, List[int]] = {}
        for pos, w in enumerate(widths):
            bucket_of.setdefault(w, []).append(pos)
        engines = {w: FGFTServeEngine.load(
            directory / f"bucket_{w:05d}", step, backend=backend,
            filters=filters, tiers=tiers, dynamic=dynamic,
            precision=precision, fused=fused, device=device)
            for w in sorted(bucket_of)}
        # request-order Laplacians from the restored buckets (pads are
        # zero, so the per-graph denominators crop for free)
        laps = [None] * len(sizes)
        for w, members in bucket_of.items():
            for row, pos in enumerate(members):
                n_i = sizes[pos]
                laps[pos] = engines[w]._laps[row, :n_i, :n_i]
        return cls(laps, _engines=engines, _widths=widths, device=device)


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
        device=device)
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
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve through the fused one-launch operator "
                         "(default); --no-fused runs three passes")
    ap.add_argument("--directed", action="store_true",
                    help="serve directed graphs through the T-transform "
                         "(scaling/shear) family")
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


def main(argv=None):
    return serve_fgft(parse_args(argv))


if __name__ == "__main__":
    main()
