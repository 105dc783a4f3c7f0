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

Only the uniform, static subset of the JAX package's service is ported;
its other flags exit with an error naming the later slice.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

DEFAULT_TIERS = {"full": 1.0, "balanced": 0.5, "draft": 0.25}

#: flags of the JAX package's service that belong to later slices
_LATER_FLAGS = {
    "--arch": "the LM scaffold", "--smoke": "the LM scaffold",
    "--requests": "the LM scaffold", "--batch-slots": "the LM scaffold",
    "--prompt-len": "the LM scaffold", "--gen-len": "the LM scaffold",
    "--max-len": "the LM scaffold",
    "--ragged": "the ragged/masked fit", "--graph-sizes":
    "the ragged/masked fit",
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
    ``step_bank``."""

    def __init__(self, laps, num_transforms: int = 0, n_iter: int = 3,
                 backend: Optional[str] = None, kind: str = "auto",
                 hint: Optional[str] = None,
                 tiers: Optional[Dict[str, float]] = None, basis=None,
                 fused: bool = True, filters: Optional[str] = None,
                 device="cuda"):
        from repro_torch.core import ApproxEigenbasis
        self.device = _resolve(device)
        self.backend = backend
        self._tier_spec = dict(tiers or {"full": 1.0})
        self._fused = bool(fused)
        self._filters = filters
        laps = torch.as_tensor(laps, dtype=torch.float32).to(self.device)
        if basis is None:
            if num_transforms <= 0:
                raise ValueError("num_transforms must be positive when "
                                 "no prefit basis is given")
            basis = ApproxEigenbasis.fit(laps, num_transforms,
                                         n_iter=n_iter, kind=kind,
                                         hint=hint, device=self.device)
        elif basis.device != self.device:
            raise ValueError(f"basis lives on {basis.device}, engine on "
                             f"{self.device}")
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
                num_stages=cut, fused=self._fused,
                device=str(self.device)).program()
        bank = bank_gains = bank_fn = None
        if self._filters:
            from repro_torch.spectral import (SpectralFilterBank,
                                              named_responses)
            bank = SpectralFilterBank(basis, named_responses(self._filters))
            bank_gains = bank.gains().contiguous()
            bank_fn = ApplyPlan(
                family=basis.kind, mode="bank", n=basis.n,
                batched=basis.batched, backend=self.backend,
                fused=self._fused, device=str(self.device)).program()
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


def serve_fgft(args) -> dict:
    """Build B community-graph Laplacians (their directed variants with
    ``--directed``), fit them in one batched run, serve filter steps at
    every configured quality tier, or the filter bank of ``--filter``."""
    from repro_torch.core.fgft import laplacian
    from repro_torch.graphs import community_graph, directed_variant

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
    return args


def main(argv=None):
    return serve_fgft(parse_args(argv))


if __name__ == "__main__":
    main()
