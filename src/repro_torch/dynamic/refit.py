"""Drift-triggered refit policy and the Lemma-1 spectrum refreshes.

The dynamic subsystem's middle layer.  Given the drift score of
dynamic/drift.py, the controller picks the CHEAPEST action that restores
serving quality:

  REUSE    drift below every threshold — keep serving the current basis.
  REFRESH  Lemma-1 spectrum-only refresh (symmetric family): the factor
           chain stays, only ``diag(Ubar^T L' Ubar)`` is recomputed — one
           staged apply of the identity (on the card the batched G-chain
           kernel) and one einsum, no greedy work, no table repack.
  EXTEND   warm-start ``ApproxEigenbasis.extend`` with a small extra-
           component budget: the greedy absorbs the perturbation with few
           extra rotations instead of refitting g components from scratch.
  REFIT    full from-scratch fit — the escape hatch for structural drift
           (and the forced action after ``max_extends`` chained extends,
           so factor chains cannot grow without bound).

Hysteresis (anti-flapping): firing an action records a FLOOR at that
severity.  The floor only clears when the post-action drift falls below
``hysteresis x`` that action's threshold; while it stands, a re-trigger
at (or below) the floored severity ESCALATES one level instead of
repeating an action that demonstrably did not take.

A quality tier serves the anytime prefix of the staged tables, and its
spectrum is refit on that prefix basis: ``diag(Ubar'^T L Ubar')``.  The
prefix basis comes from one staged apply of the identity through the
apply-mode plan — on the card that is the batched G-chain CUDA kernel
over the forward tables' tail — and the diagonal is one einsum.  The
programs are cached per (batch, width, cut, device).
"""
from __future__ import annotations

import enum
import functools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional

import numpy as np
import torch


class Action(enum.Enum):
    """Refit actions, ascending severity/cost."""

    REUSE = "reuse"
    REFRESH = "refresh"
    EXTEND = "extend"
    REFIT = "refit"


_SEVERITY = {Action.REUSE: 0, Action.REFRESH: 1, Action.EXTEND: 2,
             Action.REFIT: 3}
_BY_SEVERITY = [Action.REUSE, Action.REFRESH, Action.EXTEND, Action.REFIT]


@dataclass(frozen=True)
class RefitPolicy:
    """Thresholds on the drift score (dynamic/drift.py) + budgets.

    ``refresh``/``extend``/``refit``: ascending drift thresholds; drift
    below ``refresh`` means REUSE.  ``hysteresis`` in (0, 1]: an action's
    floor re-arms only when post-action drift < hysteresis x threshold.
    ``extend_fraction``: extra components per EXTEND, as a fraction of
    the ORIGINAL fitted g (relative to the original so chained extends
    add linearly, not geometrically).  ``max_extends``: chained extends
    before a forced full refit.  ``num_probes``/``seed``: the Hutchinson
    drift estimator's budget.
    """

    refresh: float = 0.01
    extend: float = 0.08
    refit: float = 0.5
    hysteresis: float = 0.5
    extend_fraction: float = 0.125
    max_extends: int = 4
    num_probes: int = 8
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.refresh <= self.extend <= self.refit:
            raise ValueError(
                f"thresholds must be ascending and positive, got "
                f"refresh={self.refresh}, extend={self.extend}, "
                f"refit={self.refit}")
        if not 0.0 < self.hysteresis <= 1.0:
            raise ValueError(f"hysteresis must be in (0, 1], got "
                             f"{self.hysteresis}")
        if not 0.0 < self.extend_fraction:
            raise ValueError("extend_fraction must be positive")
        if self.max_extends < 0 or self.num_probes < 1:
            raise ValueError("max_extends must be >= 0, num_probes >= 1")

    def threshold(self, action: Action) -> float:
        return {Action.REFRESH: self.refresh, Action.EXTEND: self.extend,
                Action.REFIT: self.refit}[action]


@dataclass
class RefitController:
    """The stateful half of the policy: severity mapping, hysteresis
    floor, extend budget accounting, and action counters (surfaced in
    serve stats and persisted through engine checkpoints)."""

    policy: RefitPolicy = field(default_factory=RefitPolicy)
    counts: Dict[str, int] = field(
        default_factory=lambda: {a.value: 0 for a in Action})
    extends_since_refit: int = 0
    _floor: Action = Action.REUSE
    #: queryable decision log: one entry per recorded tick — action,
    #: drift before/after, budget + floor state AFTER the tick.  Bounded
    #: and in-memory only (deliberately NOT in ``state_dict``: the
    #: timeline is run telemetry, not controller state — restoring it
    #: would make checkpoint round-trips lossy in one direction).  The
    #: JAX package also mirrors each entry to its tracer as a
    #: ``refit_decision`` event; the port's tracer comes with its
    #: observability slice, so the timeline is the only log here
    timeline: Deque[dict] = field(
        default_factory=lambda: deque(maxlen=512), repr=False,
        compare=False)

    def decide(self, drift, can_refresh: bool = True) -> Action:
        """Map the worst per-graph drift to an action (pure — counters
        move in ``record`` once the action actually executed).

        ``can_refresh=False`` marks a family without a cheap spectrum
        refresh (the general/T family: Lemma 2 needs a dense solve per
        graph) — a refresh-level trigger escalates straight to EXTEND
        there, still subject to the ``max_extends`` budget."""
        p = self.policy
        d = float(np.max(drift)) if np.size(drift) else 0.0
        if d >= p.refit:
            act = Action.REFIT
        elif d >= p.extend:
            act = Action.EXTEND
        elif d >= p.refresh:
            act = Action.REFRESH
        else:
            act = Action.REUSE
        if act is Action.REFRESH and not can_refresh:
            act = Action.EXTEND
        # hysteresis floor: a re-trigger at or below an armed severity
        # escalates instead of flapping on an action that didn't take
        if (act is not Action.REUSE
                and _SEVERITY[act] <= _SEVERITY[self._floor]):
            act = _BY_SEVERITY[min(_SEVERITY[self._floor] + 1,
                                   _SEVERITY[Action.REFIT])]
        if (act is Action.EXTEND
                and self.extends_since_refit >= p.max_extends):
            act = Action.REFIT
        return act

    def record(self, action: Action, post_drift=0.0, drift=None):
        """Account an executed action and its post-action drift (which
        arms or clears the hysteresis floor).  A REUSE tick re-examines
        an armed floor too: drift that has decayed below the floor's
        re-arm point clears it, so quiescence restores the cheap-action
        ladder instead of leaving the next mild trigger to escalate.

        ``drift`` is the optional PRE-action score the decision was made
        from; it only feeds the timeline entry."""
        self.counts[action.value] += 1
        if action is Action.REFIT:
            self.extends_since_refit = 0
        elif action is Action.EXTEND:
            self.extends_since_refit += 1
        d = float(np.max(post_drift)) if np.size(post_drift) else 0.0
        level = self._floor if action is Action.REUSE else action
        if level is not Action.REUSE:
            armed = d >= (self.policy.hysteresis
                          * self.policy.threshold(level))
            self._floor = level if armed else Action.REUSE
        self._log_decision(action, drift, d)

    def _log_decision(self, action: Action, drift, post: float):
        entry = {"action": action.value,
                 "drift": (None if drift is None
                           else float(np.max(drift)) if np.size(drift)
                           else 0.0),
                 "post_drift": post,
                 "extends_since_refit": int(self.extends_since_refit),
                 "max_extends": int(self.policy.max_extends),
                 "floor": self._floor.value}
        self.timeline.append(entry)

    def state_dict(self) -> dict:
        """JSON-able controller state for checkpoint metadata."""
        return {"counts": dict(self.counts),
                "extends_since_refit": int(self.extends_since_refit),
                "floor": self._floor.value}

    def load_state_dict(self, state: dict):
        for k, v in (state.get("counts") or {}).items():
            if k in self.counts:
                self.counts[k] = int(v)
        self.extends_since_refit = int(state.get("extends_since_refit", 0))
        self._floor = Action(state.get("floor", Action.REUSE.value))


# ---------------------------------------------------------------------------
# Lemma-1 spectrum refreshes (symmetric family)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _prefix_spectrum_program(batched: bool, n: int,
                             num_stages: Optional[int], device: str):
    """Cached per-tier Lemma-1 refresh on the ``num_stages`` prefix basis
    (``None`` = the full chain): ``program(fwd_tables, laps)``."""
    from repro_torch.kernels.plan import ApplyPlan
    table_op = ApplyPlan(family="sym", mode="apply", n=n, batched=batched,
                         keep="tail", num_stages=num_stages,
                         device=device).program()

    def program(fwd_t, laps):
        eye = torch.eye(n, dtype=torch.float32, device=laps.device)
        if batched:
            eye = eye.expand(laps.shape[0], n, n)
        # staged apply acts on row vectors: rows of apply(eye) are the
        # basis columns, i.e. apply(eye) == Ubar^T
        ut = table_op(fwd_t, eye.contiguous())
        return torch.einsum("...ij,...jk,...ik->...i", ut, laps, ut)

    return program


def _run(basis, laps, num_stages: Optional[int]) -> torch.Tensor:
    if basis.kind != "sym":
        raise ValueError("Lemma-1 spectrum refresh applies to the "
                         "symmetric (G-transform) family only")
    from repro_torch.core.staging import table_arrays
    prog = _prefix_spectrum_program(basis.batched, basis.n,
                                    None if num_stages is None
                                    else int(num_stages),
                                    str(basis.device))
    laps = torch.as_tensor(laps, dtype=torch.float32).to(basis.device)
    return prog(table_arrays(basis.fwd), laps)


def lemma1_refresh(basis, laps) -> torch.Tensor:
    """Refreshed full-chain spectrum of a symmetric basis on (updated)
    Laplacians."""
    return _run(basis, laps, None)


def prefix_spectrum(basis, laps, num_stages: Optional[int]) -> torch.Tensor:
    """Per-tier refreshed spectrum: Lemma 1 on the ``num_stages`` prefix
    basis (``None`` = full chain)."""
    return _run(basis, laps, num_stages)
