"""Drift scoring: how stale is a fitted basis on an updated Laplacian?

The fitted objective is ``||L - Ubar diag(s) Ubar^T||_F^2`` (or
``||L - Tbar diag(c) Tbar^{-1}||_F^2`` for the general family).  After a
stream of edge updates moves ``L`` to ``L'``, the serving question is how
much of that objective the CURRENT basis has lost, without a dense
eigendecomposition and without materializing the reconstruction.

This module estimates the residual stochastically (Hutchinson):

    ||L' - recon||_F^2  =  E_z ||(L' - recon) z||^2

for Rademacher probes ``z``.  Each probe costs one dense matvec ``L' z``
(one einsum over the fleet) plus one fused operator apply through the
operator plan: on the card ONE launch of the operator kernel with the P
probes as its signal rows, batched over the fleet.  The probe pass is
cached per (plan, probe count); the plan names the family, width and
device, and the tables are arguments, so a hot-swapped basis version
reuses it.  The DRIFT SCORE is the estimated relative residual minus the
relative objective the basis achieved when it was (re)fitted: ~0 means
the basis is as good as the day it was fitted, positive values meter the
quality the update stream has eroded.

The probes come from a ``torch.Generator`` on the basis's device seeded
with ``seed``; they are not the JAX package's probes (``jax.random``
cannot be reproduced), so the two packages' estimates agree in
distribution, and on given probes (``_rel_residual_on``) to rounding.

Ragged (masked) bases need no special handling: ``L'`` is zero on the pad
block and the padded spectrum is zero, so pad coordinates contribute
nothing to the residual; per-graph normalization uses each graph's own
``||L'||_F^2``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_EPS = 1e-30


def _laps_on(basis, laps) -> torch.Tensor:
    return torch.as_tensor(laps, dtype=torch.float32).to(basis.device)


@functools.lru_cache(maxsize=None)
def _residual_program(plan, num_probes: int):
    """Cached Hutchinson pass: ``program(fwd_tables, bwd_tables,
    spectrum, laps, z)`` -> estimated relative residual, (B,) or a
    scalar.  ``z``: (P, n) probes; a batched pass broadcasts them over
    the fleet as one contiguous (B, P, n) block (the operator kernel
    takes contiguous signals only).  Keyed on the operator ``ApplyPlan``
    (family, width, batching, device) and the probe count; the tables
    are arguments, so every basis version of those shapes reuses it."""
    op = plan.program()
    batched, n = plan.batched, plan.n

    def program(fwd_t, bwd_t, spectrum, laps, z):
        if batched:
            z = z.expand(laps.shape[0], num_probes, n).contiguous()
        # (L' - recon) z per probe: dense matvec + fused staged operator
        lz = torch.einsum("...ij,...kj->...ki", laps, z)
        rz = lz - op(fwd_t, bwd_t, spectrum, z)
        est = (rz * rz).sum(-1).mean(-1)
        den = (laps * laps).sum((-2, -1)).clamp_min(_EPS)
        return est / den

    return program


def _rel_residual_on(basis, laps, z) -> np.ndarray:
    """The probe pass on GIVEN probes ``z`` ((P, n)): the mean over the
    probes of ``||(L' - recon) z||^2``, over ``||L'||_F^2``."""
    from repro_torch.core.staging import table_arrays
    from repro_torch.kernels.plan import ApplyPlan
    z = torch.as_tensor(z, dtype=torch.float32).to(basis.device)
    plan = ApplyPlan(family=basis.kind, mode="operator", n=basis.n,
                     batched=basis.batched, device=str(basis.device))
    prog = _residual_program(plan, int(z.shape[0]))
    out = prog(table_arrays(basis.fwd), table_arrays(basis.bwd),
               basis.spectrum, _laps_on(basis, laps), z.contiguous())
    return out.cpu().numpy()


def _rademacher(num_probes: int, n: int, seed: int,
                device) -> torch.Tensor:
    """(P, n) f32 Rademacher (+-1) probes from a ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bits = torch.randint(0, 2, (int(num_probes), int(n)), generator=gen,
                         device=device)
    return (2 * bits - 1).to(torch.float32)


def estimate_rel_residual(basis, laps, *, num_probes: int = 8,
                          seed: int = 0) -> np.ndarray:
    """Hutchinson estimate of ``||L' - recon||_F^2 / ||L'||_F^2`` per
    graph ((B,) array, or a 0-d array unbatched).  Unbiased in the
    probes; relative std ~ sqrt(2 / num_probes).  Never forms a dense
    reconstruction or eigendecomposition."""
    z = _rademacher(num_probes, basis.n, seed, basis.device)
    return _rel_residual_on(basis, laps, z)


def exact_rel_residual(basis, laps) -> np.ndarray:
    """Dense reference ``||L' - recon||_F^2 / ||L'||_F^2`` (materializes
    the (n, n) reconstruction: small-n tests and checks only)."""
    laps = _laps_on(basis, laps)
    den = (laps * laps).sum((-2, -1)).clamp_min(_EPS)
    return (basis.frobenius_error(laps) / den).cpu().numpy()


def relative_objective(objective, laps) -> np.ndarray:
    """Per-graph relative objective ``obj / max(||L||_F^2, eps)``: THE
    baseline normalization of the drift score (one definition shared by
    the serving engine's baselines and ``drift_score``)."""
    laps = torch.as_tensor(laps, dtype=torch.float32)
    den = (laps * laps).sum((-2, -1)).clamp_min(_EPS).cpu().numpy()
    obj = (objective.detach().cpu().numpy()
           if isinstance(objective, torch.Tensor) else np.asarray(objective))
    return np.atleast_1d(obj) / np.atleast_1d(den)


def drift_score(basis, laps, baseline=None, *, num_probes: int = 8,
                seed: int = 0) -> np.ndarray:
    """Per-graph drift: estimated relative residual on ``laps`` minus the
    ``baseline`` relative residual recorded when the basis was last
    (re)fitted (default: the basis's own fitted objective), floored at 0.

    A freshly fitted basis scores ~0 on its own Laplacians; the score
    grows with every update batch the basis has not absorbed; the
    refit-policy controller (dynamic/refit.py) thresholds exactly this
    number."""
    est = estimate_rel_residual(basis, laps, num_probes=num_probes,
                                seed=seed)
    if baseline is None:
        if basis.objective is None:
            raise ValueError("basis has no recorded objective; pass an "
                             "explicit baseline")
        baseline = relative_objective(basis.objective, laps)
        if not np.ndim(est):
            baseline = baseline.reshape(())
    return np.maximum(est - np.asarray(baseline), 0.0)
