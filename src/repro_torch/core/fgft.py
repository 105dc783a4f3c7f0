"""Fast Graph Fourier Transforms of undirected graphs (the paper's §5).

Undirected graph -> symmetric Laplacian -> G-transform factorization
(an orthonormal fast eigenspace).  ``FGFT`` bundles the factors, the
staged tables and the estimated spectrum of ONE graph, and runs
analysis, synthesis and spectral filtering through the single-matrix
entry points (on the card: the CUDA kernels launched with B = 1).  For
many graphs at once use ``ApproxEigenbasis`` (core/eigenbasis.py).
Directed graphs (the T-transform family) are a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import gtransform as gt
from .staging import StagedG, pack_g_pair, select_cut
from .types import GFactors


def laplacian(adj: np.ndarray, normalized: bool = False) -> np.ndarray:
    """Graph Laplacian L = D - A as (n, n) f32 numpy (``normalized=True``
    gives D^{-1/2} L D^{-1/2}, degree-0 rows guarded)."""
    deg = np.asarray(adj).sum(axis=1)
    lap = np.diag(deg) - np.asarray(adj)
    if normalized:
        d = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        lap = lap * d[:, None] * d[None, :]
    return lap.astype(np.float32)


@dataclass
class FGFT:
    """A fast approximate graph Fourier transform for ONE undirected
    graph.  ``spectrum`` is (n,) f32; ``fwd``/``bwd`` are the staged
    (S, P) tables of Ubar and Ubar^T.  Signals put the graph coordinate
    on the LAST axis: x is (..., n) f32."""

    n: int
    spectrum: torch.Tensor
    g_factors: GFactors
    fwd: StagedG
    bwd: StagedG
    objective: float = float("nan")
    directed: bool = False

    def _plan(self, mode: str, backend: Optional[str],
              num_stages: Optional[int], keep: str = "head",
              fused: bool = True):
        from repro_torch.kernels.plan import ApplyPlan
        return ApplyPlan(family="sym", mode=mode, n=self.n, backend=backend,
                         num_stages=num_stages, keep=keep, fused=fused,
                         device=str(self.spectrum.device))

    def analysis(self, x: torch.Tensor, backend: Optional[str] = None,
                 num_stages: Optional[int] = None) -> torch.Tensor:
        """Graph Fourier coefficients x_hat = Ubar^T x: (..., n) -> (..., n);
        ``num_stages`` runs the anytime prefix transform (the adjoint
        tables' head; synthesis keeps the forward tables' tail)."""
        plan = self._plan("apply", backend, num_stages, "head")
        return plan.apply(self.bwd, x)

    def synthesis(self, xh: torch.Tensor, backend: Optional[str] = None,
                  num_stages: Optional[int] = None) -> torch.Tensor:
        """Inverse transform x = Ubar x_hat (exact inverse of ``analysis``)."""
        plan = self._plan("apply", backend, num_stages, "tail")
        return plan.apply(self.fwd, xh)

    def project(self, x: torch.Tensor, h: Optional[Callable] = None,
                backend: Optional[str] = None,
                num_stages: Optional[int] = None,
                fused: bool = True) -> torch.Tensor:
        """Spectral filter y = Ubar diag(h(spectrum)) Ubar^T x in one fused
        launch (``h`` defaults to the identity: the Laplacian itself);
        ``fused=False`` runs three passes."""
        d = self.spectrum if h is None else h(self.spectrum)
        plan = self._plan("operator", backend, num_stages, fused=fused)
        return plan.operator(self.fwd, self.bwd, d, x)

    @property
    def stage_cuts(self) -> np.ndarray:
        return self.fwd.cuts

    def select_tier(self, fraction: Optional[float] = None,
                    num_transforms: Optional[int] = None) -> tuple:
        """The exact stage cut nearest a component target:
        ``(num_stages, num_components)``."""
        return select_cut(self.fwd, num_transforms=num_transforms,
                          fraction=fraction)

    def prefix_transforms(self, num_transforms: int) -> GFactors:
        """The leading ``num_transforms`` components (significance order:
        the application-order TAIL of ``g_factors``)."""
        g = self.g_factors.g
        return GFactors(*(f[g - num_transforms:] for f in self.g_factors))

    def flops_per_matvec(self, num_transforms: Optional[int] = None) -> int:
        """Paper Table-1 cost of one matvec with Ubar diag(s) Ubar^T:
        12 g + n."""
        g = self.g_factors.g if num_transforms is None else num_transforms
        return 12 * g + self.n


def build_fgft(lap, num_transforms: int, directed: bool = False,
               n_iter: int = 8, eps: float = 1e-3,
               update_spectrum: bool = True, device="cuda") -> FGFT:
    """Factorize one (n, n) undirected graph Laplacian into a fast
    approximate GFT (Algorithm 1, then host packing of the stages)."""
    if directed:
        raise NotImplementedError("directed graphs (the T-transform family)"
                                  " are not ported yet: they come with the "
                                  "directed slice of repro_torch")
    dev = torch.device(device)
    lap = torch.as_tensor(lap, dtype=torch.float32).to(dev)
    n = lap.shape[0]
    factors, sbar, info = gt.approximate_symmetric(
        lap, g=num_transforms, n_iter=n_iter, eps=eps,
        update_spectrum=update_spectrum)
    fwd, bwd = pack_g_pair(factors, n=n, device=dev)
    return FGFT(n=n, spectrum=sbar, g_factors=factors, fwd=fwd, bwd=bwd,
                objective=float(info["objective"]))


def _relative(obj: float, denom: float) -> float:
    """obj / denom, guarded for the all-zero Laplacian (exact error 0)."""
    if denom > 0.0:
        return obj / denom
    return 0.0 if obj <= 1e-12 else float("inf")


def relative_error(lap, f: FGFT) -> float:
    """||L - Lbar||_F^2 / ||L||_F^2 — the paper's accuracy metric."""
    lap = torch.as_tensor(lap, dtype=torch.float32).to(f.spectrum.device)
    denom = float((lap * lap).sum())
    obj = float(gt.g_objective(lap, f.g_factors, f.spectrum))
    return _relative(obj, denom)


def prefix_relative_error(lap, f: FGFT, num_transforms: int) -> float:
    """Relative error of the anytime prefix operator with the leading
    ``num_transforms`` components, spectrum refit by Lemma 1."""
    lap = torch.as_tensor(lap, dtype=torch.float32).to(f.spectrum.device)
    denom = float((lap * lap).sum())
    pre = f.prefix_transforms(num_transforms)
    sbar = gt.lemma1_spectrum(lap, pre)
    return _relative(float(gt.g_objective(lap, pre, sbar)), denom)
