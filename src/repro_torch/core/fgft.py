"""Fast Graph Fourier Transforms (the paper's §5).

Undirected graph -> symmetric Laplacian -> G-transform factorization
(an orthonormal fast eigenspace).  Directed graph -> general Laplacian
-> scaling/shear T-transform factorization (a fast, non-orthogonal
eigenspace).  ``FGFT`` bundles the factors, the staged tables and the
estimated spectrum of ONE graph, and runs analysis, synthesis and
spectral filtering through the single-matrix entry points (on the card:
the CUDA kernels launched with B = 1).  For many graphs at once use
``ApproxEigenbasis`` (core/eigenbasis.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import gtransform as gt
from . import ttransform as tt
from .staging import pack_g_pair, pack_t_pair, select_cut
from .types import GFactors, TFactors


def laplacian(adj: np.ndarray, normalized: bool = False) -> np.ndarray:
    """Graph Laplacian L = D - A as (n, n) f32 numpy (out-degree D for
    directed graphs; ``normalized=True`` gives D^{-1/2} L D^{-1/2},
    degree-0 rows guarded)."""
    deg = np.asarray(adj).sum(axis=1)
    lap = np.diag(deg) - np.asarray(adj)
    if normalized:
        d = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        lap = lap * d[:, None] * d[None, :]
    return lap.astype(np.float32)


@dataclass
class FGFT:
    """A fast approximate graph Fourier transform for ONE graph.
    ``spectrum`` is (n,) f32; ``fwd``/``bwd`` are the staged (S, P)
    tables of Ubar and Ubar^T (undirected) or of Tbar and Tbar^{-1}
    (directed, ``t_factors`` set instead of ``g_factors``).  Signals put
    the graph coordinate on the LAST axis: x is (..., n), f32 or bf16
    (computed in its dtype; the result has it)."""

    n: int
    spectrum: torch.Tensor
    g_factors: Optional[GFactors]
    fwd: Any
    bwd: Any
    objective: float = float("nan")
    directed: bool = False
    t_factors: Optional[TFactors] = None

    @property
    def family(self) -> str:
        return "general" if self.directed else "sym"

    def _plan(self, mode: str, backend: Optional[str],
              num_stages: Optional[int], keep: str = "head",
              precision: str = "f32", fused: bool = True):
        from repro_torch.kernels.plan import ApplyPlan
        return ApplyPlan(family=self.family, mode=mode, n=self.n,
                         backend=backend, num_stages=num_stages, keep=keep,
                         precision=precision, fused=fused,
                         device=str(self.spectrum.device))

    def analysis(self, x: torch.Tensor, backend: Optional[str] = None,
                 num_stages: Optional[int] = None,
                 precision: str = "f32") -> torch.Tensor:
        """Graph Fourier coefficients x_hat = Ubar^T x (or Tbar^{-1} x):
        (..., n) -> (..., n); ``num_stages`` runs the anytime prefix
        transform (``leg_orientation`` picks the cut's end);
        ``precision="bf16"`` stores the tables in bf16 and accumulates in
        f32."""
        from repro_torch.kernels.plan import leg_orientation
        keep = leg_orientation(self.family)[0]
        return self._plan("apply", backend, num_stages, keep,
                          precision).apply(self.bwd, x)

    def synthesis(self, xh: torch.Tensor, backend: Optional[str] = None,
                  num_stages: Optional[int] = None,
                  precision: str = "f32") -> torch.Tensor:
        """Inverse transform x = Ubar x_hat (or Tbar x_hat): the exact
        inverse of ``analysis`` for G; for T it inverts up to the f32
        conditioning of Tbar."""
        from repro_torch.kernels.plan import leg_orientation
        keep = leg_orientation(self.family)[1]
        return self._plan("apply", backend, num_stages, keep,
                          precision).apply(self.fwd, xh)

    def filter(self, x: torch.Tensor, h: Optional[Callable],
               backend: Optional[str] = None,
               num_stages: Optional[int] = None, precision: str = "f32",
               fused: bool = True) -> torch.Tensor:
        """Spectral filter y = Ubar diag(h(spectrum)) Ubar^T x (or the
        Tbar form) in one fused launch; ``h`` maps the (n,) spectrum to
        (n,) gains (None: the identity, the Laplacian itself).
        ``num_stages`` cuts both legs to the same component prefix;
        ``fused=False`` runs three passes; ``precision="bf16"`` stores the
        tables in bf16 and accumulates in f32."""
        d = self.spectrum if h is None else h(self.spectrum)
        plan = self._plan("operator", backend, num_stages,
                          precision=precision, fused=fused)
        return plan.operator(self.fwd, self.bwd, d, x)

    def project(self, x: torch.Tensor, h: Optional[Callable] = None,
                backend: Optional[str] = None,
                num_stages: Optional[int] = None, precision: str = "f32",
                fused: bool = True) -> torch.Tensor:
        """``filter`` with ``h`` defaulting to the identity."""
        return self.filter(x, h, backend, num_stages, precision, fused)

    @property
    def stage_cuts(self) -> np.ndarray:
        return self.fwd.cuts

    def select_tier(self, fraction: Optional[float] = None,
                    num_transforms: Optional[int] = None) -> tuple:
        """The exact stage cut nearest a component target:
        ``(num_stages, num_components)``."""
        return select_cut(self.fwd, num_transforms=num_transforms,
                          fraction=fraction)

    def prefix_transforms(self, num_transforms: int):
        """The leading ``num_transforms`` components (significance order:
        the application-order TAIL of ``g_factors``, the HEAD of
        ``t_factors``)."""
        if self.directed:
            return TFactors(*(f[:num_transforms] for f in self.t_factors))
        g = self.g_factors.g
        return GFactors(*(f[g - num_transforms:] for f in self.g_factors))

    def flops_per_matvec(self, num_transforms: Optional[int] = None) -> int:
        """Paper Table-1 cost of one matvec with the reconstructed
        operator: 12 g + n (G), or 2 (m1 + 2 m2) + n (T, m1 scalings and
        m2 shears)."""
        if self.directed:
            kinds = self.t_factors.kind.cpu().numpy()
            if num_transforms is not None:
                kinds = kinds[:num_transforms]
            return int(2 * ((kinds == 0).sum() + 2 * (kinds == 1).sum())
                       + self.n)
        g = self.g_factors.g if num_transforms is None else num_transforms
        return 12 * g + self.n


def build_fgft(lap, num_transforms: int, directed: bool = False,
               n_iter: int = 8, eps: float = 1e-3,
               update_spectrum: bool = True, device="cuda") -> FGFT:
    """Factorize one (n, n) graph Laplacian into a fast approximate GFT
    (Algorithm 1 — G transforms, or T transforms when ``directed`` —
    then host packing of the stages)."""
    dev = torch.device(device)
    lap = torch.as_tensor(lap, dtype=torch.float32).to(dev)
    n = lap.shape[0]
    if directed:
        factors, cbar, info = tt.approximate_general(
            lap, m=num_transforms, n_iter=n_iter, eps=eps,
            update_spectrum=update_spectrum)
        fwd, bwd = pack_t_pair(factors, n, device=dev)
        return FGFT(n=n, spectrum=cbar, g_factors=None, t_factors=factors,
                    fwd=fwd, bwd=bwd, objective=float(info["objective"]),
                    directed=True)
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
    if f.directed:
        obj = float(tt.t_objective(lap, f.t_factors, f.spectrum))
    else:
        obj = float(gt.g_objective(lap, f.g_factors, f.spectrum))
    return _relative(obj, denom)


def prefix_relative_error(lap, f: FGFT, num_transforms: int) -> float:
    """Relative error of the anytime prefix operator with the leading
    ``num_transforms`` components, spectrum refit for the prefix (Lemma
    1; for T, Lemma 2 guarded against f32 regression)."""
    lap = torch.as_tensor(lap, dtype=torch.float32).to(f.spectrum.device)
    denom = float((lap * lap).sum())
    pre = f.prefix_transforms(num_transforms)
    if f.directed:
        cbar = tt.lemma2_spectrum(lap, pre)
        obj = float(torch.minimum(tt.t_objective(lap, pre, cbar),
                                  tt.t_objective(lap, pre, f.spectrum)))
    else:
        sbar = gt.lemma1_spectrum(lap, pre)
        obj = float(gt.g_objective(lap, pre, sbar))
    return _relative(obj, denom)
