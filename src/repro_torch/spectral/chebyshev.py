"""Chebyshev polynomial graph filtering: the no-eigendecomposition
baseline (Hammond et al., arXiv:0912.3848 §6).

``h(L) x`` is approximated by a degree-K Chebyshev expansion of ``h`` on
``[0, lmax]`` evaluated through K Laplacian matvecs: no factorization and
no spectrum estimate.  A fused FGFT filter costs ~12g flops per signal
(analysis + synthesis at 6 flops per Givens transform, paper Table 1), a
Chebyshev term one matvec (~2·nnz flops), so ``matched_degree`` converts
a factorization budget into the polynomial degree of equal cost.

Coefficients are computed once on the host (numpy quadrature); the
recurrence is a loop of dense matvecs (``torch.matmul``), as the JAX
package computes it outside any kernel.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def estimate_lmax(lap, iters: int = 64, seed: int = 0) -> float:
    """Largest-eigenvalue bound via power iteration, with a 1% safety
    margin so the Chebyshev interval [0, lmax] covers the true spectrum.

    ``lap``: (n, n) numpy array or tensor (symmetric PSD Laplacian)."""
    a = _host(lap)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(a.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = a @ v
        lam = float(np.linalg.norm(w))
        if lam < 1e-30:
            return 1e-12
        v = w / lam
    return 1.01 * lam


def chebyshev_coefficients(response: Callable, degree: int, lmax: float,
                           num_points: Optional[int] = None
                           ) -> torch.Tensor:
    """Chebyshev expansion coefficients of ``response`` on [0, lmax].

    Chebyshev-Gauss quadrature at ``num_points`` nodes (default: 4x
    oversampled, >= 32) mapped onto the spectral interval.  Returns
    (degree + 1,) f32 on the host with the k=0 term already halved."""
    npts = num_points or max(4 * (degree + 1), 32)
    theta = np.pi * (np.arange(npts) + 0.5) / npts
    lam = (np.cos(theta) + 1.0) * (lmax / 2.0)
    h = _host(response(torch.as_tensor(lam, dtype=torch.float32)))
    ks = np.arange(degree + 1)
    c = (2.0 / npts) * (h[None, :] * np.cos(ks[:, None] * theta[None, :])
                        ).sum(axis=1)
    c[0] /= 2.0
    return torch.as_tensor(c, dtype=torch.float32)


def chebyshev_apply(lap, coeffs: torch.Tensor, lmax: float,
                    x: torch.Tensor) -> torch.Tensor:
    """y ≈ h(L) x through the three-term recurrence.

    ``lap``: (n, n) or (B, n, n); ``x``: (..., n) with a leading batch
    matching ``lap`` when batched.  K = len(coeffs) - 1 matvecs."""
    lap = torch.as_tensor(lap, dtype=x.dtype).to(x.device)
    coeffs = torch.as_tensor(coeffs, dtype=x.dtype).to(x.device)
    half = lmax / 2.0
    if lap.dim() == 3:
        # v (B, ..., n) -> rows of v against each graph's L^T
        mv = lambda v: torch.matmul(                             # noqa: E731
            v.reshape(v.shape[0], -1, v.shape[-1]),
            lap.transpose(-1, -2)).reshape(v.shape)
    else:
        mv = lambda v: torch.matmul(v, lap.T)                    # noqa: E731
    # shifted operator Lhat = L/(lmax/2) - I maps the spectrum into [-1, 1]
    op = lambda v: mv(v) / half - v                              # noqa: E731
    if coeffs.shape[0] == 1:
        return coeffs[0] * x
    t_prev, t_cur = x, op(x)
    y = coeffs[0] * t_prev + coeffs[1] * t_cur
    for k in range(2, coeffs.shape[0]):
        t_prev, t_cur = t_cur, 2.0 * op(t_cur) - t_prev
        y = y + coeffs[k] * t_cur
    return y


def matched_degree(num_transforms: int, nnz: int,
                   kind: str = "sym") -> int:
    """Chebyshev degree whose matvec flops match one fused FGFT filter.

    G-transform filter: analysis + synthesis = 12g flops/signal (6 per
    Givens each way); T-transforms average ~2 flops per component each
    way.  One Chebyshev term = one sparse matvec = 2·nnz flops."""
    flops = (12 if kind == "sym" else 4) * num_transforms
    return max(int(round(flops / (2.0 * max(nnz, 1)))), 1)


def chebyshev_filter(lap, response: Callable, x: torch.Tensor,
                     degree: int = 30,
                     lmax: Optional[float] = None) -> torch.Tensor:
    """One-shot: estimate lmax, expand ``response``, apply.

    For a (B, n, n) batch, lmax is the MAX over every graph's spectral
    bound: a graph whose spectrum pokes outside the Chebyshev interval
    makes the recurrence diverge."""
    if lmax is None:
        mats = _host(lap)
        if mats.ndim == 2:
            mats = mats[None]
        lmax = max(estimate_lmax(m) for m in mats)
    coeffs = chebyshev_coefficients(response, degree, lmax)
    return chebyshev_apply(lap, coeffs, lmax, x)
