"""Closed-form elementwise polynomial minimization (plain PyTorch).

The T-transform scores (Theorems 3 and 4) are quartic polynomials in the
transform parameter ``a`` (shears) or quartics divided by ``a^2``
(scalings).  Their minimization reduces to root finding on low-degree
derivative polynomials.  Everything here is branchless elementwise
tensor code, so the score sweeps over all n^2 index pairs (and over a
leading batch of matrices) vectorize.
"""
from __future__ import annotations

import functools
import math

import torch

_TINY = 1e-30
_TWO_PI_3 = 2.0 * math.pi / 3.0

#: abscissae of the 5-point exact quartic fit (all nonzero, so the
#: rational a^-1, a^-2 terms of the scaling score stay finite)
QUARTIC_POINTS = (-2.0, -1.0, 0.5, 1.0, 2.0)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def real_cubic_roots(a3, a2, a1, a0) -> torch.Tensor:
    """Real roots of a3 x^3 + a2 x^2 + a1 x + a0, elementwise.

    Returns 5 candidates stacked on the last axis; degenerate
    (quadratic/linear) cases fall back gracefully and may duplicate
    roots, and the exact double-root candidates are always included.
    The candidates are computed stacked, so the op count does not grow
    with their number (the fit calls this once per greedy step and per
    polish component)."""
    a3, a2, a1, a0 = torch.broadcast_tensors(a3, a2, a1, a0)
    scale = torch.maximum(torch.maximum(a3.abs(), a2.abs()),
                          torch.maximum(a1.abs(), a0.abs())) + _TINY
    is_cubic = a3.abs() > 1e-12 * scale
    is_quad = a2.abs() > 1e-12 * scale

    # --- cubic branch (normalized) ---
    a3s = torch.where(is_cubic, a3, 1.0)
    aa = a2 / a3s
    bb = a1 / a3s
    cc = a0 / a3s
    p = bb - aa * aa / 3.0
    q = 2.0 * aa ** 3 / 27.0 - aa * bb / 3.0 + cc
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    shift = (aa / 3.0)[..., None]
    # one real root
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    uv = _cbrt(torch.stack([-q / 2.0 + sq, -q / 2.0 - sq], dim=-1))
    r_single = uv.sum(-1, keepdim=True) - shift
    # three real roots (disc <= 0 implies p <= 0):
    # t_k = 2 sqrt(-p/3) cos(arccos(3q/(2p) sqrt(-3/p))/3 - 2 pi k/3)
    mneg = torch.sqrt(torch.clamp(-p / 3.0, min=0.0))
    pm = p * mneg
    denom = torch.where(pm.abs() > _TINY, pm, 1.0)
    cos_arg = torch.clamp(1.5 * q / denom, -1.0, 1.0)
    theta = (torch.arccos(cos_arg) / 3.0)[..., None]
    offsets = device_constant((0.0, _TWO_PI_3, 2.0 * _TWO_PI_3),
                              theta.dtype, theta.device)
    r012 = 2.0 * mneg[..., None] * torch.cos(theta - offsets) - shift
    r012 = torch.where((disc > 0)[..., None], r_single, r012)
    # disc ~ 0 (double-root boundary) is unstable in f32: add the exact
    # disc = 0 candidates t1 = 3q/p, t2 = t3 = -3q/(2p) unconditionally
    p_safe = torch.where(p.abs() > _TINY, p, 1.0)
    r34 = ((q / p_safe)[..., None]
           * device_constant((3.0, -1.5), q.dtype, q.device) - shift)

    # --- quadratic fallback: a2 x^2 + a1 x + a0, then linear a1 x + a0 ---
    a2s = torch.where(is_quad, a2, 1.0)
    sqq = torch.sqrt(torch.clamp(a1 * a1 - 4.0 * a2 * a0, min=0.0))
    quad = (torch.stack([-a1 + sqq, -a1 - sqq], dim=-1)
            / (2.0 * a2s)[..., None])
    a1s = torch.where(a1.abs() > 1e-12 * scale, a1, 1.0)
    lin = (-a0 / a1s)[..., None]
    fb = torch.where(is_quad[..., None], quad, lin)
    # the fallback roots fill the 5 slots as (f0, f1, f0, f0, f1)
    order = device_constant((0, 1, 0, 0, 1), torch.int64, fb.device)
    out = torch.where(is_cubic[..., None], torch.cat([r012, r34], dim=-1),
                      torch.index_select(fb, -1, order))
    return torch.where(torch.isfinite(out), out, 0.0)


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant tensor, made once per dtype and device (a
    host-to-device copy synchronizes the stream)."""
    return torch.tensor(values, dtype=dtype, device=device)


def minimize_quartic(c1, c2, c3, c4, extra_candidates=None,
                     clip: float = 1e4):
    """Minimize q(a) = c1 a + c2 a^2 + c3 a^3 + c4 a^4 elementwise.

    q(0) = 0, so the returned value is always <= 0 (a = 0 recovers the
    identity transform).  ``extra_candidates``: further tensors of
    candidate ``a``.  Returns (a_star, q_star): the first candidate, in
    the order (0, the 5 stationary-point candidates, 0, extras...), whose
    value is smallest — the JAX package's sequential strict-improvement
    scan, as one argmin."""
    roots = real_cubic_roots(4.0 * c4, 3.0 * c3, 2.0 * c2, c1)
    zero = torch.zeros_like(roots[..., :1])
    cands = [zero, roots, zero]
    if extra_candidates is not None:
        cands.extend(e.expand_as(zero[..., 0])[..., None]
                     for e in extra_candidates)
    a = torch.clamp(torch.cat(cands, dim=-1), -clip, clip)
    c1, c2, c3, c4 = (c[..., None] for c in (c1, c2, c3, c4))
    v = a * (c1 + a * (c2 + a * (c3 + a * c4)))
    v = torch.where(torch.isfinite(v), v, math.inf)
    v[..., 0] = 0.0                     # the incumbent identity: a = 0
    best = torch.argmin(v, dim=-1, keepdim=True)
    return (torch.gather(a, -1, best)[..., 0],
            torch.gather(v, -1, best)[..., 0])


def quartic_points(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """QUARTIC_POINTS as a tensor on ``device``."""
    return device_constant(QUARTIC_POINTS, dtype, device)


@functools.lru_cache(maxsize=None)
def _vander_inv(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    pts = torch.tensor(QUARTIC_POINTS, dtype=torch.float64)
    vander = torch.stack([pts ** k for k in range(5)], dim=-1)   # (5, 5)
    return torch.linalg.inv(vander).to(dtype=dtype, device=device)


def fit_quartic(values: torch.Tensor) -> torch.Tensor:
    """values: (..., 5) evaluations at QUARTIC_POINTS -> (..., 5)
    polynomial coefficients p_0..p_4."""
    inv = _vander_inv(values.dtype, values.device)
    return torch.einsum("ck,...k->...c", inv, values)
