"""Spectral filter bank over fast approximate eigenbases.

A *response* is a scalar gain function of the graph frequencies:
``h(lam) -> gains`` with ``lam`` the estimated spectrum, a torch tensor
(n,) or (B, n).  Responses self-normalize against the per-graph spectral
range (``lam.max`` along the last axis), so one response serves a whole
batch of graphs with different Laplacian scales.

The factories cover the classic GSP toolbox: heat-kernel smoothing,
Butterworth low/high-pass, Gaussian band-pass, Tikhonov denoising (the
gain ``1/(1 + tau lam)`` of ``argmin_y ||y - x||^2 + tau y^T L y``), and
Hammond-style spectral-graph-wavelet scales (arXiv:0912.3848: the
band-pass kernel ``g(x) = x e^{1-x}`` at log-spaced scales plus a
low-pass scaling function).

``SpectralFilter``/``SpectralFilterBank`` bind responses to a fitted
``ApproxEigenbasis``; ``SpectralFilterBank.apply`` runs a whole bank
through one ``ApplyPlan(mode="bank")`` dispatch (on the card: one launch
of the bank kernel), so the analysis transform is paid once for all F
filters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import as_signal

Response = Callable[[torch.Tensor], torch.Tensor]


def _lmax(lam: torch.Tensor) -> torch.Tensor:
    """Per-graph spectral range, guarded against degenerate spectra."""
    return torch.clamp(lam.abs().amax(dim=-1, keepdim=True), min=1e-12)


def heat(scale: float = 5.0) -> Response:
    """Heat-kernel smoothing  exp(-scale · lam / lam_max)."""
    return lambda lam: torch.exp(-scale * lam / _lmax(lam))


def tikhonov(tau: float = 1.0) -> Response:
    """Tikhonov denoiser  1 / (1 + tau · lam / lam_max)."""
    return lambda lam: 1.0 / (1.0 + tau * lam / _lmax(lam))


def lowpass(frac: float = 0.25, order: int = 4) -> Response:
    """Butterworth low-pass with cutoff at ``frac`` of the spectral range."""
    return lambda lam: 1.0 / (1.0 + (lam / (frac * _lmax(lam)))
                              ** (2 * order))


def highpass(frac: float = 0.25, order: int = 4) -> Response:
    """Complement of ``lowpass``: passes frequencies above the cutoff."""
    lp = lowpass(frac, order)
    return lambda lam: 1.0 - lp(lam)


def bandpass(center_frac: float = 0.5, width_frac: float = 0.15
             ) -> Response:
    """Gaussian band-pass centered at ``center_frac`` of the range."""

    def resp(lam):
        mx = _lmax(lam)
        z = (lam - center_frac * mx) / (width_frac * mx)
        return torch.exp(-z * z)

    return resp


def hammond_kernel(x: torch.Tensor) -> torch.Tensor:
    """SGWT band-pass kernel  g(x) = x · e^{1-x}  (peak g(1) = 1)."""
    return x * torch.exp(1.0 - x)


def wavelet_scales(num_scales: int = 4, scale_ratio: float = 20.0
                   ) -> np.ndarray:
    """Log-spaced SGWT scales t_j (coarse -> fine) in normalized frequency
    units: t_j · lam/lam_max sweeps the kernel's pass band across
    [lam_max/scale_ratio, lam_max]."""
    return np.logspace(np.log10(scale_ratio), 0.0, num_scales)


def hammond_bank(num_scales: int = 4, scale_ratio: float = 20.0
                 ) -> Dict[str, Response]:
    """Scaling function + ``num_scales`` wavelet responses; the scaling
    function covers the lam -> 0 end, where every wavelet vanishes."""
    scales = wavelet_scales(num_scales, scale_ratio)
    t_coarse = float(scales[0])

    def scaling(lam):
        return torch.exp(-(t_coarse * lam / _lmax(lam)) ** 4)

    bank: Dict[str, Response] = {"scaling": scaling}
    for j, t in enumerate(scales):
        t = float(t)
        bank[f"wavelet{j}"] = (
            lambda lam, t=t: hammond_kernel(t * lam / _lmax(lam)))
    return bank


def response_lipschitz(response: Response, lmax: float = 1.0,
                       num: int = 512) -> float:
    """Dimensionless Lipschitz constant of a response on [0, lmax]:
    ``max |dh/dlam| · lmax`` on a dense f32 grid.  It turns a basis
    approximation error into the filtering error it implies,
    ``||h(Sbar) - h(S)|| <~ Lip(h) ||Sbar - S||``."""
    lam = torch.linspace(0.0, lmax, num, dtype=torch.float32)
    h = response(lam)
    d = (torch.diff(h) / torch.diff(lam)).abs()
    return float(d.max() * lmax)


RESPONSES: Dict[str, Callable[..., Response]] = {
    "heat": heat,
    "tikhonov": tikhonov,
    "lowpass": lowpass,
    "highpass": highpass,
    "bandpass": bandpass,
}


def named_responses(spec: str) -> Dict[str, Response]:
    """Parse a serve-style bank spec: comma-separated names with an
    optional ``:param`` (e.g. ``"heat:3.0,lowpass,wavelets:4"``).

    ``wavelets[:J]`` expands to the Hammond scaling function + J wavelet
    scales; every other name maps through ``RESPONSES`` with the optional
    float as its first parameter."""
    bank: Dict[str, Response] = {}

    def add(key: str, resp: Response):
        if key in bank:
            raise ValueError(f"duplicate filter {key!r} in bank spec "
                             f"{spec!r} — each response would silently "
                             "overwrite the previous one")
        bank[key] = resp

    for item in filter(None, (s.strip() for s in spec.split(","))):
        name, _, param = item.partition(":")
        if name == "wavelets":
            for key, resp in hammond_bank(int(param) if param else 4
                                          ).items():
                add(key, resp)
            continue
        if name not in RESPONSES:
            raise ValueError(f"unknown filter {name!r}; known: "
                             f"{sorted(RESPONSES)} + 'wavelets'")
        add(item, (RESPONSES[name](float(param)) if param
                   else RESPONSES[name]()))
    return bank


def _mask_padded_gains(gains: torch.Tensor, basis) -> torch.Tensor:
    """Zero the gains at a ragged basis's padding coordinates (a response
    may map a pad slot's 0 to a nonzero gain).  The port's bases have
    ``sizes=None`` until the ragged slice, and then this is the
    identity."""
    sizes = getattr(basis, "sizes", None)
    if sizes is None:
        return gains
    n = gains.shape[-1]
    sizes = torch.as_tensor(np.asarray(sizes), device=gains.device)
    valid = torch.arange(n, device=gains.device) < sizes[..., None]
    return torch.where(valid, gains, torch.zeros_like(gains))


@dataclass(frozen=True)
class SpectralFilter:
    """One response bound to a fitted basis: y = Ubar diag(h(s)) Ubar^T x
    (Tbar diag(h(s)) Tbar^{-1} x for the general family).  The signal
    layout follows ``ApproxEigenbasis.project``."""

    basis: object               # ApproxEigenbasis
    response: Response
    name: str = "filter"

    def gains(self) -> torch.Tensor:
        """Diagonal gains h(spectrum): (n,) or (B, n)."""
        return _mask_padded_gains(self.response(self.basis.spectrum),
                                  self.basis)

    def apply(self, x, backend: Optional[str] = None) -> torch.Tensor:
        """Filter signals x (..., n) / (B, ..., n) -> same shape."""
        return self.basis.project(x, h=self.response, backend=backend)


class SpectralFilterBank:
    """F responses served through one fused dispatch per signal block.

    ``responses``: dict name -> response (order preserved) or a sequence
    of (name, response) pairs.  ``apply`` returns the filter axis FIRST
    after any matrix batch: (F, ..., n) unbatched, (B, F, ..., n) batched.
    """

    def __init__(self, basis, responses):
        if isinstance(responses, dict):
            items: Sequence[Tuple[str, Response]] = list(responses.items())
        else:
            items = list(responses)
        if not items:
            raise ValueError("empty filter bank")
        self.basis = basis
        self.names = [name for name, _ in items]
        self.filters = [SpectralFilter(basis, resp, name)
                        for name, resp in items]

    def __len__(self) -> int:
        return len(self.filters)

    def gains(self) -> torch.Tensor:
        """Stacked diagonal gains: (F, n) or (B, F, n) when batched."""
        axis = 1 if self.basis.batched else 0
        return torch.stack([f.gains() for f in self.filters], dim=axis)

    def apply(self, x, backend: Optional[str] = None,
              fused: bool = True) -> torch.Tensor:
        """Filter x through every response.

        ``fused=True`` dispatches the whole bank at once (one analysis
        shared by all F filters; on the card one bank-kernel launch).
        ``fused=False`` is the per-filter composition through
        ``project``, the semantics baseline."""
        from repro_torch.kernels.plan import ApplyPlan
        basis = self.basis
        x = as_signal(x, basis.device)
        if not fused:
            axis = 1 if basis.batched else 0
            return torch.stack([f.apply(x, backend=backend)
                                for f in self.filters], dim=axis)
        plan = ApplyPlan.for_staged(basis.fwd, mode="bank",
                                    backend=backend)
        return plan.bank(basis.fwd, basis.bwd, self.gains(), x)
