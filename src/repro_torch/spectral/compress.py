"""Top-k spectral coefficient compression through the fast transform.

Transform a signal, keep only its k largest-magnitude spectral
coefficients, and reconstruct: one top-k over every (graph, signal) row
at once, analysis and synthesis through ``ApproxEigenbasis.apply`` (on
the card the chain kernels).

For the symmetric (G-transform) family Ubar is exactly orthonormal, so
Parseval holds in the approximate basis: ``||x - recon||^2`` equals the
dropped coefficients' energy, and the retained energy fraction is the
compression-quality dial.  For the general family the identity holds up
to Tbar's conditioning.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.types import as_signal


def topk_coefficients(coeff: torch.Tensor, k: int) -> torch.Tensor:
    """Zero all but the k largest-|.| entries along the last axis.

    Exactly k entries survive per row; magnitude ties go to the lower
    index, as ``lax.top_k`` breaks them (a stable descending sort:
    ``torch.topk`` leaves the order of ties unspecified)."""
    n = coeff.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if k == n:
        return coeff
    idx = torch.sort(coeff.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    mask = torch.zeros_like(coeff).scatter_(-1, idx, 1.0)
    return coeff * mask


@dataclass(frozen=True)
class Compressed:
    """A top-k compressed signal batch.

    ``coeff``: full spectral coefficients (same shape as the input
    signals); ``kept``: the k-sparse coefficients; ``recon``: the
    synthesis of ``kept`` back to the vertex domain; ``k``: kept count."""

    coeff: torch.Tensor
    kept: torch.Tensor
    recon: torch.Tensor
    k: int

    @property
    def retained_energy(self) -> torch.Tensor:
        """Kept / total coefficient energy per signal row, in [0, 1].
        All-zero rows have no energy to lose and report 1.0."""
        total = (self.coeff * self.coeff).sum(-1)
        kept = (self.kept * self.kept).sum(-1)
        return torch.where(total > 0, kept / total.clamp(min=1e-30),
                           torch.ones_like(total))


def compress(basis, x, k: int, backend: Optional[str] = None) -> Compressed:
    """Analysis -> keep top-k -> synthesis, batched end to end.

    ``basis``: a fitted ApproxEigenbasis (single or batched); ``x``:
    signals (..., n) / (B, ..., n) as in ``basis.apply``."""
    coeff = basis.apply(x, inverse=True, backend=backend)
    kept = topk_coefficients(coeff, k)
    recon = basis.apply(kept, backend=backend)
    return Compressed(coeff=coeff, kept=kept, recon=recon, k=k)


def compression_error(basis, x, k: int,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Relative reconstruction error ||x - recon|| / ||x|| per row."""
    x = as_signal(x, basis.device)
    recon = compress(basis, x, k, backend=backend).recon
    num = torch.linalg.norm(x - recon, dim=-1)
    return num / torch.linalg.norm(x, dim=-1).clamp(min=1e-30)
