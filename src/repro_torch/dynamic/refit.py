"""Lemma-1 spectrum refits on prefix bases (the per-tier refresh).

A quality tier serves the anytime prefix of the staged tables, and its
spectrum is refit on that prefix basis: ``diag(Ubar'^T L Ubar')``.  The
prefix basis comes from one staged apply of the identity through the
apply-mode plan — on the card that is the batched G-chain CUDA kernel
over the forward tables' tail — and the diagonal is one einsum.  The
programs are cached per (batch, width, cut, device).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch


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
