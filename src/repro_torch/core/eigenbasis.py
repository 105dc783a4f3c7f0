"""ApproxEigenbasis: the batched facade over both factorization families.

``fit`` runs Algorithm 1 for a whole stack of B matrices at once — G
transforms for symmetric matrices (core/gtransform.py), scaling/shear T
transforms for general ones (core/ttransform.py); the B greedy chains
advance in lockstep on one device — and packs the (B, S, P) staged
tables of the chains (core/staging.py).  ``apply`` and ``project``
route through one ``ApplyPlan`` (kernels/plan.py): on a CUDA device
that is the hand-written CUDA kernels, on the CPU their plain PyTorch
versions.  Everything also works unbatched ((n, n) input).

Ragged ``sizes=`` raise ``NotImplementedError`` naming the later slice
of the port that brings them.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import gtransform as gt
from . import ttransform as tt
from .staging import (pack_g_batch_pair, pack_g_pair, pack_t_batch_pair,
                      pack_t_pair, select_cut)

SYMMETRIC = "sym"
GENERAL = "general"


def _is_symmetric(mats: torch.Tensor) -> bool:
    return bool(torch.allclose(mats, mats.transpose(-1, -2), atol=1e-6))


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"the {slice_name} slice of repro_torch")


@dataclass
class ApproxEigenbasis:
    """A fitted fast approximate eigenbasis (single matrix or a batch).

    Attributes:
      kind: "sym" (G-transforms) or "general" (T-transforms).
      n: matrix side.
      batched: True when ``factors``/``spectrum`` carry a leading batch.
      factors: GFactors / TFactors with (g,) or (B, g) tensors.
      spectrum: estimated eigenvalues, (n,) or (B, n) f32.
      fwd / bwd: staged Ubar / Ubar^T (or Tbar / Tbar^{-1}) tables,
        (S, P) or (B, S, P).
      objective: final ||M - reconstruction||_F^2, scalar or (B,).
      info: fit diagnostics (objective history, iteration counts, score).
      sizes: always None here (ragged fleets are a later slice).
    """

    kind: str
    n: int
    batched: bool
    factors: Any
    spectrum: torch.Tensor
    fwd: Any
    bwd: Any
    objective: Optional[torch.Tensor] = None
    info: Dict[str, Any] = field(default_factory=dict)
    sizes: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return self.spectrum.device

    # -- fitting -----------------------------------------------------------

    @classmethod
    def fit(cls, mats, num_transforms: int, *, kind: str = "auto",
            hint: Optional[str] = None, n_iter: int = 8, eps: float = 1e-3,
            update_spectrum: bool = True, spectrum=None,
            score: Optional[str] = None, sizes=None,
            stage_pad: Optional[tuple] = None,
            device="cuda") -> "ApproxEigenbasis":
        """Factor one matrix (n, n) or a batch (B, n, n) — Algorithm 1.

        The B greedy factorizations advance in lockstep on ``device``.
        ``kind="auto"`` resolves to "sym" for symmetric input and to
        "general" otherwise; pass ``kind="sym"``/``"general"`` to force
        a family, or ``hint`` ("sym" or "general") to keep the detection
        but be warned when it resolves against the family the caller
        expects.  ``score``/``spectrum`` as in
        ``gtransform.approximate_symmetric`` (``score`` applies to the
        symmetric family only).  ``stage_pad``: optional
        (depth_quantum, width_quantum) staged-table shape quantization
        for batched fits."""
        if sizes is not None:
            raise _later("a ragged fit (sizes=)", "ragged/masked fit")
        if isinstance(mats, (list, tuple)):
            raise _later("a ragged list of matrices", "ragged/masked fit")
        dev = torch.device(device)
        mats = torch.as_tensor(mats, dtype=torch.float32).to(dev)
        if mats.dim() not in (2, 3):
            raise ValueError(f"expected (n, n) or (B, n, n), got "
                             f"{tuple(mats.shape)}")
        batched = mats.dim() == 3
        n = mats.shape[-1]
        if mats.shape[-2] != n:
            raise ValueError(f"matrices must be square, got "
                             f"{tuple(mats.shape)}")
        if hint not in (None, SYMMETRIC, GENERAL):
            raise ValueError(f"unknown hint {hint!r}; expected "
                             f"{SYMMETRIC!r} or {GENERAL!r}")
        if kind == "auto":
            kind = SYMMETRIC if _is_symmetric(mats) else GENERAL
            if hint is not None and hint != kind:
                warnings.warn(
                    f"kind='auto' resolved to {kind!r}, overriding the "
                    f"caller hint {hint!r}; pass kind={hint!r} to force "
                    "that factorization family", stacklevel=2)
        if kind not in (SYMMETRIC, GENERAL):
            raise ValueError(f"unknown kind {kind!r}")
        if kind == GENERAL and score is not None:
            raise ValueError(
                f"score={score!r} applies to the symmetric (G-transform) "
                "family only; the general (T-transform) greedy has no "
                "score variant")
        if spectrum is not None:
            spectrum = torch.as_tensor(spectrum, dtype=torch.float32).to(dev)
            want = tuple(mats.shape[:-2]) + (n,)
            if tuple(spectrum.shape) != want:
                raise ValueError(
                    f"spectrum shape {tuple(spectrum.shape)} does not match "
                    f"the fitted batch: expected {want}")
        stack = mats if batched else mats.unsqueeze(0)
        info = {"stage_pad": stage_pad}
        if kind == SYMMETRIC:
            if score is None:
                score = "paper" if spectrum is not None else "gamma"
            sbar0 = (spectrum if spectrum is not None
                     else gt.default_sbar(mats))
            factors, sbar, obj, hist, iters = gt._approx_sym_core(
                stack, sbar0.reshape(stack.shape[:2]), num_transforms,
                n_iter, update_spectrum, eps, score)
            info["score"] = score
        else:
            cbar0 = (spectrum if spectrum is not None
                     else tt.default_cbar(mats))
            factors, sbar, obj, hist, iters = tt._approx_gen_core(
                stack, cbar0.reshape(stack.shape[:2]), num_transforms,
                n_iter, update_spectrum, eps)
        sym = kind == SYMMETRIC
        if batched:
            pack = pack_g_batch_pair if sym else pack_t_batch_pair
            fwd, bwd = pack(factors, n, pad=stage_pad, device=dev)
        else:
            factors = type(factors)(*(f[0] for f in factors))
            sbar, obj, hist, iters = sbar[0], obj[0], hist[0], iters[0]
            pack = pack_g_pair if sym else pack_t_pair
            fwd, bwd = pack(factors, n=n, device=dev)
        info.update(history=hist, iterations=iters)
        return cls(kind=kind, n=n, batched=batched, factors=factors,
                   spectrum=sbar, fwd=fwd, bwd=bwd, objective=obj,
                   info=info)

    @property
    def num_transforms(self) -> int:
        """Number of fitted fundamental components g (per matrix)."""
        return int(self.factors[0].shape[-1])

    @property
    def stage_cuts(self) -> np.ndarray:
        """(C, 2) exact (num_stages, num_components) anytime boundaries."""
        return self.fwd.cuts

    def select_tier(self, fraction: Optional[float] = None,
                    num_transforms: Optional[int] = None) -> tuple:
        """The exact stage cut nearest a component target:
        ``(num_stages, num_components)`` for ``apply``/``project``."""
        return select_cut(self.fwd, num_transforms=num_transforms,
                          fraction=fraction)

    # -- application -------------------------------------------------------

    def _plan(self, mode: str, backend: Optional[str],
              num_stages: Optional[int], precision: str,
              keep: str = "head", fused: bool = True):
        from repro_torch.kernels.plan import ApplyPlan
        return ApplyPlan(family=self.kind, mode=mode, n=self.n,
                         batched=self.batched, backend=backend,
                         num_stages=num_stages, keep=keep,
                         precision=precision, fused=fused,
                         device=str(self.device))

    def _signal(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def apply(self, x, inverse: bool = False, backend: Optional[str] = None,
              num_stages: Optional[int] = None,
              precision: str = "f32") -> torch.Tensor:
        """y = Ubar x (or Tbar x); ``inverse=True`` applies Ubar^T /
        Tbar^{-1} (graph Fourier ANALYSIS; forward is SYNTHESIS).
        ``x``: (..., n), with a leading (B, ...) batch when ``batched``.
        ``num_stages`` runs an anytime prefix (pick one with
        ``select_tier``)."""
        from repro_torch.kernels.plan import leg_orientation
        staged = self.bwd if inverse else self.fwd
        keep = leg_orientation(self.kind)[0 if inverse else 1]
        plan = self._plan("apply", backend, num_stages, precision, keep)
        return plan.apply(staged, self._signal(x))

    def project(self, x, h: Optional[Callable] = None,
                backend: Optional[str] = None,
                num_stages: Optional[int] = None, precision: str = "f32",
                fused: bool = True) -> torch.Tensor:
        """y = Ubar diag(h(spectrum)) Ubar^T x, or Tbar diag(h(spectrum))
        Tbar^{-1} x for the general family (``h`` defaults to the
        identity: the approximated matrix itself).  One fused kernel
        launch on the card; ``fused=False`` is the three-pass baseline."""
        d = self.spectrum if h is None else h(self.spectrum)
        plan = self._plan("operator", backend, num_stages, precision,
                          fused=fused)
        return plan.operator(self.fwd, self.bwd, d, self._signal(x))

    def _eye(self) -> torch.Tensor:
        eye = torch.eye(self.n, dtype=torch.float32, device=self.device)
        if self.batched:
            eye = eye.expand(self.spectrum.shape[0], self.n, self.n)
        return eye.contiguous()

    def to_dense(self, num_stages: Optional[int] = None) -> torch.Tensor:
        """Materialize Ubar (or Tbar) as (n, n) or (B, n, n)
        (``num_stages``: the anytime prefix basis)."""
        # staged apply acts on row vectors: row r of the result is
        # (basis e_r), i.e. the transpose of the basis matrix
        return self.apply(self._eye(), num_stages=num_stages).transpose(-1, -2)

    def reconstruct(self) -> torch.Tensor:
        """Dense Ubar diag(s) Ubar^T (or Tbar diag(c) Tbar^{-1}) as (n, n)
        or (B, n, n)."""
        return self.project(self._eye()).transpose(-1, -2)

    def frobenius_error(self, mats) -> torch.Tensor:
        """||M - reconstruction||_F^2 per matrix (scalar or (B,))."""
        diff = self._signal(mats) - self.reconstruct()
        return (diff * diff).sum((-2, -1))
