"""Entry points of the hand-written CUDA filter-bank kernels
(``g_bank_kernel`` in csrc/butterfly.cu, ``t_bank_kernel`` in
csrc/shear.cu).

Four entry points, the port of the JAX package's Pallas TPU kernels in
``repro/kernels/spectral.py`` (same names, same table layout):

  ``batched_sym_filter_bank_apply``  y[b, f] = Ubar_b diag(gains_bf) Ubar_b^T x[b]
                                                              g_bank_kernel
  ``sym_filter_bank_apply``          the same with one table set  g_bank_kernel, B = 1
  ``batched_gen_filter_bank_apply``  y[b, f] = Tbar_b diag(gains_bf) Tbar_b^{-1} x[b]
                                                              t_bank_kernel
  ``gen_filter_bank_apply``          the same with one table set  t_bank_kernel, B = 1

One launch runs, per CTA of r signal rows and F_g filters, the analysis
leg once, scales F_g copies of its coefficients and runs the synthesis
leg once over all F_g * r rows (kernels/launcher.py::bank_geometry
chooses r and F_g).  A tensor on the CPU goes
to the plain PyTorch version (kernels/ref.py); a CUDA tensor launches the
kernel or raises (kernels/launcher.py, which also keeps the launch
counters).  Both legs are cut as the family's operator cuts them.
Tables whose values are bf16 launch the kernel's bf16 form.  y has x's
dtype: a bf16 signal's coefficients are scaled by the gains rounded to
bf16 and every operation is rounded to bf16 (the bf16-signal form), as
the JAX package's kernels keep the coefficients in x's dtype.
Each entry point takes the tile dial ``block_b`` last: the most signal
rows one CTA holds (kernels/launcher.py; None: the launcher's own
geometry).  Every tile gives the same answer; the plain version ignores
it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.staging import StagedG, StagedT
from . import launcher as _launcher
from . import ref as _ref


def batched_sym_filter_bank_apply(fwd: StagedG, adj: StagedG,
                                  gains: torch.Tensor, x: torch.Tensor,
                                  num_stages: Optional[int] = None,
                                  block_b: Optional[int] = None
                                  ) -> torch.Tensor:
    """Per-matrix banks in one launch: tables (B, S, P), gains (B, F, n),
    x (B, R, n) -> (B, F, R, n)."""
    return _launcher.bank("batched_sym_filter_bank_apply",
                          _ref.batched_sym_filter_bank_apply, fwd, adj,
                          gains, x, num_stages, block_b)


def sym_filter_bank_apply(fwd: StagedG, adj: StagedG, gains: torch.Tensor,
                          x: torch.Tensor,
                          num_stages: Optional[int] = None,
                          block_b: Optional[int] = None) -> torch.Tensor:
    """y[f] = Ubar diag(gains_f) Ubar^T x: tables (S, P), gains (F, n),
    x (R, n) -> (F, R, n) (B = 1)."""
    return _launcher.bank("sym_filter_bank_apply",
                          _ref.sym_filter_bank_apply, fwd, adj, gains, x,
                          num_stages, block_b)


def batched_gen_filter_bank_apply(fwd: StagedT, inv: StagedT,
                                  gains: torch.Tensor, x: torch.Tensor,
                                  num_stages: Optional[int] = None,
                                  block_b: Optional[int] = None
                                  ) -> torch.Tensor:
    """Directed per-matrix banks in one launch: gains (B, F, n), x
    (B, R, n) -> (B, F, R, n)."""
    return _launcher.bank("batched_gen_filter_bank_apply",
                          _ref.batched_gen_filter_bank_apply, fwd, inv,
                          gains, x, num_stages, block_b)


def gen_filter_bank_apply(fwd: StagedT, inv: StagedT, gains: torch.Tensor,
                          x: torch.Tensor,
                          num_stages: Optional[int] = None,
                          block_b: Optional[int] = None) -> torch.Tensor:
    """y[f] = Tbar diag(gains_f) Tbar^{-1} x: tables (S, P), gains (F, n),
    x (R, n) -> (F, R, n) (B = 1)."""
    return _launcher.bank("gen_filter_bank_apply",
                          _ref.gen_filter_bank_apply, fwd, inv, gains, x,
                          num_stages, block_b)
