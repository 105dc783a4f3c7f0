"""Entry points of the hand-written CUDA T-chain kernels (csrc/shear.cu).

Four entry points, the port of the JAX package's Pallas TPU kernels in
``repro/kernels/shear.py`` (same names, same table layout):

  ``batched_shear_apply``         y[b] = Tbar_b x[b]           t_chain_kernel
  ``shear_apply``                 the same with one table set  t_chain_kernel, B = 1
  ``batched_gen_operator_apply``  y[b] = Tbar_b diag(d_b) Tbar_b^{-1} x[b]
                                                               t_operator_kernel
  ``gen_operator_apply``          the same with one table set  t_operator_kernel, B = 1

A tensor on the CPU goes to the plain PyTorch version (kernels/ref.py);
a CUDA tensor launches the kernel or raises (kernels/launcher.py, which
also keeps the launch counters).  The operator cuts the inverse tables'
tail and the forward tables' head.  Tables whose values are
bf16 (``core/staging.py::with_precision``) launch the kernel's bf16
form, which widens each value to f32 on the card.  y has x's dtype: an
f32 signal is computed in f32, a bf16 signal in bf16 (the kernel's
bf16-signal form on either table precision, every operation rounded to
bf16 as the plain version and the JAX package's kernels round it).
Each entry point takes the tile dial ``block_b`` last: the most signal
rows one CTA holds (kernels/launcher.py; None: the launcher's own
geometry).  Every tile gives the same answer; the plain version ignores
it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.staging import StagedT
from . import launcher as _launcher
from . import ref as _ref


def batched_shear_apply(staged: StagedT, x: torch.Tensor,
                        num_stages: Optional[int] = None,
                        keep: str = "head",
                        block_b: Optional[int] = None) -> torch.Tensor:
    """y[b] = Tbar_b x[b]: tables (B, S, P), x (B, R, n) -> (B, R, n)."""
    return _launcher.chain("batched_shear_apply", _ref.batched_t_apply,
                           staged, x, num_stages, keep, block_b)


def shear_apply(staged: StagedT, x: torch.Tensor,
                num_stages: Optional[int] = None,
                keep: str = "head",
                block_b: Optional[int] = None) -> torch.Tensor:
    """y = Tbar x for rows of x (R, n) with (S, P) tables (B = 1)."""
    return _launcher.chain("shear_apply", _ref.staged_t_apply, staged, x,
                           num_stages, keep, block_b)


def batched_gen_operator_apply(fwd: StagedT, inv: StagedT,
                               diag: torch.Tensor, x: torch.Tensor,
                               num_stages: Optional[int] = None,
                               block_b: Optional[int] = None) -> torch.Tensor:
    """y[b] = Tbar_b diag(d_b) Tbar_b^{-1} x[b] in one launch: tables
    (B, S, P), diag (B, n), x (B, R, n)."""
    return _launcher.operator("batched_gen_operator_apply",
                              _ref.batched_gen_operator_apply, fwd, inv, diag,
                              x, num_stages, block_b)


def gen_operator_apply(fwd: StagedT, inv: StagedT, diag: torch.Tensor,
                       x: torch.Tensor,
                       num_stages: Optional[int] = None,
                       block_b: Optional[int] = None) -> torch.Tensor:
    """y = Tbar diag(d) Tbar^{-1} x for rows of x (R, n), tables (S, P),
    diag (n,) (B = 1)."""
    return _launcher.operator("gen_operator_apply", _ref.gen_operator_apply,
                              fwd, inv, diag, x, num_stages, block_b)
