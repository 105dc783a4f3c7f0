"""Entry points of the hand-written CUDA G-chain kernels (csrc/butterfly.cu).

Four entry points, the port of the JAX package's Pallas TPU kernels in
``repro/kernels/butterfly.py`` (same names, same table layout):

  ``batched_butterfly_apply``     y[b] = Ubar_b x[b]          g_chain_kernel
  ``butterfly_apply``             the same with one table set  g_chain_kernel, B = 1
  ``batched_sym_operator_apply``  y[b] = Ubar_b diag(d_b) Ubar_b^T x[b]
                                                              g_operator_kernel
  ``sym_operator_apply``          the same with one table set  g_operator_kernel, B = 1

A tensor on the CPU goes to the plain PyTorch version (kernels/ref.py);
a CUDA tensor launches the kernel or raises (kernels/launcher.py, which
also keeps the launch counters).  The operator cuts the adjoint tables'
head and the forward tables' tail.  Tables whose values are
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

from repro_torch.core.staging import StagedG
from . import launcher as _launcher
from . import ref as _ref


def batched_butterfly_apply(staged: StagedG, x: torch.Tensor,
                            num_stages: Optional[int] = None,
                            keep: str = "head",
                            block_b: Optional[int] = None) -> torch.Tensor:
    """y[b] = Ubar_b x[b]: tables (B, S, P), x (B, R, n) -> (B, R, n)."""
    return _launcher.chain("batched_butterfly_apply", _ref.batched_g_apply,
                           staged, x, num_stages, keep, block_b)


def butterfly_apply(staged: StagedG, x: torch.Tensor,
                    num_stages: Optional[int] = None,
                    keep: str = "head",
                    block_b: Optional[int] = None) -> torch.Tensor:
    """y = Ubar x for rows of x (R, n) with (S, P) tables (B = 1)."""
    return _launcher.chain("butterfly_apply", _ref.staged_g_apply, staged, x,
                           num_stages, keep, block_b)


def batched_sym_operator_apply(fwd: StagedG, adj: StagedG,
                               diag: torch.Tensor, x: torch.Tensor,
                               num_stages: Optional[int] = None,
                               block_b: Optional[int] = None) -> torch.Tensor:
    """y[b] = Ubar_b diag(d_b) Ubar_b^T x[b] in one launch: tables
    (B, S, P), diag (B, n), x (B, R, n)."""
    return _launcher.operator("batched_sym_operator_apply",
                              _ref.batched_sym_operator_apply, fwd, adj, diag,
                              x, num_stages, block_b)


def sym_operator_apply(fwd: StagedG, adj: StagedG, diag: torch.Tensor,
                       x: torch.Tensor,
                       num_stages: Optional[int] = None,
                       block_b: Optional[int] = None) -> torch.Tensor:
    """y = Ubar diag(d) Ubar^T x for rows of x (R, n), tables (S, P),
    diag (n,) (B = 1)."""
    return _launcher.operator("sym_operator_apply", _ref.sym_operator_apply,
                              fwd, adj, diag, x, num_stages, block_b)
