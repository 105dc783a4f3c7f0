"""Plain PyTorch versions of the staged G- and T-chain kernels and of
the filter banks built on them.

These are the semantics of record inside the port: chip_smoke.py and
tests/test_torch_cuda.py hold each CUDA kernel to them on the card, and
the tests hold them to the JAX package's ``repro.kernels.ref`` on the
CPU.  They also serve every CPU tensor (kernels/launcher.py dispatches
by device).

Padding entries carry the out-of-bounds index ``n``.  The JAX reference
clips such reads and drops such writes; torch has neither, so the signal
gets one zero dummy column ``n`` exactly as the fused kernels do: a pad
entry (c=1, s=0, sigma=1 for G; alpha=1, beta=0 for T) reads and
rewrites the dummy column with its own value, a structural no-op, and
the dummy is cropped at the end.  The operators pad the spectrum with
1.0 at the dummy column.

Every function takes ``num_stages`` (None = the full chain, else an
anytime cut applied to the tables before the walk); plain applies also
take ``keep`` ("head"/"tail"), while the operators know their own
orientation (core/staging.py): the G operator cuts the adjoint head and
the forward tail, the T operator the inverse tail and the forward head.
The banks cut both legs as their family's operator does.

Every function computes in the signal's dtype, as the JAX package's
kernels do: the table values, the spectrum and the gains are cast to it
(``.to(x.dtype)``), and on a bf16 signal each torch op rounds its
product or sum to bf16 (RNE).  On a bf16 signal these are bitwise equal
to the JAX package's Pallas kernels in interpret mode, and the CUDA
kernels' bf16-signal forms are held to them bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.staging import (StagedG, StagedT, table_arrays,
                                      truncate_staged)


def _walk(tables, xp: torch.Tensor) -> torch.Tensor:
    """Apply (B, S, P) stage tables in order to ``xp`` (B, M, n+1), in
    place; pads touch only the dummy column."""
    ii, jj, cc, ss, sg = tables
    bsz, m, _ = xp.shape
    for st in range(ii.shape[1]):
        i = ii[:, st].long().unsqueeze(1).expand(bsz, m, -1)
        j = jj[:, st].long().unsqueeze(1).expand(bsz, m, -1)
        c = cc[:, st].to(xp.dtype).unsqueeze(1)
        s = ss[:, st].to(xp.dtype).unsqueeze(1)
        g = sg[:, st].to(xp.dtype).unsqueeze(1)
        xi = torch.gather(xp, 2, i)
        xj = torch.gather(xp, 2, j)
        xp.scatter_(2, i, c * xi + s * xj)
        xp.scatter_(2, j, g * (-s * xi + c * xj))
    return xp


def _walk_t(tables, xp: torch.Tensor) -> torch.Tensor:
    """Apply (B, S, P) T stage tables in order to ``xp`` (B, M, n+1), in
    place: y_i = alpha x_i + beta x_j, only i written.  Within a stage no
    entry writes a coordinate another entry reads (the packer's touch
    sets), so every read happens before the stage's writes."""
    ii, jj, al, be = tables
    bsz, m, _ = xp.shape
    for st in range(ii.shape[1]):
        i = ii[:, st].long().unsqueeze(1).expand(bsz, m, -1)
        j = jj[:, st].long().unsqueeze(1).expand(bsz, m, -1)
        a = al[:, st].to(xp.dtype).unsqueeze(1)
        b = be[:, st].to(xp.dtype).unsqueeze(1)
        xi = torch.gather(xp, 2, i)
        xj = torch.gather(xp, 2, j)
        xp.scatter_(2, i, a * xi + b * xj)
    return xp


def _pad_dummy(x: torch.Tensor, bsz: int, n: int) -> torch.Tensor:
    """(B, ..., n) -> fresh (B, M, n+1) with a zero dummy column."""
    x3 = x.reshape(bsz, -1, n)
    xp = x3.new_zeros(x3.shape[:2] + (n + 1,))
    xp[..., :n] = x3
    return xp


def _single_tables(staged):
    return tuple(t.unsqueeze(0) for t in table_arrays(staged))


def batched_g_apply(staged: StagedG, x: torch.Tensor,
                    num_stages: Optional[int] = None,
                    keep: str = "head") -> torch.Tensor:
    """Per-matrix Ubar_b x_b: tables (B, S, P), x (B, ..., n)."""
    staged = truncate_staged(staged, num_stages, keep)
    n = x.shape[-1]
    xp = _walk(table_arrays(staged), _pad_dummy(x, x.shape[0], n))
    return xp[..., :n].reshape(x.shape)


def staged_g_apply(staged: StagedG, x: torch.Tensor,
                   num_stages: Optional[int] = None,
                   keep: str = "head") -> torch.Tensor:
    """Ubar x for x (..., n) with (S, P) tables."""
    staged = truncate_staged(staged, num_stages, keep)
    n = x.shape[-1]
    xp = _walk(_single_tables(staged), _pad_dummy(x, 1, n))
    return xp[..., :n].reshape(x.shape)


def batched_sym_operator_apply(fwd: StagedG, adj: StagedG,
                               diag: torch.Tensor, x: torch.Tensor,
                               num_stages: Optional[int] = None
                               ) -> torch.Tensor:
    """y_b = Ubar_b diag(d_b) Ubar_b^T x_b: diag (B, n), x (B, ..., n)."""
    adj = truncate_staged(adj, num_stages, "head")
    fwd = truncate_staged(fwd, num_stages, "tail")
    bsz, n = x.shape[0], x.shape[-1]
    xp = _walk(table_arrays(adj), _pad_dummy(x, bsz, n))
    dp = torch.ones((bsz, n + 1), dtype=xp.dtype, device=xp.device)
    dp[:, :n] = diag.reshape(bsz, n)
    xp = _walk(table_arrays(fwd), xp * dp.unsqueeze(1))
    return xp[..., :n].reshape(x.shape)


def sym_operator_apply(fwd: StagedG, adj: StagedG, diag: torch.Tensor,
                       x: torch.Tensor,
                       num_stages: Optional[int] = None) -> torch.Tensor:
    """Sbar x = Ubar diag(sbar) Ubar^T x for x (..., n), tables (S, P)."""
    adj = truncate_staged(adj, num_stages, "head")
    fwd = truncate_staged(fwd, num_stages, "tail")
    n = x.shape[-1]
    xp = _walk(_single_tables(adj), _pad_dummy(x, 1, n))
    dp = torch.ones((n + 1,), dtype=xp.dtype, device=xp.device)
    dp[:n] = diag
    xp = _walk(_single_tables(fwd), xp * dp)
    return xp[..., :n].reshape(x.shape)


# ---------------------------------------------------------------------------
# T family (scaling / shear chains)
# ---------------------------------------------------------------------------

def batched_t_apply(staged: StagedT, x: torch.Tensor,
                    num_stages: Optional[int] = None,
                    keep: str = "head") -> torch.Tensor:
    """Per-matrix Tbar_b x_b: tables (B, S, P), x (B, ..., n)."""
    staged = truncate_staged(staged, num_stages, keep)
    n = x.shape[-1]
    xp = _walk_t(table_arrays(staged), _pad_dummy(x, x.shape[0], n))
    return xp[..., :n].reshape(x.shape)


def staged_t_apply(staged: StagedT, x: torch.Tensor,
                   num_stages: Optional[int] = None,
                   keep: str = "head") -> torch.Tensor:
    """Tbar x for x (..., n) with (S, P) tables."""
    staged = truncate_staged(staged, num_stages, keep)
    n = x.shape[-1]
    xp = _walk_t(_single_tables(staged), _pad_dummy(x, 1, n))
    return xp[..., :n].reshape(x.shape)


def batched_gen_operator_apply(fwd: StagedT, inv: StagedT,
                               diag: torch.Tensor, x: torch.Tensor,
                               num_stages: Optional[int] = None
                               ) -> torch.Tensor:
    """y_b = Tbar_b diag(d_b) Tbar_b^{-1} x_b: diag (B, n), x (B, ..., n).
    ``num_stages`` cuts the inverse tables' tail and the forward head."""
    inv = truncate_staged(inv, num_stages, "tail")
    fwd = truncate_staged(fwd, num_stages, "head")
    bsz, n = x.shape[0], x.shape[-1]
    xp = _walk_t(table_arrays(inv), _pad_dummy(x, bsz, n))
    dp = torch.ones((bsz, n + 1), dtype=xp.dtype, device=xp.device)
    dp[:, :n] = diag.reshape(bsz, n)
    xp = _walk_t(table_arrays(fwd), xp * dp.unsqueeze(1))
    return xp[..., :n].reshape(x.shape)


def gen_operator_apply(fwd: StagedT, inv: StagedT, diag: torch.Tensor,
                       x: torch.Tensor,
                       num_stages: Optional[int] = None) -> torch.Tensor:
    """Cbar x = Tbar diag(cbar) Tbar^{-1} x for x (..., n), tables (S, P)
    (the directed FGFT projection)."""
    inv = truncate_staged(inv, num_stages, "tail")
    fwd = truncate_staged(fwd, num_stages, "head")
    n = x.shape[-1]
    xp = _walk_t(_single_tables(inv), _pad_dummy(x, 1, n))
    dp = torch.ones((n + 1,), dtype=xp.dtype, device=xp.device)
    dp[:n] = diag
    xp = _walk_t(_single_tables(fwd), xp * dp)
    return xp[..., :n].reshape(x.shape)


# ---------------------------------------------------------------------------
# filter banks: F filters share ONE analysis walk
# ---------------------------------------------------------------------------

def check_gains(gains: torch.Tensor, x: torch.Tensor, batched: bool,
                what: str) -> int:
    """Validate a bank's gains against the signal x ((B, ..., n) batched,
    (..., n) else): (B, F, n) or (F, n) with F >= 1.  Returns F."""
    n = x.shape[-1]
    want = "(B, F, n)" if batched else "(F, n)"
    if gains.dim() != (3 if batched else 2) or gains.shape[-1] != n or (
            batched and gains.shape[0] != x.shape[0]):
        raise ValueError(f"{what}: gains shape {tuple(gains.shape)} is not "
                         f"{want} for a signal of shape {tuple(x.shape)}")
    if gains.shape[-2] < 1:
        raise ValueError(f"{what}: a bank needs at least one filter, got "
                         f"gains of shape {tuple(gains.shape)}")
    return gains.shape[-2]


def _bank(walk, first, second, gains: torch.Tensor, x: torch.Tensor,
          bsz: int) -> torch.Tensor:
    """second diag(gains_f) first x for every filter f, with the filters
    folded into the row axis: the analysis output (B, M, n+1) is scaled
    into (B, F*M, n+1) by a plain multiply and synthesized in one walk.
    ``first``/``second`` are (B, S, P) table tuples, ``gains`` reshapes
    to (B, F, n).  Returns (B, F, M, n)."""
    n = x.shape[-1]
    xp = walk(first, _pad_dummy(x, bsz, n))
    m = xp.shape[1]
    f = gains.shape[-2]
    gp = torch.ones((bsz, f, 1, n + 1), dtype=xp.dtype, device=xp.device)
    gp[..., 0, :n] = gains.reshape(bsz, f, n)
    yp = walk(second, (xp.unsqueeze(1) * gp).reshape(bsz, f * m, n + 1))
    return yp[..., :n].reshape(bsz, f, m, n)


def sym_filter_bank_apply(fwd: StagedG, adj: StagedG, gains: torch.Tensor,
                          x: torch.Tensor,
                          num_stages: Optional[int] = None) -> torch.Tensor:
    """y[f] = Ubar diag(gains_f) Ubar^T x: gains (F, n), x (..., n) ->
    (F, ..., n); the analysis runs once for all F filters."""
    check_gains(gains, x, False, "sym_filter_bank_apply")
    adj = truncate_staged(adj, num_stages, "head")
    fwd = truncate_staged(fwd, num_stages, "tail")
    y = _bank(_walk, _single_tables(adj), _single_tables(fwd), gains, x, 1)
    return y.reshape(gains.shape[:1] + x.shape)


def gen_filter_bank_apply(fwd: StagedT, inv: StagedT, gains: torch.Tensor,
                          x: torch.Tensor,
                          num_stages: Optional[int] = None) -> torch.Tensor:
    """y[f] = Tbar diag(gains_f) Tbar^{-1} x: the directed bank."""
    check_gains(gains, x, False, "gen_filter_bank_apply")
    inv = truncate_staged(inv, num_stages, "tail")
    fwd = truncate_staged(fwd, num_stages, "head")
    y = _bank(_walk_t, _single_tables(inv), _single_tables(fwd), gains, x,
              1)
    return y.reshape(gains.shape[:1] + x.shape)


def batched_sym_filter_bank_apply(fwd: StagedG, adj: StagedG,
                                  gains: torch.Tensor, x: torch.Tensor,
                                  num_stages: Optional[int] = None
                                  ) -> torch.Tensor:
    """Per-matrix banks: tables (B, S, P), gains (B, F, n), x (B, ..., n)
    -> (B, F, ..., n)."""
    check_gains(gains, x, True, "batched_sym_filter_bank_apply")
    adj = truncate_staged(adj, num_stages, "head")
    fwd = truncate_staged(fwd, num_stages, "tail")
    y = _bank(_walk, table_arrays(adj), table_arrays(fwd), gains, x,
              x.shape[0])
    return y.reshape(gains.shape[:2] + x.shape[1:])


def batched_gen_filter_bank_apply(fwd: StagedT, inv: StagedT,
                                  gains: torch.Tensor, x: torch.Tensor,
                                  num_stages: Optional[int] = None
                                  ) -> torch.Tensor:
    """Directed per-matrix banks: gains (B, F, n), x (B, ..., n)."""
    check_gains(gains, x, True, "batched_gen_filter_bank_apply")
    inv = truncate_staged(inv, num_stages, "tail")
    fwd = truncate_staged(fwd, num_stages, "head")
    y = _bank(_walk_t, table_arrays(inv), table_arrays(fwd), gains, x,
              x.shape[0])
    return y.reshape(gains.shape[:2] + x.shape[1:])
