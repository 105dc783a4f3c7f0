"""Baselines the paper compares against (§5, Figures 2, 4, 5).

* ``truncated_jacobi`` — [Le Magoarou et al. 2018]: greedy Jacobi with the
  largest-|off-diagonal| pair selection, Givens rotations only, no
  eigenvalue information (Remark 1 of the paper).
* ``factorize_orthonormal`` — [Rusu & Rosasco 2019]-style greedy Givens
  factorization of an *explicitly known* orthonormal matrix (the paper's
  Figure 4 comparison, and the orthonormal half of
  ``fastlinear.compress_linear``).
* ``rank_r_*`` — truncated eigendecomposition / SVD at matched matvec
  flops (Figure 5's black curves).

The greedy loops take an (n, n) matrix, or a (B, n, n) stack whose B
chains advance in lockstep (as the port's fits do; each chain is the one
its matrix gives alone).  They run on the matrices' device with no host
sync: each step's pair (i, j) stays a (B,) index tensor on the device (a
per-matrix argmax, then advanced indexing and the batched row/column
mixing of ``gtransform._conjugate_gt``), so a loop of g steps only
enqueues work.  ``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .gtransform import _conjugate_gt
from .types import GFactors


def _batched(mat: torch.Tensor):
    """(B, n, n) working copy of an (n, n) or (B, n, n) input, whether it
    was single, and the batch index."""
    single = mat.dim() == 2
    work = (mat.unsqueeze(0) if single else mat).clone()
    return work, single, torch.arange(work.shape[0], device=mat.device)


def _pair(scores: torch.Tensor):
    """(i, j), i < j, (B,) int64 each: the first argmax of each matrix's
    (n, n) score."""
    n = scores.shape[-1]
    flat = scores.reshape(scores.shape[0], -1).argmax(-1)
    p, q = flat // n, flat % n
    return torch.minimum(p, q), torch.maximum(p, q)


def _chain(steps, single: bool) -> GFactors:
    """GFactors from the per-step (i, j, c, s, sigma), each (B,), in
    discovery order: step t goes to slot g-1-t (application order)."""
    i, j, c, s, sigma = (torch.stack(f, -1).flip(-1) for f in zip(*steps))
    out = GFactors(i.to(torch.int32), j.to(torch.int32), c, s, sigma)
    return GFactors(*(f[0] for f in out)) if single else out


# ---------------------------------------------------------------------------
# Truncated Jacobi [Le Magoarou et al. 2018]
# ---------------------------------------------------------------------------

def truncated_jacobi(s_mat: torch.Tensor, g: int
                     ) -> Tuple[GFactors, torch.Tensor]:
    """Greedy Jacobi truncated at g rotations on a symmetric (n, n)
    matrix, or on each of a (B, n, n) stack. Returns (factors,
    spectrum): the spectrum is the diagonal of the working matrix
    Ubar^T S Ubar."""
    work, single, ar = _batched(s_mat)
    n = work.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=work.device)
    neg_inf = torch.full((), -torch.inf, dtype=work.dtype,
                         device=work.device)
    one = torch.ones_like(ar, dtype=work.dtype)
    steps = []
    for _ in range(g):
        i, j = _pair(torch.where(eye, neg_inf, work.abs()))
        theta = 0.5 * torch.atan2(2.0 * work[ar, i, j],
                                  work[ar, i, i] - work[ar, j, j])
        c = torch.cos(theta)
        s = -torch.sin(theta)    # (c, s, +1) encodes V with V^T S V diag
        work = _conjugate_gt(work, i, j, c, s, one, ar)
        steps.append((i, j, c, s, one))
    spectrum = torch.diagonal(work, dim1=-2, dim2=-1).clone()
    return _chain(steps, single), spectrum[0] if single else spectrum


# ---------------------------------------------------------------------------
# Greedy Givens factorization of a known orthonormal matrix
# [Rusu & Rosasco 2019 / Shalit & Chechik 2014 family]
# ---------------------------------------------------------------------------

def _polar_gains_full(w: torch.Tensor) -> torch.Tensor:
    """gain_pq of appending the optimal G at pair (p, q) of each (n, n)
    matrix of w (B, n, n):
    max orthogonal-G tr(G^T W_block) - current trace = (sigma1+sigma2) - tr;
    -inf on the diagonal."""
    d = torch.diagonal(w, dim1=-2, dim2=-1)
    wt = w.transpose(-1, -2)
    tr2 = d[..., :, None] + d[..., None, :]
    hr = torch.sqrt(tr2 ** 2 + (w - wt) ** 2)            # rotation branch
    hf = torch.sqrt((d[..., :, None] - d[..., None, :]) ** 2 + (w + wt) ** 2)
    gain = torch.maximum(hr, hf) - tr2
    eye = torch.eye(w.shape[-1], dtype=torch.bool, device=w.device)
    return gain.masked_fill(eye, -torch.inf)


def factorize_orthonormal(u_mat: torch.Tensor, g: int) -> GFactors:
    """Greedily factor a known orthonormal (n, n) U, or each of a
    (B, n, n) stack, into g extended Givens transforms minimizing
    ||U - Ubar||_F (via trace maximization)."""
    w, single, ar = _batched(u_mat)
    steps = []
    for _ in range(g):
        i, j = _pair(_polar_gains_full(w))
        m11, m12 = w[ar, i, i], w[ar, i, j]
        m21, m22 = w[ar, j, i], w[ar, j, j]
        hr = torch.sqrt((m11 + m22) ** 2 + (m12 - m21) ** 2)
        hf = torch.sqrt((m11 - m22) ** 2 + (m12 + m21) ** 2)
        use_rot = hr >= hf
        phi_r = torch.atan2(m12 - m21, m11 + m22)
        phi_f = torch.atan2(m12 + m21, m11 - m22)
        c = torch.where(use_rot, torch.cos(phi_r), torch.cos(phi_f))
        s = torch.where(use_rot, torch.sin(phi_r), torch.sin(phi_f))
        sg = torch.where(use_rot, 1.0, -1.0).to(w.dtype)
        # W <- G^T W (rows i, j by G^T = [[c, -sg*s], [s, sg*c]])
        ri, rj = w[ar, i], w[ar, j]
        w[ar, i] = c[:, None] * ri - (sg * s)[:, None] * rj
        w[ar, j] = s[:, None] * ri + (sg * c)[:, None] * rj
        # the factor goes on the *inner* side (Ubar_new = Ubar_old @ G):
        # discovery order is outermost-first, slot g-1-t
        steps.append((i, j, c, s, sg))
    return _chain(steps, single)


# ---------------------------------------------------------------------------
# Rank-r baselines (Figure 5's black curves)
# ---------------------------------------------------------------------------

def rank_r_symmetric(s_mat: torch.Tensor, r: int):
    """Best rank-r symmetric approx; returns (approx, flops_per_matvec).
    The r eigenpairs of largest |lambda| (ties in the eigenvalue order,
    as ``jnp.argsort``'s stable sort keeps them)."""
    vals, vecs = torch.linalg.eigh(s_mat)
    keep = torch.argsort(-vals.abs(), stable=True)[:r]
    v = vecs[:, keep]
    approx = (v * vals[keep][None, :]) @ v.T
    return approx, 2 * 2 * r * s_mat.shape[0]


def rank_r_general(c_mat: torch.Tensor, r: int):
    """Best rank-r approx by the truncated SVD; returns (approx,
    flops_per_matvec)."""
    u, sv, vt = torch.linalg.svd(c_mat, full_matrices=False)
    approx = (u[:, :r] * sv[:r][None, :]) @ vt[:r]
    return approx, 2 * 2 * r * c_mat.shape[0]
