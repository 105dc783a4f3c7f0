"""Symmetric-case factorization with extended Givens (G-) transforms.

The paper's symmetric pipeline, in plain PyTorch:
  * Theorem 1 — greedy initialization of each G-transform via the pair
    score (eq. 15-16, or Remark 1's eigenvalue-free ``gamma`` score),
  * Theorem 2 — "polishing": indices fixed, each transform's values refit
    exactly as a smooth trig maximization (grid + safeguarded Newton),
  * Lemma 1 — closed-form spectrum refit ``sbar = diag(Ubar^T S Ubar)``,
  * Algorithm 1 — init + iterate(polish, spectrum) until the absolute
    change in the squared Frobenius error falls below ``eps``.

Every solver routine works on a leading batch axis: (B, n, n) matrices
and (B, g) factor fields.  The B greedy chains advance in lockstep, one
Python loop over the g components; the single-matrix entry points run
as B = 1.  The JAX package runs these loops in XLA (no Pallas kernel),
and so they stay plain tensor code here.

Float32 matrix products run at full precision: TF32 is switched off for
CUDA matmuls and cuDNN when this module is imported.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from .types import GFactors

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_GRID_SIZE = 64
_NEWTON_ITERS = 6


def _arange(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def _long(factors):
    """Factors (GFactors or TFactors) with int64 ``i``/``j`` for
    indexing."""
    return factors._replace(i=factors.i.long(), j=factors.j.long())


def _single_to_batch(s_mat: torch.Tensor, factors):
    """(n, n) + (g,) factors (GFactors or TFactors) -> B = 1 views;
    returns (s, factors, single)."""
    if s_mat.dim() == 3:
        return s_mat, factors, False
    if factors is not None:
        factors = type(factors)(*(f.unsqueeze(0) for f in factors))
    return s_mat.unsqueeze(0), factors, True


# ---------------------------------------------------------------------------
# Application of G-transform products
# ---------------------------------------------------------------------------

def _gapply_rows(factors: GFactors, x: torch.Tensor) -> torch.Tensor:
    """Ubar applied along axis 1 of x (B, n, ...), in place."""
    ar = _arange(x)
    f = _long(factors)
    for k in range(f.i.shape[1]):
        i, j = f.i[:, k], f.j[:, k]
        shape = (-1,) + (1,) * (x.dim() - 2)
        c = f.c[:, k].to(x.dtype).view(shape)
        s = f.s[:, k].to(x.dtype).view(shape)
        sg = f.sigma[:, k].to(x.dtype).view(shape)
        xi = x[ar, i]
        xj = x[ar, j]
        x[ar, i] = c * xi + s * xj
        x[ar, j] = sg * (-s * xi + c * xj)
    return x


def _adjoint_factors(factors: GFactors) -> GFactors:
    """Ubar^T as a G-factor sequence: reverse order; rotations flip s."""
    s_adj = torch.where(factors.sigma > 0, -factors.s, factors.s)
    return GFactors(
        i=factors.i.flip(-1), j=factors.j.flip(-1), c=factors.c.flip(-1),
        s=s_adj.flip(-1), sigma=factors.sigma.flip(-1))


def gapply(factors: GFactors, x: torch.Tensor, adjoint: bool = False,
           axis: int = -1) -> torch.Tensor:
    """``Ubar @ x`` (or ``Ubar.T @ x``) along ``axis`` of x, for one
    (g,) chain."""
    if adjoint:
        factors = _adjoint_factors(factors)
    moved = torch.movedim(x, axis, 0).unsqueeze(0).clone()
    out = _gapply_rows(GFactors(*(f.unsqueeze(0) for f in factors)), moved)
    return torch.movedim(out[0], 0, axis)


def g_to_dense(factors: GFactors, n: int,
               dtype=torch.float32) -> torch.Tensor:
    """Materialize Ubar: (n, n) for a (g,) chain, (B, n, n) for (B, g)."""
    batched = factors.i.dim() == 2
    f = factors if batched else GFactors(*(t.unsqueeze(0) for t in factors))
    eye = torch.eye(n, dtype=dtype, device=f.c.device)
    u = _gapply_rows(f, eye.expand(f.i.shape[0], n, n).clone())
    return u if batched else u[0]


# ---------------------------------------------------------------------------
# Dense 2x2 row/column mixing on (B, n, n), one pair per matrix (in place)
# ---------------------------------------------------------------------------

def _mix_rows(m, i, j, w00, w01, w10, w11, ar=None):
    ar = _arange(m) if ar is None else ar
    ri = m[ar, i]
    rj = m[ar, j]
    m[ar, i] = w00[:, None] * ri + w01[:, None] * rj
    m[ar, j] = w10[:, None] * ri + w11[:, None] * rj
    return m


def _mix_cols(m, i, j, w00, w01, w10, w11, ar=None):
    ar = _arange(m) if ar is None else ar
    ci = m[ar, :, i]
    cj = m[ar, :, j]
    m[ar, :, i] = w00[:, None] * ci + w01[:, None] * cj
    m[ar, :, j] = w10[:, None] * ci + w11[:, None] * cj
    return m


def _conjugate_gt(m, i, j, c, s, sigma, ar=None):
    """m <- G^T m G for the canonical block G = [[c, s], [-sigma*s, sigma*c]]."""
    w00, w01, w10, w11 = c, -sigma * s, s, sigma * c
    m = _mix_rows(m, i, j, w00, w01, w10, w11, ar)
    return _mix_cols(m, i, j, w00, w01, w10, w11, ar)


def _conjugate_g(m, i, j, c, s, sigma, ar=None):
    """m <- G m G^T."""
    w00, w01, w10, w11 = c, s, -sigma * s, sigma * c
    m = _mix_rows(m, i, j, w00, w01, w10, w11, ar)
    return _mix_cols(m, i, j, w00, w01, w10, w11, ar)


# ---------------------------------------------------------------------------
# Theorem 1: greedy initialization
# ---------------------------------------------------------------------------

def _pair_gains_rows(diag_s, s_row, sbar, idx, score: str = "paper",
                     ar=None, valid=None):
    """Gain of pairing index ``idx`` (B,) with every other index: (B, n).

    score="paper": the exact Theorem-1 score in rearrangement-max form;
    score="gamma": Remark 1's eigenvalue-free 2 S_pq^2 drop (up to the
    factor 2).  ``valid`` ((B, n) bool, optional) marks the real
    coordinates of ragged matrices embedded in a wider bucket; pairs
    touching a padding coordinate score -inf, so the greedy never
    selects them."""
    ar = _arange(diag_s) if ar is None else ar
    if score == "gamma":
        gain = s_row * s_row
    else:
        a_i = diag_s[ar, idx][:, None]
        delta = a_i - diag_s
        r = torch.sqrt(delta * delta + 4.0 * s_row * s_row)
        tr = a_i + diag_s
        d1 = 0.5 * (tr + r)
        d2 = 0.5 * (tr - r)
        si = sbar[ar, idx][:, None]
        base = si * a_i + sbar * diag_s
        gain = torch.maximum(si * d1 + sbar * d2, si * d2 + sbar * d1) - base
    if valid is not None:
        ok = valid & valid[ar, idx][:, None]
        gain = gain.masked_fill(~ok, -math.inf)
    gain[ar, idx] = -math.inf
    return gain


def _gain_matrix(s_work, sbar, score: str = "paper", valid=None):
    """(B, n, n) pair gains with -inf on the diagonal (and, with
    ``valid``, on every pair touching a padding coordinate)."""
    n = s_work.shape[-1]
    if score == "gamma":
        gain = s_work * s_work
    else:
        a = torch.diagonal(s_work, dim1=-2, dim2=-1)
        ai, aj = a[:, :, None], a[:, None, :]
        delta = ai - aj
        r = torch.sqrt(delta * delta + 4.0 * s_work * s_work)
        d1 = 0.5 * (ai + aj + r)
        d2 = 0.5 * (ai + aj - r)
        si, sj = sbar[:, :, None], sbar[:, None, :]
        base = si * ai + sj * aj
        gain = torch.maximum(si * d1 + sj * d2, si * d2 + sj * d1) - base
    off = torch.eye(n, dtype=torch.bool, device=s_work.device)
    if valid is not None:
        off = off | ~(valid[:, :, None] & valid[:, None, :])
    return gain.masked_fill(off, -math.inf)


def _procrustes_2x2(s_ii, s_jj, s_ij, sbar_i, sbar_j):
    """Optimal G block for a pair (eigendecomposition of the 2x2 plus the
    rearrangement pairing); returns canonical (c, s, sigma)."""
    theta = 0.5 * torch.atan2(2.0 * s_ij, s_ii - s_jj)
    ct = torch.cos(theta)
    st = torch.sin(theta)
    swap = sbar_i < sbar_j
    c = torch.where(swap, -st, ct)
    s = torch.where(swap, ct, -st)
    sigma = torch.where(swap, -1.0, 1.0).to(ct.dtype)
    return c, s, sigma


def g_init(s_mat: torch.Tensor, sbar: torch.Tensor, g: int,
           score: str = "paper", valid=None
           ) -> Tuple[GFactors, torch.Tensor]:
    """Theorem-1 greedy initialization of ``g`` G-transforms.

    ``s_mat`` (n, n) or (B, n, n).  ``valid`` ((n,) or (B, n) bool)
    restricts the greedy to the real coordinates of ragged matrices
    embedded in a wider bucket: no selected pair touches a padding
    coordinate, so the chain acts as the identity there.  Returns
    factors (application order, int32 indices) and the final working
    matrix ``W = Ubar^T S Ubar``."""
    s_work, _, single = _single_to_batch(s_mat, None)
    s_work = s_work.clone()
    bsz, n = s_work.shape[0], s_work.shape[-1]
    sbar = sbar.to(s_work.dtype).reshape(bsz, n)
    if valid is not None:
        valid = valid.reshape(bsz, n)
    ar = _arange(s_work)
    gains = _gain_matrix(s_work, sbar, score, valid)
    picked = []
    for _ in range(g):
        flat = torch.argmax(gains.reshape(bsz, -1), dim=1)
        p = torch.div(flat, n, rounding_mode="floor")
        q = flat - p * n
        i = torch.minimum(p, q)
        j = torch.maximum(p, q)
        s_ii = s_work[ar, i, i]
        s_jj = s_work[ar, j, j]
        # gamma mode pairs d1 with the larger current diagonal slot;
        # paper mode pairs by the sbar rearrangement
        if score == "paper":
            ki, kj = sbar[ar, i], sbar[ar, j]
        else:
            ki, kj = s_ii, s_jj
        c, s, sigma = _procrustes_2x2(s_ii, s_jj, s_work[ar, i, j], ki, kj)
        _conjugate_gt(s_work, i, j, c, s, sigma, ar)
        # refresh the O(n) affected scores (rows/cols i and j)
        diag_s = torch.diagonal(s_work, dim1=-2, dim2=-1)
        gi = _pair_gains_rows(diag_s, s_work[ar, i], sbar, i, score, ar,
                              valid)
        gains[ar, i] = gi
        gains[ar, :, i] = gi
        gj = _pair_gains_rows(diag_s, s_work[ar, j], sbar, j, score, ar,
                              valid)
        gains[ar, j] = gj
        gains[ar, :, j] = gj
        gji = gj[ar, i]
        gains[ar, j, i] = gji
        gains[ar, i, j] = gji
        picked.append((i, j, c, s, sigma))
    # discovery t is application slot g-1-t
    fields = [torch.stack([pk[f] for pk in reversed(picked)], dim=1)
              if picked else None for f in range(5)]
    if picked:
        factors = GFactors(fields[0].to(torch.int32),
                           fields[1].to(torch.int32), *fields[2:])
    else:
        factors = _empty_factors(bsz, s_work)
    if single:
        return GFactors(*(f[0] for f in factors)), s_work[0]
    return factors, s_work


def _empty_factors(bsz: int, like: torch.Tensor) -> GFactors:
    zi = torch.zeros((bsz, 0), dtype=torch.int32, device=like.device)
    zf = torch.zeros((bsz, 0), dtype=like.dtype, device=like.device)
    return GFactors(zi, zi, zf, zf, zf)


# ---------------------------------------------------------------------------
# Theorem 2 (polish variant): refit each transform's values, indices fixed
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _grid_trig(dtype: torch.dtype, device: str):
    """(grid, stack of cos 2t, sin 2t, cos t, sin t) over the candidates."""
    grid = _theta_candidates(dtype, device)
    return grid, torch.stack([torch.cos(2 * grid), torch.sin(2 * grid),
                              torch.cos(grid), torch.sin(grid)])


def _theta_candidates(dtype, device):
    step = 2.0 * math.pi / _GRID_SIZE
    return (torch.arange(_GRID_SIZE, dtype=torch.float64) * step
            - math.pi).to(dtype=dtype, device=device)


def _trig(t: torch.Tensor) -> torch.Tensor:
    t2 = 2 * t
    return torch.stack([torch.cos(t2), torch.sin(t2), torch.cos(t),
                        torch.sin(t)])


def _maximize_trig(k1, k2, k3, k4, theta_extra):
    """Maximize h(t) = k1 cos2t + k2 sin2t + 2 k3 cos t + 2 k4 sin t
    elementwise.  Grid + safeguarded Newton; ``theta_extra`` (the
    incumbent) is a candidate too, so the refit can never regress."""
    # coefficients of (cos 2t, sin 2t, cos t, sin t) in h, h', h''
    coef = torch.stack([
        torch.stack([k1, k2, 2 * k3, 2 * k4]),
        torch.stack([2 * k2, -2 * k1, 2 * k4, -2 * k3]),
        torch.stack([-4 * k1, -4 * k2, -2 * k3, -2 * k4]),
    ])                                                    # (3, 4, ...)
    grid, gtrig = _grid_trig(k1.dtype, str(k1.device))
    hg = (coef[0].unsqueeze(-1)
          * gtrig.reshape((4,) + (1,) * k1.dim() + (-1,))).sum(0)
    t = grid[torch.argmax(hg, dim=-1)]
    hd = (coef * _trig(t)).sum(1)                         # (3, ...)
    for _ in range(_NEWTON_ITERS):
        curv = hd[2]
        step = torch.where(curv < -1e-12, hd[1] / curv,
                           torch.zeros_like(curv))
        t_new = t - step
        hd_new = (coef * _trig(t_new)).sum(1)
        better = hd_new[0] >= hd[0]
        t = torch.where(better, t_new, t)
        hd = torch.where(better, hd_new, hd)
    h_extra = (coef[0] * _trig(theta_extra)).sum(0)
    use_extra = h_extra > hd[0]
    return (torch.where(use_extra, theta_extra, t),
            torch.where(use_extra, h_extra, hd[0]))


def _polish_block(a_ii, a_jj, a_ij, b_ii, b_jj, b_ij, m11, m12, m21, m22,
                  c_old, s_old, sigma_old):
    """Exact 2x2 refit: maximize <A_PP, G B_PP G^T> + 2 <A_PR, G B_PR>.
    Both the rotation and the reflection branch of eq. (3) are solved
    (stacked on a leading axis); returns the better canonical
    (c, s, sigma)."""
    da, db = a_ii - a_jj, b_ii - b_jj
    theta_old = torch.atan2(s_old, c_old)
    zero = torch.zeros_like(theta_old)
    k1 = torch.stack([0.5 * da * db + 2.0 * a_ij * b_ij,       # rotation
                      0.5 * da * db - 2.0 * a_ij * b_ij])      # reflection
    k2 = torch.stack([da * b_ij - a_ij * db, a_ij * db + da * b_ij])
    k3 = torch.stack([m11 + m22, m11 - m22])
    k4 = torch.stack([m12 - m21, m12 + m21])
    extra = torch.stack([torch.where(sigma_old > 0, theta_old, zero),
                         torch.where(sigma_old < 0, theta_old, zero)])
    t, h = _maximize_trig(k1, k2, k3, k4, extra)
    use_rot = h[0] >= h[1]
    theta = torch.where(use_rot, t[0], t[1])
    sigma = torch.where(use_rot, 1.0, -1.0).to(theta.dtype)
    return torch.cos(theta), torch.sin(theta), sigma


def g_polish(s_mat: torch.Tensor, factors: GFactors,
             sbar: torch.Tensor) -> GFactors:
    """One Gauss-Seidel polishing sweep over all g transforms (Theorem 2
    restricted to the stored indices)."""
    s_b, f, single = _single_to_batch(s_mat, factors)
    g = f.g
    if g == 0:
        return factors
    bsz, n = s_b.shape[0], s_b.shape[-1]
    fl = _long(f)
    ar = _arange(s_b)
    sbar = sbar.to(s_b.dtype).reshape(bsz, n)
    a_mat = _conjugate_g(g_conjugated(s_b, f), fl.i[:, 0], fl.j[:, 0],
                         f.c[:, 0], f.s[:, 0], f.sigma[:, 0], ar)
    b_mat = torch.diag_embed(sbar)
    new = []
    for k in range(g):
        i, j = fl.i[:, k], fl.j[:, k]
        ai_row, aj_row = a_mat[ar, i], a_mat[ar, j]
        bi_row, bj_row = b_mat[ar, i], b_mat[ar, j]
        a_ii, a_jj, a_ij = ai_row[ar, i], aj_row[ar, j], ai_row[ar, j]
        b_ii, b_jj, b_ij = bi_row[ar, i], bj_row[ar, j], bi_row[ar, j]
        # M = A_PR B_PR^T with the {i,j} columns excluded
        m11 = (ai_row * bi_row).sum(-1) - a_ii * b_ii - a_ij * b_ij
        m12 = (ai_row * bj_row).sum(-1) - a_ii * b_ij - a_ij * b_jj
        m21 = (aj_row * bi_row).sum(-1) - a_ij * b_ii - a_jj * b_ij
        m22 = (aj_row * bj_row).sum(-1) - a_ij * b_ij - a_jj * b_jj
        c, s, sg = _polish_block(a_ii, a_jj, a_ij, b_ii, b_jj, b_ij,
                                 m11, m12, m21, m22,
                                 f.c[:, k], f.s[:, k], f.sigma[:, k])
        new.append((c, s, sg))
        # B_{k+1} = G_k B_k G_k^T (new values);
        # A_{k+1} = G_{k+1} A_k G_{k+1}^T (old values)
        _conjugate_g(b_mat, i, j, c, s, sg, ar)
        if k + 1 < g:
            _conjugate_g(a_mat, fl.i[:, k + 1], fl.j[:, k + 1],
                         f.c[:, k + 1], f.s[:, k + 1], f.sigma[:, k + 1], ar)
    out = GFactors(f.i, f.j, *(torch.stack([nw[q] for nw in new], dim=1)
                               for q in range(3)))
    return GFactors(*(t[0] for t in out)) if single else out


# ---------------------------------------------------------------------------
# Lemma 1 + objective + the Algorithm 1 loop
# ---------------------------------------------------------------------------

def g_conjugated(s_mat: torch.Tensor, factors: GFactors) -> torch.Tensor:
    """W = Ubar^T S Ubar (dense), for (n, n) or (B, n, n)."""
    s_b, f, single = _single_to_batch(s_mat, factors)
    w = s_b.clone()
    fl = _long(f)
    ar = _arange(w)
    for k in range(f.g - 1, -1, -1):
        _conjugate_gt(w, fl.i[:, k], fl.j[:, k], f.c[:, k], f.s[:, k],
                      f.sigma[:, k], ar)
    return w[0] if single else w


def lemma1_spectrum(s_mat: torch.Tensor, factors: GFactors) -> torch.Tensor:
    """sbar* = diag(Ubar^T S Ubar) — Lemma 1."""
    return torch.diagonal(g_conjugated(s_mat, factors), dim1=-2, dim2=-1)


def _sq_sum(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last two axes, one axis at a time.  A
    single reduction over the n^2 entries of each matrix lets CUDA split
    a long row over several warps when the batch is small, so its bits
    would depend on how many matrices are reduced together; two passes
    of n keep each matrix's sum order fixed, so a batch shard's fit
    (``ApproxEigenbasis.fit(mesh=)``) reports the whole batch's bits."""
    return (d * d).sum(-1).sum(-1)


def _objective_of(w: torch.Tensor, sbar: torch.Tensor) -> torch.Tensor:
    d = w - torch.diag_embed(sbar.to(w.dtype))
    return _sq_sum(d)


def g_objective(s_mat: torch.Tensor, factors: GFactors,
                sbar: torch.Tensor) -> torch.Tensor:
    """||S - Ubar diag(sbar) Ubar^T||_F^2 (== ||W - diag(sbar)||_F^2)."""
    return _objective_of(g_conjugated(s_mat, factors), sbar)


def _sym_iterate(s_mat, factors, sbar, n_iter, update_spectrum, eps):
    """Algorithm-1 refinement loop on a batch: polish + Lemma-1 sweeps
    until the objective change drops below ``eps``.  Each matrix freezes
    once its own change is below ``eps`` while the others go on (the
    per-matrix stop of the JAX package's vmapped while loop)."""
    bsz = s_mat.shape[0]
    dt, dev = s_mat.dtype, s_mat.device
    eps_t = torch.tensor(eps, dtype=dt, device=dev)
    obj = g_objective(s_mat, factors, sbar)
    obj_prev = obj + 2 * eps_t + 1.0
    hist = torch.full((bsz, n_iter + 1), math.nan, dtype=dt, device=dev)
    hist[:, 0] = obj
    it = torch.zeros(bsz, dtype=torch.int64, device=dev)
    for step in range(n_iter):
        active = torch.abs(obj_prev - obj) >= eps_t
        if not bool(active.any()):
            break
        f2 = g_polish(s_mat, factors, sbar)
        w2 = g_conjugated(s_mat, f2)
        sb2 = (torch.diagonal(w2, dim1=-2, dim2=-1) if update_spectrum
               else sbar)
        obj2 = _objective_of(w2, sb2)
        act = active[:, None]
        factors = GFactors(*(torch.where(act, new, old)
                             for new, old in zip(f2, factors)))
        sbar = torch.where(act, sb2, sbar)
        hist[:, step + 1] = torch.where(active, obj2, hist[:, step + 1])
        obj_prev = torch.where(active, obj, obj_prev)
        obj = torch.where(active, obj2, obj)
        it = it + active.to(torch.int64)
    return factors, sbar, obj, hist, it


def _valid_mask(sizes, n: int, device) -> torch.Tensor:
    """(..., n) bool mask of the real coordinates of ragged matrices of
    true sides ``sizes`` (an int, or (...,)) embedded in an n-wide
    bucket."""
    size = torch.as_tensor(sizes, device=device)
    return torch.arange(n, device=device) < size[..., None]


def _valid_coords(s_mat: torch.Tensor, size) -> Optional[torch.Tensor]:
    """(B, n) mask of the real coordinates of the (B, n, n) stack
    ``s_mat`` (``size``: its (B,) true sides, or one int for B = 1; None
    when every matrix fills the bucket)."""
    if size is None:
        return None
    return _valid_mask(size, s_mat.shape[-1], s_mat.device).reshape(
        s_mat.shape[0], -1)


def _approx_sym_core(s_mat, sbar0, g, n_iter, update_spectrum, eps, score,
                     size=None):
    """Batched Algorithm-1 body: (B, n, n) matrices, (B, n) initial
    spectra.  ``size`` ((B,) true sides, optional) masks the greedy to
    each matrix's leading coordinates: with a zero pad block every
    polish and Lemma-1 sweep then stays inside the valid block, and each
    matrix fits as its own-size fit would.  Returns (factors, sbar,
    objective, history, iterations)."""
    factors, w = g_init(s_mat, sbar0, g, score, _valid_coords(s_mat, size))
    sbar = (torch.diagonal(w, dim1=-2, dim2=-1).clone() if update_spectrum
            else sbar0.to(s_mat.dtype))
    return _sym_iterate(s_mat, factors, sbar, n_iter, update_spectrum, eps)


def _extend_sym_core(s_mat, factors0, sbar0, g_extra, n_iter,
                     update_spectrum, eps, score, size=None):
    """Warm-start extension: append ``g_extra`` Theorem-1 components
    fitted against the current residual.  The greedy continues on
    W = Ubar^T S Ubar, where a from-scratch init would stand after the
    first g components, so the new factors extend the DISCOVERY order
    and are PREPENDED in application order: Ubar_ext = Ubar0 Unew.
    ``n_iter`` > 0 re-sweeps the whole chain; ``size`` masks the
    appended greedy as in ``_approx_sym_core``."""
    w = g_conjugated(s_mat, factors0)
    new, w2 = g_init(w, sbar0, g_extra, score, _valid_coords(s_mat, size))
    factors = GFactors(*(torch.cat([nf, of.to(nf.dtype)], dim=-1)
                         for nf, of in zip(new, factors0)))
    sbar = (torch.diagonal(w2, dim1=-2, dim2=-1).clone() if update_spectrum
            else sbar0.to(s_mat.dtype))
    return _sym_iterate(s_mat, factors, sbar, n_iter, update_spectrum, eps)


def _masked_default_spectrum(diag: torch.Tensor, sizes) -> torch.Tensor:
    """diag + the deterministic tie-break for ragged matrices embedded in
    an n-wide bucket: the statistics (std) and the perturbation ramp use
    each matrix's TRUE size, so the estimate is what its own-size fit
    starts from; padding coordinates are exactly zero."""
    n = diag.shape[-1]
    size = torch.as_tensor(sizes, device=diag.device).to(diag.dtype)[..., None]
    ramp = torch.arange(n, dtype=diag.dtype, device=diag.device)
    valid = ramp < size
    zero = torch.zeros_like(diag)
    d = torch.where(valid, diag, zero)
    mean = d.sum(-1, keepdim=True) / size
    var = torch.where(valid, (d - mean) ** 2, zero).sum(-1, keepdim=True) / size
    scale = torch.clamp(torch.sqrt(var), min=1e-6)
    pert = 1e-6 * scale * ramp / size
    return torch.where(valid, d + pert, zero)


def default_sbar(s_mat: torch.Tensor, sizes=None) -> torch.Tensor:
    """Default spectrum estimate: diag(S) with a deterministic tie-break
    (population std, as ``jnp.std``).  Works on (n, n) or (..., n, n).
    ``sizes`` (scalar, or (...,) matching the batch) marks ragged
    matrices embedded in the n-wide bucket: the statistics follow each
    matrix's true size and padding coordinates get exactly zero."""
    n = s_mat.shape[-1]
    sbar = torch.diagonal(s_mat, dim1=-2, dim2=-1)
    if sizes is not None:
        return _masked_default_spectrum(sbar, sizes)
    scale = torch.clamp(torch.std(sbar, dim=-1, keepdim=True, correction=0),
                        min=1e-6)
    ramp = torch.arange(n, dtype=s_mat.dtype, device=s_mat.device)
    return sbar + 1e-6 * scale * ramp / n


def approximate_symmetric(s_mat: torch.Tensor, g: int, n_iter: int = 10,
                          sbar: Optional[torch.Tensor] = None,
                          update_spectrum: bool = True, eps: float = 1e-2,
                          score: Optional[str] = None):
    """Algorithm 1, symmetric case, one (n, n) matrix.  Returns
    (factors, sbar, info).  ``score`` defaults to "paper" when a spectrum
    estimate is supplied and "gamma" otherwise (Remark 1)."""
    if score is None:
        score = "paper" if sbar is not None else "gamma"
    if sbar is None:
        sbar = default_sbar(s_mat)
    factors, sbar, obj, hist, iters = _approx_sym_core(
        s_mat.unsqueeze(0), sbar.to(s_mat.dtype).unsqueeze(0), g, n_iter,
        update_spectrum, eps, score)
    info = {"objective": obj[0], "history": hist[0],
            "iterations": iters[0]}
    return GFactors(*(f[0] for f in factors)), sbar[0], info
