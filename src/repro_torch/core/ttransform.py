"""General (non-symmetric) case: scaling + shear T-transform factorization.

The paper's non-symmetric pipeline, in plain PyTorch:
  * Theorem 3 — greedy initialization.  For every ordered pair (i, j)
    the shear cost ``||C - T B T^{-1}||_F^2`` is an exact quartic in the
    shear parameter ``a``, so the O(n^2) score sweep is elementwise with
    closed-form cubic root finding; the n scaling costs are quartics in
    ``a`` divided by ``a^2``, fit exactly through 5 samples and
    minimized at the real roots of their stationary quartic.
  * Theorem 4 (polish variant) — per-transform value refit with indices
    fixed, O(n^2) per transform via rank-2 residual algebra.
  * Lemma 2 — spectrum refit by the minimum-norm least-squares solve of
    the (n^2 x n) Khatri-Rao system (ridge normal equations above
    n = 256).
  * Algorithm 1 — init + iterate(polish, Lemma 2) until the absolute
    change of the squared Frobenius error falls below ``eps``.

Every solver routine works on a leading batch axis: (B, n, n) matrices
and (B, m) factor fields.  The B greedy chains advance in lockstep, one
Python loop over the m components; the single-matrix entry points run
as B = 1.  Where the JAX package branches on a transform's kind
(``lax.cond``), the B matrices may hold different kinds at the same
index, so both branches are computed and selected with ``torch.where``.
The JAX package runs these loops in XLA (no Pallas kernel), and so they
stay plain tensor code here.

Float32 matrix products run at full precision: TF32 is switched off for
CUDA matmuls and cuDNN when this module is imported.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import gtransform as gt
from .gtransform import _arange, _long, _single_to_batch
from .polyutil import (device_constant, fit_quartic, minimize_quartic,
                       quartic_points, real_cubic_roots)
from .types import SCALE, SHEAR, TFactors

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# |a| in [1/32, 32] keeps every factor well-conditioned (huge shears or
# scales make kappa(Tbar) explode and overflow the f32 state); the greedy
# just spends more factors.
_A_CLIP = 32.0
_A_MIN_SCALE = 1.0 / 32.0
# the greedy's score state is rebuilt from B every this many steps: f32
# drift across hundreds of rank-2 updates otherwise stalls the greedy
_REFRESH_EVERY = 8
# Lemma 2 materializes the Khatri-Rao matrix up to this n
_LSTSQ_MAX_N = 256
_SCALE_POLISH_GRID = (0.25, 0.5, 0.8, 0.9, 1.0, 1.1, 1.25, 2.0, 4.0)
_ROOTS_OF_UNITY = tuple(complex(math.cos(2 * math.pi * k / 3),
                                math.sin(2 * math.pi * k / 3))
                        for k in range(3))


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) against ``like``."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------------------
# Application of T-transform products
# ---------------------------------------------------------------------------

def _tapply_rows(factors: TFactors, x: torch.Tensor,
                 inverse: bool) -> torch.Tensor:
    """Tbar (or Tbar^{-1}) applied along axis 1 of x (B, n, ...), in
    place.  A scaling sets x_i = a x_i, a shear x_i = x_i + a x_j; the
    inverse walks the chain backwards with 1/a and -a."""
    ar = _arange(x)
    f = _long(factors)
    order = range(f.i.shape[1] - 1, -1, -1) if inverse else range(
        f.i.shape[1])
    for k in order:
        i, j = f.i[:, k], f.j[:, k]
        sc = _bcast(f.kind[:, k] == SCALE, x[:, 0])
        a = f.a[:, k].to(x.dtype)
        if inverse:
            a = torch.where(f.kind[:, k] == SCALE, 1.0 / a, -a)
        a = _bcast(a, x[:, 0])
        xi = x[ar, i]
        xj = x[ar, j]
        x[ar, i] = torch.where(sc, a * xi, xi + a * xj)
    return x


def tapply(factors: TFactors, x: torch.Tensor, inverse: bool = False,
           axis: int = -1) -> torch.Tensor:
    """``Tbar @ x`` (or ``Tbar^{-1} @ x``) along ``axis`` of x, for one
    (m,) chain."""
    moved = torch.movedim(x, axis, 0).unsqueeze(0).clone()
    out = _tapply_rows(TFactors(*(f.unsqueeze(0) for f in factors)), moved,
                       inverse)
    return torch.movedim(out[0], 0, axis)


def t_to_dense(factors: TFactors, n: int, inverse: bool = False,
               dtype=torch.float32) -> torch.Tensor:
    """Materialize Tbar (or Tbar^{-1}): (n, n) for a (m,) chain,
    (B, n, n) for (B, m)."""
    batched = factors.i.dim() == 2
    f = factors if batched else TFactors(*(t.unsqueeze(0) for t in factors))
    eye = torch.eye(n, dtype=dtype, device=f.a.device)
    out = _tapply_rows(f, eye.expand(f.i.shape[0], n, n).clone(), inverse)
    return out if batched else out[0]


def _left_mul(m, kind, i, j, a, ar):
    """m <- T m (row op on row i), batched, in place."""
    sc = (kind == SCALE)[:, None]
    ri = m[ar, i]
    rj = m[ar, j]
    a = a[:, None]
    m[ar, i] = torch.where(sc, ri * a, ri + a * rj)
    return m


def _right_mul_inv(m, kind, i, j, a, ar):
    """m <- m T^{-1} (column op), batched, in place: a scaling divides
    column i by a; a shear subtracts a * column i from column j.  (A
    scaling has j == i, so the written column is j for both kinds.)"""
    sc = (kind == SCALE)[:, None]
    ci = m[ar, :, i]
    cj = m[ar, :, j]
    a = a[:, None]
    m[ar, :, j] = torch.where(sc, ci * (1.0 / a), cj + (-a) * ci)
    return m


def _conjugate_inplace(m, kind, i, j, a, ar=None):
    """m <- T m T^{-1} by exact sequential row/column ops (O(n))."""
    ar = _arange(m) if ar is None else ar
    a = a.to(m.dtype)
    _left_mul(m, kind, i, j, a, ar)
    return _right_mul_inv(m, kind, i, j, a, ar)


def t_reconstruct(factors: TFactors, cbar: torch.Tensor) -> torch.Tensor:
    """Dense ``Tbar diag(cbar) Tbar^{-1}``: (n, n) or (B, n, n)."""
    batched = factors.i.dim() == 2
    f = factors if batched else TFactors(*(t.unsqueeze(0) for t in factors))
    m = torch.diag_embed(cbar.reshape(f.i.shape[0], -1)).clone()
    fl = _long(f)
    ar = _arange(m)
    for k in range(f.i.shape[1]):
        _conjugate_inplace(m, fl.kind[:, k], fl.i[:, k], fl.j[:, k],
                           fl.a[:, k], ar)
    return m if batched else m[0]


def t_objective(c_mat: torch.Tensor, factors: TFactors,
                cbar: torch.Tensor) -> torch.Tensor:
    """||C - Tbar diag(cbar) Tbar^{-1}||_F^2, scalar or (B,)."""
    d = c_mat - t_reconstruct(factors, cbar.to(c_mat.dtype))
    return gt._sq_sum(d)


def _t_objectives(c_mat, factors: TFactors, cbars) -> torch.Tensor:
    """``t_objective`` of (B, n, n) stacks for several (B, n) spectra at
    once, (K, B): one walk over the chain for all K (the walk issues a
    few small ops per factor, so its cost is the factor count)."""
    k = len(cbars)
    stacked = TFactors(*(f.repeat(k, 1) for f in factors))
    obj = t_objective(c_mat.repeat(k, 1, 1), stacked, torch.cat(cbars))
    return obj.reshape(k, -1)


# ---------------------------------------------------------------------------
# Theorem 3: greedy initialization
# ---------------------------------------------------------------------------
# State: B (current T..T diag(cbar) T^{-1}..T^{-1}), E = C - B,
# V = E B^T, H = E^T B, N = row norms^2 of B, M = col norms^2 of B.

def _shear_scores(b_mat, e_mat, v_mat, h_mat, nrow, mcol):
    """Best shear parameter and score at every ordered pair (i, j) of
    (B, n, n) states: F(a) - ||E||^2 = c1 a + c2 a^2 + c3 a^3 + c4 a^4
    with c1 = -2 (V_ij - H_ji), c2 = N_j + M_i - 2 B_ii B_jj + 2 B_ji E_ij,
    c3 = 2 B_ji (B_ii - B_jj), c4 = B_ji^2.  The diagonal scores +inf."""
    db = torch.diagonal(b_mat, dim1=-2, dim2=-1)
    bt = b_mat.transpose(-1, -2)
    c1 = -2.0 * (v_mat - h_mat.transpose(-1, -2))
    c2 = (nrow[:, None, :] + mcol[:, :, None]
          - 2.0 * db[:, :, None] * db[:, None, :] + 2.0 * bt * e_mat)
    c3 = 2.0 * bt * (db[:, :, None] - db[:, None, :])
    c4 = bt * bt
    a_star, val = minimize_quartic(c1, c2, c3, c4, clip=_A_CLIP)
    n = b_mat.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=b_mat.device)
    return a_star, val.masked_fill(eye, math.inf)


def _scale_phi(a, rho, eps_d, nv, mv, v0, h0):
    """phi_i(a) = F(a) - ||E||^2 for the scaling transform at index i."""
    alpha = a - 1.0
    beta = (1.0 - a) / a
    return (-2.0 * alpha * v0 - 2.0 * beta * h0
            - 2.0 * alpha * beta * rho * eps_d
            + alpha * alpha * nv + beta * beta * mv
            + (alpha * beta * rho) ** 2
            + 2.0 * alpha * beta * rho * rho
            + 2.0 * alpha * alpha * beta * rho * rho
            + 2.0 * alpha * beta * beta * rho * rho)


def _quartic_roots(c3, c2, c1, c0) -> torch.Tensor:
    """The 4 complex roots of the monic x^4 + c3 x^3 + c2 x^2 + c1 x + c0,
    elementwise, stacked on a new last axis, in complex128: Ferrari's
    resolvent-cubic route, then one guarded Newton step.  It yields the
    eigenvalues of the JAX package's 4x4 companion matrix without a
    batched eigensolve, which on a CUDA tensor synchronizes with the host
    (and took seconds per call at B = 64, n = 256)."""
    cd = torch.complex128
    c3, c2, c1, c0 = (t.to(cd) for t in (c3, c2, c1, c0))
    # x = y - c3/4: y^4 + p y^2 + q y + r
    c3s = c3 * c3
    p = c2 - 0.375 * c3s
    q = c1 - 0.5 * c3 * c2 + 0.125 * c3s * c3
    r = c0 - 0.25 * c3 * c1 + 0.0625 * c3s * c2 - (3.0 / 256.0) * c3s * c3s
    # resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0: its three
    # roots by Cardano; keep the largest (nonzero unless p = q = r = 0)
    bb = 0.25 * p * p - r
    pp = bb - p * p / 3.0
    qq = 2.0 * p * p * p / 27.0 - p * bb / 3.0 - 0.125 * q * q
    sd = torch.sqrt(0.25 * qq * qq + pp * pp * pp / 27.0)
    w1, w2 = -0.5 * qq + sd, -0.5 * qq - sd
    w = torch.where(w1.abs() >= w2.abs(), w1, w2)
    nz = w.abs() > 0
    uk = (torch.where(nz, w, 1.0) ** (1.0 / 3.0))[..., None] * device_constant(
        _ROOTS_OF_UNITY, w.dtype, w.device)
    # t_k = u_k - pp / (3 u_k), all 0 when w = 0 (then pp = qq = 0)
    ms = (torch.where(nz[..., None], uk - pp[..., None] / (3.0 * uk), 0.0)
          - (p / 3.0)[..., None])
    m = torch.gather(ms, -1, ms.abs().argmax(-1, keepdim=True))[..., 0]
    s = torch.sqrt(2.0 * m)
    s_ok = s.abs() > 0
    qs = torch.where(s_ok, q / (2.0 * torch.where(s_ok, s, 1.0)), 0.0)
    # (y^2 + p/2 + m)^2 = (s y - q/(2s))^2: two quadratics in y
    half = (0.5 * p + m)[..., None] + torch.stack([qs, -qs], dim=-1)
    sgn = device_constant((1.0, -1.0), s.dtype, s.device)
    b = -s[..., None] * sgn                                  # (..., 2)
    d = torch.sqrt(b * b - 4.0 * half)
    roots = torch.cat([(-b + d) / 2.0, (-b - d) / 2.0], dim=-1)
    x = roots - (0.25 * c3)[..., None]
    # one Newton step on the original polynomial, kept where it helps
    cs = [t[..., None] for t in (c3, c2, c1, c0)]
    px = (((x + cs[0]) * x + cs[1]) * x + cs[2]) * x + cs[3]
    dpx = ((4.0 * x + 3.0 * cs[0]) * x + 2.0 * cs[1]) * x + cs[2]
    ok = dpx.abs() > 0
    xn = x - px / torch.where(ok, dpx, 1.0)
    pn = (((xn + cs[0]) * xn + cs[1]) * xn + cs[2]) * xn + cs[3]
    return torch.where(ok & (pn.abs() < px.abs()), xn, x)


def _scale_scores(b_mat, e_mat, v_mat, h_mat, nrow, mcol):
    """Best scaling parameter and score per index i of (B, n, n) states."""
    rho = torch.diagonal(b_mat, dim1=-2, dim2=-1)
    eps_d = torch.diagonal(e_mat, dim1=-2, dim2=-1)
    v0 = torch.diagonal(v_mat, dim1=-2, dim2=-1)
    h0 = torch.diagonal(h_mat, dim1=-2, dim2=-1)
    dt = b_mat.dtype
    # P(a) = a^2 phi(a) is an exact quartic: fit through 5 samples
    pts = quartic_points(dt, b_mat.device)
    vals = pts ** 2 * _scale_phi(pts, rho[..., None], eps_d[..., None],
                                 nrow[..., None], mcol[..., None],
                                 v0[..., None], h0[..., None])  # (B, n, 5)
    p = fit_quartic(vals)
    # stationary points of phi = P / a^2 are the roots of
    # Q(a) = a P' - 2P = -2 p0 - p1 a + p3 a^3 + 2 p4 a^4
    q0, q1 = -2.0 * p[..., 0], -p[..., 1]
    q3, q4 = p[..., 2] * 0 + p[..., 3], 2.0 * p[..., 4]
    lead = torch.where(q4.abs() > 1e-20, q4, 1.0)
    roots = _quartic_roots(q3 / lead, torch.zeros_like(q3), q1 / lead,
                           q0 / lead)
    real_ok = roots.imag.abs() < 1e-3 * (1.0 + roots.real.abs())
    cand = torch.where(real_ok, roots.real, 1.0).to(dt)
    # also the cubic fallback roots (q4 ~ 0) and the identity a = 1
    fb = real_cubic_roots(q3, torch.zeros_like(q3), q1, q0)
    cand = torch.cat([cand, fb, torch.ones_like(cand[..., :1])], dim=-1)
    mag = torch.clamp(cand.abs(), _A_MIN_SCALE, _A_CLIP)
    cand = torch.where(cand < 0, -mag, mag)
    phis = _scale_phi(cand, rho[..., None], eps_d[..., None],
                      nrow[..., None], mcol[..., None], v0[..., None],
                      h0[..., None])
    phis = torch.where(torch.isfinite(phis), phis,
                       math.inf)
    kbest = torch.argmin(phis, dim=-1, keepdim=True)
    a_star = torch.gather(cand, -1, kbest)[..., 0]
    val = torch.clamp(torch.gather(phis, -1, kbest)[..., 0], max=0.0)
    a_star = torch.where(val < 0, a_star, 1.0)
    return a_star, val


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(B,) indices -> (B, n) unit rows (``one_hot`` would check the
    indices on the host, a stream synchronization)."""
    out = torch.zeros((idx.shape[0], n), dtype=dtype, device=idx.device)
    return out.scatter_(1, idx[:, None], 1.0)


def _rank2_vectors(b_mat, kind, i, j, a):
    """Delta = T B T^{-1} - B = u1 v1^T + u2 v2^T for one transform per
    matrix (B,): both kinds' vectors, selected per matrix."""
    ar = _arange(b_mat)
    n = b_mat.shape[-1]
    ei = _one_hot(i, n, b_mat.dtype)
    ej = _one_hot(j, n, b_mat.dtype)
    a = a.to(b_mat.dtype)[:, None]
    sc = (kind == SCALE)[:, None]
    # shear
    bji = b_mat[ar, j, i][:, None]
    sh_v1 = a * b_mat[ar, j] - (a * a * bji) * ej
    sh_u2 = -a * b_mat[ar, :, i]
    # scale (j == i)
    alpha = a - 1.0
    beta = (1.0 - a) / a
    bii = b_mat[ar, i, i][:, None]
    sc_v1 = alpha * b_mat[ar, i] + (alpha * beta * bii) * ei
    sc_u2 = beta * b_mat[ar, :, i]
    return (ei, torch.where(sc, sc_v1, sh_v1),
            torch.where(sc, sc_u2, sh_u2), torch.where(sc, ei, ej))


def _mv(mat, v):
    """Batched matrix-vector product (B, n, n) @ (B, n)."""
    return torch.bmm(mat, v.unsqueeze(-1))[..., 0]


def _outer(u, v):
    return u.unsqueeze(-1) * v.unsqueeze(-2)


def _dot(u, v):
    return (u * v).sum(-1, keepdim=True).unsqueeze(-1)


def _apply_update(state, kind, i, j, a):
    """Apply the transform and refresh (B, E, V, H, N, M) in O(n^2)."""
    b_mat, e_mat, v_mat, h_mat, _, _ = state
    u1, v1, u2, v2 = _rank2_vectors(b_mat, kind, i, j, a)
    et, bt = e_mat.transpose(-1, -2), b_mat.transpose(-1, -2)
    ev1, ev2 = _mv(e_mat, v1), _mv(e_mat, v2)
    bv1, bv2 = _mv(b_mat, v1), _mv(b_mat, v2)
    etu1, etu2 = _mv(et, u1), _mv(et, u2)
    btu1, btu2 = _mv(bt, u1), _mv(bt, u2)
    v11, v12, v22 = _dot(v1, v1), _dot(v1, v2), _dot(v2, v2)
    u11, u12, u22 = _dot(u1, u1), _dot(u1, u2), _dot(u2, u2)
    v_new = (v_mat
             + _outer(ev1, u1) + _outer(ev2, u2)
             - _outer(u1, bv1) - _outer(u2, bv2)
             - v11 * _outer(u1, u1) - v22 * _outer(u2, u2)
             - v12 * (_outer(u1, u2) + _outer(u2, u1)))
    h_new = (h_mat
             + _outer(etu1, v1) + _outer(etu2, v2)
             - _outer(v1, btu1) - _outer(v2, btu2)
             - u11 * _outer(v1, v1) - u22 * _outer(v2, v2)
             - u12 * (_outer(v1, v2) + _outer(v2, v1)))
    delta = _outer(u1, v1) + _outer(u2, v2)
    b_new = b_mat + delta
    e_new = e_mat - delta
    sq = b_new * b_new
    return b_new, e_new, v_new, h_new, sq.sum(-1), sq.sum(-2)


def _refresh(c_mat, b_mat):
    e = c_mat - b_mat
    sq = b_mat * b_mat
    return (b_mat, e, torch.bmm(e, b_mat.transpose(-1, -2)),
            torch.bmm(e.transpose(-1, -2), b_mat), sq.sum(-1), sq.sum(-2))


def t_init(c_mat: torch.Tensor, cbar: torch.Tensor, m: int, valid=None
           ) -> Tuple[TFactors, torch.Tensor]:
    """Theorem-3 greedy initialization of m T-transforms.

    ``c_mat`` (n, n) or (B, n, n).  ``valid`` ((n,) or (B, n) bool)
    restricts the greedy to the real coordinates of ragged matrices
    embedded in a wider bucket.  Returns (factors in application order,
    int32 indices; the final dense approximation B)."""
    c_b, _, single = _single_to_batch(c_mat, None)
    b0 = torch.diag_embed(cbar.to(c_b.dtype).reshape(c_b.shape[:2]))
    if valid is not None:
        valid = valid.reshape(c_b.shape[:2])
    factors, b = _t_greedy(c_b, b0, m, valid)
    if single:
        return TFactors(*(f[0] for f in factors)), b[0]
    return factors, b


def _t_greedy(c_mat: torch.Tensor, b0: torch.Tensor, m: int, valid=None
              ) -> Tuple[TFactors, torch.Tensor]:
    """Greedy Theorem-3 loop from a current approximation ``b0`` on
    (B, n, n) stacks.  New transforms CONJUGATE the running
    approximation (B <- T B T^{-1}), i.e. they are appended to the
    application order.  The score state is rebuilt from B every
    ``_REFRESH_EVERY`` steps.  With ``valid`` ((B, n) bool), shear pairs
    and scaling indices that touch a padding coordinate score +inf and
    are never selected."""
    bsz, n = c_mat.shape[0], c_mat.shape[-1]
    ar = _arange(c_mat)
    state = _refresh(c_mat, b0)
    pair_bad = (None if valid is None
                else ~(valid[:, :, None] & valid[:, None, :]))
    picked = []
    for t in range(m):
        if t and t % _REFRESH_EVERY == 0:
            state = _refresh(c_mat, state[0])
        a_sh, val_sh = _shear_scores(*state)
        a_sc, val_sc = _scale_scores(*state)
        if valid is not None:
            val_sh = val_sh.masked_fill(pair_bad, math.inf)
            val_sc = val_sc.masked_fill(~valid, math.inf)
        flat = torch.argmin(val_sh.reshape(bsz, -1), dim=1)
        pi = torch.div(flat, n, rounding_mode="floor")
        pj = flat - pi * n
        best_sh = val_sh[ar, pi, pj]
        si = torch.argmin(val_sc, dim=1)
        best_sc = val_sc[ar, si]
        use_scale = best_sc < best_sh
        kind = torch.where(use_scale, SCALE, SHEAR).to(torch.int32)
        i = torch.where(use_scale, si, pi)
        j = torch.where(use_scale, si, pj)
        a = torch.where(use_scale, a_sc[ar, si], a_sh[ar, pi, pj])
        state = _apply_update(state, kind, i, j, a)
        picked.append((kind, i, j, a))
    if not picked:
        zi = torch.zeros((bsz, 0), dtype=torch.int32, device=c_mat.device)
        return (TFactors(zi, zi, zi, torch.zeros((bsz, 0), dtype=c_mat.dtype,
                                                 device=c_mat.device)),
                state[0])
    kind, i, j, a = (torch.stack([p[q] for p in picked], dim=1)
                     for q in range(4))
    return TFactors(kind, i.to(torch.int32), j.to(torch.int32), a), state[0]


# ---------------------------------------------------------------------------
# Theorem 4 (polish): refit each transform value, indices fixed
# ---------------------------------------------------------------------------

def _shear_polish_coeffs(chat0, u_i, u_bc, w_r, w_j, kappa):
    """Quartic coefficients of ||Chat0 - (a U1 - a U2 - a^2 kappa U3)||^2
    with U1 = u_i w_r^T, U2 = u_bc w_j^T, U3 = u_i w_j^T (batched)."""
    def quad(u, mat, w):
        return (u * _mv(mat, w)).sum(-1)

    def dot(x, y):
        return (x * y).sum(-1)
    c1u = quad(u_i, chat0, w_r)
    c2u = quad(u_bc, chat0, w_j)
    c3u = quad(u_i, chat0, w_j)
    uu11, uu12, uu22 = dot(u_i, u_i), dot(u_i, u_bc), dot(u_bc, u_bc)
    ww_rr, ww_rj, ww_jj = dot(w_r, w_r), dot(w_r, w_j), dot(w_j, w_j)
    n11 = uu11 * ww_rr
    n22 = uu22 * ww_jj
    n12 = uu12 * ww_rj
    n13 = uu11 * ww_rj
    n23 = uu12 * ww_jj
    n33 = uu11 * ww_jj
    d1 = -2.0 * (c1u - c2u)
    d2 = n11 + n22 - 2.0 * n12 + 2.0 * kappa * c3u
    d3 = -2.0 * kappa * (n13 - n23)
    d4 = kappa * kappa * n33
    return d1, d2, d3, d4


def _rank2_conj(a_mat, a_inv, vecs):
    """A Delta A^{-1} as dense (B, n, n) — or (B, K, n, n) for K
    candidates per matrix — from rank-2 vectors (B, n) or (B, K, n)."""
    u1, v1, u2, v2 = vecs
    squeeze = u1.dim() == 2
    u = torch.stack([u1, u2], dim=-2).reshape(u1.shape[0], -1, u1.shape[-1])
    v = torch.stack([v1, v2], dim=-2).reshape(u.shape)
    left = torch.bmm(u, a_mat.transpose(-1, -2))     # rows: A u
    right = torch.bmm(v, a_inv)                      # rows: v^T A^{-1}
    out = torch.matmul(left.reshape(left.shape[:-2] + (-1, 2, left.shape[-1])
                                    ).transpose(-1, -2),
                       right.reshape(left.shape[:-2] + (-1, 2,
                                                        left.shape[-1])))
    return out[:, 0] if squeeze else out


def _scale_candidates_vecs(b_mat, i, cands):
    """Rank-2 vectors of a scaling at i for K candidate values per matrix
    (B, K): each (B, K, n)."""
    ar = _arange(b_mat)
    n = b_mat.shape[-1]
    ei = _one_hot(i, n, b_mat.dtype)[:, None, :].expand(-1, cands.shape[1],
                                                       -1)
    a = cands[..., None]
    alpha = a - 1.0
    beta = (1.0 - a) / a
    bii = b_mat[ar, i, i][:, None, None]
    v1 = alpha * b_mat[ar, i][:, None, :] + (alpha * beta * bii) * ei
    u2 = beta * b_mat[ar, :, i][:, None, :]
    return ei, v1, u2, ei


def t_polish(c_mat: torch.Tensor, factors: TFactors,
             cbar: torch.Tensor) -> TFactors:
    """One Gauss-Seidel sweep refitting every transform's parameter."""
    c_b, f, single = _single_to_batch(c_mat, factors)
    m = f.kind.shape[-1]
    if m == 0:
        return factors
    bsz, n = c_b.shape[0], c_b.shape[-1]
    dt = c_b.dtype
    ar = _arange(c_b)
    fl = _long(f)
    cbar = cbar.to(dt).reshape(bsz, n)
    # A = T_{m-1} ... T_1 (all but factor 0), A_inv its inverse
    eye = torch.eye(n, dtype=dt, device=c_b.device).expand(bsz, n, n)
    a_mat, a_inv = eye.clone(), eye.clone()
    for t in range(1, m):
        args = (fl.kind[:, t], fl.i[:, t], fl.j[:, t], fl.a[:, t].to(dt), ar)
        _left_mul(a_mat, *args)
        _right_mul_inv(a_inv, *args)
    b_mat = torch.diag_embed(cbar).clone()
    chat = c_b - t_reconstruct(f, cbar)
    fa = fl.a.clone()
    grid = device_constant(_SCALE_POLISH_GRID, dt, c_b.device)
    for k in range(m):
        kind, i, j = fl.kind[:, k], fl.i[:, k], fl.j[:, k]
        a_old = fa[:, k].to(dt)
        sc = kind == SCALE
        # residual with T_k = identity
        chat0 = chat + _rank2_conj(a_mat, a_inv,
                                   _rank2_vectors(b_mat, kind, i, j, a_old))
        # shear branch: exact quartic minimization, incumbent included
        kappa = b_mat[ar, j, i]
        u_i = a_mat[ar, :, i]
        u_bc = _mv(a_mat, b_mat[ar, :, i])
        w_r = _mv(a_inv.transpose(-1, -2), b_mat[ar, j])
        w_j = a_inv[ar, j]
        d1, d2, d3, d4 = _shear_polish_coeffs(chat0, u_i, u_bc, w_r, w_j,
                                              kappa)
        a_sh, _ = minimize_quartic(d1, d2, d3, d4, extra_candidates=[a_old],
                                   clip=_A_CLIP)
        # scale branch: a multiplicative grid around the incumbent, plus
        # 1 and the incumbent itself (never regresses)
        cands = torch.cat([grid[None, :] * a_old[:, None],
                           torch.ones_like(a_old)[:, None],
                           a_old[:, None]], dim=1)            # (B, 11)
        conj = _rank2_conj(a_mat, a_inv,
                           _scale_candidates_vecs(b_mat, i, cands))
        diff = chat0[:, None] - conj
        vals = gt._sq_sum(diff)
        vals = torch.where(cands.abs() < _A_MIN_SCALE,
                           math.inf, vals)
        a_sc = torch.gather(cands, 1, torch.argmin(vals, dim=1,
                                                   keepdim=True))[:, 0]
        a_new = torch.where(sc, a_sc, a_sh)
        fa[:, k] = a_new
        chat = chat0 - _rank2_conj(a_mat, a_inv,
                                   _rank2_vectors(b_mat, kind, i, j, a_new))
        # advance: B absorbs T_k(a_new); A drops T_{k+1}
        _conjugate_inplace(b_mat, kind, i, j, a_new, ar)
        if k + 1 < m:
            args = (fl.kind[:, k + 1], fl.i[:, k + 1], fl.j[:, k + 1],
                    fa[:, k + 1].to(dt), ar)
            _right_mul_inv(a_mat, *args)
            _left_mul(a_inv, *args)
    out = TFactors(f.kind, f.i, f.j, fa)
    return TFactors(*(t[0] for t in out)) if single else out


# ---------------------------------------------------------------------------
# Lemma 2 + the Algorithm 1 loop
# ---------------------------------------------------------------------------

def _min_norm_lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares of (B, M, N) a x = (B, M) b with the
    JAX package's (``jnp.linalg.lstsq``) cutoff: singular values below
    ``eps * max(M, N) * s_max`` are dropped.  A thin QR of the tall
    matrix, then an SVD of its (N, N) R factor."""
    q, r = torch.linalg.qr(a)
    u, s, vh = torch.linalg.svd(r)
    rcond = torch.finfo(a.dtype).eps * max(a.shape[-2], a.shape[-1])
    mask = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0),
                        0.0)
    qtb = torch.bmm(q.transpose(-1, -2), b.unsqueeze(-1))
    utb = torch.bmm(u.transpose(-1, -2), qtb)[..., 0]
    return torch.bmm(vh.transpose(-1, -2), (s_inv * utb).unsqueeze(-1))[..., 0]


def lemma2_spectrum(c_mat: torch.Tensor, factors: TFactors) -> torch.Tensor:
    """cbar* = argmin ||C - Tbar diag(c) Tbar^{-1}||_F^2 (Lemma 2).

    For n <= 256 the (n^2 x n) Khatri-Rao matrix is materialized and
    solved by minimum-norm least squares (the normal equations square
    kappa(Tbar), which in f32 can regress the objective); non-finite
    entries are zeroed first and a non-finite solution falls back to
    diag(C).  Larger n uses ridge-regularized normal equations (O(n^3));
    callers guard against regression either way."""
    c_b, f, single = _single_to_batch(c_mat, factors)
    bsz, n = c_b.shape[0], c_b.shape[-1]
    t_dense = t_to_dense(f, n, dtype=c_b.dtype)
    t_inv = t_to_dense(f, n, inverse=True, dtype=c_b.dtype)
    if n <= _LSTSQ_MAX_N:
        # column k: vec(Tbar[:, k] outer Tbar^{-1}[k, :])
        kr = torch.einsum("bik,bkj->bijk", t_dense, t_inv).reshape(
            bsz, n * n, n)
        torch.nan_to_num(kr, nan=0.0, posinf=0.0, neginf=0.0, out=kr)
        sol = _min_norm_lstsq(kr, c_b.reshape(bsz, n * n))
        del kr
        sol = torch.where(torch.isfinite(sol), sol,
                          torch.diagonal(c_b, dim1=-2, dim2=-1))
    else:
        gram = (torch.bmm(t_inv, t_inv.transpose(-1, -2))
                * torch.bmm(t_dense.transpose(-1, -2), t_dense))
        rhs = torch.diagonal(t_dense.transpose(-1, -2) @ c_b
                             @ t_inv.transpose(-1, -2), dim1=-2, dim2=-1)
        ridge = (1e-7 * torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) / n
                 + 1e-20)
        eye = torch.eye(n, dtype=c_b.dtype, device=c_b.device)
        sol = torch.linalg.solve(gram + ridge[:, None, None] * eye, rhs)
    return sol[0] if single else sol


def _gen_refit_spectrum(c_mat, factors, cbar0, update_spectrum: bool):
    """Lemma-2 refit with the regression guard: the f32 refit may be
    worse than the incumbent spectrum on an ill-conditioned Tbar — keep
    whichever reconstructs better (per matrix)."""
    if not update_spectrum:
        return cbar0
    cbar_l2 = lemma2_spectrum(c_mat, factors)
    obj_l2, obj0 = _t_objectives(c_mat, factors, [cbar_l2, cbar0])
    return torch.where((obj_l2 < obj0)[..., None], cbar_l2, cbar0)


def _gen_iterate(c_mat, factors, cbar, n_iter, update_spectrum, eps):
    """Algorithm-1 refinement loop on a batch: polish + Lemma-2 sweeps
    until the objective change drops below ``eps``.  Each matrix freezes
    once its own change is below ``eps`` while the others go on (the
    per-matrix stop of the JAX package's vmapped while loop)."""
    bsz = c_mat.shape[0]
    dt, dev = c_mat.dtype, c_mat.device
    eps_t = torch.tensor(eps, dtype=dt, device=dev)
    obj = t_objective(c_mat, factors, cbar)
    obj_prev = obj + 2 * eps_t + 1.0
    hist = torch.full((bsz, n_iter + 1), math.nan, dtype=dt, device=dev)
    hist[:, 0] = obj
    it = torch.zeros(bsz, dtype=torch.int64, device=dev)
    for step in range(n_iter):
        active = torch.abs(obj_prev - obj) >= eps_t
        if not bool(active.any()):
            break
        f2 = t_polish(c_mat, factors, cbar)
        cb2 = lemma2_spectrum(c_mat, f2) if update_spectrum else cbar
        obj2, obj2_old = _t_objectives(c_mat, f2, [cb2, cbar])
        # the spectrum refit can regress on an ill-conditioned Tbar;
        # keep the better of the two spectra
        keep_old = obj2 > obj
        cb2 = torch.where(keep_old[:, None], cbar, cb2)
        obj2 = torch.where(keep_old, obj2_old, obj2)
        act = active[:, None]
        factors = TFactors(*(torch.where(act, new, old)
                             for new, old in zip(f2, factors)))
        cbar = torch.where(act, cb2, cbar)
        hist[:, step + 1] = torch.where(active, obj2, hist[:, step + 1])
        obj_prev = torch.where(active, obj, obj_prev)
        obj = torch.where(active, obj2, obj)
        it = it + active.to(torch.int64)
    return factors, cbar, obj, hist, it


def _approx_gen_core(c_mat, cbar0, m, n_iter, update_spectrum, eps,
                     size=None):
    """Batched Algorithm-1 body for the general case: (B, n, n) matrices,
    (B, n) initial spectra.  ``size`` ((B,) true sides, optional) masks
    the Theorem-3 greedy to each matrix's leading coordinates; with a
    zero pad block the polish and Lemma-2 refits stay inside the valid
    block.  Returns (factors, cbar, objective, history, iterations)."""
    b0 = torch.diag_embed(cbar0.to(c_mat.dtype))
    factors, _ = _t_greedy(c_mat, b0, m, gt._valid_coords(c_mat, size))
    cbar = _gen_refit_spectrum(c_mat, factors, cbar0.to(c_mat.dtype),
                               update_spectrum)
    return _gen_iterate(c_mat, factors, cbar, n_iter, update_spectrum, eps)


def _extend_gen_core(c_mat, factors0, cbar0, m_extra, n_iter,
                     update_spectrum, eps, size=None):
    """Warm-start extension for the general case: the Theorem-3 greedy
    continues from the fitted reconstruction, so the ``m_extra`` new
    transforms refine the current residual.  They conjugate the running
    approximation and are therefore APPENDED in application order.
    ``size`` masks the appended greedy as in ``_approx_gen_core``."""
    cbar0 = cbar0.to(c_mat.dtype)
    b0 = t_reconstruct(factors0, cbar0)
    new, _ = _t_greedy(c_mat, b0, m_extra, gt._valid_coords(c_mat, size))
    factors = TFactors(*(torch.cat([of.to(nf.dtype), nf], dim=-1)
                         for of, nf in zip(factors0, new)))
    cbar = _gen_refit_spectrum(c_mat, factors, cbar0, update_spectrum)
    return _gen_iterate(c_mat, factors, cbar, n_iter, update_spectrum, eps)


def default_cbar(c_mat: torch.Tensor, sizes=None) -> torch.Tensor:
    """Default spectrum estimate diag(C) with a deterministic tie-break,
    for (n, n) or (..., n, n) (the same rule as ``default_sbar``,
    ``sizes`` included)."""
    return gt.default_sbar(c_mat, sizes)


def approximate_general(c_mat: torch.Tensor, m: int, n_iter: int = 10,
                        cbar: Optional[torch.Tensor] = None,
                        update_spectrum: bool = True, eps: float = 1e-2):
    """Algorithm 1, general case, one (n, n) matrix.  Returns
    (factors, cbar, info)."""
    if cbar is None:
        cbar = default_cbar(c_mat)
    factors, cbar, obj, hist, iters = _approx_gen_core(
        c_mat.unsqueeze(0), cbar.to(c_mat.dtype).unsqueeze(0), m, n_iter,
        update_spectrum, eps)
    info = {"objective": obj[0], "history": hist[0],
            "iterations": iters[0]}
    return TFactors(*(f[0] for f in factors)), cbar[0], info
