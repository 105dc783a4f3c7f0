"""FastEig layers: the paper's structured operators as LM building blocks.

Two integration modes:

1. ``butterfly_apply`` — a *trainable* fast orthonormal mixing layer with
   a fixed FFT-style conflict-free index pattern and learnable rotation
   angles + diagonal: y = Ubar(theta) diag(d) Ubar(theta)^T x, O(n log n)
   per token.  Plain torch under autograd (the JAX package's layer has no
   kernel either).

2. ``compress_linear`` — post-hoc compression of a trained square
   projection W via the polar decomposition W = Q H: the orthonormal Q is
   factorized with the greedy Givens method
   (``baselines.factorize_orthonormal``) and the symmetric PSD H with the
   paper's Algorithm 1, giving W ~= Qbar (Ubar diag(s) Ubar^T) at
   O(g_orth + g_sym) apply cost; ``compressed_linear_apply`` runs it as one
   operator plan and one apply plan (on the card: one ``g_operator_kernel``
   and one ``g_chain_kernel`` launch).

Each butterfly stage is applied gather-only, per coordinate:
``y_k = a_k x_k + b_k x_{pi(k)}`` with (a, b) = (c, s) on a pair's first
coordinate, (c, -s) on its second, pi swapping the two, and a = 1, b = 0,
pi(k) = k on untouched coordinates and on the pattern's no-op pad pairs.
A stage written as two scatters (``x[..., ii] = ...; x[..., jj] = ...``)
computes the same forward, but where a width that is not a power of two
pads a stage with several no-op pairs on one index, autograd through the
scatters hands each duplicate the whole cotangent and the input gradient
goes wrong; the gather form has no duplicates to mishandle.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import gtransform as gt
from .baselines import factorize_orthonormal
from .staging import StagedG, pack_g_pair


class ButterflyParams(NamedTuple):
    theta: torch.Tensor  # (S, P) rotation angles (trainable)
    diag: torch.Tensor   # (n,) diagonal (trainable)


class ButterflyPattern(NamedTuple):
    idx_i: torch.Tensor  # (S, P) int32 — static FFT-style disjoint pairs
    idx_j: torch.Tensor  # (S, P) int32
    n: int


def _fft_pattern_np(n: int, n_stages=None) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's index tables, (S, n//2) int32 each."""
    depth = n_stages or max(int(np.ceil(np.log2(n))), 1)
    ii, jj = [], []
    for k in range(depth):
        stride = 2 ** (k % max(int(np.log2(n)) if (n & (n - 1)) == 0
                               else int(np.log2(n)) + 1, 1))
        stride = max(stride % n, 1)
        pairs_i, pairs_j, used = [], [], set()
        for a in range(n):
            b = (a + stride) % n
            if a in used or b in used or a == b:
                continue
            pairs_i.append(a)
            pairs_j.append(b)
            used.add(a)
            used.add(b)
        # pad to n//2 with no-op self pairs on an unused index
        free = [x for x in range(n) if x not in used]
        pad = free[0] if free else 0
        while len(pairs_i) < n // 2:
            pairs_i.append(pad)
            pairs_j.append(pad)
        ii.append(pairs_i)
        jj.append(pairs_j)
    return np.array(ii, np.int32), np.array(jj, np.int32)


def fft_pattern(n: int, n_stages: int | None = None,
                device="cuda") -> ButterflyPattern:
    """FFT-butterfly index pattern: stage k pairs (i, i + 2^k mod-block).

    ``n``: even layer width; ``n_stages`` defaults to ceil(log2 n).
    Returns (S, n//2) int32 index tables on ``device``, bitwise the JAX
    package's.  Each stage is a perfect matching (padded with no-op self
    pairs on one unused index where n is not a power of two)."""
    if n % 2:
        raise ValueError(f"butterfly mixing needs even width, got n={n}")
    ii, jj = _fft_pattern_np(n, n_stages)
    dev = torch.device(device)
    return ButterflyPattern(torch.from_numpy(ii).to(dev),
                            torch.from_numpy(jj).to(dev), n)


def butterfly_init(generator: torch.Generator, pattern: ButterflyPattern,
                   dtype=torch.float32) -> ButterflyParams:
    """Trainable params for a butterfly layer, on the pattern's device:
    small random angles theta (S, n//2) ~ N(0, 0.1^2) from ``generator``
    (near-identity init) and a unit diagonal (n,), both ``dtype``.  The
    draws are torch's, not ``jax.random``'s."""
    dev = pattern.idx_i.device
    theta = torch.randn(tuple(pattern.idx_i.shape), generator=generator,
                        dtype=dtype, device=generator.device).to(dev) * 0.1
    return ButterflyParams(theta=theta,
                           diag=torch.ones((pattern.n,), dtype=dtype,
                                           device=dev))


def _coordinate_tables(pattern: ButterflyPattern, device):
    """Per stage and coordinate: pi (S, n) int64, the pair slot (S, n)
    int64 whose angle the coordinate takes (0 where untouched), the sign
    of its b (+1 first coordinate, -1 second, 0 untouched) and whether it
    is touched.  Pad pairs (i == j) touch nothing; their scatters land in
    a dummy column n that is dropped."""
    ii = pattern.idx_i.to(device=device, dtype=torch.int64)
    jj = pattern.idx_j.to(device=device, dtype=torch.int64)
    n = pattern.n
    stages, width = ii.shape
    real = ii != jj
    ti = torch.where(real, ii, n)
    tj = torch.where(real, jj, n)
    perm = torch.arange(n + 1, device=device).repeat(stages, 1)
    perm.scatter_(1, ti, jj).scatter_(1, tj, ii)
    slot = torch.arange(width, device=device).expand(stages, width)
    pair = torch.zeros((stages, n + 1), dtype=torch.int64, device=device)
    pair.scatter_(1, ti, slot).scatter_(1, tj, slot)
    sign = torch.zeros((stages, n + 1), device=device)
    sign.scatter_(1, ti, 1.0).scatter_(1, tj, -1.0)
    return perm[:, :n], pair[:, :n], sign[:, :n], sign[:, :n] != 0


def _apply_stages(x, tables, cos_t, sin_t, reverse: bool):
    """The stages in order (or reversed), each y = a x + b x[pi]."""
    perm, pair, sign, touched = tables
    a = torch.where(touched, cos_t.gather(1, pair), 1.0).to(x.dtype)
    b = (sign.to(sin_t.dtype) * sin_t.gather(1, pair)).to(x.dtype)
    order = range(perm.shape[0] - 1, -1, -1) if reverse \
        else range(perm.shape[0])
    for k in order:
        x = a[k] * x + b[k] * x.index_select(-1, perm[k])
    return x


def butterfly_apply(params: ButterflyParams, pattern: ButterflyPattern,
                    x: torch.Tensor, mix_only: bool = False) -> torch.Tensor:
    """y = U(theta) diag(d) U(theta)^T x  (or just U(theta) x).

    The trainable form of the paper's eq. (2) operator with rotation-only
    blocks.  ``x``: (..., n), any float dtype (params cast to x's dtype),
    on the params' device; O(n log n) per vector, differentiable in
    theta, d and x.  ``mix_only=True`` applies the orthonormal mixing
    U(theta) alone."""
    tables = _coordinate_tables(pattern, x.device)
    cos_t = torch.cos(params.theta)
    sin_t = torch.sin(params.theta)
    if mix_only:
        return _apply_stages(x, tables, cos_t, sin_t, reverse=False)
    # adjoint: reversed stages with -sin
    y = _apply_stages(x, tables, cos_t, -sin_t, reverse=True)
    y = y * params.diag.to(y.dtype)
    return _apply_stages(y, tables, cos_t, sin_t, reverse=False)


class CompressedLinear(NamedTuple):
    """W ~= Qbar @ (Ubar diag(s) Ubar^T): all-butterfly square projection."""

    q_fwd: StagedG
    h_fwd: StagedG
    h_adj: StagedG
    diag: torch.Tensor


def compress_linear(w: torch.Tensor, g_orth: int, g_sym: int,
                    n_iter: int = 6) -> Tuple[CompressedLinear, dict]:
    """Compress a trained square projection via the paper's factorizations.

    ``w``: (n, n) float.  Polar-decomposes W = Q H (f64 SVD on the host,
    so Q and H are bitwise the JAX package's), then factors the
    orthonormal Q with ``g_orth`` greedy Givens transforms
    (``baselines.factorize_orthonormal``) and the symmetric PSD H with
    Algorithm 1 (``g_sym`` transforms, ``n_iter`` sweeps), both on w's
    device, giving W ~= Qbar (Ubar diag(s) Ubar^T).  The tables are packed
    at width n.  Returns the staged bundle + a report dict
    {"rel_err", "h_obj"} (f32 reconstruction quality)."""
    n = w.shape[0]
    dev = w.device
    w64 = w.detach().cpu().numpy().astype(np.float64)
    u, sv, vt = np.linalg.svd(w64)
    q = (u @ vt).astype(np.float32)              # orthonormal polar factor
    h = (vt.T * sv[None, :]) @ vt                # symmetric PSD factor
    qf = factorize_orthonormal(torch.from_numpy(q).to(dev), g_orth)
    hf, sbar, info = gt.approximate_symmetric(
        torch.from_numpy(h.astype(np.float32)).to(dev), g=g_sym,
        n_iter=n_iter)
    comp = _bundle(qf, hf, sbar, n, dev)
    # report reconstruction quality
    qd = gt.g_to_dense(qf, n)
    hd = gt.g_to_dense(hf, n)
    w_hat = qd @ (hd * sbar[None, :]) @ hd.T
    w32 = w.detach().float()
    rel = float(torch.sum((w32 - w_hat) ** 2) / torch.sum(w32 * w32))
    return comp, {"rel_err": rel, "h_obj": float(info["objective"])}


def _bundle(qf, hf, diag: torch.Tensor, n: int, device) -> CompressedLinear:
    """The staged bundle of a Q chain, an H chain and H's spectrum."""
    q_fwd, _ = pack_g_pair(qf, n=n, device=device)
    h_fwd, h_adj = pack_g_pair(hf, n=n, device=device)
    return CompressedLinear(q_fwd=q_fwd, h_fwd=h_fwd, h_adj=h_adj,
                            diag=diag.to(device=device, dtype=torch.float32))


def compressed_linear_apply(comp: CompressedLinear, x: torch.Tensor,
                            backend=None) -> torch.Tensor:
    """y ~= W x through the compressed factors: the fused symmetric
    operator (H) followed by the staged Q apply.  ``x``: (..., n) on the
    tables' device; ``backend`` as in kernels/plan.py (None: from the
    device)."""
    from repro_torch.kernels.plan import ApplyPlan
    y = ApplyPlan.for_staged(comp.h_fwd, mode="operator",
                             backend=backend).operator(
        comp.h_fwd, comp.h_adj, comp.diag, x)
    return ApplyPlan.for_staged(comp.q_fwd, mode="apply",
                                backend=backend).apply(comp.q_fwd, y)
