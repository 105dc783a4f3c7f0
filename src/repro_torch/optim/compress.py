"""Gradient compression in a fast orthonormal butterfly basis (+ error
feedback) — the paper's operator as a distributed-optimization feature.

Each gradient leaf is flattened into width-n chunks, rotated into a
*fixed* orthonormal butterfly basis (an FFT-pattern G-transform product —
the paper's Ubar with frozen angles), and only ``keep`` of the width
coefficients are kept for the cross-replica reduction, at positions that
rotate with the step (``_keep_idx``) and are the same on every replica,
so the reduction operates on a compact buffer of keep / width the bytes.
Orthonormality makes the compression error exactly the dropped
coefficients; an error-feedback buffer re-injects them next step
(EF-SGD-style, so the compressed optimizer still converges).

``compress/decompress/residual/ef_roundtrip`` are the pure-functional
pieces; ``tree_ef_compress`` maps them over a trainer's nested
dict/list/tuple of gradient tensors, with a ``reduce_fn`` (for example an
all-reduce) on the compact blocks.  Everything runs on the tensors'
device.  The stages of a power-of-two width are perfect matchings, so a
stage is two disjoint index copies.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch


class CompressSpec(NamedTuple):
    width: int           # butterfly width n (power of two)
    depth: int           # number of butterfly stages (log2 n)
    keep: int            # coefficients kept per chunk (<= width)
    theta: torch.Tensor  # (depth, width//2) fixed rotation angles


def make_spec(width: int = 1024, ratio: float = 0.125, seed: int = 0,
              device="cuda") -> CompressSpec:
    """A spec of ``width`` (a power of two), keeping max(width * ratio, 1)
    coefficients a chunk; theta uniform in [-pi, pi) from a
    ``torch.Generator`` seeded with ``seed`` (torch's draws, not
    ``jax.random``'s), on ``device``."""
    if width < 2 or width & (width - 1):
        raise ValueError(f"width must be a power of two, got {width}")
    depth = int(np.log2(width))
    keep = max(int(width * ratio), 1)
    gen = torch.Generator().manual_seed(seed)
    theta = torch.empty((depth, width // 2)).uniform_(-np.pi, np.pi,
                                                       generator=gen)
    return CompressSpec(width, depth, keep, theta.to(device))


def _stage_indices(width: int, k: int,
                   device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage k's pairs (ii, jj), (width//2,) int32 each: stride
    2^(k mod log2 width) blocks."""
    stride = 2 ** (k % int(np.log2(width)))
    idx = np.arange(width // 2)
    block = (idx // stride) * (2 * stride)
    ii = block + idx % stride
    jj = ii + stride
    dev = torch.device(device)
    return (torch.from_numpy(ii.astype(np.int32)).to(dev),
            torch.from_numpy(jj.astype(np.int32)).to(dev))


def _butterfly(theta: torch.Tensor, x: torch.Tensor, width: int,
               adjoint: bool = False) -> torch.Tensor:
    """Apply the fixed orthonormal butterfly to x (..., width)."""
    depth = theta.shape[0]
    order = range(depth - 1, -1, -1) if adjoint else range(depth)
    for k in order:
        ii, jj = (t.long() for t in _stage_indices(width, k, x.device))
        c = torch.cos(theta[k]).to(x.dtype)
        s = torch.sin(theta[k]).to(x.dtype)
        if adjoint:
            s = -s
        xi = x.index_select(-1, ii)
        xj = x.index_select(-1, jj)
        x = (torch.empty_like(x).index_copy_(-1, ii, c * xi + s * xj)
             .index_copy_(-1, jj, -s * xi + c * xj))
    return x


def _chunk(leaf: torch.Tensor, width: int) -> Tuple[torch.Tensor, int]:
    flat = leaf.reshape(-1).float()
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, (-n) % width))
    return flat.reshape(-1, width), n


def _keep_idx(spec: CompressSpec, step) -> torch.Tensor:
    """Round-robin kept-coefficient window, (keep,) int32.

    A FIXED kept subspace can never converge under error feedback: the
    de-compressed update always lies in the same keep-dimensional
    subspace, so the orthogonal complement of the target is unreachable
    (the EF buffer just accumulates it forever).  Rotating the window by
    ``keep`` every step covers all width coordinates every width/keep
    steps while staying deterministic in ``step`` — so every replica
    keeps IDENTICAL positions and the reduction still operates on compact
    buffers.  int32 arithmetic, as the JAX package's."""
    dev = spec.theta.device
    off = (torch.as_tensor(step, dtype=torch.int32, device=dev)
           * spec.keep) % spec.width
    return (off + torch.arange(spec.keep, dtype=torch.int32, device=dev)
            ) % spec.width


def compress(spec: CompressSpec, leaf: torch.Tensor, step=0) -> torch.Tensor:
    """leaf -> compact (chunks, keep) coefficient block."""
    chunks, _ = _chunk(leaf, spec.width)
    coeffs = _butterfly(spec.theta, chunks, spec.width, adjoint=True)
    return coeffs.index_select(1, _keep_idx(spec, step).long())


def decompress(spec: CompressSpec, compact: torch.Tensor, shape,
               dtype, step=0) -> torch.Tensor:
    n = int(np.prod(shape))
    full = compact.new_zeros((compact.shape[0], spec.width),
                             dtype=torch.float32)
    full.index_copy_(1, _keep_idx(spec, step).long(), compact.float())
    out = _butterfly(spec.theta, full, spec.width, adjoint=False)
    return out.reshape(-1)[:n].reshape(shape).to(dtype)


def residual(spec: CompressSpec, leaf: torch.Tensor, step=0) -> torch.Tensor:
    """leaf - decompress(compress(leaf)): the error-feedback carry."""
    chunks, n = _chunk(leaf, spec.width)
    coeffs = _butterfly(spec.theta, chunks, spec.width, adjoint=True)
    dropped = coeffs.index_fill(1, _keep_idx(spec, step).long(), 0.0)
    err = _butterfly(spec.theta, dropped, spec.width, adjoint=False)
    return err.reshape(-1)[:n].reshape(leaf.shape).to(leaf.dtype)


def _ef_compact(spec: CompressSpec, grad: torch.Tensor, err: torch.Tensor,
                step=0):
    g_ef = grad.float() + err.float()
    return compress(spec, g_ef, step), g_ef


def _ef_expand(spec: CompressSpec, compact: torch.Tensor, g_ef, grad, err,
               step=0):
    out = decompress(spec, compact, grad.shape, torch.float32, step)
    new_err = residual(spec, g_ef, step)
    return out.to(grad.dtype), new_err.to(err.dtype)


def ef_roundtrip(spec: CompressSpec, grad: torch.Tensor,
                 err: torch.Tensor, reduce_fn=None, step=0):
    """Error-feedback compression of one leaf.

    Returns (reduced_grad, new_err).  ``reduce_fn`` (e.g. an all-reduce)
    acts on the compact coefficient block — the only thing that crosses
    replicas.
    """
    compact, g_ef = _ef_compact(spec, grad, err, step)
    if reduce_fn is not None:
        compact = reduce_fn(compact)
    return _ef_expand(spec, compact, g_ef, grad, err, step)


def _tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts, lists and tuples, ``rest`` of
    the same structure; anything else is a leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def init_error(params) -> Any:
    """Zero error-feedback buffers, bf16, of each leaf's shape and device."""
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                           device=p.device), params)


def init_error_abstract(params) -> Any:
    """The buffers' shapes and dtype without memory: bf16 tensors on the
    ``meta`` device (the JAX package returns ``ShapeDtypeStruct``s)."""
    return _tree_map(lambda p: torch.empty(p.shape, dtype=torch.bfloat16,
                                           device="meta"), params)


def tree_ef_compress(spec: CompressSpec, grads, err_tree, reduce_fn=None,
                     min_size: int = 1 << 14, step=0):
    """Apply EF compression leaf-wise (small leaves pass through, reduced
    whole).  Returns (new_grads, new_errs), each of the grads' structure."""

    def one(g, e):
        if int(np.prod(g.shape)) < min_size:
            out = reduce_fn(g) if reduce_fn is not None else g
            return out, e
        return ef_roundtrip(spec, g, e, reduce_fn, step)

    pairs = _tree_map(one, grads, err_tree)
    return (_tree_map(lambda _, p: p[0], grads, pairs),
            _tree_map(lambda _, p: p[1], grads, pairs))


def group_ef_compress(spec: CompressSpec, grads, errs, reduce_fn,
                      min_size: int = 1 << 14, step=0):
    """``tree_ef_compress`` on every member of a reduction group at once:
    ``grads`` and ``errs`` hold one tree a member, each of its own shard
    of every leaf (the JAX package compresses inside a ``shard_map``, so
    a leaf is a device's shard and ``min_size`` is compared with the
    shard's size).  ``reduce_fn`` maps the members' compact blocks (a
    small shard: the shards whole) to the members' reduced blocks, e.g. a
    mean over the pods.  Returns (new grads, new errs), a tree a
    member."""
    n = len(grads)

    def one(*leaves):
        gs, es = leaves[:n], leaves[n:]
        if int(np.prod(gs[0].shape)) < min_size:
            return list(zip(reduce_fn(list(gs)), es))
        parts = [_ef_compact(spec, g, e, step) for g, e in zip(gs, es)]
        reduced = reduce_fn([p[0] for p in parts])
        return [_ef_expand(spec, c, p[1], g, e, step)
                for c, p, g, e in zip(reduced, parts, gs, es)]

    done = _tree_map(one, *grads, *errs)
    return ([_tree_map(lambda _, d, k=k: d[k][0], grads[0], done)
             for k in range(n)],
            [_tree_map(lambda _, d, k=k: d[k][1], grads[0], done)
             for k in range(n)])
