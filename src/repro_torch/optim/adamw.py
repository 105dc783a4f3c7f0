"""AdamW with global-norm clipping and a warmup-cosine schedule.

The optimizer state mirrors the parameter tree (nested dicts of tensors,
the model's stacked tree): ``mu`` and ``nu`` have each parameter's shape
in ``moment_dtype``.  The arithmetic is the JAX package's: the moments
update in f32 and are cast back to their dtype (bf16 in the kimi-k2
recipe), the bias corrections ``1 - b**step`` are f32, the schedule is
computed on f32 tensors (so that ``lr`` rounds as the JAX package's does)
and the global norm adds the leaves' squared sums in the JAX tree order
(dict keys sorted).

``update`` writes the new parameters and moments into the given tensors
(the JAX step donates its state); it returns them, as the JAX function
returns its new trees.  Plain torch ops, one leaf at a time: a leaf's f32
temporaries are the only memory it adds.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import Axes


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any
    nu: Any


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts, lists and tuples (``rest``:
    trees of the same structure); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the JAX pytree order: dict keys sorted."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def init(params, moment_dtype=torch.float32) -> AdamWState:
    """Zero moments beside each parameter (its device), step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def init_abstract(params, moment_dtype=torch.float32) -> AdamWState:
    """The state's shapes and dtypes without memory: tensors on the
    ``meta`` device (the JAX package returns ``ShapeDtypeStruct``s)."""
    def empty(p):
        return torch.empty(p.shape, dtype=moment_dtype, device="meta")

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=tree_map(empty, params), nu=tree_map(empty, params))


def state_axes(params_axes) -> AdamWState:
    """The optimizer state's axes tree: the moments mirror the
    parameters' logical axes, the step is a scalar (``Axes(())``)."""
    return AdamWState(step=Axes(()), mu=tree_map(lambda a: a, params_axes),
                      nu=tree_map(lambda a: a, params_axes))


def squared_sum(tree, start=0) -> torch.Tensor:
    """The leaves' f32 squared sums, added in the JAX tree order to
    ``start`` (a zero tensor where the tree may be empty: a mesh id that
    owns no shard)."""
    total = start
    for x in tree_leaves(tree):
        xf = x.float()
        total = total + (xf * xf).sum()
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the leaves' f32 squared sums, added in the JAX tree order.
    Over a placed tree, each distinct shard counts once: a sharded step
    adds the ``squared_sum`` of the shards each mesh id owns over the
    mesh and takes the root (``runtime/steps.py``)."""
    return torch.sqrt(squared_sum(tree))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` as an f32 tensor: linear warmup to
    ``peak_lr``, then a cosine down to ``floor`` x ``peak_lr`` at
    ``total``; each operation in the JAX function's order and dtype."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           max_grad_norm: float = 1.0, norm=None):
    """One AdamW step, in place: returns (params, new state, {"grad_norm"})
    with the parameters and moments written into the given tensors.
    ``lr``: a float or an f32 tensor (``warmup_cosine``).  ``norm``: the
    gradients' global norm where the trees are one mesh id's shards (the
    norm of the whole tree, computed over the mesh); None: theirs."""
    gnorm = global_norm(grads) if norm is None else norm
    scale = _clip_scale(gnorm, max_grad_norm)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(g, m, v, p):
        # clip_by_global_norm leaf by leaf: no clipped copy of the tree.
        # Each line is the JAX expression's operations in its order, written
        # in place where a temporary is not read again (an f32 moment or
        # parameter is updated where it lies: ``.float()`` is the tensor)
        g32 = (g * scale).to(g.dtype).float()
        m2 = m.float().mul_(b1).add_((1 - b1) * g32)
        v2 = v.float().mul_(b2).add_(((1 - b2) * g32).mul_(g32))
        delta = (m2 / bc1).div_((v2 / bc2).sqrt_().add_(eps))
        delta.add_(weight_decay * p.float())
        p2 = p.float().sub_(delta.mul_(lr))
        for dst, src in ((p, p2), (m, m2), (v, v2)):
            if dst is not src:
                dst.copy_(src)

    tree_map(upd, grads, state.mu, state.nu, params)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}


@torch.no_grad()
def first_step_tolerance(grads, new_params, norm, *, lr, grad_tol: float,
                         grad_floor: float = 1e-3, norm_tol: float,
                         eps: float = 1e-8, max_grad_norm: float = 1.0
                         ) -> list:
    """How far apart two first ``update`` steps (zero moments, the same
    parameters) may put each parameter entry, when their gradients lie
    within ``grad_tol`` max(``grad_floor``, max|g|) a leaf of ``grads``
    and their global norms within ``norm_tol`` relative of ``norm``.

    The first step moves a parameter by lr (u(c g) + weight_decay p), the
    direction u(x) = x / (|x| + eps) of the clipped gradient c g.  Over
    the gradients' interval c g +- d, d = c (grad_tol max(grad_floor,
    max|g|) + norm_tol |g|), u moves by u(c g + d) - u(c g - d): up to 2
    where |g| is near eps, nothing where |g| >> d.  The tolerance is lr
    times that, plus 2^-16 lr for the update's own rounding and two f32
    spacings of the new parameter (``new_params``: the reference's) for
    the two results' roundings to f32 (half a spacing each, a spacing
    twice as wide across a power of two).  A list of f32 tensors in
    ``tree_leaves`` order."""
    c = min(1.0, max_grad_norm / max(float(norm), 1e-9))

    def u(x):
        return x / (x.abs() + eps)

    out = []
    for g, p in zip(tree_leaves(grads), tree_leaves(new_params)):
        g = g.float()
        d = c * (grad_tol * max(grad_floor, float(g.abs().max()))
                 + norm_tol * g.abs())
        spread = u(c * g + d).sub_(u(c * g - d))
        pa = p.float().abs()
        ulp = torch.nextafter(pa, torch.full_like(pa, math.inf)).sub_(pa)
        out.append(spread.add_(2.0 ** -16).mul_(float(lr)).add_(ulp, alpha=2))
    return out
