"""Carrying a fitted basis across from the JAX package.

A fit is this system's "weights".  ``basis_from_numpy`` takes the factor
chain and spectrum of a fit as numpy arrays — ``np.asarray`` of the JAX
``ApproxEigenbasis.factors`` fields — and returns the port's
``ApproxEigenbasis`` with tables repacked by the port's own packer, which
are bitwise the JAX package's tables for the same factors.  Both
families: G chains (``kind="sym"``) and T chains (``kind="general"``).

The same for the layers of ``core/fastlinear.py`` and
``optim/compress.py``, whose random draws (``jax.random``) the port
cannot reproduce: ``butterfly_params_from_numpy`` (a butterfly layer's
angles and diagonal), ``compress_spec_from_numpy`` (a compression spec's
fixed angles) and ``compressed_linear_from_numpy`` (the Q and H chains
and H's spectrum of a compressed projection, repacked into the tables the
JAX ``CompressedLinear`` holds).

And for the LM scaffold: ``lm_params_from_numpy`` turns the JAX
``init_params`` tree (numpy leaves, stacked per group) into the port's
parameter tree, and ``lm_cache_from_numpy`` a JAX decode cache into the
port's.  The port keeps the JAX layouts (``wq`` (d, h, hd), ``wo``
(h, hd, d), ...), so each leaf is a copy, not a transpose.
``train_state_from_numpy`` and ``train_state_to_numpy`` carry a whole
train state (parameters, the AdamW step and moments, the error-feedback
buffers) across, both ways.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.eigenbasis import (ApproxEigenbasis, _normalize_sizes,
                                        _pack)
from repro_torch.core.fastlinear import (ButterflyParams, CompressedLinear,
                                         _bundle)
from repro_torch.core.types import GFactors, TFactors
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compress import CompressSpec
from repro_torch.runtime.steps import TrainState

#: kind -> (factor container, its int32 fields; the others are f32)
_LAYOUT = {"sym": (GFactors, ("i", "j")),
           "general": (TFactors, ("kind", "i", "j"))}


def basis_from_numpy(kind: str, n: int, factors: Mapping[str, np.ndarray],
                     spectrum: np.ndarray, objective=None,
                     cuts: Optional[Sequence[int]] = None,
                     stage_pad: Optional[tuple] = None, sizes=None,
                     device="cuda") -> ApproxEigenbasis:
    """A port basis from host arrays.

    ``kind``: "sym" or "general"; ``factors``: dict of the family's
    fields (``i, j, c, s, sigma`` or ``kind, i, j, a``), (g,) or (B, g);
    ``spectrum``: (n,) or (B, n); ``cuts``: the component ladder to pack
    (default: the quarters ladder); ``stage_pad``: batched shape quanta;
    ``sizes``: the true sides of a ragged (masked) fit, (B,) or a scalar,
    so that the carried basis keeps its mask.
    """
    if kind not in _LAYOUT:
        raise ValueError(f"kind must be one of {sorted(_LAYOUT)}, got "
                         f"{kind!r}")
    cls, int_fields = _LAYOUT[kind]
    missing = [f for f in cls._fields if f not in factors]
    if missing:
        raise ValueError(f"factors lack fields {missing}")
    host = cls(**{f: np.asarray(factors[f], np.int32 if f in int_fields
                                else np.float32) for f in cls._fields})
    batched = host.i.ndim == 2
    if host.i.ndim not in (1, 2) or any(f.shape != host.i.shape
                                        for f in host):
        raise ValueError("factor fields must share one (g,) or (B, g) "
                         "shape")
    spec = np.asarray(spectrum, np.float32)
    want = (host.i.shape[0], n) if batched else (n,)
    if spec.shape != want:
        raise ValueError(f"spectrum shape {spec.shape} != {want}")
    sizes = _normalize_sizes(sizes, batched, n,
                             host.i.shape[0] if batched else 0)
    dev = torch.device(device)
    fwd, bwd = _pack(kind, batched, host, n, cuts, stage_pad, dev)
    tensors = cls(*(torch.from_numpy(f.copy()).to(dev) for f in host))
    obj = (None if objective is None
           else torch.from_numpy(np.array(objective, np.float32)).to(dev))
    return ApproxEigenbasis(kind=kind, n=n, batched=batched,
                            factors=tensors,
                            spectrum=torch.from_numpy(spec.copy()).to(dev),
                            fwd=fwd, bwd=bwd, objective=obj,
                            info={"stage_pad": stage_pad}, sizes=sizes)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype)).to(torch.device(device))


def butterfly_params_from_numpy(theta, diag,
                                device="cuda") -> ButterflyParams:
    """A butterfly layer's parameters from host arrays: theta (S, n//2)
    and diag (n,), both float32 (``np.asarray`` of the JAX
    ``ButterflyParams`` fields)."""
    theta = _tensor(theta, np.float32, device)
    diag = _tensor(diag, np.float32, device)
    if theta.dim() != 2 or diag.dim() != 1 \
            or 2 * theta.shape[1] != diag.shape[0]:
        raise ValueError(f"theta {tuple(theta.shape)} and diag "
                         f"{tuple(diag.shape)} are not (S, n//2) and (n,)")
    return ButterflyParams(theta=theta, diag=diag)


def compress_spec_from_numpy(width: int, keep: int, theta,
                             device="cuda") -> CompressSpec:
    """A compression spec from the JAX ``make_spec``'s fields: ``width``
    (a power of two), ``keep`` and its theta (log2 width, width//2)."""
    theta = _tensor(theta, np.float32, device)
    depth = int(np.log2(width))
    if width < 2 or width & (width - 1) \
            or tuple(theta.shape) != (depth, width // 2):
        raise ValueError(f"theta {tuple(theta.shape)} does not fit width "
                         f"{width} (want ({depth}, {width // 2}))")
    if not 1 <= keep <= width:
        raise ValueError(f"keep {keep} not in [1, {width}]")
    return CompressSpec(width, depth, int(keep), theta)


def compressed_linear_from_numpy(q_factors: Mapping[str, np.ndarray],
                                 h_factors: Mapping[str, np.ndarray],
                                 diag: np.ndarray, n: int,
                                 device="cuda") -> CompressedLinear:
    """A compressed projection from the Q chain (``factorize_orthonormal``
    of the polar factor), the H chain (Algorithm 1) and H's spectrum, as
    the JAX ``compress_linear`` computes them: dicts of ``i, j, c, s,
    sigma`` (g,) arrays and diag (n,).  The tables are packed at width n
    by the port's packer, bitwise the JAX ``CompressedLinear``'s tables
    where its chains touch coordinate n - 1 (the JAX package infers the
    width from the indices)."""
    chains = []
    for name, fields in (("q_factors", q_factors), ("h_factors", h_factors)):
        missing = [f for f in GFactors._fields if f not in fields]
        if missing:
            raise ValueError(f"{name} lack fields {missing}")
        chains.append(GFactors(*(
            _tensor(fields[f], np.int32 if f in ("i", "j") else np.float32,
                    device) for f in GFactors._fields)))
    diag = _tensor(diag, np.float32, device)
    if tuple(diag.shape) != (n,):
        raise ValueError(f"diag shape {tuple(diag.shape)} != ({n},)")
    return _bundle(chains[0], chains[1], diag, n, device)


def _leaf(a, device) -> torch.Tensor:
    """A host array as a tensor, bf16 (``ml_dtypes.bfloat16``, as
    ``np.asarray`` of a JAX bf16 array gives it) included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(torch.device(device))


def lm_params_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The port's parameter tree from the JAX ``init_params`` tree with
    numpy leaves (``jax.tree.map(np.asarray, params)``), in
    ``cfg.param_dtype``; its structure and shapes are checked against
    ``transformer.param_spec``.  Build the model with
    ``transformer.Transformer(cfg, params)``."""
    params = tfm.tree_map(
        lambda a: _leaf(a, device).to(cfg.param_dtype), dict(tree))
    tfm._check_tree(params, tfm.param_spec(cfg))
    return params


def lm_cache_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The port's decode cache from a JAX ``init_cache``/``prefill``
    cache with numpy leaves, each leaf's dtype kept: per group and block
    attention ``k``, ``v`` (count, B, len, KV, hd) and ``pos`` (count, B,
    len) int32, RG-LRU ``conv`` and ``h``, SSD ``conv`` and ``state``.
    The tree's structure and shapes are checked against
    ``transformer.init_cache``'s for the same batch and length."""
    tree = {name: dict(group) for name, group in dict(tree).items()}
    want = [name for name, _ in tfm.group_plan(cfg)]
    if sorted(tree) != sorted(want):
        raise ValueError(f"cache groups {sorted(tree)}, want {sorted(want)}")
    cache = tfm.tree_map(lambda a: _leaf(a, device), tree)
    blocks = [blk for grp in cache.values() for blk in grp.values()]
    b = next(iter(blocks[0].values())).shape[1]
    length = max((blk["k"].shape[2] for blk in blocks if "k" in blk),
                 default=1)
    spec = tfm.tree_map(lambda t: tfm.Leaf(tuple(t.shape), "zeros"),
                        tfm.init_cache(cfg, b, length, device="meta"))
    tfm._check_tree(cache, spec)
    return cache


def _field(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def train_state_from_numpy(cfg: ModelConfig, tree,
                           device="cuda") -> TrainState:
    """The port's ``TrainState`` from a JAX one with numpy leaves
    (``jax.tree.map(np.asarray, state)``) or the same as nested dicts
    (``train_state_to_numpy``'s): ``params`` (as
    ``lm_params_from_numpy`` takes them), ``opt`` with ``step`` (int32),
    ``mu`` and ``nu`` (each leaf's dtype kept: f32 or bf16 moments), and
    ``ef_err`` (bf16 error-feedback buffers, or None)."""
    params = lm_params_from_numpy(cfg, _field(tree, "params"), device)
    opt = _field(tree, "opt")

    def moments(name):
        out = tfm.tree_map(lambda a: _leaf(a, device), dict(_field(opt,
                                                                   name)))
        tfm._check_tree(out, tfm.param_spec(cfg))
        return out

    step = torch.tensor(int(np.asarray(_field(opt, "step"))),
                        dtype=torch.int32, device=torch.device(device))
    ef = _field(tree, "ef_err")
    if ef is not None:
        ef = tfm.tree_map(lambda a: _leaf(a, device), dict(ef))
        tfm._check_tree(ef, tfm.param_spec(cfg))
    return TrainState(params, AdamWState(step, moments("mu"),
                                         moments("nu")), ef)


def _host_leaf(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 as ``ml_dtypes.bfloat16`` where
    that package is loaded (the JAX package loads it), else f32."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        return t.float().numpy()
    return t.view(torch.int16).numpy().copy().view(bf16)


def train_state_to_numpy(state: TrainState) -> dict:
    """A port ``TrainState`` as nested dicts of numpy arrays:
    {"params", "opt": {"step", "mu", "nu"}, "ef_err"}."""
    def host(tree):
        return None if tree is None else tfm.tree_map(_host_leaf, tree)

    return {"params": host(state.params),
            "opt": {"step": np.asarray(int(state.opt.step), np.int32),
                    "mu": host(state.opt.mu), "nu": host(state.opt.nu)},
            "ef_err": host(state.ef_err)}
