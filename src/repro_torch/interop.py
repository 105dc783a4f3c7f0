"""Carrying a fitted basis across from the JAX package.

A fit is this system's "weights".  ``basis_from_numpy`` takes the factor
chain and spectrum of a fit as numpy arrays — ``np.asarray`` of the JAX
``ApproxEigenbasis.factors`` fields — and returns the port's
``ApproxEigenbasis`` with tables repacked by the port's own packer, which
are bitwise the JAX package's tables for the same factors.  Both
families: G chains (``kind="sym"``) and T chains (``kind="general"``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.eigenbasis import (ApproxEigenbasis, _normalize_sizes,
                                        _pack)
from repro_torch.core.types import GFactors, TFactors

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
