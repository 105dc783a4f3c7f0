"""Carrying a fitted basis across from the JAX package.

A fit is this system's "weights".  ``basis_from_numpy`` takes the factor
chain and spectrum of a fit as numpy arrays — ``np.asarray`` of the JAX
``ApproxEigenbasis.factors`` fields — and returns the port's
``ApproxEigenbasis`` with tables repacked by the port's own packer, which
are bitwise the JAX package's tables for the same factors.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.eigenbasis import ApproxEigenbasis
from repro_torch.core.staging import pack_g_batch_pair, pack_g_pair
from repro_torch.core.types import GFactors

_FIELDS = ("i", "j", "c", "s", "sigma")


def basis_from_numpy(kind: str, n: int, factors: Mapping[str, np.ndarray],
                     spectrum: np.ndarray, objective=None,
                     cuts: Optional[Sequence[int]] = None,
                     stage_pad: Optional[tuple] = None,
                     device="cuda") -> ApproxEigenbasis:
    """A port basis from host arrays.

    ``factors``: dict of ``i, j, c, s, sigma`` arrays, (g,) or (B, g);
    ``spectrum``: (n,) or (B, n); ``cuts``: the component ladder to pack
    (default: the quarters ladder); ``stage_pad``: batched shape quanta.
    """
    if kind != "sym":
        raise NotImplementedError(f"kind={kind!r} is not ported yet: the "
                                  "general family comes with the directed "
                                  "slice of repro_torch")
    missing = [f for f in _FIELDS if f not in factors]
    if missing:
        raise ValueError(f"factors lack fields {missing}")
    host = GFactors(
        *(np.asarray(factors[f], np.int32) for f in ("i", "j")),
        *(np.asarray(factors[f], np.float32) for f in ("c", "s", "sigma")))
    batched = host.i.ndim == 2
    if host.i.ndim not in (1, 2) or any(f.shape != host.i.shape
                                        for f in host):
        raise ValueError("factor fields must share one (g,) or (B, g) "
                         "shape")
    spec = np.asarray(spectrum, np.float32)
    want = (host.i.shape[0], n) if batched else (n,)
    if spec.shape != want:
        raise ValueError(f"spectrum shape {spec.shape} != {want}")
    dev = torch.device(device)
    if batched:
        fwd, bwd = pack_g_batch_pair(host, n, cuts=cuts, pad=stage_pad,
                                     device=dev)
    else:
        fwd, bwd = pack_g_pair(host, cuts=cuts, n=n, device=dev)
    tensors = GFactors(*(torch.from_numpy(f.copy()).to(dev) for f in host))
    obj = (None if objective is None
           else torch.from_numpy(np.array(objective, np.float32)).to(dev))
    return ApproxEigenbasis(kind="sym", n=n, batched=batched,
                            factors=tensors,
                            spectrum=torch.from_numpy(spec.copy()).to(dev),
                            fwd=fwd, bwd=bwd, objective=obj,
                            info={"stage_pad": stage_pad})
