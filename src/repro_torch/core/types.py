"""Factor containers for the paper's two structured operator families.

G-transforms (eq. 3-5): extended orthonormal Givens transforms — rotations
(sigma=+1) and reflections (sigma=-1) — with canonical 2x2 block on (i, j),
j > i::

    [ c        s      ]
    [ -sigma*s sigma*c ]   with c^2 + s^2 = 1

so that  y_i = c x_i + s x_j ;  y_j = sigma * (-s x_i + c x_j).

T-transforms (eq. 8-10): kind=SHEAR at ordered (i, j) is x_i += a x_j,
kind=SCALE at (i, i) scales coordinate i by a.

Factors are stored in APPLICATION order: factor 0 is applied first, i.e.
``Ubar = G_{g-1} ... G_1 G_0``.  Fields hold torch tensors (or numpy
arrays on the host side of the packers); batched chains carry a leading
(B,) axis.

Signals (``as_signal``) are float32 or bfloat16: the transforms compute
in the signal's dtype, as the JAX package's kernels do.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

SCALE = 0  # T-transform kind: diagonal scaling at index i (j == i)
SHEAR = 1  # T-transform kind: x_i += a * x_j  (ordered pair, i != j)


class GFactors(NamedTuple):
    """A sequence of g extended Givens transforms: (g,) or (B, g) fields."""

    i: torch.Tensor      # int32, first coordinate
    j: torch.Tensor      # int32, second coordinate (j > i)
    c: torch.Tensor      # float, cosine-like value
    s: torch.Tensor      # float, sine-like value
    sigma: torch.Tensor  # float in {+1.0, -1.0}: rotation / reflection

    @property
    def g(self) -> int:
        return self.i.shape[-1]


class TFactors(NamedTuple):
    """A sequence of m scaling / shear transforms: (m,) or (B, m) fields."""

    kind: torch.Tensor   # int32 in {SCALE, SHEAR}
    i: torch.Tensor      # int32
    j: torch.Tensor      # int32 (== i for SCALE)
    a: torch.Tensor      # float parameter

    @property
    def m(self) -> int:
        return self.kind.shape[-1]


def gfactors_identity(g: int, dtype=torch.float32,
                      device="cuda") -> GFactors:
    """g identity G-transforms on the pair (0, 1)."""
    z = torch.zeros((g,), dtype=torch.int32, device=device)
    return GFactors(
        i=z, j=torch.ones((g,), dtype=torch.int32, device=device),
        c=torch.ones((g,), dtype=dtype, device=device),
        s=torch.zeros((g,), dtype=dtype, device=device),
        sigma=torch.ones((g,), dtype=dtype, device=device),
    )


def tfactors_identity(m: int, dtype=torch.float32,
                      device="cuda") -> TFactors:
    """m identity T-transforms: scalings by 1 at index 0."""
    z = torch.zeros((m,), dtype=torch.int32, device=device)
    return TFactors(
        kind=torch.full((m,), SCALE, dtype=torch.int32, device=device),
        i=z, j=z.clone(), a=torch.ones((m,), dtype=dtype, device=device),
    )


#: the signal dtypes the transforms compute in
SIGNAL_DTYPES = (torch.float32, torch.bfloat16)


def as_signal(x, device) -> torch.Tensor:
    """A signal block on ``device``: a float32 or bfloat16 tensor keeps
    its dtype (the transforms then compute in it), anything else becomes
    float32, as ``jnp.asarray`` does without x64."""
    x = torch.as_tensor(x)
    dtype = x.dtype if x.dtype in SIGNAL_DTYPES else torch.float32
    return x.to(device=device, dtype=dtype)
