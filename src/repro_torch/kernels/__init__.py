"""Hand-written CUDA kernels (csrc/), their plain PyTorch versions
(``ref``) and the execution plans that dispatch between them.

Dispatch is declarative: ``plan.ApplyPlan`` names a staged-table
computation and returns its one cached program.  The JAX package's
``autotune`` (persisted Pallas tile choices) is not ported.
"""
from . import plan, ref, butterfly, shear, spectral
from .plan import ApplyPlan
