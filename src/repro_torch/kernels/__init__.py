"""Hand-written CUDA kernels (csrc/), their plain PyTorch versions
(``ref``), the execution plans that dispatch between them and the
persisted tile autotuner (``autotune``).

Dispatch is declarative: ``plan.ApplyPlan`` names a staged-table
computation and returns its one cached program; its ``block_b`` tile
resolves through ``autotune``'s cache.
"""
from . import plan, ref, butterfly, shear, spectral, autotune
from .plan import ApplyPlan
