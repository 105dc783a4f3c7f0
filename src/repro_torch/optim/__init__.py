"""Optimizer-side features of the port: butterfly gradient compression
with error feedback (``compress``).  The JAX package's ``adamw`` comes
with the LM training slice."""
from . import compress
