"""Optimizer-side features of the port: AdamW with clipping and the
warmup-cosine schedule (``adamw``) and butterfly gradient compression
with error feedback (``compress``)."""
from . import adamw, compress
