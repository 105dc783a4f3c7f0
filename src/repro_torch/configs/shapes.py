"""Assigned input-shape grid (seq_len x global_batch per mode).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of length seq_len); ``train_*`` lowers ``train_step``; ``prefill_*``
lowers the prompt-processing forward.
"""
from typing import NamedTuple


class Shape(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic decode: only the SSM/hybrid archs run it
# (DESIGN.md §5); pure/global-attention archs skip with a recorded reason.
LONG_CONTEXT_ARCHS = {"mamba2-780m", "recurrentgemma-2b"}


def cells(arch_names):
    """All runnable (arch, shape) dry-run cells + the skip list."""
    run, skip = [], []
    for a in arch_names:
        for s in SHAPES.values():
            if s.name == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                skip.append((a, s.name,
                             "full-attention arch: 500k dense-KV decode is "
                             "quadratic-in-context (DESIGN.md §5)"))
            else:
                run.append((a, s.name))
    return run, skip
