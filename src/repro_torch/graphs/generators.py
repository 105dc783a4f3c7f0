"""Synthetic graph generators (numpy): the GSP-box community family the
paper's experiments and the FGFT service use.  The same seed gives the
same adjacency as the JAX package's generator."""
from __future__ import annotations

import numpy as np


def community_graph(n: int, n_comm: int = 0, p_in: float = 0.5,
                    p_out: float = 0.01, seed: int = 0) -> np.ndarray:
    """GSP-box-style community graph: dense blocks, sparse inter-links."""
    rng = np.random.default_rng(seed)
    n_comm = n_comm or max(int(round(np.sqrt(n) / 2)), 2)
    labels = rng.integers(0, n_comm, n)
    same = labels[:, None] == labels[None, :]
    p = np.where(same, p_in, p_out)
    a = (rng.uniform(size=(n, n)) < p).astype(np.float32)
    a = np.triu(a, 1)
    return a + a.T
