"""Synthetic graph generators (numpy): the GSP-box community family the
paper's experiments and the FGFT service use, and its directed variant.
The same seed gives the same adjacency as the JAX package's
generators."""
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


def directed_variant(adj: np.ndarray, seed: int = 0) -> np.ndarray:
    """Directed graph from an undirected one: each edge keeps exactly one
    direction, chosen with probability 0.5 (paper Fig. 1, bottom row)."""
    rng = np.random.default_rng(seed)
    upper = np.triu(adj, 1)
    coin = rng.uniform(size=adj.shape) < 0.5  # one decision per (i<j) edge
    kept = np.where(coin, upper, 0)           # i -> j
    flipped = (upper - kept).T                # j -> i for the other edges
    return (kept + flipped).astype(np.float32)
