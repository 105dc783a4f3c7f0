"""Streaming graph updates: edge batches as Laplacian deltas.

Real graph fleets (social, traffic, sensor networks) evolve edge-by-edge
while the serving layer keeps answering queries.  This module is the
UPDATE-TRACKING layer of the dynamic subsystem: it
represents a batch of edge inserts/deletes/reweights as an
``UpdateBatch``, maintains the current weighted adjacency ``W`` per graph
(``GraphStream``), and converts batches into dense Laplacian deltas
``ΔL = D(ΔW) - ΔW`` so the serving engines (launch/serve.py
``apply_updates``) never re-derive a Laplacian from scratch.  Plain numpy,
bitwise the JAX package's stream under the same batches.

Conventions match core/fgft.py::laplacian: ``L = D - W`` with out-degree
``D`` (row sums), so a delta built here composes exactly:
``laplacian(W + ΔW) == laplacian(W) + laplacian_delta(batch, n)``.
Symmetric batches mirror every (i, j) entry to (j, i); directed batches
touch exactly the one stored direction per edge (the one-direction-per-
edge invariant of graphs/generators.py::directed_variant is preserved by
construction — see ``edge_perturbation``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np


class UpdateBatch(NamedTuple):
    """A batch of edge-weight deltas for ONE graph.

    ``i``/``j``: (E,) int endpoint indices (i != j; for symmetric batches
    each pair appears ONCE, the mirror entry is implied).  ``dw``: (E,)
    float weight deltas — ``+w`` inserts an edge, ``-w_old`` deletes one,
    any other value reweights.  ``symmetric`` marks whether the mirror
    entry (j, i) receives the same delta.
    """

    i: np.ndarray
    j: np.ndarray
    dw: np.ndarray
    symmetric: bool = True

    @property
    def num_edges(self) -> int:
        """Number of edge slots this batch touches (mirror implied)."""
        return int(np.asarray(self.i).shape[0])


def make_update_batch(i, j, dw, symmetric: bool = True) -> UpdateBatch:
    """Validated ``UpdateBatch`` constructor (rejects self-loops and
    ragged component lengths; canonicalizes dtypes)."""
    i = np.asarray(i, np.int64).ravel()
    j = np.asarray(j, np.int64).ravel()
    dw = np.asarray(dw, np.float32).ravel()
    if not (i.shape == j.shape == dw.shape):
        raise ValueError(f"i/j/dw must have one length, got "
                         f"{i.shape}/{j.shape}/{dw.shape}")
    if i.size and (np.any(i == j) or np.any(i < 0) or np.any(j < 0)):
        raise ValueError("edge updates must be off-diagonal with "
                         "non-negative indices")
    return UpdateBatch(i, j, dw, bool(symmetric))


def _check_bounds(batch: UpdateBatch, n: int):
    i, j = np.asarray(batch.i), np.asarray(batch.j)
    if i.size and (i.max() >= n or j.max() >= n):
        raise ValueError(f"edge update touches coordinate "
                         f">= n={n}: max index "
                         f"{int(max(i.max(), j.max()))}")


def delta_adjacency(batch: UpdateBatch, n: int) -> np.ndarray:
    """Dense (n, n) adjacency delta ΔW of one batch (mirrored when
    symmetric).  Duplicate (i, j) entries accumulate."""
    _check_bounds(batch, n)
    dw = np.zeros((n, n), np.float32)
    np.add.at(dw, (batch.i, batch.j), batch.dw)
    if batch.symmetric:
        np.add.at(dw, (batch.j, batch.i), batch.dw)
    return dw


def laplacian_delta(batch: UpdateBatch, n: int) -> np.ndarray:
    """Dense (n, n) Laplacian delta ΔL = D(ΔW) - ΔW (out-degree D), so
    the tracked Laplacian updates as ``L += laplacian_delta(batch, n)``
    without re-deriving ``D - W`` from the full adjacency."""
    dw = delta_adjacency(batch, n)
    return (np.diag(dw.sum(axis=1)) - dw).astype(np.float32)


def apply_update(adj: np.ndarray, batch: UpdateBatch) -> np.ndarray:
    """New adjacency ``W + ΔW`` (pure; the input is not mutated).
    Tiny residuals from float cancellation are snapped to zero AT THE
    TOUCHED SLOTS ONLY, so a delete (``dw = -w_old``) restores an exact
    structural zero without disturbing legitimate tiny-weight edges
    elsewhere in the graph."""
    adj = np.asarray(adj, np.float32)
    out = adj + delta_adjacency(batch, adj.shape[0])
    if batch.num_edges:
        i = np.asarray(batch.i)
        j = np.asarray(batch.j)
        if batch.symmetric:
            i, j = np.concatenate([i, j]), np.concatenate([j, i])
        snap = np.abs(out[i, j]) < 1e-7
        out[i[snap], j[snap]] = 0.0
    return out


class GraphStream:
    """Tracks the CURRENT weighted adjacency of every graph in an
    evolving fleet, handing Laplacians (and Laplacian deltas) to the
    serving layer.

    ``adjs``: sequence of (n_b, n_b) adjacency matrices (sizes may
    differ — the stream is ragged-friendly; bucketing is the serving
    router's business).  ``directed`` marks the whole fleet: batches
    applied to a directed stream must carry ``symmetric=False``.
    """

    def __init__(self, adjs: Sequence[np.ndarray], directed: bool = False):
        self.adjs = [np.asarray(a, np.float32).copy() for a in adjs]
        for a in self.adjs:
            if a.ndim != 2 or a.shape[0] != a.shape[1]:
                raise ValueError(f"adjacency must be square, got {a.shape}")
        self.directed = bool(directed)
        self.updates_applied = np.zeros(len(self.adjs), np.int64)

    def __len__(self) -> int:
        return len(self.adjs)

    @property
    def sizes(self) -> list:
        return [a.shape[0] for a in self.adjs]

    def laplacian(self, graph_id: int) -> np.ndarray:
        from repro_torch.core.fgft import laplacian
        return laplacian(self.adjs[graph_id])

    def laplacians(self) -> list:
        """Current Laplacians, request order (ragged list)."""
        return [self.laplacian(g) for g in range(len(self.adjs))]

    def apply(self, graph_id: int, batch: UpdateBatch) -> np.ndarray:
        """Apply one update batch to graph ``graph_id``; returns the
        dense Laplacian delta ΔL to forward to a serving engine's
        ``apply_updates`` (the stream and the engine stay in lockstep
        from the same batch)."""
        if batch.symmetric == self.directed:
            raise ValueError(
                f"batch symmetric={batch.symmetric} does not match "
                f"directed={self.directed} stream")
        n = self.adjs[graph_id].shape[0]
        dl = laplacian_delta(batch, n)
        self.adjs[graph_id] = apply_update(self.adjs[graph_id], batch)
        self.updates_applied[graph_id] += 1
        return dl


def merge_batches(batches: Sequence[UpdateBatch]) -> Optional[UpdateBatch]:
    """Concatenate update batches (same symmetry) into one; None when
    empty — lets a caller coalesce several small deltas into a single
    ``apply_updates`` call."""
    batches = [b for b in batches if b.num_edges]
    if not batches:
        return None
    sym = batches[0].symmetric
    if any(b.symmetric != sym for b in batches):
        raise ValueError("cannot merge symmetric and directed batches")
    return UpdateBatch(np.concatenate([b.i for b in batches]),
                       np.concatenate([b.j for b in batches]),
                       np.concatenate([b.dw for b in batches]), sym)
