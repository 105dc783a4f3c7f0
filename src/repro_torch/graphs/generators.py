"""Synthetic graph generators (numpy): the paper's experimental families
(GSP-box community, Erdos-Renyi p = 0.3, sensor kNN), their directed
variants (each edge kept in one direction, §5 Fig. 1 bottom), offline
stand-ins of the size and edge count of the four real graphs of Fig. 2,
and evolving-graph update streams for the dynamic subsystem.  The same
seed gives the same arrays as the JAX package's generators, bitwise."""
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


def erdos_renyi(n: int, p: float = 0.3, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = (rng.uniform(size=(n, n)) < p).astype(np.float32)
    a = np.triu(a, 1)
    return a + a.T


def sensor_graph(n: int, k: int = 6, seed: int = 0) -> np.ndarray:
    """Random points in the unit square, k-nearest-neighbour edges."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    a = np.zeros((n, n), np.float32)
    nn = np.argsort(d2, axis=1)[:, :k]
    rows = np.repeat(np.arange(n), k)
    a[rows, nn.ravel()] = 1.0
    return np.maximum(a, a.T)   # symmetrize kNN


def directed_variant(adj: np.ndarray, seed: int = 0) -> np.ndarray:
    """Directed graph from an undirected one: each edge keeps exactly one
    direction, chosen with probability 0.5 (paper Fig. 1, bottom row)."""
    rng = np.random.default_rng(seed)
    upper = np.triu(adj, 1)
    coin = rng.uniform(size=adj.shape) < 0.5  # one decision per (i<j) edge
    kept = np.where(coin, upper, 0)           # i -> j
    flipped = (upper - kept).T                # j -> i for the other edges
    return (kept + flipped).astype(np.float32)


def real_graph_standin(name: str, seed: int = 0) -> np.ndarray:
    """Offline stand-ins with the size/edge-count of the paper's Fig. 2
    graphs (Minnesota / HumanProtein / Email / Facebook). The container has
    no network access, so topology is synthesized to match (n, |E|, family);
    the same seed gives the JAX package's stand-in bitwise."""
    spec = {
        # name: (n, edges, family)
        "minnesota": (2642, 3304, "sensor"),      # road network ~ planar kNN
        "human_protein": (3133, 6726, "scalefree"),
        "email": (1133, 5451, "scalefree"),
        "facebook": (2888, 2981, "community"),
    }[name]
    n, m_target, family = spec
    rng = np.random.default_rng(seed)
    if family == "sensor":
        a = sensor_graph(n, k=3, seed=seed)
    elif family == "community":
        a = community_graph(n, n_comm=40, p_in=0.03, p_out=0.0002, seed=seed)
    else:  # preferential attachment (scale-free)
        a = np.zeros((n, n), np.float32)
        deg = np.ones(n)
        for v in range(1, n):
            k = 2 if v > 2 else 1
            p = deg[:v] / deg[:v].sum()
            targets = rng.choice(v, size=min(k, v), replace=False, p=p)
            for t in targets:
                a[v, t] = a[t, v] = 1.0
                deg[v] += 1
                deg[t] += 1
    # trim/grow edges toward the target count (keep connectivity bias)
    edges = np.argwhere(np.triu(a, 1) > 0)
    m_now = len(edges)
    if m_now > m_target:
        drop = rng.choice(m_now, m_now - m_target, replace=False)
        for e in drop:
            i, j = edges[e]
            a[i, j] = a[j, i] = 0.0
    elif m_now < m_target:
        need = m_target - m_now
        while need > 0:
            i, j = rng.integers(0, n, 2)
            if i != j and a[i, j] == 0:
                a[i, j] = a[j, i] = 1.0
                need -= 1
    return a


# ---------------------------------------------------------------------------
# Evolving-graph streams: update batches for the dynamic subsystem.
# Generators return repro_torch.dynamic.stream.UpdateBatch objects; the
# import is deferred so the static generators above stay usable without
# the dynamic subsystem loaded.
# ---------------------------------------------------------------------------


def edge_perturbation(adj: np.ndarray, num_edges: int, seed: int = 0,
                      weight: float = 1.0, p_delete: float = 0.5,
                      directed: bool = False):
    """One update batch perturbing up to ``num_edges`` edge SLOTS of
    ``adj``: existing edges are deleted (probability ``p_delete``) or
    reweighted, absent pairs gain a fresh edge of weight ``weight``.

    Invariants: a symmetric adjacency stays
    symmetric under the batch (each pair appears once, mirror implied);
    a ``directed_variant`` graph keeps at most ONE direction per pair
    (inserts pick pairs with no edge in either direction and choose one
    direction at random; deletes/reweights touch the stored direction);
    the batch touches at most ``num_edges`` slots (delta sparsity is
    bounded by the requested churn)."""
    from repro_torch.dynamic.stream import make_update_batch
    adj = np.asarray(adj, np.float32)
    n = adj.shape[0]
    rng = np.random.default_rng(seed)
    either = np.maximum(adj, adj.T)             # pair occupancy, any direction
    iu, ju = np.triu_indices(n, 1)
    occupied = either[iu, ju] > 0
    # candidate slots: every (i < j) pair; sample without replacement so
    # one batch never touches the same pair twice
    take = min(int(num_edges), iu.size)
    pick = rng.choice(iu.size, size=take, replace=False)
    src, dst, dw = [], [], []
    for e in pick:
        a, b = int(iu[e]), int(ju[e])
        if occupied[e]:
            # the stored direction (symmetric graphs store both; emit the
            # upper entry once, the batch mirrors it)
            if not directed or adj[a, b] > 0:
                i, j = a, b
            else:
                i, j = b, a
            w_old = float(adj[i, j])
            if rng.uniform() < p_delete:
                delta = -w_old                   # delete: exact removal
            else:
                delta = float(rng.uniform(0.25, 1.0)) * weight - w_old
                if delta == 0.0:
                    continue
        else:
            if directed and rng.uniform() < 0.5:
                i, j = b, a                      # fresh edge, one direction
            else:
                i, j = a, b
            delta = float(weight)
        src.append(i)
        dst.append(j)
        dw.append(delta)
    return make_update_batch(src, dst, dw, symmetric=not directed)


def weight_jitter(adj: np.ndarray, num_edges: int, scale: float = 0.2,
                  seed: int = 0, directed: bool = False):
    """Reweight-only update batch: up to ``num_edges`` EXISTING edges get
    a relative weight nudge ``dw = uniform(-scale, scale) * w`` (never
    crossing zero, so topology is untouched).  This is the gentle end of
    the update spectrum — a Lemma-1 spectrum refresh absorbs it almost
    completely, whereas inserts/deletes rotate eigenvectors and need
    structural refit work (dynamic/refit.py)."""
    from repro_torch.dynamic.stream import make_update_batch
    if not 0.0 < scale < 1.0:
        raise ValueError(f"scale must be in (0, 1) so reweights never "
                         f"cross zero, got {scale}")
    adj = np.asarray(adj, np.float32)
    rng = np.random.default_rng(seed)
    ii, jj = np.nonzero(np.triu(adj, 1) if not directed else adj)
    take = min(int(num_edges), ii.size)
    if take == 0:
        return make_update_batch([], [], [], symmetric=not directed)
    pick = rng.choice(ii.size, size=take, replace=False)
    i, j = ii[pick], jj[pick]
    dw = rng.uniform(-scale, scale, take).astype(np.float32) * adj[i, j]
    return make_update_batch(i, j, dw, symmetric=not directed)


def evolving_erdos_renyi(n: int, p: float = 0.3, churn: float = 0.05,
                         steps: int = 10, seed: int = 0,
                         directed: bool = False, weight: float = 1.0):
    """An evolving Erdős–Rényi stream: the initial adjacency plus
    ``steps`` update batches, each perturbing at most
    ``ceil(churn * n(n-1)/2)`` edge slots (insert/delete/reweight mix).

    Returns ``(adj0, batches)``; replay the stream with
    ``repro_torch.dynamic.GraphStream([adj0], directed=directed)`` — the
    batches were generated against the evolving adjacency, so applying
    them in order reproduces the generator's internal trajectory
    exactly."""
    from repro_torch.dynamic.stream import apply_update
    if not 0.0 < churn <= 1.0:
        raise ValueError(f"churn must be in (0, 1], got {churn}")
    adj0 = erdos_renyi(n, p, seed=seed)
    if directed:
        adj0 = directed_variant(adj0, seed=seed)
    budget = max(int(np.ceil(churn * n * (n - 1) / 2)), 1)
    adj = adj0.copy()
    batches = []
    for t in range(int(steps)):
        batch = edge_perturbation(adj, budget, seed=seed + 1 + t,
                                  weight=weight, directed=directed)
        batches.append(batch)
        adj = apply_update(adj, batch)
    return adj0, batches


GRAPHS = {
    "community": community_graph,
    "erdos_renyi": erdos_renyi,
    "sensor": sensor_graph,
}
