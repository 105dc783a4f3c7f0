"""Dynamic-graph subsystem: streaming Laplacian updates, drift scoring,
and the drift-triggered refit policy.

Three layers: update tracking (stream.py), drift estimation (drift.py),
refit policy and the Lemma-1 refreshes (refit.py).  The versioned
hot-swap serving layer lives in launch/serve.py (``--dynamic``)."""
from .stream import (GraphStream, UpdateBatch, apply_update,
                     delta_adjacency, laplacian_delta, make_update_batch,
                     merge_batches)
from .drift import (drift_score, estimate_rel_residual,
                    exact_rel_residual, relative_objective)
from .refit import (Action, RefitController, RefitPolicy, lemma1_refresh,
                    prefix_spectrum)

__all__ = [
    "GraphStream", "UpdateBatch", "apply_update", "delta_adjacency",
    "laplacian_delta", "make_update_batch", "merge_batches",
    "drift_score", "estimate_rel_residual", "exact_rel_residual",
    "relative_objective",
    "Action", "RefitController", "RefitPolicy", "lemma1_refresh",
    "prefix_spectrum",
]
