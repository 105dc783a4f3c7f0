"""Roofline terms of a step, read from its eager run traced on ``meta``.

The JAX package derives its terms from the compiled XLA executable
(``cost_analysis``, ``memory_analysis`` and a walk of the optimized HLO
text).  The port has no HLO: its step runs op by op in eager mode.
``step_cost`` runs a step once under a ``TorchDispatchMode`` on ``meta``
tensors (shapes and dtypes, no memory, no card) and reads every aten op
it dispatches, the backward's and the checkpoints' recomputation
included:

  flops       the dot FLOPs (mm, bmm, addmm, baddbmm, convolution and
              the like, as ``torch.utils.flop_counter`` counts them: the
              products the JAX walker counts as dot/convolution)
  bytes       every op's tensor operands and results (each operand read
              once, each result written once; views and allocations move
              nothing): the eager step materialises every op, so this is
              its HBM traffic
  temp_bytes  the peak live bytes of the storages the step makes
  op_counts   ops by aten name

and the terms are

  compute term    = flops_per_device / PEAK_FLOPS_BF16
  memory term     = bytes_per_device / HBM_BW
  collective term = collective_bytes_per_device / NVLINK_BW

The collective bytes are counted where a sharded step runs
(``runtime/collectives.py``: the result bytes each collective delivers on
each mesh id, by kind and axes; ``collective_terms`` applies the JAX
walker's factor of 2 for an all-reduce and takes the largest id).  A
placed step run on logical devices gives them (``roofline_terms(...,
collectives=bundle.collectives)``).  A dry-run cell on the 256- or
512-id production meshes has no such run: a single-controller step over
256 shards is not feasible to trace, so there the collective keys
(``collective_bytes``, ``cross_pod_bytes``, ``collective_s``,
``cross_pod_s``, ``collective_by_kind``, ``collective_counts``) are None
and named in ``unavailable`` (ROADMAP A6d-3b), and ``dominant`` is taken
over the terms there are.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet: dense bf16 tensor-core
# peak (no sparsity), HBM3 bandwidth, HBM capacity, NVLink 4 (900 GB/s in
# both directions together: 450 GB/s a direction).  Per card.
PEAK_FLOPS_BF16 = 989.4e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
NVLINK_BW = 450e9

#: the JAX terms' collective keys, None without a run of the sharded step
UNAVAILABLE = ("collective_bytes", "cross_pod_bytes", "collective_s",
               "cross_pod_s", "collective_by_kind", "collective_counts")
UNAVAILABLE_WHY = ("counted only on a sharded step run on logical devices; "
                   "a single-controller trace of a production mesh's 256 or "
                   "512 shards is not feasible (ROADMAP A6d-3b)")
#: the kinds the JAX walker reports (the port runs the first three)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: ops that allocate without writing (their results move no bytes)
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided"}


def storage_key(t: torch.Tensor) -> int:
    """An id of ``t``'s storage, the same for every view of it while it
    lives."""
    return t.untyped_storage()._cdata


def _tensors(tree):
    """The tensors of nested dicts, lists and tuples (named ones too)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _Counter(TorchDispatchMode):
    """Counts what ``step_cost`` reports, op by op."""

    def __init__(self, arg_keys):
        super().__init__()
        self.args = arg_keys
        self.reads = set()
        self.flops = 0
        self.flops_by_op: Counter = Counter()
        self.bytes = 0
        self.ops: Counter = Counter()
        self.sizes: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        self.ops[name] += 1
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            f = int(count(*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[name] += f
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if not func.is_view:            # a view reads nothing
            for t in ins:
                key = storage_key(t)
                if key in self.args:
                    self.reads.add(key)
            if name not in _ALLOCS:
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.sizes or key in self.args:
                continue
            self.sizes[key] = st.nbytes()
            self.live += self.sizes[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def step_cost(fn: Callable, *args) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args)`` once under the counting mode: returns (its
    result, the cost).  The cost: ``flops``, ``flops_by_op``, ``bytes``,
    ``temp_bytes`` (the peak live bytes of the storages the run made),
    ``op_counts``, ``ops`` (their total) and ``reads``, the
    ``storage_key``s of the argument tensors some op read (an argument
    no op reads is not an argument of the step, as XLA prunes an unused
    jit argument).  Give it ``meta`` tensors to trace without memory."""
    arg_keys = {storage_key(t) for t in _tensors(args)}
    mode = _Counter(arg_keys)
    with mode:
        out = fn(*args)
    cost = {"flops": mode.flops, "flops_by_op": dict(mode.flops_by_op),
            "bytes": mode.bytes, "temp_bytes": mode.peak,
            "op_counts": dict(mode.ops.most_common()),
            "ops": sum(mode.ops.values()), "reads": mode.reads}
    return out, cost


def cost_summary(cost: Dict[str, Any]) -> Dict[str, float]:
    """flops / bytes of a ``step_cost`` (the whole step, every device's
    share together)."""
    return {"flops": float(cost["flops"]), "bytes": float(cost["bytes"])}


def memory_summary(*, argument: float, output: float, temp: float,
                   alias: float) -> Dict[str, float]:
    """The JAX ``memory_summary``'s keys from the dry run's per-device
    byte counts; peak live bytes count an aliased (donated) argument and
    its output once."""
    out = {"argument_size_in_bytes": float(argument),
           "output_size_in_bytes": float(output),
           "temp_size_in_bytes": float(temp),
           "generated_code_size_in_bytes": 0.0,
           "alias_size_in_bytes": float(alias)}
    out["per_device_bytes"] = (out["argument_size_in_bytes"]
                               + out["output_size_in_bytes"]
                               + out["temp_size_in_bytes"]
                               - out["alias_size_in_bytes"])
    return out


def collective_terms(counter, pod_axis: str = "pod") -> Dict[str, Any]:
    """The JAX terms' collective keys from a sharded step's
    ``collectives.Counter``: per device (the largest id's), the result
    bytes by kind (an all-reduce's twice, the JAX walker's ring factor),
    their sum, the part over a group that spans ``pod_axis``, the op
    counts by kind, and their seconds at ``NVLINK_BW``."""
    by_id, counts = {}, {}
    for i, tally in counter.bytes.items():
        kinds = dict.fromkeys(COLLECTIVES, 0)
        pod = 0
        for (kind, axes), b in tally.items():
            b *= 2 if kind == "all-reduce" else 1
            kinds[kind] += b
            if pod_axis in axes.split(","):
                pod += b
        by_id[i] = (sum(kinds.values()), pod, kinds)
        ops = dict.fromkeys(COLLECTIVES, 0)
        for (kind, _axes), n in counter.ops[i].items():
            ops[kind] += n
        counts[i] = ops
    if not by_id:
        zero = dict.fromkeys(COLLECTIVES, 0)
        return {"collective_bytes": 0, "cross_pod_bytes": 0,
                "collective_s": 0.0, "cross_pod_s": 0.0,
                "collective_by_kind": zero, "collective_counts": dict(zero)}
    top = max(by_id, key=lambda i: (by_id[i][0], -i))
    total, pod, kinds = by_id[top]
    return {"collective_bytes": total, "cross_pod_bytes": pod,
            "collective_s": total / NVLINK_BW, "cross_pod_s": pod / NVLINK_BW,
            "collective_by_kind": kinds, "collective_counts": counts[top]}


def roofline_terms(cost: Dict[str, Any], *, n_chips: int = 1,
                   collectives=None) -> Dict[str, Any]:
    """The roofline terms (seconds) and the dominant one, the JAX
    function's keys: a device's FLOPs and bytes are the traced step's
    over ``n_chips``, at the H100's rates.  ``collectives``: the counter
    of a run of the sharded step (``StepBundle.collectives``), which
    fills the collective keys; None leaves them None (``unavailable``)."""
    flops = cost["flops"] / n_chips
    nbytes = cost["bytes"] / n_chips
    terms = {"compute_s": flops / PEAK_FLOPS_BF16,
             "memory_s": nbytes / HBM_BW}
    coll = (dict.fromkeys(UNAVAILABLE) if collectives is None
            else collective_terms(collectives))
    if collectives is not None:
        terms["collective_s"] = coll["collective_s"]
    dominant = max(terms, key=terms.get)
    return {
        **terms,
        "collective_s": coll["collective_s"],
        "dominant": dominant.replace("_s", ""),
        "hlo_flops": flops,
        "hlo_bytes": nbytes,
        "collective_bytes": coll["collective_bytes"],
        "cross_pod_bytes": coll["cross_pod_bytes"],
        "cross_pod_s": coll["cross_pod_s"],
        "collective_by_kind": coll["collective_by_kind"],
        "collective_counts": coll["collective_counts"],
        "naive_cost_analysis": cost_summary(cost),
        "unavailable": [] if collectives is not None else list(UNAVAILABLE),
        "unavailable_why": None if collectives is not None
        else UNAVAILABLE_WHY,
    }


def model_flops(n_params_active: int, n_tokens: int,
                mode: str = "train") -> float:
    """MODEL_FLOPS = 6 N D (train) or 2 N D (inference forward)."""
    c = 6.0 if mode == "train" else 2.0
    return c * n_params_active * n_tokens

