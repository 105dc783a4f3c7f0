"""Logical-axis -> mesh-axis sharding rules, and fleet placement: whole
ragged-router buckets on disjoint device subsets (the JAX package's
``runtime/sharding.py``).

The model half.  Logical axes of the model zoo (``transformer.param_axes``,
``cache_axes``):
  batch     -> data parallel axes ("pod","data") / ("data",)
  vocab, heads, ff, expert, inner -> tensor/expert parallel axis ("model")
  kv_heads  -> "model" when divisible, else replicated (GQA with few KV
               heads)
  embed     -> "data" when FSDP is on; else replicated across data
  kv_seq    -> decode-time sequence parallelism for underfilled batches
  layers    -> never sharded (scan axis)
``make_rules``, ``spec_for``, ``sharding_tree``, ``batch_sharding`` and
``check_divisibility`` are the JAX functions' logic; ``PartitionSpec`` is a
tuple equal element by element to JAX's ``P(...)`` and ``NamedSharding``
gives JAX's ``shard_shape`` (a dimension its spec splits must divide, or
``ValueError``: JAX refuses such a sharding for a jitted argument too).
The dry run (``launch/dryrun.py``) reads shard shapes from these
shardings; ``NamedSharding.shard``/``gather`` place a tensor's shards on
a mesh's devices and bring them back, and ``place_tree``/``gather_tree``
do so for a whole tree (a train state: mesh id -> that id's tree of
shards).  The sharded train step (``runtime/steps.py``) keeps its state
so and runs its collectives through ``runtime/collectives.py``.

The placement half.

Serving wants the opposite of a fit's "spread one batch over
everything": each bucket, and each graph within it, lives end to end on
ONE device, so a served step needs no cross-device collective.  A
``BucketPlacement`` is a frozen, hashable record of the device ids that
own a bucket; it rides inside an ``ApplyPlan`` as part of the plan-cache
key (kernels/plan.py).  Graphs partition along the batch axis over the
bucket's devices; a batch that does not divide the device count is
padded with structural no-op rows (core/staging.py::pad_batch).

In the port one Python process drives every device: a placed tensor is
a tuple of per-device shards, ``batch_padded // D`` rows each, each its
own contiguous tensor on its device; a placed program launches once per
shard, on that device's current stream, with no host sync between the
shards, and ``gather`` concatenates the answers onto the bucket's first
device.  Serving needs no collective.

Device ids resolve through a ``launch/mesh.py::Mesh`` (``cuda:k`` on the
card, the CPU's id 0, or ``logical_devices``).  A placement built from a
mesh (``fleet_placement``) carries the torch device of each id, so it
keeps working after a ``logical_devices`` block ends; one built by hand
resolves its ids through the process's CUDA devices.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, process_devices


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# The model half: logical axes -> mesh axes
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a tensor dimension: None (whole), a mesh axis name, or a
    tuple of names (split over their product, the first the major one);
    dimensions past its length are whole.  Equal element by element to the
    JAX ``PartitionSpec``, which keeps a one-name tuple as the name and an
    empty one as None."""

    def __new__(cls, *parts):
        def canon(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, (canon(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}".replace(",)", ")")


P = PartitionSpec


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A ``PartitionSpec`` over a ``Mesh``: which part of a tensor each of
    the mesh's device ids holds."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"

    def _parts(self, ndim: int) -> list:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec!r} has {len(self.spec)} entries "
                             f"for a tensor of {ndim} dimensions")
        shape = self.mesh.shape
        return [int(np.prod([shape[a] for a in entry_axes(e)]))
                for e in self.spec] + [1] * (ndim - len(self.spec))

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The shape of the part of a ``global_shape`` tensor one device
        holds (JAX's ``NamedSharding.shard_shape``)."""
        global_shape = tuple(int(s) for s in global_shape)
        partitions = self._parts(len(global_shape))
        out = []
        for dim, (s, p) in enumerate(zip(global_shape, partitions)):
            quotient, remainder = divmod(s, p)
            if remainder != 0:
                raise ValueError(
                    f"Sharding {self} implies that array axis {dim} is "
                    f"partitioned {p} times, but the dimension size is {s} "
                    f"(full shape: {global_shape}, per-dimension tiling "
                    f"factors: {partitions} should evenly divide the shape)")
            out.append(quotient)
        return tuple(out)

    def shard_nbytes(self, tensor: torch.Tensor) -> int:
        """Bytes of one device's part of ``tensor`` (a ``meta`` tensor
        will do)."""
        return int(np.prod(self.shard_shape(tensor.shape))) * \
            tensor.element_size()

    def index(self, device_id: int) -> Tuple[int, ...]:
        """Which part of each split dimension ``device_id`` holds, one k
        for each spec entry: the id's coordinates on the entry's mesh axes
        read as one number, the first axis the major digit."""
        where = np.argwhere(self.mesh.device_ids == int(device_id))
        if not len(where):
            raise ValueError(f"device id {device_id} is not in {self.mesh}")
        coord = dict(zip(self.mesh.axis_names, where[0].tolist()))
        shape = self.mesh.shape
        out = []
        for entry in self.spec:
            k = 0
            for a in entry_axes(entry):
                k = k * shape[a] + coord[a]
            out.append(k)
        return tuple(out)

    def dim_of(self, axis: str) -> Optional[int]:
        """The dimension the mesh axis ``axis`` splits (None: none)."""
        for dim, entry in enumerate(self.spec):
            if axis in entry_axes(entry):
                return dim
        return None

    def part(self, tensor: torch.Tensor, device_id: int) -> torch.Tensor:
        """``device_id``'s part of the whole ``tensor``, a view."""
        q = self.shard_shape(tensor.shape)
        for dim, k in enumerate(self.index(device_id)):
            tensor = tensor.narrow(dim, k * q[dim], q[dim])
        return tensor

    def shard(self, tensor: torch.Tensor) -> Dict[int, torch.Tensor]:
        """device id -> its part of ``tensor``, a contiguous copy on that
        id's device (every id of the mesh; a replicated dimension whole)."""
        return {i: self.part(tensor, i).to(self.mesh.device(i), copy=True)
                .contiguous() for i in self.mesh.device_ids.ravel().tolist()}

    def gather(self, shards: Mapping[int, torch.Tensor],
               host: bool = False) -> torch.Tensor:
        """The tensor ``shard`` split, put together on the first id's
        device (``host``: in host memory) from one holder of each part."""
        ids = self.mesh.device_ids.ravel().tolist()
        first = shards[ids[0]]
        parts = self._parts(first.dim())
        out = torch.empty([s * p for s, p in zip(first.shape, parts)],
                          dtype=first.dtype,
                          device="cpu" if host else first.device)
        done = set()
        for i in ids:
            where = self.index(i)
            if where in done:
                continue
            done.add(where)
            view = out
            for dim, k in enumerate(where):
                q = first.shape[dim]
                view = view.narrow(dim, k * q, q)
            view.copy_(shards[i])
        return out


def make_rules(mesh: Mesh, cfg, *, fsdp: bool = False,
               seq_shard: bool = False,
               global_batch: Optional[int] = None) -> Dict[Any, Any]:
    """Logical axis -> mesh axis (or tuple of axes, or None) for ``cfg`` on
    ``mesh``, the JAX ``make_rules``."""
    tp = mesh.shape.get("model", 1)
    dp = dp_axes(mesh)
    fsdp_n = mesh.shape.get("data", 1)

    def fits(dim: int) -> bool:
        return dim > 0 and dim % tp == 0

    # batch: drop data-parallel axes until the global batch divides (decode
    # at batch=1 falls back to a replicated batch + KV-seq sharding)
    batch_rule: Any = dp
    if global_batch is not None:
        while batch_rule and global_batch % int(
                np.prod([mesh.shape[a] for a in batch_rule])) != 0:
            batch_rule = batch_rule[:-1]
        batch_rule = batch_rule or None

    return {
        "batch": batch_rule,
        "vocab": "model" if fits(cfg.vocab) else None,
        "heads": "model" if fits(cfg.n_heads) else None,
        "kv_heads": "model" if fits(cfg.n_kv_heads) else None,
        "ff": "model" if fits(cfg.d_ff) else None,
        "expert": "model" if fits(cfg.n_experts) else None,
        "inner": "model",
        "embed": ("data" if fsdp and cfg.d_model % fsdp_n == 0 else None),
        "kv_seq": "data" if seq_shard else None,
        "layers": None,
        None: None,
    }


def spec_for(axes, rules) -> PartitionSpec:
    """Map logical axes to a PartitionSpec, deduplicating mesh axes.

    A mesh axis may appear at most once in a spec; the first logical axis
    (left-to-right) claims it (e.g. MoE expert weights ("expert", "embed",
    "ff") -> P("model", ..., None): "expert" wins the "model" axis and the
    per-expert ff dim stays unsharded)."""
    used = set()
    out = []
    for a in axes:
        r = rules.get(a)
        items = r if isinstance(r, tuple) else (r,) if r else ()
        if any(m in used for m in items):
            out.append(None)
        else:
            used.update(items)
            out.append(r)
    return PartitionSpec(*out)


def _tree_map(fn, tree):
    """fn over the ``Axes`` leaves of nested dicts, named tuples, tuples
    and lists; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def sharding_tree(axes_tree, mesh: Mesh, rules) -> Any:
    """Map an Axes-leaf tree to a NamedSharding tree (same structure)."""
    return _tree_map(lambda leaf: NamedSharding(mesh, spec_for(leaf.axes,
                                                               rules)),
                     axes_tree)


def batch_sharding(mesh: Mesh, rules, *, with_memory=False,
                   mode: str = "train") -> Dict[str, NamedSharding]:
    """Shardings for input batches."""
    bsp = rules["batch"]
    tok = NamedSharding(mesh, P(bsp, None))
    if mode in ("train", "prefill"):
        out = {"tokens": tok}
        if with_memory:
            out["memory"] = NamedSharding(mesh, P(bsp, None, None))
        return out
    out = {"token": tok, "pos": NamedSharding(mesh, P(bsp))}
    if with_memory:
        out["memory"] = NamedSharding(mesh, P(bsp, None, None))
    return out


def _first_sharding(shardings) -> Optional[NamedSharding]:
    if isinstance(shardings, NamedSharding):
        return shardings
    if isinstance(shardings, dict):
        shardings = list(shardings.values())
    if isinstance(shardings, (list, tuple)):
        for s in shardings:
            found = _first_sharding(s)
            if found is not None:
                return found
    return None


def place_tree(tree, shardings) -> Dict[int, Any]:
    """A tree of tensors placed by a tree of ``NamedSharding``s of the
    same structure (dicts, named tuples, tuples, lists; None stays None):
    mesh id -> that id's tree of shards (``NamedSharding.shard``: each
    its own contiguous copy on its id's device, also where several ids
    share one device, so that an in-place update of one id's shard never
    writes another's).  The leaves are placed one at a time."""
    ids = _first_sharding(shardings).mesh.device_ids.ravel().tolist()

    def rec(values, sh):
        if values is None:
            return dict.fromkeys(ids)
        if isinstance(values, dict):
            parts = {k: rec(values[k], sh[k]) for k in values}
            return {i: {k: parts[k][i] for k in values} for i in ids}
        if isinstance(values, (list, tuple)):
            parts = [rec(v, s) for v, s in zip(values, sh)]
            build = (type(values) if hasattr(values, "_fields")
                     else lambda *xs: type(values)(xs))
            return {i: build(*(p[i] for p in parts)) for i in ids}
        return sh.shard(torch.as_tensor(values))

    return rec(tree, shardings)


def gather_tree(placed: Mapping[int, Any], shardings,
                host: bool = False) -> Any:
    """The tree ``place_tree`` split, put together on the first id's
    device (``host``: in host memory; ``NamedSharding.gather``, leaf by
    leaf)."""
    ids = sorted(placed)

    def rec(parts, sh):
        first = parts[ids[0]]
        if first is None:
            return None
        if isinstance(first, dict):
            return {k: rec({i: parts[i][k] for i in ids}, sh[k])
                    for k in first}
        if isinstance(first, (list, tuple)):
            out = [rec({i: parts[i][j] for i in ids}, sh[j])
                   for j in range(len(first))]
            return (type(first)(*out) if hasattr(first, "_fields")
                    else type(first)(out))
        return sh.gather(parts, host)

    return rec(placed, shardings)


def placed_nbytes(placed: Mapping[int, Any]) -> Dict[int, int]:
    """mesh id -> bytes of the tensors its tree holds."""
    def nbytes(tree) -> int:
        if tree is None:
            return 0
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    return {i: nbytes(t) for i, t in placed.items()}


def check_divisibility(cfg, mesh: Mesh, global_batch: int, mode: str):
    """Human-readable divisibility report (surfaced by the dry-run)."""
    tp = mesh.shape.get("model", 1)
    dp = int(np.prod([mesh.shape[a] for a in dp_axes(mesh)]))
    notes = []
    if global_batch % dp != 0:
        notes.append(f"batch {global_batch} not divisible by dp={dp}: "
                     "falls back to sequence/KV sharding where possible")
    if cfg.n_heads and cfg.n_heads % tp != 0:
        notes.append(f"heads {cfg.n_heads} % tp={tp} != 0 (padded shards)")
    if cfg.n_kv_heads and cfg.n_kv_heads % tp != 0:
        notes.append(f"kv_heads {cfg.n_kv_heads} < tp={tp}: KV replicated")
    if cfg.n_experts and cfg.n_experts % tp != 0:
        notes.append(f"experts {cfg.n_experts} % tp={tp} != 0")
    return notes


# ---------------------------------------------------------------------------
# The placement half: whole ragged-router buckets -> disjoint device subsets
# ---------------------------------------------------------------------------


class BatchSharding(NamedTuple):
    """How a leading matrix-batch axis splits over a mesh: ``axes``, the
    data-parallel axes it spreads over (None: replicated), and
    ``shards``, the product of their sizes."""
    axes: Optional[Tuple[str, ...]]
    shards: int


def matrix_batch_sharding(mesh: Mesh, ndim: int,
                          batch: Optional[int] = None) -> BatchSharding:
    """The split of a leading matrix-batch axis (B matrices, tables or
    signal blocks) over the mesh's data-parallel axes; every other axis
    of the ``ndim``-d operand stays whole.

    ``batch``: the leading-dim size; the largest (order-preserving)
    subset of data-parallel axes whose product divides it is used, so an
    awkward B degrades to partial sharding or replication instead of
    raising (e.g. (pod=4, data=2) with B=6 shards over "data" alone)."""
    del ndim                        # the JAX signature's; every axis but 0
    dp = dp_axes(mesh)
    if batch is not None:
        best, best_p = (), 1
        for r in range(len(dp), 0, -1):
            for combo in itertools.combinations(dp, r):
                p = int(np.prod([mesh.shape[a] for a in combo]))
                if p > best_p and batch % p == 0:
                    best, best_p = combo, p
        dp = best
    shards = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1
    return BatchSharding(tuple(dp) or None, shards)


def batch_shard_ids(mesh: Mesh, batch: int) -> Tuple[int, ...]:
    """The device ids a (batch, ...) operand's shards go to, in batch
    order: the mesh's devices along ``matrix_batch_sharding``'s axes,
    every other axis at index 0 (one id when replicated)."""
    axes = matrix_batch_sharding(mesh, 3, batch=batch).axes or ()
    idx = tuple(slice(None) if a in axes else 0 for a in mesh.axis_names)
    return tuple(int(i) for i in np.asarray(mesh.device_ids[idx]).ravel())


def assign_buckets(num_devices: int, bucket_sizes: Mapping[Any, int],
                   weights: Optional[Mapping[Any, float]] = None,
                   ) -> Dict[Any, Tuple[int, ...]]:
    """Pure assignment logic: bucket key -> device *indices* 0..D-1.

    Deterministic greedy proportional allocation (largest
    weight-per-allocated-device next), contiguous disjoint ranges, each
    bucket at least one device, never more devices than the bucket has
    graphs (extra devices would only serve padding).  With more buckets
    than devices, buckets share devices round-robin.  ``weights``
    defaults to the bucket batch sizes; the ragged router passes
    batch x width so wide buckets get proportionally more devices."""
    if num_devices <= 0:
        raise ValueError(f"assign_buckets: num_devices={num_devices} "
                         "must be positive")
    keys = sorted(bucket_sizes)
    if not keys:
        return {}
    if any(bucket_sizes[k] <= 0 for k in keys):
        bad = {k: bucket_sizes[k] for k in keys if bucket_sizes[k] <= 0}
        raise ValueError(f"assign_buckets: empty buckets {bad}")
    if len(keys) > num_devices:
        return {k: (i % num_devices,) for i, k in enumerate(keys)}
    w = np.array([float((weights or bucket_sizes)[k]) for k in keys])
    w = np.maximum(w, 1e-9)
    cap = np.array([int(bucket_sizes[k]) for k in keys])
    alloc = np.ones(len(keys), dtype=int)
    for _ in range(num_devices - len(keys)):
        score = w / alloc
        score[alloc >= cap] = -1.0
        i = int(np.argmax(score))
        if score[i] < 0:
            break  # every bucket saturated: surplus devices stay idle
        alloc[i] += 1
    out: Dict[Any, Tuple[int, ...]] = {}
    nxt = 0
    for k, a in zip(keys, alloc):
        out[k] = tuple(range(nxt, nxt + int(a)))
        nxt += int(a)
    return out


def data_devices(mesh: Mesh) -> list:
    """The mesh's data-parallel device ids (non-DP axes indexed at 0):
    the pool ``fleet_placement`` carves bucket subsets out of."""
    idx = tuple(slice(None) if a in ("pod", "data") else 0
                for a in mesh.axis_names)
    return [int(i) for i in np.asarray(mesh.device_ids[idx]).ravel()]


def _submesh(device_ids: Tuple[int, ...],
             devices: Optional[Tuple[str, ...]] = None) -> Mesh:
    """A one-axis ("data",) mesh over ``device_ids``: their given torch
    devices, else the process's CUDA devices of those ids."""
    if devices is not None:
        by_id = {i: torch.device(d) for i, d in zip(device_ids, devices)}
    else:
        by_id = process_devices("cuda")
        missing = [i for i in device_ids if i not in by_id]
        if missing:
            raise ValueError(
                f"placement names device ids {missing} but this process "
                f"has {len(by_id)} device(s) (ids {sorted(by_id)}); "
                "re-place with fleet_placement on the current mesh")
    return Mesh(np.array(device_ids), ("data",), by_id)


@dataclass(frozen=True)
class BucketPlacement:
    """Which global device ids own one bucket, and its true batch size.

    Frozen and tuple-valued, so hashable: plans carrying a placement stay
    valid cache keys.  ``batch_padded`` is the serving-time leading dim:
    the smallest multiple of the device count >= batch (pad rows are
    structural no-ops, see staging.pad_batch).  ``devices``: the torch
    device of each id (None: resolved through the process's CUDA devices
    when used)."""
    device_ids: Tuple[int, ...]
    batch: int
    devices: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "device_ids",
                           tuple(int(i) for i in self.device_ids))
        if not self.device_ids:
            raise ValueError("BucketPlacement needs at least one device")
        if self.batch <= 0:
            raise ValueError(f"BucketPlacement: batch={self.batch}")
        if self.devices is not None:
            devs = tuple(str(torch.device(d)) for d in self.devices)
            if len(devs) != len(self.device_ids):
                raise ValueError(f"BucketPlacement: {len(devs)} devices for "
                                 f"{len(self.device_ids)} device ids")
            object.__setattr__(self, "devices", devs)

    @property
    def num_devices(self) -> int:
        return len(self.device_ids)

    @property
    def batch_padded(self) -> int:
        d = self.num_devices
        return -(-self.batch // d) * d

    @property
    def rows(self) -> int:
        """Batch rows of each device's shard."""
        return self.batch_padded // self.num_devices

    def mesh(self) -> Mesh:
        return _submesh(self.device_ids, self.devices)

    def torch_devices(self) -> Tuple[torch.device, ...]:
        """The torch device of each shard, in shard order."""
        if self.devices is not None:
            return tuple(torch.device(d) for d in self.devices)
        mesh = self.mesh()
        return tuple(mesh.device(i) for i in self.device_ids)

    def place(self, arr) -> tuple:
        """Pad axis 0 with zero rows to ``batch_padded`` and split it into
        one shard per device.

        For staged tables use staging.pad_batch first (pads are identity
        transforms there, not zeros) and place the leaves with
        ``place_leaf``/``place_leaves``."""
        arr = torch.as_tensor(arr)
        pad = self.batch_padded - arr.shape[0]
        if pad > 0:
            arr = torch.cat([arr, arr.new_zeros((pad,) + arr.shape[1:])])
        elif arr.shape[0] != self.batch_padded:
            raise ValueError(
                f"place: leading dim {arr.shape[0]} exceeds "
                f"batch_padded={self.batch_padded}")
        return self._split(arr)

    def place_leaf(self, arr) -> tuple:
        """Split an already padded leaf into its shards (no shape
        change)."""
        arr = torch.as_tensor(arr)
        if arr.shape[0] != self.batch_padded:
            raise ValueError(
                f"place_leaf: leading dim {arr.shape[0]} != "
                f"batch_padded={self.batch_padded}")
        return self._split(arr)

    def place_leaves(self, leaves) -> tuple:
        """A tuple of padded leaves (a table tuple) as one tuple of leaves
        per shard: ``out[k]`` is shard k's table tuple."""
        split = [self.place_leaf(a) for a in leaves]
        return tuple(tuple(s[k] for s in split)
                     for k in range(self.num_devices))

    def _split(self, arr: torch.Tensor) -> tuple:
        # every shard is a copy of its own, also where it stays on the
        # array's device: the launcher keeps entry streams, casts and
        # extents beside the tensors they come from, one set per shard
        r = self.rows
        return tuple(arr[k * r:(k + 1) * r].to(dev, copy=True).contiguous()
                     for k, dev in enumerate(self.torch_devices()))

    def gather(self, shards) -> torch.Tensor:
        """The shards' answers concatenated on the bucket's first device
        (padded: crop with ``crop``)."""
        first = self.torch_devices()[0]
        return torch.cat([s.to(first) for s in shards])

    def crop(self, y):
        """Drop the pad rows of a gathered answer."""
        return y if self.batch_padded == self.batch else y[:self.batch]


class FleetPlacement:
    """Bucket key -> BucketPlacement over one serving mesh (disjoint
    device subsets; a bucket's refit can only occupy its own devices)."""

    def __init__(self, buckets: Mapping[Any, BucketPlacement],
                 num_devices: int):
        self.buckets = dict(buckets)
        self.num_devices = int(num_devices)

    def __getitem__(self, key) -> BucketPlacement:
        return self.buckets[key]

    def __contains__(self, key) -> bool:
        return key in self.buckets

    def items(self):
        return self.buckets.items()

    def manifest(self) -> Dict[str, Any]:
        """JSON-serializable placement record for shard-aware checkpoints
        (the JAX package's dict)."""
        return {
            "num_devices": self.num_devices,
            "buckets": {str(k): {"device_ids": list(p.device_ids),
                                 "batch": p.batch}
                        for k, p in self.buckets.items()},
        }


def fleet_placement(mesh: Mesh, bucket_sizes: Mapping[Any, int],
                    weights: Optional[Mapping[Any, float]] = None,
                    ) -> FleetPlacement:
    """Assign whole ragged-router buckets to the mesh's data-axis devices.

    Each bucket gets a contiguous, disjoint device subset sized by
    ``weights`` (default: batch count; the router passes batch x width).
    Within a bucket, whole graphs partition along the batch axis over the
    subset; no tensor is ever split across devices."""
    devs = data_devices(mesh)
    assignment = assign_buckets(len(devs), bucket_sizes, weights)
    buckets = {
        k: BucketPlacement(
            device_ids=tuple(devs[i] for i in idxs),
            batch=int(bucket_sizes[k]),
            devices=tuple(str(mesh.device(devs[i])) for i in idxs))
        for k, idxs in assignment.items()}
    return FleetPlacement(buckets, num_devices=len(devs))


def single_bucket_placement(mesh: Mesh, batch: int) -> BucketPlacement:
    """All data-axis devices as one bucket (the non-ragged engine)."""
    return fleet_placement(mesh, {"all": batch})["all"]
