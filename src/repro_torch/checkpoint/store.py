"""Atomic checkpoints: npz leaves + a JSON manifest, committed by a marker.

Layout (the JAX package's, so either package restores the other's
checkpoints)::

  <dir>/step_000000123/
    manifest.json     # leaf paths, keys, shapes, dtypes, metadata
    leaves_000.npz    # leaf arrays (leaves_001.npz ... with shards > 1)
  <dir>/step_000000123.COMMITTED   # marker written LAST

A checkpoint is written into ``step_%09d.tmp``, renamed into place, and
only then marked committed: restore ignores a step without its marker,
so a writer killed at any point never corrupts a later resume.

State trees are nested dicts, lists, tuples and NamedTuples whose leaves
are tensors or numpy arrays.  Leaves are flattened in the JAX package's
pytree order (dict keys sorted, NamedTuple fields in declaration order,
``None`` dropped) and named by the path string ``jax.tree_util.keystr``
gives (``['factors'].i``, ``['spectrum']``); dtype strings are numpy's.

As the JAX store does, it counts saves and restores
(``checkpoint_saves_total``, ``checkpoint_restores_total``) and traces
each as a ``checkpoint_save`` / ``checkpoint_restore`` span (cat
``checkpoint``) in the port's observability layer (``repro_torch.obs``).
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

_STEP_RE = re.compile(r"step_(\d+)$")

# checkpoint I/O telemetry: counters in the registry, one timed span per
# save/restore in the trace
_OBS_SAVES = obs.counter("checkpoint_saves_total",
                         "committed checkpoint saves")
_OBS_RESTORES = obs.counter("checkpoint_restores_total",
                            "checkpoint restores")


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in pytree order, paths as ``keystr`` writes
    them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _tree_paths(tree[key], f"{prefix}[{key!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name, child in zip(tree._fields, tree):
            out += _tree_paths(child, f"{prefix}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for k, child in enumerate(tree):
            out += _tree_paths(child, f"{prefix}[{k}]")
        return out
    return [(prefix, tree)]


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in pytree order, from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        rebuilt = {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
        return {key: rebuilt[key] for key in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(child, leaves) for child in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(child, leaves) for child in tree)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _step_dir(directory: pathlib.Path, step: int) -> pathlib.Path:
    return directory / f"step_{step:09d}"


def save_checkpoint(directory, step: int, state, *,
                    metadata: Optional[dict] = None,
                    shards: int = 1) -> pathlib.Path:
    """Synchronous save with an atomic commit marker.

    ``shards``: number of ``leaves_%03d.npz`` files the leading axis of
    each leaf is split over; leaves whose leading dim is smaller than
    ``shards`` (and 0-d leaves) land whole in the first file.  The
    manifest records each leaf's shard count, so a restore reassembles
    full arrays whatever wrote them."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    tracer = obs.default_tracer()
    t_start = tracer.now()
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final.with_name(final.name + ".tmp")
    marker = final.with_name(final.name + ".COMMITTED")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    per_file: list = [dict() for _ in range(shards)]
    manifest = {"step": step, "leaves": [], "metadata": metadata or {},
                "time": time.time()}
    if shards > 1:
        manifest["num_shards"] = shards
    for i, (path, leaf) in enumerate(_tree_paths(state)):
        arr = _host(leaf)
        key = f"leaf_{i:05d}"
        k = shards if (shards > 1 and arr.ndim >= 1
                       and arr.shape[0] >= shards) else 1
        entry = {"path": path, "key": key, "shape": list(arr.shape),
                 "dtype": str(arr.dtype)}
        if k > 1:
            entry["shards"] = k
            for s, part in enumerate(np.array_split(arr, k, axis=0)):
                per_file[s][key] = part
        else:
            per_file[0][key] = arr
        manifest["leaves"].append(entry)
    n_files = max([1] + [e.get("shards", 1) for e in manifest["leaves"]])
    for s in range(n_files):
        np.savez(tmp / f"leaves_{s:03d}.npz", **per_file[s])
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)            # atomic on the same filesystem
    marker.touch()               # commit marker written last
    _OBS_SAVES.inc()
    tracer.add_span(
        "checkpoint_save", t_start, tracer.now(), cat="checkpoint",
        args={"step": int(step), "leaves": len(manifest["leaves"]),
              "shards": n_files,
              "bytes": int(sum(int(np.prod(e["shape"] or [1]))
                               * np.dtype(e["dtype"]).itemsize
                               for e in manifest["leaves"]))})
    return final


def latest_step(directory) -> Optional[int]:
    """The newest committed step in ``directory`` (None if there is
    none)."""
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        m = _STEP_RE.search(p.name)
        if m and p.is_dir() and (directory
                                 / f"{p.name}.COMMITTED").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _resolve_step(directory: pathlib.Path, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in "
                                    f"{directory}")
    return step


def read_metadata(directory, step: Optional[int] = None) -> dict:
    """Manifest metadata of a committed checkpoint (the latest when
    ``step`` is None) without reading any leaf."""
    directory = pathlib.Path(directory)
    step = _resolve_step(directory, step)
    manifest = json.loads(
        (_step_dir(directory, step) / "manifest.json").read_text())
    return manifest.get("metadata", {})


def restore_checkpoint(directory, state_like, *,
                       step: Optional[int] = None):
    """Restore into the structure of ``state_like``.

    Each leaf comes back as a tensor with the dtype and on the device of
    its ``state_like`` leaf (a numpy ``like`` leaf: its dtype, on the
    CPU).  Returns ``(state, step, metadata)``; a leaf path the
    checkpoint lacks raises ``KeyError``."""
    tracer = obs.default_tracer()
    t_start = tracer.now()
    directory = pathlib.Path(directory)
    step = _resolve_step(directory, step)
    final = _step_dir(directory, step)
    manifest = json.loads((final / "manifest.json").read_text())
    num_files = int(manifest.get("num_shards", 1))
    files = [np.load(final / f"leaves_{s:03d}.npz")
             for s in range(num_files)]
    try:
        by_path = {e["path"]: e for e in manifest["leaves"]}
        new_leaves = []
        for path, like in _tree_paths(state_like):
            entry = by_path.get(path)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {path}")
            k = int(entry.get("shards", 1))
            arr = (files[0][entry["key"]] if k == 1 else np.concatenate(
                [files[s][entry["key"]] for s in range(k)], axis=0))
            if isinstance(like, torch.Tensor):
                leaf = torch.from_numpy(np.array(arr)).to(
                    device=like.device, dtype=like.dtype)
            else:
                want = getattr(like, "dtype", arr.dtype)
                leaf = torch.from_numpy(np.array(arr, dtype=want))
            new_leaves.append(leaf)
    finally:
        for f in files:
            f.close()
    state = _unflatten(state_like, iter(new_leaves))
    _OBS_RESTORES.inc()
    tracer.add_span(
        "checkpoint_restore", t_start, tracer.now(), cat="checkpoint",
        args={"step": int(step), "leaves": len(manifest["leaves"]),
              "shards": num_files})
    return state, step, manifest.get("metadata", {})


class CheckpointManager:
    """Background-thread checkpointing with retention.

    ``save(step, state)`` copies the state to host arrays at once, then
    writes it on a worker thread; ``wait()`` joins the outstanding write
    and re-raises its error.  Keeps the newest ``keep`` checkpoints."""

    def __init__(self, directory, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state, metadata: Optional[dict] = None,
             blocking: bool = False):
        self.wait()
        leaves = iter([_host(leaf).copy() for _, leaf in _tree_paths(state)])
        host_state = _unflatten(state, leaves)

        def work():
            try:
                save_checkpoint(self.directory, step, host_state,
                                metadata=metadata)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(_STEP_RE.search(p.name).group(1))
            for p in self.directory.iterdir()
            if _STEP_RE.search(p.name) and p.is_dir()
            and (self.directory / f"{p.name}.COMMITTED").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)
            (self.directory / f"step_{s:09d}.COMMITTED").unlink(
                missing_ok=True)

    def restore_latest(self, state_like):
        return restore_checkpoint(self.directory, state_like)
