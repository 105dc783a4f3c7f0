"""Persisted tile autotuner for the port's execution plans.

Two tuned axes, the JAX package's:

  * ``block_b`` — the most signal rows one CTA holds (kernels/launcher.py:
    warps x rows per warp in a chain or operator launch, r in a bank
    launch), the keyword every kernel entry point takes.  A CTA walks the
    whole table stream once for its rows, so the dial trades rows per
    stream walk against CTAs on the card.  Every geometry gives the same
    answer.
  * stage chunking — the cut-ladder granularity the packers schedule
    against (``core/staging.py::default_cut_ladder``), cached as the JAX
    package caches it.

Choices persist in ONE JSON cache, in the JAX package's layout:

    {"version": 1,
     "entries": {"<key>": {"block_b": 128, "source": "measured",
                           "timings_us": {"64": 12.3, ...}},
                 "chunks/sym/n64": {"num_chunks": 4, "source": "prior",
                                    "depth_overhead": {...}}}}

Plan keys are ``<family>/<mode>/<batched|single>/n<width>`` and carry no
backend, so the port keeps a file of its own: ``$REPRO_TORCH_AUTOTUNE_CACHE``
(or ``~/.cache/repro_torch/autotune.json``).  A file shared with the JAX
package (``$REPRO_AUTOTUNE_CACHE``) would let a Pallas measurement set a
CUDA tile.

Seeding: ``prior_block_b`` (the largest candidate whose CTA tile and
ring fit one block's shared memory) gives ``source="prior"`` entries;
``autotune_block_b`` refines them to ``source="measured"`` by timing the
plan's program at each candidate.  A prior never overwrites a
measurement.

Staleness rule: ``ApplyPlan.program()`` resolves ``block_b=None``
through this cache when it builds the program, so entries recorded after
a plan was first built take effect only after ``plan.clear_plan_cache()``.
With no entry the launcher chooses its own geometry.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Optional, Sequence

import torch

from repro_torch import obs
from . import launcher

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 1

_OBS_AUTOTUNE = obs.counter("autotune_measurements_total",
                            "measured tile-size autotune passes")
BLOCK_B_CANDIDATES = (32, 64, 128, 256)
CHUNK_CANDIDATES = (1, 2, 4, 8)


def cache_path() -> pathlib.Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return pathlib.Path(env).expanduser()
    return pathlib.Path("~/.cache/repro_torch/autotune.json").expanduser()


def load_cache(path=None) -> dict:
    """The cache dict ({"version", "entries"}); empty/corrupt files load
    as a fresh cache (the tuner must never be able to brick an apply)."""
    p = pathlib.Path(path) if path else cache_path()
    try:
        data = json.loads(p.read_text())
        if (isinstance(data, dict)
                and data.get("version") == CACHE_VERSION
                and isinstance(data.get("entries"), dict)):
            return data
    except (OSError, ValueError):
        pass
    return {"version": CACHE_VERSION, "entries": {}}


def save_cache(cache: dict, path=None) -> pathlib.Path:
    """Atomic write (tmp + rename): concurrent processes may share one
    cache file."""
    p = pathlib.Path(path) if path else cache_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(cache, indent=1, sort_keys=True))
    tmp.replace(p)
    return p


def plan_key(plan) -> str:
    return (f"{plan.family}/{plan.mode}/"
            f"{'batched' if plan.batched else 'single'}/n{plan.n}")


def chunk_key(family: str, n: int) -> str:
    return f"chunks/{family}/n{n}"


def cached_block_b(plan, path=None) -> Optional[int]:
    """The persisted tile choice for ``plan``, or None (the launcher then
    chooses its own geometry)."""
    entry = load_cache(path)["entries"].get(plan_key(plan))
    if entry and isinstance(entry.get("block_b"), int):
        return entry["block_b"]
    return None


def cached_num_chunks(family: str, n: int, default: Optional[int] = None,
                      path=None) -> Optional[int]:
    """The persisted cut-ladder granularity for (family, n) packs."""
    entry = load_cache(path)["entries"].get(chunk_key(family, n))
    if entry and isinstance(entry.get("num_chunks"), int):
        return entry["num_chunks"]
    return default


def record(key: str, path=None, source: str = "measured",
           **fields) -> dict:
    """Merge one entry into the cache.  A ``source="prior"`` record
    never clobbers an existing measurement; everything else last-wins."""
    cache = load_cache(path)
    old = cache["entries"].get(key)
    if (source == "prior" and old is not None
            and old.get("source") == "measured"):
        return old
    entry = {"source": source, **fields}
    cache["entries"][key] = entry
    save_cache(cache, path)
    return entry


def prior_block_b(n: int, width: int, family: str = "sym",
                  mode: str = "operator", precision: str = "f32",
                  candidates: Sequence[int] = BLOCK_B_CANDIDATES,
                  smem_block: Optional[int] = None) -> int:
    """Analytic tile prior: the LARGEST candidate whose CTA tile (its
    signal rows at the launcher's odd stride, (n + 1) | 1 words) and
    table ring fit ``smem_block`` bytes of one block's shared memory;
    the smallest candidate when none fits.  The ring is a bank CTA's
    (RING_STAGES stages of ``width`` slots) in mode "bank", else one
    warp ring per 32 rows (one row a lane).  Pure given ``smem_block``;
    None reads the current card's limit (``launcher._card_limits``)."""
    if smem_block is None:
        smem_block = launcher._card_limits(torch.cuda.current_device())[0]
    fam = "g" if family == "sym" else "t"
    row_bytes = ((n + 1) | 1) * 4
    best = candidates[0]
    for cand in sorted(candidates):
        if mode == "bank":
            ring = launcher.bank_ring_bytes(width, fam)
        else:
            ring = -(-cand // 32) * launcher.operator_ring_bytes(fam,
                                                                 precision)
        if cand * row_bytes + ring <= smem_block:
            best = cand
    return best


def _median_time(fn, args, repeats: int = 5, warmup: int = 2) -> float:
    """Median seconds of ``fn(*args)``: CUDA events after a synchronize
    where the signal (``args[-1]``) is on the card, ``perf_counter``
    otherwise."""
    on_card = args[-1].device.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(repeats):
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def autotune_block_b(plan, args: tuple,
                     candidates: Sequence[int] = BLOCK_B_CANDIDATES,
                     repeats: int = 5, path=None) -> int:
    """Measure ``plan`` at each candidate tile size on ``args`` (the
    program's argument tuple — prepared tables + tensors), pick the
    fastest, persist it as ``source="measured"``, and return it.
    Candidates are capped at the signal-row count (a taller tile holds
    no more rows)."""
    x = args[-1]
    denom = plan.n * (x.shape[0] if plan.batched else 1)
    rows = max(x.numel() // max(denom, 1), 1)
    grid = sorted({min(int(c), max(_pow2_floor(rows), 1))
                   for c in candidates})
    timings = {}
    tracer = obs.default_tracer()
    t_start = tracer.now()
    for cand in grid:
        prog = dataclasses.replace(plan, block_b=cand).program()
        timings[str(cand)] = _median_time(prog, args, repeats=repeats)
    best = int(min(timings, key=timings.get))
    timings_us = {k: round(v * 1e6, 2) for k, v in timings.items()}
    record(plan_key(plan), path=path, source="measured", block_b=best,
           timings_us=timings_us)
    _OBS_AUTOTUNE.inc()
    tracer.add_span("autotune_measure", t_start, tracer.now(),
                    cat="autotune",
                    args={"key": plan_key(plan), "block_b": best,
                          "timings_us": timings_us})
    return best


def _pow2_floor(v: int) -> int:
    p = 1
    while 2 * p <= v:
        p *= 2
    return p
