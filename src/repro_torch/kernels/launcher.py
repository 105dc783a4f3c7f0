"""Launching the hand-written CUDA staged-chain kernels (csrc/*.cu).

One launcher serves every table family: ``chain``, ``operator`` and
``bank`` take an entry point's name, dispatch a CPU tensor to the plain
PyTorch version they are given (kernels/ref.py), and otherwise check the
arguments and launch the entry point's kernel on PyTorch's current
stream, or raise (no nvcc, failed build, wrong dtype/shape/device):
there is no fallback.
Signals are f32, indices int32, and the value tables all f32 or all
bf16; other dtypes raise.  Each entry point has two forms, one per value
dtype: a bf16 form launches its kernel's bf16 instantiation, which reads
the 16-bit values and widens them in registers (a widening is exact), so
it computes what the f32 form computes on ``tables.float()``.  The
anytime cut is passed to the kernel as a runtime (first stage, count) per
leg: a chain's at the caller's ``keep``, each operator or bank leg at its
family's ``leg_orientation``.

Geometry.  In a chain or operator launch (the rows body of
csrc/chain.cuh, which replaces the Pallas chain kernels
``_{batched_,}butterfly_kernel`` and ``_{batched_,}shear_kernel`` and the
fused operator kernels) a warp owns its signal rows of one matrix for
the whole launch (``operator_geometry``, a pure function of the shapes
and the card's figures): L lanes per row, 32 / L rows per warp, a few
warps per CTA.  Each leg walks a compacted stream of its real entries in
stage order (``entry_stream``, built on the tables' device and kept
beside the tables, so a chain and an operator on the same tables share
one stream), so the anytime cut is an entry range and no pad is read;
the body is bound by one warp's latency per stage, not by memory.  A
bank CTA owns r signal rows and F_g filters (``bank_geometry``, a pure
function of the shapes and the card's shared-memory and SM counts): it
runs the analysis leg on its r rows, scales them into F_g copies and runs
ONE synthesis walk over all F_g * r rows, so it crosses 2 S stage
barriers for any F_g.  Its shared memory (the F_g * r rows and a ring of
table stages) leaves at least three CTAs resident per SM; the grid
(r-row tiles x filter groups, matrices) gives every SM two CTAs where the
work allows, and otherwise F_g = F, so the analysis runs once.  A bank
leg walks each stage only up to its real extent (``stage_extents``,
computed on the tables' device and kept beside the index table until it
dies or is written).

A batch is grid y of every launch, so a batch of more than ``_GRID_B``
matrices is launched as consecutive slices of at most ``_GRID_B``
(``batch_slices``), each on pointers offset to its first matrix.

Every launch adds one to its entry point form's count, in ONE registry
for all families: ``entry_launch_counts()`` per form (an entry point's
name for f32 tables, the name with ``_bf16`` for bf16 ones),
``launch_counts()`` summed per kernel (``g_chain_kernel``,
``g_chain_bf16_kernel``, ...), ``reset_launch_counts()`` zeroes both.
"""
from __future__ import annotations

import functools
import threading
import weakref
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.staging import (PRECISION_DTYPE, StagedT,
                                      table_arrays, table_precision,
                                      with_precision)
from . import build
from .ref import check_gains

#: entry point -> the kernel its f32 form launches
_F32_KERNEL_OF = {"batched_butterfly_apply": "g_chain_kernel",
                  "butterfly_apply": "g_chain_kernel",
                  "batched_sym_operator_apply": "g_operator_kernel",
                  "sym_operator_apply": "g_operator_kernel",
                  "batched_shear_apply": "t_chain_kernel",
                  "shear_apply": "t_chain_kernel",
                  "batched_gen_operator_apply": "t_operator_kernel",
                  "gen_operator_apply": "t_operator_kernel",
                  "batched_sym_filter_bank_apply": "g_bank_kernel",
                  "sym_filter_bank_apply": "g_bank_kernel",
                  "batched_gen_filter_bank_apply": "t_bank_kernel",
                  "gen_filter_bank_apply": "t_bank_kernel"}
#: the 12 entry points
ENTRIES = tuple(_F32_KERNEL_OF)
#: entry point form -> the kernel it launches (its C launcher is
#: ``<kernel without _kernel>_launch``): ``entry`` for f32 value tables,
#: ``entry + "_bf16"`` for bf16 ones
KERNEL_OF = {**_F32_KERNEL_OF,
             **{f"{e}_bf16": k.replace("_kernel", "_bf16_kernel")
                for e, k in _F32_KERNEL_OF.items()}}
KERNELS = tuple(dict.fromkeys(KERNEL_OF.values()))
THREADS = 256
#: matrices per launch: the grid's y dimension
_GRID_B = 65535
#: table stages in a bank CTA's shared ring (csrc/chain.cuh kRing), and
#: 32-bit words per entry of a chain or operator stream by (family,
#: precision): GPair::kWords, TEntry::kWords, GPairBf16::kWords,
#: TEntryBf16::kWords.  A bank ring holds the f32 form's words at either
#: precision (GBankBf16 and TEntryBf16 widen the values into it).
RING_STAGES = 4
_ENTRY_WORDS = {("g", "f32"): 8, ("t", "f32"): 4,
                ("g", "bf16"): 4, ("t", "bf16"): 4}
#: shared memory the card reserves for each resident block (Hopper: 1 KB),
#: and the resident bank CTAs per SM that the geometry keeps room for
_SMEM_RESERVED = 1024
_MIN_RESIDENT = 3
#: lanes per signal row an operator launch may take, its warps per CTA,
#: and the stream entries of a warp's ring (csrc/chain.cuh kChunk *
#: kRingChunks)
OPERATOR_LANES = (1, 2, 4, 8)
_MAX_WARPS = 8
_RING_ENTRIES = 32 * 8
_launches = dict.fromkeys(KERNEL_OF, 0)
#: guards the launch and cache counters: an async service's dispatcher
#: and maintainer threads launch at the same time, and ``+= 1`` on a dict
#: entry is not atomic
_COUNT_LOCK = threading.Lock()


def entry_launch_counts() -> dict:
    """Launches per entry point since the last ``reset_launch_counts``."""
    return dict(_launches)


def launch_counts() -> dict:
    """Launches per kernel since the last ``reset_launch_counts``."""
    out = dict.fromkeys(KERNELS, 0)
    for entry, k in _launches.items():
        out[KERNEL_OF[entry]] += k
    return out


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def leg_orientation(family: str) -> tuple:
    """(analysis_keep, synthesis_keep) cut orientation of a family's
    operator legs: the significant G stages sit at the HEAD of the
    adjoint tables and the TAIL of the forward tables; the significant T
    stages at the TAIL of the inverse tables and the HEAD of the forward
    tables."""
    return ("head", "tail") if family == "sym" else ("tail", "head")


# ---------------------------------------------------------------------------
# argument checks and launch geometry
# ---------------------------------------------------------------------------

def _leg_range(num_stages_total: int, num_stages: Optional[int],
               keep: str) -> Tuple[int, int]:
    """(first stage, stage count) of an anytime cut."""
    if keep not in ("head", "tail"):
        raise ValueError(f"keep must be 'head' or 'tail', got {keep!r}")
    if num_stages is None:
        return 0, num_stages_total
    if not 0 <= num_stages <= num_stages_total:
        raise ValueError(f"num_stages {num_stages} not in "
                         f"[0, {num_stages_total}]")
    return (0 if keep == "head" else num_stages_total - num_stages,
            num_stages)


def form(entry: str, precision: str) -> str:
    """The launch counters' name of ``entry`` at a table precision."""
    return entry if precision == "f32" else f"{entry}_{precision}"


def _check_signal(x: torch.Tensor, ndim: int, what: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(
            f"{what}: signals must be float32, got {x.dtype} (a precision="
            "'bf16' plan takes a bf16 signal and walks it in f32; a bf16 "
            "signal computed in bf16, as the JAX kernels do on f32 tables, "
            "is not ported)")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"device {x.device}")
    if x.dim() != ndim:
        raise ValueError(f"{what}: expected a {ndim}-d signal, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: signal must be contiguous")


def _check_tables(staged, device: torch.device, batch: Optional[int],
                  n: int, what: str) -> Tuple[int, int]:
    """Validate a StagedG/StagedT table set against the signal: int32
    indices, value tables all f32 or all bf16 (``table_precision``);
    returns (S, P)."""
    if staged.n != n:
        raise ValueError(f"{what}: tables are for n={staged.n}, signal has "
                         f"n={n}")
    shape = tuple(staged.idx_i.shape)
    want_dim = 2 if batch is None else 3
    if len(shape) != want_dim or (batch is not None and shape[0] != batch):
        raise ValueError(f"{what}: tables of shape {shape} do not match "
                         f"{'(S, P)' if batch is None else f'({batch}, S, P)'}")
    values = table_arrays(staged)[2].dtype
    for name, t in zip(staged._fields, table_arrays(staged)):
        dt = (torch.int32 if name.startswith("idx_")
              else values if values in (torch.float32, torch.bfloat16)
              else torch.float32)
        if t.device != device:
            raise ValueError(f"{what}: table {name} on {t.device}, signal "
                             f"on {device}")
        if t.dtype != dt:
            raise TypeError(f"{what}: table {name} must be {dt}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: table {name} shape {tuple(t.shape)} "
                             f"!= {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: table {name} must be contiguous")
    return shape[-2], shape[-1]


class BankGeometry(NamedTuple):
    """A bank launch's CTAs: ``rows`` signal rows (r) and ``filters``
    filters (F_g) each, on a grid of ``row_tiles`` x ``groups`` CTAs per
    matrix; ``smem`` dynamic shared-memory bytes per CTA, which leave
    ``resident`` CTAs per SM."""
    rows: int
    filters: int
    row_tiles: int
    groups: int
    smem: int
    resident: int


def bank_ring_bytes(slots: int, family: str) -> int:
    """Bytes of a bank CTA's table ring: RING_STAGES stages of ``slots``
    entries of the family's ("g" or "t") ring words, and their extents
    (csrc/chain.cuh::bank_smem).  The ring holds f32 words at either
    table precision."""
    return RING_STAGES * (slots * _ENTRY_WORDS[(family, "f32")] + 1) * 4


@functools.lru_cache(maxsize=4096)
def bank_geometry(batch: int, rows: int, n: int, filters: int,
                  ring_bytes: int, smem_block: int, smem_sm: int,
                  sms: int) -> BankGeometry:
    """Rows and filters per bank CTA for B = ``batch`` matrices, R =
    ``rows`` signal rows of width n and F = ``filters`` filters, on a
    card whose blocks may take ``smem_block`` bytes of shared memory and
    whose ``sms`` SMs hold ``smem_sm`` bytes each.  Pure: no card query.

    A CTA's tile (F_g * r rows at the odd stride, 16-byte aligned) and
    ``ring_bytes`` leave at least three CTAs resident per SM.  Among the
    (r, F_g) that fit, the choice maximizes min(CTAs, 2 * sms), then
    takes the fewest filter groups (F_g = F: the analysis runs once per
    row), then the most rows.  Raises when not one row fits."""
    if min(batch, rows, filters) < 1:
        raise ValueError(f"bank geometry needs B, R, F >= 1, got "
                         f"{(batch, rows, filters)}")
    ld = (n + 1) | 1
    per_cta = min(smem_block,
                  smem_sm // _MIN_RESIDENT - _SMEM_RESERVED) - ring_bytes
    max_rows = 4 * (per_cta // 16) // ld if per_cta > 0 else 0
    if max_rows < 1:
        raise ValueError(f"n={n} is too wide for a bank CTA: one row and "
                         f"the table ring ({ld * 4} + {ring_bytes} bytes) "
                         f"leave no {_MIN_RESIDENT} CTAs per SM in "
                         f"{smem_sm} bytes")
    target = 2 * sms
    best, best_key = None, None
    for groups in range(1, filters + 1):
        fg = -(-filters // groups)
        if -(-filters // fg) != groups:      # the same F_g as fewer groups
            continue
        rmax = min(rows, max_rows // fg)
        if rmax < 1:
            continue
        want = -(-target // (batch * groups))    # row tiles to reach it
        r = rmax if want <= 1 else max(1, min(rmax,
                                              -(-rows // (want - 1)) - 1))
        tiles = -(-rows // r)
        r = -(-rows // tiles)                    # balanced tiles
        key = (min(batch * groups * tiles, target), -groups, r)
        if best_key is None or key > best_key:
            best_key, best = key, (r, fg, tiles, groups)
    r, fg, tiles, groups = best
    smem = -(-r * fg * ld // 4) * 16 + ring_bytes
    return BankGeometry(r, fg, tiles, groups, smem,
                        smem_sm // (smem + _SMEM_RESERVED))


@functools.lru_cache(maxsize=None)
def _card_limits(index: int) -> Tuple[int, int, int]:
    """(shared memory per block, per SM, SM count) of card ``index``."""
    lib = build.library()
    with torch.cuda.device(index):
        block, sm = lib.repro_max_smem_optin(), lib.repro_smem_per_sm()
    if block <= 0 or sm <= 0:
        raise RuntimeError("cannot read the device's shared memory limits")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return block, sm, sms


def _bank_geometry_on(device: torch.device, batch: int, rows: int, n: int,
                      filters: int, slots: int,
                      family: str) -> BankGeometry:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return bank_geometry(batch, rows, n, filters,
                         bank_ring_bytes(slots, family),
                         *_card_limits(index))


class OperatorGeometry(NamedTuple):
    """An operator launch's CTAs: ``warps`` warps each, each warp owning
    ``rows_per_warp`` signal rows of one matrix with ``lanes`` lanes per
    row and a ring of table entries; ``row_tiles`` CTAs per matrix;
    ``smem`` dynamic shared-memory bytes per CTA, which leave
    ``resident`` CTAs per SM."""
    lanes: int
    rows_per_warp: int
    warps: int
    row_tiles: int
    smem: int
    resident: int


def operator_ring_bytes(family: str, precision: str = "f32") -> int:
    """Bytes of a warp's ring of stream entries in an operator CTA, for
    the family "g" or "t" at a table precision (csrc/chain.cuh::
    operator_smem): the bf16 G stream's entry is half the f32 one's."""
    return _RING_ENTRIES * _ENTRY_WORDS[(family, precision)] * 4


@functools.lru_cache(maxsize=4096)
def operator_geometry(batch: int, rows: int, n: int, ring_bytes: int,
                      smem_block: int, smem_sm: int,
                      sms: int) -> OperatorGeometry:
    """Lanes per row, rows per warp and warps per CTA of an operator
    launch for B = ``batch`` matrices of R = ``rows`` signal rows of
    width n and a ring of ``ring_bytes`` per warp, on a card whose
    blocks may take ``smem_block`` bytes of shared memory and whose
    ``sms`` SMs hold ``smem_sm`` bytes each.  Pure: no card query.

    L is the fewest lanes in OPERATOR_LANES whose warps number at least
    two per SM, else the most (a warp holds 32 / L rows, fewer where R
    or one block's shared memory is smaller): one lane per row where the
    rows fill the card, more where they do not, so that more warps run.
    The warps per CTA (at most 8, at most a matrix's warps) minimize the
    warps on the busiest SM, ceil(CTAs / SMs) * warps, then take the
    most warps per CTA (their rings load one matrix's stream through one
    L1).  Raises when not one row fits."""
    if min(batch, rows) < 1:
        raise ValueError(f"operator geometry needs B, R >= 1, got "
                         f"{(batch, rows)}")
    row_bytes = ((n + 1) | 1) * 4
    fit = (smem_block - 16 - ring_bytes) // row_bytes
    if fit < 1:
        raise ValueError(f"n={n} is too wide for one shared-memory row "
                         f"and a ring ({row_bytes} + {ring_bytes} bytes > "
                         f"{smem_block})")
    for lanes in OPERATOR_LANES:
        per_warp = min(32 // lanes, rows, fit)
        warps_per_matrix = -(-rows // per_warp)
        if batch * warps_per_matrix >= 2 * sms:
            break

    def smem(warps):
        rows_bytes = -(-warps * per_warp * row_bytes // 16) * 16
        return rows_bytes + warps * ring_bytes

    best, best_key = None, None
    for warps in range(1, min(_MAX_WARPS, warps_per_matrix) + 1):
        if smem(warps) > smem_block:
            break
        tiles = -(-warps_per_matrix // warps)
        key = (-(-(batch * tiles) // sms) * warps, -warps)
        if best_key is None or key < best_key:
            best_key, best = key, (warps, tiles)
    warps, tiles = best
    resident = min(smem_sm // (smem(warps) + _SMEM_RESERVED), 64 // warps,
                   32)
    return OperatorGeometry(lanes, per_warp, warps, tiles, smem(warps),
                            resident)


def _operator_geometry_on(device: torch.device, batch: int, rows: int,
                          n: int, family: str,
                          precision: str) -> OperatorGeometry:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return operator_geometry(batch, rows, n,
                             operator_ring_bytes(family, precision),
                             *_card_limits(index))


def launch_geometry(entry: str, batch: int, rows: int, n: int,
                    filters: int = 1, slots: int = 1) -> dict:
    """The CTAs a launch of ``entry`` (an entry point form: its bf16 form
    is ``entry + "_bf16"``) takes on the current card at x (batch, rows,
    n) (a bank: ``filters`` filters on tables of ``slots`` slots per
    stage; a chain or an operator also its lanes per row, rows per warp
    and warps per CTA), with the card's own reading of its resident CTAs
    per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    kernel = KERNEL_OF[entry]
    dev = torch.device("cuda", torch.cuda.current_device())
    family, kind = kernel[0], kernel.split("_")[1]
    precision = "bf16" if "_bf16_" in kernel else "f32"
    threads = THREADS
    if kind == "bank":
        geo = _bank_geometry_on(dev, batch, rows, n, filters, slots, family)
        out = {"rows_per_cta": geo.rows, "filters_per_cta": geo.filters,
               "ctas": batch * geo.row_tiles * geo.groups}
        tile_rows = geo.rows * geo.filters
    else:
        geo = _operator_geometry_on(dev, batch, rows, n, family, precision)
        tile_rows = geo.warps * geo.rows_per_warp
        threads = 32 * geo.warps
        out = {"rows_per_cta": tile_rows, "filters_per_cta": 1,
               "lanes_per_row": geo.lanes, "rows_per_warp": geo.rows_per_warp,
               "warps_per_cta": geo.warps, "ctas": batch * geo.row_tiles}
    lib = build.library()
    occupancy = (f"{family}_occupancy" if precision == "f32"
                 else f"{family}_{precision}_occupancy")
    resident = getattr(lib, occupancy)(
        ("chain", "operator", "bank").index(kind), tile_rows, n, slots,
        threads)
    if resident < 0:
        build.check(lib, -resident, f"{kernel} occupancy query")
    out["resident_per_sm"] = resident
    return out


def stage_extents(staged) -> torch.Tensor:
    """(B, S) or (S,) int32 real extent of every stage: 1 + the last slot
    whose index is below n, 0 for an all-pad stage.  The packers put a
    stage's real entries first (core/staging.py), so this is the
    stage's real-entry count; a bank kernel walks only those slots."""
    ii = staged.idx_i
    slot = torch.arange(1, ii.shape[-1] + 1, dtype=torch.int32,
                        device=ii.device)
    return torch.where(ii < staged.n, slot, 0).amax(-1).to(torch.int32)


def _built_on(t: torch.Tensor):
    """(stream handle, event): the current stream, where an entry
    computed from ``t`` was just enqueued, and an event recorded after
    it (None on the CPU, which has no streams)."""
    if t.device.type != "cuda":
        return None
    stream = torch.cuda.current_stream(t.device)
    done = torch.cuda.Event()
    done.record(stream)
    return stream.cuda_stream, done


def _join(built, device: torch.device) -> None:
    """Order the current stream after an entry's build, where another
    stream built it: an async service's maintainer builds entries on its
    own stream that the dispatcher's stream then reads, and the other
    way round, and the card must not read an entry before it is
    written."""
    if built is not None:
        cur = torch.cuda.current_stream(device)
        if cur.cuda_stream != built[0]:
            cur.wait_event(built[1])


def _kept(cache: dict, tensors: tuple, n: int, make: Callable,
          counts: Optional[dict] = None):
    """``make()`` kept in ``cache`` beside the tensors it is computed
    from, keyed on the first, while all of them live and none is
    replaced or written in place (their versions); the entry goes with
    the first tensor.  A hit from another CUDA stream than the one that
    built the entry waits (on the card) for the build.  ``counts``
    tallies the lookups' hits and misses."""
    key = id(tensors[0])
    hit = cache.get(key)
    if (hit is not None and hit[2] == n
            and all(r() is t and v == t._version
                    for r, v, t in zip(hit[0], hit[1], tensors))):
        if counts is not None:
            with _COUNT_LOCK:
                counts["hits"] += 1
        _join(hit[4], tensors[0].device)
        return hit[3]
    if counts is not None:
        with _COUNT_LOCK:
            counts["misses"] += 1
    out = make()
    refs = ((weakref.ref(tensors[0], lambda _, k=key: cache.pop(k, None)),)
            + tuple(weakref.ref(t) for t in tensors[1:]))
    cache[key] = (refs, tuple(t._version for t in tensors), n, out,
                  _built_on(tensors[0]))
    return out


#: id(idx_i) -> ((weak reference to idx_i,), (its version,), n, its
#: extents)
_EXTENTS: dict = {}


def _cached_extents(staged) -> torch.Tensor:
    """``stage_extents`` kept beside the index table it was computed
    from: a served basis pays the reduction (a few small launches) once,
    not per bank launch."""
    return _kept(_EXTENTS, (staged.idx_i,), staged.n,
                 lambda: stage_extents(staged))


def entry_stream(staged) -> Tuple[torch.Tensor, torch.Tensor]:
    """An operator leg's compacted stream, built on the tables' device:
    ``(words, offsets)``.  ``words`` (E, k) int32 holds the real entries
    (index below n) of all matrices in (matrix, stage, slot) order in the
    ring form of csrc/{butterfly,shear}.cu, k words each, values as their
    bits: for f32 tables (i, j, c, s, sigma, 0, 0, 0) for G and (i, j,
    alpha, beta) for T; for bf16 tables two values a word, the first in
    the low half: (i, j, c|s, sigma|0) for G and (i, j, alpha|beta, 0)
    for T.  ``offsets`` (B, S + 1) int32: matrix b's stage s holds
    entries [offsets[b, s], offsets[b, s + 1]), so offsets[b, 1:] -
    offsets[b, 0] is the running sum of b's stage extents.  (S, P) tables
    give B = 1."""
    tabs = table_arrays(staged)
    ii = tabs[0]
    dev = ii.device
    bsz = ii.shape[0] if ii.dim() == 3 else 1
    s_tot = ii.shape[-2]
    flat = [t.reshape(-1) for t in tabs]
    real = flat[0] < staged.n
    counts = real.reshape(bsz * s_tot, -1).sum(-1)
    ends = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    at = (torch.arange(bsz, device=dev)[:, None] * s_tot
          + torch.arange(s_tot + 1, device=dev))
    sel = real.nonzero().squeeze(1)
    if sel.numel() >= 2 ** 31:
        raise ValueError(f"{sel.numel()} table entries exceed the stream's "
                         "int32 offsets")
    family = "t" if isinstance(staged, StagedT) else "g"
    precision = table_precision(staged)
    cols = [t[sel].view(torch.int32) for t in flat[:2]]
    if precision == "f32":
        cols += [t[sel].view(torch.int32) for t in flat[2:]]
    else:
        half = [t[sel].view(torch.int16) for t in flat[2:]]
        half += [torch.zeros_like(half[0])] * (len(half) % 2)
        cols += [torch.stack(half[k:k + 2], -1).view(torch.int32)[:, 0]
                 for k in range(0, len(half), 2)]
    words = torch.zeros((sel.numel(), _ENTRY_WORDS[(family, precision)]),
                        dtype=torch.int32, device=dev)
    for k, col in enumerate(cols):
        words[:, k] = col
    return words, ends[at].to(torch.int32)


#: id(idx_i) -> (weak references to the leg's tables, their versions, n,
#: its stream), one cache per value precision: a basis's f32 and bf16
#: table sets share their index tables, and an engine that probes on one
#: and serves on the other keeps both streams
_STREAMS: dict = {}
_BF16_STREAMS: dict = {}
_stream_counts = {"hits": 0, "misses": 0}


def stream_cache_counts() -> dict:
    """Hits and misses of the entry-stream cache since the last
    ``reset_stream_cache_counts``: a hot swap that keeps its tables
    (a spectrum refresh) hits, one that builds new tables misses once
    per leg."""
    return dict(_stream_counts)


def reset_stream_cache_counts() -> None:
    _stream_counts.update(hits=0, misses=0)


def _cached_stream(staged) -> Tuple[torch.Tensor, torch.Tensor]:
    """``entry_stream`` kept beside the tables it was built from: a
    served basis builds its streams once, not per operator launch."""
    cache = _STREAMS if table_precision(staged) == "f32" else _BF16_STREAMS
    return _kept(cache, table_arrays(staged), staged.n,
                 lambda: entry_stream(staged), _stream_counts)


#: id(the first value table) -> (weak references to the value and index
#: tables, their versions, n, the table set cast to the other precision)
_CASTS: dict = {}


def cast_tables(staged, precision: str):
    """``with_precision(staged, precision)`` kept beside the tables it
    casts while they live and are not written: repeated one-shot calls at
    a precision other than the tables' (``ApproxEigenbasis.apply(
    precision="bf16")`` on f32 tables) cast once and then share one cast
    table set, and so one cached entry stream."""
    tabs = table_arrays(staged)
    if all(t.dtype == PRECISION_DTYPE[precision] for t in tabs[2:]):
        return staged
    return _kept(_CASTS, tabs[2:] + tabs[:2], staged.n,
                 lambda: with_precision(staged, precision))


def _check_diag(diag: torch.Tensor, x3: torch.Tensor, batched: bool,
                what: str) -> torch.Tensor:
    """Validate the spectrum; return it contiguous, (B, n) or (n,)."""
    bsz, _, n = x3.shape
    want = (bsz, n) if batched else (n,)
    if tuple(diag.shape) != want:
        raise ValueError(f"{what}: diag shape {tuple(diag.shape)} != {want}")
    if diag.device != x3.device or diag.dtype != torch.float32:
        raise TypeError(f"{what}: diag must be float32 on the signal's "
                        "device")
    return diag.contiguous()


def _padded_gains(gains: torch.Tensor, x3: torch.Tensor, batched: bool,
                  what: str) -> torch.Tensor:
    """Validate the gains; return them (B, F, n+1) with 1.0 in the dummy
    column n."""
    bsz, _, n = x3.shape
    f = check_gains(gains, x3 if batched else x3[0], batched, what)
    if gains.device != x3.device or gains.dtype != torch.float32:
        raise TypeError(f"{what}: gains must be float32 on the signal's "
                        "device")
    gp = torch.ones((bsz, f, n + 1), dtype=torch.float32, device=x3.device)
    gp[..., :n] = gains
    return gp


class _PerMatrix(NamedTuple):
    """A pointer argument that advances ``stride`` elements of
    ``itemsize`` bytes per matrix of the batch."""
    ptr: int
    stride: int
    itemsize: int = 4


def batch_slices(bsz: int) -> Iterator[Tuple[int, int]]:
    """The [b0, b1) slices of at most ``_GRID_B`` matrices that cover
    [0, bsz) in order: one launch each."""
    for b0 in range(0, bsz, _GRID_B):
        yield b0, min(bsz, b0 + _GRID_B)


def _sliced(x3: torch.Tensor, y: torch.Tensor,
            args: tuple) -> Iterator[tuple]:
    """Per ``batch_slices`` slice [b0, b1): the C arguments (x, y,
    b1 - b0, R, n, *args), with x, y and every ``_PerMatrix`` argument
    offset to matrix b0 (the others, such as a stream's words, stay as
    they are)."""
    bsz, r, n = x3.shape
    xy = (_PerMatrix(x3.data_ptr(), x3.stride(0)),
          _PerMatrix(y.data_ptr(), y.stride(0)))
    for b0, b1 in batch_slices(bsz):
        at = [a.ptr + a.itemsize * b0 * a.stride
              if isinstance(a, _PerMatrix) else a for a in xy + args]
        yield (*at[:2], b1 - b0, r, n, *at[2:])


def _launch(lib, entry: str, x3: torch.Tensor, y: torch.Tensor,
            args: tuple, geometry: tuple) -> torch.Tensor:
    """Launch the kernel of ``entry`` (an entry point form, ``form``)
    from ``lib`` (build.library()) from x3
    (B, R, n) into y (B, ..., n), once per batch slice (``_sliced``):
    ``args`` are the C arguments after (x, y, B, R, n) and before the
    geometry, ``geometry`` those before the CUDA stream handle (a chain's
    or operator's lanes, rows per warp and warps; a bank's rows and
    filters per CTA and threads).  Each launch function loads ``lib``
    first: without a toolchain nothing is prepared for a kernel."""
    kernel = KERNEL_OF[entry]
    launch = getattr(lib, kernel.replace("_kernel", "_launch"))
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    for c_args in _sliced(x3, y, args):
        build.check(lib, launch(*c_args, *geometry, stream),
                    f"{kernel} launch")
        with _COUNT_LOCK:
            _launches[entry] += 1
    return y


def _stream_leg(staged, x3: torch.Tensor, batched: bool,
                num_stages: Optional[int], keep: str, what: str) -> tuple:
    """A chain or operator leg's C arguments: the stream's words and
    stage offsets, S, first stage and stage count."""
    bsz, _, n = x3.shape
    s_tot, _ = _check_tables(staged, x3.device, bsz if batched else None, n,
                             what)
    words, offsets = _cached_stream(staged)
    return (words.data_ptr(), _PerMatrix(offsets.data_ptr(), s_tot + 1),
            s_tot, *_leg_range(s_tot, num_stages, keep))


def _bank_leg(staged, x3: torch.Tensor, batched: bool,
              num_stages: Optional[int], keep: str, what: str) -> tuple:
    """A bank leg's C arguments: its table pointers and stage extents,
    the tables' matrix stride, P, first stage and stage count."""
    bsz, _, n = x3.shape
    s_tot, p = _check_tables(staged, x3.device, bsz if batched else None, n,
                             what)
    stride = s_tot * p if batched else 0
    ext = _cached_extents(staged)
    return (*(_PerMatrix(t.data_ptr(), stride, t.element_size())
              for t in table_arrays(staged)),
            _PerMatrix(ext.data_ptr(), s_tot if batched else 0), stride, p,
            *_leg_range(s_tot, num_stages, keep))


def _form(entry: str, *legs) -> str:
    """The form of ``entry`` that the legs' (checked) tables take: they
    must share one value precision."""
    got = {table_precision(t) for t in legs}
    if len(got) != 1:
        raise TypeError(f"{entry}: the legs' value tables differ in "
                        f"precision ({sorted(got)})")
    return form(entry, got.pop())


def _keeps(fwd) -> tuple:
    """(analysis, synthesis) cut orientation of the operator or bank whose
    synthesis tables are ``fwd``."""
    return leg_orientation("general" if isinstance(fwd, StagedT) else "sym")


def _chain_launch(entry: str, staged, x3: torch.Tensor,
                  num_stages: Optional[int], keep: str) -> torch.Tensor:
    """y (B, R, n): one leg, a stream cut at ``keep``, on the
    ``operator_geometry`` grid."""
    lib = build.library()
    kernel = KERNEL_OF[entry]
    leg = _stream_leg(staged, x3, entry.startswith("batched"), num_stages,
                      keep, kernel)
    entry = _form(entry, staged)
    bsz, r, n = x3.shape
    y = torch.empty_like(x3)
    if bsz == 0 or r == 0:
        return y
    geo = _operator_geometry_on(x3.device, bsz, r, n, kernel[0],
                                table_precision(staged))
    return _launch(lib, entry, x3, y, leg,
                   (geo.lanes, geo.rows_per_warp, geo.warps))


def _operator_launch(entry: str, fwd, bwd, diag: torch.Tensor,
                     x3: torch.Tensor,
                     num_stages: Optional[int]) -> torch.Tensor:
    """y (B, R, n): the analysis leg (bwd), the spectrum (B, n) and the
    synthesis leg (fwd), each leg a stream cut at its family's
    orientation, on the ``operator_geometry`` grid."""
    lib = build.library()
    batched = entry.startswith("batched")
    kernel = KERNEL_OF[entry]
    a_keep, s_keep = _keeps(fwd)
    legs = (_stream_leg(bwd, x3, batched, num_stages, a_keep,
                        f"{kernel} bwd")
            + _stream_leg(fwd, x3, batched, num_stages, s_keep,
                          f"{kernel} fwd"))
    d = _check_diag(diag, x3, batched, kernel)
    entry = _form(entry, fwd, bwd)
    bsz, r, n = x3.shape
    y = torch.empty_like(x3)
    if bsz == 0 or r == 0:
        return y
    geo = _operator_geometry_on(x3.device, bsz, r, n, kernel[0],
                                table_precision(fwd))
    return _launch(lib, entry, x3, y, (_PerMatrix(d.data_ptr(), n), *legs),
                   (geo.lanes, geo.rows_per_warp, geo.warps))


def _bank_launch(entry: str, fwd, bwd, gains: torch.Tensor,
                 x3: torch.Tensor,
                 num_stages: Optional[int]) -> torch.Tensor:
    """(B, F, R, n): both legs cut as the operator's, each walked over
    its stages' real extents, on the ``bank_geometry`` grid."""
    lib = build.library()
    batched = entry.startswith("batched")
    kernel = KERNEL_OF[entry]
    a_keep, s_keep = _keeps(fwd)
    legs = (_bank_leg(bwd, x3, batched, num_stages, a_keep, f"{kernel} bwd")
            + _bank_leg(fwd, x3, batched, num_stages, s_keep,
                        f"{kernel} fwd"))
    gp = _padded_gains(gains, x3, batched, kernel)
    entry = _form(entry, fwd, bwd)
    bsz, r, n = x3.shape
    f = gp.shape[1]
    y = x3.new_empty((bsz, f, r, n))
    if bsz == 0 or r == 0:
        return y
    slots = max(fwd.idx_i.shape[-1], bwd.idx_i.shape[-1])
    geo = _bank_geometry_on(x3.device, bsz, r, n, f, slots, kernel[0])
    return _launch(lib, entry, x3, y,
                   (_PerMatrix(gp.data_ptr(), f * (n + 1)), f, *legs),
                   (geo.rows, geo.filters, THREADS))


# ---------------------------------------------------------------------------
# entry points' bodies
# ---------------------------------------------------------------------------

def chain(entry: str, plain: Callable, staged, x: torch.Tensor,
          num_stages: Optional[int], keep: str) -> torch.Tensor:
    """A chain entry point: ``plain`` on a CPU tensor, else the kernel;
    x is (B, R, n) for a batched entry, (R, n) for a B = 1 one."""
    if x.device.type == "cpu":
        return plain(staged, x, num_stages, keep)
    if entry.startswith("batched"):
        _check_signal(x, 3, entry)
        return _chain_launch(entry, staged, x, num_stages, keep)
    _check_signal(x, 2, entry)
    return _chain_launch(entry, staged, x.unsqueeze(0), num_stages, keep)[0]


def _two_legs(launch: Callable, entry: str, plain: Callable, fwd, bwd,
              d: torch.Tensor, x: torch.Tensor,
              num_stages: Optional[int]) -> torch.Tensor:
    """An operator or bank entry point: ``plain`` on a CPU tensor, else
    ``launch``; x is (B, R, n) for a batched entry, (R, n) for a B = 1
    one (launched as B = 1, the batch axis dropped again)."""
    if x.device.type == "cpu":
        return plain(fwd, bwd, d, x, num_stages)
    if entry.startswith("batched"):
        _check_signal(x, 3, entry)
        return launch(entry, fwd, bwd, d, x, num_stages)
    _check_signal(x, 2, entry)
    return launch(entry, fwd, bwd, d, x.unsqueeze(0), num_stages)[0]


def operator(entry: str, plain: Callable, fwd, bwd, diag: torch.Tensor,
             x: torch.Tensor, num_stages: Optional[int]) -> torch.Tensor:
    """An operator entry point: the fused operator kernel, diag (B, n)
    or (n,)."""
    return _two_legs(_operator_launch, entry, plain, fwd, bwd, diag, x,
                     num_stages)


def bank(entry: str, plain: Callable, fwd, bwd, gains: torch.Tensor,
         x: torch.Tensor, num_stages: Optional[int]) -> torch.Tensor:
    """A filter-bank entry point: the bank kernel, gains (B, F, n) ->
    (B, F, R, n) for a batched entry, (F, n) -> (F, R, n) for a B = 1
    one."""
    return _two_legs(_bank_launch, entry, plain, fwd, bwd, gains, x,
                     num_stages)
