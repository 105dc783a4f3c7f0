"""Conflict-free stage packing of G- and T-transform chains.

The paper applies its g transforms one after another.  Disjoint 2x2
transforms commute, so the ordered factor list is packed greedily (ASAP
list scheduling) into *stages* whose transforms touch pairwise-disjoint
coordinates; each stage then applies as one gather -> 2xFMA -> scatter
step over all its pairs at once (kernels/butterfly.py), and the chain's
dependency depth drops from O(g) to O(log n).

Anytime prefixes: packing is *chunked* along the greedy discovery order
(the paper's significance order).  Chunk boundaries are barriers, so
cutting the (S, P) tables at one of them yields exactly the operator of
the leading k components; the valid (num_stages, num_components) pairs
are the ``cuts`` metadata.  Adjoint tables are stage-MIRRORS of the
forward tables, so one ``num_stages`` cuts both directions.  For the G
family discovery order is the reverse of application order, so the
significant stages sit at the TAIL of the forward (synthesis) tables and
at the HEAD of the adjoint (analysis) tables.  For the T family
discovery order IS application order: the significant stages sit at the
HEAD of the forward tables and at the TAIL of the inverse tables.

Padding entries carry the OUT-OF-BOUNDS index ``n`` with (c=1, s=0,
sigma=1) for G and (alpha=1, beta=0) for T: the kernels give the signal
one dummy column ``n`` (or skip the entry), so a pad is a structural
no-op.

Packing happens on the host in numpy, once per factorization; only the
finished tables become torch tensors on the requested device.  For the
same factors the tables are bitwise those of the JAX package's packer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .types import SCALE, GFactors, TFactors

DEFAULT_NUM_CHUNKS = 4


class StagedG(NamedTuple):
    """G-transforms packed into conflict-free stages (padded to width P).

    ``idx_*``/``c``/``s``/``sigma`` are (S, P) tensors — (B, S, P) when
    batched; indices int32, values f32 (bf16 under ``with_precision``).
    ``cuts`` is host metadata: a (C, 2) int64 array of (num_stages,
    num_components) pairs at which truncating the stage axis is exact.
    ``n`` is the signal width and the pad index."""

    idx_i: torch.Tensor
    idx_j: torch.Tensor
    c: torch.Tensor
    s: torch.Tensor
    sigma: torch.Tensor
    cuts: Optional[np.ndarray]
    n: int

    @property
    def num_stages(self) -> int:
        return self.idx_i.shape[-2]


class StagedT(NamedTuple):
    """T-transforms packed into stages.  Unified per-entry action
    y_i = alpha x_i + beta x_j (only i is written) with (alpha, beta) =
    (1, a) for shears and (a, 0) for scalings (j == i).  Padding:
    (alpha=1, beta=0) at the out-of-bounds index ``n``.  Layout, dtypes
    and ``cuts`` as in ``StagedG``."""

    idx_i: torch.Tensor   # written coordinate
    idx_j: torch.Tensor   # read coordinate
    alpha: torch.Tensor
    beta: torch.Tensor
    cuts: Optional[np.ndarray]
    n: int

    @property
    def num_stages(self) -> int:
        return self.idx_i.shape[-2]


_G_TABLE_FIELDS = ("idx_i", "idx_j", "c", "s", "sigma")
_T_TABLE_FIELDS = ("idx_i", "idx_j", "alpha", "beta")


def _table_fields(staged) -> Tuple[str, ...]:
    return _T_TABLE_FIELDS if isinstance(staged, StagedT) else _G_TABLE_FIELDS


def table_arrays(staged) -> Tuple[torch.Tensor, ...]:
    """The device tables of a StagedG/StagedT without the host
    ``cuts``/``n`` tail — what plan programs take as their table
    arguments."""
    return tuple(staged[:len(_table_fields(staged))])


TABLE_PRECISIONS = ("f32", "bf16")
PRECISION_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def table_precision(staged) -> str:
    """"f32" or "bf16": the dtype of a table set's value tables (G: c, s,
    sigma; T: alpha, beta), which must all share one of the two."""
    values = {getattr(staged, f).dtype for f in _table_fields(staged)[2:]}
    for name, dtype in PRECISION_DTYPE.items():
        if values == {dtype}:
            return name
    raise TypeError(f"value tables must all be float32 or all bfloat16, "
                    f"got {sorted(map(str, values))}")


def with_precision(staged, precision: str):
    """Staged tables under a storage-precision policy.

    ``"f32"`` is the packing default.  ``"bf16"`` casts the VALUE tables
    (c, s, sigma for G; alpha, beta for T) to bfloat16, rounding to
    nearest even as the JAX package's cast does; the index tables stay
    int32 and ``cuts``/``n`` are untouched, so cut ladders and plan keys
    survive the cast.  Returns ``staged`` itself when its value tables
    already have the dtype.  Accumulation stays f32: every kernel and
    plain version widens a bf16 entry to the f32 signal's dtype before
    it uses it (kernels/ref.py, csrc/*.cu), so bf16 is a storage policy
    only."""
    if precision not in TABLE_PRECISIONS:
        raise ValueError(f"precision must be one of {TABLE_PRECISIONS}, "
                         f"got {precision!r}")
    dtype = PRECISION_DTYPE[precision]
    values = _table_fields(staged)[2:]
    if all(getattr(staged, f).dtype == dtype for f in values):
        return staged
    return staged._replace(**{f: getattr(staged, f).to(dtype)
                              for f in values})


_G_PAD_VALUES = (None, None, 1.0, 0.0, 1.0)   # idx fields use n
_T_PAD_VALUES = (None, None, 1.0, 0.0)


def pad_batch(staged, quantum: int):
    """Pad the leading batch axis of (B, S, P) tables up to a multiple of
    ``quantum`` with whole no-op rows (the per-device batch quantum of a
    placement, runtime/sharding.py).

    Every entry of a pad row is the structural no-op (out-of-bounds index
    ``n`` and identity values: G (c, s, sigma) = (1, 0, 1), T
    (alpha, beta) = (1, 0)), so a pad row applies as the identity on its
    signal row, and padded tables on padded signals equal the original
    tables on the original signals.  ``cuts`` and ``n`` are
    batch-independent and survive unchanged.  Bitwise the JAX package's
    tables, at either value precision."""
    if quantum < 1:
        raise ValueError(f"pad_batch: quantum must be >= 1, got {quantum}")
    tables = table_arrays(staged)
    if tables[0].dim() != 3:
        raise ValueError("pad_batch expects batched (B, S, P) tables, got "
                         f"ndim={tables[0].dim()}")
    b = tables[0].shape[0]
    b_pad = -(-b // quantum) * quantum
    if b_pad == b:
        return staged
    pads = _T_PAD_VALUES if isinstance(staged, StagedT) else _G_PAD_VALUES
    upd = {}
    for field, pad_val in zip(_table_fields(staged), pads):
        arr = getattr(staged, field)
        fill = staged.n if pad_val is None else pad_val
        block = torch.full((b_pad - b,) + tuple(arr.shape[1:]), fill,
                           dtype=arr.dtype, device=arr.device)
        upd[field] = torch.cat([arr, block])
    return staged._replace(**upd)


# ---------------------------------------------------------------------------
# Prefix metadata helpers
# ---------------------------------------------------------------------------

def default_cut_ladder(num_transforms: int,
                       num_chunks: int = DEFAULT_NUM_CHUNKS) -> np.ndarray:
    """Component counts at which the staged tables are exactly cuttable:
    evenly spaced, including 0 and ``num_transforms``."""
    ks = {round(num_transforms * c / num_chunks)
          for c in range(num_chunks + 1)}
    return np.asarray(sorted(ks | {0, num_transforms}), np.int64)


def truncate_staged(staged, num_stages: Optional[int], keep: str = "head"):
    """Cut staged tables at a stage boundary: keep the first (``head``)
    or last (``tail``) ``num_stages`` stages (views, not copies).  Exact
    whenever ``num_stages`` is one of ``staged.cuts``."""
    if num_stages is None:
        return staged
    s_tot = staged.idx_i.shape[-2]
    if not 0 <= num_stages <= s_tot:
        raise ValueError(f"num_stages {num_stages} not in [0, {s_tot}]")
    if num_stages == s_tot:
        return staged
    if keep == "head":
        sl = slice(0, num_stages)
    elif keep == "tail":
        sl = slice(s_tot - num_stages, s_tot)
    else:
        raise ValueError(f"keep must be 'head' or 'tail', got {keep!r}")
    upd = {f: getattr(staged, f)[..., sl, :] for f in _table_fields(staged)}
    if isinstance(staged.cuts, np.ndarray):
        upd["cuts"] = staged.cuts[staged.cuts[:, 0] <= num_stages]
    return staged._replace(**upd)


def select_cut(staged, num_transforms: Optional[int] = None,
               fraction: Optional[float] = None) -> Tuple[int, int]:
    """The ladder entry ``(num_stages, num_components)`` whose component
    count is nearest a target (``num_transforms`` or ``fraction`` of the
    full chain); ties resolve to the larger cut, and a positive target
    never snaps to the empty (0, 0) cut."""
    if staged.cuts is None:
        raise ValueError("staged tables carry no cut metadata "
                         "(built outside the packers?)")
    cuts = np.asarray(staged.cuts)
    total = int(cuts[:, 1].max())
    if fraction is not None:
        if num_transforms is not None:
            raise ValueError("pass num_transforms or fraction, not both")
        num_transforms = fraction * total
    if num_transforms is None:
        raise ValueError("pass num_transforms or fraction")
    if num_transforms > 0:
        pos = cuts[cuts[:, 1] > 0]
        if len(pos):
            cuts = pos
    dist = np.abs(cuts[:, 1].astype(np.float64) - float(num_transforms))
    best = int(np.lexsort((-cuts[:, 1], dist))[0])
    return int(cuts[best, 0]), int(cuts[best, 1])


def _chunk_bounds(g: int, cuts: Optional[Sequence[int]],
                  significance_tail: bool) -> np.ndarray:
    """Factor-index barriers (application order) for a significance
    ladder; for the G family a significance prefix of k components is
    the application suffix [g-k, g)."""
    ladder = (default_cut_ladder(g) if cuts is None
              else np.asarray(sorted({0, g} | {int(k) for k in cuts
                                               if 0 <= int(k) <= g}),
                              np.int64))
    if significance_tail:
        return g - ladder[::-1]
    return ladder


def _chunked_schedule(touch_sets, bounds) -> Tuple[np.ndarray, int,
                                                   np.ndarray]:
    """ASAP list scheduling with barriers at ``bounds``.  Returns (stage
    per factor, num_stages, stage index of every barrier)."""
    stage_of = np.zeros(len(touch_sets), dtype=np.int64)
    stage_bounds = np.zeros(len(bounds), dtype=np.int64)
    base = 0
    for c, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        busy = {}
        depth = 0
        for k in range(a, b):
            st = 0
            for coord in touch_sets[k]:
                st = max(st, busy.get(int(coord), 0))
            stage_of[k] = base + st
            for coord in touch_sets[k]:
                busy[int(coord)] = st + 1
            depth = max(depth, st + 1)
        base += depth
        stage_bounds[c + 1] = base
    return stage_of, base, stage_bounds


def _pad_layout(stage_of, n_stages):
    """Common padded (S, P) layout: returns (slot per factor, P)."""
    counts = np.bincount(stage_of, minlength=max(n_stages, 1))
    width = max(int(counts.max(initial=1)), 1)
    slot = np.zeros_like(stage_of)
    seen = np.zeros(max(n_stages, 1), dtype=np.int64)
    for k, st in enumerate(stage_of):
        slot[k] = seen[st]
        seen[st] += 1
    return slot, width


def _cut_table(stage_bounds: np.ndarray, bounds: np.ndarray, g: int,
               n_stages: int, significance_tail: bool) -> np.ndarray:
    """(num_stages, num_components) rows for every exact barrier."""
    if significance_tail:
        rows = [(n_stages - int(sb), g - int(fb))
                for sb, fb in zip(stage_bounds, bounds)]
    else:
        rows = [(int(sb), int(fb))
                for sb, fb in zip(stage_bounds, bounds)]
    uniq = sorted(set(rows))
    return np.asarray(uniq, np.int64).reshape(-1, 2)


# ---------------------------------------------------------------------------
# Host-side (numpy) packers
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pack_g_np(factors: GFactors, n: int, cuts: Optional[Sequence[int]]):
    fi, fj, fc, fs, fsg = (_host(f) for f in factors)
    g = fi.shape[0]
    pairs = [(int(a), int(b)) for a, b in zip(fi, fj)]
    bounds = _chunk_bounds(g, cuts, significance_tail=True)
    stage_of, n_stages, stage_bounds = _chunked_schedule(pairs, bounds)
    slot, width = _pad_layout(stage_of, n_stages)
    n_stages = max(n_stages, 1)

    ii = np.full((n_stages, width), n, dtype=np.int32)
    jj = ii.copy()
    cc = np.ones((n_stages, width), fc.dtype)
    ss = np.zeros((n_stages, width), fs.dtype)
    sg = np.ones((n_stages, width), fsg.dtype)
    ii[stage_of, slot] = fi
    jj[stage_of, slot] = fj
    cc[stage_of, slot] = fc
    ss[stage_of, slot] = fs
    sg[stage_of, slot] = fsg
    cut = _cut_table(stage_bounds, bounds, g, n_stages,
                     significance_tail=True)
    return (ii, jj, cc, ss, sg), cut, stage_bounds


def _mirror_g_np(tables):
    """Stage-mirror of forward G tables: Ubar^T (reverse stage order;
    rotations flip s, reflections are symmetric; pads are fixed points)."""
    ii, jj, cc, ss, sg = tables
    s_adj = np.where(sg > 0, -ss, ss)
    return (ii[::-1].copy(), jj[::-1].copy(), cc[::-1].copy(),
            s_adj[::-1].copy(), sg[::-1].copy())


def _infer_n_g(factors: GFactors, n: Optional[int] = None) -> int:
    """Matrix side for a G-chain: the caller's ``n`` when given, else the
    largest factor coordinate + 1."""
    fi = _host(factors.i)
    fj = _host(factors.j)
    inferred = int(max(fi.max(initial=0), fj.max(initial=0))) + 1
    if n is None:
        return inferred
    if n < inferred:
        raise ValueError(f"explicit n={n} smaller than the largest factor "
                         f"coordinate ({inferred - 1})")
    return int(n)


def _staged(tables, cut, n, device, cls=StagedG):
    dev = torch.device(device)
    return cls(*(torch.from_numpy(np.ascontiguousarray(t)).to(dev)
                 for t in tables), cut, n)


def _pack_t_np(factors: TFactors, n: int, cuts: Optional[Sequence[int]]):
    fk, fi, fj, fa = (_host(f) for f in factors)
    m = fk.shape[0]
    # a scaling touches i; a shear reads j too, so no entry of a stage
    # writes a coordinate that another entry of the stage reads
    touch = [(int(fi[k]),) if fk[k] == SCALE else (int(fi[k]), int(fj[k]))
             for k in range(m)]
    bounds = _chunk_bounds(m, cuts, significance_tail=False)
    stage_of, n_stages, stage_bounds = _chunked_schedule(touch, bounds)
    slot, width = _pad_layout(stage_of, n_stages)
    n_stages = max(n_stages, 1)

    ii = np.full((n_stages, width), n, dtype=np.int32)
    jj = ii.copy()
    al = np.ones((n_stages, width), fa.dtype)
    be = np.zeros((n_stages, width), fa.dtype)
    is_scale = fk == SCALE
    ii[stage_of, slot] = fi
    jj[stage_of, slot] = np.where(is_scale, fi, fj)
    al[stage_of, slot] = np.where(is_scale, fa, 1.0)
    be[stage_of, slot] = np.where(is_scale, 0.0, fa)
    cut = _cut_table(stage_bounds, bounds, m, n_stages,
                     significance_tail=False)
    return (ii, jj, al, be), cut, stage_bounds


def _mirror_t_np(tables):
    """Stage-mirror of forward T tables: Tbar^{-1} (reverse stage order;
    per entry (alpha, beta) -> (1/alpha, -beta/alpha), which inverts
    shears, scalings and fixes pads (1, 0))."""
    ii, jj, al, be = tables
    inv_al = 1.0 / al
    inv_be = -be / al
    return (ii[::-1].copy(), jj[::-1].copy(), inv_al[::-1].copy(),
            inv_be[::-1].copy())


# ---------------------------------------------------------------------------
# Public single-matrix packers
# ---------------------------------------------------------------------------

def pack_g(factors: GFactors, cuts: Optional[Sequence[int]] = None,
           n: Optional[int] = None, device="cuda") -> StagedG:
    """Stage a G-chain (synthesis direction, Ubar); significant
    components land in the TAIL stages."""
    n = _infer_n_g(factors, n)
    tables, cut, _ = _pack_g_np(factors, n, cuts)
    return _staged(tables, cut, n, device)


def pack_g_adjoint(factors: GFactors, cuts: Optional[Sequence[int]] = None,
                   n: Optional[int] = None, device="cuda") -> StagedG:
    """Staged Ubar^T: the stage-mirror of ``pack_g(factors)``."""
    n = _infer_n_g(factors, n)
    tables, cut, _ = _pack_g_np(factors, n, cuts)
    return _staged(_mirror_g_np(tables), cut, n, device)


def pack_g_pair(factors: GFactors, cuts: Optional[Sequence[int]] = None,
                n: Optional[int] = None, device="cuda"
                ) -> Tuple[StagedG, StagedG]:
    """(forward, adjoint) staged forms from ONE scheduling pass."""
    n = _infer_n_g(factors, n)
    tables, cut, _ = _pack_g_np(factors, n, cuts)
    return (_staged(tables, cut, n, device),
            _staged(_mirror_g_np(tables), cut, n, device))


def pack_t(factors: TFactors, n: int, cuts: Optional[Sequence[int]] = None,
           device="cuda") -> StagedT:
    """Stage a T-chain (forward direction, Tbar); significant components
    land in the HEAD stages."""
    tables, cut, _ = _pack_t_np(factors, n, cuts)
    return _staged(tables, cut, n, device, StagedT)


def pack_t_inverse(factors: TFactors, n: int,
                   cuts: Optional[Sequence[int]] = None,
                   device="cuda") -> StagedT:
    """Staged Tbar^{-1}: the stage-mirror of ``pack_t(factors)``
    (significant components in the TAIL stages)."""
    tables, cut, _ = _pack_t_np(factors, n, cuts)
    return _staged(_mirror_t_np(tables), cut, n, device, StagedT)


def pack_t_pair(factors: TFactors, n: int,
                cuts: Optional[Sequence[int]] = None, device="cuda"
                ) -> Tuple[StagedT, StagedT]:
    """(forward, inverse) staged forms from ONE scheduling pass."""
    tables, cut, _ = _pack_t_np(factors, n, cuts)
    return (_staged(tables, cut, n, device, StagedT),
            _staged(_mirror_t_np(tables), cut, n, device, StagedT))


# ---------------------------------------------------------------------------
# Batched packers: (B, S, P) tables with chunk-uniform padding
# ---------------------------------------------------------------------------

def _stack_chunked(per_matrix, stage_bounds_list, pad_values, n,
                   pad: Optional[Tuple[int, int]] = None):
    """Stack per-matrix staged tables into (B, S, P), padding each CHUNK
    to the batch-max chunk depth (and each stage to the batch-max width),
    so every cut boundary sits at the same stage index for all B
    matrices.  ``pad``: optional (depth_quantum, width_quantum) shape
    quantization."""
    num_chunks = len(stage_bounds_list[0]) - 1
    depths = np.zeros(num_chunks, np.int64)
    for sb in stage_bounds_list:
        depths = np.maximum(depths, np.diff(sb))
    qd, qw = pad if pad is not None else (1, 1)
    if qd < 1 or qw < 1:
        raise ValueError(f"pad quanta must be >= 1, got {(qd, qw)}")
    depths = -(-depths // qd) * qd
    offs = np.concatenate([[0], np.cumsum(depths)])
    s_max = int(offs[-1]) if offs[-1] > 0 else 1
    p_max = max(t[0].shape[1] for t in per_matrix)
    p_max = int(-(-p_max // qw) * qw)
    batch = len(per_matrix)
    stacked = []
    for f, pad_val in enumerate(pad_values):
        arr = np.full((batch, s_max, p_max), pad_val,
                      per_matrix[0][f].dtype)
        for b, tables in enumerate(per_matrix):
            sb = stage_bounds_list[b]
            src = tables[f]
            for c in range(num_chunks):
                lo, hi = int(sb[c]), int(sb[c + 1])
                arr[b, int(offs[c]):int(offs[c]) + (hi - lo),
                    :src.shape[1]] = src[lo:hi]
        stacked.append(arr)
    return stacked, offs


def _pack_g_batch_np(factors: GFactors, n: int,
                     cuts: Optional[Sequence[int]],
                     pad: Optional[Tuple[int, int]] = None):
    host = GFactors(*(_host(f) for f in factors))
    batch, g = host.i.shape
    n = max(n, int(max(host.i.max(initial=0),
                       host.j.max(initial=0))) + 1)
    per, sbs = [], []
    for b in range(batch):
        tables, _, sb = _pack_g_np(GFactors(*(f[b] for f in host)), n,
                                   cuts)
        per.append(tables)
        sbs.append(sb)
    pads = (np.int32(n), np.int32(n), 1.0, 0.0, 1.0)
    stacked, offs = _stack_chunked(per, sbs, pads, n, pad)
    bounds = _chunk_bounds(g, cuts, significance_tail=True)
    n_stages = int(offs[-1]) if offs[-1] > 0 else 1
    cut = _cut_table(offs, bounds, g, n_stages, significance_tail=True)
    return stacked, cut, n


def _mirror_g_batch_np(stacked):
    """Batched stage-mirror (Ubar^T per matrix): flip the stage axis and
    adjoint each entry."""
    out = [np.ascontiguousarray(a[:, ::-1]) for a in stacked]
    sg = out[4]
    out[3] = np.where(sg > 0, -out[3], out[3])
    return out


def pack_g_batch(factors: GFactors, n: int, adjoint: bool = False,
                 cuts: Optional[Sequence[int]] = None,
                 pad: Optional[Tuple[int, int]] = None,
                 device="cuda") -> StagedG:
    """Pack a batch of G chains ((B, g) fields) into one StagedG with
    (B, S, P) tables sharing one cut ladder."""
    stacked, cut, n = _pack_g_batch_np(factors, n, cuts, pad)
    if adjoint:
        stacked = _mirror_g_batch_np(stacked)
    return _staged(stacked, cut, n, device)


def pack_g_batch_pair(factors: GFactors, n: int,
                      cuts: Optional[Sequence[int]] = None,
                      pad: Optional[Tuple[int, int]] = None,
                      device="cuda") -> Tuple[StagedG, StagedG]:
    """(forward, adjoint) batched staged forms from ONE scheduling +
    stacking pass."""
    stacked, cut, n = _pack_g_batch_np(factors, n, cuts, pad)
    return (_staged(stacked, cut, n, device),
            _staged(_mirror_g_batch_np(stacked), cut, n, device))


def _pack_t_batch_np(factors: TFactors, n: int,
                     cuts: Optional[Sequence[int]],
                     pad: Optional[Tuple[int, int]] = None):
    host = TFactors(*(_host(f) for f in factors))
    batch, m = host.kind.shape
    per, sbs = [], []
    for b in range(batch):
        tables, _, sb = _pack_t_np(TFactors(*(f[b] for f in host)), n, cuts)
        per.append(tables)
        sbs.append(sb)
    pads = (np.int32(n), np.int32(n), 1.0, 0.0)
    stacked, offs = _stack_chunked(per, sbs, pads, n, pad)
    bounds = _chunk_bounds(m, cuts, significance_tail=False)
    n_stages = int(offs[-1]) if offs[-1] > 0 else 1
    cut = _cut_table(offs, bounds, m, n_stages, significance_tail=False)
    return stacked, cut


def _mirror_t_batch_np(stacked):
    """Batched stage-mirror (Tbar^{-1} per matrix)."""
    al, be = stacked[2], stacked[3]
    out = [stacked[0], stacked[1], 1.0 / al, -be / al]
    return [np.ascontiguousarray(a[:, ::-1]) for a in out]


def pack_t_batch(factors: TFactors, n: int, inverse: bool = False,
                 cuts: Optional[Sequence[int]] = None,
                 pad: Optional[Tuple[int, int]] = None,
                 device="cuda") -> StagedT:
    """Pack a batch of T chains ((B, m) fields) into one StagedT with
    (B, S, P) tables sharing one cut ladder (``inverse=True`` mirrors
    the stages into Tbar^{-1} per matrix)."""
    stacked, cut = _pack_t_batch_np(factors, n, cuts, pad)
    if inverse:
        stacked = _mirror_t_batch_np(stacked)
    return _staged(stacked, cut, n, device, StagedT)


def pack_t_batch_pair(factors: TFactors, n: int,
                      cuts: Optional[Sequence[int]] = None,
                      pad: Optional[Tuple[int, int]] = None,
                      device="cuda") -> Tuple[StagedT, StagedT]:
    """(forward, inverse) batched staged forms from ONE scheduling +
    stacking pass."""
    stacked, cut = _pack_t_batch_np(factors, n, cuts, pad)
    return (_staged(stacked, cut, n, device, StagedT),
            _staged(_mirror_t_batch_np(stacked), cut, n, device, StagedT))
