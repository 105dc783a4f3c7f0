"""Launching the hand-written CUDA staged-chain kernels (csrc/*.cu).

One launcher serves every table family: ``chain``, ``operator`` and
``bank`` take an entry point's name, dispatch a CPU tensor to the plain
PyTorch version they are given (kernels/ref.py), and otherwise check the
arguments and launch the entry point's kernel on PyTorch's current
stream, or raise (no nvcc, failed build, wrong dtype/shape/device):
there is no fallback.
Signals and values are f32, indices int32; other dtypes raise.  The
anytime cut is passed to the kernel as a runtime (first stage, count) per
leg, each operator or bank leg cut at its family's ``leg_orientation``.

Every launch adds one to its entry point's count, in ONE registry for all
families: ``entry_launch_counts()`` per entry point, ``launch_counts()``
summed per kernel, ``reset_launch_counts()`` zeroes both.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.staging import StagedT, table_arrays
from . import build
from .ref import check_gains

#: entry point -> the kernel it launches (its C launcher is
#: ``<kernel without _kernel>_launch``)
KERNEL_OF = {"batched_butterfly_apply": "g_chain_kernel",
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
KERNELS = tuple(dict.fromkeys(KERNEL_OF.values()))
THREADS = 256
_MAX_ROWS = 128
_launches = dict.fromkeys(KERNEL_OF, 0)


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


def _check_signal(x: torch.Tensor, ndim: int, what: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: signals must be float32, got {x.dtype} "
                        "(bf16 belongs to the precision slice)")
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
    """Validate a StagedG/StagedT table set against the signal; returns
    (S, P)."""
    if staged.n != n:
        raise ValueError(f"{what}: tables are for n={staged.n}, signal has "
                         f"n={n}")
    shape = tuple(staged.idx_i.shape)
    want_dim = 2 if batch is None else 3
    if len(shape) != want_dim or (batch is not None and shape[0] != batch):
        raise ValueError(f"{what}: tables of shape {shape} do not match "
                         f"{'(S, P)' if batch is None else f'({batch}, S, P)'}")
    for name, t in zip(staged._fields, table_arrays(staged)):
        dt = (torch.int32 if name.startswith("idx_")
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


def rows_per_tile(batch: int, rows: int, n: int, device: torch.device,
                  tiles: int = 1) -> int:
    """Signal rows per CTA: at most 128, with ``tiles`` tiles of that many
    rows within the shared memory a block may opt into (a bank holds
    two), halved while the grid would not give every SM two CTAs
    (barrier stalls of one CTA then overlap another's work)."""
    lib = build.library()
    ld = (n + 1) | 1
    smem = lib.repro_max_smem_optin()
    if smem <= 0:
        raise RuntimeError("cannot read the device's shared memory limit")
    cap = smem // (tiles * ld * 4)
    if cap < 1:
        raise ValueError(f"n={n} is too wide for {tiles} shared-memory "
                         f"row(s) ({tiles * ld * 4} bytes > {smem})")
    rpt = max(1, min(rows, _MAX_ROWS, cap))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    while rpt > 16 and batch * -(-rows // rpt) < 2 * sms:
        rpt //= 2
    return rpt


def _padded_diag(diag: torch.Tensor, x3: torch.Tensor, batched: bool,
                 what: str) -> torch.Tensor:
    """Validate the spectrum; return it (B, n+1) with 1.0 in the dummy
    column n."""
    bsz, _, n = x3.shape
    want = (bsz, n) if batched else (n,)
    if tuple(diag.shape) != want:
        raise ValueError(f"{what}: diag shape {tuple(diag.shape)} != {want}")
    if diag.device != x3.device or diag.dtype != torch.float32:
        raise TypeError(f"{what}: diag must be float32 on the signal's "
                        "device")
    dp = torch.ones((bsz, n + 1), dtype=torch.float32, device=x3.device)
    dp[:, :n] = diag
    return dp


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


def _leg(staged, x3: torch.Tensor, batched: bool, num_stages: Optional[int],
         keep: str, what: str) -> tuple:
    """A leg's C arguments: table pointers, matrix stride, P, first stage
    and stage count."""
    bsz, _, n = x3.shape
    s_tot, p = _check_tables(staged, x3.device, bsz if batched else None, n,
                             what)
    return (*(t.data_ptr() for t in table_arrays(staged)),
            s_tot * p if batched else 0, p,
            *_leg_range(s_tot, num_stages, keep))


def _launch(entry: str, x3: torch.Tensor, head: tuple, legs: tuple,
            filters: Optional[int] = None) -> torch.Tensor:
    """Launch ``entry``'s kernel on x3 (B, R, n): ``head`` holds the C
    arguments before the signal's shape (the spectrum of an operator,
    the gains and filter count of a bank), ``legs`` those of its legs.
    A bank (``filters`` = F) writes (B, F, R, n) from two shared tiles."""
    bsz, r, n = x3.shape
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the grid's 65535 matrices")
    y = (torch.empty_like(x3) if filters is None
         else x3.new_empty((bsz, filters, r, n)))
    if bsz == 0 or r == 0:
        return y
    kernel = KERNEL_OF[entry]
    lib = build.library()
    launch = getattr(lib, kernel.replace("_kernel", "_launch"))
    tiles = 1 if filters is None else 2
    code = launch(x3.data_ptr(), y.data_ptr(), *head, bsz, r, n, *legs,
                  rows_per_tile(bsz, r, n, x3.device, tiles), THREADS,
                  torch.cuda.current_stream(x3.device).cuda_stream)
    build.check(lib, code, f"{kernel} launch")
    _launches[entry] += 1
    return y


def _chain_launch(entry: str, staged, x3: torch.Tensor,
                  num_stages: Optional[int], keep: str) -> torch.Tensor:
    leg = _leg(staged, x3, entry.startswith("batched"), num_stages, keep,
               KERNEL_OF[entry])
    return _launch(entry, x3, (), leg)


def _operator_legs(entry: str, fwd, bwd, x3: torch.Tensor,
                   num_stages: Optional[int]) -> tuple:
    """bwd is the analysis leg (G adjoint, T inverse), fwd the synthesis
    leg, each cut at its family's orientation."""
    batched = entry.startswith("batched")
    kernel = KERNEL_OF[entry]
    a_keep, s_keep = leg_orientation(
        "general" if isinstance(fwd, StagedT) else "sym")
    return (_leg(bwd, x3, batched, num_stages, a_keep, f"{kernel} bwd")
            + _leg(fwd, x3, batched, num_stages, s_keep, f"{kernel} fwd"))


def _operator_launch(entry: str, fwd, bwd, diag: torch.Tensor,
                     x3: torch.Tensor,
                     num_stages: Optional[int]) -> torch.Tensor:
    legs = _operator_legs(entry, fwd, bwd, x3, num_stages)
    dp = _padded_diag(diag, x3, entry.startswith("batched"),
                      KERNEL_OF[entry])
    return _launch(entry, x3, (dp.data_ptr(),), legs)


def _bank_launch(entry: str, fwd, bwd, gains: torch.Tensor,
                 x3: torch.Tensor,
                 num_stages: Optional[int]) -> torch.Tensor:
    """(B, F, R, n): the analysis leg once, then scale and synthesis per
    filter, both legs cut as the operator's."""
    legs = _operator_legs(entry, fwd, bwd, x3, num_stages)
    gp = _padded_gains(gains, x3, entry.startswith("batched"),
                       KERNEL_OF[entry])
    return _launch(entry, x3, (gp.data_ptr(), gp.shape[1]), legs,
                   filters=gp.shape[1])


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
