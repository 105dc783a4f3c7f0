"""Wrappers of the hand-written CUDA G-chain kernels (csrc/butterfly.cu).

Four entry points, the port of the JAX package's Pallas TPU kernels in
``repro/kernels/butterfly.py`` (same names, same table layout):

  ``batched_butterfly_apply``     y[b] = Ubar_b x[b]          g_chain_kernel
  ``butterfly_apply``             the same with one table set  g_chain_kernel, B = 1
  ``batched_sym_operator_apply``  y[b] = Ubar_b diag(d_b) Ubar_b^T x[b]
                                                              g_operator_kernel
  ``sym_operator_apply``          the same with one table set  g_operator_kernel, B = 1

A tensor on the CPU goes to the plain PyTorch version (kernels/ref.py);
a CUDA tensor launches the kernel on PyTorch's current stream or raises
(no nvcc, failed build, wrong dtype/shape/device): there is no fallback.
Signals and values are f32, indices int32; other dtypes raise.  The
anytime cut is passed to the kernel as a runtime (first stage, count)
per leg.  Each launch adds one to its entry point's count
(``entry_launch_counts()``); ``launch_counts()`` sums them per kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.staging import StagedG
from . import build
from . import ref as _ref

KERNELS = ("g_chain_kernel", "g_operator_kernel")
#: entry point -> the kernel it launches
KERNEL_OF = {"batched_butterfly_apply": "g_chain_kernel",
             "butterfly_apply": "g_chain_kernel",
             "batched_sym_operator_apply": "g_operator_kernel",
             "sym_operator_apply": "g_operator_kernel"}
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


def _check_tables(staged: StagedG, device: torch.device, batch: Optional[int],
                  n: int, what: str) -> Tuple[int, int]:
    """Validate a table set against the signal; returns (S, P)."""
    if staged.n != n:
        raise ValueError(f"{what}: tables are for n={staged.n}, signal has "
                         f"n={n}")
    shape = tuple(staged.idx_i.shape)
    want_dim = 2 if batch is None else 3
    if len(shape) != want_dim or (batch is not None and shape[0] != batch):
        raise ValueError(f"{what}: tables of shape {shape} do not match "
                         f"{'(S, P)' if batch is None else f'({batch}, S, P)'}")
    for name, t, dt in (("idx_i", staged.idx_i, torch.int32),
                        ("idx_j", staged.idx_j, torch.int32),
                        ("c", staged.c, torch.float32),
                        ("s", staged.s, torch.float32),
                        ("sigma", staged.sigma, torch.float32)):
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


def rows_per_tile(batch: int, rows: int, n: int,
                  device: torch.device) -> int:
    """Signal rows per CTA: at most 128, within the shared memory a block
    may opt into, halved while the grid would not give every SM two
    CTAs (barrier stalls of one CTA then overlap another's work)."""
    lib = build.library()
    ld = (n + 1) | 1
    smem = lib.repro_max_smem_optin()
    if smem <= 0:
        raise RuntimeError("cannot read the device's shared memory limit")
    cap = smem // (ld * 4)
    if cap < 1:
        raise ValueError(f"n={n} is too wide for one shared-memory row "
                         f"({ld * 4} bytes > {smem})")
    rpt = max(1, min(rows, _MAX_ROWS, cap))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    while rpt > 16 and batch * -(-rows // rpt) < 2 * sms:
        rpt //= 2
    return rpt


def _ptrs(staged: StagedG):
    return (staged.idx_i.data_ptr(), staged.idx_j.data_ptr(),
            staged.c.data_ptr(), staged.s.data_ptr(),
            staged.sigma.data_ptr())


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _chain(staged: StagedG, x3: torch.Tensor, batched: bool,
           num_stages: Optional[int], keep: str, entry: str) -> torch.Tensor:
    bsz, r, n = x3.shape
    s_tot, p = _check_tables(staged, x3.device, bsz if batched else None, n,
                             "g_chain_kernel")
    s0, ns = _leg_range(s_tot, num_stages, keep)
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the grid's 65535 matrices")
    y = torch.empty_like(x3)
    if bsz == 0 or r == 0:
        return y
    lib = build.library()
    rpt = rows_per_tile(bsz, r, n, x3.device)
    code = lib.g_chain_launch(
        x3.data_ptr(), y.data_ptr(), bsz, r, n, *_ptrs(staged),
        s_tot * p if batched else 0, p, s0, ns, rpt, THREADS,
        _stream(x3.device))
    build.check(lib, code, "g_chain_kernel launch")
    _launches[entry] += 1
    return y


def _operator(fwd: StagedG, adj: StagedG, diag: torch.Tensor,
              x3: torch.Tensor, batched: bool,
              num_stages: Optional[int], entry: str) -> torch.Tensor:
    bsz, r, n = x3.shape
    tb = bsz if batched else None
    sa, pa = _check_tables(adj, x3.device, tb, n, "g_operator_kernel adj")
    sf, pf = _check_tables(fwd, x3.device, tb, n, "g_operator_kernel fwd")
    a0, na = _leg_range(sa, num_stages, "head")
    f0, nf = _leg_range(sf, num_stages, "tail")
    want = (bsz, n) if batched else (n,)
    if tuple(diag.shape) != want:
        raise ValueError(f"g_operator_kernel: diag shape {tuple(diag.shape)}"
                         f" != {want}")
    if diag.device != x3.device or diag.dtype != torch.float32:
        raise TypeError("g_operator_kernel: diag must be float32 on the "
                        "signal's device")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the grid's 65535 matrices")
    # the (B, n+1) spectrum with 1.0 in the dummy column n
    dp = torch.ones((bsz, n + 1), dtype=torch.float32, device=x3.device)
    dp[:, :n] = diag
    y = torch.empty_like(x3)
    if bsz == 0 or r == 0:
        return y
    lib = build.library()
    rpt = rows_per_tile(bsz, r, n, x3.device)
    code = lib.g_operator_launch(
        x3.data_ptr(), y.data_ptr(), dp.data_ptr(), bsz, r, n,
        *_ptrs(adj), sa * pa if batched else 0, pa, a0, na,
        *_ptrs(fwd), sf * pf if batched else 0, pf, f0, nf,
        rpt, THREADS, _stream(x3.device))
    build.check(lib, code, "g_operator_kernel launch")
    _launches[entry] += 1
    return y


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def batched_butterfly_apply(staged: StagedG, x: torch.Tensor,
                            num_stages: Optional[int] = None,
                            keep: str = "head") -> torch.Tensor:
    """y[b] = Ubar_b x[b]: tables (B, S, P), x (B, R, n) -> (B, R, n)."""
    if x.device.type == "cpu":
        return _ref.batched_g_apply(staged, x, num_stages, keep)
    _check_signal(x, 3, "batched_butterfly_apply")
    return _chain(staged, x, True, num_stages, keep,
                  "batched_butterfly_apply")


def butterfly_apply(staged: StagedG, x: torch.Tensor,
                    num_stages: Optional[int] = None,
                    keep: str = "head") -> torch.Tensor:
    """y = Ubar x for rows of x (R, n) with (S, P) tables (B = 1)."""
    if x.device.type == "cpu":
        return _ref.staged_g_apply(staged, x, num_stages, keep)
    _check_signal(x, 2, "butterfly_apply")
    return _chain(staged, x.unsqueeze(0), False, num_stages, keep,
                  "butterfly_apply")[0]


def batched_sym_operator_apply(fwd: StagedG, adj: StagedG,
                               diag: torch.Tensor, x: torch.Tensor,
                               num_stages: Optional[int] = None
                               ) -> torch.Tensor:
    """y[b] = Ubar_b diag(d_b) Ubar_b^T x[b] in one launch: tables
    (B, S, P), diag (B, n), x (B, R, n).  ``num_stages`` cuts the
    adjoint's head and the forward tables' tail."""
    if x.device.type == "cpu":
        return _ref.batched_sym_operator_apply(fwd, adj, diag, x, num_stages)
    _check_signal(x, 3, "batched_sym_operator_apply")
    return _operator(fwd, adj, diag, x, True, num_stages,
                     "batched_sym_operator_apply")


def sym_operator_apply(fwd: StagedG, adj: StagedG, diag: torch.Tensor,
                       x: torch.Tensor,
                       num_stages: Optional[int] = None) -> torch.Tensor:
    """y = Ubar diag(d) Ubar^T x for rows of x (R, n), tables (S, P),
    diag (n,) (B = 1)."""
    if x.device.type == "cpu":
        return _ref.sym_operator_apply(fwd, adj, diag, x, num_stages)
    _check_signal(x, 2, "sym_operator_apply")
    return _operator(fwd, adj, diag, x.unsqueeze(0), False, num_stages,
                     "sym_operator_apply")[0]
