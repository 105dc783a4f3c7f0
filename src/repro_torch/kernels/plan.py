"""Declarative execution plans: ONE way to run every staged-table apply.

An ``ApplyPlan`` names a computation over staged tables — family
("sym": G-transforms, "general": T-transforms), mode (plain transform
apply, fused ``Ubar diag(d) Ubar^T`` / ``Tbar diag(d) Tbar^{-1}``
operator, or a filter bank of F such operators sharing one analysis),
batching, anytime ladder cut, device and backend — and ``program()``
returns the ONE cached callable that runs it.  Programs take the staged
tables as arguments, so a basis swap with the same shapes reuses the
program.

Program signatures (``tables`` = ``core/staging.py::table_arrays``):

  * mode "apply":     ``program(tables, x)``
  * mode "operator":  ``program(fwd_tables, bwd_tables, diag, x)``
  * mode "bank":      ``program(fwd_tables, bwd_tables, gains, x)`` with
    gains (F, n) -> (F, ..., n), or batched (B, F, n) -> (B, F, ..., n)

Backends: ``"cuda"`` runs the hand-written kernels of
kernels/butterfly.py, kernels/shear.py and kernels/spectral.py (on a CPU
tensor their wrappers use the plain version); ``"torch"`` runs the plain
PyTorch versions of kernels/ref.py on any device.  A plan defaults to
``"cuda"`` on a CUDA device and to ``"torch"`` on the CPU; ``"torch"``
on a CUDA device exists so that the kernels can be compared with their
plain versions on the card.

Precision policy: ``precision="bf16"`` stores the value tables in
bfloat16 (``prepare`` casts them, indices stay int32) while accumulating
in f32: the program runs the walk on the signal raised to f32 and
returns the result in the caller's dtype, and the kernels (and the plain
versions) widen each entry to the f32 signal's dtype as they use it, as
the JAX package's ``table_op`` and Pallas kernels do.  An f32 plan takes
f32 signals on the card; a bf16 signal computed in bf16 there is not
ported.

``fused=False`` compiles the operator to the three-pass baseline
(analysis apply, diagonal scale, synthesis apply as separate calls), the
parity oracle of the fused path; a bank then runs F such three-pass
operators, re-running the analysis per filter.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.staging import (TABLE_PRECISIONS, StagedG, StagedT,
                                      table_arrays)
from . import butterfly as _bf
from .launcher import cast_tables, leg_orientation
from . import ref as _ref
from . import shear as _sh
from . import spectral as _sp

PLAN_FAMILIES = ("sym", "general")
PLAN_MODES = ("apply", "operator", "bank")
PLAN_BACKENDS = ("cuda", "torch")
PLAN_PRECISIONS = TABLE_PRECISIONS


def _not_ported(what: str, slice_name: str) -> ValueError:
    return ValueError(f"{what} is not ported yet: it comes with the "
                      f"{slice_name} slice of repro_torch")


@dataclass(frozen=True)
class ApplyPlan:
    """One declarative execution plan (hashable: it IS the cache key).

    ``family``: "sym" | "general".  ``mode``: "apply" | "operator" |
    "bank".
    ``n``: table width.  ``num_stages``: anytime ladder cut ("apply"
    also takes ``keep``; operator legs use ``leg_orientation``).
    ``device``: where the tables and signals live.  ``backend``: None
    resolves from the device (see module docstring)."""

    family: str
    mode: str
    n: int
    batched: bool = False
    backend: Optional[str] = None
    num_stages: Optional[int] = None
    keep: str = "head"
    precision: str = "f32"
    fused: bool = True
    device: str = "cuda"
    #: not ported yet (each raises when set): mesh placement, tile size
    placement: Optional[object] = None
    block_b: Optional[int] = None

    def __post_init__(self):
        if self.placement is not None:
            raise _not_ported("placement=", "multi-GPU placement")
        if self.block_b is not None:
            raise _not_ported("block_b= (tile autotune)", "autotune")
        if self.family not in PLAN_FAMILIES:
            raise ValueError(f"family must be one of {PLAN_FAMILIES}, "
                             f"got {self.family!r}")
        if self.mode not in PLAN_MODES:
            raise ValueError(f"mode must be one of {PLAN_MODES}, "
                             f"got {self.mode!r}")
        if self.precision not in PLAN_PRECISIONS:
            raise ValueError(f"precision must be one of {PLAN_PRECISIONS}, "
                             f"got {self.precision!r}")
        if self.keep not in ("head", "tail"):
            raise ValueError(f"keep must be 'head' or 'tail', "
                             f"got {self.keep!r}")
        if self.n <= 0:
            raise ValueError(f"n must be positive, got {self.n}")
        dev = torch.device(self.device)
        object.__setattr__(self, "device", str(dev))
        if self.backend is None:
            object.__setattr__(self, "backend",
                               "cuda" if dev.type == "cuda" else "torch")
        if self.backend not in PLAN_BACKENDS:
            raise ValueError(f"backend must be one of {PLAN_BACKENDS}, "
                             f"got {self.backend!r}")
        if self.mode != "apply" and self.keep != "head":
            # operator legs derive their own orientation; canonical
            # keep="head" keeps equivalent plans on one cache entry
            object.__setattr__(self, "keep", "head")

    @classmethod
    def for_staged(cls, staged, mode: str = "apply",
                   **kwargs) -> "ApplyPlan":
        """Infer family, width, batching and device from a
        StagedG/StagedT."""
        kwargs.setdefault("device", str(staged.idx_i.device))
        family = "general" if isinstance(staged, StagedT) else "sym"
        return cls(family=family, mode=mode, n=staged.n,
                   batched=staged.idx_i.dim() == 3, **kwargs)

    # -- tables and programs ---------------------------------------------

    def prepare(self, staged) -> tuple:
        """The table tuple a program takes, on the plan's device, under
        the plan's precision policy (``core/staging.py::with_precision``;
        the cast is kept beside the tables it came from,
        ``launcher.cast_tables``, so repeated one-shot calls share it)."""
        dev = torch.device(self.device)
        staged = type(staged)(*(t.to(dev) for t in table_arrays(staged)),
                              staged.cuts, staged.n)
        return table_arrays(cast_tables(staged, self.precision))

    def program(self):
        """The plan's program: ONE process-wide cache entry per plan (two
        equal plans return the identical program object)."""
        before = _compile.cache_info().misses
        prog = _compile(self)
        # the miss counter increments inside _compile, the only place a
        # program is built; a lookup that left `misses` untouched was a
        # hit
        if _compile.cache_info().misses == before:
            _PLAN_HITS.inc(**self._obs_labels())
        return prog

    def _obs_labels(self) -> dict:
        return {"family": self.family, "mode": self.mode,
                "backend": self.backend, "n": self.n}

    def apply(self, staged, x: torch.Tensor) -> torch.Tensor:
        return self.program()(self.prepare(staged), x)

    def operator(self, fwd, bwd, diag: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
        return self.program()(self.prepare(fwd), self.prepare(bwd), diag, x)

    def bank(self, fwd, bwd, gains: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
        return self.program()(self.prepare(fwd), self.prepare(bwd), gains,
                              x)

    # -- dispatch ----------------------------------------------------------

    def _staged(self, tables: tuple):
        cls = StagedT if self.family == "general" else StagedG
        return cls(*tables, None, self.n)

    def _dispatch(self):
        """tables -> tensors map implementing the plan: the ONE place
        where kernel entry points, reshapes and cut orientations meet."""
        cut, keep, n = self.num_stages, self.keep, self.n
        fn = _ENTRY[(self.family, self.mode, self.backend, self.batched)]
        if self.mode == "apply":
            if self.backend == "torch":
                return lambda t, x: fn(self._staged(t), x, cut, keep)
            if self.batched:
                return lambda t, x: fn(
                    self._staged(t),
                    x.reshape(x.shape[0], -1, n).contiguous(),
                    cut, keep).reshape(x.shape)
            return lambda t, x: fn(
                self._staged(t), x.reshape(-1, n).contiguous(),
                cut, keep).reshape(x.shape)
        if self.backend == "torch":
            return lambda ft, bt, d, x: fn(self._staged(ft),
                                            self._staged(bt), d, x, cut)
        # the kernel's (B, [F,] M, n) / ([F,] M, n) back to x's row axes;
        # d is the spectrum of an operator, the gains of a bank
        if self.batched:
            def batched(ft, bt, d, x):
                y = fn(self._staged(ft), self._staged(bt), d,
                       x.reshape(x.shape[0], -1, n).contiguous(), cut)
                return y.reshape(y.shape[:-2] + x.shape[1:])
            return batched

        def single(ft, bt, d, x):
            y = fn(self._staged(ft), self._staged(bt), d,
                   x.reshape(-1, n).contiguous(), cut)
            return y.reshape(y.shape[:-2] + x.shape)
        return single

    def _three_pass(self):
        """The UNFUSED operator: analysis, diagonal scale and synthesis
        as separate calls through cached "apply" plans; the unfused bank
        runs one such operator per filter (F analyses) and stacks them
        on the filter axis."""
        a_keep, s_keep = leg_orientation(self.family)
        analysis = replace(self, mode="apply", keep=a_keep,
                           fused=True).program()
        synthesis = replace(self, mode="apply", keep=s_keep,
                            fused=True).program()
        batched = self.batched

        def three_pass(fwd_t, bwd_t, d, x):
            xh = analysis(bwd_t, x)
            if batched:                   # d (B, n) against xh (B, ..., n)
                d = d.reshape(d.shape[:1] + (1,) * (xh.dim() - 2)
                              + d.shape[-1:])
            return synthesis(fwd_t, xh * d.to(xh.dtype))
        if self.mode == "operator":
            return three_pass

        def three_pass_bank(fwd_t, bwd_t, gains, x):
            axis = 1 if batched else 0
            return torch.stack([three_pass(fwd_t, bwd_t, g, x)
                                for g in gains.unbind(axis)], dim=axis)
        return three_pass_bank


#: (family, mode, backend, batched) -> the entry point a plan dispatches to
_ENTRY = {
    ("sym", "apply", "torch", True): _ref.batched_g_apply,
    ("sym", "apply", "torch", False): _ref.staged_g_apply,
    ("sym", "apply", "cuda", True): _bf.batched_butterfly_apply,
    ("sym", "apply", "cuda", False): _bf.butterfly_apply,
    ("sym", "operator", "torch", True): _ref.batched_sym_operator_apply,
    ("sym", "operator", "torch", False): _ref.sym_operator_apply,
    ("sym", "operator", "cuda", True): _bf.batched_sym_operator_apply,
    ("sym", "operator", "cuda", False): _bf.sym_operator_apply,
    ("general", "apply", "torch", True): _ref.batched_t_apply,
    ("general", "apply", "torch", False): _ref.staged_t_apply,
    ("general", "apply", "cuda", True): _sh.batched_shear_apply,
    ("general", "apply", "cuda", False): _sh.shear_apply,
    ("general", "operator", "torch", True): _ref.batched_gen_operator_apply,
    ("general", "operator", "torch", False): _ref.gen_operator_apply,
    ("general", "operator", "cuda", True): _sh.batched_gen_operator_apply,
    ("general", "operator", "cuda", False): _sh.gen_operator_apply,
    ("sym", "bank", "torch", True): _ref.batched_sym_filter_bank_apply,
    ("sym", "bank", "torch", False): _ref.sym_filter_bank_apply,
    ("sym", "bank", "cuda", True): _sp.batched_sym_filter_bank_apply,
    ("sym", "bank", "cuda", False): _sp.sym_filter_bank_apply,
    ("general", "bank", "torch", True): _ref.batched_gen_filter_bank_apply,
    ("general", "bank", "torch", False): _ref.gen_filter_bank_apply,
    ("general", "bank", "cuda", True): _sp.batched_gen_filter_bank_apply,
    ("general", "bank", "cuda", False): _sp.gen_filter_bank_apply,
}


def _accumulate_f32(op):
    """The bf16 policy around a program: the walk runs on the signal
    raised to f32 (the tables stay bf16 and are widened entry by entry),
    and the result returns in the caller's dtype."""
    def accumulate_f32(*args):
        x = args[-1]
        return op(*args[:-1], x.float()).to(x.dtype)
    return accumulate_f32


#: plan-cache telemetry, the JAX package's metrics: misses count INSIDE
#: the lru-cached ``_compile`` body, the only code path where a program
#: is built, so the compile spans in the trace equal the plan-cache
#: misses by construction
_PLAN_HITS = obs.counter(
    "plan_cache_hits_total",
    "plan-cache lookups served by an already-compiled program",
    ("family", "mode", "backend", "n"))
_PLAN_MISSES = obs.counter(
    "plan_cache_misses_total",
    "staged-program compilations (plan-cache misses)",
    ("family", "mode", "backend", "n"))


@functools.lru_cache(maxsize=None)
def _compile(plan: ApplyPlan):
    """THE plan cache: every tier/refit/core program lives here.  In the
    port a "compilation" builds the dispatch closure over the entry
    points (the kernels themselves are built once per process by
    kernels/build.py); the ``plan_compile`` span times that build."""
    labels = plan._obs_labels()
    _PLAN_MISSES.inc(**labels)
    with obs.default_tracer().span(
            "plan_compile", cat="compile",
            args={**labels, "fused": plan.fused,
                  "num_stages": plan.num_stages,
                  "precision": plan.precision}):
        if plan.mode != "apply" and not plan.fused:
            op = plan._three_pass()
        else:
            op = plan._dispatch()
        return op if plan.precision == "f32" else _accumulate_f32(op)


def plan_cache_stats() -> dict:
    """Hit/miss/size counters of the plan cache."""
    info = _compile.cache_info()
    return {"hits": int(info.hits), "misses": int(info.misses),
            "currsize": int(info.currsize)}


def clear_plan_cache() -> None:
    """Drop every cached plan program (and reset the counters)."""
    _compile.cache_clear()
