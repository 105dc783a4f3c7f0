"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--baseline DIR [DIR ...]]

Phases (any failure exits non-zero; no phase swallows its own failure).
[main-filter], [main-dynamic] and [main-bf16] fit [main]'s fleet at its g
and n_iter again through their CLIs; the G greedy of those fits is not run
again but copied from [main]'s (``reuse_g_greedy``, a ``[reuse]`` line
each), so that the run stays well inside its time limit:

1. build   — compile the hand-written CUDA kernels (every csrc/*.cu, one
             nvcc process per source, all started together) from this
             checkout and load them.
2. kernels — hold each kernel against its plain PyTorch version on the card:
             the G kernels (csrc/butterfly.cu) and the T kernels
             (csrc/shear.cu), chain, operator and bank, batched and B = 1,
             at n in {16, 48} on tables of small port fits (symmetric and
             directed), R = 130 signal rows (a ragged tile edge), at every
             ladder cut including 0, the chains at both keeps, the banks at
             F in {1, 7, 33} (33 filters split into several filter groups
             per row tile where the grid needs them; the geometry of each
             check is printed).  The same checks run on the same tables
             cast to bf16 (the bf16 forms of all 12 entry points, G chains
             now at both keeps), each bf16 form also against its own f32
             form on the widened tables (max|dy| printed).  Then the batch
             split, f32 and bf16: a batch of 7 at a grid limit forced down
             to 3 matrices (launcher._GRID_B) launches each family's
             chain, operator and bank three times, and each equals its
             unsplit launch bitwise.
3. main    — the port's main path at a realistic size, through the CLI entry
             point: ``python -m repro_torch.launch.serve --fgft`` with B = 64
             community graphs, n = 256, g = 2 n log2 n = 4096, R = 256,
             tiers full/balanced/draft.  Launch counters are zeroed just
             before and read just after; both batched entry points must
             have launched.  The full tier's relative error must be < 0.05
             and equal the dense ||L - U diag(s) U^T||^2 / ||L||^2 within
             1e-3 relative, and the served output must match the plain
             version.
3b. main-filter — the filter-bank path through the CLI: ``serve --fgft
             --filter heat,tikhonov,wavelets:4`` on the same fleet (B = 64,
             n = 256, g = 4096, R = 256, F = 7).  Counters are zeroed just
             before and read just after: ``batched_sym_filter_bank_apply``
             must have launched.  The served (B, F, R, n) bank must match
             its plain version, each filter the operator kernel with that
             filter's gains (``engine.step``), and each filter the dense
             ``eigh`` filtering within 2 max(Lip(h), 1) delta + 5e-3 per
             graph (delta = sqrt(relative error); the worst ratio is
             printed).
4. fgft    — the single-graph path at the same width: ``build_fgft`` on one
             community graph (n = 256, g = 4096), then ``FGFT.analysis``,
             ``synthesis``, ``project`` and the same bank through
             ``ApplyPlan(mode="bank")`` (the single-matrix entry points,
             launched as B = 1).  Counters are zeroed just before and read
             just after; the three single-matrix entry points must have
             launched.  Relative error < 0.05, synthesis(analysis(x)) = x,
             the bank equal to its plain version.
5. main-directed — the directed main path, through the CLI entry point:
             ``serve --fgft --directed`` with B = 64 directed community
             graphs, n = 256, g = 4096, R = 256, the same tiers.  Counters
             are zeroed just before; then ``basis.apply(x, inverse=True)``
             and ``basis.apply(.)`` round-trip the signals; counters are
             read just after: ``batched_gen_operator_apply`` and
             ``batched_shear_apply`` must have launched.  Mean full-tier
             relative error < 0.05 and equal to the dense
             ||L - T diag(c) T^-1||^2 / ||L||^2 (T from ``t_to_dense``, plain
             torch) within 1e-3 relative; the served output equals the plain
             version bitwise; the round trip returns x within a tolerance derived
             from cond(Tbar) (printed with it).  Then the directed bank on
             the same fitted basis (no second T fit): an engine with
             ``filters=`` and the same bank spec, counters zeroed just before
             its steps; ``batched_gen_filter_bank_apply`` must have
             launched, the bank must equal its plain version and each
             filter the operator kernel, bitwise.
5b. main-ragged — the heterogeneous fleet through the CLI: ``serve --fgft
             --ragged --graphs 64 --graph-sizes 64,100,180,256 --transforms
             4096`` (16 community graphs of each size in buckets of width 64,
             128 and 256 with 16, 16 and 32 graphs, g = 768, 1792 and 4096:
             2 w log2 w, the main path's g at the largest width), R = 256,
             the same tiers.  Counters are zeroed just before and read just
             after; both batched G entry points must have launched.  Each
             graph's relative error equals its dense recomputation on the
             cropped block within 1e-3 relative (mean < 0.05); each bucket's
             served output matches the plain operator program on the same
             tables (G tolerance), each graph's answer is its cropped bucket
             row and the bucket's pads are 0; ``apply`` passes pad
             coordinates through bitwise (synthesis, analysis, round trip)
             and ``project`` with the heat response gives exactly 0 there.
             Then the router is saved and loaded (times printed) with the
             bank spec as a ``filters=`` override: the restored tables and
             every tier's steps are bitwise equal to the saved router's,
             and the restored router serves ``step_bank`` (counters zeroed
             just before its timed steps: one bank launch per bucket and
             step), each bucket's bank held to its plain version and each
             filter to the operator kernel, pads 0.  Last a small directed
             ragged fleet (sizes 12, 20, 32; n_iter = 1): the T operator,
             chain (both legs) and bank of every bucket bitwise equal to
             their plain versions, and the pads passed through bitwise.
5c. main-dynamic — the evolving-fleet path (after [main-ragged], whose
             saved router it loads), each part driven with the counts
             zeroed just before and read just after, comparisons not
             counted: a. ``serve --fgft --dynamic --graphs 64 --graph-n
             256 --transforms 4096 --signals 256 --update-rounds 4
             --churn 0.002`` (default tiers and policy) through
             ``serve_fgft_dynamic``; after each round the served full tier
             against the plain operator, the full-tier relative error
             through the operator kernel (and the objective after a
             structural fit) against the dense recomputation within 1e-3
             relative, the entry-stream cache's hits and misses; then the
             drift probe (R = 8), the Lemma-1 refresh and a full-tier step
             timed on the pinned tables.  b. REFRESH, then EXTEND at full
             width on the same engine (2% churn, thresholds set from the
             measured drift), every kernel of the path (operator at R =
             256 and R = 8, chain on the identity, the F = 7 bank served
             on the extended basis) against its plain version on the
             pinned, extended tables.  c. EXTEND then a budget-forced
             REFIT on a small fleet (B = 4, n = 32): the chain returns to
             g0, ``extends_since_refit`` is 0.  d. a dynamic engine on
             [main-directed]'s basis (no new fit), one directed round,
             EXTEND; every tier bitwise equal to its plain version.
             e. [main-ragged]'s router loaded with ``dynamic=True``, graphs
             of two of its three buckets updated, ``maintain(dirty_only=
             True)``: only those buckets tick and only their graphs'
             versions move; pads 0 from ``project``.  The operator, chain,
             bank and T operator batched entry points must have launched;
             each ``kernels`` row carries ``dynamic_launches``.
5d. main-bf16 — bf16 table storage (after [main-dynamic]), each part
             driven with the counts zeroed just before and read just
             after, comparisons not counted: a. ``serve --fgft --precision
             bf16 --filter heat,tikhonov,wavelets:4 --graphs 64 --graph-n
             256 --transforms 4096 --signals 256`` (one G fit): the bank
             against its plain version, each filter against dense ``eigh``
             within its bound; b. engines at ``precision="bf16"`` on
             [main]'s and [main-directed]'s bases (``basis=``, no fit):
             every tier and the bank against the plain versions, the full
             tier and the bank against the f32 engine's (relative
             deviation < 0.03), graph-transforms/s and responses/s beside
             the f32 ones, an ``apply`` round trip at bf16; c.
             [main-ragged]'s saved router loaded at bf16: served buckets
             against plain, pads bitwise through ``apply`` and 0 from
             ``project``; d. a dynamic engine at bf16 on [main]'s basis,
             one forced REFRESH: the bf16 cast is kept and every step after
             the swap hits the entry-stream cache; e. the single-graph
             paths at bf16.  Every bf16 form must have launched; the bf16
             rows of the ``kernels`` line carry these launches.
5e. main-async — the async front end (after [main-bf16]), on the tables
             the earlier phases fitted (no fit at full width), each part
             driven with the counts zeroed just before and read just
             after, comparisons not counted: a. [main]'s basis with its
             tiers and the F = 7 bank behind ``AsyncFGFTService(
             max_queue=128, max_batch=8)``, 4096 tier and 1024 bank
             requests of R = 8 rows from 16 closed-loop tenants: every
             answer equal to ``step_versioned`` / ``step_bank_versioned``
             on the request's rows alone (G within the G tolerance, the
             largest max|dy| and whether it was bitwise printed),
             ``batched_sym_operator_apply`` launches equal to the tier
             dispatches and ``batched_sym_filter_bank_apply`` launches to
             the bank dispatches, ``plan_compile`` spans equal to the
             plan-cache misses (cache cleared first), each request's
             queue, batch and execute spans sharing their endpoints with
             the next one and with the request span, exactly (the
             service's clock is rounded to 2^-20 s so that the sums are
             exact); requests/s, p50/p99 of queue, service and total per
             tier, mean occupancy, and the traced/untraced requests/s
             ratio (the same load with ``obs.configure(enabled=False)``,
             printed, not gated).  b. [main-directed]'s basis, 1024
             requests, bitwise.  c. [main-ragged]'s saved router (no
             fit), 1024 requests over its three buckets, one launch per
             dispatch, pads 0 in every bucket output.  d. a dynamic
             engine on [main]'s basis, a churn thread at 0.002 and the
             maintainer at a 0.05 s interval (refresh threshold 0.002,
             the others out of reach, hysteresis 1: REFRESH fires, and
             an EXTEND comes only by escalation; the churn stops when the
             first EXTEND starts, so there is at most one), 2048
             requests: at least one swap, versions non-decreasing in
             dispatch order, no failed request, the final full tier
             against plain, a profiled REFRESH tick's kernels on other
             CUDA streams than the serving launches' (in a process of its
             own on the saved [main] basis: a profiler that has taken the
             earlier phases' traces can lose a whole tick), total p99
             while a tick runs against idle.  e. ``serve --fgft --serve-async
             --dynamic --graphs 8 --graph-n 64 --load-requests 256
             --load-workers 4 --trace T --metrics-dir M``: T loads as a
             Chrome trace, M's metrics.json and metrics.prom hold
             ``service_requests_total`` and ``plan_cache_misses_total``.
             The operator, bank, T operator and chain batched entry
             points must have launched; each ``kernels`` row carries
             ``async_launches``.
6. fgft-directed — ``build_fgft(directed=True)`` on one directed community
             graph (n = 256, g = 4096, n_iter = 3), then analysis, synthesis,
             project and the bank; ``shear_apply``, ``gen_operator_apply``
             and ``gen_filter_bank_apply`` must have launched; relative
             error < 0.05.
7. shapes  — each of the 12 entry points held against its plain version at
             the paths' shapes (every cut; the banks also at F = 33 and
             R = 130, batched at B = 64 and on two matrices, and at B = 1,
             so that both batched and B = 1 banks run with several filter
             groups), then timed.  Each ``[time]`` line prints the launch's
             geometry, the card's own count of resident CTAs per SM
             (cudaOccupancyMaxActiveBlocksPerMultiprocessor; a bank launch
             must keep at least three) and the kernel's device time per
             launch from a torch.profiler trace beside the CUDA-event
             time of the whole call; a chain or operator launch also
             prints its lanes per row, rows per warp and warps per CTA
             (launcher.operator_geometry).  The banks' stage-extent
             reduction (launcher.stage_extents, both legs) is timed on its
             own.  After [main-bf16] the same checks and timings for the
             12 bf16 forms on the same tables cast to bf16 (the bound
             counts a value at 2 bytes).
8. turns   — only with ``--baseline DIR ...`` (each DIR a checkout of this
             repository, e.g. a ``git archive`` of an earlier commit): the
             four operator and the four chain entry points of this
             checkout and of each DIR timed in turns (this, DIR..., then
             the same in reverse), each tree in a process of its own with
             its own kernel build, on the tables, signals and spectra of
             phase 7's timings, saved by this run (the batched G chain on
             the tier refit's identity block); CUDA-event and profiler
             device ms per call.

Tolerance of the kernel-vs-plain checks: for the G kernels max|dy| <= 1e-4 *
max(1, max|y|), since they and their plain versions round their FMA
contractions differently across about 2S stages; for the T kernels max|dy|
== 0, since they round every entry as their plain versions do (no FMA
contraction).

Output: progress lines, a {"kernels": [...]} line (24 rows: each entry
point's f32 and bf16 form; launches per path: ``launches`` on the
batched or single-graph path, or on [main-bf16] for a bf16 form,
``ragged_launches``, ``dynamic_launches``, ``async_launches``), the
card's name and power limit, and as the last line {"ok": true, "device":
{...}}.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TOL = 1e-4
DEVICE = "cuda"
MAIN = dict(graphs=64, n=256, signals=256, steps=5,
            tiers="full:1.0,balanced:0.5,draft:0.25",
            filters="heat,tikhonov,wavelets:4")
#: the heterogeneous fleet of [main-ragged]: sizes cycled over the graphs,
#: the largest bucket at the main path's width and g; the directed check's
#: small fleet
RAGGED = dict(graphs=64, sizes="64,100,180,256", transforms=4096,
              buckets={64: 16, 128: 16, 256: 32},
              g={64: 768, 128: 1792, 256: 4096},
              directed_sizes="12,20,32", directed_graphs=6)
#: the evolving fleet of [main-dynamic]: the main path's fleet under the
#: CLI's update rounds, then forced rounds at 10x the churn, a small fleet
#: for the REFIT, and the directed EXTEND's component budget
DYNAMIC = dict(graphs=64, n=256, transforms=4096, signals=256, rounds=4,
               churn=0.002, forced_churn=0.02, small=dict(graphs=4, n=32),
               directed_extend_fraction=0.03125)
REPLACES = {
    "batched_sym_operator_apply": "src/repro/kernels/butterfly.py:169",
    "batched_butterfly_apply": "src/repro/kernels/butterfly.py:209",
    "sym_operator_apply": "src/repro/kernels/butterfly.py:240",
    "butterfly_apply": "src/repro/kernels/butterfly.py:102",
    "shear_apply": "src/repro/kernels/shear.py:84",
    "gen_operator_apply": "src/repro/kernels/shear.py:115",
    "batched_shear_apply": "src/repro/kernels/shear.py:153",
    "batched_gen_operator_apply": "src/repro/kernels/shear.py:207",
    "sym_filter_bank_apply": "src/repro/kernels/spectral.py:122",
    "gen_filter_bank_apply": "src/repro/kernels/spectral.py:122",
    "batched_sym_filter_bank_apply": "src/repro/kernels/spectral.py:142",
    "batched_gen_filter_bank_apply": "src/repro/kernels/spectral.py:142",
}
#: per real table entry of each kind: bytes the function reads (the indices
#: and values it needs) and flops per signal row — a G pair (i, j, c, s,
#: sigma) 20 B and 6 flops (paper Table 1), a T shear y_i = x_i + beta x_j
#: (i, j, beta) 12 B and 2 flops, a T scaling y_i = alpha x_i (i, alpha) 8 B
#: and 1 flop; with bf16 values each value is 2 B (pair 14 B, shear 10 B,
#: scaling 6 B)
ENTRY_COST = {"pair": (20, 6), "shear": (12, 2), "scaling": (8, 1)}
ENTRY_COST_BF16 = {"pair": (14, 6), "shear": (10, 2), "scaling": (6, 1)}
#: form name of a bf16 check -> the largest max|dy| of the bf16 form
#: against its own f32 form run on the widened tables (printed)
BF16_VS_F32: dict = {}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparisons and timing
# ---------------------------------------------------------------------------

def max_err(got, want) -> tuple:
    import torch
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = max(1.0, float(want.abs().max()) if want.numel() else 0.0)
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    return err, scale


def tolerance(entry: str) -> float:
    """Relative kernel-vs-plain tolerance of an entry point: 0 (bitwise)
    for the T kernels, TOL for the G kernels (module docstring)."""
    from repro_torch.kernels import launcher
    return 0.0 if launcher.KERNEL_OF[entry].startswith("t_") else TOL


def compare(name, got, want, errs) -> None:
    err, scale = max_err(got, want)
    tol = tolerance(name)
    check(err <= tol * scale,
          f"{name}: max|dy| {err:.3e} > {tol} * {scale:.3e}")
    errs[name] = max(errs.get(name, 0.0), err)


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over rounds of the mean time of ``reps`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 10, traces: int = 3):
    """Device time per launch of ``kernel`` over ``reps`` calls of fn, from
    torch.profiler's CUDA trace (the kernel alone, without the host's
    launch path).  A trace now and then holds none of the launches, so up
    to ``traces`` are taken; None when none of them holds one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if count:
            total = sum(getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0.0)
                        for e in events)
            return total / 1e3 / count
    return None


def real_entries(staged, num_stages, keep) -> dict:
    """Real (non-pad) entries a leg holds at a cut, over the batch, by
    kind: G pairs, or T shears (j != i) and scalings (j == i)."""
    from repro_torch.core.staging import StagedT
    s_tot = staged.idx_i.shape[-2]
    k = s_tot if num_stages is None else num_stages
    sl = slice(0, k) if keep == "head" else slice(s_tot - k, s_tot)
    ii, jj = staged.idx_i[..., sl, :], staged.idx_j[..., sl, :]
    real = ii < staged.n
    if not isinstance(staged, StagedT):
        return {"pair": int(real.sum())}
    return {"shear": int((real & (jj != ii)).sum()),
            "scaling": int((real & (jj == ii)).sum())}


def bound_ms(x, legs, filters: int, precision: str = "f32") -> tuple:
    """Least time on the card for the function itself.  ``filters``: 0
    for a chain (one leg, no diagonal), 1 for an operator, F for a bank.
    x is read once and y written max(1, F) times; each leg's real entries
    are read once at their kind's ENTRY_COST bytes; the analysis leg
    (legs[0]) costs its ENTRY_COST flops per signal row once, the
    synthesis leg (legs[1]) once per filter; the F diagonals (B F n
    values) are read once and cost n flops per row and filter.  Pad
    entries of the (S, P) layout are not counted: the function does not
    need them, the layout is the kernel's choice.  ``precision`` "bf16"
    counts the values at 2 bytes (ENTRY_COST_BF16).  Returns (ms,
    "bytes" | "operations")."""
    cost = ENTRY_COST if precision == "f32" else ENTRY_COST_BF16
    bsz, rows, n = (1,) * (3 - x.dim()) + tuple(x.shape)
    outputs = max(filters, 1)
    nbytes = (1 + outputs) * x.numel() * 4 + filters * bsz * n * 4
    flops = filters * bsz * rows * n
    for pos, leg in enumerate(legs):
        runs = outputs if pos > 0 else 1
        for kind, count in leg.items():
            per_bytes, per_flops = cost[kind]
            nbytes += count * per_bytes
            flops += runs * per_flops * count * rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def ptxas_report(nvcc: str) -> dict:
    """Registers, stack frame and spill bytes of every kernel, from
    ``nvcc -Xptxas -v`` on each source (one process per source, all
    started together): {kernel: (registers, stack, spill stores, spill
    loads)}."""
    import re
    from repro_torch.kernels import build
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v",
                               "-c", "-o", "/dev/null", str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src in build.sources()]
    out, kernel, frame = {}, None, (0, 0, 0)
    for proc in procs:
        text = proc.communicate(timeout=600)[0]
        check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{text}")
        for line in text.splitlines():
            m = re.search(r"Compiling entry function .*?([gt]_(?:chain|"
                          r"operator|bank)(?:_bf16)?_kernel)", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                frame = tuple(int(v) for v in m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                out[kernel] = (int(m.group(1)), *frame)
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    nvcc = build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    log(f"[build] {nvcc}: {version.splitlines()[-1] if version else '?'}")
    t0 = time.perf_counter()
    build.library()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f}s")
    for kernel, (regs, stack, st, ld) in sorted(ptxas_report(nvcc).items()):
        log(f"[build] ptxas: {kernel} {regs} registers, {stack} B stack "
            f"frame, spill stores {st} B, spill loads {ld} B")


def lowpass(lam):
    """The low-pass response 1 / (1 + lambda) of the smoke run's filters."""
    return 1.0 / (1.0 + lam)


def cut_list(staged) -> list:
    return sorted({0, *staged.cuts[:, 0].tolist()})


def widened(staged):
    """The f32 tables a bf16 table set widens to (exact), or None for
    f32 tables."""
    from repro_torch.core.staging import table_precision, with_precision
    return (None if table_precision(staged) == "f32"
            else with_precision(staged, "f32"))


def compare_form(name, fn, args, plain, errs, wide_args=None) -> None:
    """``fn(*args)`` against ``plain(*args)`` (``compare``); for a bf16
    form also against ``fn(*wide_args)``, its f32 form on the widened
    tables, into BF16_VS_F32 (an exact widening: 0 unless the two forms
    round differently)."""
    y = fn(*args)
    compare(name, y, plain(*args), errs)
    if wide_args is not None:
        d = float((y - fn(*wide_args)).abs().max()) if y.numel() else 0.0
        BF16_VS_F32[name] = max(BF16_VS_F32.get(name, 0.0), d)


def forms_note(*names) -> str:
    """The printed bf16-vs-f32 deltas of the named forms, if any."""
    got = {k: BF16_VS_F32[k] for k in names if k in BF16_VS_F32}
    return ("" if not got else "; bf16 form vs its f32 form on the "
            "widened tables max|dy| " + ", ".join(
                f"{k} {v:.3e}" for k, v in got.items()))


def check_tables(tag, fwd, adj, diag, x, errs) -> int:
    """Both kernels (batched if the tables are) against the plain
    versions at every cut (bf16 tables: the bf16 forms, also against
    their f32 forms on the widened tables); returns the number of
    comparisons."""
    from repro_torch.core.staging import table_precision
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import launcher, ref
    batched = fwd.idx_i.dim() == 3
    prec = table_precision(fwd)
    wfwd, wadj = widened(fwd), widened(adj)
    chain = bf.batched_butterfly_apply if batched else bf.butterfly_apply
    chain_ref = ref.batched_g_apply if batched else ref.staged_g_apply
    op = (bf.batched_sym_operator_apply if batched
          else bf.sym_operator_apply)
    op_ref = (ref.batched_sym_operator_apply if batched
              else ref.sym_operator_apply)
    chain_name = launcher.form("batched_butterfly_apply" if batched
                               else "butterfly_apply", prec)
    op_name = launcher.form("batched_sym_operator_apply" if batched
                            else "sym_operator_apply", prec)
    count = 0
    for k in cut_list(fwd):
        for staged, wide, keep in ((fwd, wfwd, "tail"), (adj, wadj, "head"),
                                   (fwd, wfwd, "head"), (adj, wadj, "tail")):
            compare_form(chain_name, chain, (staged, x, k, keep), chain_ref,
                         errs, wide and (wide, x, k, keep))
            count += 1
        compare_form(op_name, op, (fwd, adj, diag, x, k), op_ref, errs,
                     wfwd and (wfwd, wadj, diag, x, k))
        count += 1
    log(f"[kernels] {tag}: {count} kernel-vs-plain checks at cuts "
        f"{cut_list(fwd)} passed ({prec} tables)"
        + forms_note(chain_name, op_name))
    return count


def tables_for(basis, b: int):
    """B = 1 tables of matrix b of a batched basis (packed by the port)."""
    from repro_torch.core.staging import pack_g_pair
    from repro_torch.core.types import GFactors
    f = GFactors(*(t[b] for t in basis.factors))
    return pack_g_pair(f, n=basis.n, device=basis.device)


def check_t_tables(tag, fwd, inv, diag, x, errs) -> int:
    """Both T kernels (batched if the tables are) against the plain
    versions at every cut, the chain on both table sets at both keeps
    (bf16 tables: as check_tables); returns the number of
    comparisons."""
    from repro_torch.core.staging import table_precision
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels import shear as sh
    batched = fwd.idx_i.dim() == 3
    prec = table_precision(fwd)
    wfwd, winv = widened(fwd), widened(inv)
    chain = sh.batched_shear_apply if batched else sh.shear_apply
    chain_ref = ref.batched_t_apply if batched else ref.staged_t_apply
    op = sh.batched_gen_operator_apply if batched else sh.gen_operator_apply
    op_ref = (ref.batched_gen_operator_apply if batched
              else ref.gen_operator_apply)
    chain_name = launcher.form("batched_shear_apply" if batched
                               else "shear_apply", prec)
    op_name = launcher.form("batched_gen_operator_apply" if batched
                            else "gen_operator_apply", prec)
    count = 0
    for k in cut_list(fwd):
        for staged, wide in ((fwd, wfwd), (inv, winv)):
            for keep in ("head", "tail"):
                compare_form(chain_name, chain, (staged, x, k, keep),
                             chain_ref, errs, wide and (wide, x, k, keep))
                count += 1
        compare_form(op_name, op, (fwd, inv, diag, x, k), op_ref, errs,
                     wfwd and (wfwd, winv, diag, x, k))
        count += 1
    log(f"[kernels] {tag}: {count} T kernel-vs-plain checks at cuts "
        f"{cut_list(fwd)} passed ({prec} tables)"
        + forms_note(chain_name, op_name))
    return count


def t_tables_for(basis, b: int):
    """B = 1 T tables of matrix b of a batched general basis."""
    from repro_torch.core.staging import pack_t_pair
    from repro_torch.core.types import TFactors
    f = TFactors(*(t[b] for t in basis.factors))
    return pack_t_pair(f, basis.n, device=basis.device)


def bank_gains(spectrum):
    """(F, n) gains of the smoke run's bank on a single graph's spectrum
    (n,)."""
    import torch
    from repro_torch.spectral import named_responses
    return torch.stack([h(spectrum) for h in
                        named_responses(MAIN["filters"]).values()])


def bank_groups(entry, fwd, x, filters: int) -> int:
    """Filter groups per row tile of a bank launch at these shapes."""
    from repro_torch.kernels import launcher
    bsz, rows, n = (1,) * (3 - x.dim()) + tuple(x.shape)
    geo = launcher.launch_geometry(entry, bsz, rows, n, filters,
                                   int(fwd.idx_i.shape[-1]))
    return -(-filters // geo["filters_per_cta"])


def check_bank_tables(tag, fwd, bwd, gains, x, errs,
                      filter_counts=None) -> dict:
    """The bank kernel of the tables' family (batched if they are)
    against its plain version at every cut, with the first filter and
    with all of ``gains``' filters (or the leading ``filter_counts``;
    bf16 tables: as check_tables); returns {F: filter groups of its
    launches}."""
    from repro_torch.core.staging import StagedT, table_precision
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels import spectral as ksp
    entry = (("batched_" if fwd.idx_i.dim() == 3 else "")
             + ("gen" if isinstance(fwd, StagedT) else "sym")
             + "_filter_bank_apply")
    fn, plain = getattr(ksp, entry), getattr(ref, entry)
    name = launcher.form(entry, table_precision(fwd))
    wfwd, wbwd = widened(fwd), widened(bwd)
    counts = sorted(filter_counts or {1, gains.shape[-2]})
    count = 0
    for k in cut_list(fwd):
        for f in counts:
            g = gains[..., :f, :].contiguous()
            compare_form(name, fn, (fwd, bwd, g, x, k), plain, errs,
                         wfwd and (wfwd, wbwd, g, x, k))
            count += 1
    groups = {f: bank_groups(name, fwd, x, f) for f in counts}
    log(f"[kernels] {tag}: {count} {name} kernel-vs-plain checks at cuts "
        f"{cut_list(fwd)}, F in {counts} (filter groups {groups}) passed"
        + forms_note(name))
    return groups


def directed_laps(n: int, count: int):
    import numpy as np
    from repro_torch.core import laplacian
    from repro_torch.graphs import community_graph, directed_variant
    return np.stack([laplacian(directed_variant(community_graph(n, seed=s),
                                                seed=s))
                     for s in range(count)])


def random_tables(family: str, n: int, batch: int, g: int, seed: int):
    """(fwd, bwd) tables of ``batch`` random chains of g components."""
    import numpy as np
    from repro_torch.core import staging
    from repro_torch.core.types import GFactors, TFactors
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, (batch, g))
    j = (i + rng.integers(1, n, (batch, g))) % n
    if family == "sym":
        theta = rng.uniform(-np.pi, np.pi, (batch, g))
        f = GFactors(np.minimum(i, j).astype(np.int32),
                     np.maximum(i, j).astype(np.int32),
                     np.cos(theta).astype(np.float32),
                     np.sin(theta).astype(np.float32),
                     rng.choice([-1.0, 1.0], (batch, g)).astype(np.float32))
        return staging.pack_g_batch_pair(f, n, device=DEVICE)
    kind = rng.integers(0, 2, (batch, g)).astype(np.int32)
    scale = (rng.uniform(0.8, 1.25, (batch, g))
             * rng.choice([-1.0, 1.0], (batch, g)))
    a = np.where(kind == 0, scale, rng.uniform(-0.5, 0.5, (batch, g)))
    f = TFactors(kind, i.astype(np.int32),
                 np.where(kind == 0, i, j).astype(np.int32),
                 a.astype(np.float32))
    return staging.pack_t_batch_pair(f, n, device=DEVICE)


def check_split(precision: str = "f32") -> None:
    """A batch of 7 at a grid limit forced down to 3 matrices: each
    family's chain, operator and bank entry point (its form at the table
    ``precision``) launches three times (on [0, 3), [3, 6) and [6, 7))
    and equals its unsplit launch bitwise."""
    import torch
    from repro_torch.core.staging import with_precision
    from repro_torch.kernels import launcher
    from repro_torch.kernels import spectral as ksp
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import shear as sh
    n, batch = 48, 7
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    x = torch.randn((batch, 130, n), generator=gen, device=DEVICE)
    diag = torch.rand((batch, n), generator=gen, device=DEVICE) * n
    gains = torch.rand((batch, 5, n), generator=gen, device=DEVICE) * 2.0
    for family, mod, names in (
            ("sym", bf, ("batched_butterfly_apply",
                         "batched_sym_operator_apply",
                         "batched_sym_filter_bank_apply")),
            ("general", sh, ("batched_shear_apply",
                             "batched_gen_operator_apply",
                             "batched_gen_filter_bank_apply"))):
        fwd, bwd = (with_precision(t, precision)
                    for t in random_tables(family, n, batch, 200, 5))
        k = int(fwd.cuts[1, 0])
        chain, op = getattr(mod, names[0]), getattr(mod, names[1])
        bank = getattr(ksp, names[2])
        calls = (lambda: chain(fwd, x, k, "tail"),
                 lambda: op(fwd, bwd, diag, x, k),
                 lambda: bank(fwd, bwd, gains, x, k))
        whole = [call() for call in calls]
        grid = launcher._GRID_B
        launcher._GRID_B = 3
        try:
            launcher.reset_launch_counts()
            split = [call() for call in calls]
            counts = launcher.entry_launch_counts()
        finally:
            launcher._GRID_B = grid
        for name, got, want in zip(names, split, whole):
            name = launcher.form(name, precision)
            check(torch.equal(got, want),
                  f"{name}: split launch != unsplit launch")
            check(counts[name] == 3,
                  f"{name}: {counts[name]} launches for 3 slices")
    torch.cuda.synchronize()
    log(f"[kernels] batch split ({precision} tables): B={batch} at a grid "
        f"limit of 3 matrices, chain, operator and bank of both families: "
        f"3 launches each, bitwise equal to the unsplit launches")


def phase_kernels(errs) -> None:
    import numpy as np
    import torch
    from repro_torch.core import ApproxEigenbasis, laplacian
    from repro_torch.core.staging import with_precision
    from repro_torch.graphs import community_graph
    dev = torch.device(DEVICE)

    def bf16(*tables):
        return [with_precision(t, "bf16") for t in tables]
    for n in (16, 48):
        g = int(2 * n * np.log2(n))
        laps = np.stack([laplacian(community_graph(n, seed=s))
                         for s in range(4)])
        basis = ApproxEigenbasis.fit(laps, g, n_iter=1, device=dev)
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((4, 130, n), generator=gen, device=dev)
        gains = torch.rand((4, 33, n), generator=gen, device=dev) * 2.0
        x1, g1 = x[1].contiguous(), gains[1].contiguous()
        check_tables(f"n={n} B=4 R=130", basis.fwd, basis.bwd,
                     basis.spectrum, x, errs)
        check_bank_tables(f"n={n} B=4 R=130", basis.fwd, basis.bwd, gains,
                          x, errs, (1, 7, 33))
        sfwd, sadj = tables_for(basis, 1)
        check_tables(f"n={n} B=1 R=130", sfwd, sadj, basis.spectrum[1],
                     x1, errs)
        check_bank_tables(f"n={n} B=1 R=130", sfwd, sadj, g1, x1, errs,
                          (1, 7, 33))
        tbasis = ApproxEigenbasis.fit(directed_laps(n, 4), g, n_iter=1,
                                      kind="general", device=dev)
        check_t_tables(f"n={n} B=4 R=130", tbasis.fwd, tbasis.bwd,
                       tbasis.spectrum, x, errs)
        check_bank_tables(f"n={n} B=4 R=130", tbasis.fwd, tbasis.bwd, gains,
                          x, errs, (1, 7, 33))
        sfwd, sinv = t_tables_for(tbasis, 1)
        check_t_tables(f"n={n} B=1 R=130", sfwd, sinv, tbasis.spectrum[1],
                       x1, errs)
        check_bank_tables(f"n={n} B=1 R=130", sfwd, sinv, g1, x1, errs,
                          (1, 7, 33))
        # the bf16 forms on the same fits' tables cast to bf16
        b_fwd, b_bwd = bf16(basis.fwd, basis.bwd)
        check_tables(f"n={n} B=4 R=130", b_fwd, b_bwd, basis.spectrum, x,
                     errs)
        check_bank_tables(f"n={n} B=4 R=130", b_fwd, b_bwd, gains, x, errs,
                          (1, 7, 33))
        s_fwd, s_adj = bf16(*tables_for(basis, 1))
        check_tables(f"n={n} B=1 R=130", s_fwd, s_adj, basis.spectrum[1],
                     x1, errs)
        check_bank_tables(f"n={n} B=1 R=130", s_fwd, s_adj, g1, x1, errs,
                          (1, 7, 33))
        t_fwd, t_inv = bf16(tbasis.fwd, tbasis.bwd)
        check_t_tables(f"n={n} B=4 R=130", t_fwd, t_inv, tbasis.spectrum, x,
                       errs)
        check_bank_tables(f"n={n} B=4 R=130", t_fwd, t_inv, gains, x, errs,
                          (1, 7, 33))
        s_fwd, s_inv = bf16(sfwd, sinv)
        check_t_tables(f"n={n} B=1 R=130", s_fwd, s_inv, tbasis.spectrum[1],
                       x1, errs)
        check_bank_tables(f"n={n} B=1 R=130", s_fwd, s_inv, g1, x1, errs,
                          (1, 7, 33))
    check_split()
    check_split("bf16")
    torch.cuda.synchronize()


def phase_main() -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    argv = ["--fgft", "--graphs", str(MAIN["graphs"]),
            "--graph-n", str(MAIN["n"]), "--signals", str(MAIN["signals"]),
            "--filter-steps", str(MAIN["steps"]), "--tiers", MAIN["tiers"],
            "--device", DEVICE]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[main] serve --fgft {' '.join(argv[1:])}: {wall:.1f}s "
        f"(fit {out['fit_s']:.1f}s); launches {launches}")
    for entry in ("batched_sym_operator_apply", "batched_butterfly_apply"):
        check(launches[entry] > 0, f"main path never launched {entry}")
    engine, laps = out["engine"], out["laps"]
    basis = engine.basis
    n = basis.n
    dense = dense_rel_error(basis, laps)
    rel = np.asarray(out["rel_error"], np.float64)
    mean_rel, mean_dense = float(rel.mean()), float(dense.mean())
    log(f"[main] full-tier relative error: mean {mean_rel:.6f} from the "
        f"fit objective, {mean_dense:.6f} recomputed densely")
    check(bool(np.isfinite(rel).all()), "non-finite relative error")
    check(mean_rel < 0.05, f"mean relative error {mean_rel} >= 0.05")
    check(abs(mean_dense - mean_rel) <= 1e-3 * mean_rel,
          f"dense relative error {mean_dense} != objective {mean_rel}")
    for name, ts in out["tiers"].items():
        log(f"[main] tier {name}: {ts['transforms_per_s']:.1f} "
            f"graph-transforms/s, {ts['num_transforms']} components, "
            f"{ts['num_stages']} stages")
    x = out["signals"]
    y = engine.step(x, lowpass, tier="full")
    plain = ApplyPlan(family="sym", mode="operator", n=n, batched=True,
                      backend="torch", device=DEVICE).program()
    spec = engine.tiers["full"]["spectrum"]
    y_ref = plain(engine._live.fwd, engine._live.bwd, lowpass(spec), x)
    check(tuple(y.shape) == tuple(x.shape), f"served shape {tuple(y.shape)}")
    err, scale = max_err(y, y_ref)
    check(err <= TOL * scale, f"served full tier max|dy| {err:.3e}")
    log(f"[main] served full tier vs plain version: max|dy| {err:.3e} "
        f"(scale {scale:.3e})")
    torch.cuda.synchronize()
    return {"out": out, "launches": launches, "wall_s": wall,
            "mean_rel": mean_rel, "mean_rel_dense": mean_dense,
            "served_err": err}


def check_bank_slices(tag, engine, yb, x, tol: float) -> float:
    """Each filter of a served bank (B, F, R, n) against ``engine.step``
    with that filter's response at the full tier (the operator kernel);
    returns the largest max|dy|."""
    worst = 0.0
    for f, filt in enumerate(engine.bank.filters):
        err, scale = max_err(yb[:, f], engine.step(x, filt.response))
        check(err <= tol * scale,
              f"{tag}: filter {filt.name} vs operator max|dy| {err:.3e}")
        worst = max(worst, err)
    log(f"[{tag}] each of {len(engine.bank)} filters vs the operator kernel "
        f"with its gains: max|dy| {worst:.3e} (tolerance {tol} * scale)")
    return worst


def phase_main_filter(errs) -> dict:
    """The filter-bank path through the CLI: ``serve --fgft --filter``."""
    import numpy as np
    import torch
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    argv = ["--fgft", "--filter", MAIN["filters"], "--graphs",
            str(MAIN["graphs"]), "--graph-n", str(MAIN["n"]), "--signals",
            str(MAIN["signals"]), "--filter-steps", str(MAIN["steps"]),
            "--device", DEVICE]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[main-filter] serve {' '.join(argv)}: {wall:.1f}s (fit "
        f"{out['fit_s']:.1f}s), {out['responses_per_s']:.1f} responses/s; "
        f"launches {launches}")
    check(launches["batched_sym_filter_bank_apply"] > 0,
          "filter-bank path never launched batched_sym_filter_bank_apply")
    engine, x = out["engine"], out["signals"]
    basis, live = engine.basis, engine._live
    bsz, rows, n = x.shape
    nf = len(engine.bank)
    check(out["filters"] == engine.bank.names and nf == 7,
          f"bank filters {out['filters']}")
    y = engine.step_bank(x)
    check(tuple(y.shape) == (bsz, nf, rows, n), f"bank shape {tuple(y.shape)}")
    plain = ApplyPlan(family="sym", mode="bank", n=n, batched=True,
                      backend="torch", device=DEVICE).program()
    err, scale = max_err(y, plain(live.fwd, live.bwd, live.bank_gains, x))
    check(err <= TOL * scale, f"served bank max|dy| {err:.3e}")
    errs["batched_sym_filter_bank_apply"] = max(
        errs.get("batched_sym_filter_bank_apply", 0.0), err)
    log(f"[main-filter] served bank {list(y.shape)} vs plain version: "
        f"max|dy| {err:.3e} (scale {scale:.3e})")
    check_bank_slices("main-filter", engine, y, x, TOL)
    worst = check_filters_dense("main-filter", engine, y, x, out["laps"],
                                out["rel_error"])
    return {"out": out, "launches": launches, "wall_s": wall,
            "worst_ratio": worst}


def check_filters_dense(tag, engine, y, x, laps, rel_error) -> float:
    """Each filter of a served bank y (B, F, R, n) against dense ``eigh``
    filtering of x, per graph, within the accuracy the fit's error
    implies: 2 max(Lip(h), 1) delta + 5e-3, delta = sqrt(relative error)
    (tests/test_spectral.py's bound).  Returns the worst error/bound."""
    import numpy as np
    import torch
    from repro_torch.spectral import response_lipschitz
    lap = torch.from_numpy(laps).to(DEVICE, torch.float64)
    lam, u = torch.linalg.eigh(lap)
    delta = np.sqrt(np.asarray(rel_error, np.float64))
    xd = x.double()
    worst = 0.0
    for f, filt in enumerate(engine.bank.filters):
        hd = filt.response(lam.float()).double()
        dense = xd @ (u * hd[:, None, :]) @ u.transpose(1, 2)
        err_b = (torch.linalg.norm(y[:, f].double() - dense, dim=(1, 2))
                 / torch.linalg.norm(dense, dim=(1, 2)).clamp(min=1e-12)
                 ).cpu().numpy()
        lip = max(response_lipschitz(filt.response), 1.0)
        bound = 2.0 * lip * delta + 5e-3
        ratio = float((err_b / bound).max())
        log(f"[{tag}] filter {filt.name}: Lip {lip:.3f}, max rel error "
            f"vs dense eigh {float(err_b.max()):.5f}, worst error/bound "
            f"{ratio:.4f}")
        check(bool((err_b <= bound).all()),
              f"{tag}: filter {filt.name} exceeds its dense-eigh bound "
              f"(error/bound {ratio:.3f})")
        worst = max(worst, ratio)
    log(f"[{tag}] worst error/bound over {len(engine.bank)} filters x "
        f"{x.shape[0]} graphs: {worst:.4f} (mean relative error "
        f"{float(delta.mean() ** 2):.6f})")
    torch.cuda.synchronize()
    return worst


def phase_fgft(errs) -> dict:
    """The single-graph entry points at the main path's width."""
    import numpy as np
    import torch
    from repro_torch.core import build_fgft, laplacian, relative_error
    from repro_torch.graphs import community_graph
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels.plan import ApplyPlan
    n = MAIN["n"]
    g = int(2 * n * np.log2(n))
    lap = laplacian(community_graph(n, seed=0))
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    x = torch.randn((MAIN["signals"], n), generator=gen, device=DEVICE)
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    f = build_fgft(lap, g, n_iter=3, device=DEVICE)
    fit_s = time.perf_counter() - t0
    xh = f.analysis(x)
    xr = f.synthesis(xh)
    y = f.project(x, lowpass)
    gains = bank_gains(f.spectrum)
    yb = ApplyPlan(family="sym", mode="bank", n=n, batched=False,
                   device=DEVICE).bank(f.fwd, f.bwd, gains, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[single] build_fgft n={n} g={g} + analysis/synthesis/project/bank "
        f"of R={x.shape[0]}: {wall:.1f}s (fit {fit_s:.1f}s); launches "
        f"{launches}")
    for entry in ("sym_operator_apply", "butterfly_apply",
                  "sym_filter_bank_apply"):
        check(launches[entry] > 0, f"single-graph path never launched {entry}")
    rel = relative_error(lap, f)
    log(f"[single] relative error {rel:.6f}, {f.fwd.idx_i.shape[0]} stages "
        f"of {f.fwd.idx_i.shape[1]} pairs")
    check(np.isfinite(rel) and rel < 0.05, f"relative error {rel} >= 0.05")
    compare("butterfly_apply", xh, ref.staged_g_apply(f.bwd, x), errs)
    compare("butterfly_apply", xr, ref.staged_g_apply(f.fwd, xh, None,
                                                      "tail"), errs)
    compare("sym_operator_apply", y, ref.sym_operator_apply(
        f.fwd, f.bwd, lowpass(f.spectrum), x), errs)
    compare("sym_filter_bank_apply", yb, ref.sym_filter_bank_apply(
        f.fwd, f.bwd, gains, x), errs)
    err, scale = max_err(xr, x)
    check(err <= TOL * scale, f"synthesis(analysis(x)) != x: {err:.3e}")
    log(f"[single] synthesis(analysis(x)) vs x: max|dx| {err:.3e}")
    return {"fgft": f, "launches": launches, "signals": x, "gains": gains}


def at_precision(precision: str, *tables) -> list:
    """The table sets at a storage precision (with_precision)."""
    from repro_torch.core.staging import with_precision
    return [with_precision(t, precision) for t in tables]


def phase_main_shapes(main, single, errs, precision: str = "f32",
                      launches=None) -> list:
    """Kernel vs plain at the two paths' shapes, then timings; with
    ``precision`` "bf16" the same on the paths' tables cast to bf16 (the
    bf16 forms, their launches from ``launches``)."""
    import torch
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import launcher, ref
    engine = main["out"]["engine"]
    basis = engine.basis
    fwd, bwd = at_precision(precision, basis.fwd, basis.bwd)
    n, bsz = basis.n, basis.spectrum.shape[0]
    x = main["out"]["signals"]
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    ragged = torch.randn((bsz, 130, n), generator=gen, device=DEVICE)
    eye = torch.eye(n, device=DEVICE).expand(bsz, n, n).contiguous()
    check_tables(f"main n={n} B={bsz} R={x.shape[1]}", fwd, bwd,
                 basis.spectrum, x, errs)
    check_tables(f"main n={n} B={bsz} R=130", fwd, bwd, basis.spectrum,
                 ragged, errs)
    wide = widened(fwd)
    for name in ("balanced", "draft"):
        k = engine.tiers[name]["num_stages"]
        compare_form(launcher.form("batched_butterfly_apply", precision),
                     bf.batched_butterfly_apply, (fwd, eye, k, "tail"),
                     ref.batched_g_apply, errs,
                     wide and (wide, eye, k, "tail"))
    f = single["fgft"]
    sfwd, sadj = at_precision(precision, f.fwd, f.bwd)
    sspec, x0 = f.spectrum, single["signals"]
    check_tables(f"fgft n={n} B=1 R={x0.shape[0]}", sfwd, sadj, sspec, x0,
                 errs)
    torch.cuda.synchronize()

    # timings at the main path's shapes (full chain)
    spec = basis.spectrum
    ut = bf.batched_butterfly_apply(fwd, eye)              # rows: Ubar^T
    u = ut.transpose(1, 2).contiguous()
    dense_op = u @ torch.diag_embed(spec) @ u.transpose(1, 2)
    su = bf.butterfly_apply(sfwd, torch.eye(n, device=DEVICE)).T.contiguous()
    sdense = su @ torch.diag(sspec) @ su.T
    fwd_legs = [real_entries(fwd, None, "tail")]
    op_legs = [real_entries(bwd, None, "head")] + fwd_legs
    single_fwd = [real_entries(sfwd, None, "tail")]
    single_op = [real_entries(sadj, None, "head")] + single_fwd
    cases = [
        ("g_operator_kernel", "batched_sym_operator_apply", x, op_legs, 1,
         lambda: bf.batched_sym_operator_apply(fwd, bwd, spec, x),
         lambda: ref.batched_sym_operator_apply(fwd, bwd, spec, x),
         lambda: torch.bmm(x, dense_op.transpose(1, 2))),
        ("g_chain_kernel", "batched_butterfly_apply", eye, fwd_legs, 0,
         lambda: bf.batched_butterfly_apply(fwd, eye),
         lambda: ref.batched_g_apply(fwd, eye),
         lambda: torch.bmm(eye, u.transpose(1, 2))),
        ("g_operator_kernel", "sym_operator_apply", x0, single_op, 1,
         lambda: bf.sym_operator_apply(sfwd, sadj, sspec, x0),
         lambda: ref.sym_operator_apply(sfwd, sadj, sspec, x0),
         lambda: torch.mm(x0, sdense.T)),
        ("g_chain_kernel", "butterfly_apply", x0, single_fwd, 0,
         lambda: bf.butterfly_apply(sfwd, x0),
         lambda: ref.staged_g_apply(sfwd, x0),
         lambda: torch.mm(x0, su.T)),
    ]
    return timed_rows(cases, main, single, fwd, sfwd, errs, "sym",
                      precision, launches)


def timed_rows(cases, main, single, tables_b, tables_1, errs,
               family: str, precision: str = "f32", launches=None) -> list:
    """Time each case (kernel, plain version, library yardstick) and
    build its row of the ``kernels`` line; batched entries report the
    batched path's launches, B = 1 entries the single-graph path's.  At
    ``precision`` "bf16" each case is the entry point's bf16 form (its
    kernel, form name and bf16 bound), with the launches of
    ``launches`` (the [main-bf16] path's)."""
    source = ("src/repro_torch/csrc/butterfly.cu" if family == "sym"
              else "src/repro_torch/csrc/shear.cu")
    from repro_torch.kernels import launcher
    rows = []
    for kernel, entry, xin, legs, filters, fn, plain, lib in cases:
        base = entry
        entry = launcher.form(entry, precision)
        kernel = launcher.KERNEL_OF[entry]
        ms = time_ms(fn)
        dev_ms = device_ms(fn, kernel)
        plain_ms = time_ms(plain, reps=2, rounds=3)
        lib_ms = time_ms(lib)
        b_ms, b_by = bound_ms(xin, legs, filters, precision)
        batched = entry.startswith("batched")
        path = main if batched else single
        tables = tables_b if batched else tables_1
        bsz, nrows, n = (1,) * (3 - xin.dim()) + tuple(xin.shape)
        geo = launcher.launch_geometry(entry, bsz, nrows, n, max(filters, 1),
                                       int(tables.idx_i.shape[-1]))
        rows.append({
            "name": kernel if batched else f"{kernel}[B=1]",
            "entry": entry, "route": "cuda", "source": source,
            "replaces": REPLACES[base], "precision": precision,
            "launches": (launches if launches is not None
                         else path["launches"])[entry],
            "max_abs_err": errs[entry], "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": list(xin.shape), "filters": filters,
            "stages": int(tables.idx_i.shape[-2]),
            "pairs_per_stage": int(tables.idx_i.shape[-1]),
            "real_entries": legs,
            "bf16_vs_f32_max_abs": BF16_VS_F32.get(entry), **geo})
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        lanes = (f" ({geo['warps_per_cta']} warps of {geo['rows_per_warp']} "
                 f"rows, {geo['lanes_per_row']} lanes per row)"
                 if "lanes_per_row" in geo else "")
        log(f"[time] {entry} ({kernel}) at {list(xin.shape)}, F={filters}: "
            f"{ms:.4f} ms (device {dev_txt}), plain {plain_ms:.3f} ms, "
            f"library {lib_ms:.4f} ms, "
            f"bound "
            f"{b_ms:.5f} ms ({b_by}), real entries per leg {legs} of "
            f"{tables.idx_i.numel()} table entries; {geo['ctas']} CTAs of "
            f"{geo['rows_per_cta']} rows x {geo['filters_per_cta']} "
            f"filters{lanes}, {geo['resident_per_sm']} resident per SM")
    return rows


def phase_bank_shapes(family: str, path: dict, engine, x, single,
                      errs, precision: str = "f32", launches=None) -> list:
    """The family's bank kernel against its plain version at the paths'
    shapes (every cut, F in {1, 7}; the served R and a ragged R = 130,
    there also F = 33: the served gains and 26 random filters, batched
    at B = 64 and on the first two matrices, and at B = 1, where 33
    filters need several filter groups), then timed: batched on the
    served engine's tables and gains, B = 1 on the single-graph fit's,
    and the stage-extent reduction of both legs on its own.  The library
    yardstick is one ``torch.matmul`` over dense per-filter operators
    built outside the timing (from the kernel's own output on the
    identity).  ``precision`` and ``launches``: as in
    phase_main_shapes."""
    import torch
    from repro_torch.core.staging import table_arrays
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels import spectral as ksp
    from repro_torch.kernels.launcher import leg_orientation
    basis, gains = engine.basis, engine._live.bank_gains
    fwd, bwd = at_precision(precision, basis.fwd, basis.bwd)
    bsz, rows, n = x.shape
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    ragged = torch.randn((bsz, 130, n), generator=gen, device=DEVICE)
    f = single["fgft"]
    sfwd, sbwd = at_precision(precision, f.fwd, f.bwd)
    x0, g0 = single["signals"], single["gains"]
    for tag, tf, tb, g, xin in (
            (f"B={bsz} R={rows}", fwd, bwd, gains, x),
            (f"B=1 R={x0.shape[0]}", sfwd, sbwd, g0, x0)):
        check_bank_tables(f"{family} bank n={n} {tag}", tf, tb, g, xin, errs)
    # 33 filters: the served ones and 26 random ones, at R = 130
    wide = torch.cat([gains, torch.rand((bsz, 26, n), generator=gen,
                                        device=DEVICE) * 2.0], dim=1)
    wide1 = torch.cat([g0, wide[0, 7:]], dim=0)

    def first_two(staged):
        return type(staged)(*(t[:2].contiguous()
                              for t in table_arrays(staged)),
                            staged.cuts, staged.n)
    for tag, tf, tb, g, xin, split in (
            (f"B={bsz} R=130", fwd, bwd, wide, ragged, False),
            ("B=2 R=130", first_two(fwd), first_two(bwd), wide[:2],
             ragged[:2].contiguous(), True),
            ("B=1 R=130", sfwd, sbwd, wide1, x0[:130].contiguous(), True)):
        groups = check_bank_tables(f"{family} bank n={n} {tag}", tf, tb, g,
                                   xin, errs, (1, 7, 33))
        check(not split or groups[33] > 1,
              f"{family} bank {tag}: F = 33 ran in one filter group")
    torch.cuda.synchronize()
    ext_ms = time_ms(lambda: (launcher.stage_extents(bwd),
                              launcher.stage_extents(fwd)))
    ext_ms1 = time_ms(lambda: (launcher.stage_extents(sbwd),
                               launcher.stage_extents(sfwd)))
    log(f"[time] {family} bank stage extents of both legs: {ext_ms:.4f} ms "
        f"at {list(fwd.idx_i.shape)} x 2, {ext_ms1:.4f} ms at "
        f"{list(sfwd.idx_i.shape)} x 2")

    entry = ("sym" if family == "sym" else "gen") + "_filter_bank_apply"
    bank, bank1 = getattr(ksp, "batched_" + entry), getattr(ksp, entry)
    plain, plain1 = getattr(ref, "batched_" + entry), getattr(ref, entry)
    eye = torch.eye(n, device=DEVICE)
    # row r of a bank's output on the identity is op e_r: transposed, the
    # dense (B, F, n, n) / (F, n, n) operators
    ops = bank(fwd, bwd, gains, eye.expand(bsz, n, n).contiguous()
               ).transpose(-1, -2).contiguous()
    ops1 = bank1(sfwd, sbwd, g0, eye).transpose(-1, -2).contiguous()
    a_keep, s_keep = leg_orientation(family)
    legs = [real_entries(bwd, None, a_keep), real_entries(fwd, None, s_keep)]
    legs1 = [real_entries(sbwd, None, a_keep),
             real_entries(sfwd, None, s_keep)]
    kernel = "g_bank_kernel" if family == "sym" else "t_bank_kernel"
    cases = [
        (kernel, "batched_" + entry, x, legs, gains.shape[1],
         lambda: bank(fwd, bwd, gains, x),
         lambda: plain(fwd, bwd, gains, x),
         lambda: torch.matmul(x.unsqueeze(1), ops.transpose(-1, -2))),
        (kernel, entry, x0, legs1, g0.shape[0],
         lambda: bank1(sfwd, sbwd, g0, x0),
         lambda: plain1(sfwd, sbwd, g0, x0),
         lambda: torch.matmul(x0.unsqueeze(0), ops1.transpose(-1, -2))),
    ]
    out = timed_rows(cases, path, single, fwd, sfwd, errs, family,
                     precision, launches)
    for row, ms in zip(out, (ext_ms, ext_ms1)):
        row["extent_ms"] = ms
        check(row["resident_per_sm"] >= 3,
              f"{row['name']}: {row['resident_per_sm']} resident CTAs per SM")
    return out


def check_round_trip(tag, xr, x, t_dense, num_stages: int) -> float:
    """synthesis(analysis(x)) == x for a T basis.  Tbar is not
    orthogonal: the round trip is exact only up to f32 rounding across
    the 2S stages, amplified by cond(Tbar).  Tolerance
    4 eps cond(Tbar) sqrt(2S) max(1, max|x|), with cond(Tbar) < 1e4
    required (printed with it).  Returns max|dx|."""
    import numpy as np
    import torch
    cond = float(torch.linalg.cond(t_dense.double()).max())
    stages = 2 * num_stages
    tol = 4 * float(np.finfo(np.float32).eps) * cond * stages ** 0.5
    err, scale = max_err(xr, x)
    log(f"[{tag}] synthesis(analysis(x)) vs x: max|dx| {err:.3e}, "
        f"tolerance {tol:.3e} * {scale:.3e} (max cond(Tbar) {cond:.1f}, "
        f"{stages} stages)")
    check(cond < 1e4, f"{tag}: cond(Tbar) {cond} >= 1e4")
    check(err <= tol * scale, f"{tag}: round trip max|dx| {err:.3e}")
    return err


def phase_main_directed() -> dict:
    """The directed main path through the CLI, then an analysis /
    synthesis round trip through ``ApproxEigenbasis.apply``."""
    import numpy as np
    import torch
    from repro_torch.core.ttransform import t_to_dense
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    argv = ["--fgft", "--directed", "--graphs", str(MAIN["graphs"]),
            "--graph-n", str(MAIN["n"]), "--signals", str(MAIN["signals"]),
            "--filter-steps", str(MAIN["steps"]), "--tiers", MAIN["tiers"],
            "--device", DEVICE]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    basis = out["engine"].basis
    x = out["signals"]
    xr = basis.apply(basis.apply(x, inverse=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[main-directed] serve --fgft {' '.join(argv[1:])} + apply round "
        f"trip: {wall:.1f}s (fit {out['fit_s']:.1f}s); launches {launches}")
    for entry in ("batched_gen_operator_apply", "batched_shear_apply"):
        check(launches[entry] > 0, f"directed path never launched {entry}")
    check(basis.kind == "general", f"directed fleet fitted as {basis.kind}")
    engine, laps = out["engine"], out["laps"]
    n = basis.n
    lap_t = torch.from_numpy(laps).to(basis.device)
    t_dense = t_to_dense(basis.factors, n)
    t_inv = t_to_dense(basis.factors, n, inverse=True)
    recon = t_dense @ torch.diag_embed(basis.spectrum) @ t_inv
    dense = (((lap_t - recon) ** 2).sum((1, 2))
             / (lap_t ** 2).sum((1, 2))).cpu().numpy()
    rel = np.asarray(out["rel_error"], np.float64)
    mean_rel, mean_dense = float(rel.mean()), float(dense.mean())
    log(f"[main-directed] full-tier relative error: mean {mean_rel:.6f} "
        f"from the fit objective, {mean_dense:.6f} recomputed densely")
    check(bool(np.isfinite(rel).all()), "non-finite relative error")
    check(mean_rel < 0.05, f"mean relative error {mean_rel} >= 0.05")
    check(abs(mean_dense - mean_rel) <= 1e-3 * mean_rel,
          f"dense relative error {mean_dense} != objective {mean_rel}")
    trip_err = check_round_trip("main-directed", xr, x, t_dense,
                                basis.fwd.num_stages)
    for name, ts in out["tiers"].items():
        log(f"[main-directed] tier {name}: {ts['transforms_per_s']:.1f} "
            f"graph-transforms/s, {ts['num_transforms']} components, "
            f"{ts['num_stages']} stages")
    y = engine.step(x, lowpass, tier="full")
    plain = ApplyPlan(family="general", mode="operator", n=n, batched=True,
                      backend="torch", device=DEVICE).program()
    spec = engine.tiers["full"]["spectrum"]
    y_ref = plain(engine._live.fwd, engine._live.bwd, lowpass(spec), x)
    check(tuple(y.shape) == tuple(x.shape), f"served shape {tuple(y.shape)}")
    err, scale = max_err(y, y_ref)
    check(err == 0.0, f"served full tier max|dy| {err:.3e} (want 0)")
    log(f"[main-directed] served full tier vs plain version: max|dy| "
        f"{err:.3e} (scale {scale:.3e})")
    bank = directed_bank(laps, basis, x)
    return {"out": out, "launches": launches, "wall_s": wall,
            "mean_rel": mean_rel, "mean_rel_dense": mean_dense,
            "served_err": err, "round_trip_err": trip_err, "bank": bank}


def directed_bank(laps, basis, x) -> dict:
    """The directed filter bank on the fitted basis of the directed main
    path (no second T fit): an engine with the bank spec serves one
    warm-up and MAIN["steps"] bank steps with the counters zeroed just
    before; bank and each filter are held bitwise to the plain version
    and to the operator kernel."""
    import torch
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    engine = serve.FGFTServeEngine(laps, basis=basis, kind="general",
                                   filters=MAIN["filters"], device=DEVICE)
    y = engine.step_bank(x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(MAIN["steps"]):
        y = engine.step_bank(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = launcher.entry_launch_counts()
    bsz, rows, n = x.shape
    nf = len(engine.bank)
    rate = MAIN["steps"] * bsz * nf / dt
    log(f"[main-directed] bank {MAIN['filters']} on the fitted basis: "
        f"{time.perf_counter() - t0:.1f}s, {rate:.1f} responses/s; "
        f"launches {launches}")
    check(launches["batched_gen_filter_bank_apply"] > 0,
          "directed bank never launched batched_gen_filter_bank_apply")
    check(tuple(y.shape) == (bsz, nf, rows, n), f"bank shape {tuple(y.shape)}")
    live = engine._live
    plain = ApplyPlan(family="general", mode="bank", n=n, batched=True,
                      backend="torch", device=DEVICE).program()
    err, scale = max_err(y, plain(live.fwd, live.bwd, live.bank_gains, x))
    check(err == 0.0, f"directed bank vs plain max|dy| {err:.3e} (want 0)")
    log(f"[main-directed] served bank {list(y.shape)} vs plain version: "
        f"max|dy| {err:.3e} (scale {scale:.3e})")
    check_bank_slices("main-directed", engine, y, x, 0.0)
    return {"engine": engine, "launches": launches, "responses_per_s": rate,
            "served_err": err}


def phase_fgft_directed(errs) -> dict:
    """The single-graph T entry points at the main path's width."""
    import numpy as np
    import torch
    from repro_torch.core import build_fgft, relative_error
    from repro_torch.core.ttransform import t_to_dense
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels.plan import ApplyPlan
    n = MAIN["n"]
    g = int(2 * n * np.log2(n))
    lap = directed_laps(n, 1)[0]
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    x = torch.randn((MAIN["signals"], n), generator=gen, device=DEVICE)
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    f = build_fgft(lap, g, directed=True, n_iter=3, device=DEVICE)
    fit_s = time.perf_counter() - t0
    xh = f.analysis(x)
    xr = f.synthesis(xh)
    y = f.project(x, lowpass)
    gains = bank_gains(f.spectrum)
    yb = ApplyPlan(family="general", mode="bank", n=n, batched=False,
                   device=DEVICE).bank(f.fwd, f.bwd, gains, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[single-directed] build_fgft(directed) n={n} g={g} + "
        f"analysis/synthesis/project/bank of R={x.shape[0]}: {wall:.1f}s "
        f"(fit {fit_s:.1f}s); launches {launches}")
    for entry in ("gen_operator_apply", "shear_apply",
                  "gen_filter_bank_apply"):
        check(launches[entry] > 0,
              f"directed single-graph path never launched {entry}")
    rel = relative_error(lap, f)
    log(f"[single-directed] relative error {rel:.6f}, "
        f"{f.fwd.idx_i.shape[0]} stages of {f.fwd.idx_i.shape[1]} entries")
    check(np.isfinite(rel) and rel < 0.05, f"relative error {rel} >= 0.05")
    compare("shear_apply", xh, ref.staged_t_apply(f.bwd, x, None, "tail"),
            errs)
    compare("shear_apply", xr, ref.staged_t_apply(f.fwd, xh), errs)
    compare("gen_operator_apply", y, ref.gen_operator_apply(
        f.fwd, f.bwd, lowpass(f.spectrum), x), errs)
    compare("gen_filter_bank_apply", yb, ref.gen_filter_bank_apply(
        f.fwd, f.bwd, gains, x), errs)
    check_round_trip("single-directed", xr, x,
                     t_to_dense(f.t_factors, n), f.fwd.num_stages)
    return {"fgft": f, "launches": launches, "signals": x, "gains": gains}


def phase_directed_shapes(main, single, errs, precision: str = "f32",
                          launches=None) -> list:
    """T kernels vs plain at the directed paths' shapes (every cut),
    then timings; ``precision`` and ``launches``: as in
    phase_main_shapes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import shear as sh
    basis = main["out"]["engine"].basis
    fwd, inv = at_precision(precision, basis.fwd, basis.bwd)
    n, bsz = basis.n, basis.spectrum.shape[0]
    x = main["out"]["signals"]
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    ragged = torch.randn((bsz, 130, n), generator=gen, device=DEVICE)
    check_t_tables(f"main-directed n={n} B={bsz} R={x.shape[1]}", fwd, inv,
                   basis.spectrum, x, errs)
    check_t_tables(f"main-directed n={n} B={bsz} R=130", fwd, inv,
                   basis.spectrum, ragged, errs)
    f = single["fgft"]
    sfwd, sinv = at_precision(precision, f.fwd, f.bwd)
    sspec, x0 = f.spectrum, single["signals"]
    check_t_tables(f"fgft-directed n={n} B=1 R={x0.shape[0]}", sfwd, sinv,
                   sspec, x0, errs)
    torch.cuda.synchronize()

    # timings at the paths' shapes (full chain); dense yardsticks from
    # the kernels' own output
    eye = torch.eye(n, device=DEVICE)
    tt_rows = sh.batched_shear_apply(
        fwd, eye.expand(bsz, n, n).contiguous())           # rows: Tbar^T
    t_dense = tt_rows.transpose(1, 2).contiguous()
    spec = basis.spectrum
    dense_op = sh.batched_gen_operator_apply(
        fwd, inv, spec,
        eye.expand(bsz, n, n).contiguous()).transpose(1, 2).contiguous()
    st = sh.shear_apply(sfwd, eye).T.contiguous()
    sdense = sh.gen_operator_apply(sfwd, sinv, sspec, eye).T.contiguous()
    fwd_legs = [real_entries(fwd, None, "head")]
    op_legs = [real_entries(inv, None, "tail")] + fwd_legs
    single_fwd = [real_entries(sfwd, None, "head")]
    single_op = [real_entries(sinv, None, "tail")] + single_fwd
    cases = [
        ("t_operator_kernel", "batched_gen_operator_apply", x, op_legs, 1,
         lambda: sh.batched_gen_operator_apply(fwd, inv, spec, x),
         lambda: ref.batched_gen_operator_apply(fwd, inv, spec, x),
         lambda: torch.bmm(x, dense_op.transpose(1, 2))),
        ("t_chain_kernel", "batched_shear_apply", x, fwd_legs, 0,
         lambda: sh.batched_shear_apply(fwd, x),
         lambda: ref.batched_t_apply(fwd, x),
         lambda: torch.bmm(x, t_dense.transpose(1, 2))),
        ("t_operator_kernel", "gen_operator_apply", x0, single_op, 1,
         lambda: sh.gen_operator_apply(sfwd, sinv, sspec, x0),
         lambda: ref.gen_operator_apply(sfwd, sinv, sspec, x0),
         lambda: torch.mm(x0, sdense.T)),
        ("t_chain_kernel", "shear_apply", x0, single_fwd, 0,
         lambda: sh.shear_apply(sfwd, x0),
         lambda: ref.staged_t_apply(sfwd, x0),
         lambda: torch.mm(x0, st.T)),
    ]
    return timed_rows(cases, main, single, fwd, sfwd, errs, "general",
                      precision, launches)


def sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def masked_gains(basis, gains):
    """``gains`` (B, n) zeroed at the pad coordinates of a ragged basis
    (computed here from ``basis.sizes``, not by the engine)."""
    import torch
    if basis.sizes is None:
        return gains
    valid = (torch.arange(basis.n, device=gains.device)
             < torch.as_tensor(basis.sizes, device=gains.device)[:, None])
    return torch.where(valid, gains, torch.zeros_like(gains))


def ragged_blocks(router, seed: int, rows: int):
    """Random (B_w, R, w) blocks per bucket with NONZERO pad coordinates
    (the pass-through checks need signal there)."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return {w: torch.randn((len(m), rows, w), generator=gen, device=DEVICE)
            for w, m in sorted(router.bucket_of.items())}


def ragged_step_times(tag, calls: dict, kernel: str, launches: int,
                      graphs: int, steps: int = 50) -> dict:
    """Per call (a tier's step or the bank's): the host's enqueue time and
    the synchronized wall time per step over ``steps`` steps, the rate
    (``graphs`` per step), and the profiler's device time of ``kernel``
    per step (``launches`` launches each) with the card's idle share."""
    import torch
    out = {}
    for name, fn in calls.items():
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        t1 = time.perf_counter()
        sync()
        wall = (time.perf_counter() - t0) / steps * 1e3
        enqueue = (t1 - t0) / steps * 1e3
        dev = device_ms(fn, kernel) if torch.cuda.is_available() else None
        dev_step = None if dev is None else dev * launches
        out[name] = {"enqueue_ms": enqueue, "wall_ms": wall,
                     "per_s": graphs / wall * 1e3, "device_ms": dev_step}
        dev_txt = ("not measured" if dev_step is None else
                   f"{dev_step:.4f} ms ({launches} launches), idle "
                   f"{1.0 - dev_step / wall:.2f}")
        log(f"[{tag}] {name}: {steps} steps, host enqueue {enqueue:.4f} "
            f"ms/step, wall {wall:.4f} ms/step ({graphs / wall * 1e3:.1f} "
            f"per s); device {dev_txt}")
    return out


def ragged_host_split(tag, router, x, steps: int = 50) -> dict:
    """Host enqueue time per call of the three parts of a full-tier
    router step: the scatter into padded blocks, the bucket engines'
    steps on those blocks, and the crops (the card finishes its work
    between the parts, so each is the host's alone)."""
    blocks = router._scatter(x)
    ys = {w: router.engines[w].step(b, lowpass) for w, b in blocks.items()}
    parts = {"scatter": lambda: router._scatter(x),
             "engine steps": lambda: {w: router.engines[w].step(b, lowpass)
                                      for w, b in blocks.items()},
             "crops": lambda: router._gather(ys)}
    out = {}
    for name, fn in parts.items():
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        out[name] = (time.perf_counter() - t0) / steps * 1e3
        sync()
    log(f"[{tag}] host enqueue per full-tier step, by part: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def check_ragged_pads(tag, router, blocks, tol: float,
                      precision: str = "f32") -> None:
    """Per bucket: ``apply`` (synthesis, analysis and the round trip)
    passes pad coordinates through BITWISE, ``project`` with the heat
    response (h(0) = 1) gives exactly 0 there, and ``apply`` equals its
    plain version (G within ``tol`` * scale, T bitwise), each at the
    table ``precision``."""
    import torch
    from repro_torch.spectral import named_responses
    heat = named_responses("heat")["heat"]
    at = dict(precision=precision)
    for w, eng in sorted(router.engines.items()):
        basis, x = eng.basis, blocks[w]
        y = basis.apply(x, **at)
        xa = basis.apply(x, inverse=True, **at)
        xr = basis.apply(xa, **at)
        p = basis.project(x, h=heat, **at)
        err, scale = max_err(y, basis.apply(x, backend="torch", **at))
        check(err <= tol * scale, f"{tag} bucket {w}: apply vs plain "
              f"max|dy| {err:.3e}")
        sizes = basis.sizes if basis.sizes is not None else [w] * len(x)
        for b, s in enumerate(sizes):
            for name, got in (("synthesis", y), ("analysis", xa),
                              ("round trip", xr)):
                check(torch.equal(got[b, :, s:], x[b, :, s:]),
                      f"{tag} bucket {w} graph {b}: {name} changed its "
                      f"pad coordinates")
            check(bool((p[b, :, s:] == 0).all()),
                  f"{tag} bucket {w} graph {b}: project(heat) is not 0 "
                  f"at the pads")
    sync()
    log(f"[{tag}] pads of every bucket ({precision} tables): synthesis, "
        f"analysis and round trip bitwise the input's; project(heat, "
        f"h(0) = 1) exactly 0")


def check_ragged_served(tag, router, signals, tol: float) -> float:
    """Each bucket's served full-tier output against the plain operator
    program on the same tables and masked gains; every graph's cropped
    answer equals its bucket row and the bucket's pads are 0.  Returns
    the largest max|dy|."""
    import torch
    from repro_torch.kernels.plan import ApplyPlan
    ys = router.step(signals, lowpass, tier="full")
    blocks = router._scatter(signals)
    worst = 0.0
    for w, eng in sorted(router.engines.items()):
        live, basis = eng._live, eng.basis
        plain = ApplyPlan(family=basis.kind, mode="operator", n=w,
                          batched=True, backend="torch",
                          device=DEVICE).program()
        d = masked_gains(basis, lowpass(eng.tiers["full"]["spectrum"]))
        y = eng.step(blocks[w], lowpass, tier="full")
        err, scale = max_err(y, plain(live.fwd, live.bwd, d, blocks[w]))
        check(err <= tol * scale, f"{tag} bucket {w}: served vs plain "
              f"max|dy| {err:.3e} > {tol} * {scale:.3e}")
        worst = max(worst, err)
        for row, pos in enumerate(router.bucket_of[w]):
            n = router.sizes[pos]
            check(ys[pos].device.type == torch.device(DEVICE).type
                  and tuple(ys[pos].shape) == (signals[pos].shape[0], n),
                  f"{tag}: graph {pos} served {tuple(ys[pos].shape)} on "
                  f"{ys[pos].device}")
            check(torch.equal(ys[pos], y[row, :, :n]),
                  f"{tag}: graph {pos} != its bucket row")
            check(bool((y[row, :, n:] == 0).all()),
                  f"{tag}: graph {pos}'s pads are not 0")
    sync()
    log(f"[{tag}] served full tier of every bucket vs the plain version: "
        f"max|dy| {worst:.3e} (tolerance {tol} * scale); crops in request "
        f"order, pads 0")
    return worst


def phase_main_ragged(errs, cfg=None) -> dict:
    """The heterogeneous-fleet path through the CLI: ``serve --fgft
    --ragged``, then save / load of the router and its bank served from
    the restored router (no second fit), then a small directed ragged
    fleet held bitwise to the plain versions."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.gtransform import g_to_dense
    from repro_torch.core.staging import table_arrays
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    cfg = dict(RAGGED, **(cfg or {}))
    argv = ["--fgft", "--ragged", "--graphs", str(cfg["graphs"]),
            "--graph-sizes", cfg["sizes"], "--transforms",
            str(cfg["transforms"]), "--signals", str(MAIN["signals"]),
            "--filter-steps", str(MAIN["steps"]), "--tiers", MAIN["tiers"],
            "--device", DEVICE]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    sync()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    router = out["router"]
    buckets = {w: len(m) for w, m in sorted(router.bucket_of.items())}
    g = {w: e.basis.num_transforms for w, e in sorted(router.engines.items())}
    log(f"[main-ragged] serve {' '.join(argv)}: {wall:.1f}s (fit "
        f"{out['fit_s']:.1f}s); buckets {buckets}, g per bucket {g}; "
        f"launches {launches}")
    check(buckets == cfg["buckets"], f"buckets {buckets}")
    check(g == cfg["g"], f"g per bucket {g}")
    for entry in ("batched_sym_operator_apply", "batched_butterfly_apply"):
        check(launches[entry] > 0, f"ragged path never launched {entry}")
    for name, ts in out["tiers"].items():
        log(f"[main-ragged] tier {name}: {ts['transforms_per_s']:.1f} "
            f"graph-transforms/s, components per bucket "
            f"{ts['num_transforms']}, stages {ts['num_stages']}")
    x = out["signals"]
    nb = len(router.engines)
    step_times = ragged_step_times(
        "main-ragged", {f"tier {name}": (lambda t=name: router.step(
            x, lowpass, tier=t)) for name in out["tiers"]},
        "g_operator_kernel", nb, len(x))
    host_split = ragged_host_split("main-ragged", router, x)
    # each graph's relative error against a dense recomputation on its
    # cropped block
    rel = np.asarray(out["rel_error"], np.float64)
    dense = np.zeros_like(rel)
    for w, eng in sorted(router.engines.items()):
        basis = eng.basis
        u = g_to_dense(basis.factors, w)
        recon = (u @ torch.diag_embed(basis.spectrum)
                 @ u.transpose(1, 2)).double().cpu().numpy()
        for row, pos in enumerate(router.bucket_of[w]):
            n = router.sizes[pos]
            lap = np.asarray(out["laps"][pos], np.float64)
            dense[pos] = (((lap - recon[row, :n, :n]) ** 2).sum()
                          / (lap ** 2).sum())
    dev_rel = float(np.max(np.abs(dense - rel) / rel))
    log(f"[main-ragged] full-tier relative error: mean {rel.mean():.6f} "
        f"(per bucket " + ", ".join(
            f"{w}: {rel[m].mean():.6f}" for w, m in
            sorted(router.bucket_of.items())) + f"); dense recomputation "
        f"on the cropped blocks: mean {dense.mean():.6f}, worst relative "
        f"deviation {dev_rel:.2e}")
    check(bool(np.isfinite(rel).all()), "non-finite relative error")
    check(float(rel.mean()) < 0.05, f"mean relative error {rel.mean()}")
    check(dev_rel <= 1e-3, f"dense relative error deviates {dev_rel:.3e}")
    served_err = check_ragged_served("main-ragged", router, out["signals"],
                                     TOL)
    errs["batched_sym_operator_apply"] = max(
        errs.get("batched_sym_operator_apply", 0.0), served_err)
    check_ragged_pads("main-ragged", router,
                      ragged_blocks(router, 29, 130), TOL)

    # save / load: the restored router serves the bank without a refit
    ckpt = ROOT / "build" / "ragged_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    router.save(ckpt)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = serve.RaggedFGFTServeEngine.load(
        ckpt, filters=MAIN["filters"], device=DEVICE)
    sync()
    load_s = time.perf_counter() - t0
    size_mb = sum(p.stat().st_size for p in ckpt.rglob("*")
                  if p.is_file()) / 2 ** 20
    check(restored.widths == router.widths
          and restored.bucket_of == router.bucket_of, "restored geometry")
    for w, eng in router.engines.items():
        back = restored.engines[w]
        for leg in ("fwd", "bwd"):
            for a, b in zip(table_arrays(getattr(eng.basis, leg)),
                            table_arrays(getattr(back.basis, leg))):
                check(torch.equal(a, b), f"bucket {w}: restored {leg} "
                      f"tables differ")
    for tier in router.engines[max(router.engines)].tiers:
        for pos, (a, b) in enumerate(zip(router.step(x, lowpass, tier=tier),
                                         restored.step(x, lowpass,
                                                       tier=tier))):
            check(torch.equal(a, b), f"restored router, tier {tier}: "
                  f"graph {pos} differs")
    sync()
    log(f"[main-ragged] router saved in {save_s:.2f}s ({size_mb:.1f} MiB, "
        f"{len(router.engines)} bucket checkpoints) and loaded with filters "
        f"{MAIN['filters']} in {load_s:.2f}s; staged tables bitwise equal, "
        f"every tier's steps bitwise equal to the saved router's")
    restored.step_bank(x)                       # warmup: not counted
    sync()
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(MAIN["steps"]):
        yb = restored.step_bank(x)
    sync()
    dt = time.perf_counter() - t0
    bank_launches = launcher.entry_launch_counts()
    nf = len(restored.engines[max(restored.engines)].bank)
    rate = MAIN["steps"] * len(x) * nf / dt
    log(f"[main-ragged] restored router's bank ({nf} filters): "
        f"{rate:.1f} responses/s; launches {bank_launches}")
    step_times.update(ragged_step_times(
        "main-ragged", {"bank": lambda: restored.step_bank(x)},
        "g_bank_kernel", nb, len(x) * nf))
    check(bank_launches["batched_sym_filter_bank_apply"]
          == MAIN["steps"] * len(restored.engines),
          "the restored router's bank did not launch once per bucket "
          "and step")
    blocks = restored._scatter(x)
    plain_bank = {}
    for w, eng in sorted(restored.engines.items()):
        live = eng._live
        y = eng.step_bank(blocks[w])
        plain = ApplyPlan(family="sym", mode="bank", n=w, batched=True,
                          backend="torch", device=DEVICE).program()
        err, scale = max_err(y, plain(live.fwd, live.bwd, live.bank_gains,
                                      blocks[w]))
        check(err <= TOL * scale, f"bucket {w}: bank vs plain max|dy| "
              f"{err:.3e}")
        plain_bank[w] = err
        errs["batched_sym_filter_bank_apply"] = max(
            errs.get("batched_sym_filter_bank_apply", 0.0), err)
        check_bank_slices(f"main-ragged bucket {w}", eng, y, blocks[w], TOL)
        for row, pos in enumerate(restored.bucket_of[w]):
            n = restored.sizes[pos]
            check(bool((y[row, :, :, n:] == 0).all()),
                  f"bucket {w}: bank pads of graph {pos} are not 0")
            check(torch.equal(yb[pos], y[row, :, :, :n]),
                  f"bank of graph {pos} != its bucket row")
    log(f"[main-ragged] bank of every bucket vs plain version: max|dy| "
        f"{plain_bank}; pads 0")
    directed = ragged_directed(cfg)
    return {"out": out, "launches": launches, "wall_s": wall,
            "mean_rel": float(rel.mean()), "dense_dev": dev_rel,
            "served_err": served_err, "save_s": save_s, "load_s": load_s,
            "checkpoint_mib": size_mb, "bank_responses_per_s": rate,
            "step_times": step_times, "host_split": host_split,
            "bank_launches": bank_launches, "directed": directed}


def ragged_directed(cfg) -> dict:
    """A small directed ragged fleet (T fit, n_iter = 1): the T operator,
    chain and bank of every bucket held BITWISE to their plain versions,
    and the pads passed through bitwise."""
    import torch
    from repro_torch.core import laplacian
    from repro_torch.graphs import community_graph, directed_variant
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    sizes = [int(s) for s in cfg["directed_sizes"].split(",")]
    sizes = [sizes[i % len(sizes)] for i in range(cfg["directed_graphs"])]
    laps = [laplacian(directed_variant(community_graph(n, seed=s), seed=s))
            for s, n in enumerate(sizes)]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    router = serve.RaggedFGFTServeEngine(
        laps, n_iter=1, kind="general", filters=MAIN["filters"],
        tiers={"full": 1.0}, device=DEVICE)
    sync()
    fit_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    x = [torch.randn((MAIN["signals"], n), generator=gen, device=DEVICE)
         for n in sizes]
    ys = router.step(x, lowpass)
    yb = router.step_bank(x)
    blocks = ragged_blocks(router, 37, MAIN["signals"])
    for eng in router.engines.values():
        eng.basis.apply(eng.basis.apply(blocks[eng.basis.n], inverse=True))
    sync()
    launches = launcher.entry_launch_counts()
    rel = router.rel_errors()
    log(f"[ragged-directed] {len(sizes)} directed graphs (sizes "
        f"{sorted(set(sizes))}) in buckets "
        f"{ {w: len(m) for w, m in sorted(router.bucket_of.items())} }: "
        f"fit {fit_s:.1f}s, mean rel error {rel.mean():.6f}; launches "
        f"{launches}")
    for entry in ("batched_gen_operator_apply", "batched_shear_apply",
                  "batched_gen_filter_bank_apply"):
        check(launches[entry] > 0, f"directed ragged check never launched "
              f"{entry}")
    check(router.engines[max(router.engines)].basis.kind == "general",
          "directed fleet fitted as sym")
    xb = router._scatter(x)
    for w, eng in sorted(router.engines.items()):
        live, basis = eng._live, eng.basis
        d = masked_gains(basis, lowpass(eng.tiers["full"]["spectrum"]))
        op = ApplyPlan(family="general", mode="operator", n=w, batched=True,
                       backend="torch", device=DEVICE).program()
        bank = ApplyPlan(family="general", mode="bank", n=w, batched=True,
                         backend="torch", device=DEVICE).program()
        checks = (("batched_gen_operator_apply", eng.step(xb[w], lowpass),
                   op(live.fwd, live.bwd, d, xb[w])),
                  ("batched_gen_filter_bank_apply", eng.step_bank(xb[w]),
                   bank(live.fwd, live.bwd, live.bank_gains, xb[w])),
                  ("batched_shear_apply", basis.apply(blocks[w]),
                   basis.apply(blocks[w], backend="torch")),
                  ("batched_shear_apply", basis.apply(blocks[w],
                                                      inverse=True),
                   basis.apply(blocks[w], inverse=True, backend="torch")))
        for entry, got, want in checks:
            check(torch.equal(got, want), f"directed bucket {w}: {entry} "
                  f"!= its plain version (want bitwise)")
        for row, pos in enumerate(router.bucket_of[w]):
            n = sizes[pos]
            check(torch.equal(ys[pos], eng.step(xb[w], lowpass)[row, :, :n]),
                  f"directed graph {pos} != its bucket row")
            check(bool((yb[pos] == eng.step_bank(xb[w])[row, :, :, :n]).all()),
                  f"directed bank of graph {pos} != its bucket row")
    check_ragged_pads("ragged-directed", router, blocks, 0.0)
    log("[ragged-directed] T operator, chain (both legs) and bank of every "
        "bucket bitwise equal to their plain versions")
    return {"launches": launches, "fit_s": fit_s,
            "mean_rel": float(rel.mean())}


@contextlib.contextmanager
def uncounted():
    """Launches inside (comparisons with the plain versions, error
    checks) leave the launch counts as they were."""
    from repro_torch.kernels import launcher
    saved = launcher.entry_launch_counts()
    try:
        yield
    finally:
        launcher.reset_launch_counts()
        launcher._launches.update(saved)


def device_total_ms(fn, kernel: str, reps: int = 5, traces: int = 5):
    """Device time per call of fn summed over every kernel it launches
    (torch.profiler's CUDA events), from a trace that holds all ``reps``
    launches of ``kernel`` (a trace now and then drops events); None
    when no trace does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        if sum(e.count for e in events if kernel in e.key) != reps:
            continue
        total = sum(getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0.0) for e in events)
        return total / 1e3 / reps
    return None


def table_shape(basis) -> str:
    s, p = basis.fwd.idx_i.shape[-2:]
    return f"(S, P) = ({s}, {p}), g = {basis.num_transforms}"


def dense_rel_error(basis, laps):
    """Per-graph ||L - U diag(s) U^T||^2 / ||L||^2 from the dense chain
    (plain torch: g_to_dense / t_to_dense)."""
    import torch
    from repro_torch.core.gtransform import g_to_dense
    from repro_torch.core.ttransform import t_to_dense
    lap = torch.as_tensor(laps, dtype=torch.float32).to(basis.device)
    if basis.kind == "sym":
        u = g_to_dense(basis.factors, basis.n)
        recon = u @ torch.diag_embed(basis.spectrum) @ u.transpose(-1, -2)
    else:
        recon = (t_to_dense(basis.factors, basis.n)
                 @ torch.diag_embed(basis.spectrum)
                 @ t_to_dense(basis.factors, basis.n, inverse=True))
    return (((lap - recon) ** 2).sum((-2, -1))
            / (lap ** 2).sum((-2, -1))).cpu().numpy()


def check_swap(tag, engine, x, y, errs, structural: bool) -> dict:
    """After a hot swap: the served full tier (y on x) against the plain
    operator on the live tables; the full-tier relative error through the
    operator kernel (``exact_rel_residual``) and, when the swap was a
    ``structural`` fit (EXTEND, REFIT) on the tracked Laplacians, from
    its objective, each against the dense recomputation within 1e-3
    relative."""
    import numpy as np
    from repro_torch.dynamic import exact_rel_residual
    from repro_torch.kernels.plan import ApplyPlan
    live, basis = engine._live, engine.basis
    with uncounted():
        plain = ApplyPlan(family=basis.kind, mode="operator", n=basis.n,
                          batched=True, backend="torch",
                          device=DEVICE).program()
        want = plain(live.fwd, live.bwd,
                     lowpass(live.tiers[engine.default_tier]["spectrum"]), x)
        err, scale = max_err(y, want)
        entry = ("batched_sym_operator_apply" if basis.kind == "sym"
                 else "batched_gen_operator_apply")
        tol = tolerance(entry)
        check(err <= tol * scale, f"{tag}: served full tier vs plain "
              f"max|dy| {err:.3e} > {tol} * {scale:.3e}")
        errs[entry] = max(errs.get(entry, 0.0), err)
        laps = engine._laps
        dense = dense_rel_error(basis, laps)
        kern = exact_rel_residual(basis, laps)
        dev = float(np.max(np.abs(kern - dense) / dense))
        check(dev <= 1e-3, f"{tag}: relative error through the kernel "
              f"deviates {dev:.2e} from the dense recomputation")
        obj_dev = None
        if structural:
            from repro_torch.dynamic import relative_objective
            rel = relative_objective(basis.objective, laps)
            obj_dev = float(np.max(np.abs(rel - dense) / dense))
            check(obj_dev <= 1e-3, f"{tag}: objective relative error "
                  f"deviates {obj_dev:.2e} from the dense recomputation")
    log(f"[{tag}] served full tier vs plain max|dy| {err:.3e} (scale "
        f"{scale:.3e}); full-tier relative error mean {dense.mean():.6f} "
        f"dense, kernel deviation {dev:.2e}"
        + ("" if obj_dev is None else f", objective deviation {obj_dev:.2e}")
        + f"; {table_shape(basis)}")
    return {"served_err": err, "rel_error": float(dense.mean()),
            "kernel_dev": dev, "objective_dev": obj_dev}


def update_round(engine, stream, churn: float, seed: int,
                 directed: bool = False, graphs=None) -> None:
    """One ``edge_perturbation`` batch at ``churn`` of the edge slots for
    each graph (or those listed), through the stream into the engine."""
    from repro_torch.graphs import edge_perturbation
    for gid in (range(len(stream)) if graphs is None else graphs):
        n = stream.sizes[gid]
        batch = edge_perturbation(stream.adjs[gid],
                                  max(int(churn * n * (n - 1) / 2), 1),
                                  seed=seed + gid, directed=directed)
        engine.apply_updates(gid, stream.apply(gid, batch))


def forced_tick(tag, engine, want: str, **thresholds) -> dict:
    """One maintain tick under a policy whose thresholds are the given
    multiples of the engine's current maximum drift, so that the ladder
    takes ``want``; timed, with the stream cache's hits and misses.  A
    quiet tick first (every threshold out of reach: REUSE) clears a
    hysteresis floor that an earlier action left standing."""
    from dataclasses import replace
    import torch
    from repro_torch.kernels import launcher
    policy = engine.controller.policy
    engine.controller.policy = replace(policy, refresh=1e9, extend=1e9,
                                       refit=1e9)
    check(engine.maintain()["action"] == "reuse", f"{tag}: quiet tick")
    d = float(engine.drift().max())
    check(d > 0, f"{tag}: no drift to act on")
    engine.controller.policy = replace(
        policy, **{k: v * d for k, v in thresholds.items()})
    launcher.reset_stream_cache_counts()
    t0 = time.perf_counter()
    res = engine.maintain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cache = launcher.stream_cache_counts()
    check(res["action"] == want, f"{tag}: took {res['action']}, want {want}")
    split = engine.maintain_ms
    log(f"[{tag}] {want}: drift {d:.5f} -> {float(res['post_drift'].max()):.5f}"
        f" in {wall:.3f}s (drift probe {split['drift']:.1f} ms, action "
        f"{split['action']:.1f} ms, install {split['install']:.1f} ms, "
        f"post-action probe {split['post_drift']:.1f} ms); stream cache "
        f"{cache}; {table_shape(engine.basis)}")
    return {"action": want, "drift": d, "wall_s": wall,
            "split_ms": dict(split), "stream_cache": cache,
            "post_drift": float(res["post_drift"].max())}


def hold_pinned(tag, engine, bank_engine, x, errs) -> None:
    """Every kernel of the dynamic path against its plain version on the
    engine's pinned (and extended) tables: the operator at R = 256 and at
    the probe's R = 8 (every cut at R = 8, the full chain at R = 256),
    the chain on the identity block at every cut, the bank (F = 7)
    served by ``bank_engine`` on the same basis."""
    import torch
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import ApplyPlan
    basis = engine.basis
    fwd, bwd, spec = basis.fwd, basis.bwd, basis.spectrum
    bsz, n = spec.shape
    x8 = x[:, :8].contiguous()
    eye = torch.eye(n, device=DEVICE).expand(bsz, n, n).contiguous()
    with uncounted():
        compare("batched_sym_operator_apply",
                bf.batched_sym_operator_apply(fwd, bwd, spec, x),
                ref.batched_sym_operator_apply(fwd, bwd, spec, x), errs)
        for k in [None, *cut_list(fwd)]:
            compare("batched_sym_operator_apply",
                    bf.batched_sym_operator_apply(fwd, bwd, spec, x8, k),
                    ref.batched_sym_operator_apply(fwd, bwd, spec, x8, k),
                    errs)
            compare("batched_butterfly_apply",
                    bf.batched_butterfly_apply(fwd, eye, k, "tail"),
                    ref.batched_g_apply(fwd, eye, k, "tail"), errs)
        live = bank_engine._live
        plain = ApplyPlan(family="sym", mode="bank", n=n, batched=True,
                          backend="torch", device=DEVICE).program()
        yb = bank_engine.step_bank(x)
        compare("batched_sym_filter_bank_apply", yb,
                plain(live.fwd, live.bwd, live.bank_gains, x), errs)
        check_bank_slices(tag, bank_engine, yb, x, TOL)
    sync()
    log(f"[{tag}] operator (R = {x.shape[1]} full, R = 8 at every cut), "
        f"chain on the identity at every cut and bank (F = "
        f"{len(bank_engine.bank)}) vs plain on {table_shape(basis)}: "
        f"max|dy| operator {errs['batched_sym_operator_apply']:.3e}, chain "
        f"{errs['batched_butterfly_apply']:.3e}, bank "
        f"{errs['batched_sym_filter_bank_apply']:.3e}")


def phase_main_dynamic(errs, main_dir) -> dict:
    """The evolving-fleet path: a. ``serve --fgft --dynamic`` at full
    width through the CLI, each swap checked; b. REFRESH and EXTEND forced
    on the same engine, every kernel held to its plain version on the
    pinned and extended tables; c. a REFIT on a small fleet; d. the
    directed engine on [main-directed]'s basis; e. [main-ragged]'s saved
    router loaded dynamic.  Counts are zeroed before each driven part
    and read after it; comparisons do not count."""
    from collections import Counter
    import numpy as np
    import torch
    from repro_torch.dynamic import GraphStream, RefitPolicy
    from repro_torch.graphs import community_graph, directed_variant
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    counts: Counter = Counter()

    def driven(fn):
        launcher.reset_launch_counts()
        out = fn()
        sync()
        counts.update(launcher.entry_launch_counts())
        return out

    cfg = DYNAMIC
    # a. the CLI at full width, each swap checked after its round
    argv = ["--fgft", "--dynamic", "--graphs", str(cfg["graphs"]),
            "--graph-n", str(cfg["n"]), "--transforms",
            str(cfg["transforms"]), "--signals", str(cfg["signals"]),
            "--update-rounds", str(cfg["rounds"]), "--churn",
            str(cfg["churn"]), "--filter-steps", str(MAIN["steps"]),
            "--device", DEVICE]
    swaps = []

    def on_round(rnd, engine, rec, x, y):
        seen = launcher.entry_launch_counts()
        cache = launcher.stream_cache_counts()
        for entry in ("batched_sym_operator_apply",
                      "batched_butterfly_apply"):
            check(seen[entry] > 0, f"[main-dynamic] round {rnd}: "
                  f"{entry} never launched")
        swaps.append({**rec, "stream_cache": cache,
                      **check_swap(f"main-dynamic round {rnd}", engine, x,
                                   y, errs, rec["action"] in ("extend",
                                                              "refit"))})
        log(f"[main-dynamic] round {rnd}: {rec['action']}, stream cache "
            f"{cache} (since the previous round's checks)")
        launcher.reset_stream_cache_counts()

    launcher.reset_stream_cache_counts()
    t0 = time.perf_counter()
    out = driven(lambda: serve.serve_fgft_dynamic(serve.parse_args(argv),
                                                  on_round=on_round))
    wall_a = time.perf_counter() - t0
    engine, stream = out["engine"], out["stream"]
    log(f"[main-dynamic] serve {' '.join(argv)}: {wall_a:.1f}s (fit "
        f"{out['fit_s']:.1f}s); actions {out['actions']}; launches "
        f"{dict(counts)}")
    check(engine.basis.fwd.idx_i.shape[-1] == cfg["n"] // 2,
          "pinned G tables are not n/2 wide")
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    x = torch.randn((cfg["graphs"], cfg["signals"], cfg["n"]),
                    generator=gen, device=DEVICE)
    # the probe and the refresh on the full-width pinned tables
    from repro_torch.dynamic import lemma1_refresh
    probe = {"ms": time_ms(engine.drift, reps=5, rounds=3),
             "device_ms": device_total_ms(engine.drift,
                                          "g_operator_kernel"),
             "kernel_device_ms": device_ms(engine.drift,
                                           "g_operator_kernel")}
    refresh = {"ms": time_ms(lambda: lemma1_refresh(engine.basis,
                                                    engine._laps),
                             reps=5, rounds=3),
               "device_ms": device_total_ms(
                   lambda: lemma1_refresh(engine.basis, engine._laps),
                   "g_chain_kernel"),
               "kernel_device_ms": device_ms(
                   lambda: lemma1_refresh(engine.basis, engine._laps),
                   "g_chain_kernel")}
    step = {"ms": time_ms(lambda: engine.step(x, lowpass)),
            "device_ms": device_ms(lambda: engine.step(x, lowpass),
                                   "g_operator_kernel")}
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
    log(f"[main-dynamic] drift probe (R = 8, B = {cfg['graphs']}): "
        f"{probe['ms']:.4f} ms a call, device {fmt(probe['device_ms'])} ms "
        f"(operator kernel {fmt(probe['kernel_device_ms'])}); Lemma-1 "
        f"refresh: {refresh['ms']:.4f} ms, device "
        f"{fmt(refresh['device_ms'])} ms (chain kernel "
        f"{fmt(refresh['kernel_device_ms'])}); full-tier step "
        f"{step['ms']:.4f} ms, device {fmt(step['device_ms'])} ms on "
        f"{table_shape(engine.basis)}")

    # b. REFRESH then EXTEND, forced at full width
    taken = {a for a in out["actions"]}
    forced = []
    driven(lambda: update_round(engine, stream, cfg["forced_churn"], 7000))
    forced.append(driven(lambda: forced_tick(
        "main-dynamic forced", engine, "refresh", refresh=0.5, extend=4.0,
        refit=8.0)))
    driven(lambda: update_round(engine, stream, cfg["churn"], 8000))
    g_before = engine.basis.num_transforms
    forced.append(driven(lambda: forced_tick(
        "main-dynamic forced", engine, "extend", refresh=0.25, extend=0.5,
        refit=8.0)))
    check(engine.basis.num_transforms
          == g_before + round(0.125 * cfg["transforms"]),
          f"EXTEND grew the chain from {g_before} to "
          f"{engine.basis.num_transforms}")
    y = driven(lambda: engine.step(x, lowpass))
    swaps.append(check_swap("main-dynamic extended", engine, x, y, errs,
                            True))
    bank_engine = serve.FGFTServeEngine(
        engine._laps, basis=engine.basis, filters=MAIN["filters"],
        tiers={"full": 1.0}, device=DEVICE)
    driven(lambda: bank_engine.step_bank(x))
    hold_pinned("main-dynamic pinned", engine, bank_engine, x, errs)
    taken |= {"refresh", "extend"}

    # c. REFIT on a small fleet: the chain returns to g0
    small = cfg["small"]
    sstream = GraphStream([community_graph(small["n"], seed=100 + s)
                           for s in range(small["graphs"])])
    g0 = int(2 * small["n"] * np.log2(small["n"]))
    seng = driven(lambda: serve.FGFTServeEngine(
        np.stack(sstream.laplacians()), g0, dynamic=True,
        policy=RefitPolicy(max_extends=1), device=DEVICE))
    driven(lambda: update_round(seng, sstream, 0.05, 9000))
    refit_ticks = [driven(lambda: forced_tick(
        "main-dynamic small", seng, "extend", refresh=0.25, extend=0.5,
        refit=8.0))]
    check(seng.basis.num_transforms > g0, "small fleet did not extend")
    driven(lambda: update_round(seng, sstream, 0.05, 9100))
    refit_ticks.append(driven(lambda: forced_tick(
        "main-dynamic small", seng, "refit", refresh=0.25, extend=0.5,
        refit=8.0)))
    check(seng.basis.num_transforms == g0,
          f"REFIT chain has {seng.basis.num_transforms} != g0 = {g0}")
    check(seng.controller.extends_since_refit == 0,
          "extends_since_refit is not 0 after the REFIT")
    xs = torch.randn((small["graphs"], 32, small["n"]), generator=gen,
                     device=DEVICE)
    swaps.append(check_swap("main-dynamic small refit", seng, xs,
                            driven(lambda: seng.step(xs, lowpass)), errs,
                            True))

    # d. directed: the [main-directed] basis, no new fit
    dbasis = main_dir["out"]["engine"].basis
    dstream = GraphStream([directed_variant(community_graph(cfg["n"],
                                                            seed=s), seed=s)
                           for s in range(cfg["graphs"])], directed=True)
    check(np.array_equal(np.stack(dstream.laplacians()),
                         main_dir["out"]["laps"]),
          "directed stream differs from [main-directed]'s Laplacians")
    deng = driven(lambda: serve.FGFTServeEngine(
        main_dir["out"]["laps"], basis=dbasis, dynamic=True,
        policy=RefitPolicy(extend_fraction=cfg["directed_extend_fraction"]),
        device=DEVICE))
    check(deng.basis.fwd.idx_i.shape[-1] == cfg["n"],
          "pinned T tables are not n wide")
    driven(lambda: update_round(deng, dstream, cfg["churn"], 9500,
                                directed=True))
    directed_tick = driven(lambda: forced_tick(
        "main-dynamic directed", deng, "extend", refresh=0.5, extend=4.0,
        refit=8.0))
    xd = main_dir["out"]["signals"]
    for tier in deng.tiers:
        got = driven(lambda: deng.step(xd, lowpass, tier=tier))
        with uncounted():
            live = deng._live
            want = ApplyPlan(family="general", mode="operator", n=cfg["n"],
                             batched=True, backend="torch", device=DEVICE,
                             num_stages=(None if tier == deng.default_tier
                                         else live.tiers[tier]["num_stages"])
                             ).program()(live.fwd, live.bwd, lowpass(
                                 live.tiers[tier]["spectrum"]), xd)
        check(torch.equal(got, want), f"directed dynamic tier {tier} != "
              f"its plain version (want bitwise)")
    log(f"[main-dynamic directed] every tier bitwise equal to its plain "
        f"version on {table_shape(deng.basis)}")

    # e. [main-ragged]'s saved router, loaded dynamic
    ckpt = ROOT / "build" / "ragged_checkpoint"
    t0 = time.perf_counter()
    router = driven(lambda: serve.RaggedFGFTServeEngine.load(
        ckpt, dynamic=True, policy=RefitPolicy(
            refresh=1e-9, extend=10.0, refit=20.0, num_probes=64),
        device=DEVICE))
    load_s = time.perf_counter() - t0
    sizes = router.sizes
    rstream = GraphStream([community_graph(n, seed=s)
                           for s, n in enumerate(sizes)])
    moved = sorted({router.widths[0], router.widths[3]})
    check(len(moved) == 2 and len(router.engines) == 3,
          f"ragged buckets {sorted(router.engines)}")
    before = router.versions.copy()
    driven(lambda: update_round(router, rstream, cfg["forced_churn"], 9900,
                                graphs=[0, 3]))
    res = driven(lambda: router.maintain(dirty_only=True))
    after = router.versions
    check(sorted(res) == moved, f"dirty_only ticked buckets {sorted(res)}")
    check(all(r["action"] == "refresh" for r in res.values()),
          f"updated buckets took {[r['action'] for r in res.values()]}")
    for pos, w in enumerate(router.widths):
        want_bump = pos in (0, 3)
        check((after[pos] > before[pos]) == want_bump,
              f"graph {pos} (bucket {w}): version {before[pos]} -> "
              f"{after[pos]}")
    blocks = ragged_blocks(router, 43, 64)
    signals = [torch.randn((64, n), generator=gen, device=DEVICE)
               for n in sizes]
    driven(lambda: router.step(signals, lowpass))
    with uncounted():
        for w, eng in sorted(router.engines.items()):
            p = eng.basis.project(blocks[w], h=lambda lam: torch.exp(-lam))
            for row, pos in enumerate(router.bucket_of[w]):
                check(bool((p[row, :, sizes[pos]:] == 0).all()),
                      f"bucket {w}: project pads of graph {pos} are not 0")
    with uncounted():
        ragged_served = check_ragged_served("main-dynamic ragged", router,
                                            signals, TOL)
    log(f"[main-dynamic ragged] router loaded dynamic in {load_s:.2f}s; "
        f"buckets {moved} acted ({ {w: r['action'] for w, r in res.items()} }"
        f"), versions moved only there; pads 0 from project")

    path = ("batched_sym_operator_apply", "batched_butterfly_apply",
            "batched_gen_operator_apply", "batched_sym_filter_bank_apply")
    for entry in path:
        check(counts[entry] > 0, f"dynamic path never launched {entry}")
    check({"refresh", "extend"} <= taken, f"actions taken {taken}")
    phase_s = time.perf_counter() - t_phase
    log(f"[main-dynamic] {phase_s:.1f}s in all; launches {dict(counts)}")
    return {"out": out, "launches": dict(counts), "swaps": swaps,
            "forced": forced, "refit": refit_ticks,
            "directed": directed_tick, "probe": probe, "refresh": refresh,
            "step": step, "ragged_load_s": load_s,
            "ragged_served_err": ragged_served, "phase_s": phase_s,
            "fit_s": out["fit_s"], "wall_a_s": wall_a}


def rel_dev(got, want) -> float:
    """||got - want|| / ||want|| over the whole block."""
    import torch
    return float(torch.linalg.norm((got - want).double())
                 / torch.linalg.norm(want.double()).clamp(min=1e-30))


def served_rates(engine, x, steps: int) -> dict:
    """graph-transforms/s of every tier and responses/s of the bank of an
    engine (one uncounted warm-up each, then ``steps`` timed steps)."""
    import torch
    out = {}
    calls = {f"tier {t}": (lambda t=t: engine.step(x, lowpass, tier=t))
             for t in engine.tiers}
    if engine.bank is not None:
        calls["bank"] = lambda: engine.step_bank(x)
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        per = x.shape[0] * (len(engine.bank) if name == "bank" else 1)
        out[name] = steps * per / (time.perf_counter() - t0)
    return out


def phase_main_bf16(errs, main, filt, single, main_dir, single_dir) -> dict:
    """[main-bf16]: bf16 table storage end to end, each part driven with
    the counts zeroed just before and read just after (comparisons not
    counted).  a. ``serve --fgft --precision bf16 --filter ...`` at full
    width through the CLI (one G fit): the bank against its plain version
    and each filter against dense eigh within its bound.  b. engines at
    ``precision="bf16"`` on [main]'s and [main-directed]'s bases (no
    fit): every tier and the bank against the plain versions, the full
    tier against the f32 engine (relative deviation < 0.03), rates beside
    the f32 ones, and an ``apply`` round trip at bf16.  c. [main-ragged]'s
    saved router loaded at bf16: pads bitwise through ``apply``, 0 from
    ``project``, served buckets against plain.  d. a dynamic engine at
    bf16 on [main]'s basis with one forced REFRESH: every step after the
    swap hits the entry-stream cache.  e. the single-graph paths at bf16
    (analysis, synthesis, project, bank).  Every bf16 form must have
    launched."""
    from collections import Counter
    import numpy as np
    import torch
    from repro_torch.core.staging import table_arrays
    from repro_torch.dynamic import GraphStream, RefitPolicy
    from repro_torch.graphs import community_graph
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    counts: Counter = Counter()

    def driven(fn):
        launcher.reset_launch_counts()
        out = fn()
        sync()
        counts.update(launcher.entry_launch_counts())
        return out

    def plain(kind, mode, n, **kw):
        return ApplyPlan(family=kind, mode=mode, n=n, batched=True,
                         backend="torch", precision="bf16", device=DEVICE,
                         **kw).program()

    # a. the CLI at full width
    argv = ["--fgft", "--precision", "bf16", "--filter", MAIN["filters"],
            "--graphs", str(MAIN["graphs"]), "--graph-n", str(MAIN["n"]),
            "--transforms", str(int(2 * MAIN["n"] * np.log2(MAIN["n"]))),
            "--signals", str(MAIN["signals"]), "--filter-steps",
            str(MAIN["steps"]), "--device", DEVICE]
    t0 = time.perf_counter()
    out = driven(lambda: serve.main(argv))
    wall = time.perf_counter() - t0
    engine, x = out["engine"], out["signals"]
    live = engine._live
    log(f"[main-bf16] serve {' '.join(argv)}: {wall:.1f}s (fit "
        f"{out['fit_s']:.1f}s), {out['responses_per_s']:.1f} responses/s "
        f"(f32 [main-filter]: {filt['out']['responses_per_s']:.1f}); "
        f"launches { {k: v for k, v in counts.items() if v} }")
    check(engine._precision == "bf16"
          and all(t.dtype == torch.bfloat16 for t in live.fwd[2:]),
          "the bf16 CLI engine does not serve bf16 tables")
    check(counts["batched_sym_filter_bank_apply_bf16"] > 0
          and counts["batched_sym_filter_bank_apply"] == 0,
          "the bf16 CLI did not serve through the bf16 bank form")
    with uncounted():
        y = engine.step_bank(x)
        err, scale = max_err(y, plain("sym", "bank", engine.basis.n)(
            live.fwd, live.bwd, live.bank_gains, x))
        check(err <= TOL * scale, f"[main-bf16] bank vs plain max|dy| "
              f"{err:.3e}")
        errs["batched_sym_filter_bank_apply_bf16"] = max(
            errs.get("batched_sym_filter_bank_apply_bf16", 0.0), err)
        log(f"[main-bf16] served bank {list(y.shape)} vs plain version: "
            f"max|dy| {err:.3e} (scale {scale:.3e})")
        cli_worst = check_filters_dense("main-bf16", engine, y, x,
                                        out["laps"], out["rel_error"])

    # b. engines at bf16 on the f32 paths' bases, no fit
    engines = {}
    for tag, rec, f32_bank in (
            ("main", main, filt["out"]["responses_per_s"]),
            ("main-directed", main_dir, main_dir["bank"]["responses_per_s"])):
        f32_eng, laps, xs = (rec["out"]["engine"], rec["out"]["laps"],
                             rec["out"]["signals"])
        basis = f32_eng.basis
        eng = driven(lambda: serve.FGFTServeEngine(
            laps, basis=basis, tiers=serve.parse_tiers(MAIN["tiers"]),
            filters=MAIN["filters"], precision="bf16", device=DEVICE))
        rates = driven(lambda: served_rates(eng, xs, MAIN["steps"]))
        yr = driven(lambda: basis.apply(basis.apply(
            xs, inverse=True, precision="bf16"), precision="bf16"))
        with uncounted():
            kind, n, lv = basis.kind, basis.n, eng._live
            tol = TOL if kind == "sym" else 0.0
            for tier in eng.tiers:
                k = lv.tiers[tier]["num_stages"]
                want = plain(kind, "operator", n, num_stages=(
                    None if tier == eng.default_tier else k))(
                        lv.fwd, lv.bwd, lowpass(lv.tiers[tier]["spectrum"]),
                        xs)
                err, scale = max_err(eng.step(xs, lowpass, tier=tier), want)
                check(err <= tol * scale, f"[main-bf16 {tag}] tier {tier} vs "
                      f"plain max|dy| {err:.3e}")
                entry = launcher.form(
                    "batched_sym_operator_apply" if kind == "sym"
                    else "batched_gen_operator_apply", "bf16")
                errs[entry] = max(errs.get(entry, 0.0), err)
            y16 = eng.step(xs, lowpass)
            dev = rel_dev(y16, f32_eng.step(xs, lowpass))
            check(dev < 0.03, f"[main-bf16 {tag}] full tier deviates {dev:.4f}"
                  f" from the f32 engine")
            yb = eng.step_bank(xs)
            err, scale = max_err(yb, plain(kind, "bank", n)(
                lv.fwd, lv.bwd, lv.bank_gains, xs))
            check(err <= tol * scale, f"[main-bf16 {tag}] bank vs plain "
                  f"max|dy| {err:.3e}")
            bank_entry = launcher.form(
                "batched_sym_filter_bank_apply" if kind == "sym"
                else "batched_gen_filter_bank_apply", "bf16")
            errs[bank_entry] = max(errs.get(bank_entry, 0.0), err)
            f32_bank_fn = ApplyPlan(family=kind, mode="bank", n=n,
                                    batched=True, device=DEVICE).program()
            bank_dev = rel_dev(yb, f32_bank_fn(
                table_arrays(basis.fwd), table_arrays(basis.bwd),
                lv.bank_gains, xs))
            check(bank_dev < 0.03, f"[main-bf16 {tag}] bank deviates "
                  f"{bank_dev:.4f} from the f32 bank")
            worst = (check_filters_dense(f"main-bf16 {tag}", eng, yb, xs,
                                         laps, rec["out"]["rel_error"])
                     if kind == "sym" else None)
            chain_entry = launcher.form(
                "batched_butterfly_apply" if kind == "sym"
                else "batched_shear_apply", "bf16")
            inv = basis.apply(xs, inverse=True, precision="bf16")
            err, scale = max_err(inv, basis.apply(
                xs, inverse=True, precision="bf16", backend="torch"))
            check(err <= tol * scale, f"[main-bf16 {tag}] apply vs plain "
                  f"max|dy| {err:.3e}")
            errs[chain_entry] = max(errs.get(chain_entry, 0.0), err)
            trip = rel_dev(yr, xs)
            check(bool(torch.isfinite(yr).all()) and trip < 0.03,
                  f"[main-bf16 {tag}] bf16 round trip deviates {trip:.4f}")
        f32_rates = {f"tier {t}": ts["transforms_per_s"]
                     for t, ts in rec["out"]["tiers"].items()}
        f32_rates["bank"] = f32_bank
        log(f"[main-bf16 {tag}] engine at bf16 on the fitted basis: full "
            f"tier vs the f32 engine relative deviation {dev:.3e}, bank "
            f"{bank_dev:.3e}; every tier and the bank vs plain within "
            f"{tol} * scale; apply round trip at bf16 vs x {trip:.3e}"
            + ("" if worst is None else f"; bank filters' worst error/bound "
               f"vs dense eigh {worst:.4f}"))
        log(f"[main-bf16 {tag}] rates at bf16 (f32): " + ", ".join(
            f"{k} {v:.1f} ({f32_rates[k]:.1f})" for k, v in rates.items())
            + " graph-transforms/s per tier, responses/s for the bank")
        engines[tag] = {"rates": rates, "f32_rates": f32_rates,
                        "full_dev": dev, "bank_dev": bank_dev,
                        "round_trip_dev": trip, "dense_worst": worst}

    # c. [main-ragged]'s saved router at bf16
    ckpt = ROOT / "build" / "ragged_checkpoint"
    router = driven(lambda: serve.RaggedFGFTServeEngine.load(
        ckpt, precision="bf16", device=DEVICE))
    check(all(e._live.fwd[2].dtype == torch.bfloat16
              for e in router.engines.values()),
          "the bf16 router does not serve bf16 tables")
    gen = torch.Generator(device=DEVICE).manual_seed(47)
    rsig = [torch.randn((64, n), generator=gen, device=DEVICE)
            for n in router.sizes]
    driven(lambda: router.step(rsig, lowpass))
    with uncounted():
        ragged_err = check_ragged_served("main-bf16 ragged", router, rsig,
                                         TOL)
        check_ragged_pads("main-bf16 ragged", router,
                          ragged_blocks(router, 53, 130), TOL, "bf16")

    # d. a dynamic engine at bf16, one forced REFRESH
    f32_eng = main["out"]["engine"]
    xs = main["out"]["signals"]
    stream = GraphStream([community_graph(MAIN["n"], seed=s)
                          for s in range(MAIN["graphs"])])
    check(np.array_equal(np.stack(stream.laplacians()), main["out"]["laps"]),
          "the stream differs from [main]'s Laplacians")
    deng = driven(lambda: serve.FGFTServeEngine(
        main["out"]["laps"], basis=f32_eng.basis, dynamic=True,
        tiers=serve.parse_tiers(MAIN["tiers"]), policy=RefitPolicy(),
        precision="bf16", device=DEVICE))
    driven(lambda: [deng.step(xs, lowpass, tier=t) for t in deng.tiers])
    cast = deng._live.fwd
    driven(lambda: update_round(deng, stream, DYNAMIC["forced_churn"], 7700))
    tick = driven(lambda: forced_tick("main-bf16 dynamic", deng, "refresh",
                                      refresh=0.5, extend=4.0, refit=8.0))
    check(deng.basis.fwd.c.dtype == torch.float32,
          "the dynamic engine's basis is not f32")
    check(deng._live.fwd[2] is cast[2], "REFRESH did not keep the bf16 cast")
    launcher.reset_stream_cache_counts()
    driven(lambda: [deng.step(xs, lowpass, tier=t) for t in deng.tiers])
    cache = launcher.stream_cache_counts()
    check(cache["misses"] == 0 and cache["hits"] == 2 * len(deng.tiers),
          f"[main-bf16 dynamic] steps after the REFRESH: stream cache "
          f"{cache}")
    with uncounted():
        lv = deng._live
        err, scale = max_err(deng.step(xs, lowpass), plain(
            "sym", "operator", MAIN["n"])(
                lv.fwd, lv.bwd, lowpass(lv.tiers[deng.default_tier][
                    "spectrum"]), xs))
        check(err <= TOL * scale, f"[main-bf16 dynamic] served full tier vs "
              f"plain max|dy| {err:.3e}")
    log(f"[main-bf16 dynamic] REFRESH on {table_shape(deng.basis)}: the "
        f"bf16 cast kept, steps after the swap hit the stream cache "
        f"{cache}; full tier vs plain max|dy| {err:.3e}")

    # e. the single-graph paths at bf16
    for tag, rec in (("single", single), ("single-directed", single_dir)):
        f, x0, g0 = rec["fgft"], rec["signals"], rec["gains"]
        bank = ApplyPlan(family=f.family, mode="bank", n=f.n,
                         precision="bf16", device=DEVICE)
        ys = driven(lambda: (f.synthesis(f.analysis(x0, precision="bf16"),
                                         precision="bf16"),
                             f.project(x0, lowpass, precision="bf16"),
                             bank.bank(f.fwd, f.bwd, g0, x0)))
        with uncounted():
            tol = TOL if f.family == "sym" else 0.0
            fam = "sym" if f.family == "sym" else "gen"
            wants = (f.synthesis(f.analysis(x0, "torch", precision="bf16"),
                                 "torch", precision="bf16"),
                     f.project(x0, lowpass, "torch", precision="bf16"),
                     ApplyPlan(family=f.family, mode="bank", n=f.n,
                               precision="bf16", backend="torch",
                               device=DEVICE).bank(f.fwd, f.bwd, g0, x0))
            names = ("butterfly_apply" if fam == "sym" else "shear_apply",
                     f"{fam}_operator_apply", f"{fam}_filter_bank_apply")
            for name, got, want in zip(names, ys, wants):
                err, scale = max_err(got, want)
                name = launcher.form(name, "bf16")
                check(err <= tol * scale, f"[main-bf16 {tag}] {name} vs "
                      f"plain max|dy| {err:.3e}")
                errs[name] = max(errs.get(name, 0.0), err)
        log(f"[main-bf16 {tag}] analysis, synthesis, project and bank at "
            f"bf16 vs plain within {tol} * scale")

    missing = [e for e in launcher.ENTRIES
               if counts[launcher.form(e, "bf16")] == 0]
    check(not missing, f"[main-bf16] bf16 forms never launched: {missing}")
    phase_s = time.perf_counter() - t_phase
    log(f"[main-bf16] {phase_s:.1f}s in all; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return {"launches": dict(counts), "wall_s": wall, "fit_s": out["fit_s"],
            "responses_per_s": out["responses_per_s"],
            "cli_dense_worst": cli_worst, "engines": engines,
            "ragged_served_err": ragged_err, "dynamic_tick": tick,
            "dynamic_cache": cache, "phase_s": phase_s}


#: the async front end of [main-async]: R-row requests from closed-loop
#: tenants through AsyncFGFTService on the tables the earlier phases
#: fitted (no fit at full width); the dynamic part's churn and refresh
#: threshold; the CLI at a small size for the wiring
ASYNC = dict(requests=4096, bank_requests=1024, directed_requests=1024,
             ragged_requests=1024, dynamic_requests=2048, rows=8,
             workers=16, max_queue=128, max_batch=8, churn=0.002,
             maintain_interval=0.05, refresh=0.002,
             cli=["--fgft", "--serve-async", "--dynamic", "--graphs", "8",
                  "--graph-n", "64", "--load-requests", "256",
                  "--load-workers", "4"])


def span_clock():
    """time.monotonic rounded to 2^-20 s: differences and sums of its
    readings are exact in float64, so that a request's spans can be held
    to their shared endpoints with ==."""
    return round(time.monotonic() * 2 ** 20) / 2 ** 20


def async_requests(sizes, count: int, seed: int, tiers=None) -> list:
    """``count`` requests of ASYNC["rows"] rows cycling over the graphs
    (and over ``tiers``; None: bank requests)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        gid = i % len(sizes)
        x = rng.standard_normal((ASYNC["rows"], sizes[gid])).astype(
            np.float32)
        out.append((gid, x, None if tiers is None else tiers[i % len(tiers)],
                    tiers is None))
    return out


def timed_load(svc, requests) -> tuple:
    """(results, requests/s) of one closed-loop load."""
    from repro_torch.launch.service import closed_loop_load
    t0 = time.perf_counter()
    results = closed_loop_load(svc, requests, workers=ASYNC["workers"])
    rate = len(requests) / (time.perf_counter() - t0)
    check(all(r is not None for r in results), "a request got no answer")
    return results, rate


def warm(svc, requests) -> None:
    """Answer one request per (graph, tier) group, then zero the SLO
    counters: first calls are not in the measured load."""
    from repro_torch.launch.service import closed_loop_load
    seen, first = set(), []
    for req in requests:
        if (req[0], req[2]) not in seen:
            seen.add((req[0], req[2]))
            first.append(req)
    closed_loop_load(svc, first, workers=ASYNC["workers"])
    sync()
    svc.reset_stats()


def hold_answers(tag, routes, requests, results, h, family: str) -> dict:
    """Every answer against ``step_versioned`` (``step_bank_versioned``)
    of its engine on that request's rows alone, zero-padded as the
    service pads them, at the same tier and version; uncounted.  Returns
    the largest max|dy| and whether every answer was bitwise equal."""
    import torch
    from repro_torch.launch.service import quantize_rows
    worst, scale = [], 1.0
    with uncounted():
        for (gid, x, tier, bank), res in zip(requests, results):
            route = routes[gid]
            eng = route.engine
            b, n = int(eng.basis.spectrum.shape[0]), eng.basis.n
            r, size = x.shape
            block = torch.zeros((b, quantize_rows(r), n), device=DEVICE)
            block[route.row, :r, :size] = torch.from_numpy(x).to(DEVICE)
            if bank:
                y, v = eng.step_bank_versioned(block)
                want = y[route.row, :, :r, :size]
            else:
                y, v = eng.step_versioned(block, h, tier=tier)
                want = y[route.row, :r, :size]
            check(v == res.version, f"[{tag}] graph {gid}: answered by "
                  f"version {res.version}, reference at {v}")
            got = torch.from_numpy(res.y).to(DEVICE)
            check(got.shape == want.shape, f"[{tag}] graph {gid}: answer "
                  f"{tuple(got.shape)} != {tuple(want.shape)}")
            worst.append((got - want).abs().max())
            scale = max(scale, float(want.abs().max()))
        err = float(torch.stack(worst).max())
    tol = 0.0 if family == "general" else TOL
    check(err <= tol * scale, f"[{tag}] answers vs step_versioned on the "
          f"request alone: max|dy| {err:.3e} > {tol} * {scale:.3e}")
    return {"max_abs_err": err, "bitwise": err == 0.0, "scale": scale}


def check_spans(tag, results) -> None:
    """Each request's queue, batch and execute spans share their
    endpoints with the next one and with the request span, exactly."""
    from repro_torch import obs
    by_id: dict = {}
    for s in obs.default_tracer().spans(cat="serve"):
        if s["trace_id"] is not None:
            by_id.setdefault(s["trace_id"], {})[s["name"]] = s
    for res in results:
        sp = by_id.get(res.trace_id, {})
        check(len(sp) == 4, f"[{tag}] request {res.trace_id}: spans "
              f"{sorted(sp)}")
        q, bt, ex, tot = (sp["request/queue"], sp["request/batch"],
                          sp["request/execute"], sp["request"])
        check(q["ts"] == tot["ts"] and q["ts"] + q["dur"] == bt["ts"]
              and bt["ts"] + bt["dur"] == ex["ts"]
              and ex["ts"] + ex["dur"] == tot["ts"] + tot["dur"]
              and q["dur"] + bt["dur"] + ex["dur"] == tot["dur"]
              == res.total_s and ex["dur"] == res.service_s,
              f"[{tag}] request {res.trace_id}: spans do not share their "
              f"endpoints: {q}, {bt}, {ex}, {tot}")


def slo_text(stats) -> str:
    """p50/p99 of queue, service and total per tier, in ms."""
    lat = stats["latency"]
    tiers = sorted({k.split("/")[0] for k in lat})
    return "; ".join(
        f"{t}: " + ", ".join(
            f"{stage} p50 {lat[f'{t}/{stage}']['p50_s'] * 1e3:.3f} / p99 "
            f"{lat[f'{t}/{stage}']['p99_s'] * 1e3:.3f} ms"
            for stage in ("queue", "service", "total")) for t in tiers)


def one_launch_per_dispatch(tag, counts, stats, entry) -> None:
    check(counts[entry] == stats["dispatches"] > 0
          and sum(counts.values()) == counts[entry],
          f"[{tag}] {stats['dispatches']} fused dispatches but launches "
          f"{ {k: v for k, v in counts.items() if v} }")


def kernel_streams(prof) -> dict:
    """kernel name -> the CUDA streams its launches ran on, from the
    profiler's Chrome trace."""
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json", dir=ROOT / "build")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    out: dict = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            stream = ev.get("args", {}).get("stream", ev.get("tid"))
            out.setdefault(ev["name"], set()).add(stream)
    return out


def traced_streams(fn, want: tuple, traces: int = 3, before=None) -> dict:
    """``kernel_streams`` of a profiled call of fn, from the first of up
    to ``traces`` traces that holds a launch of a kernel named in
    ``want`` (a trace now and then drops events); ``before(attempt)``
    runs ahead of each, outside the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for attempt in range(traces):
        if before is not None:
            before(attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        streams = kernel_streams(prof)
        if any(w in k for k in streams for w in want):
            return streams
        seen.append({k[:60]: sorted(v) for k, v in streams.items()})
    raise SmokeFailure(f"no trace of {traces} holds a launch of {want}; "
                       f"kernels and streams per trace: {seen}")


def maintenance_streams(ckpt) -> dict:
    """Child of [main-async] d, in a fresh process: a dynamic engine on the
    [main] basis saved in ``ckpt`` (and its Laplacians, ``laps.npy``)
    behind a service whose maintainer ticks only when asked; the CUDA
    streams of 32 served requests, then of one REFRESH tick, each from a
    torch.profiler trace (``traced_streams``).  The tick runs after a
    quiet tick and one round of updates at DYNAMIC["forced_churn"].
    Launches here are in no count of the parent's."""
    from dataclasses import replace
    import numpy as np
    from repro_torch.core import ApproxEigenbasis
    from repro_torch.dynamic import GraphStream, RefitPolicy
    from repro_torch.graphs import community_graph
    from repro_torch.kernels import build, launcher
    from repro_torch.launch import serve
    from repro_torch.launch.service import AsyncFGFTService
    build.library()
    ckpt = pathlib.Path(ckpt)
    basis = ApproxEigenbasis.load(ckpt, device=DEVICE)
    graphs = int(basis.spectrum.shape[0])
    stream = GraphStream([community_graph(basis.n, seed=s)
                          for s in range(graphs)])
    laps = np.stack(stream.laplacians())
    check(np.array_equal(laps, np.load(ckpt / "laps.npy")),
          "[main-async streams] the stream differs from [main]'s Laplacians")
    policy = RefitPolicy(refresh=ASYNC["refresh"], extend=1e9, refit=1e9,
                         hysteresis=1.0, max_extends=1000)
    tiers = serve.parse_tiers(MAIN["tiers"])
    dyn = serve.FGFTServeEngine(laps, basis=basis, tiers=tiers,
                                dynamic=True, policy=policy, device=DEVICE)
    x_one = [(g, x, "full", False) for g, x, _, _ in
             async_requests([basis.n] * graphs, 32, 65, sorted(tiers))]
    attempts, launched = [], {}

    def refresh_ready(attempt):
        # a quiet tick (every threshold out of reach) clears a hysteresis
        # floor an earlier tick left armed; then one round of updates
        attempts.append(attempt)
        dyn.controller.policy = replace(policy, refresh=1e9)
        svc.maintain_now(timeout=120)
        dyn.controller.policy = policy
        update_round(dyn, stream, DYNAMIC["forced_churn"],
                     90000 + 1000 * attempt)
        sync()

    def refresh_tick():
        launcher.reset_launch_counts()
        check(svc.maintain_now(timeout=120)["action"] == "refresh",
              "[main-async streams] the profiled tick was not a REFRESH")
        launched.clear()
        launched.update({k: v for k, v in
                         launcher.entry_launch_counts().items() if v})

    with AsyncFGFTService(dyn, h=lowpass, name="smoke-streams",
                          max_queue=ASYNC["max_queue"],
                          max_batch=ASYNC["max_batch"]) as svc:
        warm(svc, x_one)
        serving = traced_streams(lambda: timed_load(svc, x_one),
                                 ("g_operator_kernel",))
        maintenance = traced_streams(
            refresh_tick, ("g_chain_kernel", "g_operator_kernel"),
            traces=6, before=refresh_ready)
    return {"serving": {k: sorted(v) for k, v in serving.items()},
            "maintenance": {k: sorted(v) for k, v in maintenance.items()},
            "launched": launched, "attempt": len(attempts)}


def phase_main_async(errs, main, main_dir) -> dict:
    """[main-async]: the async front end (launch/service.py) on the tables
    the earlier phases fitted, each part driven with the counts zeroed
    just before and read just after (comparisons not counted).  a. the
    [main] basis with its tiers and the F = 7 bank behind
    ``AsyncFGFTService(max_queue=128, max_batch=8)``: 4096 tier requests
    and 1024 bank requests of R = 8 rows from 16 closed-loop tenants,
    every answer against ``step_versioned`` on the request alone, one
    kernel launch per fused dispatch, compile spans equal to plan-cache
    misses, each request's spans sharing their endpoints exactly; the
    same tier load untraced (``obs.configure(enabled=False)``) for the
    traced/untraced ratio.  b. the [main-directed] basis, 1024 requests
    bitwise.  c. [main-ragged]'s saved router, 1024 requests over its
    three buckets, pads 0 in every bucket output.  d. a dynamic engine on
    the [main] basis under a churn thread, 2048 requests while the
    maintainer ticks on its own CUDA stream: swaps, non-decreasing
    versions, no failed request, the final full tier against plain, a
    profiled tick's kernels on another stream than the serving launches
    (``maintenance_streams``, in a child process), p99 while a tick runs
    against idle.  e. ``serve --fgft --serve-async
    --dynamic --trace T --metrics-dir M`` at a small size."""
    from collections import Counter
    import shutil
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.dynamic import GraphStream, RefitPolicy
    from repro_torch.dynamic.refit import Action
    from repro_torch.graphs import community_graph
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import (ApplyPlan, clear_plan_cache,
                                          plan_cache_stats)
    from repro_torch.launch import serve
    from repro_torch.launch.service import AsyncFGFTService
    t_phase = time.perf_counter()
    counts: Counter = Counter()
    tracer = obs.default_tracer()
    tiers = sorted(serve.parse_tiers(MAIN["tiers"]))
    svc_args = dict(max_queue=ASYNC["max_queue"],
                    max_batch=ASYNC["max_batch"], clock=span_clock)

    def driven(fn):
        launcher.reset_launch_counts()
        out = fn()
        sync()
        seen = launcher.entry_launch_counts()
        counts.update(seen)
        return out, seen

    # a. static, undirected, full width: compile spans count from a
    # cleared plan cache, so the engine is built after the clear
    clear_plan_cache()
    tracer.clear()
    m_out = main["out"]
    engine = serve.FGFTServeEngine(
        m_out["laps"], basis=m_out["engine"].basis,
        tiers=serve.parse_tiers(MAIN["tiers"]), filters=MAIN["filters"],
        device=DEVICE)
    sizes = [engine.basis.n] * int(engine.basis.spectrum.shape[0])
    reqs = async_requests(sizes, ASYNC["requests"], 61, tiers)
    bank_reqs = async_requests(sizes, ASYNC["bank_requests"], 62)
    with AsyncFGFTService(engine, h=lowpass, name="smoke-static",
                          **svc_args) as svc:
        warm(svc, reqs)
        (results, rate), seen = driven(lambda: timed_load(svc, reqs))
        stats = svc.stats()
        one_launch_per_dispatch("main-async", seen, stats,
                                "batched_sym_operator_apply")
        check(stats["served"] == len(reqs) and stats["errors"] == 0,
              f"[main-async] served {stats['served']}, errors "
              f"{stats['errors']}")
        check_spans("main-async", results)
        obs.configure(enabled=False)
        try:
            svc.reset_stats()
            _, rate_off = timed_load(svc, reqs)
        finally:
            obs.configure(enabled=True)
        warm(svc, bank_reqs)
        (bank_results, bank_rate), bank_seen = driven(
            lambda: timed_load(svc, bank_reqs))
        bank_stats = svc.stats()
        one_launch_per_dispatch("main-async bank", bank_seen, bank_stats,
                                "batched_sym_filter_bank_apply")
        check_spans("main-async bank", bank_results)
    compiles = len(tracer.spans(cat="compile"))
    misses = plan_cache_stats()["misses"]
    check(compiles == misses > 0, f"[main-async] {compiles} compile spans, "
          f"{misses} plan-cache misses")
    routes = svc._routes
    held = hold_answers("main-async", routes, reqs, results, lowpass, "sym")
    bank_held = hold_answers("main-async bank", routes, bank_reqs,
                             bank_results, None, "sym")
    errs["batched_sym_operator_apply"] = max(
        errs["batched_sym_operator_apply"], held["max_abs_err"])
    errs["batched_sym_filter_bank_apply"] = max(
        errs["batched_sym_filter_bank_apply"], bank_held["max_abs_err"])
    log(f"[main-async] {len(reqs)} tier requests (R = {ASYNC['rows']}, "
        f"{ASYNC['workers']} tenants, max_batch {ASYNC['max_batch']}): "
        f"{rate:.1f} requests/s traced, {rate_off:.1f} untraced (traced/"
        f"untraced {rate / rate_off:.4f}); {stats['dispatches']} fused "
        f"dispatches = {seen['batched_sym_operator_apply']} operator "
        f"launches, mean occupancy {stats['batch']['occupancy_mean']:.3f}"
        f" (max {stats['batch']['occupancy_max']}), queue peak "
        f"{stats['queue']['peak']}; {slo_text(stats)}")
    log(f"[main-async] {len(bank_reqs)} bank requests (F = "
        f"{len(engine.bank)}): {bank_rate:.1f} requests/s, "
        f"{bank_stats['dispatches']} dispatches = "
        f"{bank_seen['batched_sym_filter_bank_apply']} bank launches, mean "
        f"occupancy {bank_stats['batch']['occupancy_mean']:.3f}; "
        f"{slo_text(bank_stats)}")
    log(f"[main-async] answers vs step_versioned on the request alone: "
        f"tiers max|dy| {held['max_abs_err']:.3e} (bitwise "
        f"{held['bitwise']}), bank {bank_held['max_abs_err']:.3e} (bitwise "
        f"{bank_held['bitwise']}); compile spans {compiles} = plan-cache "
        f"misses {misses}; every request's spans share their endpoints")

    # b. directed: the [main-directed] basis, held bitwise
    d_out = main_dir["out"]
    d_engine = serve.FGFTServeEngine(
        d_out["laps"], basis=d_out["engine"].basis,
        tiers=serve.parse_tiers(MAIN["tiers"]), device=DEVICE)
    d_reqs = async_requests(sizes, ASYNC["directed_requests"], 63, tiers)
    with AsyncFGFTService(d_engine, h=lowpass, name="smoke-directed",
                          **svc_args) as svc:
        warm(svc, d_reqs)
        (d_results, d_rate), d_seen = driven(lambda: timed_load(svc,
                                                                d_reqs))
        d_stats = svc.stats()
        one_launch_per_dispatch("main-async directed", d_seen, d_stats,
                                "batched_gen_operator_apply")
    d_held = hold_answers("main-async directed", svc._routes, d_reqs,
                          d_results, lowpass, "general")
    log(f"[main-async directed] {len(d_reqs)} requests: {d_rate:.1f} "
        f"requests/s, {d_stats['dispatches']} dispatches, every answer "
        f"bitwise equal to step_versioned on the request alone; "
        f"{slo_text(d_stats)}")

    # c. ragged: [main-ragged]'s saved router, loaded (no fit)
    router = serve.RaggedFGFTServeEngine.load(
        ROOT / "build" / "ragged_checkpoint", device=DEVICE)
    outputs = []
    for w, eng in router.engines.items():
        def keep(live, x, h, tier, _step=eng._step_on, _eng=eng):
            y = _step(live, x, h, tier)
            outputs.append((_eng, y))
            return y
        eng._step_on = keep
    r_reqs = async_requests(router.sizes, ASYNC["ragged_requests"], 64,
                            tiers)
    with AsyncFGFTService(router, h=lowpass, name="smoke-ragged",
                          **svc_args) as svc:
        warm(svc, r_reqs)
        outputs.clear()
        (r_results, r_rate), r_seen = driven(lambda: timed_load(svc,
                                                                r_reqs))
        r_stats = svc.stats()
        one_launch_per_dispatch("main-async ragged", r_seen, r_stats,
                                "batched_sym_operator_apply")
    for eng in router.engines.values():
        del eng._step_on
    with uncounted():
        for eng, y in outputs:
            if eng.basis.sizes is None:         # a bucket without pads
                continue
            pad = (torch.arange(eng.basis.n, device=DEVICE)
                   >= torch.as_tensor(eng.basis.sizes,
                                      device=DEVICE)[:, None])
            check(bool((y.masked_select(pad[:, None, :]) == 0).all()),
                  "[main-async ragged] a bucket output has nonzero pads")
    r_held = hold_answers("main-async ragged", svc._routes, r_reqs,
                          r_results, lowpass, "sym")
    log(f"[main-async ragged] {len(r_reqs)} requests over buckets "
        f"{sorted(router.engines)}: {r_rate:.1f} requests/s, "
        f"{r_stats['dispatches']} dispatches ({len(outputs)} bucket "
        f"outputs, pads 0 in each); answers vs step_versioned max|dy| "
        f"{r_held['max_abs_err']:.3e} (bitwise {r_held['bitwise']}); "
        f"{slo_text(r_stats)}")

    # d. dynamic: churn and maintenance on the maintainer's own stream
    policy = RefitPolicy(refresh=ASYNC["refresh"], extend=1e9, refit=1e9,
                         hysteresis=1.0, max_extends=1000)
    dyn = serve.FGFTServeEngine(
        m_out["laps"], basis=m_out["engine"].basis,
        tiers=serve.parse_tiers(MAIN["tiers"]), dynamic=True, policy=policy,
        device=DEVICE)
    stream = GraphStream([community_graph(MAIN["n"], seed=s)
                          for s in range(len(sizes))])
    check(np.array_equal(np.stack(stream.laplacians()), m_out["laps"]),
          "[main-async dynamic] the stream differs from [main]'s Laplacians")
    ticks = []
    real_maintain, real_execute = dyn.maintain, dyn._execute
    churn_stop = threading.Event()

    def timed_maintain():
        t0 = span_clock()
        res = real_maintain()
        ticks.append((t0, span_clock(), res["action"]))
        return res

    def one_extend(action, laps):
        # at most one full-width EXTEND (~5 s) in the phase: the churn
        # stops when the first starts
        if action is Action.EXTEND:
            churn_stop.set()
        return real_execute(action, laps)

    dyn.maintain, dyn._execute = timed_maintain, one_extend
    churn_errors = []

    def churn(svc):
        try:
            rnd = 0
            while not churn_stop.is_set():
                update_round(dyn, stream, ASYNC["churn"],
                             20000 + 1000 * rnd)
                svc.request_maintain()
                rnd += 1
                churn_stop.wait(ASYNC["maintain_interval"])
        except Exception as exc:  # noqa: BLE001 — re-raised after join
            churn_errors.append(exc)

    y_reqs = async_requests(sizes, ASYNC["dynamic_requests"], 65, tiers)
    try:
        with AsyncFGFTService(dyn, h=lowpass, name="smoke-dynamic",
                              maintain_interval=ASYNC["maintain_interval"],
                              **svc_args) as svc:
            warm(svc, y_reqs)
            churner = threading.Thread(target=churn, args=(svc,),
                                       name="smoke-churn")
            launcher.reset_launch_counts()
            churner.start()
            try:
                y_results, y_rate = timed_load(svc, y_reqs)
            finally:
                churn_stop.set()
                churner.join(60)
            check(not churner.is_alive() and not churn_errors,
                  f"[main-async dynamic] churn failed: {churn_errors}")
            y_stats = svc.stats()
            svc.maintain_now(timeout=120)       # absorb the last updates
            sync()
            counts.update(launcher.entry_launch_counts())
    finally:
        dyn.maintain, dyn._execute = real_maintain, real_execute
    acted = Counter(a for _, _, a in ticks)
    check(y_stats["errors"] == 0 and y_stats["maintain"]["errors"] == 0
          and y_stats["maintain"]["swaps"] >= 1 and acted["extend"] <= 1,
          f"[main-async dynamic] stats {y_stats['maintain']}, errors "
          f"{y_stats['errors']}, ticks {dict(acted)}")
    ids = {r.trace_id for r in y_results}
    order = sorted((s["ts"] + s["dur"], s["args"]["version"])
                   for s in tracer.spans(name="request")
                   if s["trace_id"] in ids)
    versions = [v for _, v in order]
    check(len(versions) == len(y_results) and versions == sorted(versions),
          "[main-async dynamic] versions decrease in dispatch order")
    # streams: in a process of its own on the same [main] tables
    # (maintenance_streams); this process's profiler lost a tick's kernels
    # after the earlier phases' hundreds of traces
    ckpt = ROOT / "build" / "async_streams"
    shutil.rmtree(ckpt, ignore_errors=True)
    m_out["engine"].basis.save(ckpt)
    np.save(ckpt / "laps.npy", m_out["laps"])
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"),
         "--maintenance-streams", str(ckpt)],
        capture_output=True, text=True, timeout=300)
    check(child.returncode == 0, f"[main-async dynamic] the stream check "
          f"failed:\n{child.stdout[-2000:]}\n{child.stderr[-4000:]}")
    traced = json.loads(child.stdout.strip().splitlines()[-1])
    serve_streams, maint_streams = traced["serving"], traced["maintenance"]
    serving = set().union(*map(set, serve_streams.values()))
    maint = set().union(*map(set, maint_streams.values()))
    check(maint and not (maint & serving),
          f"[main-async dynamic] maintenance kernels on streams {maint}, "
          f"serving launches on {serving}")
    with uncounted():
        live = dyn._live
        x = torch.from_numpy(np.stack(
            [x for _, x, _, _ in y_reqs[:len(sizes)]])).to(DEVICE)
        plain = ApplyPlan(family="sym", mode="operator", n=dyn.basis.n,
                          batched=True, backend="torch",
                          device=DEVICE).program()
        compare("batched_sym_operator_apply", dyn.step(x, lowpass),
                plain(live.fwd, live.bwd,
                      lowpass(live.tiers["full"]["spectrum"]), x), errs)
    during = {"action": [], "reuse": [], "idle": []}
    spans = {s["trace_id"]: s for s in tracer.spans(name="request")}
    for res in y_results:
        s = spans[res.trace_id]
        t0, t1 = s["ts"], s["ts"] + s["dur"]
        over = {act for a, b, act in ticks if a < t1 and t0 < b}
        key = ("idle" if not over else "reuse" if over == {"reuse"}
               else "action")
        during[key].append(res.total_s)

    def p99(xs):
        if not xs:
            return "none"
        rank = max(int(np.ceil(0.99 * len(xs))), 1)
        return f"{sorted(xs)[rank - 1] * 1e3:.3f} ms ({len(xs)} requests)"

    log(f"[main-async dynamic] {len(y_reqs)} requests under churn "
        f"{ASYNC['churn']}: {y_rate:.1f} requests/s; ticks {dict(acted)}, "
        f"swaps {y_stats['maintain']['swaps']}, versions "
        f"{versions[0]} -> {versions[-1]} non-decreasing in dispatch order, "
        f"no failed request; total p99 while a refresh or extend tick runs "
        f"{p99(during['action'])}, while a reuse tick (drift probe) runs "
        f"{p99(during['reuse'])}, idle {p99(during['idle'])}; "
        f"{slo_text(y_stats)}")
    ours = sorted({name for name in launcher.KERNELS
                   for k in maint_streams if f"{name}(" in k})
    log(f"[main-async dynamic] a profiled REFRESH tick's "
        f"{len(maint_streams)} kernels ({', '.join(ours)} and library "
        f"kernels; the tick's wrappers launched "
        f"{traced['launched']}) on CUDA streams {sorted(maint)}, the serving "
        f"launches on {sorted(serving)} (a process of its own, trace "
        f"{traced['attempt']} of up to 6); final full tier vs plain within "
        f"{TOL} * scale")

    # e. the CLI at a small size
    out_dir = ROOT / "build" / "async_cli"
    shutil.rmtree(out_dir, ignore_errors=True)
    trace_path, metrics_dir = out_dir / "trace.json", out_dir / "metrics"
    argv = ASYNC["cli"] + ["--trace", str(trace_path), "--metrics-dir",
                           str(metrics_dir), "--device", DEVICE]
    cli, _ = driven(lambda: serve.main(argv))
    events = json.loads(trace_path.read_text())["traceEvents"]
    check(any(e["name"] == "request" for e in events),
          "[main-async cli] the trace holds no request span")
    snap = json.loads((metrics_dir / "metrics.json").read_text())
    prom = (metrics_dir / "metrics.prom").read_text()
    for name in ("service_requests_total", "plan_cache_misses_total"):
        check(name in snap and name in prom,
              f"[main-async cli] {name} missing from the metrics files")
    log(f"[main-async cli] serve {' '.join(argv)}: {cli['qps']:.1f} "
        f"requests/s, versions {cli['versions']}; {len(events)} trace "
        f"events, metrics.json/metrics.prom hold service_requests_total "
        f"and plan_cache_misses_total")
    for entry in ("batched_sym_operator_apply",
                  "batched_sym_filter_bank_apply",
                  "batched_gen_operator_apply", "batched_butterfly_apply"):
        check(counts[entry] > 0, f"async path never launched {entry}")
    phase_s = time.perf_counter() - t_phase
    log(f"[main-async] {phase_s:.1f}s in all (budget 90 s); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return {"launches": dict(counts), "rate": rate, "rate_untraced":
            rate_off, "stats": stats, "bank_rate": bank_rate,
            "directed_rate": d_rate, "ragged_rate": r_rate,
            "dynamic_rate": y_rate, "phase_s": phase_s}


#: entry point -> (family, kernel) of the turns phase
TURNS = {"batched_sym_operator_apply": ("sym", "g_operator_kernel"),
         "sym_operator_apply": ("sym", "g_operator_kernel"),
         "batched_gen_operator_apply": ("general", "t_operator_kernel"),
         "gen_operator_apply": ("general", "t_operator_kernel"),
         "batched_butterfly_apply": ("sym", "g_chain_kernel"),
         "butterfly_apply": ("sym", "g_chain_kernel"),
         "batched_shear_apply": ("general", "t_chain_kernel"),
         "shear_apply": ("general", "t_chain_kernel")}


def save_turn_inputs(path, main, single, main_dir, single_dir) -> None:
    """Phase 7's timing inputs of the TURNS entry points, on the host: per
    entry point both table sets, n, the spectrum and the signal (the
    batched G chain's signal is the tier refit's identity block)."""
    import torch
    from repro_torch.core.staging import table_arrays

    def host(staged):
        return [t.cpu() for t in table_arrays(staged)]
    out = {}
    for entry, (family, _) in TURNS.items():
        batched = entry.startswith("batched")
        path_rec = ((main if batched else single) if family == "sym"
                    else (main_dir if batched else single_dir))
        if batched:
            basis = path_rec["out"]["engine"].basis
            x = path_rec["out"]["signals"]
            fwd, bwd, spec = basis.fwd, basis.bwd, basis.spectrum
            if entry == "batched_butterfly_apply":
                x = torch.eye(basis.n).expand(spec.shape[0], basis.n,
                                              basis.n).contiguous()
        else:
            f, x = path_rec["fgft"], path_rec["signals"]
            fwd, bwd, spec = f.fwd, f.bwd, f.spectrum
        out[entry] = {"fwd": host(fwd), "bwd": host(bwd), "n": fwd.n,
                      "diag": spec.cpu(), "x": x.cpu()}
    torch.save(out, path)


def time_entries(path) -> dict:
    """Child of the turns phase: the TURNS entry points of the
    ``repro_torch`` on sys.path, timed on the saved inputs (a chain on
    its forward tables, full chain)."""
    import torch
    from repro_torch.core.staging import StagedG, StagedT
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import shear as sh
    data = torch.load(path)
    out = {}
    for entry, (family, kernel) in TURNS.items():
        d = data[entry]
        cls, mod = (StagedG, bf) if family == "sym" else (StagedT, sh)
        fwd, bwd = (cls(*(t.to(DEVICE) for t in d[leg]), None, d["n"])
                    for leg in ("fwd", "bwd"))
        diag, x = d["diag"].to(DEVICE), d["x"].to(DEVICE)
        fn = getattr(mod, entry)
        if "operator" in kernel:
            call = lambda: fn(fwd, bwd, diag, x)  # noqa: E731
        else:
            call = lambda: fn(fwd, x)  # noqa: E731
        out[entry] = {"ms": time_ms(call), "device_ms": device_ms(call,
                                                                  kernel)}
    return out


def phase_turns(baselines, main, single, main_dir, single_dir) -> list:
    """This checkout's TURNS entry points and each baseline's, timed in
    turns (this, baselines..., then in reverse), each tree in a process
    of its own that builds its own kernels."""
    import os
    work = ROOT / "build" / "turns"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "turn_inputs.pt"
    save_turn_inputs(inputs, main, single, main_dir, single_dir)
    trees = [("this", ROOT)] + [(f"baseline {d}", pathlib.Path(d).resolve())
                                for d in baselines]
    rows = []
    for k, (tag, tree) in enumerate(trees + trees[::-1]):
        check((tree / "src" / "repro_torch").is_dir(),
              f"{tree} holds no src/repro_torch")
        env = dict(os.environ, REPRO_TORCH_BUILD_DIR=str(
            work / f"build_{trees.index((tag, tree))}"))
        out = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--time-entries",
             str(inputs), "--src", str(tree / "src")],
            capture_output=True, text=True, env=env, timeout=900)
        check(out.returncode == 0, f"turn {k} ({tag}) failed:\n"
              f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        for entry, r in res.items():
            dev_txt = ("not measured" if r["device_ms"] is None
                       else f"{r['device_ms']:.4f} ms")
            log(f"[turns] {k}: {tag}: {entry} {r['ms']:.4f} ms (device "
                f"{dev_txt})")
        rows.append({"turn": k, "tree": tag, **res})
    return rows


def reuse_g_greedy() -> None:
    """From here on in this process, a G greedy
    (``gtransform._approx_sym_core``) on exactly the inputs of an earlier
    one returns a copy of that one's result instead of running again.
    [main-filter], [main-dynamic] and [main-bf16] fit [main]'s fleet at
    its g and n_iter through their CLIs: each greedy would take 50-90 s
    of a run held to 1200 s.  Packing (a dynamic engine's pinned stage
    quantum included), tiers and all that follows still run per
    engine."""
    import copy
    import hashlib
    import torch
    from repro_torch.core import gtransform as gt
    real = gt._approx_sym_core
    done: dict = {}

    def digest(t):
        if t is None:
            return None
        data = torch.as_tensor(t).detach().cpu().contiguous().numpy()
        return hashlib.sha256(data.tobytes()).hexdigest()

    def core(s_mat, sbar0, g, n_iter, update_spectrum, eps, score,
             size=None):
        key = (tuple(s_mat.shape), digest(s_mat), digest(sbar0), g, n_iter,
               update_spectrum, eps, score, digest(size))
        if key in done:
            log(f"[reuse] G greedy of {tuple(s_mat.shape)} at g = {g}, "
                f"n_iter = {n_iter}: an earlier fit's result, not run again")
        else:
            done[key] = real(s_mat, sbar0, g, n_iter, update_spectrum, eps,
                             score, size)
        return copy.deepcopy(done[key])

    gt._approx_sym_core = core


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", nargs="+", default=[], metavar="DIR",
                    help="checkouts whose operator and chain entry points "
                    "are timed in turns with this one's (phase 8)")
    ap.add_argument("--time-entries", metavar="FILE",
                    help=argparse.SUPPRESS)
    ap.add_argument("--src", help=argparse.SUPPRESS)
    ap.add_argument("--maintenance-streams", metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_entries:
        sys.path.insert(0, args.src)
        print(json.dumps(time_entries(args.time_entries)))
        return 0
    if args.maintenance_streams:
        print(json.dumps(maintenance_streams(args.maintenance_streams)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    reuse_g_greedy()
    errs: dict = {}
    phase_kernels(errs)
    main_rec = phase_main()
    filter_rec = phase_main_filter(errs)
    single = phase_fgft(errs)
    kernels = phase_main_shapes(main_rec, single, errs)
    filter_out = filter_rec["out"]
    kernels += phase_bank_shapes("sym", filter_rec, filter_out["engine"],
                                 filter_out["signals"], single, errs)
    main_dir = phase_main_directed()
    single_dir = phase_fgft_directed(errs)
    kernels += phase_directed_shapes(main_dir, single_dir, errs)
    bank_dir = main_dir["bank"]
    kernels += phase_bank_shapes("general", bank_dir, bank_dir["engine"],
                                 main_dir["out"]["signals"], single_dir, errs)
    ragged = phase_main_ragged(errs)
    dynamic = phase_main_dynamic(errs, main_dir)
    bf16 = phase_main_bf16(errs, main_rec, filter_rec, single, main_dir,
                           single_dir)
    asynch = phase_main_async(errs, main_rec, main_dir)
    at = ("bf16", bf16["launches"])
    kernels += phase_main_shapes(main_rec, single, errs, *at)
    kernels += phase_bank_shapes("sym", filter_rec, filter_out["engine"],
                                 filter_out["signals"], single, errs, *at)
    kernels += phase_directed_shapes(main_dir, single_dir, errs, *at)
    kernels += phase_bank_shapes("general", bank_dir, bank_dir["engine"],
                                 main_dir["out"]["signals"], single_dir, errs,
                                 *at)
    check(len(kernels) == 2 * len(REPLACES),
          f"{len(kernels)} kernel rows for the f32 and bf16 forms of "
          f"{len(REPLACES)} entry points")
    ragged_counts = dict(ragged["launches"])
    for entry, k in ragged["bank_launches"].items():
        ragged_counts[entry] += k
    for entry, k in ragged["directed"]["launches"].items():
        ragged_counts[entry] += k
    for row in kernels:
        row["ragged_launches"] = ragged_counts[row["entry"]]
        row["dynamic_launches"] = dynamic["launches"].get(row["entry"], 0)
        row["async_launches"] = asynch["launches"].get(row["entry"], 0)
        row["max_abs_err"] = errs[row["entry"]]
    if args.baseline:
        turns = phase_turns(args.baseline, main_rec, single, main_dir,
                            single_dir)
        print(json.dumps({"turns": turns}))
    torch.cuda.synchronize()
    log(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
