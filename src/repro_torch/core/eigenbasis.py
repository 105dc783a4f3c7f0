"""ApproxEigenbasis: the batched facade over both factorization families.

``fit`` runs Algorithm 1 for a whole stack of B matrices at once — G
transforms for symmetric matrices (core/gtransform.py), scaling/shear T
transforms for general ones (core/ttransform.py); the B greedy chains
advance in lockstep on one device — and packs the (B, S, P) staged
tables of the chains (core/staging.py).  ``apply`` and ``project``
route through one ``ApplyPlan`` (kernels/plan.py): on a CUDA device
that is the hand-written CUDA kernels, on the CPU their plain PyTorch
versions.  Everything also works unbatched ((n, n) input).

Heterogeneous fleets: a list of square matrices of different sides (or
a zero-padded stack with ``sizes=``) fits as one masked bucket, each
chain acting as the identity on its padding coordinates.  ``extend``
grows a fit without refitting its prefix, and ``save``/``load`` persist
a basis through the checkpoint store in the JAX package's format, so
either package restores the other's bases.

Meshes: ``fit``/``extend`` with ``mesh=`` (launch/mesh.py) split the batch
over the mesh's data devices (runtime/sharding.py::batch_shard_ids) and
fit each shard on its own device; the factors come back to the fit's
device and the whole batch is packed once, as unplaced.  ``shard(mesh)``
returns the basis with a ``placement`` over those devices, through which
``apply``/``project`` then run (one launch per shard).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import gtransform as gt
from . import ttransform as tt
from .staging import (default_cut_ladder, pack_g_batch_pair, pack_g_pair,
                      pack_t_batch_pair, pack_t_pair, select_cut)
from .types import GFactors, TFactors, as_signal

SYMMETRIC = "sym"
GENERAL = "general"


def _is_symmetric(mats: torch.Tensor) -> bool:
    return bool(torch.allclose(mats, mats.transpose(-1, -2), atol=1e-6))


def pad_ragged(mats, width: Optional[int] = None, device="cuda") -> tuple:
    """Zero-pad a heterogeneous fleet of square matrices into one bucket.

    ``mats``: a sequence of (n_b, n_b) arrays or tensors (sides may
    differ).  Returns ``(stack, sizes)``: a (B, n, n) f32 tensor on
    ``device`` (``n`` = ``width`` or the largest side) and the (B,)
    int64 numpy array of true sides.  A masked fit
    (``ApproxEigenbasis.fit(..., sizes=sizes)``) acts as the identity on
    coordinates >= n_b, so each matrix factors as its own-size fit
    would."""
    arrs = [torch.as_tensor(m, dtype=torch.float32) for m in mats]
    for a in arrs:
        if a.dim() != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"ragged fleet entries must be square "
                             f"matrices, got shape {tuple(a.shape)}")
    if not arrs:
        raise ValueError("empty ragged fleet")
    sizes = np.asarray([a.shape[0] for a in arrs], np.int64)
    n = int(width) if width is not None else int(sizes.max())
    if n < int(sizes.max()):
        raise ValueError(f"bucket width {n} < largest matrix "
                         f"{int(sizes.max())}")
    out = torch.zeros((len(arrs), n, n), dtype=torch.float32,
                      device=device)
    for b, a in enumerate(arrs):
        out[b, :a.shape[0], :a.shape[0]] = a.to(out.device)
    return out, sizes


def _zero_pad_block(mats: torch.Tensor, sizes) -> torch.Tensor:
    """Enforce the ragged-embedding precondition: coordinates >= the true
    size are zeroed.  The masked greedy never selects a pad pair either
    way, but the polish and Lemma refits and the reported objective sum
    whole rows and columns, so garbage in a caller's pad block would
    corrupt them."""
    if sizes is None:
        return mats
    valid = gt._valid_mask(sizes, mats.shape[-1], mats.device)
    keep = valid[..., :, None] & valid[..., None, :]
    return torch.where(keep, mats, torch.zeros_like(mats))


def _normalize_sizes(sizes, batched: bool, n: int, batch: int):
    """Validate and canonicalize ``sizes``: a (B,) int64 array for a
    batched fit, an int for an unbatched one, or None when every matrix
    fills the bucket (the unmasked fit is the cheaper one)."""
    if sizes is None:
        return None
    sizes = np.asarray(sizes)
    if batched:
        if sizes.shape != (batch,):
            raise ValueError(f"sizes must be ({batch},) to match the "
                             f"matrix batch, got {sizes.shape}")
        sizes = sizes.astype(np.int64)
    else:
        if sizes.ndim != 0:
            raise ValueError(f"unbatched fit takes a scalar size, got "
                             f"shape {sizes.shape}")
        sizes = np.int64(sizes)
    if np.any(sizes < 2) or np.any(sizes > n):
        raise ValueError(f"sizes must lie in [2, {n}], got {sizes}")
    if np.all(sizes == n):
        return None
    return int(sizes) if not batched else sizes


def _shard_devices(mesh, batch: int) -> list:
    """The torch devices a (batch, n, n) fit splits over on ``mesh``."""
    from repro_torch.runtime.sharding import batch_shard_ids
    return [mesh.device(i) for i in batch_shard_ids(mesh, batch)]


def _rows(a, lo: int, hi: int, dev):
    """Rows [lo, hi) of a batched operand, copied to ``dev``: a tensor, a
    factor tuple of them, a numpy array (host metadata) or None."""
    if a is None:
        return None
    if isinstance(a, np.ndarray):
        return a[lo:hi]
    if isinstance(a, tuple):
        return type(a)(*(_rows(t, lo, hi, dev) for t in a))
    return a[lo:hi].to(dev, copy=True)


def _cat(parts, home):
    """The shards' results back on ``home``, concatenated on the batch
    axis (factor tuples field by field)."""
    first = parts[0]
    if isinstance(first, tuple):
        return type(first)(*(_cat([p[k] for p in parts], home)
                             for k in range(len(first))))
    return torch.cat([p.to(home) for p in parts])


def _fit_sharded(core, devices, home, rows: tuple, static: tuple, sizes):
    """``core(*rows, *static, sizes)`` (a batched fit or extend core)
    over one batch shard per device, each on its own device, one after
    the other from this thread; the results concatenated on ``home``."""
    if len(devices) <= 1:
        return core(*rows, *static, sizes)
    from repro_torch.kernels.plan import _on_device
    bsz = rows[0].shape[0]
    per = bsz // len(devices)
    outs = []
    for k, dev in enumerate(devices):
        lo, hi = k * per, (k + 1) * per
        with _on_device(dev):
            outs.append(core(*(_rows(a, lo, hi, dev) for a in rows),
                             *static, _rows(sizes, lo, hi, dev)))
    return tuple(_cat([o[q] for o in outs], home)
                 for q in range(len(outs[0])))


def _pack(kind: str, batched: bool, factors, n: int, cuts, stage_pad,
          device):
    """(fwd, bwd) staged tables of a chain, packed by the port."""
    if kind == SYMMETRIC:
        return (pack_g_batch_pair(factors, n, cuts=cuts, pad=stage_pad,
                                  device=device) if batched
                else pack_g_pair(factors, cuts=cuts, n=n, device=device))
    return (pack_t_batch_pair(factors, n, cuts=cuts, pad=stage_pad,
                              device=device) if batched
            else pack_t_pair(factors, n, cuts=cuts, device=device))


@dataclass
class ApproxEigenbasis:
    """A fitted fast approximate eigenbasis (single matrix or a batch).

    Attributes:
      kind: "sym" (G-transforms) or "general" (T-transforms).
      n: matrix side.
      batched: True when ``factors``/``spectrum`` carry a leading batch.
      factors: GFactors / TFactors with (g,) or (B, g) tensors.
      spectrum: estimated eigenvalues, (n,) or (B, n) f32.
      fwd / bwd: staged Ubar / Ubar^T (or Tbar / Tbar^{-1}) tables,
        (S, P) or (B, S, P).
      objective: final ||M - reconstruction||_F^2, scalar or (B,).
      info: fit diagnostics (objective history, iteration counts, score).
      sizes: true matrix sides of a ragged (masked) fit — a (B,) int64
        numpy array or an int — or None when every matrix fills the
        bucket.  A masked basis is the identity on coordinates >=
        sizes[b]: ``apply`` passes them through and ``project`` zeroes
        them.
      placement: the ``BucketPlacement`` of ``shard(mesh)``, over whose
        devices ``apply``/``project`` split the batch, or None (the
        tables and spectrum themselves stay whole on ``device``).
    """

    kind: str
    n: int
    batched: bool
    factors: Any
    spectrum: torch.Tensor
    fwd: Any
    bwd: Any
    objective: Optional[torch.Tensor] = None
    info: Dict[str, Any] = field(default_factory=dict)
    sizes: Optional[Any] = None
    placement: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return self.spectrum.device

    # -- fitting -----------------------------------------------------------

    @classmethod
    def fit(cls, mats, num_transforms: int, *, kind: str = "auto",
            hint: Optional[str] = None, n_iter: int = 8, eps: float = 1e-3,
            update_spectrum: bool = True, spectrum=None,
            score: Optional[str] = None, sizes=None,
            mesh=None, stage_pad: Optional[tuple] = None,
            device="cuda") -> "ApproxEigenbasis":
        """Factor one matrix (n, n) or a batch (B, n, n) — Algorithm 1.

        The B greedy factorizations advance in lockstep on ``device``.
        ``kind="auto"`` resolves to "sym" for symmetric input and to
        "general" otherwise; pass ``kind="sym"``/``"general"`` to force
        a family, or ``hint`` ("sym" or "general") to keep the detection
        but be warned when it resolves against the family the caller
        expects.  ``score``/``spectrum`` as in
        ``gtransform.approximate_symmetric`` (``score`` applies to the
        symmetric family only).  ``stage_pad``: optional
        (depth_quantum, width_quantum) staged-table shape quantization
        for batched fits.  ``mesh`` (launch/mesh.py): a batch splits over
        the mesh's data devices (the largest subset of its data axes
        whose size divides B; an unbatched fit or an awkward B runs on
        ``device``), each shard fitted on its own device; the factors
        come back to ``device`` and pack once, so the basis equals the
        unplaced fit's.

        Heterogeneous fleets: ``mats`` may be a LIST of square matrices
        of different sides; they are zero-padded into one (B, n, n)
        bucket (``pad_ragged``) and fitted with the greedy masked to each
        matrix's true coordinates.  Or pass a padded stack with ``sizes``
        ((B,) true sides); its pad block is zeroed."""
        dev = torch.device(device)
        if isinstance(mats, (list, tuple)):
            if sizes is not None:
                raise ValueError("pass sizes= only with a pre-padded "
                                 "stack; a ragged list derives its own")
            mats, sizes = pad_ragged(mats, device=dev)
        mats = torch.as_tensor(mats, dtype=torch.float32).to(dev)
        if mats.dim() not in (2, 3):
            raise ValueError(f"expected (n, n) or (B, n, n), got "
                             f"{tuple(mats.shape)}")
        batched = mats.dim() == 3
        n = mats.shape[-1]
        if mats.shape[-2] != n:
            raise ValueError(f"matrices must be square, got "
                             f"{tuple(mats.shape)}")
        sizes = _normalize_sizes(sizes, batched, n,
                                 mats.shape[0] if batched else 0)
        mats = _zero_pad_block(mats, sizes)
        if hint not in (None, SYMMETRIC, GENERAL):
            raise ValueError(f"unknown hint {hint!r}; expected "
                             f"{SYMMETRIC!r} or {GENERAL!r}")
        if kind == "auto":
            kind = SYMMETRIC if _is_symmetric(mats) else GENERAL
            if hint is not None and hint != kind:
                warnings.warn(
                    f"kind='auto' resolved to {kind!r}, overriding the "
                    f"caller hint {hint!r}; pass kind={hint!r} to force "
                    "that factorization family", stacklevel=2)
        if kind not in (SYMMETRIC, GENERAL):
            raise ValueError(f"unknown kind {kind!r}")
        if kind == GENERAL and score is not None:
            raise ValueError(
                f"score={score!r} applies to the symmetric (G-transform) "
                "family only; the general (T-transform) greedy has no "
                "score variant")
        if spectrum is not None:
            spectrum = torch.as_tensor(spectrum, dtype=torch.float32).to(dev)
            want = tuple(mats.shape[:-2]) + (n,)
            if tuple(spectrum.shape) != want:
                raise ValueError(
                    f"spectrum shape {tuple(spectrum.shape)} does not match "
                    f"the fitted batch: expected {want}")
        stack = mats if batched else mats.unsqueeze(0)
        devices = (_shard_devices(mesh, stack.shape[0])
                   if mesh is not None and batched else [dev])
        info = {"stage_pad": stage_pad}
        if kind == SYMMETRIC:
            if score is None:
                score = "paper" if spectrum is not None else "gamma"
            sbar0 = (spectrum if spectrum is not None
                     else gt.default_sbar(mats, sizes))
            factors, sbar, obj, hist, iters = _fit_sharded(
                gt._approx_sym_core, devices, dev,
                (stack, sbar0.reshape(stack.shape[:2])),
                (num_transforms, n_iter, update_spectrum, eps, score),
                sizes)
            info["score"] = score
        else:
            cbar0 = (spectrum if spectrum is not None
                     else tt.default_cbar(mats, sizes))
            factors, sbar, obj, hist, iters = _fit_sharded(
                tt._approx_gen_core, devices, dev,
                (stack, cbar0.reshape(stack.shape[:2])),
                (num_transforms, n_iter, update_spectrum, eps), sizes)
        if not batched:
            factors = type(factors)(*(f[0] for f in factors))
            sbar, obj, hist, iters = sbar[0], obj[0], hist[0], iters[0]
        fwd, bwd = _pack(kind, batched, factors, n, None, stage_pad, dev)
        info.update(history=hist, iterations=iters)
        return cls(kind=kind, n=n, batched=batched, factors=factors,
                   spectrum=sbar, fwd=fwd, bwd=bwd, objective=obj,
                   info=info, sizes=sizes)

    @property
    def num_transforms(self) -> int:
        """Number of fitted fundamental components g (per matrix)."""
        return int(self.factors[0].shape[-1])

    @property
    def stage_cuts(self) -> np.ndarray:
        """(C, 2) exact (num_stages, num_components) anytime boundaries."""
        return self.fwd.cuts

    def select_tier(self, fraction: Optional[float] = None,
                    num_transforms: Optional[int] = None) -> tuple:
        """The exact stage cut nearest a component target:
        ``(num_stages, num_components)`` for ``apply``/``project``."""
        return select_cut(self.fwd, num_transforms=num_transforms,
                          fraction=fraction)

    def extend(self, mats, num_transforms: int, *, n_iter: int = 0,
               eps: float = 1e-3, update_spectrum: bool = True,
               score: Optional[str] = None, mesh=None,
               stage_pad: Optional[tuple] = None) -> "ApproxEigenbasis":
        """Grow this fit to ``num_transforms`` components WITHOUT
        refitting the prefix: new Theorem-1/3 components are fitted
        greedily against the current residual, so the extended basis's
        anytime prefix of the ORIGINAL g components is the original
        basis.  ``n_iter`` > 0 re-sweeps the whole chain with the usual
        polish and Lemma refits.

        ``mats``: the (n, n) / (B, n, n) stack this basis was fitted to
        (a ragged fit extends against its zero-padded bucket stack and
        keeps its mask).  The new cut ladder carries the original g, so
        the pre-extension basis stays selectable as a serving tier.
        ``score`` defaults to the score the fit resolved; like ``fit``
        it is rejected for the general family.  ``mesh``: as in ``fit``
        (each batch shard extends on its own device).  The extended basis
        keeps this one's ``placement``."""
        dev = self.device
        mats = torch.as_tensor(mats, dtype=torch.float32).to(dev)
        if mats.dim() != (3 if self.batched else 2):
            raise ValueError(f"expected {'batched ' if self.batched else ''}"
                             f"matrices matching the fit, got "
                             f"{tuple(mats.shape)}")
        if mats.shape[-1] != self.n or mats.shape[-2] != self.n:
            raise ValueError(f"matrix side {mats.shape[-1]} != fitted "
                             f"n={self.n}")
        if self.kind != SYMMETRIC and score is not None:
            raise ValueError(
                f"score={score!r} applies to the symmetric (G-transform) "
                "family only; this basis is kind='general'")
        g_old = self.num_transforms
        extra = num_transforms - g_old
        if extra <= 0:
            raise ValueError(f"num_transforms must exceed the fitted "
                             f"{g_old}, got {num_transforms}")
        mats = _zero_pad_block(mats, self.sizes)
        cuts = sorted(set(default_cut_ladder(num_transforms).tolist())
                      | {g_old})
        if stage_pad is None:     # keep the fit's shape quantization
            stage_pad = self.info.get("stage_pad")
        info: Dict[str, Any] = {"extended_from": g_old,
                                "stage_pad": stage_pad}
        stack = mats if self.batched else mats.unsqueeze(0)
        factors0 = (self.factors if self.batched else type(self.factors)(
            *(f.unsqueeze(0) for f in self.factors)))
        spec0 = self.spectrum.reshape(stack.shape[:2])
        devices = (_shard_devices(mesh, stack.shape[0])
                   if mesh is not None and self.batched else [dev])
        if self.kind == SYMMETRIC:
            if score is None:
                score = self.info.get("score", "gamma")
            info["score"] = score  # chained extends keep the criterion
            factors, sbar, obj, hist, iters = _fit_sharded(
                gt._extend_sym_core, devices, dev, (stack, factors0, spec0),
                (extra, n_iter, update_spectrum, eps, score), self.sizes)
        else:
            factors, sbar, obj, hist, iters = _fit_sharded(
                tt._extend_gen_core, devices, dev, (stack, factors0, spec0),
                (extra, n_iter, update_spectrum, eps), self.sizes)
        if not self.batched:
            factors = type(factors)(*(f[0] for f in factors))
            sbar, obj, hist, iters = sbar[0], obj[0], hist[0], iters[0]
        fwd, bwd = _pack(self.kind, self.batched, factors, self.n, cuts,
                         stage_pad, dev)
        info.update(history=hist, iterations=iters)
        return type(self)(kind=self.kind, n=self.n, batched=self.batched,
                          factors=factors, spectrum=sbar, fwd=fwd, bwd=bwd,
                          objective=obj, info=info, sizes=self.sizes,
                          placement=self.placement)

    # -- application -------------------------------------------------------

    def _plan(self, mode: str, backend: Optional[str],
              num_stages: Optional[int], precision: str,
              keep: str = "head", fused: bool = True):
        from repro_torch.kernels.plan import ApplyPlan
        return ApplyPlan(family=self.kind, mode=mode, n=self.n,
                         batched=self.batched, backend=backend,
                         num_stages=num_stages, keep=keep,
                         precision=precision, fused=fused,
                         device=str(self.device), placement=self.placement)

    def _signal(self, x) -> torch.Tensor:
        return as_signal(x, self.device)

    def apply(self, x, inverse: bool = False, backend: Optional[str] = None,
              num_stages: Optional[int] = None,
              precision: str = "f32") -> torch.Tensor:
        """y = Ubar x (or Tbar x); ``inverse=True`` applies Ubar^T /
        Tbar^{-1} (graph Fourier ANALYSIS; forward is SYNTHESIS).
        ``x``: (..., n), with a leading (B, ...) batch when ``batched``.
        ``num_stages`` runs an anytime prefix (pick one with
        ``select_tier``); ``precision="bf16"`` stores the tables in bf16
        (cast once per table set and kept) and accumulates in f32."""
        from repro_torch.kernels.plan import leg_orientation
        staged = self.bwd if inverse else self.fwd
        keep = leg_orientation(self.kind)[0 if inverse else 1]
        plan = self._plan("apply", backend, num_stages, precision, keep)
        return plan.apply(staged, self._signal(x))

    def project(self, x, h: Optional[Callable] = None,
                backend: Optional[str] = None,
                num_stages: Optional[int] = None, precision: str = "f32",
                fused: bool = True) -> torch.Tensor:
        """y = Ubar diag(h(spectrum)) Ubar^T x, or Tbar diag(h(spectrum))
        Tbar^{-1} x for the general family (``h`` defaults to the
        identity: the approximated matrix itself).  One fused kernel
        launch on the card; ``fused=False`` is the three-pass baseline;
        ``precision="bf16"`` stores the tables in bf16, accumulating in
        f32.
        On a ragged basis the gains are zeroed at each matrix's padding
        coordinates: the padded spectrum is 0 but ``h(0)`` need not be,
        and the transforms pass pad coordinates through, so an unmasked
        ``h`` would leak pad columns of ``x`` into the output."""
        d = self.spectrum if h is None else h(self.spectrum)
        if h is not None and self.sizes is not None:
            d = torch.where(gt._valid_mask(self.sizes, self.n, d.device),
                            d, torch.zeros_like(d))
        plan = self._plan("operator", backend, num_stages, precision,
                          fused=fused)
        return plan.operator(self.fwd, self.bwd, d, self._signal(x))

    def _eye(self) -> torch.Tensor:
        eye = torch.eye(self.n, dtype=torch.float32, device=self.device)
        if self.batched:
            eye = eye.expand(self.spectrum.shape[0], self.n, self.n)
        return eye.contiguous()

    def to_dense(self, num_stages: Optional[int] = None) -> torch.Tensor:
        """Materialize Ubar (or Tbar) as (n, n) or (B, n, n)
        (``num_stages``: the anytime prefix basis)."""
        # staged apply acts on row vectors: row r of the result is
        # (basis e_r), i.e. the transpose of the basis matrix
        return self.apply(self._eye(), num_stages=num_stages).transpose(-1, -2)

    def reconstruct(self) -> torch.Tensor:
        """Dense Ubar diag(s) Ubar^T (or Tbar diag(c) Tbar^{-1}) as (n, n)
        or (B, n, n)."""
        return self.project(self._eye()).transpose(-1, -2)

    def frobenius_error(self, mats) -> torch.Tensor:
        """||M - reconstruction||_F^2 per matrix (scalar or (B,))."""
        diff = (torch.as_tensor(mats, dtype=torch.float32).to(self.device)
                - self.reconstruct())
        return (diff * diff).sum((-2, -1))

    def shard(self, mesh) -> "ApproxEigenbasis":
        """This basis with a ``placement`` over ``mesh``'s data devices
        (the largest subset of its data axes whose size divides B):
        ``apply``/``project`` on (B, ..., n) signals then run one launch
        per device shard and gather the answer on ``device``.  An
        unbatched basis, or a batch that splits over one device, is
        returned as it is."""
        if not self.batched:
            return self
        from repro_torch.runtime.sharding import (BucketPlacement,
                                                  batch_shard_ids)
        batch = int(self.spectrum.shape[0])
        ids = batch_shard_ids(mesh, batch)
        if len(ids) <= 1:
            return self
        placement = BucketPlacement(
            device_ids=ids, batch=batch,
            devices=tuple(str(mesh.device(i)) for i in ids))
        return replace(self, placement=placement)

    # -- persistence (repro_torch/checkpoint, the JAX package's format) ---

    def save(self, directory, step: int = 0, *,
             extra_state: Optional[Dict[str, Any]] = None,
             extra_metadata: Optional[Dict[str, Any]] = None,
             shards: int = 1):
        """Persist factors + spectrum through the atomic checkpoint store,
        with the JAX package's leaves and ``eigenbasis`` metadata block.

        ``extra_state``: more leaves saved alongside (``load`` ignores
        them; the serve engines persist their Laplacians this way).
        ``extra_metadata``: JSON-able keys merged into the manifest
        metadata beside the ``eigenbasis`` block.  ``shards``: table
        files the leading axis is split over."""
        from repro_torch.checkpoint import save_checkpoint
        state: Dict[str, Any] = {"factors": self.factors,
                                 "spectrum": self.spectrum}
        for key, leaf in (extra_state or {}).items():
            if key in state:
                raise ValueError(f"extra_state key {key!r} collides with "
                                 "the basis state")
            state[key] = leaf
        meta = dict(extra_metadata or {})
        if "eigenbasis" in meta:
            raise ValueError("extra_metadata must not carry an "
                             "'eigenbasis' key")
        stage_pad = self.info.get("stage_pad")
        meta["eigenbasis"] = {
            "kind": self.kind, "n": self.n, "batched": self.batched,
            "num_transforms": self.num_transforms,
            "batch": int(self.spectrum.shape[0]) if self.batched else 0,
            # load() repacks the tables deterministically; the ladder
            # documents the tiers a restored basis offers and lets load()
            # verify the repack
            "num_stages": int(self.fwd.num_stages),
            "stage_cuts": (np.asarray(self.fwd.cuts).tolist()
                           if self.fwd.cuts is not None else None),
            # the resolved greedy criterion: a restored basis extends
            # under the score its fit used
            "score": self.info.get("score"),
            "objective": (self.objective.detach().cpu().double().tolist()
                          if self.objective is not None else None),
            "sizes": (np.asarray(self.sizes).tolist()
                      if self.sizes is not None else None),
            "version": int(self.info.get("version", 0)),
            "stage_pad": list(stage_pad) if stage_pad else None,
        }
        return save_checkpoint(directory, step, state, metadata=meta,
                               shards=shards)

    @classmethod
    def load(cls, directory, step: Optional[int] = None,
             device="cuda") -> "ApproxEigenbasis":
        """Restore a fitted basis (saved by either package) onto
        ``device`` and repack its staged tables with the checkpoint's
        cut ladder."""
        from repro_torch.checkpoint import (latest_step, read_metadata,
                                            restore_checkpoint)
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint in {directory}")
        meta = read_metadata(directory, step).get("eigenbasis")
        if meta is None:
            raise ValueError(f"checkpoint at {directory} does not hold an "
                             "ApproxEigenbasis state")
        dev = torch.device(device)
        kind, n = meta["kind"], int(meta["n"])
        batched = bool(meta["batched"])
        g = int(meta["num_transforms"])
        shape = (int(meta["batch"]), g) if batched else (g,)
        nsh = (int(meta["batch"]), n) if batched else (n,)
        zi = torch.zeros(shape, dtype=torch.int32, device=dev)
        zf = torch.zeros(shape, dtype=torch.float32, device=dev)
        if kind == SYMMETRIC:
            factors_like = GFactors(i=zi, j=zi, c=zf, s=zf, sigma=zf)
        else:
            factors_like = TFactors(kind=zi, i=zi, j=zi, a=zf)
        like = {"factors": factors_like,
                "spectrum": torch.zeros(nsh, dtype=torch.float32,
                                        device=dev)}
        state, _, _ = restore_checkpoint(directory, like, step=step)
        factors, spectrum = state["factors"], state["spectrum"]
        stage_pad = meta.get("stage_pad")
        if stage_pad is not None:
            stage_pad = tuple(int(q) for q in stage_pad)
        # repack with the checkpoint's COMPONENT ladder: an extended basis
        # carries its pre-extension g as an extra cut, which the default
        # quarters ladder would drop
        saved_cuts = meta.get("stage_cuts")
        cuts = (None if saved_cuts is None
                else sorted({int(row[1]) for row in saved_cuts}))
        fwd, bwd = _pack(kind, batched, factors, n, cuts, stage_pad, dev)
        if (saved_cuts is not None and fwd.cuts is not None
                and np.asarray(fwd.cuts).tolist() != saved_cuts):
            warnings.warn(
                "restored staged tables repacked with a different anytime "
                "cut ladder than the checkpoint recorded (packing defaults "
                "changed?); serving tiers pinned to the old ladder's stage "
                "counts must be re-selected via select_tier", stacklevel=2)
        info: Dict[str, Any] = {"version": int(meta.get("version", 0)),
                                "stage_pad": stage_pad}
        if meta.get("score") is not None:
            info["score"] = meta["score"]
        objective = None
        if meta.get("objective") is not None:
            objective = torch.tensor(meta["objective"], dtype=torch.float32,
                                     device=dev)
        sizes = meta.get("sizes")
        if sizes is not None:
            sizes = (np.asarray(sizes, np.int64) if batched
                     else int(sizes))
        return cls(kind=kind, n=n, batched=batched, factors=factors,
                   spectrum=spectrum, fwd=fwd, bwd=bwd, objective=objective,
                   info=info, sizes=sizes)
