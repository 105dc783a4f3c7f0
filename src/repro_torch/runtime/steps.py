"""Step functions: the train step with its state, the cross-pod
compressed train step, and the prefill and decode steps, at the JAX
package's ``runtime/steps.py`` names.

Without a mesh, the train step runs on one device, its state plain
tensors updated in place (the JAX step's buffer donation).  On a mesh
(``launch/mesh.py``; the dry run's ``state_shardings`` are the JAX
``_state_shardings``) one process drives every mesh id, as JAX's single
controller does:

* the state lives in shards: ``shd.place_tree(state, bundle.state_
  shardings)`` gives mesh id -> that id's ``TrainState`` of shards, which
  the step updates in place; each id holds exactly the bytes the dry run
  predicts for it (``launch/dryrun.py::analyze``);
* the batch splits over the batch rule's axes; each data group runs the
  forward and backward on its rows, and the loss is the global masked
  mean (each group's NLL sum and mask count added over the data axes
  before the division);
* the model axis is tensor and expert parallelism for every group of
  every family (``transformer.tp_nll_sums``): attention and
  cross-attention heads, ``ff``, the vocabulary, the MoE experts (or each
  expert's ``ff``) and the SSD and RG-LRU widths split as the rules split
  them, the audio encoder like a dense stack; each rank's config is
  ``transformer.local_config``'s;
* with ``fsdp`` the leaves the rules split over "data" are all-gathered
  at the step's start and their gradients reduce-scattered back; the
  other gradients are added over the data axes (and a leaf every rank
  holds whole but uses inside a split block, over "model":
  ``transformer.tp_partial_leaves``);
* the global norm counts each distinct shard once; AdamW runs per shard.

The collectives are the port's own (``runtime/collectives.py``) and count
their bytes per mesh id in ``bundle.collectives`` (read by
``hlo_analysis.collective_terms``).  On a 1x1 mesh the step is the
unsharded step, bit for bit.

The prefill and decode steps on a mesh (``_MeshServe``) are the JAX
steps' sharding: the parameters by their rules, the cache by
``cache_axes`` (``seq_shard``: its ``kv_seq`` over "data" where the
global batch is smaller than the data-parallel shards), the batch by
``batch_sharding``; each "model" group runs ``transformer.tp_serve``.
Without a mesh they wrap ``Transformer.prefill`` and ``decode_step``.

Every sharded step also runs as a representative trace
(``representative=True``; ``collectives.Representatives``): on
``meta``, one id runs and the others are virtual members of its groups,
so that a production mesh's collectives are counted from one id
(``launch/dryrun.py``).  The per-id setup then works on that id alone
(``_owned`` reads the mesh once a split, ``placed_abstract``).

The step's order is the JAX step's: ``loss_fn`` and its gradients (a live
``Transformer`` over the state's parameters, remat as the config asks),
then the error-feedback butterfly compression of the gradients where
``grad_compress_ratio`` > 0 (on a mesh: of each whole leaf, as GSPMD
gives the JAX step), the warmup-cosine learning rate at the optimizer's
step, and the AdamW update.  The pod step compresses each device's own
shard and averages only the compact coefficients across pods.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.blocks import moe_groups
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw, compress
from repro_torch.runtime import collectives as col
from repro_torch.runtime import sharding as shd


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    ef_err: Optional[Any] = None  # error-feedback buffers (compression on)


class StepBundle(NamedTuple):
    """A step function, the shardings of what it takes (None without a
    mesh) and their shapes: ``abstract_state`` and ``abstract_batch`` hold
    tensors on the ``meta`` device (the JAX bundle's
    ``ShapeDtypeStruct``s).  ``collectives``: the counter of a sharded
    step's collectives (None without a mesh)."""
    fn: Callable
    state_shardings: Any
    batch_shardings: Any
    abstract_state: Any
    abstract_batch: Any
    collectives: Optional[col.Counter] = None


def state_shardings(cfg: ModelConfig, mesh, rules,
                    use_compression: bool = False) -> TrainState:
    """The train state's ``NamedSharding`` tree on ``mesh`` (the JAX
    ``_state_shardings``): the parameters' by their logical axes, the
    moments and any error-feedback buffers the parameters', the step
    replicated."""
    axes = tfm.param_axes(cfg)
    params = shd.sharding_tree(axes, mesh, rules)
    return TrainState(params,
                      shd.sharding_tree(adamw.state_axes(axes), mesh, rules),
                      params if use_compression else None)


def _meta_params(cfg: ModelConfig):
    return tfm.tree_map(lambda leaf: torch.empty(
        leaf.shape, dtype=cfg.param_dtype, device="meta"), tfm.param_spec(cfg))


def abstract_train_state(cfg: ModelConfig, use_compression: bool = False,
                         moment_dtype=torch.float32) -> TrainState:
    """The train state's tree, shapes and dtypes without memory."""
    params = _meta_params(cfg)
    opt = adamw.init_abstract(params, moment_dtype)
    ef = compress.init_error_abstract(params) if use_compression else None
    return TrainState(params, opt, ef)


def concrete_train_state(cfg: ModelConfig,
                         generator: Optional[torch.Generator] = None,
                         device="cuda", use_compression: bool = False,
                         moment_dtype=torch.float32) -> TrainState:
    """Fresh parameters (``transformer.init_params`` from ``generator``,
    default seed 0 on ``device``), zero moments in ``moment_dtype`` and,
    with compression, zero bf16 error-feedback buffers."""
    params = tfm.init_params(cfg, generator, device)
    opt = adamw.init(params, moment_dtype)
    ef = compress.init_error(params) if use_compression else None
    return TrainState(params, opt, ef)


def _memory_spec(cfg: ModelConfig, seq_len: int, global_batch: int):
    if cfg.family == "vlm":
        return (global_batch, cfg.num_patches, cfg.d_model)
    if cfg.family == "audio":
        return (global_batch, max(seq_len // cfg.enc_ratio, 1), cfg.d_model)
    return None


def input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                mode: str = "train"):
    """``meta`` tensors standing in for every model input of a cell:
    tokens (B, S) int32 (decode: token (B, 1) and pos (B,)), and the
    vision or audio memory in bf16."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if mode in ("train", "prefill"):
        batch = {"tokens": meta((global_batch, seq_len), torch.int32)}
    else:
        batch = {"token": meta((global_batch, 1), torch.int32),
                 "pos": meta((global_batch,), torch.int32)}
    mem = _memory_spec(cfg, seq_len, global_batch)
    if mem is not None:
        batch["memory"] = meta(mem, torch.bfloat16)
    return batch


def _on(batch, device):
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, mesh=None, *, seq_len: int,
                    global_batch: int, fsdp: bool = False,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, weight_decay: float = 0.1,
                    grad_compress_ratio: float = 0.0,
                    moment_dtype=torch.float32, device="cuda",
                    representative: bool = False) -> StepBundle:
    """``fn(state, batch) -> (state, metrics)``: one training step, the
    JAX ``make_train_step``'s.  The state's parameters, moments and step
    are updated in place (the JAX step donates them); the returned state
    holds the same tensors and the new error-feedback buffers.
    ``metrics``: 0-d tensors ``loss``, ``ppl_proxy``, ``grad_norm`` and
    ``lr`` (no host read).

    ``mesh`` None: the state is one tree on ``device`` and ``fsdp`` does
    nothing (no data axis to shard over).  A ("data", "model") ``Mesh``:
    the state is placed (``shd.place_tree(state, bundle.state_shardings)``
    or ``placed_train_state``), the batch a host batch of the global
    rows, placed by the step (module docstring).  ``representative``:
    a representative trace (one id runs, ``collectives.Representatives``)
    on a mesh of ``meta`` ids, its state ``placed_abstract(bundle)``."""
    use_comp = grad_compress_ratio > 0
    abstract = abstract_train_state(cfg, use_comp, moment_dtype)
    specs = input_specs(cfg, seq_len, global_batch, "train")
    hyper = dict(peak_lr=peak_lr, warmup=warmup, total=total_steps,
                 weight_decay=weight_decay)
    if mesh is not None:
        rules = shd.make_rules(mesh, cfg, fsdp=fsdp,
                               global_batch=global_batch)
        run = _MeshStep(cfg, mesh, rules, seq_len, global_batch, hyper,
                        ratio=grad_compress_ratio,
                        representative=representative)
        return StepBundle(run, run.state_sh, run.batch_sh, abstract, specs,
                          run.counter)
    del fsdp
    dev = torch.device(device)
    spec = (compress.make_spec(ratio=grad_compress_ratio, device=dev)
            if use_comp else None)
    live = {}   # the live model over the current parameter tree

    def model_of(params) -> tfm.Transformer:
        if live.get("params") is not params:
            live.clear()
            live["model"] = tfm.Transformer(cfg, params, live=True)
            live["params"] = params
        return live["model"]

    def step(state: TrainState, batch):
        model = model_of(state.params)
        (loss, metrics), grads = tfm.value_and_grad(
            model, cfg, _on(batch, dev))
        ef_err = state.ef_err
        with torch.no_grad():
            if use_comp:
                grads, ef_err = compress.tree_ef_compress(
                    spec, grads, ef_err, step=state.opt.step)
            lr = _lr(state.opt.step, hyper)
            _, new_opt, om = adamw.update(grads, state.opt, state.params,
                                          lr=lr, weight_decay=weight_decay)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr"] = lr
        return TrainState(state.params, new_opt, ef_err), metrics

    #: {"model": the live model of the last step's parameters (its
    #: ``grads``, that step's gradients before the update), "params"}
    step.live = live
    return StepBundle(step, None, None, abstract, specs)


def make_pod_compressed_train_step(
        cfg: ModelConfig, mesh, *, seq_len: int, global_batch: int,
        fsdp: bool = False, compress_ratio: float = 0.125,
        moment_dtype=torch.float32, peak_lr: float = 3e-4,
        warmup: int = 100, total_steps: int = 10_000,
        weight_decay: float = 0.1,
        representative: bool = False) -> StepBundle:
    """Train step whose CROSS-POD gradient reduction runs in the compressed
    butterfly basis with error feedback (the JAX function's).

    Each pod computes the gradients of its share of the global batch (its
    data and model axes as in ``make_train_step``), the error-feedback
    compression then runs on every mesh id on its own shard of each leaf,
    and only the compact coefficient blocks are averaged across pods
    (``min_size`` compared with the shard's size: a small shard is
    averaged whole); ``loss`` and ``ppl_proxy`` are the pods' means.  The
    error-feedback buffers are bf16 of shape (npod, *leaf), each pod's
    row sharded like the leaf.  ``representative``: ``make_train_step``'s."""
    if "pod" not in mesh.axis_names:
        raise ValueError("make_pod_compressed_train_step: multi-pod mesh "
                         f"required, got axes {mesh.axis_names}")
    npod = mesh.shape["pod"]
    rules = shd.make_rules(mesh, cfg, fsdp=fsdp, global_batch=global_batch)
    hyper = dict(peak_lr=peak_lr, warmup=warmup, total=total_steps,
                 weight_decay=weight_decay)
    run = _MeshStep(cfg, mesh, rules, seq_len, global_batch, hyper,
                    ratio=compress_ratio, pod=True,
                    representative=representative)
    params = _meta_params(cfg)
    ef = tfm.tree_map(lambda p: torch.empty((npod,) + tuple(p.shape),
                                            dtype=torch.bfloat16,
                                            device="meta"), params)
    abstract = TrainState(params, adamw.init_abstract(params, moment_dtype),
                          ef)
    return StepBundle(run, run.state_sh, run.batch_sh, abstract,
                      input_specs(cfg, seq_len, global_batch, "train"),
                      run.counter)


def placed_train_state(bundle: StepBundle,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[int, Any]:
    """A fresh state placed on a sharded step's mesh: the parameters of
    ``transformer.init_params`` (from ``generator``, default seed 0)
    drawn on the mesh's first device one leaf at a time, each placed
    before the next is drawn (no whole tree on one device); zero moments,
    step and error-feedback buffers made as shards on each id."""
    run = bundle.fn
    sh = bundle.state_shardings
    a = bundle.abstract_state
    parts = tfm.init_params(run.cfg, generator, run.mesh.device(run.ids[0]),
                            place=sh.params)
    params = {i: tfm.tree_map(lambda _, d, i=i: d[i], a.params, parts)
              for i in run.ids}

    def zeros(abstract, sharding):
        return {i: torch.zeros(sharding.shard_shape(abstract.shape),
                               dtype=abstract.dtype,
                               device=run.mesh.device(i)) for i in run.ids}

    def placed(abstract, shardings):
        if abstract is None:
            return dict.fromkeys(run.ids)
        leaves = tfm.tree_map(zeros, abstract, shardings)
        return {i: tfm.tree_map(lambda _, d, i=i: d[i], abstract, leaves)
                for i in run.ids}

    mu, nu = placed(a.opt.mu, sh.opt.mu), placed(a.opt.nu, sh.opt.nu)
    step = zeros(a.opt.step, sh.opt.step)
    ef = placed(a.ef_err, sh.ef_err)
    return {i: TrainState(params[i],
                          adamw.AdamWState(step[i], mu[i], nu[i]), ef[i])
            for i in run.ids}


def placed_abstract(bundle: StepBundle):
    """A sharded step's abstract state placed on the ids it runs, as
    ``meta`` shards, what a representative trace runs on
    (``launch/dryrun.py``): train, id -> ``TrainState``; serve, (id ->
    parameters, id -> cache)."""
    placed = shd.place_tree(bundle.abstract_state, bundle.state_shardings,
                            bundle.fn.ids)
    if isinstance(bundle.fn, _MeshServe):
        return ({i: v[0] for i, v in placed.items()},
                {i: v[1] for i, v in placed.items()})
    return placed


def _lr(step, hyper):
    return adamw.warmup_cosine(step, peak_lr=hyper["peak_lr"],
                               warmup=hyper["warmup"], total=hyper["total"])


def _leaf_paths(tree, prefix=()):
    """(path, leaf) of a nested dict's leaves, keys sorted (the JAX
    order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _owned(shardings: Dict[tuple, Any], mesh, ids) -> Dict[int, list]:
    """id -> the paths of the shards it counts in the global norm: the
    first id (in id order) holding each distinct shard.  Which ids hold
    one shard depends only on the mesh axes its spec splits over, so
    each such set is worked out once, over the whole mesh."""
    owners: Dict[tuple, set] = {}
    out: Dict[int, list] = {i: [] for i in ids}
    every = sorted(int(i) for i in mesh.device_ids.ravel())
    for path, s in shardings.items():
        key = tuple(a for e in s.spec for a in shd.entry_axes(e))
        if key not in owners:
            seen, first = set(), set()
            for i in every:
                if s.index(i) not in seen:
                    seen.add(s.index(i))
                    first.add(i)
            owners[key] = first
        for i in ids:
            if i in owners[key]:
                out[i].append(path)
    return out


def _place_batch(batch, shardings, ids):
    """A host batch (numpy arrays or tensors, a ``meta`` one too) placed
    on ``ids`` by the batch shardings (a key without its own, e.g. a
    mask, as the tokens)."""
    tok = shardings["tokens" if "tokens" in shardings else "token"]
    sh = {k: shardings.get(k, tok) for k in batch}
    return shd.place_tree({k: v if isinstance(v, torch.Tensor)
                           else torch.as_tensor(np.asarray(v))
                           for k, v in batch.items()}, sh, ids)


class _MeshRun:
    """What the sharded train and serve steps share: the ids they run
    (every id of the mesh; with ``representative`` the one id of a
    representative trace, ``collectives.Representatives``), the counter
    of their collectives, the batch axes and their shards, the model
    axis's layout and a rank's config, the leaves split over "data"
    (fsdp; ``param_sh``: path -> sharding) and each id's ``Transformer``
    (``_models``)."""

    def __init__(self, cfg: ModelConfig, mesh, rules, param_sh: dict,
                 representative: bool):
        tp = mesh.shape.get("model", 1)
        self.cfg, self.mesh = cfg, mesh
        self.rep = col.Representatives(mesh) if representative else None
        self.ids = (self.rep.ids if self.rep else
                    sorted(int(i) for i in mesh.device_ids.ravel()))
        self.counter = col.Counter(self.rep.stands_for if self.rep
                                   else None)
        self.batch_axes = tuple(shd.entry_axes(rules["batch"]))
        self.shards = int(np.prod([mesh.shape[a] for a in self.batch_axes]))
        self.layout = tfm.tp_layout(rules) if tp > 1 else None
        self.local_cfg = (tfm.local_config(cfg, self.layout, tp) if tp > 1
                          else cfg)
        self.fsdp = {p: s.dim_of("data") for p, s in param_sh.items()
                     if s.dim_of("data") is not None}
        self.live: Dict[int, tuple] = {}

    def _groups(self, axes):
        return col.mesh_groups(self.mesh, axes, self.counter, self.rep)

    def _each(self, axes, values, fn, **kw):
        return col.per_id(self.mesh, axes, values, fn, self.counter,
                          self.rep, **kw)

    def _models(self, params, live: bool) -> Dict[int, tfm.Transformer]:
        """id -> the ``Transformer`` over its parameters (``live``: the
        train step's): its shards, the leaves split over "data" (fsdp)
        all-gathered first, at every call; without fsdp built once a
        tree."""
        if self.fsdp:
            params = {i: tfm.tree_map(lambda t: t, params[i])
                      for i in self.ids}
            for path, dim in self.fsdp.items():
                full = self._each(("data",), {i: _at(params[i], path)
                                              for i in self.ids},
                                  col.Group.all_gather, dim=dim)
                for i in self.ids:
                    _put(params[i], path, full[i])
        elif all(self.live.get(i, (None,))[0] is params[i]
                 for i in self.ids):
            return {i: self.live[i][1] for i in self.ids}
        self.live = {i: (params[i], tfm.Transformer(self.local_cfg,
                                                    params[i], live=live))
                     for i in self.ids}
        return {i: m for i, (_, m) in self.live.items()}


class _MeshStep(_MeshRun):
    """The sharded train step (``make_train_step`` on a mesh, and with
    ``pod`` the cross-pod compressed step): ``__call__(state, batch)``
    with ``state`` mesh id -> ``TrainState`` of shards."""

    def __init__(self, cfg: ModelConfig, mesh, rules, seq_len: int,
                 global_batch: int, hyper: dict, ratio: float = 0.0,
                 pod: bool = False, representative: bool = False):
        self.hyper, self.pod = hyper, pod
        self.state_sh = state_shardings(cfg, mesh, rules,
                                        ratio > 0 and not pod)
        if pod:
            self.state_sh = self.state_sh._replace(ef_err=tfm.tree_map(
                lambda s: shd.NamedSharding(mesh, shd.P("pod", *s.spec)),
                self.state_sh.params))
        self.param_sh = dict(_leaf_paths(self.state_sh.params))
        super().__init__(cfg, mesh, rules, self.param_sh, representative)
        shards = self.shards
        if cfg.n_experts and moe_groups(cfg, global_batch, seq_len) != \
                moe_groups(cfg, global_batch // shards, seq_len):
            raise ValueError(
                f"{cfg.name}: a data shard of {global_batch // shards} rows "
                f"x {seq_len} does not hold whole MoE dispatch groups of the "
                f"global batch ({moe_groups(cfg, global_batch, seq_len)} "
                "tokens and capacity a group)")
        # the pod step reduces within a pod; its pods meet in the compressor
        self.grad_axes = tuple(a for a in self.batch_axes
                               if not (pod and a == "pod"))
        self.batch_sh = shd.batch_sharding(
            mesh, rules, with_memory=cfg.family in ("vlm", "audio"))
        self.spec = (compress.make_spec(ratio=ratio, device=mesh.device(
            self.ids[0])) if ratio > 0 else None)
        if self.fsdp and "data" not in self.grad_axes:
            raise ValueError(f"fsdp needs the batch split over 'data' (the "
                             f"global batch {global_batch}, rules {rules})")
        self.partial = set(tfm.tp_partial_leaves(cfg, self.layout)
                           if self.layout else ())
        self.owned = _owned(self.param_sh, mesh, self.ids)

    def _batch(self, batch):
        """The host batch placed: tokens (and a mask) split over the batch
        axes, a vision or audio memory likewise."""
        return _place_batch(batch, self.batch_sh, self.ids)

    def _sums(self, models, batch):
        """id -> its data group's (NLL sum, mask count)."""
        if self.layout is None:
            return {i: tfm.nll_sums(models[i], self.cfg, batch[i])
                    for i in self.ids}
        out = {}
        for g in self._groups(("model",)):
            out.update(zip(g.ids, tfm.tp_nll_sums(
                [models[i] for i in g.ids], self.cfg, self.layout, g,
                [batch[i] for i in g.ids])))
        return out

    def _losses(self, sums):
        """id -> (loss, metrics): the sums added over the gradient axes
        (in the backward each group keeps its own share)."""
        out = {}
        for g in self._groups(self.grad_axes):
            tots = g.sum([sums[i][0] for i in g.ids])
            cnts = g.all_reduce([sums[i][1] for i in g.ids])
            out.update(zip(g.ids, (tfm.mean_loss(t, c)
                                   for t, c in zip(tots, cnts))))
        return out

    def _reduce(self, models):
        """id -> its gradient tree of shards: a leaf held whole but used
        in a split block added over "model", an fsdp leaf reduce-scattered
        over "data", the rest added over the gradient axes and written
        back into the model's gradient (one leaf's reduction alive at a
        time)."""
        grads = {i: models[i].grads for i in self.ids}
        out = {i: tfm.tree_map(lambda t: t, grads[i]) for i in self.ids}
        for path in self.param_sh:
            vals = {i: _at(grads[i], path) for i in self.ids}
            if path in self.partial:
                vals = self._each(("model",), vals, col.Group.all_reduce)
            rest = self.grad_axes
            if path in self.fsdp:
                vals = self._each(("data",), vals, col.Group.reduce_scatter,
                                  dim=self.fsdp[path])
                rest = tuple(a for a in rest if a != "data")
            if rest:
                vals = self._each(rest, vals, col.Group.all_reduce)
            for i in self.ids:
                if path in self.fsdp:
                    _put(out[i], path, vals[i])
                elif vals[i] is not _at(grads[i], path):
                    _at(grads[i], path).copy_(vals[i])
        return out

    def _whole_leaf_compress(self, state, grads):
        """``tree_ef_compress`` of each whole leaf (the JAX step's on its
        global gradients): every id gathers the leaf and its buffer, runs
        the round trip, and keeps its own part."""
        for path, sh in self.param_sh.items():
            g = {i: _at(grads[i], path) for i in self.ids}
            e = {i: _at(state[i].ef_err, path) for i in self.ids}
            for dim, entry in enumerate(sh.spec):
                axes = shd.entry_axes(entry)
                if axes:
                    g = self._each(axes, g, col.Group.all_gather, dim=dim)
                    e = self._each(axes, e, col.Group.all_gather, dim=dim)
            for i in self.ids:
                new_g, new_e = compress.tree_ef_compress(
                    self.spec, {"g": g[i]}, {"g": e[i]},
                    step=state[i].opt.step)
                _put(grads[i], path, sh.part(new_g["g"], i))
                _at(state[i].ef_err, path).copy_(sh.part(new_e["g"], i))

    def _pod_compress(self, state, grads):
        """Each id's own shards compressed with its error feedback, the
        compact blocks averaged over the pods."""
        npod = self.mesh.shape["pod"]
        for g in self._groups(("pod",)):
            errs = [tfm.tree_map(lambda e: e[0], state[i].ef_err)
                    for i in g.ids]
            new_g, new_e = compress.group_ef_compress(
                self.spec, [grads[i] for i in g.ids], errs,
                lambda cs, g=g: [c / npod for c in g.all_reduce(cs)],
                step=state[g.ids[0]].opt.step)
            for k, i in enumerate(g.ids):
                grads[i] = new_g[k]
                tfm.tree_map(lambda buf, e: buf[0].copy_(e),
                             state[i].ef_err, new_e[k])

    def _norms(self, grads):
        """id -> the global norm: each id's owned shards' squared sum,
        added over the whole mesh."""
        parts = [adamw.squared_sum(
            [_at(grads[i], p) for p in self.owned[i]],
            torch.zeros((), device=self.mesh.device(i))) for i in self.ids]
        total = self._groups(self.mesh.axis_names)[0].all_reduce(parts)
        return {i: torch.sqrt(t) for i, t in zip(self.ids, total)}

    def gradients(self, state, batch):
        """(id -> metrics, id -> gradient tree of shards): the loss and
        its gradients over the mesh, reduced as the step reduces them
        before any compression; the state is not changed."""
        placed = self._batch(batch)
        models = self._models({i: state[i].params for i in self.ids}, True)
        for m in models.values():
            m.zero_grad()
        losses = self._losses(self._sums(models, placed))
        torch.autograd.backward([losses[i][0] for i in self.ids])
        with torch.no_grad():
            return ({i: {k: v.detach() for k, v in losses[i][1].items()}
                     for i in self.ids}, self._reduce(models))

    def __call__(self, state, batch):
        metrics, grads = self.gradients(state, batch)
        with torch.no_grad():
            if self.pod:
                self._pod_compress(state, grads)
                npod = self.mesh.shape["pod"]
                for g in self._groups(("pod",)):
                    for key in ("loss", "ppl_proxy"):
                        means = g.all_reduce([metrics[i][key]
                                              for i in g.ids])
                        for i, v in zip(g.ids, means):
                            metrics[i][key] = v / npod
            elif self.spec is not None:
                self._whole_leaf_compress(state, grads)
            norms = self._norms(grads)
            new = {}
            for i in self.ids:
                st = state[i]
                lr = _lr(st.opt.step, self.hyper)
                _, opt, om = adamw.update(
                    grads[i], st.opt, st.params, lr=lr,
                    weight_decay=self.hyper["weight_decay"], norm=norms[i])
                new[i] = TrainState(st.params, opt, st.ef_err)
                metrics[i].update(om)
                metrics[i]["lr"] = lr
        return new, metrics[self.ids[0]]


class _MeshServe(_MeshRun):
    """The sharded prefill or decode step (``make_prefill_step`` /
    ``make_decode_step`` on a mesh): ``__call__(params, cache, batch)``
    with ``params`` and ``cache`` mesh id -> that id's tree of shards
    (``shd.place_tree(tree, bundle.state_shardings[k])``, or
    ``placed_abstract``), ``batch`` a host batch of the global rows,
    placed by the step.  Returns (id -> the logits of its rows (B, 1, V)
    in ``cfg.dtype``, gathered over "model"; the cache, written in
    place); ``out_sharding`` gathers the logits
    (``NamedSharding.gather``); ``models`` holds the last call's
    ``Transformer`` of each id.

    One process drives every id, as the train step does.  The leaves
    the rules split over "data" (fsdp) are all-gathered at each call;
    every id's ``Transformer`` is of ``transformer.local_config`` and the
    ranks of each "model" group run ``transformer.tp_serve``.  Where the
    global batch is smaller than the data-parallel shards (``seq_shard``:
    the batch replicated), each cache's ``kv_seq`` is split over "data"
    and a decode token's attention is combined over the data groups;
    where a data shard does not hold whole MoE dispatch groups of the
    global call, the MoE blocks' input is gathered over the batch axes."""

    def __init__(self, cfg: ModelConfig, mesh, rules, mode: str,
                 seq_len: int, global_batch: int,
                 representative: bool = False):
        self.param_sh = shd.sharding_tree(tfm.param_axes(cfg), mesh, rules)
        super().__init__(cfg, mesh, rules, dict(_leaf_paths(self.param_sh)),
                         representative)
        self.cache_sh = shd.sharding_tree(tfm.cache_axes(cfg), mesh, rules)
        self.batch_sh = shd.batch_sharding(
            mesh, rules, with_memory=cfg.family in ("vlm", "audio"),
            mode=mode)
        self.out_sharding = shd.NamedSharding(
            mesh, shd.P(rules["batch"], None, None))
        tokens = seq_len if mode == "prefill" else 1
        self.seq_axes = ("data",) if rules["kv_seq"] == "data" else None
        self.row_axes = (self.batch_axes if cfg.n_experts and moe_groups(
            cfg, global_batch, tokens) != moe_groups(
                cfg, global_batch // self.shards, tokens) else None)
        self.models: Dict[int, tfm.Transformer] = {}

    def _all(self, axes) -> col.Groups:
        return col.Groups(self._groups(axes), self.ids)

    def __call__(self, params, cache, batch):
        placed = _place_batch(batch, self.batch_sh, self.ids)
        with torch.no_grad():
            models = self.models = self._models(params, False)
            logits = tfm.tp_serve(
                [models[i] for i in self.ids], self.cfg, self.layout,
                self._all(("model",)), [cache[i] for i in self.ids],
                [placed[i] for i in self.ids],
                self._all(self.seq_axes) if self.seq_axes else None,
                self._all(self.row_axes) if self.row_axes else None)
        return dict(zip(self.ids, logits)), cache


def _serve_bundle(cfg: ModelConfig, mesh, mode: str, seq_len: int,
                  global_batch: int, fsdp: bool,
                  representative: bool) -> StepBundle:
    """The JAX serve steps' rules (``seq_shard`` where the global batch is
    smaller than the data-parallel shards) and a ``_MeshServe``."""
    seq_shard = global_batch < int(np.prod(
        [mesh.shape[a] for a in shd.dp_axes(mesh)]))
    rules = shd.make_rules(mesh, cfg, fsdp=fsdp, seq_shard=seq_shard,
                           global_batch=global_batch)
    run = _MeshServe(cfg, mesh, rules, mode, seq_len, global_batch,
                     representative)
    return StepBundle(run, (run.param_sh, run.cache_sh), run.batch_sh,
                      (_meta_params(cfg), tfm.init_cache(
                          cfg, global_batch, seq_len, device="meta")),
                      input_specs(cfg, seq_len, global_batch, mode),
                      run.counter)


def make_prefill_step(cfg: ModelConfig, mesh=None, *, seq_len: int,
                      global_batch: int, fsdp: bool = False,
                      representative: bool = False) -> StepBundle:
    """Without a mesh: ``fn(model, cache, batch) -> (logits, cache)``,
    ``model.prefill`` of batch {"tokens", optional "memory"} (``model``:
    a ``Transformer``).  On a ("data", "model") or ("pod", "data",
    "model") mesh: the JAX step's sharding, ``fn(params, cache, batch)``
    (``_MeshServe``), ``state_shardings`` (parameters, cache).
    ``abstract_state``: (parameters, cache) as ``meta`` tensors.
    ``representative``: ``make_train_step``'s."""
    if mesh is not None:
        return _serve_bundle(cfg, mesh, "prefill", seq_len, global_batch,
                             fsdp, representative)

    def fn(model, cache, batch):
        logits, cache, _memory = model.prefill(cache, batch["tokens"],
                                               batch.get("memory"))
        return logits, cache

    return StepBundle(fn, None, None, (_meta_params(cfg), tfm.init_cache(
        cfg, global_batch, seq_len, device="meta")),
        input_specs(cfg, seq_len, global_batch, "prefill"))


def make_decode_step(cfg: ModelConfig, mesh=None, *, seq_len: int,
                     global_batch: int, fsdp: bool = False,
                     representative: bool = False) -> StepBundle:
    """One token against a cache of ``seq_len``: without a mesh
    ``fn(model, cache, batch) -> (logits, cache)``, ``model.decode_step``
    of batch {"token" (B, 1), "pos" (B,), optional encoded "memory"}; on
    a mesh as ``make_prefill_step``'s."""
    if mesh is not None:
        return _serve_bundle(cfg, mesh, "decode", seq_len, global_batch,
                             fsdp, representative)

    def fn(model, cache, batch):
        return model.decode_step(cache, batch["token"], batch["pos"],
                                 batch.get("memory"))

    return StepBundle(fn, None, None, (_meta_params(cfg), tfm.init_cache(
        cfg, global_batch, seq_len, device="meta")),
        input_specs(cfg, seq_len, global_batch, "decode"))
