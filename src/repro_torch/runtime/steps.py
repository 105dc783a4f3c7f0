"""Step functions: the train step with its state, and thin prefill and
decode wrappers, at the JAX package's ``runtime/steps.py`` names.

One card, no partitioner: the step runs on one device, its state plain
tensors updated in place (the JAX step's buffer donation); ``fsdp`` is
accepted and does nothing.  The shardings the JAX steps are built with
are here for the dry run: ``state_shardings`` (the train state's, the JAX
``_state_shardings``), from the logical axes and ``runtime/sharding.py``'s
rules.

The step's order is the JAX step's: ``loss_fn`` and its gradients (a live
``Transformer`` over the state's parameters, remat as the config asks),
then the error-feedback butterfly compression of the gradients where
``grad_compress_ratio`` > 0, the warmup-cosine learning rate at the
optimizer's step, and the AdamW update.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw, compress
from repro_torch.runtime import sharding as shd


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    ef_err: Optional[Any] = None  # error-feedback buffers (compression on)


class StepBundle(NamedTuple):
    """A step function and the shapes of what it takes: ``abstract_state``
    and ``abstract_batch`` hold tensors on the ``meta`` device (the JAX
    bundle's ``ShapeDtypeStruct``s)."""
    fn: Callable
    abstract_state: Any
    abstract_batch: Any


def state_shardings(cfg: ModelConfig, mesh, rules) -> TrainState:
    """The train state's ``NamedSharding`` tree on ``mesh`` (the JAX
    ``_state_shardings`` without compression): the parameters' by their
    logical axes, the moments the parameters', the step replicated."""
    axes = tfm.param_axes(cfg)
    return TrainState(shd.sharding_tree(axes, mesh, rules),
                      shd.sharding_tree(adamw.state_axes(axes), mesh, rules))


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


def make_train_step(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                    fsdp: bool = False, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1,
                    grad_compress_ratio: float = 0.0,
                    moment_dtype=torch.float32, device="cuda"
                    ) -> StepBundle:
    """``fn(state, batch) -> (state, metrics)``: one training step on
    ``device``, the JAX ``make_train_step``'s.  The state's parameters,
    moments and step are updated in place (the JAX step donates them);
    the returned state holds the same tensors and the new error-feedback
    buffers.  ``metrics``: 0-d tensors ``loss``, ``ppl_proxy``,
    ``grad_norm`` and ``lr`` (no host read).

    ``fsdp`` is accepted for the JAX signature and does nothing: one card
    holds the whole state, there is no data axis to shard it over."""
    del fsdp
    dev = torch.device(device)
    use_comp = grad_compress_ratio > 0
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
            lr = adamw.warmup_cosine(state.opt.step, peak_lr=peak_lr,
                                     warmup=warmup, total=total_steps)
            _, new_opt, om = adamw.update(grads, state.opt, state.params,
                                          lr=lr, weight_decay=weight_decay)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr"] = lr
        return TrainState(state.params, new_opt, ef_err), metrics

    return StepBundle(step,
                      abstract_train_state(cfg, use_comp, moment_dtype),
                      input_specs(cfg, seq_len, global_batch, "train"))


def make_pod_compressed_train_step(cfg: ModelConfig, *args, **kwargs):
    """The JAX package's cross-pod step reduces compressed gradients over
    a ``pod`` mesh axis; the port runs no sharded step.  Not ported
    (ROADMAP A6d-2, the sharded execution)."""
    raise NotImplementedError(
        "make_pod_compressed_train_step needs a pod axis across cards "
        "(ROADMAP A6d-2, the sharded execution); use make_train_step "
        "with grad_compress_ratio for compression on one card")


def make_prefill_step(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                      fsdp: bool = False) -> StepBundle:
    """``fn(model, cache, batch) -> (logits, cache)``: ``model.prefill``
    of batch {"tokens", optional "memory"} (``model``: a
    ``Transformer``).  ``abstract_state``: (parameters, cache) as
    ``meta`` tensors."""
    del fsdp

    def fn(model, cache, batch):
        logits, cache, _memory = model.prefill(cache, batch["tokens"],
                                               batch.get("memory"))
        return logits, cache

    return StepBundle(fn, (_meta_params(cfg), tfm.init_cache(
        cfg, global_batch, seq_len, device="meta")),
        input_specs(cfg, seq_len, global_batch, "prefill"))


def make_decode_step(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                     fsdp: bool = False) -> StepBundle:
    """``fn(model, cache, batch) -> (logits, cache)``: one token against
    a cache of ``seq_len``, ``model.decode_step`` of batch {"token" (B, 1),
    "pos" (B,), optional encoded "memory"}."""
    del fsdp

    def fn(model, cache, batch):
        return model.decode_step(cache, batch["token"], batch["pos"],
                                 batch.get("memory"))

    return StepBundle(fn, (_meta_params(cfg), tfm.init_cache(
        cfg, global_batch, seq_len, device="meta")),
        input_specs(cfg, seq_len, global_batch, "decode"))
