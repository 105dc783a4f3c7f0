"""LM assembly of every family of the configs.

The decoder stack is organized into *groups* of identical super-layers,
as in the JAX package:

  family        groups (super-layer contents)
  dense         [L x (attn + mlp)]
  moe           [L x (attn + moe)]
  local_global  [L/2 x (local-attn + mlp + global-attn + mlp)]  (gemma2)
  hybrid (rrl)  [L/3 x (rglru+mlp, rglru+mlp, local-attn+mlp)]
                + the remainder as rglru+mlp layers (recurrentgemma)
  ssm           [L x ssd]                                        (mamba2)
  vlm (cross5)  [L/5 x (4 x (attn+mlp) + cross-attn + mlp)]
  audio         encoder [Lenc x (bidirectional attn + mlp)], then
                decoder [L x (attn + cross-attn + mlp)]

Parameters are a nested dict of tensors in the JAX ``init_params``
layout, stacked per group on a leading layer axis (``init_params``,
``interop.lm_params_from_numpy``).  ``Transformer`` splits the stacked
leaves into one module per super-layer (views, no copy) and serves:

  Transformer(cfg, params).forward(tokens, memory)   -> logits (B, S, V)
  init_cache(cfg, batch, max_len)                    -> cache
  Transformer.prefill(cache, tokens, memory)         -> (last logits, cache,
                                                        memory)
  Transformer.decode_step(cache, token, pos, memory) -> (logits, cache)

``memory`` is the vision family's patch embeddings (B, P, D) or the
audio family's frame embeddings (B, F, D); ``prefill`` returns it in the
compute dtype, encoded for audio, for the decode steps to reuse.
Caches are written in place (and returned, as the JAX functions return
theirs).  Layers run in a Python loop (no ``lax.scan``).

Training (the JAX ``loss_fn`` under ``jax.value_and_grad``):

  model = Transformer(cfg, params, live=True)
  loss_fn(model, cfg, batch, remat, loss_chunk)      -> (loss, metrics)
  value_and_grad(model, cfg, batch, ...)             -> ((loss, metrics),
                                                        model.grads)

A live model casts its weights in the graph at every call and collects
the gradients in ``model.grads``, in the stacked layout of ``params``;
``remat`` checkpoints the layers as the JAX ``_scan_group`` does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (ATTN_AXES, CROSS_AXES, MLP_AXES, MOE_AXES, RGLRU_AXES,
                     SSD_AXES, AttnBlock, CrossAttnBlock, MLPBlock, MoEBlock,
                     RGLRUBlock, SSDBlock, attn_spec, cross_attn_spec,
                     mlp_spec, moe_spec, rglru_spec, ssd_spec)
from .common import (PAD_POS, Axes, ModelConfig, RankConfig, checkpointed,
                     combine_partials, rmsnorm, scaled, softcap)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Group structure per family
# ---------------------------------------------------------------------------

def group_plan(cfg: ModelConfig):
    """Returns [(group_name, super_layer_count)] for the decoder stack."""
    pat = cfg.layer_pattern
    if pat == "global":
        return [("dense" if cfg.n_experts == 0 else "moe", cfg.n_layers)]
    if pat == "local_global":
        assert cfg.n_layers % 2 == 0
        return [("lg", cfg.n_layers // 2)]
    if pat == "rrl":
        main, rem = divmod(cfg.n_layers, 3)
        plan = [("rrl", main)]
        if rem:
            plan.append(("rec_extra", rem))
        return plan
    if pat == "cross5":
        assert cfg.n_layers % 5 == 0
        return [("cross5", cfg.n_layers // 5)]
    if pat == "ssm":
        return [("ssd", cfg.n_layers)]
    if pat == "encdec":
        return [("dec", cfg.n_layers)]
    raise ValueError(pat)


class Leaf(NamedTuple):
    shape: tuple
    init: str          # "normal" | "zeros" | "ones"
    scale: float = 0.02
    axes: tuple = ()   # logical axis names, one a dimension


#: block kind -> (module, spec, axes); a key is matched by its prefix
_BLOCKS = {"attn": (AttnBlock, attn_spec, ATTN_AXES),
           "mlp": (MLPBlock, mlp_spec, MLP_AXES),
           "moe": (MoEBlock, moe_spec, MOE_AXES),
           "rec": (RGLRUBlock, rglru_spec, RGLRU_AXES),
           "cross": (CrossAttnBlock, cross_attn_spec, CROSS_AXES),
           "ssd": (SSDBlock, ssd_spec, SSD_AXES)}

#: group -> its super-layer's blocks, in the JAX ``_init_group`` order
_GROUPS = {
    "dense": ("attn", "mlp"),
    "moe": ("attn", "moe"),
    "lg": ("attn_l", "mlp_l", "attn_g", "mlp_g"),
    "rrl": ("rec1", "mlp1", "rec2", "mlp2", "attn", "mlp3"),
    "rec_extra": ("rec", "mlp"),
    "cross5": ("attn0", "mlp0", "attn1", "mlp1", "attn2", "mlp2", "attn3",
               "mlp3", "cross", "mlp_c"),
    "ssd": ("ssd",),
    "enc": ("attn", "mlp"),
    "dec": ("attn", "cross", "mlp"),
}


def _kind(key: str) -> str:
    return next(k for k in ("cross", "attn", "mlp", "moe", "rec", "ssd")
                if key.startswith(k))


def _group_spec(name: str, cfg: ModelConfig) -> Dict[str, Any]:
    """A super-layer's blocks as ``Leaf``s, each with its axes."""
    out = {}
    for key in _GROUPS[name]:
        _module, spec, axes = _BLOCKS[_kind(key)]
        out[key] = {k: Leaf(*entry)._replace(axes=axes[k])
                    for k, entry in spec(cfg).items()}
    return out


def _stacked(count: int, spec) -> Dict[str, Any]:
    """A group's leaves stacked on a leading "layers" axis."""
    return {blk: {k: leaf._replace(shape=(count,) + leaf.shape,
                                   axes=("layers",) + leaf.axes)
                  for k, leaf in leaves.items()}
            for blk, leaves in spec.items()}


def param_spec(cfg: ModelConfig) -> Params:
    """The parameter tree as ``Leaf``s: the JAX ``init_params`` tree's
    structure, shapes (stacked per group), initializers and logical
    axes."""
    d, v = cfg.d_model, cfg.vocab
    out = {"embed": Leaf((v, d), "normal", 0.01, ("vocab", "embed")),
           "final_norm": Leaf((d,), "zeros", axes=(None,)),
           "lm_head": Leaf((d, v), "normal", 0.01, ("embed", "vocab")),
           "groups": {name: _stacked(count, _group_spec(name, cfg))
                      for name, count in group_plan(cfg)}}
    if cfg.is_encdec:
        out["encoder"] = _stacked(cfg.n_enc_layers, _group_spec("enc", cfg))
        out["enc_norm"] = Leaf((d,), "zeros", axes=(None,))
    return out


def param_axes(cfg: ModelConfig) -> Params:
    """The parameters' logical axes as a tree of ``Axes`` (the JAX
    ``init_params(cfg, mode="axes")`` tree)."""
    return tree_map(lambda leaf: Axes(leaf.axes), param_spec(cfg))


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts (``rest``: trees of the same
    structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", place=None) -> Params:
    """Random parameters with the JAX package's distributions: normal x
    0.02, the embedding and the LM head x 0.01, the convolutions x 0.2,
    norms, biases, gates, SSD ``a_log``/``dt_bias`` zero, SSD ``d_skip``
    and RG-LRU ``lam`` one,
    drawn in f32 from ``generator`` (default: seed 0 on ``device``) and
    stored in ``cfg.param_dtype``.  The draws are torch's, not
    ``jax.random``'s: carry weights across with
    ``interop.lm_params_from_numpy`` to compare the two packages.

    ``place``: a tree of ``NamedSharding``s; each leaf is split into its
    shards (``NamedSharding.shard``) as soon as it is drawn, so that no
    more than one whole leaf is held: the tree's leaves are then
    {mesh id: shard}."""
    dev = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(leaf: Leaf, sharding=None):
        if leaf.init in ("zeros", "ones"):
            fill = torch.zeros if leaf.init == "zeros" else torch.ones
            t = fill(leaf.shape, dtype=cfg.param_dtype, device=dev)
        else:
            t = torch.randn(leaf.shape, generator=generator,
                            dtype=torch.float32, device=dev)
            t = t.mul_(leaf.scale).to(cfg.param_dtype)
        return t if sharding is None else sharding.shard(t)

    spec = param_spec(cfg)
    return (tree_map(draw, spec) if place is None
            else tree_map(draw, spec, place))


def _check_tree(params: Params, spec: Params, path: str = "") -> None:
    if isinstance(spec, dict):
        if not isinstance(params, dict) or set(params) != set(spec):
            got = sorted(params) if isinstance(params, dict) else params
            raise ValueError(f"parameters at {path or 'the root'}: keys "
                             f"{got}, want {sorted(spec)}")
        for k in spec:
            _check_tree(params[k], spec[k], f"{path}.{k}" if path else k)
    elif tuple(params.shape) != tuple(spec.shape):
        raise ValueError(f"parameter {path}: shape {tuple(params.shape)}, "
                         f"want {spec.shape}")


def _layer(tree, index: int):
    return tree_map(lambda t: t[index], tree)


def _local(name: str, key: str) -> bool:
    """Whether attention block ``key`` of group ``name`` is local."""
    return key == "attn_l" or name == "rrl"


#: the blocks that keep a decode cache
_CACHED = ("attn", "rec", "ssd")


class SuperLayer(nn.Module):
    """One super-layer of a group (``_GROUPS``), its blocks run in the
    JAX ``_super_layer`` order.  ``forward(x, positions, cache, memory,
    tiles)``: ``cache`` is this layer's part of the group's cache (None:
    no cache), ``memory`` the cross-attention blocks' memory in the
    compute dtype, ``tiles`` the forward's tile tables (``attention``)."""

    def __init__(self, name: str, cfg: ModelConfig, w: Params,
                 live: bool = False):
        super().__init__()
        self.name, self.cfg = name, cfg
        for key, leaves in w.items():
            self.add_module(key, _BLOCKS[_kind(key)][0](cfg, leaves, live))

    def forward(self, x, positions, cache=None, memory=None, tiles=None):
        for key in _GROUPS[self.name]:
            x = self.run_block(key, x, positions, cache, memory, tiles)
        return x

    def run_block(self, key: str, x, positions, cache=None, memory=None,
                  tiles=None):
        """Block ``key`` on ``x``, with its residual (``forward``'s
        arguments)."""
        block, kind = getattr(self, key), _kind(key)
        c = None if cache is None or kind not in _CACHED else cache[key]
        if kind == "attn":
            window = self.cfg.local_window if _local(self.name, key) else 0
            return block(x, positions, window=window,
                         causal=self.name != "enc", cache=c, tiles=tiles)[0]
        if kind in ("rec", "ssd"):
            return block(x, c)[0]
        if kind == "cross":
            return block(x, memory)
        return block(x)


def _stack(layers, spec: Params, device, dtype) -> Params:
    """The per-layer trees of a group stacked on a leading axis (a group
    of no layers: empty tensors of the spec's shapes)."""
    if not layers:
        return tree_map(lambda leaf: torch.empty(leaf.shape, dtype=dtype,
                                                 device=device), spec)
    return tree_map(lambda *ts: torch.stack(ts), *layers)


def remat_layers(steps, xs: tuple, extra: tuple, remat: bool,
                 block: int) -> tuple:
    """``steps`` in order, each ``step(*xs, *extra) -> xs`` (a tuple of
    activations; ``extra`` inputs every step reads).  With ``remat``:
    where ``block`` = k > 1 divides their count, nested checkpoints, one
    a run of k steps and one each step inside it; otherwise one
    checkpoint a step."""
    if not remat:
        for step in steps:
            xs = step(*xs, *extra)
        return xs
    k = max(int(block), 1)
    if k > 1 and len(steps) % k == 0:
        def run_of(sub):
            def run(*args):
                xc, ex = args[:len(xs)], args[len(xs):]
                for step in sub:
                    xc = checkpointed(step, *xc, *ex)
                return xc
            return run

        steps = [run_of(steps[j:j + k]) for j in range(0, len(steps), k)]
    for step in steps:
        xs = checkpointed(step, *xs, *extra)
    return xs


class Transformer(nn.Module):
    """The LM over a parameter tree (see the module docstring).  The
    tree's tensors are kept (the per-layer parameters are views of the
    stacked leaves).

    Serving (``live=False``): the compute-dtype copies are made once
    here, and the embedding is gathered in ``param_dtype`` and cast per
    row, which is bitwise the JAX package's cast of the whole table on
    every call.

    Training (``live=True``): the parameters take gradients and every
    weight is cast in the graph from the live parameter at every call,
    the embedding table cast whole and then gathered (the JAX order, so
    that a repeated token's gradient adds in the compute dtype).  The
    gradients land in ``grads``, a tree of the stacked layout beside
    ``params`` (each parameter's ``.grad`` is a view of it, added into in
    place: no restacking); ``zero_grad`` zeroes it.  The optimizer
    updates ``params`` in place and the model sees the new values."""

    def __init__(self, cfg: ModelConfig, params: Params, live: bool = False):
        super().__init__()
        spec = param_spec(cfg)
        _check_tree(params, spec)
        self.cfg = cfg
        self.live = live
        self.plan = group_plan(cfg)
        self._spec = spec
        self._singles = ["embed", "final_norm", "lm_head"]
        if cfg.is_encdec:
            self._singles.append("enc_norm")
        for name in self._singles:
            self.register_parameter(name, nn.Parameter(params[name],
                                                       requires_grad=live))
        self.groups = nn.ModuleDict({
            name: nn.ModuleList(SuperLayer(name, cfg,
                                           _layer(params["groups"][name], i),
                                           live)
                                for i in range(count))
            for name, count in self.plan})
        self.encoder = nn.ModuleList(
            SuperLayer("enc", cfg, _layer(params["encoder"], i), live)
            for i in range(cfg.n_enc_layers if cfg.is_encdec else 0))
        #: a cross-attention block needs the request's memory
        self.needs_memory = any("cross" in _GROUPS[name]
                                for name, _ in self.plan)
        self.c_lm_head = None if live else self.lm_head.to(cfg.dtype)
        self.params = params if live else None
        self.grads = None
        if live:
            self._bind_grads()

    def _stacked_params(self):
        """(stacked tree path, layer index or None, parameter) of every
        parameter: the tree leaf a parameter is (a view of)."""
        for name in self._singles:
            yield (name,), None, getattr(self, name)
        stacks = [(("groups", name), self.groups[name])
                  for name, _ in self.plan]
        if self.cfg.is_encdec:
            stacks.append((("encoder",), self.encoder))
        for path, layers in stacks:
            for i, layer in enumerate(layers):
                for key, blk in layer.named_children():
                    for leaf, p in blk.named_parameters(recurse=False):
                        yield path + (key, leaf), i, p

    def _bind_grads(self) -> None:
        self.grads = tree_map(torch.zeros_like, self.params)
        for path, i, p in self._stacked_params():
            g = self.grads
            for k in path:
                g = g[k]
            p.grad = g if i is None else g[i]

    def zero_grad(self, set_to_none: bool = False) -> None:
        """Zero ``grads`` in place (the parameters' ``.grad`` stay views
        of it)."""
        tree_map(lambda g: g.zero_(), self.grads)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def params_tree(self) -> Params:
        """The parameters as the stacked tree they came from (a copy)."""
        def stacked(layers, spec):
            return _stack([{key: {k: p.detach() for k, p in
                                  blk.named_parameters(recurse=False)}
                            for key, blk in layer.named_children()}
                           for layer in layers], spec, self.device,
                          self.cfg.param_dtype)

        out = {name: getattr(self, name).detach().clone()
               for name in ("embed", "final_norm", "lm_head")}
        out["groups"] = {name: stacked(self.groups[name],
                                       self._spec["groups"][name])
                         for name, _count in self.plan}
        if self.cfg.is_encdec:
            out["encoder"] = stacked(self.encoder, self._spec["encoder"])
            out["enc_norm"] = self.enc_norm.detach().clone()
        return out

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.live:   # the JAX order: cast the table, then gather
            x = self.embed.to(self.cfg.dtype)[tokens]
        else:
            x = self.embed[tokens].to(self.cfg.dtype)
        return scaled(x, math.sqrt(self.cfg.d_model))

    def _head(self) -> torch.Tensor:
        return self.c_lm_head if not self.live else self.lm_head.to(
            self.cfg.dtype)

    def _stack_run(self, layers, x, positions, cache=None, memory=None,
                   remat: bool = False, tiles=None):
        """One group's layers in order (the JAX ``_scan_group``), with
        ``remat`` (and no cache) under ``remat_layers``' checkpoints.
        ``tiles``: the forward's tile tables, shared by its layers."""
        if cache is not None:
            for i, layer in enumerate(layers):
                x = layer(x, positions, _layer(cache, i), memory, tiles)
            return x

        def one(layer):
            def run(xc, pos, mem):
                return (layer(xc, pos, None, mem, tiles),)
            return run

        return remat_layers([one(layer) for layer in layers], (x,),
                            (positions, memory), remat,
                            self.cfg.remat_block)[0]

    def _layers(self, x, positions, cache=None, memory=None,
                remat: bool = False, tiles=None):
        for name, _count in self.plan:
            x = self._stack_run(self.groups[name], x, positions,
                                None if cache is None else cache[name],
                                memory, remat, tiles)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_norm, self.cfg.rms_eps)
        return softcap(x @ self._head(), self.cfg.logit_softcap)

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return torch.arange(s, dtype=torch.int32,
                            device=self.device)[None].expand(b, s)

    def encode(self, frames, remat: bool = False) -> torch.Tensor:
        """The audio encoder: a bidirectional stack over frame embeddings
        (B, F, D), then ``enc_norm``; the memory in the compute dtype."""
        x = torch.as_tensor(frames, device=self.device).to(self.cfg.dtype)
        x = self._stack_run(self.encoder, x, self._positions(*x.shape[:2]),
                            remat=remat, tiles={})
        return rmsnorm(x, self.enc_norm, self.cfg.rms_eps)

    def _memory(self, memory, encoded: bool = False, remat: bool = False):
        """The memory the cross-attention blocks read, in the compute
        dtype: the audio frames encoded unless ``encoded``."""
        if memory is None:
            if self.needs_memory:
                raise ValueError(f"{self.cfg.name} (family "
                                 f"{self.cfg.family!r}) needs a memory")
            return None
        if self.cfg.is_encdec and not encoded:
            return self.encode(memory, remat)
        return torch.as_tensor(memory, device=self.device).to(self.cfg.dtype)

    def forward_hidden(self, tokens, memory=None,
                       remat: bool = False) -> torch.Tensor:
        """Final-normed hidden states (B, S, D) of tokens (B, S).
        ``remat``: checkpoint the layers (``_stack_run``), for a
        training forward."""
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        x = self._layers(self._embed(tokens), self._positions(b, s),
                         memory=self._memory(memory, remat=remat),
                         remat=remat, tiles={})
        return rmsnorm(x, self.final_norm, self.cfg.rms_eps)

    def forward(self, tokens, memory=None, remat: bool = False
                ) -> torch.Tensor:
        """Logits (B, S, V) in ``cfg.dtype`` of tokens (B, S) (and, for
        the vision and audio families, their memory (B, P, D))."""
        x = self.forward_hidden(tokens, memory, remat)
        return softcap(x @ self._head(), self.cfg.logit_softcap)

    def prefill(self, cache, tokens, memory=None):
        """Run a prompt (B, S) and write it into ``cache`` (the tail where
        a cache is shorter than the prompt).  Returns the last position's
        logits (B, 1, V), the cache and the memory the decode steps take
        (encoded for audio; None where the family has none)."""
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        memory = self._memory(memory)
        x = self._layers(self._embed(tokens), self._positions(b, s), cache,
                         memory)
        return self._logits(x[:, -1:]), cache, memory

    def decode_step(self, cache, token, pos, memory=None):
        """One-token decode: token (B, 1), pos (B,) int, ``memory`` as
        ``prefill`` returned it.  Local-attention caches are ring buffers
        indexed by pos % len."""
        token = self._tokens(token)
        positions = torch.as_tensor(pos, device=self.device).to(
            torch.int32)[:, None]
        x = self._layers(self._embed(token), positions, cache,
                         self._memory(memory, encoded=True))
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

_LOSS_CHUNK = 1024


def _chunk_nll(cap, head, xx, tt, mm):
    """One chunk's masked NLL sum and mask count: the projection in the
    compute dtype, softcap, f32 log-softmax, the targets' entries."""
    logits = softcap(xx @ head.to(xx.dtype), cap).float()
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, tt[..., None])[..., 0]
    return (nll * mm).sum(), mm.sum()


def _model(model, cfg: ModelConfig) -> "Transformer":
    return (model if isinstance(model, Transformer)
            else Transformer(cfg, model, live=True))


def _shifted(x, tokens, mask, loss_chunk: int):
    """The hidden states (B, S, D) shifted against their targets and
    zero-padded to a multiple of the chunk: (x, targets, mask, chunk,
    padded length)."""
    b, s = tokens.shape
    mask = (torch.ones((b, s), device=x.device) if mask is None else
            torch.as_tensor(mask, device=x.device).float())
    x, targets, mask = x[:, :-1], tokens[:, 1:], mask[:, 1:]
    sm = s - 1
    c = min(loss_chunk, sm)
    pad = (-sm) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    return x, targets, mask, c, sm + pad


def _chunk_sums(chunk_nll, heads, shifted) -> list:
    """The loss's chunk loop over the ranks' shifted hidden states
    (``_shifted``, one a rank): ``chunk_nll(*heads, *xs, *targets,
    *masks)`` of one chunk under a checkpoint gives each rank's (sum,
    count), flat.  Returns each rank's (sum, count)."""
    c, length = shifted[0][3], shifted[0][4]
    sums = [(torch.zeros((), device=sh[0].device),) * 2 for sh in shifted]
    for i in range(0, length, c):
        got = checkpointed(chunk_nll, *heads, *(sh[k][:, i:i + c]
                                                for k in range(3)
                                                for sh in shifted))
        sums = [(tot + got[2 * r], cnt + got[2 * r + 1])
                for r, (tot, cnt) in enumerate(sums)]
    return sums


def nll_sums(model, cfg: ModelConfig, batch: Dict[str, Any],
             remat: bool = True, loss_chunk: int = _LOSS_CHUNK):
    """``loss_fn``'s masked NLL sum and mask count over the batch, before
    the division: (sum, count), 0-d f32 tensors.  A data-parallel step
    adds them over its shards first (a mean of per-shard means is
    another function)."""
    model = _model(model, cfg)
    x = model.forward_hidden(batch["tokens"], batch.get("memory"), remat)
    shifted = _shifted(x, model._tokens(batch["tokens"]), batch.get("mask"),
                       loss_chunk)
    return _chunk_sums(functools.partial(_chunk_nll, cfg.logit_softcap),
                       [model.lm_head], [shifted])[0]


def mean_loss(tot: torch.Tensor, cnt: torch.Tensor):
    """(loss, {"loss", "ppl_proxy"}) of an NLL sum and its mask count."""
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"loss": loss,
                  "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}


def loss_fn(model, cfg: ModelConfig, batch: Dict[str, Any],
            remat: bool = True, loss_chunk: int = _LOSS_CHUNK):
    """Next-token NLL, the JAX ``loss_fn``: hidden state t predicts token
    t + 1, weighted by ``batch["mask"]`` (default all ones), over chunks
    of ``loss_chunk`` positions (the sequence zero-padded to a multiple),
    each chunk's projection, softcap, f32 log-softmax and gather under a
    checkpoint, so that the (B, S, V) f32 logits are never held whole.

    ``model``: a live ``Transformer`` or a parameter tree (a live model
    is built over it); ``batch``: {"tokens" (B, S), optional "memory",
    "mask" (B, S)}.  Returns (loss, {"loss", "ppl_proxy"}), 0-d f32
    tensors on the model's device."""
    return mean_loss(*nll_sums(model, cfg, batch, remat, loss_chunk))


def value_and_grad(model, cfg: ModelConfig, batch: Dict[str, Any],
                   remat: bool = True, loss_chunk: int = _LOSS_CHUNK):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads) with ``grads`` the live model's gradient tree (the stacked
    parameter layout; zeroed, then filled by the backward).  ``model``:
    a live ``Transformer`` or a parameter tree."""
    model = _model(model, cfg)
    if not model.live:
        raise ValueError("gradients need a live Transformer "
                         "(Transformer(cfg, params, live=True))")
    model.zero_grad()
    loss, metrics = loss_fn(model, cfg, batch, remat, loss_chunk)
    loss.backward()
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            model.grads)


# ---------------------------------------------------------------------------
# Tensor and expert parallelism over a "model" group (every block kind)
# ---------------------------------------------------------------------------

class TPLayout(NamedTuple):
    """Which dimensions the mesh's rules split over "model", as the JAX
    ``spec_for`` splits the leaves (the first logical axis of a leaf
    claims the mesh axis): query heads (then the attention and
    cross-attention blocks are tensor parallel), KV heads (else every
    rank holds them all and reads the ones its query heads use), the
    dense MLPs' ``ff``, the vocabulary (embedding rows, LM-head columns),
    the MoE experts (expert parallelism), each expert's ``ff`` where the
    experts do not divide the axis and ``ff`` does (each expert
    Megatron-split), and the SSD and RG-LRU ``inner`` widths.  A block
    whose dimension is not split is computed whole on every rank and
    summed nowhere."""
    heads: bool
    kv_heads: bool
    ff: bool
    vocab: bool
    expert: bool = False
    expert_ff: bool = False
    inner: bool = False


def tp_layout(rules) -> TPLayout:
    on = {a: rules.get(a) == "model"
          for a in ("heads", "kv_heads", "ff", "vocab", "expert", "inner")}
    return TPLayout(on["heads"], on["kv_heads"], on["ff"], on["vocab"],
                    on["expert"], on["ff"] and not on["expert"], on["inner"])


def local_config(cfg: ModelConfig, layout: TPLayout, tp: int) -> RankConfig:
    """The config of one rank's parameters: the split counts over ``tp``
    (heads, KV heads, the dense or expert ``ff``, the vocabulary), the
    head width and ``d_model`` kept, and the parts the SSD and RG-LRU
    widths (``inner_parts``) and the experts (``expert_parts``) are cut
    into."""
    def part(n: int, split: bool) -> int:
        return n // tp if split else n

    ff = layout.expert_ff if cfg.n_experts else layout.ff
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(head_dim=cfg.hd,
                  n_heads=part(cfg.n_heads, layout.heads),
                  n_kv_heads=part(cfg.n_kv_heads, layout.kv_heads),
                  d_ff=part(cfg.d_ff, ff), vocab=part(cfg.vocab, layout.vocab))
    return RankConfig(**fields, inner_parts=tp if layout.inner else 1,
                      expert_parts=tp if layout.expert else 1)


def kv_select(cfg: ModelConfig, layout: TPLayout, tp: int, rank: int,
              device) -> Optional[torch.Tensor]:
    """The KV heads rank ``rank``'s query heads read, where the query
    heads are split and the KV heads are not (GQA with fewer KV heads
    than ranks): the distinct heads where each serves an equal run of
    the rank's query heads, else one a query head.  None: nothing to
    select."""
    if layout is None or not layout.heads or layout.kv_heads:
        return None
    hl, rep = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv_heads
    idx = [(rank * hl + j) // rep for j in range(hl)]
    uniq = sorted(set(idx))
    if hl % len(uniq) == 0 and idx == [u for u in uniq
                                        for _ in range(hl // len(uniq))]:
        idx = uniq
    return torch.tensor(idx, dtype=torch.long, device=device)


def _split(kind: str, layout: Optional[TPLayout]) -> bool:
    """Whether the blocks of ``kind`` are split over "model" (no layout:
    a model axis of 1, nothing split)."""
    if layout is None:
        return False
    return {"attn": layout.heads, "cross": layout.heads, "mlp": layout.ff,
            "moe": layout.expert or layout.expert_ff, "ssd": layout.inner,
            "rec": layout.inner}[kind]


def _stacks(cfg: ModelConfig) -> list:
    """(tree path, group name) of every stacked group, the encoder's
    too."""
    out = [(("groups", g), g) for g, _ in group_plan(cfg)]
    if cfg.is_encdec:
        out.append((("encoder",), "enc"))
    return out


def tp_partial_leaves(cfg: ModelConfig, layout: TPLayout) -> list:
    """Paths of the leaves every rank holds whole but uses inside a split
    block, so that each rank holds only part of their gradient, to be
    added over "model": the KV projections of the self- and
    cross-attention blocks whose query heads are split and KV heads are
    not (each rank reads them for its own query heads), the router of a
    split MoE block (each rank combines its own slots' weights) and the
    SSD's B and C projections and convolutions (each rank's heads read
    them)."""
    kv = layout.heads and not layout.kv_heads
    names = {"attn": (("wk", "wv", "bk", "bv") if cfg.qkv_bias
                      else ("wk", "wv")) if kv else (),
             "cross": ("wk", "wv") if kv else (),
             "moe": ("router",) if _split("moe", layout) else (),
             "ssd": ("in_bc", "conv_b", "conv_c") if layout.inner else (),
             "mlp": (), "rec": ()}
    return [path + (key, leaf) for path, g in _stacks(cfg)
            for key in _GROUPS[g] for leaf in names[_kind(key)]]


def _ssd_parts(cfg, group, blocks, hs, caches=None) -> list:
    """Each rank's part of an SSD block's output.  ``in_xz``'s "inner"
    split gives rank r the r-th run of its 2 d_in columns, not the x and
    z columns of its heads (at a model axis of 2 rank 0 holds every x
    column and rank 1 every z column), so the ranks' products are
    gathered (``group.gather``: B x S x 2 d_in a rank, reduce-scattered
    back in the backward) and each takes the x and z columns of its
    heads.

    ``caches``: each rank's cache of the block (a serve step's).  The
    rules split the convolution tail's d_in + 2N channels (x, B, C) into
    runs over "model" that are not the ranks' heads either: the tails
    are gathered (``group.all_gather``), each rank convolves its heads'
    x channels and B and C, and writes its run of the whole new tail,
    whose x channels it has from the gathered product.  The state is
    split by heads, each rank's its own."""
    ws = [b.weights() for b in blocks]
    whole = group.gather([h @ c.in_xz for h, c in zip(hs, ws)], dim=-1)
    d_in, dl = cfg.ssm_inner, blocks[0].cfg.ssm_inner
    if caches is None or caches[0] is None:
        return [b.project(h, xz[..., r * dl:(r + 1) * dl],
                          xz[..., d_in + r * dl:d_in + (r + 1) * dl],
                          c=c)[0]
                for r, b, h, xz, c in zip(group.ranks, blocks, hs, whole,
                                          ws)]
    n, w = cfg.ssm_state, cfg.conv_width
    tails = group.all_gather([cache["conv"] for cache in caches], dim=-1)
    out = []
    for r, b, h, xz, c, cache, tail in zip(group.ranks, blocks, hs, whole,
                                           ws, caches, tails):
        own = (tail[..., r * dl:(r + 1) * dl], tail[..., d_in:d_in + n],
               tail[..., d_in + n:])
        o, (_, ncb, ncc) = b.scan(
            h, xz[..., r * dl:(r + 1) * dl],
            xz[..., d_in + r * dl:d_in + (r + 1) * dl], own, cache["state"],
            c)
        x_in = F.silu(xz[..., :d_in])
        xp = torch.cat([tail[..., :d_in].to(x_in.dtype), x_in], dim=1)
        new = torch.cat([xp[:, xp.shape[1] - (w - 1):], ncb, ncc], dim=-1)
        q = cache["conv"].shape[-1]
        cache["conv"].copy_(new[..., r * q:(r + 1) * q])
        out.append(o)
    return out


def _rec_parts(group, blocks, hs, caches=None) -> list:
    """Each rank's part of an RG-LRU block's output.  ``w_r`` and ``w_i``
    are split by rows, the gates' columns whole, so a rank's product is a
    partial sum of each whole gate, of which it needs its own columns: a
    reduce-scatter (``group.sum_scatter``, all-gathered back in the
    backward), not a sum every rank then slices.  ``caches``: each
    rank's cache of the block, split by width as the rank's columns
    are."""
    caches = caches or [None] * len(blocks)
    ws = [b.weights() for b in blocks]
    br = [b.branches(h, cache, c) for b, h, c, cache in zip(blocks, hs, ws,
                                                            caches)]
    rs = group.sum_scatter([xb @ c.w_r for (xb, _, _), c in zip(br, ws)],
                           dim=-1)
    gs = group.sum_scatter([xb @ c.w_i for (xb, _, _), c in zip(br, ws)],
                           dim=-1)
    return [b.recur(xb, yb, r, i, cache, conv, c)
            for b, (xb, yb, conv), r, i, c, cache in zip(blocks, br, rs, gs,
                                                          ws, caches)]


def _tp_layer(cfg, layout, group, layers, xs, positions, tiles, kvsel,
              mems, caches=None, seq=None, rows=None):
    """One super-layer on every rank of ``group``: a split block's normed
    input opened (``group.copy``), each rank's part of its output added
    (``group.sum``), then the residual (a cross-attention block's through
    its ``tanh(gate)``, after the sum); a whole block on every rank.

    A serve step's (``tp_serve``): ``caches`` each rank's cache of this
    layer; ``seq`` the groups over which an attention cache is split
    along ``kv_seq`` (``collectives.Groups`` over "data": a prompt's
    tail written into each run, a decode token's softmax combined over
    the runs, ``common.combine_partials``); ``rows`` the groups over
    which a batch is split whose MoE dispatch groups span the shards
    (the MoE's input gathered over them, each rank keeping its rows of
    the output)."""
    name = layers[0].name
    caches = caches or [None] * len(layers)
    for key in _GROUPS[name]:
        kind = _kind(key)
        cs = [None if c is None or kind not in _CACHED else c[key]
              for c in caches]
        split = _split(kind, layout)
        runs = seq is not None and kind == "attn" and cs[0] is not None
        gathered = rows is not None and kind == "moe"
        if not (split or runs or gathered):
            xs = [layer.run_block(key, x, p, c, m, t)
                  for layer, x, p, c, m, t in zip(layers, xs, positions,
                                                  caches, mems, tiles)]
            continue
        blocks = [getattr(layer, key) for layer in layers]
        hs = [b.normed(x) for x, b in zip(xs, blocks)]
        if split:
            hs = group.copy(hs)
        gates = [None] * len(blocks)
        if kind == "attn":
            window = cfg.local_window if _local(name, key) else 0
            if runs and hs[0].shape[1] == 1:
                parts = [b.partial(h, p, window=window, cache=c,
                                   shard=(r, seq.size), kv_heads=kv)
                         for b, h, p, c, kv, r in zip(blocks, hs, positions,
                                                      cs, kvsel, seq.ranks)]
                parts = [b.out(o) for b, o in zip(blocks, combine_partials(
                    seq, parts, hs[0].dtype))]
            else:
                shards = ([(r, seq.size) for r in seq.ranks] if runs
                          else [(0, 1)] * len(blocks))
                parts = [b.attend(h, p, window=window, causal=name != "enc",
                                  cache=c, tiles=t, kv_heads=kv,
                                  shard=sh)[0]
                         for b, h, p, c, t, kv, sh in zip(
                             blocks, hs, positions, cs, tiles, kvsel,
                             shards)]
        elif kind == "cross":
            ws = [b.weights() for b in blocks]
            parts = [b.attend(h, m, kv, c) for b, h, m, kv, c in
                     zip(blocks, hs, mems, kvsel, ws)]
            gates = [c.gate for c in ws]
        elif kind == "mlp":
            parts = [b.project(h) for b, h in zip(blocks, hs)]
        elif kind == "moe":
            firsts = [r * b.cfg.local_experts if split and layout.expert
                      else 0 for r, b in zip(group.ranks, blocks)]
            ins = rows.all_gather(hs, dim=0) if gathered else hs
            parts = [b.project(h, f) for b, h, f in zip(blocks, ins, firsts)]
            if gathered:
                parts = [o.narrow(0, k * h.shape[0], h.shape[0])
                         for o, h, k in zip(parts, hs, rows.ranks)]
        elif kind == "ssd":
            parts = _ssd_parts(cfg, group, blocks, hs, cs)
        else:
            parts = _rec_parts(group, blocks, hs, cs)
        if split:
            parts = group.sum(parts)
        xs = [x + (o.to(x.dtype) if g is None else g * o.to(x.dtype))
              for x, o, g in zip(xs, parts, gates)]
    return xs


def _tp_stack_run(cfg, layout, group, stacks, xs, positions, tiles, kvsel,
                  mems, remat: bool):
    """One group's layers on every rank (``remat_layers``' checkpoints,
    each spanning the ranks); ``mems`` each rank's memory (or None)."""
    n = len(xs)

    def one(i):
        def run(*args):
            return tuple(_tp_layer(cfg, layout, group, [s[i] for s in stacks],
                                   list(args[:n]), positions, tiles, kvsel,
                                   list(args[n:])))
        return run

    return list(remat_layers([one(i) for i in range(len(stacks[0]))],
                             tuple(xs), tuple(mems), remat,
                             cfg.remat_block))


def _tp_memory(models, cfg, layout, group, batches, kvsel, remat) -> list:
    """Each rank's memory for the cross-attention blocks (None where the
    family has none): the vision patches as given, or the audio frames
    through the encoder, run on the ranks as a dense stack is (its
    attention non-causal), then ``enc_norm``.  Where the cross-attention
    is split, the encoded memory passes ``group.copy``: each rank's
    cross-attention adds only part of the memory's gradient, and the
    copy adds those parts together."""
    if not models[0].needs_memory:
        return [None] * len(models)
    mems = [m._memory(bt.get("memory"), encoded=True)
            for m, bt in zip(models, batches)]
    if not cfg.is_encdec:
        return mems
    positions = [m._positions(*x.shape[:2]) for m, x in zip(models, mems)]
    xs = _tp_stack_run(cfg, layout, group, [m.encoder for m in models], mems,
                       positions, [{} for _ in models], kvsel,
                       [None] * len(models), remat)
    mems = [rmsnorm(x, m.enc_norm, cfg.rms_eps) for x, m in zip(xs, models)]
    return group.copy(mems) if layout is not None and layout.heads \
        else mems


def _tp_chunk_nll(cap, group, vl: int, *args):
    """One chunk's NLL on every rank of ``group`` from its vocabulary
    columns: the maximum over the ranks, then the sum of exponentials
    added over them, then the target's logit from the rank that owns it.
    ``args``: the ranks' heads, hidden chunks, targets and masks, each a
    run of len(group).  Returns (sum, count) of each rank, flat."""
    n = len(group)
    heads, xxs, tts, mms = (args[k * n:(k + 1) * n] for k in range(4))
    logits = [softcap(xx @ h.to(xx.dtype), cap).float()
              for h, xx in zip(heads, xxs)]
    ms = group.max([z.amax(-1) for z in logits])
    es = group.sum([torch.exp(z - m[..., None]).sum(-1)
                    for z, m in zip(logits, ms)])
    picks = []
    for r, z, tt in zip(group.ranks, logits, tts):
        local = tt - r * vl
        own = (local >= 0) & (local < vl)
        hit = z.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
        picks.append(torch.where(own, hit, torch.zeros((), device=z.device)))
    ts = group.sum(picks)
    out = []
    for e, m, t, mm in zip(es, ms, ts, mms):
        nll = torch.log(e) + m - t
        out += [(nll * mm).sum(), mm.sum()]
    return tuple(out)


def _tp_embed(models, cfg: ModelConfig, layout, group, toks) -> list:
    """Each rank's embedded tokens: split by vocabulary, each rank gathers
    its rows, zeros the rest, and the ranks add (``group.sum``); else the
    whole table on every rank."""
    if layout is None or not layout.vocab:
        return [m._embed(t) for m, t in zip(models, toks)]
    vl = models[0].cfg.vocab
    parts = []
    for r, m, t in zip(group.ranks, models, toks):
        local = t - r * vl
        own = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        e = (m.embed.to(cfg.dtype)[idx] if m.live
             else m.embed[idx].to(cfg.dtype))
        parts.append(torch.where(own[..., None], e,
                                 torch.zeros((), dtype=e.dtype,
                                             device=e.device)))
    return [scaled(x, math.sqrt(cfg.d_model)) for x in group.sum(parts)]


def tp_nll_sums(models, cfg: ModelConfig, layout: TPLayout, group, batches,
                remat: bool = True, loss_chunk: int = _LOSS_CHUNK) -> list:
    """``nll_sums`` of one batch over the ranks of a "model" group:
    ``models`` the ranks' live ``Transformer``s over their parameters (of
    ``local_config``), in ``group``'s order, ``batches`` each rank's copy
    of the batch (its vision or audio memory too).  The embedding is
    split by vocabulary (each rank gathers its rows, zeros the rest, and
    the ranks add), every block as ``_tp_layer`` splits it (the audio
    encoder's too, ``_tp_memory``), and the loss is vocabulary-parallel
    (``_tp_chunk_nll``) in ``loss_fn``'s checkpointed chunks: no rank
    holds the (B, S, V) logits.  Returns each rank's (sum, count), equal
    on all of them."""
    toks = [m._tokens(bt["tokens"]) for m, bt in zip(models, batches)]
    xs = _tp_embed(models, cfg, layout, group, toks)
    positions = [m._positions(*t.shape) for m, t in zip(models, toks)]
    tiles = [{} for _ in models]
    kvsel = [kv_select(cfg, layout, group.size, r, t.device)
             for r, t in zip(group.ranks, toks)]
    mems = _tp_memory(models, cfg, layout, group, batches, kvsel, remat)
    for name, _count in group_plan(cfg):
        xs = _tp_stack_run(cfg, layout, group,
                           [m.groups[name] for m in models], xs, positions,
                           tiles, kvsel, mems, remat)
    xs = [rmsnorm(x, m.final_norm, cfg.rms_eps) for x, m in zip(xs, models)]
    if layout.vocab:
        vl = models[0].cfg.vocab
        xs = group.copy(xs)
    shifted = [_shifted(x, t, bt.get("mask"), loss_chunk)
               for x, t, bt in zip(xs, toks, batches)]
    heads = [m.lm_head for m in models]
    if layout.vocab:
        return _chunk_sums(functools.partial(
            _tp_chunk_nll, cfg.logit_softcap, group, vl), heads, shifted)
    whole = functools.partial(_chunk_nll, cfg.logit_softcap)
    return [_chunk_sums(whole, [h], [sh])[0]
            for h, sh in zip(heads, shifted)]


def tp_serve(models, cfg: ModelConfig, layout: Optional[TPLayout], group,
             caches, batches, seq=None, rows=None) -> list:
    """A prefill or one decode step of each rank's batch over the ranks of
    ``group`` (a ``collectives.Group`` or ``Groups`` over "model"):
    ``models`` their ``Transformer``s over their parameters (of
    ``local_config``; ``layout`` None: a model axis of 1), ``caches``
    their caches (the rules' shards: KV heads split or replicated as
    ``cache_axes`` and the rules give, the SSD and RG-LRU widths split),
    written in place, ``batches`` their batches: {"tokens" (B, S)} a
    prefill, {"token" (B, 1), "pos" (B,)} a decode step, and the vision
    or audio memory (raw audio frames in a prefill, encoded in a decode
    step, as ``Transformer.prefill`` returns them).  The embedding,
    every block and the audio encoder split as ``tp_nll_sums`` splits
    them (``_tp_layer``; ``seq`` and ``rows`` as it takes them).
    Returns each rank's logits of the last position (B, 1, V) in
    ``cfg.dtype``: a rank's vocabulary columns gathered over "model"
    (``group.all_gather``)."""
    decode = "token" in batches[0]
    toks = [m._tokens(bt["token" if decode else "tokens"])
            for m, bt in zip(models, batches)]
    xs = _tp_embed(models, cfg, layout, group, toks)
    kvsel = [kv_select(cfg, layout, group.size, r, t.device)
             for r, t in zip(group.ranks, toks)]
    if decode:
        positions = [torch.as_tensor(bt["pos"], device=m.device).to(
            torch.int32)[:, None] for m, bt in zip(models, batches)]
        mems = [m._memory(bt.get("memory"), encoded=True)
                for m, bt in zip(models, batches)]
    else:
        positions = [m._positions(*t.shape) for m, t in zip(models, toks)]
        mems = _tp_memory(models, cfg, layout, group, batches, kvsel, False)
    tiles = [{} for _ in models]
    for name, count in group_plan(cfg):
        for i in range(count):
            xs = _tp_layer(cfg, layout, group,
                           [m.groups[name][i] for m in models], xs,
                           positions, tiles, kvsel, mems,
                           [_layer(c[name], i) for c in caches], seq, rows)
    logits = [softcap(rmsnorm(x[:, -1:], m.final_norm, cfg.rms_eps)
                      @ m._head(), cfg.logit_softcap)
              for x, m in zip(xs, models)]
    if layout is not None and layout.vocab:
        logits = group.all_gather(logits, dim=-1)
    return logits


# ---------------------------------------------------------------------------
# Serving caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda", dtype=torch.bfloat16):
    """Empty decode caches in the JAX ``init_cache`` tree: per group and
    block, attention ``k``/``v`` (count, B, len, KV, hd) and ``pos``
    (count, B, len) int32 at 2^30 (the empty-slot position the mask
    excludes; a local-attention cache holds min(max_len, local_window)
    entries), RG-LRU ``conv`` (count, B, W-1, width) and ``h`` (count, B,
    width), SSD ``conv`` (count, B, W-1, d_in + 2N) and ``state`` (count,
    B, H, P, N).  K/V and the convolution tails are in ``dtype`` (bf16,
    as the JAX package keeps them at every config dtype), ``h`` and
    ``state`` in f32."""
    dev = torch.device(device)
    b = batch_size
    loc = min(max_len, cfg.local_window) if cfg.local_window else max_len
    cw = cfg.conv_width - 1
    d_in = cfg.ssm_expand * cfg.d_model
    p, n = cfg.ssm_head_dim, cfg.ssm_state

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def entry(name, key, count):
        kind = _kind(key)
        if kind == "attn":
            length = loc if _local(name, key) else max_len
            shape = (count, b, length, cfg.n_kv_heads, cfg.hd)
            return {"k": zeros(*shape), "v": zeros(*shape),
                    "pos": torch.full((count, b, length), PAD_POS,
                                      dtype=torch.int32, device=dev)}
        if kind == "rec":
            wdt = cfg.lru_width or cfg.d_model
            return {"conv": zeros(count, b, cw, wdt),
                    "h": zeros(count, b, wdt, dt=torch.float32)}
        return {"conv": zeros(count, b, cw, d_in + 2 * n),
                "state": zeros(count, b, d_in // p, p, n, dt=torch.float32)}

    return {name: {key: entry(name, key, count) for key in _GROUPS[name]
                   if _kind(key) in _CACHED}
            for name, count in group_plan(cfg)}


#: each cache leaf's logical axes, by block kind (the JAX ``_cache_entry``)
_CACHE_AXES = {
    "attn": {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
             "v": ("layers", "batch", "kv_seq", "kv_heads", None),
             "pos": ("layers", "batch", "kv_seq")},
    "rec": {"conv": ("layers", "batch", None, "inner"),
            "h": ("layers", "batch", "inner")},
    "ssd": {"conv": ("layers", "batch", None, "inner"),
            "state": ("layers", "batch", "inner", None, None)}}


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The decode cache's logical axes as a tree of ``Axes``, in
    ``init_cache``'s structure (the JAX ``init_cache(..., mode="axes")``
    tree); ``init_cache(..., device="meta")`` gives the shapes."""
    return {name: {key: {k: Axes(a) for k, a in
                         _CACHE_AXES[_kind(key)].items()}
                   for key in _GROUPS[name] if _kind(key) in _CACHED}
            for name, _count in group_plan(cfg)}


def clear_cache(cache) -> None:
    """Empty a cache (or a view of some of its rows) in place."""
    for key, t in cache.items():
        if isinstance(t, dict):
            clear_cache(t)
        else:
            t.fill_(PAD_POS if key == "pos" else 0)
