"""LM assembly of the dense and local/global families.

The decoder stack is organized into *groups* of identical super-layers,
as in the JAX package:

  family        groups (super-layer contents)
  dense         [L x (attn + mlp)]
  local_global  [L/2 x (local-attn + mlp + global-attn + mlp)]  (gemma2)

``group_plan`` covers every family of the configs; the groups of the
others (``moe``, ``rrl``, ``rec_extra``, ``cross5``, ``ssd``, ``dec`` and
the encoder) raise ``NotImplementedError``: they come with a later LM
slice of the port.

Parameters are a nested dict of tensors in the JAX ``init_params``
layout, stacked per group on a leading layer axis (``init_params``,
``interop.lm_params_from_numpy``).  ``Transformer`` splits the stacked
leaves into one module per super-layer (views, no copy) and serves:

  Transformer(cfg, params).forward(tokens)          -> logits (B, S, V)
  init_cache(cfg, batch, max_len)                   -> cache
  Transformer.prefill(cache, tokens)                -> (last logits, cache)
  Transformer.decode_step(cache, token, pos)        -> (logits, cache)

Caches are written in place (and returned, as the JAX functions return
theirs).  Layers run in a Python loop (no ``lax.scan``, no remat:
serving does not differentiate).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from .blocks import AttnBlock, MLPBlock, attn_spec, mlp_spec
from .common import PAD_POS, ModelConfig, rmsnorm, scaled, softcap

Params = Dict[str, Any]

PORTED_GROUPS = ("dense", "lg")
LATER_SLICE = ("a later LM slice of repro_torch (the MoE, SSD, RG-LRU and "
               "cross-attention blocks and the encoder)")


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


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the later slice when cfg needs
    a layer group that is not ported yet."""
    missing = [name for name, _ in group_plan(cfg)
               if name not in PORTED_GROUPS]
    if cfg.is_encdec:
        missing.append("enc")
    if missing:
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}) needs the layer groups "
            f"{missing}, which come with {LATER_SLICE}")


class Leaf(NamedTuple):
    shape: tuple
    init: str          # "normal" | "zeros"
    scale: float = 0.02


def _group_spec(name: str, cfg: ModelConfig) -> Dict[str, Any]:
    if name == "dense":
        return {"attn": attn_spec(cfg), "mlp": mlp_spec(cfg)}
    if name == "lg":
        return {"attn_l": attn_spec(cfg), "mlp_l": mlp_spec(cfg),
                "attn_g": attn_spec(cfg), "mlp_g": mlp_spec(cfg)}
    raise NotImplementedError(f"layer group {name!r} comes with "
                              f"{LATER_SLICE}")


def param_spec(cfg: ModelConfig) -> Params:
    """The parameter tree as ``Leaf``s: the JAX ``init_params`` tree's
    structure, shapes (stacked per group) and initializers."""
    check_ported(cfg)
    d, v = cfg.d_model, cfg.vocab
    groups = {}
    for name, count in group_plan(cfg):
        groups[name] = {blk: {k: Leaf((count,) + shape, init)
                              for k, (shape, init) in leaves.items()}
                        for blk, leaves in _group_spec(name, cfg).items()}
    return {"embed": Leaf((v, d), "normal", 0.01),
            "final_norm": Leaf((d,), "zeros"),
            "lm_head": Leaf((d, v), "normal", 0.01),
            "groups": groups}


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts (``rest``: trees of the same
    structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random parameters with the JAX package's distributions: normal x
    0.02, the embedding and the LM head x 0.01, norms and biases zero,
    drawn in f32 from ``generator`` (default: seed 0 on ``device``) and
    stored in ``cfg.param_dtype``.  The draws are torch's, not
    ``jax.random``'s: carry weights across with
    ``interop.lm_params_from_numpy`` to compare the two packages."""
    dev = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(leaf: Leaf) -> torch.Tensor:
        if leaf.init == "zeros":
            return torch.zeros(leaf.shape, dtype=cfg.param_dtype, device=dev)
        t = torch.randn(leaf.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return t.mul_(leaf.scale).to(cfg.param_dtype)

    return tree_map(draw, param_spec(cfg))


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


class SuperLayer(nn.Module):
    """One super-layer of a group: ``dense`` (attn + mlp) or ``lg``
    (local attn + mlp + global attn + mlp)."""

    def __init__(self, name: str, cfg: ModelConfig, w: Params):
        super().__init__()
        self.name, self.cfg = name, cfg
        for key, leaves in w.items():
            block = AttnBlock if key.startswith("attn") else MLPBlock
            self.add_module(key, block(cfg, leaves))

    def forward(self, x, positions, cache=None):
        def attn(key, xx, window):
            c = None if cache is None else cache[key]
            return getattr(self, key)(xx, positions, window=window,
                                      cache=c)[0]

        if self.name == "dense":
            x = attn("attn", x, 0)
            return self.mlp(x)
        x = attn("attn_l", x, self.cfg.local_window)
        x = self.mlp_l(x)
        x = attn("attn_g", x, 0)
        return self.mlp_g(x)


class Transformer(nn.Module):
    """The decoder LM over a parameter tree (see the module docstring).
    The tree's tensors are kept (per-layer views); the compute-dtype
    copies are made once here, and the embedding is gathered in
    ``param_dtype`` and cast per row, which is bitwise the JAX package's
    cast of the whole table on every call."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        check_ported(cfg)
        _check_tree(params, param_spec(cfg))
        self.cfg = cfg
        self.plan = group_plan(cfg)
        for name in ("embed", "final_norm", "lm_head"):
            self.register_parameter(name, nn.Parameter(params[name],
                                                       requires_grad=False))
        self.groups = nn.ModuleDict({
            name: nn.ModuleList(SuperLayer(name, cfg,
                                           _layer(params["groups"][name], i))
                                for i in range(count))
            for name, count in self.plan})
        self.c_lm_head = self.lm_head.to(cfg.dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def params_tree(self) -> Params:
        """The parameters as the stacked tree they came from (a copy)."""
        groups = {}
        for name, _count in self.plan:
            layers = [{key: {k: p.detach() for k, p in
                             blk.named_parameters(recurse=False)}
                       for key, blk in layer.named_children()}
                      for layer in self.groups[name]]
            groups[name] = tree_map(lambda *ts: torch.stack(ts), *layers)
        return {"embed": self.embed.detach().clone(),
                "final_norm": self.final_norm.detach().clone(),
                "lm_head": self.lm_head.detach().clone(), "groups": groups}

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens].to(self.cfg.dtype)
        return scaled(x, math.sqrt(self.cfg.d_model))

    def _layers(self, x, positions, cache=None):
        for name, _count in self.plan:
            for i, layer in enumerate(self.groups[name]):
                c = None if cache is None else _layer(cache[name], i)
                x = layer(x, positions, c)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_norm, self.cfg.rms_eps)
        return softcap(x @ self.c_lm_head, self.cfg.logit_softcap)

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return torch.arange(s, dtype=torch.int32,
                            device=self.device)[None].expand(b, s)

    def forward_hidden(self, tokens) -> torch.Tensor:
        """Final-normed hidden states (B, S, D) of tokens (B, S)."""
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        x = self._layers(self._embed(tokens), self._positions(b, s))
        return rmsnorm(x, self.final_norm, self.cfg.rms_eps)

    def forward(self, tokens) -> torch.Tensor:
        """Logits (B, S, V) in ``cfg.dtype`` of tokens (B, S)."""
        x = self.forward_hidden(tokens)
        return softcap(x @ self.c_lm_head, self.cfg.logit_softcap)

    def prefill(self, cache, tokens):
        """Run a prompt (B, S) and write it into ``cache`` (the tail where
        a cache is shorter than the prompt).  Returns the last position's
        logits (B, 1, V) and the cache."""
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        x = self._layers(self._embed(tokens), self._positions(b, s), cache)
        return self._logits(x[:, -1:]), cache

    def decode_step(self, cache, token, pos):
        """One-token decode: token (B, 1), pos (B,) int.  Local-attention
        caches are ring buffers indexed by pos % len."""
        token = self._tokens(token)
        positions = torch.as_tensor(pos, device=self.device).to(
            torch.int32)[:, None]
        x = self._layers(self._embed(token), positions, cache)
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# Serving caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda", dtype=torch.bfloat16):
    """Empty decode caches: per group and attention block, ``k``/``v``
    (count, B, len, KV, hd) in ``dtype`` (bf16, as the JAX package keeps
    them at every config dtype) and ``pos`` (count, B, len) int32 at
    2^30, the empty-slot position the mask excludes.  A local-attention
    cache holds min(max_len, local_window) entries."""
    check_ported(cfg)
    dev = torch.device(device)
    kv, hd = cfg.n_kv_heads, cfg.hd
    loc = min(max_len, cfg.local_window) if cfg.local_window else max_len

    def attn_c(count, length):
        shape = (count, batch_size, length)
        return {"k": torch.zeros(shape + (kv, hd), dtype=dtype, device=dev),
                "v": torch.zeros(shape + (kv, hd), dtype=dtype, device=dev),
                "pos": torch.full(shape, PAD_POS, dtype=torch.int32,
                                  device=dev)}

    cache = {}
    for name, count in group_plan(cfg):
        if name == "dense":
            cache[name] = {"attn": attn_c(count, max_len)}
        else:
            cache[name] = {"attn_l": attn_c(count, loc),
                           "attn_g": attn_c(count, max_len)}
    return cache


def clear_cache(cache) -> None:
    """Empty a cache (or a view of some of its rows) in place."""
    for key, t in cache.items():
        if isinstance(t, dict):
            clear_cache(t)
        else:
            t.fill_(PAD_POS if key == "pos" else 0)
