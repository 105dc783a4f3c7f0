"""Attention and MLP blocks of the dense and local/global families.

Each block is an ``nn.Module`` over one layer's parameters, in the JAX
package's layouts (``wq`` (d, h, hd), ``wo`` (h, hd, d), ``w_gate``
(d, f), ...), so that weights carry across by a copy.  The parameters
stay in ``cfg.param_dtype``; ``cast_weights`` makes the compute-dtype
copies the products read once, when the weights are installed.  The
JAX package casts each weight on every call (``w.astype(h.dtype)``); a
cast is elementwise, so casting once gives the same bits, and an eager
decode step does not rewrite every weight.

``attn_spec`` / ``mlp_spec`` give each block's leaves as (shape, init)
for ``transformer.init_params``.  The MoE, SSD, RG-LRU and
cross-attention blocks come with a later LM slice of the port.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, apply_rope, attention, rmsnorm, rope_tables

Spec = Dict[str, Tuple[tuple, str]]


def _params(module: nn.Module, w: Dict[str, torch.Tensor]) -> None:
    for name, t in w.items():
        module.register_parameter(name, nn.Parameter(t, requires_grad=False))


# ---------------------------------------------------------------------------
# Self-attention (global / local) with GQA + RoPE
# ---------------------------------------------------------------------------

def attn_spec(cfg: ModelConfig) -> Spec:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {"wq": ((d, h, hd), "normal"), "wk": ((d, kv, hd), "normal"),
           "wv": ((d, kv, hd), "normal"), "wo": ((h, hd, d), "normal"),
           "norm": ((d,), "zeros")}
    if cfg.qkv_bias:
        out.update(bq=((h, hd), "zeros"), bk=((kv, hd), "zeros"),
                   bv=((kv, hd), "zeros"))
    return out


class AttnBlock(nn.Module):
    """Pre-norm self-attention with a residual: ``forward(x, positions,
    window, causal, cache) -> (x_out, cache)``.

    Modes: ``cache=None`` -> no cache; cache and S > 1 -> prefill (attend
    within the prompt, write the tail into the cache); cache and S == 1 ->
    decode (write the token, attend to the cache).  ``cache`` is one
    layer's ``{"k", "v": (B, len, KV, hd), "pos": (B, len) int32}``,
    written in place; a cache shorter than the context is a ring buffer
    (slot = pos % len; the stored positions drive the mask)."""

    def __init__(self, cfg: ModelConfig, w: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        _params(self, w)
        self.cast_weights()

    def cast_weights(self) -> None:
        cfg, dt = self.cfg, self.cfg.dtype
        d = cfg.d_model
        self.c_wq, self.c_wk, self.c_wv = (
            getattr(self, n).reshape(d, -1).to(dt) for n in ("wq", "wk", "wv"))
        self.c_wo = self.wo.reshape(-1, d).to(dt)
        self.c_bias = ((self.bq.to(dt), self.bk.to(dt), self.bv.to(dt))
                       if cfg.qkv_bias else None)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                window: int = 0, causal: bool = True,
                cache: Optional[Dict[str, torch.Tensor]] = None):
        cfg = self.cfg
        b, s = x.shape[:2]
        h = rmsnorm(x, self.norm, cfg.rms_eps)
        q = (h @ self.c_wq).reshape(b, s, cfg.n_heads, cfg.hd)
        k = (h @ self.c_wk).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        v = (h @ self.c_wv).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        if self.c_bias is not None:
            q = q + self.c_bias[0]
            k = k + self.c_bias[1]
            v = v + self.c_bias[2]
        sin, cos = rope_tables(positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        opts = dict(causal=causal, window=window, cap=cfg.attn_softcap,
                    impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                    skip=cfg.attn_skip)

        if cache is None or s > 1:
            o = attention(q, k, v, positions, positions, **opts)
        if cache is not None:
            ck, cv, cp = cache["k"], cache["v"], cache["pos"]
            clen = ck.shape[1]
            if s > 1:
                # prefill: write the tail of the prompt into the cache
                tail = min(s, clen)
                p_t = positions[:, -tail:]
                slot = (p_t % clen).long()
                bi = torch.arange(b, device=x.device)[:, None]
                ck[bi, slot] = k[:, -tail:].to(ck.dtype)
                cv[bi, slot] = v[:, -tail:].to(cv.dtype)
                cp[bi, slot] = p_t.to(torch.int32)
            else:
                # decode: insert one token, attend to the cache
                pos0 = positions[:, 0]
                slot = (pos0 % clen).long()
                bi = torch.arange(b, device=x.device)
                ck[bi, slot] = k[:, 0].to(ck.dtype)
                cv[bi, slot] = v[:, 0].to(cv.dtype)
                cp[bi, slot] = pos0.to(torch.int32)
                o = attention(q, ck.to(q.dtype), cv.to(q.dtype), positions,
                              cp, **opts)
        out = o.reshape(b, s, -1) @ self.c_wo
        return x + out.to(x.dtype), cache


# ---------------------------------------------------------------------------
# MLP (dense) — swiglu/geglu/gelu, with optional butterfly fast mixing
# ---------------------------------------------------------------------------

def mlp_spec(cfg: ModelConfig) -> Spec:
    d, f = cfg.d_model, cfg.d_ff
    out = {"norm": ((d,), "zeros")}
    if cfg.mlp_type in ("swiglu", "geglu"):
        out["w_gate"] = ((d, f), "normal")
    out["w_up"] = ((d, f), "normal")
    out["w_down"] = ((f, d), "normal")
    if cfg.butterfly_mlp:
        depth = max(int(np.ceil(np.log2(d))), 1)
        out["bf_theta"] = ((depth, d // 2), "zeros")
    return out


@functools.lru_cache(maxsize=16)
def _mix_tables(n: int, depth: int):
    """Per stage k and coordinate: the partner pi (depth, n), the pair
    slot whose angle the coordinate takes (depth, n) and the sign of its
    b (+1: the pair's first coordinate, -1: its second, 0: untouched).

    The JAX package writes a stage as two scatters, ``xc.at[ii].set``
    then ``xc.at[jj].set``.  Where d is not a power of two its degenerate
    guard gives a stage indices that repeat (at d = 1536 and stride 1024,
    jj holds 1280..1535 twice; at stride 512 an index is in ii and in
    jj), and JAX's CPU scatter keeps the last write.  The tables keep the
    same write: the later pair in ii, then any pair in jj, the later one
    winning."""
    steps = max(int(np.ceil(np.log2(n))), 1)
    half = n // 2
    perm = np.tile(np.arange(n, dtype=np.int64), (depth, 1))
    slot = np.zeros((depth, n), np.int64)
    sign = np.zeros((depth, n), np.float32)
    for k in range(depth):
        stride = 2 ** (k % steps)
        idx = np.arange(half)
        ii = (idx // stride) * (2 * stride) + idx % stride
        jj = ii + stride
        ok = jj < n
        ii, jj = np.where(ok, ii, idx), np.where(ok, jj, idx + half)
        for p in range(half):
            perm[k, ii[p]], slot[k, ii[p]], sign[k, ii[p]] = jj[p], p, 1.0
        for p in range(half):
            perm[k, jj[p]], slot[k, jj[p]], sign[k, jj[p]] = ii[p], p, -1.0
    return perm, slot, sign


def _butterfly_mix(theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """FFT-pattern orthonormal mixing (the paper's fast-transform layer):
    ``depth`` stages, each gather-only, y_k = a_k x_k + b_k x_{pi(k)}
    with (a, b) = (cos, sin) of the pair's angle on its first coordinate,
    (cos, -sin) on its second and (1, 0) where untouched."""
    n = x.shape[-1]
    depth = theta.shape[0]
    perm, slot, sign = (torch.from_numpy(t).to(x.device)
                        for t in _mix_tables(n, depth))
    cc = torch.cos(theta).to(x.dtype)
    ss = torch.sin(theta).to(x.dtype)
    touched = sign != 0
    a = torch.where(touched, cc.gather(1, slot), torch.ones((), dtype=x.dtype,
                                                             device=x.device))
    b = torch.where(touched, ss.gather(1, slot) * sign.to(x.dtype),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    for k in range(depth):
        x = a[k] * x + b[k] * x.index_select(-1, perm[k])
    return x


class MLPBlock(nn.Module):
    """Pre-norm MLP with a residual: SwiGLU, GeGLU or GELU, optionally
    after the butterfly mixing (``cfg.butterfly_mlp``)."""

    def __init__(self, cfg: ModelConfig, w: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        _params(self, w)
        self.cast_weights()

    def cast_weights(self) -> None:
        dt = self.cfg.dtype
        self.c_gate = (self.w_gate.to(dt)
                       if self.cfg.mlp_type in ("swiglu", "geglu") else None)
        self.c_up = self.w_up.to(dt)
        self.c_down = self.w_down.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rmsnorm(x, self.norm, cfg.rms_eps)
        if cfg.butterfly_mlp:
            h = _butterfly_mix(self.bf_theta, h)
        if cfg.mlp_type == "swiglu":
            z = F.silu(h @ self.c_gate) * (h @ self.c_up)
        elif cfg.mlp_type == "geglu":
            z = F.gelu(h @ self.c_gate, approximate="tanh") * (h @ self.c_up)
        else:
            z = F.gelu(h @ self.c_up, approximate="tanh")
        out = z @ self.c_down
        return x + out.to(x.dtype)

