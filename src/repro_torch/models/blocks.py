"""The LM blocks: self-attention, cross-attention, MLP, MoE, Mamba-2 SSD
and RG-LRU.

Each block is an ``nn.Module`` over one layer's parameters, in the JAX
package's layouts (``wq`` (d, h, hd), ``wo`` (h, hd, d), ``w_gate``
(d, f), ...), so that weights carry across by a copy.  The parameters
stay in ``cfg.param_dtype``; for serving, ``cast_weights`` makes the
compute-dtype copies the products read once, when the weights are
installed.  The JAX package casts each weight on every call
(``w.astype(h.dtype)``); a cast is elementwise, so casting once gives
the same bits, and an eager decode step does not rewrite every weight.
A block built ``live`` (training) casts in the graph at every call
instead, from parameters that take gradients.

``<block>_spec`` gives each block's leaves as (shape, init) or (shape,
init, scale) for ``transformer.init_params``, and ``<BLOCK>_AXES`` each
leaf's logical axes, the JAX ``param(...)`` axes that
``runtime/sharding.py`` maps onto a mesh.

The MoE dispatch, the SSD chunked scan and the RG-LRU scan are plain
XLA in the JAX package (no ``pallas_call``), so they are plain torch
here, the products ``torch.matmul``/``einsum``.
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import (ModelConfig, apply_rope, attention, attention_partial,
                     rmsnorm, rope_tables)

Spec = Dict[str, Tuple[tuple, str]]


class _Block(nn.Module):
    """One layer's parameters (views of a stacked tree share its memory)
    and the compute-dtype weights its products read (``weights()``).

    Serving (``live=False``): ``cast_weights`` makes the copies once
    (the ``c_*`` attributes) and the parameters take no gradient.
    Training (``live=True``): the parameters carry gradients and change
    every step, so each call casts them in the graph, as the JAX package
    casts them on every call; no copy is kept."""

    def __init__(self, cfg: ModelConfig, w: Dict[str, torch.Tensor],
                 live: bool = False):
        super().__init__()
        self.cfg, self.live = cfg, live
        for name, t in w.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=live))
        self._cast = None
        if not live:
            self.cast_weights()

    def _casts(self) -> Dict[str, object]:
        """The compute-dtype weights, cast from the parameters now."""
        raise NotImplementedError

    def cast_weights(self) -> None:
        casts = self._casts()
        for name, t in casts.items():
            setattr(self, f"c_{name}", t)
        self._cast = SimpleNamespace(**casts)

    def weights(self) -> SimpleNamespace:
        return SimpleNamespace(**self._casts()) if self.live else self._cast

    def normed(self, x: torch.Tensor) -> torch.Tensor:
        """The input the block's projections read (its pre-norm)."""
        return rmsnorm(x, self.norm, self.cfg.rms_eps)


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


#: each leaf's logical axes (the JAX ``param`` axes)
ATTN_AXES = {"wq": ("embed", "heads", None),
             "wk": ("embed", "kv_heads", None),
             "wv": ("embed", "kv_heads", None),
             "wo": ("heads", None, "embed"), "norm": (None,),
             "bq": ("heads", None), "bk": ("kv_heads", None),
             "bv": ("kv_heads", None)}


class AttnBlock(_Block):
    """Pre-norm self-attention with a residual: ``forward(x, positions,
    window, causal, cache) -> (x_out, cache)``.

    Modes: ``cache=None`` -> no cache; cache and S > 1 -> prefill (attend
    within the prompt, write the tail into the cache); cache and S == 1 ->
    decode (write the token, attend to the cache).  ``cache`` is one
    layer's ``{"k", "v": (B, len, KV, hd), "pos": (B, len) int32}``,
    written in place; a cache shorter than the context is a ring buffer
    (slot = pos % len; the stored positions drive the mask)."""


    def _casts(self):
        cfg, dt = self.cfg, self.cfg.dtype
        d = cfg.d_model
        out = {n: getattr(self, n).reshape(d, -1).to(dt)
               for n in ("wq", "wk", "wv")}
        out["wo"] = self.wo.reshape(-1, d).to(dt)
        out["bias"] = ((self.bq.to(dt), self.bk.to(dt), self.bv.to(dt))
                       if cfg.qkv_bias else None)
        return out

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                window: int = 0, causal: bool = True,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                tiles: Optional[dict] = None):
        h = self.normed(x)
        out, cache = self.attend(h, positions, window=window, causal=causal,
                                 cache=cache, tiles=tiles)
        return x + out.to(x.dtype), cache

    def qkv(self, h: torch.Tensor, positions: torch.Tensor, c=None):
        """The queries, keys and values of the normed input ``h`` (B, S,
        heads, hd), RoPE applied to the first two."""
        cfg = self.cfg
        c = self.weights() if c is None else c
        b, s = h.shape[:2]
        q = (h @ c.wq).reshape(b, s, cfg.n_heads, cfg.hd)
        k = (h @ c.wk).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        v = (h @ c.wv).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        if c.bias is not None:
            q = q + c.bias[0]
            k = k + c.bias[1]
            v = v + c.bias[2]
        sin, cos = rope_tables(positions, cfg.hd, cfg.rope_theta)
        return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v

    def _opts(self, window: int, causal: bool) -> dict:
        cfg = self.cfg
        return dict(causal=causal, window=window, cap=cfg.attn_softcap,
                    impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                    skip=cfg.attn_skip)

    def attend(self, h: torch.Tensor, positions: torch.Tensor, *,
               window: int = 0, causal: bool = True,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               tiles: Optional[dict] = None,
               kv_heads: Optional[torch.Tensor] = None,
               shard: Tuple[int, int] = (0, 1)):
        """The block's output of the normed input ``h`` without the
        residual (``forward`` adds it), and the cache.  ``kv_heads``: the
        KV heads (indices into this block's) that the query heads read,
        in their order, for a tensor-parallel rank that holds every KV
        head but a part of the query heads (its cache holds them all).
        ``shard`` (k, n): the cache is the k-th of n runs of the whole
        cache's slots (``kv_write``); a prompt then writes only the slots
        of this run (decode against such a cache: ``partial``)."""
        c = self.weights()
        b, s = h.shape[:2]
        q, k, v = self.qkv(h, positions, c)
        opts = self._opts(window, causal)
        if cache is None or s > 1:
            o = attention(q, _heads(k, kv_heads), _heads(v, kv_heads),
                          positions, positions, tiles=tiles, **opts)
        if cache is not None:
            if shard[1] > 1:
                kv_write(cache, k, v, positions, shard)
            elif s > 1:
                # prefill: write the tail of the prompt into the cache
                ck, cv, cp = cache["k"], cache["v"], cache["pos"]
                tail = min(s, ck.shape[1])
                p_t = positions[:, -tail:]
                slot = (p_t % ck.shape[1]).long()
                bi = torch.arange(b, device=h.device)[:, None]
                ck[bi, slot] = k[:, -tail:].to(ck.dtype)
                cv[bi, slot] = v[:, -tail:].to(cv.dtype)
                cp[bi, slot] = p_t.to(torch.int32)
            else:
                # decode: insert one token, attend to the cache
                ck, cv, cp = cache["k"], cache["v"], cache["pos"]
                pos0 = positions[:, 0]
                slot = (pos0 % ck.shape[1]).long()
                bi = torch.arange(b, device=h.device)
                ck[bi, slot] = k[:, 0].to(ck.dtype)
                cv[bi, slot] = v[:, 0].to(cv.dtype)
                cp[bi, slot] = pos0.to(torch.int32)
            if s == 1:
                o = attention(q, _heads(cache["k"].to(q.dtype), kv_heads),
                              _heads(cache["v"].to(q.dtype), kv_heads),
                              positions, cache["pos"], **opts)
        return self.out(o, c), cache

    def partial(self, h: torch.Tensor, positions: torch.Tensor, *,
                window: int, cache: Dict[str, torch.Tensor],
                shard: Tuple[int, int],
                kv_heads: Optional[torch.Tensor] = None):
        """One decode token against the ``shard``-th run of a cache split
        along its slots: the token written where its slot falls in this
        run, then this run's part of the softmax
        (``common.attention_partial``), for the runs to combine
        (``common.combine_partials``) before ``out``."""
        q, k, v = self.qkv(h, positions)
        kv_write(cache, k, v, positions, shard)
        return attention_partial(
            q, _heads(cache["k"].to(q.dtype), kv_heads),
            _heads(cache["v"].to(q.dtype), kv_heads), positions,
            cache["pos"], window=window, cap=self.cfg.attn_softcap)

    def out(self, o: torch.Tensor, c=None) -> torch.Tensor:
        """The output projection of the attention's (B, S, heads, hd)."""
        c = self.weights() if c is None else c
        b, s = o.shape[:2]
        return o.reshape(b, s, -1) @ c.wo


def _heads(t: torch.Tensor, kv_heads: Optional[torch.Tensor]):
    return t if kv_heads is None else t.index_select(2, kv_heads)


def kv_write(cache: Dict[str, torch.Tensor], k: torch.Tensor,
             v: torch.Tensor, positions: torch.Tensor,
             shard: Tuple[int, int]) -> None:
    """Write keys and values (B, S, KV, hd) at ``positions`` (B, S) into
    the ``shard`` = (k, n)-th run of a cache whose slots (the whole
    cache's ``n`` x this run's, a ring buffer: slot = pos % length) are
    split into n runs along ``kv_seq``, as the JAX rules split a cache
    over "data" for a batch smaller than the data shards.  The run keeps
    what the whole cache would hold in its slots: a prompt's tail (the
    last of the consecutive positions that fall in a slot), a decode
    token where its slot is this run's.  Gathers and one copy a leaf: no
    host read, no scatter of colliding slots."""
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    r, n = shard
    run = ck.shape[1]
    length = run * n
    b, s = positions.shape
    dev = ck.device
    slots = r * run + torch.arange(run, device=dev)             # (run,)
    if s > 1:
        # the prompt position that lands in each slot: the tail of the
        # prompt covers each slot at most once
        tail = min(s, length)
        first = positions[:, s - tail].long()                    # (b,)
        t = (slots[None] - first[:, None]) % length              # (b, run)
        hit = t < tail
        src = (s - tail + torch.clamp(t, max=tail - 1))
    else:
        own = (positions[:, 0].long() % length)[:, None] == slots[None]
        hit, src = own, torch.zeros((b, run), dtype=torch.long, device=dev)
    bi = torch.arange(b, device=dev)[:, None]
    for leaf, new in ((ck, k), (cv, v)):
        got = new[bi, src].to(leaf.dtype)                        # (b,run,..)
        leaf.copy_(torch.where(hit[..., None, None], got, leaf))
    cp.copy_(torch.where(hit, positions[bi, src].to(torch.int32), cp))


def cross_attn_spec(cfg: ModelConfig) -> Spec:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": ((d, h, hd), "normal"), "wk": ((d, kv, hd), "normal"),
            "wv": ((d, kv, hd), "normal"), "wo": ((h, hd, d), "normal"),
            "norm": ((d,), "zeros"), "gate": ((1,), "zeros")}


#: each leaf's logical axes (the JAX ``param`` axes)
CROSS_AXES = {**{k: ATTN_AXES[k]
                 for k in ("wq", "wk", "wv", "wo", "norm")},
              "gate": (None,)}


class CrossAttnBlock(_Block):
    """Pre-norm cross-attention to a fixed memory (patch, frame or encoder
    states) with a ``tanh(gate)`` residual gate, zero at init:
    ``forward(x, memory) -> x_out``.  Non-causal, every query and key at
    position 0 (no RoPE, no mask).  K/V are projected from the memory at
    every call, as the JAX package does."""


    def _casts(self):
        dt, d = self.cfg.dtype, self.cfg.d_model
        out = {n: getattr(self, n).reshape(d, -1).to(dt)
               for n in ("wq", "wk", "wv")}
        out["wo"] = self.wo.reshape(-1, d).to(dt)
        out["gate"] = torch.tanh(self.gate.float()).to(dt)
        return out

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        c = self.weights()
        out = self.attend(self.normed(x), memory, c=c)
        return x + c.gate * out.to(x.dtype)

    def attend(self, h: torch.Tensor, memory: torch.Tensor,
               kv_heads: Optional[torch.Tensor] = None, c=None):
        """The block's output of the normed input ``h`` before the gate
        and the residual (``forward`` applies both).  ``kv_heads`` as
        ``AttnBlock.attend``'s, for a tensor-parallel rank."""
        cfg = self.cfg
        c = self.weights() if c is None else c
        b, sq = h.shape[:2]
        sk = memory.shape[1]
        mem = memory.to(h.dtype)
        q = (h @ c.wq).reshape(b, sq, cfg.n_heads, cfg.hd)
        k = (mem @ c.wk).reshape(b, sk, cfg.n_kv_heads, cfg.hd)
        v = (mem @ c.wv).reshape(b, sk, cfg.n_kv_heads, cfg.hd)
        if kv_heads is not None:
            k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
        zeros = functools.partial(torch.zeros, dtype=torch.int32,
                                  device=h.device)
        # every position 0, no causal mask and no window: no tile is ever
        # skipped, so the tile table is not read (no host sync)
        o = attention(q, k, v, zeros((b, sq)), zeros((b, sk)), causal=False,
                      window=0, cap=None, impl=cfg.attn_impl,
                      chunk=cfg.attn_chunk, skip=False)
        return o.reshape(b, sq, -1) @ c.wo


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


#: each leaf's logical axes (the JAX ``param`` axes)
MLP_AXES = {"norm": (None,), "w_gate": ("embed", "ff"),
            "w_up": ("embed", "ff"), "w_down": ("ff", "embed"),
            "bf_theta": (None, None)}


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


class MLPBlock(_Block):
    """Pre-norm MLP with a residual: SwiGLU, GeGLU or GELU, optionally
    after the butterfly mixing (``cfg.butterfly_mlp``)."""


    def _casts(self):
        dt = self.cfg.dtype
        return {"gate": (self.w_gate.to(dt) if self.cfg.mlp_type
                         in ("swiglu", "geglu") else None),
                "up": self.w_up.to(dt), "down": self.w_down.to(dt)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.project(self.normed(x)).to(x.dtype)

    def normed(self, x: torch.Tensor) -> torch.Tensor:
        """The input the projections read: normed, then mixed where
        ``cfg.butterfly_mlp``."""
        h = super().normed(x)
        if self.cfg.butterfly_mlp:
            h = _butterfly_mix(self.bf_theta, h)
        return h

    def project(self, h: torch.Tensor) -> torch.Tensor:
        """The block's output of ``normed``'s without the residual (over
        this block's ``ff`` columns: a tensor-parallel rank's part)."""
        cfg, c = self.cfg, self.weights()
        if cfg.mlp_type == "swiglu":
            z = F.silu(h @ c.gate) * (h @ c.up)
        elif cfg.mlp_type == "geglu":
            z = F.gelu(h @ c.gate, approximate="tanh") * (h @ c.up)
        else:
            z = F.gelu(h @ c.up, approximate="tanh")
        return z @ c.down



# ---------------------------------------------------------------------------
# MoE — token-choice top-k with per-group capacity, sort-based dispatch
# ---------------------------------------------------------------------------

def moe_spec(cfg: ModelConfig) -> Spec:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.local_experts
    return {"norm": ((d,), "zeros"), "router": ((d, cfg.n_experts), "normal"),
            "w_gate": ((e, d, f), "normal"), "w_up": ((e, d, f), "normal"),
            "w_down": ((e, f, d), "normal")}


#: each leaf's logical axes (the JAX ``param`` axes)
MOE_AXES = {"norm": (None,), "router": ("embed", None),
            "w_gate": ("expert", "embed", "ff"),
            "w_up": ("expert", "embed", "ff"),
            "w_down": ("expert", "ff", "embed")}


def moe_groups(cfg: ModelConfig, b: int, s: int) -> Tuple[int, int]:
    """(tokens a dispatch group, capacity an expert and group) for a call
    on (B, S) tokens, as the JAX ``moe_block`` computes them:
    ``moe_group`` (0: S) at most B x S, cut down until it divides B x S,
    and ceil(gsz k / e x capacity_factor)."""
    gsz = min(cfg.moe_group or s, b * s)
    while (b * s) % gsz:
        gsz -= 1
    cap = int(np.ceil(gsz * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return gsz, cap


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis in descending order, a tie to the
    lower index first, as ``lax.top_k`` orders them (``torch.topk`` makes
    no promise about ties: a stable descending sort does)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEBlock(_Block):
    """Pre-norm token-choice top-k mixture of SwiGLU experts with a
    residual, the JAX ``moe_block`` exactly: groups of ``moe_groups``
    tokens (all of a call's B x S tokens in order, as the JAX reshape
    takes them), router softmax in f32, top-k weights renormalised, each
    expert's (token, choice) pairs in token order (a stable sort on the
    expert id) and the pairs past the capacity dropped: a token whose
    every pair is dropped keeps its residual.

    Combine: the JAX package scatter-adds each kept slot's weighted
    output into its token, in slot order, that is, by ascending expert
    id.  Here each token gathers its k slots and adds them in that same
    order (a dropped pair adds a zero row), so no atomics and, on the
    CPU, the JAX package's order of the compute-dtype sums.

    ``routes`` and ``kept`` keep the last call's top-k expert ids and
    which pairs fit, (groups, gsz, k), on the device (no host read).

    A tensor-parallel rank (``project``'s ``first``) routes every token
    and computes the capacity and the drops as the whole block does, so
    its dispatch is the global one; it fills and runs only its own
    experts' part of the (e, cap) table and combines only their slots
    (expert parallelism), or runs every expert over its ``ff`` columns
    (each expert Megatron-split); the ranks' parts add up to the
    block's output."""

    def __init__(self, cfg: ModelConfig, w: Dict[str, torch.Tensor],
                 live: bool = False):
        super().__init__(cfg, w, live)
        self.routes: Optional[torch.Tensor] = None
        self.kept: Optional[torch.Tensor] = None

    def _casts(self):
        dt = self.cfg.dtype
        return {"router": self.router.to(dt), "gate": self.w_gate.to(dt),
                "up": self.w_up.to(dt), "down": self.w_down.to(dt)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.project(self.normed(x)).to(x.dtype)

    def project(self, h: torch.Tensor, first: int = 0) -> torch.Tensor:
        """The block's output of the normed input ``h`` without the
        residual, over this block's experts: ``cfg.local_experts`` of
        them from expert ``first`` on, over their ``ff`` columns (a
        tensor-parallel rank's part)."""
        cfg, c = self.cfg, self.weights()
        b, s, d = h.shape
        e, k, el = cfg.n_experts, cfg.top_k, cfg.local_experts
        dev = h.device
        gsz, cap = moe_groups(cfg, b, s)
        g = b * s // gsz
        hg = h.reshape(g, gsz, d)
        probs = torch.softmax((hg @ c.router).float(), dim=-1)
        top_p, top_e = top_k(probs, k)                        # (g, gsz, k)
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

        # each pair's position among its expert's pairs, in token order
        flat_e = top_e.reshape(g, gsz * k)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        sorted_e = flat_e.gather(1, order)
        starts = torch.searchsorted(
            sorted_e, torch.arange(e, device=dev).expand(g, e).contiguous())
        rank = (torch.arange(gsz * k, device=dev)[None]
                - starts.gather(1, sorted_e))
        pos = torch.empty_like(rank).scatter_(1, order, rank).reshape(
            g, gsz, k)
        keep = pos < cap
        # slot of each pair in the (e, cap) table; a dropped pair's is the
        # trash slot e * cap
        slot = torch.where(keep, top_e * cap + pos, e * cap)

        # dispatch: the token each (expert, slot) holds (gsz: a zero row)
        table = torch.full((g, e * cap + 1), gsz, dtype=torch.long,
                           device=dev)
        tok = torch.arange(gsz, device=dev)[None, :, None].expand(g, gsz, k)
        table.scatter_(1, slot.reshape(g, -1), tok.reshape(g, -1))
        hpad = torch.cat([hg, hg.new_zeros(g, 1, d)], dim=1)
        gi = torch.arange(g, device=dev)[:, None]
        xin = hpad[gi, table[:, first * cap:(first + el) * cap]].reshape(
            g, el, cap, d)
        a = F.silu(torch.einsum("gecd,edf->gecf", xin, c.gate))
        u = torch.einsum("gecd,edf->gecf", xin, c.up)
        y = torch.einsum("gecf,efd->gecd", a * u, c.down)

        # combine: each token's kept slots, weighted, by ascending expert
        # (another rank's slot: the zero row)
        ypad = torch.cat([y.reshape(g, el * cap, d), y.new_zeros(g, 1, d)],
                         dim=1)
        slot, perm = torch.sort(slot, dim=-1)
        wts = top_p.gather(-1, perm).to(y.dtype)
        own = slot - first * cap
        own = torch.where((own >= 0) & (own < el * cap), own, el * cap)
        out = None
        for j in range(k):
            yj = ypad[gi, own[..., j]] * wts[..., j, None]
            out = yj if out is None else out + yj
        self.routes, self.kept = top_e, keep
        return out.reshape(b, s, d)


# ---------------------------------------------------------------------------
# Mamba-2 SSD block (state-space duality, chunked)
# ---------------------------------------------------------------------------

def ssd_spec(cfg: ModelConfig) -> Spec:
    d = cfg.d_model
    d_in = cfg.ssm_inner
    hs = d_in // cfg.ssm_head_dim
    n, cw = cfg.ssm_state, cfg.conv_width
    return {"norm": ((d,), "zeros"), "in_xz": ((d, 2 * d_in), "normal"),
            "in_bc": ((d, 2 * n), "normal"), "in_dt": ((d, hs), "normal"),
            "conv_x": ((cw, d_in), "normal", 0.2),
            "conv_b": ((cw, n), "normal", 0.2),
            "conv_c": ((cw, n), "normal", 0.2),
            "a_log": ((hs,), "zeros"), "dt_bias": ((hs,), "zeros"),
            "d_skip": ((hs,), "ones"), "out": ((d_in, d), "normal")}


#: each leaf's logical axes (the JAX ``param`` axes)
SSD_AXES = {"norm": (None,), "in_xz": ("embed", "inner"),
            "in_bc": ("embed", None), "in_dt": ("embed", "inner"),
            "conv_x": (None, "inner"), "conv_b": (None, None),
            "conv_c": (None, None), "a_log": ("inner",),
            "dt_bias": ("inner",), "d_skip": ("inner",),
            "out": ("inner", "embed")}


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv of x (B, S, C) with kernel (W, C) in x's
    dtype, after ``cache`` (B, W-1, C) or zeros; the terms summed in the
    JAX package's order.  Returns (out, the last W-1 inputs)."""
    w, s = kernel.shape[0], x.shape[1]
    xp = (F.pad(x, (0, 0, w - 1, 0)) if cache is None
          else torch.cat([cache.to(x.dtype), x], dim=1))
    out = xp[:, :s] * kernel[0]
    for i in range(1, w):
        out = out + xp[:, i:i + s] * kernel[i]
    return out, xp[:, xp.shape[1] - (w - 1):]


def _segsum(t: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) segment sums, entry (i, j) the sum of t
    over j < k <= i (SSD decays; -inf above the diagonal).

    Each segment is summed directly (a cumulative sum down the rows of
    t masked to k > j), the Mamba-2 reference's stable form.  The JAX
    package takes differences of one cumulative sum, cs_i - cs_j, which
    loses the digits of |cs| that a short segment does not have: at a
    chunk of 128 steps of decay ~0.7, a rounding of the inputs comes back
    ~90 times larger in the segment, and two f32 runs that add the same
    terms in another order (a tensor-parallel step) part by more than
    1e-5 of the decay parameters' gradients.  The two forms agree within
    the f32 rounding of the sums."""
    length = t.shape[-1]
    ones = torch.ones(length, length, dtype=torch.bool, device=t.device)
    terms = t[..., :, None].expand(*t.shape, length).masked_fill(
        ~torch.tril(ones, diagonal=-1), 0)              # [k, j]: t_k, k > j
    seg = torch.cumsum(terms, dim=-2)
    return seg.masked_fill(~torch.tril(ones), -math.inf)


class SSDBlock(_Block):
    """Mamba-2 SSD with a residual: ``forward(x, cache) -> (x_out,
    cache)``.  Without a cache or with S > 1 it runs the chunked form
    (quadratic within chunks of ``ssm_chunk``, the prompt zero-padded to
    a multiple with zero decays, recurrent across chunks in a loop); with
    a cache and S == 1 the single-step recurrence.  ``cache`` is one
    layer's ``{"conv": (B, W-1, d_in + 2N), "state": (B, H, P, N) f32}``,
    written in place.

    A tensor-parallel rank (``project``) holds the heads of its part of
    the inner width (``cfg.ssm_inner``) and B, C whole."""


    def _casts(self):
        dt = self.cfg.dtype
        return {name: getattr(self, name).to(dt)
                for name in ("in_xz", "in_bc", "in_dt", "dt_bias", "conv_x",
                             "conv_b", "conv_c", "out")}

    def forward(self, x: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None):
        c = self.weights()
        h = self.normed(x)
        xc, z = (h @ c.in_xz).split(self.cfg.ssm_inner, dim=-1)
        out, cache = self.project(h, xc, z, cache, c)
        return x + out.to(x.dtype), cache

    def project(self, h: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None, c=None):
        """The block's output of the normed input ``h`` without the
        residual, and the cache: ``xc`` and ``z`` are the x and z columns
        of ``h @ in_xz`` over this block's heads (a tensor-parallel rank
        gathers them: its ``in_xz`` columns are not its heads')."""
        conv = None if cache is None else cache["conv"]
        d_in, n = self.cfg.ssm_inner, self.cfg.ssm_state
        tails = None if conv is None else (conv[..., :d_in],
                                           conv[..., d_in:d_in + n],
                                           conv[..., d_in + n:])
        out, new = self.scan(h, xc, z, tails,
                             None if cache is None else cache["state"], c)
        if cache is not None:
            conv.copy_(torch.cat(new, dim=-1))
        return out, cache

    def scan(self, h: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
             tails=None, state: Optional[torch.Tensor] = None, c=None):
        """``project``'s computation: ``tails`` the convolutions' carried
        inputs (x, B, C: (B, W-1, width) each) or None, ``state`` the
        (B, H, P, N) f32 state (updated in place) or None.  Returns (the
        output, the convolutions' new tails)."""
        cfg = self.cfg
        c = self.weights() if c is None else c
        b, s, _ = h.shape
        d_in = cfg.ssm_inner
        p, n = cfg.ssm_head_dim, cfg.ssm_state
        hs = d_in // p
        bmat, cmat = (h @ c.in_bc).split(n, dim=-1)
        dt = F.softplus(h @ c.in_dt + c.dt_bias)                # (b, s, hs)
        a = -torch.exp(self.a_log.float())

        parts = (None,) * 3 if tails is None else tails
        xc, ncx = _causal_conv(F.silu(xc), c.conv_x, parts[0])
        bmat, ncb = _causal_conv(bmat, c.conv_b, parts[1])
        cmat, ncc = _causal_conv(cmat, c.conv_c, parts[2])

        xh = xc.reshape(b, s, hs, p)
        dta = dt.float() * a                                   # (b, s, hs)
        dtx = xh * dt[..., None]
        if state is not None and s == 1:
            st = state
            decay = torch.exp(dta[:, 0])[..., None, None]
            upd = (dtx[:, 0].float()[..., None]
                   * bmat[:, 0].float()[:, None, None, :])
            st.copy_(st * decay + upd)
            y = torch.einsum("bhpn,bn->bhp", st, cmat[:, 0].float())
            y = y + self.d_skip.float()[None, :, None] * xh[:, 0].float()
            y = y.reshape(b, 1, d_in)
        else:
            st0 = (state if state is not None else
                   torch.zeros((b, hs, p, n), device=h.device))
            y, st = self._chunked(dtx, bmat, cmat, dta, st0)
            y = y + self.d_skip.float()[None, None, :, None] * xh.float()
            y = y.reshape(b, s, d_in)
            if state is not None:
                state.copy_(st)
        y = y.to(h.dtype) * F.silu(z)
        return y @ c.out, (ncx, ncb, ncc)

    def _chunked(self, dtx, bmat, cmat, dta, st):
        """The chunked scan: (y (B, S, H, P) f32, the final state)."""
        b, s, hs, p = dtx.shape
        n = bmat.shape[-1]
        q = min(self.cfg.ssm_chunk, s)
        pad = (-s) % q
        if pad:  # zero inputs and zero decays leave the state untouched
            dtx = F.pad(dtx, (0, 0, 0, 0, 0, pad))
            bmat = F.pad(bmat, (0, 0, 0, pad))
            cmat = F.pad(cmat, (0, 0, 0, pad))
            dta = F.pad(dta, (0, 0, 0, pad))
        nc = (s + pad) // q
        xb = dtx.reshape(b, nc, q, hs, p).float()
        bb = bmat.reshape(b, nc, q, n).float()
        cb = cmat.reshape(b, nc, q, n).float()
        ab = dta.reshape(b, nc, q, hs)

        lmat = torch.exp(_segsum(ab.permute(0, 1, 3, 2)))     # (b,nc,hs,q,q)
        scores = torch.einsum("bcqn,bckn->bcqk", cb, bb)
        y_diag = torch.einsum("bchqk,bckhp->bcqhp",
                              lmat * scores[:, :, None], xb)
        a_cum = torch.cumsum(ab, dim=2)                        # (b,nc,q,hs)
        a_tot = a_cum[:, :, -1]                                # (b,nc,hs)
        decay_out = torch.exp(a_tot[:, :, None, :] - a_cum)
        states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", bb, decay_out, xb)
        prev = []
        for c in range(nc):
            prev.append(st)
            st = st * torch.exp(a_tot[:, c])[:, :, None, None] + states[:, c]
        y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cb,
                             torch.stack(prev, dim=1), torch.exp(a_cum))
        y = (y_diag + y_off).reshape(b, s + pad, hs, p)[:, :s]
        return y, st


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma)
# ---------------------------------------------------------------------------

def rglru_spec(cfg: ModelConfig) -> Spec:
    d = cfg.d_model
    w, full = cfg.lru_inner, cfg.lru_width or d
    return {"norm": ((d,), "zeros"), "in_x": ((d, w), "normal"),
            "in_y": ((d, w), "normal"),
            "conv": ((cfg.conv_width, w), "normal", 0.2),
            "w_r": ((w, full), "normal"), "w_i": ((w, full), "normal"),
            "lam": ((w,), "ones"), "out": ((w, d), "normal")}


#: each leaf's logical axes (the JAX ``param`` axes)
RGLRU_AXES = {"norm": (None,), "in_x": ("embed", "inner"),
              "in_y": ("embed", "inner"), "conv": (None, "inner"),
              "w_r": ("inner", None), "w_i": ("inner", None),
              "lam": ("inner",), "out": ("inner", "embed")}


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 in log2 S
    steps (Hillis-Steele over (a, b) pairs with the JAX package's
    ``combine``: (a1, b1) then (a2, b2) -> (a1 a2, b1 a2 + b2)).  Returns
    (the running products of a, h with h_{-1} = 0)."""
    s, off = a.shape[1], 1
    while off < s:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, b


class RGLRUBlock(_Block):
    """recurrentgemma's RG-LRU block with a residual: ``forward(x, cache)
    -> (x_out, cache)``.  S > 1 (or no cache) scans the recurrence with
    ``linear_scan`` and folds in the carried state; a cache and S == 1
    take one step h = h a + gated.  ``cache`` is one layer's ``{"conv":
    (B, W-1, width), "h": (B, width) f32}``, written in place.

    A tensor-parallel rank holds its part of the width (``cfg.lru_inner``)
    and the rows of ``w_r`` and ``w_i`` it reads, the gates' columns
    whole: its ``branches`` give a partial sum of each whole gate, and
    ``recur`` takes the rank's own columns of the sums."""

    C_CONST = 8.0


    def _casts(self):
        dt = self.cfg.dtype
        return {name: getattr(self, name).to(dt)
                for name in ("in_x", "in_y", "conv", "w_r", "w_i", "out")}

    def forward(self, x: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None):
        c = self.weights()
        xb, yb, new_conv = self.branches(self.normed(x), cache, c)
        out = self.recur(xb, yb, xb @ c.w_r, xb @ c.w_i, cache, new_conv, c)
        return x + out.to(x.dtype), cache

    def branches(self, h: torch.Tensor,
                 cache: Optional[Dict[str, torch.Tensor]] = None, c=None):
        """The normed input's x branch (convolved), its y branch (gelu)
        and the convolution's new tail."""
        c = self.weights() if c is None else c
        xb = h @ c.in_x
        yb = F.gelu(h @ c.in_y, approximate="tanh")
        xb, new_conv = _causal_conv(
            xb, c.conv, None if cache is None else cache["conv"])
        return xb, yb, new_conv

    def recur(self, xb: torch.Tensor, yb: torch.Tensor, r_in: torch.Tensor,
              i_in: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              new_conv: Optional[torch.Tensor] = None,
              c=None) -> torch.Tensor:
        """The block's output without the residual, the cache written:
        ``r_in`` and ``i_in`` are ``xb @ w_r`` and ``xb @ w_i`` over this
        block's width."""
        c = self.weights() if c is None else c
        s = xb.shape[1]
        r = torch.sigmoid(r_in).float()
        i = torch.sigmoid(i_in).float()
        log_a0 = -self.C_CONST * F.softplus(self.lam.float())
        log_a = log_a0 * r
        a = torch.exp(log_a)
        gated = (torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                            1e-12)) * i * xb.float())
        if cache is not None and s == 1:
            hidden = (cache["h"] * a[:, 0] + gated[:, 0])[:, None]
            cache["h"].copy_(hidden[:, 0])
        else:
            a_sc, hidden = linear_scan(a, gated)
            if cache is not None:  # prefill: fold in the carried-in state
                hidden = hidden + a_sc * cache["h"][:, None]
                cache["h"].copy_(hidden[:, -1])
        if cache is not None:
            cache["conv"].copy_(new_conv)
        return (hidden.to(yb.dtype) * yb) @ c.out
