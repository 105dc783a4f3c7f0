"""Shared model machinery: the config, norms, RoPE and attention (naive
and chunked online softmax), as the JAX package's ``models/common.py``
computes them, in plain torch ops.

Where the JAX package asks for an f32 product of bf16 operands
(``preferred_element_type=jnp.float32``), the operands are widened to
f32 before the product: a bf16 x bf16 product is exact in f32, so the
two differ only in the order of the sums.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab: int = 512
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mlp_type: str = "swiglu"       # swiglu | geglu | gelu
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    local_window: int = 0          # >0 enables local attention layers
    layer_pattern: str = "global"  # global | local_global | rrl | cross5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 0             # tokens per dispatch group (0 = per-seq)
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_expand: int = 2
    conv_width: int = 4
    # RG-LRU (recurrentgemma)
    lru_width: int = 0
    # enc-dec
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_ratio: int = 4             # encoder frames = seq // enc_ratio
    # vlm
    cross_every: int = 0           # every k-th layer is cross-attn
    num_patches: int = 0
    # numerics
    rms_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attn_impl: str = "chunked"     # chunked | naive
    attn_chunk: int = 1024
    attn_skip: bool = True         # causal/window/pad KV-chunk skipping
    remat_block: int = 1           # layers per activation-checkpoint block
    # paper integration
    butterfly_mlp: bool = False    # ButterflyLinear fast mixing in MLP blocks

    #: the parts a tensor-parallel rank's config (``RankConfig``) cuts the
    #: "inner" (SSD and RG-LRU) widths and the experts into; 1 for a
    #: whole model.  Not fields, so that a config compares field for
    #: field with the JAX package's.
    inner_parts = 1
    expert_parts = 1

    @property
    def ssm_inner(self) -> int:
        """The SSD inner width the parameters hold (a rank's part)."""
        return self.ssm_expand * self.d_model // self.inner_parts

    @property
    def lru_inner(self) -> int:
        """The RG-LRU width the parameters hold (a rank's part)."""
        return (self.lru_width or self.d_model) // self.inner_parts

    @property
    def local_experts(self) -> int:
        """The experts the parameters hold (a rank's part)."""
        return self.n_experts // self.expert_parts

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def q_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RankConfig(ModelConfig):
    """One tensor-parallel rank's config (``transformer.local_config``):
    the whole model's fields with the split counts cut, and the parts its
    "inner" widths and experts are cut into.  ``d_model``, the router's
    expert count and the RG-LRU gates' output width stay whole."""
    inner_parts: int = 1
    expert_parts: int = 1


class Axes:
    """A leaf holding one tensor's logical axis names (the JAX package's
    ``Axes``): an axes tree (``transformer.param_axes``, ``cache_axes``)
    has the structure of the tensors' tree, with one ``Axes`` where each
    tensor is; ``runtime/sharding.py`` maps it onto a mesh."""

    __slots__ = ("axes",)

    def __init__(self, axes):
        self.axes = tuple(axes)

    def __eq__(self, other):
        return isinstance(other, Axes) and self.axes == other.axes

    def __repr__(self):
        return f"Axes{self.axes}"


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: the second moment accumulates in f32 and only the
    per-position scale is rounded to x.dtype."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    scale = torch.rsqrt(var[..., None] + eps)
    mult = (scale * (1.0 + w.float())).to(x.dtype)
    return x * mult


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> (sin, cos) of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); sin/cos: (B, S, hd//2) or broadcastable."""
    half = x.shape[-1] // 2
    sin = sin[..., None, :].float()
    cos = cos[..., None, :].float()
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin,
                      x2f * cos + x1f * sin], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def scaled(x: torch.Tensor, factor: float) -> torch.Tensor:
    """x * factor with the factor first rounded to x.dtype, as a JAX
    array times a Python float computes it (the float is weakly typed)."""
    return x * torch.tensor(factor, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / local; naive + chunked online softmax)
# ---------------------------------------------------------------------------

_MASK_VALUE = -1e30
PAD_POS = 2 ** 30  # sentinel position of padded / empty KV slots


def _scores(q, k, scale, cap):
    """q: (B,Sq,KV,R,hd) k: (B,Sk,KV,hd) -> (B,KV,R,Sq,Sk) in f32."""
    qf = q.float().permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 3, 1).unsqueeze(2)
    return softcap(torch.matmul(qf, kf) * scale, cap)


def _mix(p, v):
    """p: (B,KV,R,Sq,Sk) in v's dtype, v: (B,Sk,KV,hd) -> (B,Sq,KV,R,hd)."""
    o = torch.matmul(p, v.permute(0, 2, 1, 3).unsqueeze(2))
    return o.permute(0, 3, 1, 2, 4)


def _mask(q_pos, k_pos, causal: bool, window: int):
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    m = kp < PAD_POS  # padded KV chunks / empty cache slots never attend
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return m  # (B, Sq, Sk)


def checkpointed(fn, *args):
    """``fn(*args)`` under an activation checkpoint (``jax.checkpoint``):
    its activations are recomputed in the backward."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _tile_table(posp, qpos_p, b, n_chunks, chunk, n_qb, qb, causal, window):
    """Which (query block, KV chunk) tiles attend: the tile rule of the JAX
    package's lax.cond, over the whole batch, read to the host.  A
    ``meta`` trace has no positions to read: every tile counts as
    computed, as the JAX package's cost walk sums both branches of the
    cond (a skipped tile's branch is trivial)."""
    if posp.device.type == "meta":
        return [[True] * n_chunks for _ in range(n_qb)]
    pc = posp.reshape(b, n_chunks, chunk)
    qc = qpos_p.reshape(b, n_qb, qb)
    pmin, pmax = pc.amin(dim=(0, 2)), pc.amax(dim=(0, 2))
    qmin, qmax = qc.amin(dim=(0, 2)), qc.amax(dim=(0, 2))
    need = (pmin < PAD_POS)[None, :].expand(n_qb, n_chunks)
    if causal:
        need = need & (pmin[None, :] <= qmax[:, None])
    if window > 0:
        need = need & (pmax[None, :] > qmin[:, None] - window)
    return need.tolist()


def attention(q, k, v, q_pos, k_pos, *, causal=True, window=0, cap=None,
              impl="chunked", chunk=1024, skip=True, tiles=None):
    """GQA attention.

    q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd); q_pos (B, Sq), k_pos (B, Sk)
    int.  Returns (B, Sq, H, hd) in q's dtype.  ``impl="chunked"`` streams
    KV in chunks of ``chunk`` with an online softmax, over query blocks of
    at most ``chunk`` rows; ``skip`` leaves out a (query block, KV chunk)
    tile that is entirely in the future, outside the window or padding,
    decided for all tiles of the call in one read on the host.  ``tiles``:
    a dict that the calls of one forward share, over the same positions as
    queries and keys; the tables read are kept in it, so that a layer's
    recomputation in a checkpointed backward reads none (no host sync in
    the backward).  Where a gradient is wanted, each KV
    step and each of several query blocks is checkpointed, as the JAX
    package checkpoints them.
    """
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg = q.reshape(b, sq, kv, rep, hd)
    scale = 1.0 / math.sqrt(hd)

    if impl == "naive" or k.shape[1] <= chunk:
        s = _scores(qg, k, scale, cap)
        m = _mask(q_pos, k_pos, causal, window)
        s = torch.where(m[:, None, None], s, _MASK_VALUE)
        p = torch.softmax(s, dim=-1)
        return _mix(p.to(v.dtype), v).reshape(b, sq, h, hd)

    sk = k.shape[1]
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    posp = F.pad(k_pos, (0, pad), value=PAD_POS)
    qb = min(chunk, sq)
    n_qb = -(-sq // qb)
    pad_q = n_qb * qb - sq
    qp_ = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad_q))
    qpos_p = F.pad(q_pos, (0, pad_q), value=0)

    needed = None
    if skip:
        key = (causal, window, chunk)
        needed = None if tiles is None else tiles.get(key)
        if needed is None:
            needed = _tile_table(posp, qpos_p, b, n_chunks, chunk, n_qb, qb,
                                 causal, window)
            if tiles is not None:
                tiles[key] = needed
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)

    def kv_step(m_run, l_run, acc, qgb, qposb, kch, vch, pch):
        s = _scores(qgb, kch, scale, cap)              # (B,KV,R,qb,C)
        msk = _mask(qposb, pch, causal, window)
        s = torch.where(msk[:, None, None], s, _MASK_VALUE)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = _mix(p.to(vch.dtype), vch)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        return m_new, l_run, acc

    def q_block(i, qgb, qposb):
        m_run = torch.full((b, kv, rep, qb), -math.inf, device=q.device)
        l_run = torch.zeros((b, kv, rep, qb), device=q.device)
        acc = torch.zeros((b, qb, kv, rep, hd), device=q.device)
        for c in range(n_chunks):
            if needed is not None and not needed[i][c]:
                continue
            args = (m_run, l_run, acc, qgb, qposb,
                    kp[:, c * chunk:(c + 1) * chunk],
                    vp[:, c * chunk:(c + 1) * chunk],
                    posp[:, c * chunk:(c + 1) * chunk])
            m_run, l_run, acc = (checkpointed(kv_step, *args) if grad
                                 else kv_step(*args))
        denom = l_run.permute(0, 3, 1, 2)[..., None]
        return (acc / torch.clamp_min(denom, 1e-30)).to(q.dtype)

    outs = []
    for i in range(n_qb):
        args = (i, qp_[:, i * qb:(i + 1) * qb],         # (B,qb,KV,R,hd)
                qpos_p[:, i * qb:(i + 1) * qb])
        outs.append(checkpointed(q_block, *args) if grad and n_qb > 1
                    else q_block(*args))
    out = torch.cat(outs, dim=1)[:, :sq]
    return out.reshape(b, sq, h, hd)


def attention_partial(q, k, v, q_pos, k_pos, *, window=0, cap=None):
    """One run of a causal attention's keys, for runs split over several
    ranks (a decode cache split along ``kv_seq``): (m, l, acc), the run's
    masked score maximum (B, KV, R, Sq) in f32, the sum of the scores'
    exponentials less m, and the values weighted by them (B, Sq, KV, R,
    hd) in f32.  ``combine_partials`` adds the runs as the online
    softmax adds KV chunks.  A run with no key in the mask gives m at the
    mask value, and the combination weighs it by exp(mask - max) = 0."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    s = _scores(qg, k, 1.0 / math.sqrt(hd), cap)
    m = _mask(q_pos, k_pos, True, window)
    s = torch.where(m[:, None, None], s, _MASK_VALUE)
    top = s.amax(dim=-1)
    p = torch.exp(s - top[..., None])
    return top, p.sum(dim=-1), _mix(p.to(v.dtype), v).float()


def combine_partials(group, parts, dtype):
    """The attention output (B, Sq, H, hd) in ``dtype`` of each member of
    ``group`` (a ``collectives.Group`` or ``Groups``) from the members'
    ``attention_partial`` runs: the maximum over the group, each run's
    sum and weighted values rescaled to it and added over the group,
    then divided (three all-reduces)."""
    tops = group.max([m for m, _, _ in parts])
    scale = [torch.exp(m - t) for (m, _, _), t in zip(parts, tops)]
    sums = group.all_reduce([lv * w for (_, lv, _), w in zip(parts, scale)])
    accs = group.all_reduce([acc * w.permute(0, 3, 1, 2)[..., None]
                             for (_, _, acc), w in zip(parts, scale)])
    out = []
    for acc, lv in zip(accs, sums):
        b, sq, kv, rep, hd = acc.shape
        denom = torch.clamp_min(lv.permute(0, 3, 1, 2)[..., None], 1e-30)
        out.append((acc / denom).to(dtype).reshape(b, sq, kv * rep, hd))
    return out
