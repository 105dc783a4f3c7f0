"""The MoE, SSD, RG-LRU and cross-attention blocks of the port
(``repro_torch.models.blocks``) against the JAX package's, on the CPU.

Blocks take numpy-seeded weights at a scale where each block's output is
of order one (norms, gates and decays away from their init, so that every
term reaches the output).  Tolerances, relative to max(1, max|y|): 1e-5
at f32 (the two packages differ in the order of their sums, the scans in
their trees), 1e-2 at bf16, where each package rounds its bf16 products
and elementwise ops in its own places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro_torch import configs
from repro_torch.interop import _leaf
from repro_torch.models import blocks

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GATE = 0.5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max|d| {err:.3e} > {bound:.3e}"
    return err


def _cfgs(arch, dtype="float32", **kw):
    jd, td = DTYPES[dtype]
    return (jconfigs.get_config(arch, smoke=True).replace(dtype=jd, **kw),
            configs.get_config(arch, smoke=True).replace(dtype=td, **kw))


def _weights(spec, rng):
    """Block weights with outputs of order one: matrices normal x 0.5 /
    sqrt(fan-in), convolutions x 0.5, zero-init leaves (norms, gates,
    a_log, dt_bias) uniform in [-0.5, 0.5] (gate: 0.5), d_skip uniform
    in [0.5, 1.5] and lam in [-4, 1], so that RG-LRU decays reach ~0.9."""
    out = {}
    for name, (shape, init, *_) in spec.items():
        if name == "gate":
            w = np.full(shape, GATE)
        elif init == "zeros":
            w = rng.uniform(-0.5, 0.5, shape)
        elif name == "lam":
            w = rng.uniform(-4.0, 1.0, shape)
        elif init == "ones":
            w = rng.uniform(0.5, 1.5, shape)
        elif name.startswith("conv"):
            w = rng.standard_normal(shape) * 0.5
        else:
            fan_in = shape[-2] if len(shape) > 1 else 1
            if name in ("wo",):
                fan_in = shape[0] * shape[1]
            w = rng.standard_normal(shape) * 0.5 / np.sqrt(fan_in)
        out[name] = w.astype(np.float32)
    return out


def _to_torch(tree):
    return {k: _leaf(a, "cpu") for k, a in tree.items()}


def _x(rng, b, s, d, dtype):
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return (jnp.asarray(x.copy(), DTYPES[dtype][0]),
            _leaf(x, "cpu").to(DTYPES[dtype][1]))


def _caches(arrays: dict, jcfg, tcfg, cast=("conv",)):
    """Each package's OWN copy of every cache array: the port's blocks
    write their caches in place, and on the CPU ``jnp.asarray`` may alias
    a numpy buffer that ``torch.from_numpy`` shares, so a shared array
    would let the port's call overwrite the JAX cache before JAX's
    asynchronous step has read it."""
    jcache = {k: jnp.asarray(a.copy(), jcfg.dtype if k in cast else None)
              for k, a in arrays.items()}
    tcache = {k: _leaf(a, "cpu").to(tcfg.dtype) if k in cast
              else _leaf(a, "cpu") for k, a in arrays.items()}
    return jcache, tcache


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sk", [8, 40])      # 40 > attn_chunk: chunked
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_attn_block_matches_jax(dtype, sk):
    jcfg, tcfg = _cfgs("llama-3.2-vision-90b", dtype, attn_chunk=16)
    rng = np.random.default_rng(sk)
    w = _weights(blocks.cross_attn_spec(tcfg), rng)
    jx, tx = _x(rng, 2, 5, tcfg.d_model, dtype)
    mem = rng.standard_normal((2, sk, tcfg.d_model)).astype(np.float32)
    want = jblocks.cross_attn_block(jax.tree.map(jnp.asarray, w), jx,
                                    jnp.asarray(mem), jcfg)
    got = blocks.CrossAttnBlock(tcfg, _to_torch(w))(tx, torch.from_numpy(mem))
    _close(got, want, BLOCK_TOL[dtype])
    assert float(np.abs(_np(got) - _np(tx)).max()) > 0.1   # memory reached


def _moe(dtype, capacity_factor, router=None, seed=0):
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", dtype,
                       capacity_factor=capacity_factor)
    rng = np.random.default_rng(seed)
    w = _weights(blocks.moe_spec(tcfg), rng)
    if router is not None:
        w["router"] = router(w["router"])
    jx, tx = _x(rng, 2, 12, tcfg.d_model, dtype)
    want = jblocks.moe_block(jax.tree.map(jnp.asarray, w), jx, jcfg)
    blk = blocks.MoEBlock(tcfg, _to_torch(w))
    return blk(tx), want, blk, tx


@pytest.mark.parametrize("capacity_factor,drops", [
    (1.25, True), (0.25, True), (8.0, False)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_block_matches_jax(dtype, capacity_factor, drops):
    got, want, blk, tx = _moe(dtype, capacity_factor)
    _close(got, want, BLOCK_TOL[dtype])
    dropped = int((~blk.kept).sum())
    assert (dropped > 0) == drops
    assert blk.routes.shape == (2, 12, 2)    # moe_group 0: one group a row
    if capacity_factor == 0.25:
        # cap 1 an expert and row: a token whose pairs all drop keeps its
        # residual exactly
        gone = (~blk.kept).all(-1).reshape(2, 12)
        assert bool(gone.any())
        assert torch.equal(got[gone], tx[gone])


@pytest.mark.parametrize("tie", ["all", "pair"])
def test_moe_top_k_ties_go_to_the_lower_index(tie):
    """A zero router ties every expert (lax.top_k takes experts 0 and 1);
    two equal router columns tie that pair wherever it leads."""
    def router(r):
        if tie == "all":
            return np.zeros_like(r)
        r = r.copy()
        r[:, 5] = r[:, 3]
        return r

    got, want, blk, _ = _moe("float32", 1.25, router, seed=3)
    _close(got, want, BLOCK_TOL["float32"])
    if tie == "all":
        assert torch.equal(blk.routes, torch.tensor([0, 1]).expand(2, 12, 2))
    probs = np.random.default_rng(0).integers(0, 3, (64, 9)).astype(
        np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 4)
    tv, ti = blocks.top_k(torch.from_numpy(probs), 4)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def _run_modes(jfn, tfn, jx, tx, jcache, tcache, s, steps, tol):
    """No cache over the whole input; then a prefill of s tokens and
    ``steps`` single-token decodes, caches compared after each call (at
    bf16 within 2e-2: the f32 states sum bf16 inputs, dt and the gates,
    that the two packages round an ulp apart now and then)."""
    # each JAX call is finished before the port's call runs
    want, _ = jax.block_until_ready(jfn(jx, None))
    got, _ = tfn(tx, None)
    _close(got, want, tol)
    want, jcache = jax.block_until_ready(jfn(jx[:, :s], jcache))
    got, tcache = tfn(tx[:, :s], tcache)
    _close(got, want, tol)
    for t in range(s, s + steps):
        want, jcache = jax.block_until_ready(jfn(jx[:, t:t + 1], jcache))
        got, tcache = tfn(tx[:, t:t + 1], tcache)
        _close(got, want, tol)
        for key in tcache:
            _close(tcache[key], jcache[key], max(tol, 2e-2 if tol > 1e-4
                                                 else tol))


@pytest.mark.parametrize("s", [40, 16, 5])   # chunk 16: padded, exact, one
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_block_modes_match_jax(dtype, s):
    jcfg, tcfg = _cfgs("mamba2-780m", dtype)
    rng = np.random.default_rng(s)
    w = _weights(blocks.ssd_spec(tcfg), rng)
    jw = jax.tree.map(jnp.asarray, w)
    jx, tx = _x(rng, 2, s + 3, tcfg.d_model, dtype)
    d_in = tcfg.ssm_expand * tcfg.d_model
    hs, p, n = d_in // tcfg.ssm_head_dim, tcfg.ssm_head_dim, tcfg.ssm_state
    jcache, tcache = _caches(
        {"conv": np.zeros((2, tcfg.conv_width - 1, d_in + 2 * n),
                          np.float32),
         "state": np.zeros((2, hs, p, n), np.float32)}, jcfg, tcfg)
    blk = blocks.SSDBlock(tcfg, _to_torch(w))
    _run_modes(lambda x, c: jblocks.ssd_block(jw, x, jcfg, c),
               lambda x, c: blk(x, c), jx, tx, jcache, tcache, s, 3,
               BLOCK_TOL[dtype])


@pytest.mark.parametrize("s", [37, 8, 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_block_modes_match_jax(dtype, s):
    jcfg, tcfg = _cfgs("recurrentgemma-2b", dtype)
    rng = np.random.default_rng(s)
    w = _weights(blocks.rglru_spec(tcfg), rng)
    jw = jax.tree.map(jnp.asarray, w)
    jx, tx = _x(rng, 2, s + 3, tcfg.d_model, dtype)
    jcache, tcache = _caches(
        {"conv": np.zeros((2, tcfg.conv_width - 1, tcfg.lru_width),
                          np.float32),
         "h": np.zeros((2, tcfg.lru_width), np.float32)}, jcfg, tcfg)
    blk = blocks.RGLRUBlock(tcfg, _to_torch(w))
    _run_modes(lambda x, c: jblocks.rglru_block(jw, x, jcfg, c),
               lambda x, c: blk(x, c), jx, tx, jcache, tcache, s, 3,
               BLOCK_TOL[dtype])


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3)))
    b = torch.from_numpy(rng.standard_normal((2, 37, 3)))
    a_sc, h_sc = blocks.linear_scan(a, b)
    h = torch.zeros(2, 3, dtype=torch.float64)
    prod = torch.ones(2, 3, dtype=torch.float64)
    for t in range(37):
        h = h * a[:, t] + b[:, t]
        prod = prod * a[:, t]
        assert torch.allclose(h_sc[:, t], h) and torch.allclose(
            a_sc[:, t], prod)
