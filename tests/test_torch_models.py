"""The port's LM scaffold (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's on the CPU, at the configs' smoke sizes.

Inputs come from numpy with a seed; weights are drawn by the JAX package
and carried across with ``interop.lm_params_from_numpy``.  Tolerances:
1e-5 for the primitives and attention at f32 (the two differ in the
order of their sums), 1e-4 * max(1, max|logits|) for whole models at f32,
and ``BF16_TOL`` * max(1, max|logits|) at the configs' bf16, where each
package rounds its bf16 products and elementwise ops in its own places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.interop import (_leaf, lm_cache_from_numpy,
                                 lm_params_from_numpy)
from repro_torch.models import blocks, common
from repro_torch.models import transformer as tfm

PORTED = ["qwen2-1.5b", "qwen2-7b", "glm4-9b", "gemma2-27b"]
#: one architecture of each of the other families (MoE, hybrid, SSM,
#: vision, audio; their parity tests: tests/test_torch_lm_families.py)
FAMILIES = ["qwen3-moe-30b-a3b", "recurrentgemma-2b", "mamba2-780m",
            "llama-3.2-vision-90b", "seamless-m4t-large-v2"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-4
BF16_TOL = 1e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cfgs(arch, dtype="float32", **kw):
    jd, td = DTYPES[dtype]
    return (jconfigs.get_config(arch, smoke=True).replace(dtype=jd, **kw),
            configs.get_config(arch, smoke=True).replace(dtype=td, **kw))


def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max|d| {err:.3e} > {bound:.3e}"
    return err


def _carry(jcfg, tcfg, seed):
    params, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, tree, tfm.Transformer(
        tcfg, lm_params_from_numpy(tcfg, tree, device="cpu"))


# ---------------------------------------------------------------------------
# primitives and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_rope_softcap_match_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(common.rmsnorm(tx, torch.from_numpy(w), 1e-6),
           jcommon.rmsnorm(jx, jnp.asarray(w), 1e-6), tol)
    jsin, jcos = jcommon.rope_tables(jnp.asarray(pos), 16, 1e4)
    tsin, tcos = common.rope_tables(torch.from_numpy(pos), 16, 1e4)
    # positions up to 4096: an angle carries ~4096 ulp of its frequency
    _close(tsin, jsin, 1e-3)
    _close(tcos, jcos, 1e-3)
    _close(common.apply_rope(tx, _leaf(jsin, "cpu"), _leaf(jcos, "cpu")),
           jcommon.apply_rope(jx, jsin, jcos), tol)
    _close(common.softcap(tx * 40, 30.0), jcommon.softcap(jx * 40, 30.0),
           tol)
    assert common.softcap(tx, None) is tx


ATTN_CASES = {
    # name: (impl, chunk, skip, causal, window, kv heads, pad slots, Sq)
    "naive": ("naive", 1024, True, True, 0, 2, False, 24),
    "naive-window": ("naive", 1024, True, True, 5, 2, False, 24),
    "naive-mha-bidir": ("naive", 1024, True, False, 0, 4, False, 24),
    "chunked-skip": ("chunked", 8, True, True, 0, 2, False, 24),
    "chunked-noskip": ("chunked", 8, False, True, 0, 2, False, 24),
    "chunked-window-skip": ("chunked", 8, True, True, 5, 1, False, 24),
    "chunked-window-noskip": ("chunked", 8, False, True, 5, 1, False, 24),
    "chunked-ragged-q": ("chunked", 8, True, True, 0, 2, False, 19),
    "chunked-pad-slots": ("chunked", 8, True, True, 0, 2, True, 1),
    "naive-pad-slots": ("naive", 1024, True, True, 0, 2, True, 1),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_jax(case):
    impl, chunk, skip, causal, window, kv, padded, sq = ATTN_CASES[case]
    rng = np.random.default_rng(1)
    b, sk, h, hd = 2, 24, 4, 8
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    if padded:
        # a decode row against a cache whose tail slots are empty
        k_pos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
        k_pos[:, 13:] = 2 ** 30
        q_pos = np.array([[12], [9]], np.int32)
    else:
        k_pos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
        q_pos = k_pos[:, sk - sq:]
    kw = dict(causal=causal, window=window, cap=50.0 if kv == 1 else None,
              impl=impl, chunk=chunk, skip=skip)
    want = jcommon.attention(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                             **kw)
    got = common.attention(*map(torch.from_numpy, (q, k, v, q_pos, k_pos)),
                           **kw)
    _close(got, want, 1e-5)


def test_local_window_masks_context():
    """gemma2-style local attention only sees `window` tokens back."""
    rng = np.random.default_rng(4)
    b, s, h, kv, hd = 1, 24, 2, 1, 8
    q = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, kv, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kv, hd)).astype(
        np.float32))
    pos = torch.arange(s)[None, :]
    out1 = common.attention(q, k, v, pos, pos, causal=True, window=4,
                            impl="naive")
    # perturb a key far outside every query's window
    k2, v2 = k.clone(), v.clone()
    k2[:, 0] += 100.0
    v2[:, 0] += 100.0
    out2 = common.attention(q, k2, v2, pos, pos, causal=True, window=4,
                            impl="naive")
    np.testing.assert_allclose(out1[:, 8:].numpy(), out2[:, 8:].numpy(),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block_weights(spec, rng):
    """Random weights for a block spec, norms and biases included."""
    return {k: (rng.standard_normal(shape) * (0.02 if init == "normal"
                                              else 0.1)).astype(np.float32)
            for k, (shape, init) in spec.items()}


def _layer_cache(cfg, b, length):
    """One layer's empty cache in f32: a bf16 cache would turn f32 K/V
    that differ in the last ulp into bf16 entries a whole bf16 ulp apart
    now and then."""
    return {"k": np.zeros((b, length, cfg.n_kv_heads, cfg.hd), np.float32),
            "v": np.zeros((b, length, cfg.n_kv_heads, cfg.hd), np.float32),
            "pos": np.full((b, length), 2 ** 30, np.int32)}


def _in_dtype(jcache, dtype):
    """A JAX cache (bf16 K/V at every config dtype) with its K/V in
    ``dtype``."""
    return jax.tree.map(lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16
                        else a, jcache)


def _to_torch(tree):
    return {k: _leaf(a, "cpu") for k, a in tree.items()}


def _cache_close(got, want):
    """K/V to f32 rounding, positions exactly."""
    assert np.array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,window,length", [
    ("qwen2-1.5b", 0, 32), ("glm4-9b", 0, 32),
    ("gemma2-27b", 8, 8),       # a ring buffer: local window 8
])
def test_attn_block_modes_match_jax(arch, window, length):
    jcfg, tcfg = _cfgs(arch, local_window=window or 32)
    rng = np.random.default_rng(2)
    w = _block_weights(blocks.attn_spec(tcfg), rng)
    blk = blocks.AttnBlock(tcfg, _to_torch(w))
    jw = jax.tree.map(jnp.asarray, w)
    b, s = 2, 20
    x = rng.standard_normal((b, s + 4, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s + 4, dtype=np.int32), (b, 1))
    # no cache
    want, _ = jblocks.attn_block(jw, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos), window=window)
    got, _ = blk(torch.from_numpy(x), torch.from_numpy(pos), window=window)
    _close(got, want, 1e-5)
    # prefill of s tokens, then decode four
    jc = jax.tree.map(jnp.asarray, _layer_cache(jcfg, b, length))
    tc = _to_torch(_layer_cache(jcfg, b, length))
    want, jc = jblocks.attn_block(jw, jnp.asarray(x[:, :s]), jcfg,
                                  positions=jnp.asarray(pos[:, :s]),
                                  window=window, cache=jc)
    got, tc = blk(torch.from_numpy(x[:, :s]), torch.from_numpy(pos[:, :s]),
                  window=window, cache=tc)
    _close(got, want, 1e-5)
    _cache_close(tc, jc)
    for t in range(s, s + 4):
        want, jc = jblocks.attn_block(jw, jnp.asarray(x[:, t:t + 1]), jcfg,
                                      positions=jnp.asarray(pos[:, t:t + 1]),
                                      window=window, cache=jc)
        got, tc = blk(torch.from_numpy(x[:, t:t + 1]),
                      torch.from_numpy(pos[:, t:t + 1]), window=window,
                      cache=tc)
        _close(got, want, 1e-5)
        _cache_close(tc, jc)


@pytest.mark.parametrize("mlp_type,d,butterfly", [
    ("swiglu", 64, False), ("geglu", 64, False), ("gelu", 64, False),
    ("swiglu", 64, True), ("geglu", 96, True), ("gelu", 48, True),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_block_matches_jax(mlp_type, d, butterfly, dtype):
    jcfg, tcfg = _cfgs("qwen2-1.5b", dtype, mlp_type=mlp_type, d_model=d,
                       butterfly_mlp=butterfly)
    rng = np.random.default_rng(3)
    w = _block_weights(blocks.mlp_spec(tcfg), rng)
    if butterfly:
        w["bf_theta"] = rng.uniform(-np.pi, np.pi, w["bf_theta"].shape
                                    ).astype(np.float32)
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = jblocks.mlp_block(jax.tree.map(jnp.asarray, w),
                             jnp.asarray(x, jcfg.dtype), jcfg)
    got = blocks.MLPBlock(tcfg, _to_torch(w))(
        torch.from_numpy(x).to(tcfg.dtype))
    _close(got, want, 1e-5 if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("d", [64, 96, 1536])
def test_butterfly_mix_matches_jax_scatter(d):
    """Each stage gather-only with JAX's last write where d is not a
    power of two (96: repeated jj at stride 64; 1536: at stride 1024)."""
    rng = np.random.default_rng(d)
    depth = max(int(np.ceil(np.log2(d))), 1)
    theta = rng.uniform(-np.pi, np.pi, (depth, d // 2)).astype(np.float32)
    x = rng.standard_normal((3, d)).astype(np.float32)
    want = jblocks._butterfly_mix(jnp.asarray(theta), jnp.asarray(x))
    got = blocks._butterfly_mix(torch.from_numpy(theta), torch.from_numpy(x))
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", PORTED)
def test_forward_prefill_decode_match_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jparams, _, model = _carry(jcfg, tcfg, seed=2)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    b, s = 2, 24
    toks = _batch(tcfg, b, s + 3, seed=2)
    _close(model.forward(toks), jtfm.forward(jparams, jcfg,
                                             {"tokens": toks}), tol)
    # the caches in the compute dtype: the JAX package's bf16 cache at
    # f32 would round f32 K/V that differ in their last ulp a bf16 ulp
    # apart now and then
    jcache = _in_dtype(jtfm.init_cache(jcfg, b, 32)[0], jcfg.dtype)
    tcache = tfm.init_cache(tcfg, b, 32, device="cpu", dtype=tcfg.dtype)
    jl, jcache, _ = jtfm.prefill(jparams, jcfg, jcache,
                                 {"tokens": toks[:, :s]})
    tl, tcache, _ = model.prefill(tcache, toks[:, :s])
    _close(tl, jl, tol)
    for t in range(s, s + 3):
        db = {"token": toks[:, t:t + 1], "pos": np.full((b,), t, np.int32)}
        jl, jcache = jtfm.decode_step(jparams, jcfg, jcache, db)
        tl, tcache = model.decode_step(tcache, db["token"], db["pos"])
        _close(tl, jl, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", PORTED)
def test_decode_from_a_carried_jax_cache(arch, dtype):
    """A JAX prefill's cache (K/V in the compute dtype: bf16, the JAX
    package's own, or f32) carried across decodes as the JAX cache does
    (``lm_cache_from_numpy``)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jparams, _, model = _carry(jcfg, tcfg, seed=5)
    toks = _batch(tcfg, 2, 17, seed=5)
    jcache = _in_dtype(jtfm.init_cache(jcfg, 2, 32)[0], jcfg.dtype)
    _, jcache, _ = jtfm.prefill(jparams, jcfg, jcache,
                                {"tokens": toks[:, :16]})
    tcache = lm_cache_from_numpy(tcfg, jax.tree.map(np.asarray, jcache),
                                 device="cpu")
    assert tcache["dense" if "lg" not in tcache else "lg"]
    db = {"token": toks[:, 16:], "pos": np.full((2,), 16, np.int32)}
    jl, _ = jtfm.decode_step(jparams, jcfg, jcache, db)
    tl, _ = model.decode_step(tcache, db["token"], db["pos"])
    _close(tl, jl, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_forward(arch):
    """The port on its own weights: prefill + one decode equal the
    forward of the extended sequence (the JAX package's test and bound,
    at the configs' bf16)."""
    cfg = configs.get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(2)
    model = tfm.Transformer(cfg, tfm.init_params(cfg, gen, device="cpu"))
    b, s = 2, 32
    toks = _batch(cfg, b, s, seed=2)
    cache = tfm.init_cache(cfg, b, 64, device="cpu")
    logits_p, cache, _ = model.prefill(cache, toks)
    tok = logits_p[:, -1].argmax(-1)[:, None]
    logits_d, _ = model.decode_step(cache, tok, torch.full((b,), s))
    logits_f = model.forward(np.concatenate([toks, tok.numpy()], 1))
    assert float((logits_f[:, s - 1] - logits_p[:, 0]).abs().max()) < 0.005
    assert float((logits_f[:, s] - logits_d[:, 0]).abs().max()) < 0.005


def test_params_from_numpy_rejects_a_wrong_tree():
    jcfg, tcfg = _cfgs("qwen2-1.5b")
    params, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tree["groups"]["dense"]["attn"]["wq"] = tree["groups"]["dense"][
        "attn"]["wq"][:, :, :2]
    with pytest.raises(ValueError, match="wq"):
        lm_params_from_numpy(tcfg, tree, device="cpu")


# ---------------------------------------------------------------------------
# configs and group plans
# ---------------------------------------------------------------------------

def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            val = str(val).split(".")[-1].split("'")[0]
        out[f.name] = val
    return out


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_configs_and_group_plans_equal_jax(arch, smoke):
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    tcfg = configs.get_config(arch, smoke=smoke)
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.hd == jcfg.hd
    if jcfg.n_kv_heads:
        assert tcfg.q_rep == jcfg.q_rep
    assert tfm.group_plan(tcfg) == jtfm.group_plan(jcfg)


def test_registry_and_shapes_equal_jax():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert configs.RECIPES == jconfigs.RECIPES
    for arch in configs.ARCH_NAMES:
        t, j = configs.get_recipe(arch), jconfigs.get_recipe(arch)
        assert t.keys() == j.keys() and t["fsdp"] == j["fsdp"]
        assert str(t["moment_dtype"]).split(".")[-1] == \
            j["moment_dtype"].__name__
    assert configs.SHAPES == jconfigs.SHAPES
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert configs.cells(configs.ARCH_NAMES) == \
        jconfigs.cells(jconfigs.ARCH_NAMES)


@pytest.mark.parametrize("arch", FAMILIES)
def test_unported_families_are_refused(arch):
    """These families were refused until their blocks were ported; now
    the parameter spec, parameters and cache build on the CPU in the JAX
    package's trees."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    spec = tfm.param_spec(cfg)
    params = tfm.init_params(cfg, device="cpu")
    want = jax.tree.map(lambda a: a.shape,
                        jtfm.init_params(jcfg, abstract=True)[0])
    got = tfm.tree_map(lambda t: tuple(t.shape), params)
    assert got == want
    assert tfm.tree_map(lambda leaf: leaf.shape, spec) == want
    cache = tfm.init_cache(cfg, 1, 8, device="cpu")
    jcache = jtfm.init_cache(jcfg, 1, 8, abstract=True)[0]
    assert tfm.tree_map(lambda t: (tuple(t.shape), str(t.dtype)), cache) == \
        jax.tree.map(lambda a: (a.shape, f"torch.{a.dtype}"), jcache)
