"""The six architectures of the MoE, SSM, hybrid, vision and audio
families in the port (``repro_torch.models.transformer``: the new groups,
the encoder, memory through forward, prefill and decode) against the JAX
package's, on the CPU at the configs' smoke sizes.

Weights are the JAX package's own draws, carried across with
``interop.lm_params_from_numpy``, with the cross-attention gates set to
0.5 (their init, 0, would hide the memory).  Tolerances, relative to
max(1, max|logits|): 1e-4 at f32 (the two packages differ in the order
of their sums, the scans in their trees), 1e-2 at bf16, where each
package rounds its bf16 products and elementwise ops in its own places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import transformer as tfm

FAMILIES = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "mamba2-780m",
            "recurrentgemma-2b", "llama-3.2-vision-90b",
            "seamless-m4t-large-v2"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
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


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def gated(tree, value=GATE):
    """A JAX parameter tree (numpy leaves) with its cross-attention gates
    set to ``value``."""
    for grp in list(tree["groups"].values()):
        if "cross" in grp:
            grp["cross"]["gate"] = np.full_like(grp["cross"]["gate"], value)
    return tree


def _carry(jcfg, tcfg, seed):
    params, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = gated(jax.tree.map(np.asarray, params))
    return (jax.tree.map(jnp.asarray, tree),
            tfm.Transformer(tcfg, lm_params_from_numpy(tcfg, tree, "cpu")))


def _memory(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        shape = (b, cfg.num_patches, cfg.d_model)
    elif cfg.family == "audio":
        shape = (b, max(s // cfg.enc_ratio, 1), cfg.d_model)
    else:
        return None
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def _in_dtype(jcache, dtype):
    """A JAX cache with its bf16 leaves (K/V, conv tails) in ``dtype``."""
    return jax.tree.map(lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16
                        else a, jcache)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_decode_match_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jparams, model = _carry(jcfg, tcfg, seed=2)
    tol = MODEL_TOL[dtype]
    b, s = 2, 24
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (b, s + 3))
    mem = _memory(tcfg, b, s, seed=2)
    jb = {"tokens": toks} if mem is None else {"tokens": toks, "memory": mem}
    _close(model.forward(toks, mem), jtfm.forward(jparams, jcfg, jb), tol)
    # caches in the compute dtype (see test_torch_models.py)
    jcache = _in_dtype(jtfm.init_cache(jcfg, b, 32)[0], jcfg.dtype)
    tcache = tfm.init_cache(tcfg, b, 32, device="cpu", dtype=tcfg.dtype)
    jb["tokens"] = toks[:, :s]
    jl, jcache, jmem = jtfm.prefill(jparams, jcfg, jcache, jb)
    tl, tcache, tmem = model.prefill(tcache, toks[:, :s], mem)
    _close(tl, jl, tol)
    assert (tmem is None) == (jmem is None)
    if jmem is not None:   # audio: the encoded frames
        _close(tmem, jmem, tol)
    for t in range(s, s + 3):
        db = {"token": toks[:, t:t + 1], "pos": np.full((b,), t, np.int32)}
        if jmem is not None:
            db["memory"] = jmem
        jl, jcache = jtfm.decode_step(jparams, jcfg, jcache, db)
        tl, tcache = model.decode_step(tcache, db["token"], db["pos"], tmem)
        _close(tl, jl, tol)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b",
                                  "qwen3-moe-30b-a3b"])
def test_decode_from_a_carried_jax_cache(arch):
    """A JAX prefill's cache, conv tails and f32 states included, carried
    across (``lm_cache_from_numpy``) decodes as the JAX cache does."""
    jcfg, tcfg = _cfgs(arch)
    jparams, model = _carry(jcfg, tcfg, seed=5)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 17))
    jcache = _in_dtype(jtfm.init_cache(jcfg, 2, 32)[0], jnp.float32)
    _, jcache, _ = jtfm.prefill(jparams, jcfg, jcache,
                                {"tokens": toks[:, :16]})
    tcache = lm_cache_from_numpy(tcfg, jax.tree.map(np.asarray, jcache),
                                 device="cpu")
    db = {"token": toks[:, 16:], "pos": np.full((2,), 16, np.int32)}
    jl, _ = jtfm.decode_step(jparams, jcfg, jcache, db)
    tl, _ = model.decode_step(tcache, db["token"], db["pos"])
    _close(tl, jl, MODEL_TOL["float32"])


def test_cache_from_numpy_rejects_a_wrong_tree():
    jcfg, tcfg = _cfgs("mamba2-780m")
    tree = jax.tree.map(np.asarray, jtfm.init_cache(jcfg, 2, 16)[0])
    tree["ssd"]["ssd"]["state"] = tree["ssd"]["ssd"]["state"][..., :3]
    with pytest.raises(ValueError, match="state"):
        lm_cache_from_numpy(tcfg, tree, device="cpu")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m",
                                  "qwen3-moe-30b-a3b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b"])
def test_decode_matches_forward(arch):
    """The JAX package's test_decode_matches_forward on the port's own
    weights, its five cases of these families at their bound (0.02 for
    MoE, 0.005 for the others, at the configs' bf16)."""
    cfg = configs.get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(2)
    model = tfm.Transformer(cfg, tfm.init_params(cfg, gen, device="cpu"))
    b, s = 2, 32
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (b, s))
    mem = _memory(cfg, b, s, seed=2)
    cache = tfm.init_cache(cfg, b, 64, device="cpu")
    logits_p, cache, memory = model.prefill(cache, toks, mem)
    tok = logits_p[:, -1].argmax(-1)[:, None]
    logits_d, _ = model.decode_step(cache, tok, torch.full((b,), s), memory)
    logits_f = model.forward(np.concatenate([toks, tok.numpy()], 1), mem)
    tol = 0.02 if cfg.n_experts else 0.005
    assert float((logits_f[:, s - 1] - logits_p[:, 0]).abs().max()) < tol
    assert float((logits_f[:, s] - logits_d[:, 0]).abs().max()) < tol


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_params_from_numpy_round_trips_the_jax_tree(arch):
    jcfg, tcfg = _cfgs(arch)
    params, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, params)
    back = tfm.Transformer(tcfg, lm_params_from_numpy(
        tcfg, tree, device="cpu")).params_tree()
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        assert np.array_equal(node.numpy(), leaf), path


def test_an_empty_group_builds_and_serves():
    """recurrentgemma at 2 layers: no full rrl super-layer (a group of
    0), two rec_extra layers, as the JAX plan has it."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b", n_layers=2)
    assert tfm.group_plan(tcfg) == [("rrl", 0), ("rec_extra", 2)]
    jparams, model = _carry(jcfg, tcfg, seed=1)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (1, 9))
    _close(model.forward(toks), jtfm.forward(jparams, jcfg,
                                             {"tokens": toks}),
           MODEL_TOL["float32"])
    assert model.params_tree()["groups"]["rrl"]["attn"]["wq"].shape[0] == 0
    cache = tfm.init_cache(tcfg, 1, 16, device="cpu")
    assert cache["rrl"]["attn"]["k"].shape[0] == 0
    model.prefill(cache, toks)
