"""The port's training loss and gradients (``transformer.loss_fn`` and
``value_and_grad`` over a live ``Transformer``) against
``jax.value_and_grad(repro.models.transformer.loss_fn)`` on the CPU, on
weights carried across (the cross-attention gates set to 0.5: their
init, 0, would hide the memory).

Bounds: at f32 the loss within 1e-5 max(1, |loss|) and every gradient
leaf within 1e-4 max(1e-3, max|g|), relative to its own scale: the two
packages do the same operations and differ only in the order of their
sums.  At bf16 compute (f32
parameters) each package rounds its products and elementwise ops to
bf16 in its own places (XLA fuses an elementwise chain and rounds once,
torch rounds each op): the loss within 1e-2 max(1, |loss|) and each
leaf within 5e-2 max(1e-3, max|g|) relative to its own scale.  The
embedding follows the JAX order (the table cast, then gathered), so a
repeated token's gradient adds in bf16 in both.

An MoE model is compared only where the two packages route alike: the
JAX top-k sets are read out of the JAX step (``jax.debug.callback`` on
``lax.top_k``) and must equal the port's, call by call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.blocks import MoEBlock
from repro_torch.optim.adamw import tree_leaves

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GATE = 0.5


def _cfgs(arch, dtype="float32", **kw):
    jd, td = DTYPES[dtype]
    return (jconfigs.get_config(arch, smoke=True).replace(dtype=jd, **kw),
            configs.get_config(arch, smoke=True).replace(dtype=td, **kw))


def _carried(jcfg, tcfg, seed):
    """The same weights in both packages: the port's draws (the JAX
    ``init_params`` tree's structure and distributions; ``jax.random``
    compiles each leaf's draw, which costs more than the whole test)."""
    tree = tfm.tree_map(lambda t: t.numpy().copy(), tfm.init_params(
        tcfg, torch.Generator().manual_seed(seed), "cpu"))
    for grp in tree["groups"].values():
        if "cross" in grp:
            grp["cross"]["gate"] = np.full_like(grp["cross"]["gate"], GATE)
    return (jax.tree.map(jnp.asarray, tree),
            tfm.Transformer(tcfg, lm_params_from_numpy(tcfg, tree, "cpu"),
                            live=True))


def _batch(cfg, b, s, seed, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        shape = (b, cfg.num_patches, cfg.d_model)
    elif cfg.family == "audio":
        shape = (b, max(s // cfg.enc_ratio, 1), cfg.d_model)
    else:
        shape = None
    if shape is not None:
        out["memory"] = (rng.standard_normal(shape) * 0.02).astype(
            np.float32)
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _jax_value_and_grad(monkeypatch, jparams, jcfg, batch, **kw):
    """``jax.value_and_grad(loss_fn)`` jitted and compiled without XLA's
    backend optimizations (a third of the compile time; the same
    operations).  For an MoE config also the forward's top-k sets, call by
    call (sorted ids): ``lax.top_k`` is wrapped in a ``jax.debug.callback``
    while the step is traced; the first ``n_layers`` callbacks are the
    forward's (the rest, the backward's recomputation)."""
    seen = []
    if jcfg.n_experts:
        top_k = jax.lax.top_k

        def spy(x, k):
            vals, idx = top_k(x, k)
            jax.debug.callback(
                lambda a: seen.append(np.sort(np.asarray(a), -1)), idx,
                ordered=True)
            return vals, idx

        monkeypatch.setattr(jax.lax, "top_k", spy)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt: jtfm.loss_fn(p, jcfg, bt, **kw), has_aux=True))
    compiled = fn.lower(jparams, jb).compile(
        {"xla_backend_optimization_level": 0})
    (loss, metrics), grads = compiled(jparams, jb)
    jax.effects_barrier()
    return float(loss), metrics, grads, seen[:jcfg.n_layers]


def _port_routes(model):
    return [m.routes.sort(-1).values.numpy() for m in model.modules()
            if isinstance(m, MoEBlock)]


def _grads_close(tgrads, jgrads, tol, floor=1.0):
    jl = jax.tree_util.tree_leaves_with_path(jgrads)
    tl = tree_leaves(tgrads)
    assert len(tl) == len(jl)
    worst = 0.0
    for (path, w), g in zip(jl, tl):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape and np.isfinite(g).all()
        bound = tol * max(floor, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= bound, (f"{jax.tree_util.keystr(path)}: max|d| "
                              f"{err:.3e} > {bound:.3e}")
        worst = max(worst, err / bound)
    return worst


def _compare(monkeypatch, arch, dtype, b=2, s=33, seed=0, mask=False,
             loss_tol=1e-5, grad_tol=1e-4, grad_floor=1e-3, **loss_kw):
    jcfg, tcfg = _cfgs(arch, dtype)
    jparams, model = _carried(jcfg, tcfg, seed)
    batch = _batch(tcfg, b, s, seed, mask)
    jl, jm, jg, want = _jax_value_and_grad(monkeypatch, jparams, jcfg,
                                           batch, **loss_kw)
    (tl, tm), tg = tfm.value_and_grad(model, tcfg, batch, **loss_kw)
    if tcfg.n_experts:
        got = _port_routes(model)
        assert len(got) == len(want) == tcfg.n_layers
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), (
            "the two packages' top-k sets differ")
    assert tl.dtype == torch.float32
    assert abs(float(tl) - jl) <= loss_tol * max(1.0, abs(jl))
    assert abs(float(tm["ppl_proxy"]) - float(jm["ppl_proxy"])) <= (
        loss_tol * 2 * float(jm["ppl_proxy"]))
    return _grads_close(tg, jg, grad_tol, grad_floor)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_loss_and_every_gradient_match_jax_f32(monkeypatch, arch):
    _compare(monkeypatch, arch, "float32")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-780m"])
def test_loss_and_gradients_match_jax_bf16(monkeypatch, arch):
    _compare(monkeypatch, arch, "bfloat16", loss_tol=1e-2, grad_tol=5e-2,
             grad_floor=1e-3)


def test_loss_chunks_with_a_pad_and_a_mask_match_jax(monkeypatch):
    """S - 1 = 49 positions in chunks of 16 (a pad of 15) under a random
    mask, through the chunked attention (S > the smoke attn_chunk 64
    is not needed for the loss chunks; 80 tokens run both)."""
    _compare(monkeypatch, "qwen2-1.5b", "float32", s=50, mask=True,
             loss_chunk=16)
    _compare(monkeypatch, "gemma2-27b", "float32", s=80, mask=True,
             loss_chunk=24)


@pytest.mark.parametrize("arch,layers", [("qwen2-1.5b", 4),
                                         ("qwen2-1.5b", 3),
                                         ("recurrentgemma-2b", 6),
                                         ("seamless-m4t-large-v2", 4)])
def test_remat_on_and_off_are_bitwise(monkeypatch, arch, layers):
    """``remat_block`` 2: nested checkpoints where it divides the group's
    count (4 dense layers, 2 rrl super-layers and the encoder), one a
    layer where it does not (3); S = 100 > attn_chunk runs the chunked
    attention's own checkpoints too.  The skip table is read once a
    forward, never in the backward."""
    _, cfg = _cfgs(arch, remat_block=2, n_layers=layers)
    if cfg.is_encdec:
        cfg = cfg.replace(n_enc_layers=layers)
    model = tfm.Transformer(cfg, tfm.init_params(
        cfg, torch.Generator().manual_seed(1), "cpu"), live=True)
    batch = _batch(cfg, 2, 100, seed=1, mask=True)
    reads = []     # host reads of a skip table (each a device sync)
    table = common._tile_table
    monkeypatch.setattr(common, "_tile_table",
                        lambda *a: reads.append(a) or table(*a))
    out = {}
    for remat in (True, False):
        reads.clear()
        (loss, _), grads = tfm.value_and_grad(model, cfg, batch, remat=remat,
                                              loss_chunk=32)
        assert len(reads) == 1     # one causal window a forward
        out[remat] = (loss, [g.clone() for g in tree_leaves(grads)])
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


def test_live_forward_is_bitwise_the_serving_forward():
    """At bf16 the training forward (weights cast in the graph, the table
    cast and then gathered) gives the serving forward's bits."""
    _, cfg = _cfgs("gemma2-27b", "bfloat16")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 70))
    serve = tfm.Transformer(cfg, params)
    live = tfm.Transformer(cfg, params, live=True)
    with torch.no_grad():
        assert torch.equal(live.forward(toks), serve.forward(toks))


def test_gradients_land_in_the_stacked_tree():
    """Each per-layer parameter's ``.grad`` is a view of ``model.grads``
    (the stacked layout), and a step's gradients replace the last
    step's (``zero_grad`` in ``value_and_grad``)."""
    _, cfg = _cfgs("qwen2-1.5b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    model = tfm.Transformer(cfg, params, live=True)
    wq = model.grads["groups"]["dense"]["attn"]["wq"]
    layer1 = model.groups["dense"][1].attn.wq
    assert layer1.grad.data_ptr() == wq[1].data_ptr()
    assert layer1.data_ptr() == params["groups"]["dense"]["attn"]["wq"][
        1].data_ptr()
    batch = _batch(cfg, 2, 20, seed=3)
    _, g1 = tfm.value_and_grad(model, cfg, batch)
    first = [g.clone() for g in tree_leaves(g1)]
    _, g2 = tfm.value_and_grad(model, cfg, batch)
    assert g2 is model.grads
    assert all(torch.equal(a, b) for a, b in zip(first, tree_leaves(g2)))
    with pytest.raises(ValueError, match="live"):
        tfm.value_and_grad(tfm.Transformer(cfg, params), cfg, batch)
