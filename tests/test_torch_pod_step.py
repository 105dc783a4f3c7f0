"""The port's cross-pod compressed train step
(``steps.make_pod_compressed_train_step``) on a ("pod", "data", "model")
mesh of 8 logical CPU devices, against an oracle composed of the JAX
package's unsharded calls.

The JAX pod step is red in this container (ROADMAP C3), so the oracle
follows its code (``src/repro/runtime/steps.py``): each pod's gradients
of its rows (``jax.grad(loss_fn)``), then on every shard of each leaf
(the leaf's data/model sharding; ``min_size`` compared with the shard's
size, as the JAX compressor inside ``shard_map`` sees it) the
error-feedback round trip with the compact coefficients averaged over
the pods (``compress.compress``/``decompress``/``residual`` with the
port's angles: the port draws them with a ``torch.Generator``), the
loss averaged over the pods, then ``adamw.update``.

The smoke config's vocabulary is widened to 512 so that the embedding's
and LM head's shards (256 x 64) reach the compressor's 2^14 entries
while the MLP weights (2 x 64 x 128 = 2^14 whole) are below it per shard
and are averaged uncompressed.

Bounds (f32, one step at lr 1e-4): the loss within 1e-5 max(1,
|loss|); the global norm within 1e-4 relative; the first moment (0.1 x
the reduced, clipped gradient) within 1e-4 max(1e-4, max|m|) and the
parameters after the update within 1e-4 max(1, max|p|) a leaf (the
unsharded step's); the bf16 error-feedback buffers within one bf16
rounding step, 2^-8 max|e|, a leaf (the residual is rounded to bf16 in
both).  The update itself, which a bound of lr on the parameters'
scale cannot see, is held entry by entry within
``adamw.first_step_tolerance`` of the oracle's reduced gradients and
norm at the same 1e-4: AdamW's first update is g / (|g| + eps) x lr,
and the compressed gradient has entries near eps (the dropped
coefficients' leak into rows no token touched), where the tolerance
allows up to 2 lr and elsewhere ~2^-16 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import Mesh, logical_devices, process_devices
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.runtime import hlo_analysis as hlo
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps

S, B, RATIO, VOCAB = 32, 8, 0.25, 512
LR = dict(peak_lr=1e-4, warmup=0, total_steps=10)
MIN_SIZE = 1 << 14

@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the smoke steps are thousands of tiny ops,
    which several threads a worker only slow down when the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch="qwen2-1.5b"):
    return configs.get_config(arch, smoke=True).replace(
        dtype=torch.float32, vocab=VOCAB)


def _mesh(shape=(2, 2, 2)):
    n = int(np.prod(shape))
    with logical_devices(n, "cpu"):
        return Mesh(np.arange(n).reshape(shape), ("pod", "data", "model"),
                    process_devices("cpu"))


def _bundle(mesh, cfg=None):
    return steps.make_pod_compressed_train_step(
        cfg or _cfg(), mesh, seq_len=S, global_batch=B, compress_ratio=RATIO,
        **LR)


def _tree(cfg):
    return tfm.tree_map(lambda t: t.numpy().copy(), tfm.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))


def _placed(bundle, tree):
    """The state of ``tree`` placed, moments and buffers zero."""
    state = steps.placed_train_state(bundle, torch.Generator().manual_seed(
        3))
    params = shd.place_tree(tfm.tree_map(torch.from_numpy, tree),
                            bundle.state_shardings.params)
    for i, st in state.items():
        tfm.tree_map(lambda dst, src: dst.copy_(src), st.params, params[i])
    return state


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled without XLA's backend optimizations (the
    same operations, a third of the compile time)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def _oracle(tree, batch, bundle, spec, arch="qwen2-1.5b"):
    """(loss, parameter leaves, error-feedback leaves (npod, *leaf)) of
    one pod step composed of the JAX package's unsharded calls."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(
        dtype=jnp.float32, vocab=VOCAB)
    params = jax.tree.map(jnp.asarray, tree)
    npod = bundle.fn.mesh.shape["pod"]
    rows = B // npod
    pods = [{k: jnp.asarray(v[p * rows:(p + 1) * rows])
             for k, v in batch.items()} for p in range(npod)]
    grad_fn = _compiled(jax.value_and_grad(
        lambda p, bt: jtfm.loss_fn(p, jcfg, bt)[0]), params, pods[0])
    losses, grads = [], []
    for bt in pods:
        loss, g = grad_fn(params, bt)
        losses.append(float(loss))
        grads.append(jax.tree.map(np.asarray, g))
    jspec = jcompress.CompressSpec(spec.width, spec.depth, spec.keep,
                                   jnp.asarray(spec.theta.numpy()))
    comp = jax.jit(lambda g: jcompress.compress(jspec, g))
    resid = jax.jit(lambda g: jcompress.residual(jspec, g))
    decomp = jax.jit(lambda c, shape: jcompress.decompress(
        jspec, c, shape, jnp.float32), static_argnums=1)
    mesh = bundle.fn.mesh
    pod0 = [int(i) for i in mesh.device_ids[0].ravel()]

    def leaf(sh, *per_pod):
        """One leaf: each pod-0 id's shard through the round trip with its
        pod-mates' (the same data/model coordinate in each pod)."""
        full = np.zeros_like(per_pod[0])
        errs = np.zeros((npod,) + per_pod[0].shape, np.float32)
        for i in pod0:
            parts = [sh.part(torch.from_numpy(g.copy()), i).numpy()
                     for g in per_pod]
            view = sh.part(torch.from_numpy(full), i).numpy()
            if parts[0].size < MIN_SIZE:
                view[...] = np.mean(parts, axis=0)
                continue
            # flat: the compressor flattens a leaf, and one length is one
            # compile for every shard
            compact = [comp(jnp.asarray(g.reshape(-1))) for g in parts]
            mean = sum(compact) / npod
            view[...] = np.asarray(decomp(mean, (parts[0].size,))).reshape(
                view.shape)
            for p, g in enumerate(parts):
                sh.part(torch.from_numpy(errs[p]), i).numpy()[...] = \
                    np.asarray(resid(jnp.asarray(g.reshape(-1)))).reshape(
                        g.shape)
        return full, errs

    done = tfm.tree_map(leaf, bundle.state_shardings.params, *grads)
    reduced = tfm.tree_map(lambda _, d: jnp.asarray(d[0]), tree, done)

    def update(g, p):
        opt = jadamw.init(p)
        lr = jadamw.warmup_cosine(opt.step, peak_lr=LR["peak_lr"],
                                  warmup=LR["warmup"],
                                  total=LR["total_steps"])
        return jadamw.update(g, opt, p, lr=lr, weight_decay=0.1)

    new, new_opt, om = _compiled(update, reduced, params)(reduced, params)
    efs = adamw.tree_leaves(tfm.tree_map(lambda _, d: d[1], tree, done))
    return (float(np.mean(losses)),
            [np.asarray(x) for x in jax.tree.leaves(new)],
            [np.asarray(x) for x in jax.tree.leaves(new_opt.mu)], efs,
            [np.asarray(x) for x in jax.tree.leaves(reduced)],
            float(om["grad_norm"]))


def _worst(got, want, tol, floor):
    worst = 0.0
    for g, w in zip(got, want):
        bound = tol * max(floor, float(np.abs(w).max()))
        worst = max(worst, float(np.abs(np.asarray(g, np.float32)
                                        - w).max()) / bound)
    return worst


def test_pod_step_matches_a_jax_composed_oracle():
    against_oracle("qwen2-1.5b", (2, 2, 2))


def against_oracle(arch, mesh_shape):
    """One pod step of ``arch``'s smoke config on a ("pod", "data",
    "model") mesh of ``mesh_shape`` against ``_oracle``, within the
    bounds above."""
    cfg = _cfg(arch)
    tree = _tree(cfg)
    bundle = _bundle(_mesh(mesh_shape), cfg)
    batch = SyntheticLM(cfg, S, B, seed=1).batch(0)
    state, metrics = bundle.fn(_placed(bundle, tree), batch)
    whole = shd.gather_tree(state, bundle.state_shardings)
    loss, params, mu, efs, grads, norm = _oracle(tree, batch, bundle,
                                                 bundle.fn.spec, arch)
    assert abs(float(metrics["loss"]) - loss) <= 1e-5 * max(1.0, abs(loss))
    assert abs(float(metrics["grad_norm"]) - norm) <= 1e-4 * norm
    got = [p.numpy() for p in adamw.tree_leaves(whole.params)]
    assert len(got) == len(params)
    assert _worst(got, params, 1e-4, 1.0) <= 1.0
    bound = adamw.first_step_tolerance(
        [torch.from_numpy(g) for g in grads],
        [torch.from_numpy(p) for p in params], norm, lr=LR["peak_lr"],
        grad_tol=1e-4, norm_tol=1e-4)
    assert max(float((np.abs(g - p) / b.numpy()).max())
               for g, p, b in zip(got, params, bound)) <= 1.0
    # the first moment is 0.1 x the reduced, clipped gradient
    got = [m.numpy() for m in adamw.tree_leaves(whole.opt.mu)]
    assert _worst(got, mu, 1e-4, 1e-4) <= 1.0
    ef = [e.float().numpy() for e in adamw.tree_leaves(whole.ef_err)]
    assert [e.shape for e in ef] == [e.shape for e in efs]
    assert _worst(ef, efs, 2.0 ** -8, 1e-30) <= 1.0


def test_min_size_is_compared_with_the_shard():
    """A leaf of 2^14 entries whole is 2^13 a shard: averaged whole, its
    buffer untouched; the embedding's 2^14-entry shards are compressed."""
    cfg = _cfg()
    bundle = _bundle(_mesh())
    state, _ = bundle.fn(_placed(bundle, _tree(cfg)),
                         SyntheticLM(cfg, S, B, seed=1).batch(0))
    ef = state[0].ef_err
    assert ef["groups"]["dense"]["mlp"]["w_up"][0].numel() == MIN_SIZE // 2
    assert not ef["groups"]["dense"]["mlp"]["w_up"].any()
    assert ef["embed"][0].numel() == MIN_SIZE and ef["embed"].any()
    assert ef["embed"].shape == (1, VOCAB // 2, cfg.d_model)


def _cross_pod_bytes(bundle, spec) -> int:
    """One step's cross-pod result bytes on an id, x2 for each all-reduce
    (the JAX walker's count): every leaf's compact block (chunks x keep
    f32) or, below ``min_size`` a shard, the shard's f32 gradient; the
    pods' mean of ``loss`` and ``ppl_proxy``; the global norm's scalar,
    added over the whole mesh."""
    total = 0
    for meta, sh in zip(adamw.tree_leaves(bundle.abstract_state.params),
                        adamw.tree_leaves(bundle.state_shardings.params)):
        n = int(np.prod(sh.shard_shape(meta.shape)))
        total += (n if n < MIN_SIZE else -(-n // spec.width) * spec.keep)
    return 2 * 4 * (total + 2 + 1)


def test_pod_step_runs_and_reduces_cross_pod():
    """Three steps: finite losses; ``cross_pod_bytes`` > 0, below half of
    ``collective_bytes`` (the JAX test's gate, tests/test_multipod.py) and
    equal to the count from the leaves' shard shapes."""
    cfg = _cfg()
    bundle = _bundle(_mesh())
    state = steps.placed_train_state(bundle)
    pipe = SyntheticLM(cfg, S, B, seed=0)
    losses = []
    for k in range(3):
        state, metrics = bundle.fn(state, pipe.batch(k))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and max(losses) < 1e4
    terms = hlo.roofline_terms({"flops": 1.0, "bytes": 1.0},
                               collectives=bundle.collectives)
    assert terms["cross_pod_bytes"] > 0
    assert terms["cross_pod_bytes"] < 0.5 * terms["collective_bytes"]
    assert terms["cross_pod_bytes"] == 3 * _cross_pod_bytes(
        bundle, bundle.fn.spec)
    assert terms["collective_by_kind"]["all-reduce"] == \
        terms["collective_bytes"]
    assert int(state[7].opt.step) == 3
    held = shd.placed_nbytes(state)
    assert len(set(held.values())) == 1


def test_pod_step_needs_a_pod_axis():
    with logical_devices(4, "cpu"):
        mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"),
                    process_devices("cpu"))
    with pytest.raises(ValueError, match="multi-pod mesh required"):
        _bundle(mesh)


def test_pod_step_abstract_state_is_the_jax_one():
    bundle = _bundle(_mesh())
    ef = adamw.tree_leaves(bundle.abstract_state.ef_err)
    params = adamw.tree_leaves(bundle.abstract_state.params)
    assert [tuple(e.shape) for e in ef] == [(2,) + tuple(p.shape)
                                            for p in params]
    assert {e.dtype for e in ef} == {torch.bfloat16}
    specs = []
    tfm.tree_map(lambda s: specs.append(s.spec),
                 bundle.state_shardings.ef_err)
    params = []
    tfm.tree_map(lambda s: params.append(s.spec),
                 bundle.state_shardings.params)
    assert specs == [shd.P("pod", *p) for p in params]
