"""The port's sharded train step (``runtime/steps.py``: ``make_train_step``
on a ("data", "model") mesh) and ``train --model-axis`` on logical CPU
devices (``logical_devices``), against the port's unsharded step and the
JAX package's unsharded calls.

The JAX package's own sharded step is red in this container (ROADMAP C3:
a ``ShardingTypeError`` in ``forward_hidden``'s embedding gather), so the
JAX oracle is ``jax.value_and_grad(loss_fn)`` and ``adamw.update`` on the
whole batch, composed here, as the unsharded step's tests hold it
(``tests/test_torch_train_cli.py``).

Bounds (f32, smoke configs, one step at lr 1e-5):
* against the port's unsharded step: the loss within 1e-6 relative,
  every gradient leaf within 1e-5 max(1e-3, max|g|) of its own scale,
  the global norm within 1e-5 relative and the parameters after AdamW
  within 1e-6 max(1, max|p|).  The sharded step adds in other orders
  (per-shard partial sums, a vocabulary-parallel log-sum-exp); its
  gradients differ by ~5e-7 of their scale here;
* the update itself, entry by entry: one step at lr 1e-5 moves a
  parameter by ~1e-5, which a bound on the parameters' scale cannot see,
  so each parameter after the step is also held within
  ``adamw.first_step_tolerance`` of the reference's: lr times how far
  the update's direction g / (|g| + eps) can move over the gradients'
  and norm's tolerance above (up to 2 where |g| is near eps, nothing
  where |g| >> the tolerance), plus 2^-16 lr and two f32 spacings;
* the update path alone: each sharded step against the unsharded
  ``adamw.update`` of its own gathered gradients, the same tolerance with
  no gradient term and the norm within 1e-6 relative (added in another
  order);
* against the JAX package: the unsharded step's bounds, the loss within
  1e-5 max(1, |loss|), each gradient leaf and parameter within 1e-4 of
  its own scale (floors 1e-3 and 1), the global norm within 1e-4
  relative, the first moment within 1e-4 max(1e-4, max|m|) and the
  update within ``first_step_tolerance`` of the gradients' and norm's
  1e-4;
* on a 1x1 mesh the step is the unsharded step bit for bit.
"""
import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro_torch import configs
from repro_torch.configs.shapes import Shape
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import (Mesh, logical_devices, make_local_mesh,
                                     process_devices)
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw, compress
from repro_torch.runtime import hlo_analysis as hlo
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps

S, B = 32, 8
LR = dict(peak_lr=1e-5, warmup=0, total_steps=10)
GATE = 0.5
TP = [("qwen2-1.5b", False), ("gemma2-27b", False), ("glm4-9b", True)]
MESHES = [(2, 2), (1, 4)]

@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the smoke steps are thousands of tiny ops,
    which several threads a worker only slow down when the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch, **kw):
    return configs.get_config(arch, smoke=True).replace(dtype=torch.float32,
                                                        **kw)


def _tree(cfg, seed=3):
    """The port's draws as numpy, cross-attention gates opened."""
    tree = tfm.tree_map(lambda t: t.numpy().copy(), tfm.init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    for grp in tree["groups"].values():
        if "cross" in grp:
            grp["cross"]["gate"] = np.full_like(grp["cross"]["gate"], GATE)
    return tree


def _state(tree):
    params = tfm.tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    return steps.TrainState(params, adamw.init(params))


def _mesh(shape, axes=("data", "model")):
    n = int(np.prod(shape))
    with logical_devices(n, "cpu"):
        return Mesh(np.arange(n).reshape(shape), axes, process_devices("cpu"))


def _batch(cfg, seed=1):
    return SyntheticLM(cfg, S, B, seed=seed).batch(0)


class Step(NamedTuple):
    """One step's loss, gradient leaves (before clipping), parameter
    leaves after the update, global norm and first-moment leaves; a
    sharded step's also its placed state and bundle."""
    loss: float
    grads: list
    params: list
    norm: float
    mu: list
    placed: Any = None
    bundle: Any = None


def _unsharded(cfg, tree, batch):
    state = _state(tree)
    model = tfm.Transformer(cfg, state.params, live=True)
    (loss, _), grads = tfm.value_and_grad(model, cfg, batch)
    grads = [g.clone() for g in adamw.tree_leaves(grads)]
    bundle = steps.make_train_step(cfg, seq_len=S, global_batch=B,
                                   device="cpu", **LR)
    state, metrics = bundle.fn(state, batch)
    assert torch.equal(metrics["loss"], loss)
    return Step(float(loss), grads, adamw.tree_leaves(state.params),
                float(metrics["grad_norm"]), adamw.tree_leaves(state.opt.mu))


def _sharded(cfg, tree, batch, mesh, fsdp=False):
    """The sharded step; its parameters also held to the unsharded AdamW
    update of the step's own gradients."""
    bundle = steps.make_train_step(cfg, mesh, seq_len=S, global_batch=B,
                                   fsdp=fsdp, **LR)
    placed = shd.place_tree(_state(tree), bundle.state_shardings)
    metrics, grads = bundle.fn.gradients(placed, batch)
    grads = tfm.tree_map(lambda g: g.clone(), shd.gather_tree(
        grads, bundle.state_shardings.params))
    bundle.collectives.reset()
    placed, out = bundle.fn(placed, batch)
    assert torch.equal(out["loss"], metrics[0]["loss"])
    whole = shd.gather_tree(placed, bundle.state_shardings)
    params = adamw.tree_leaves(whole.params)
    # the update path alone: the unsharded AdamW of the step's own
    # gradients (its norm added in another order: ~1e-7 of the scale)
    state = _state(tree)
    _, _, om = adamw.update(grads, state.opt, state.params, weight_decay=0.1,
                            lr=adamw.warmup_cosine(
                                state.opt.step, peak_lr=LR["peak_lr"],
                                warmup=LR["warmup"], total=LR["total_steps"]))
    assert abs(float(out["grad_norm"]) - float(om["grad_norm"])) <= \
        1e-6 * float(om["grad_norm"])
    assert _moved(params, adamw.tree_leaves(state.params),
                  adamw.tree_leaves(grads), om["grad_norm"], 0.0,
                  1e-6) <= 1.0
    return Step(float(out["loss"]), adamw.tree_leaves(grads), params,
                float(out["grad_norm"]), adamw.tree_leaves(whole.opt.mu),
                placed, bundle)


def _worst(got, want, tol, floor):
    """max over leaves of max|d| / (tol max(floor, max|want|))."""
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        g = np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        bound = tol * max(floor, float(np.abs(w).max()))
        worst = max(worst, float(np.abs(g - w).max()) / bound)
    return worst


def _np(leaves):
    return [t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32))
            for t in leaves]


def _moved(got, want, grads, norm, grad_tol, norm_tol):
    """max over the entries of |p_got - p_want| / the reference's
    ``adamw.first_step_tolerance`` (``grads``, ``norm``, ``want``: the
    reference's gradients, global norm and parameters after the step)."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    want, grads = [t(w) for w in _np(want)], [t(g) for g in _np(grads)]
    bound = adamw.first_step_tolerance(grads, want, norm, lr=LR["peak_lr"],
                                       grad_tol=grad_tol, norm_tol=norm_tol)
    assert len(got) == len(want) == len(bound)
    return max(float(((t(g) - w).abs() / b).max())
               for g, w, b in zip(_np(got), want, bound))


def _against_unsharded(got, want):
    assert abs(got.loss - want.loss) <= 1e-6 * abs(want.loss)
    assert _worst(_np(got.grads), _np(want.grads), 1e-5, 1e-3) <= 1.0
    assert abs(got.norm - want.norm) <= 1e-5 * want.norm
    assert _worst(_np(got.params), _np(want.params), 1e-6, 1.0) <= 1.0
    assert _moved(got.params, want.params, want.grads, want.norm, 1e-5,
                  1e-5) <= 1.0


def _against_jax(got, want):
    assert abs(got.loss - want.loss) <= 1e-5 * max(1.0, abs(want.loss))
    assert _worst(_np(got.grads), want.grads, 1e-4, 1e-3) <= 1.0
    assert abs(got.norm - want.norm) <= 1e-4 * want.norm
    assert _worst(_np(got.mu), want.mu, 1e-4, 1e-4) <= 1.0
    assert _worst(_np(got.params), want.params, 1e-4, 1.0) <= 1.0
    assert _moved(got.params, want.params, want.grads, want.norm, 1e-4,
                  1e-4) <= 1.0


def _held_as_predicted(cfg, got, fsdp):
    """Every id holds the dry run's argument bytes in state and batch (the
    batch at the dtypes of ``steps.input_specs``, as the dry run counts
    it: a vision or audio memory in bf16, where ``SyntheticLM`` gives
    f32), in storages of its own; the collectives' bytes are counted and
    give every collective key of the roofline terms."""
    placed, bundle = got.placed, got.bundle
    specs = steps.input_specs(cfg, S, B)
    batch = shd.place_tree({k: torch.from_numpy(v).to(specs[k].dtype)
                            for k, v in _batch(cfg).items()},
                           bundle.batch_shardings)
    held = shd.placed_nbytes(placed)
    want = dryrun.argument_bytes(
        cfg, {"fsdp": fsdp, "moment_dtype": torch.float32},
        Shape("sharded", S, B, "train"), bundle.fn.mesh)
    assert {held[i] + shd.placed_nbytes(batch)[i] for i in held} == {want}
    n, distinct = _storages(placed)
    assert n == distinct
    terms = hlo.roofline_terms({"flops": 1.0, "bytes": 1.0},
                               collectives=bundle.collectives)
    assert terms["unavailable"] == [] and terms["cross_pod_bytes"] == 0
    assert terms["collective_bytes"] > 0
    assert terms["collective_s"] == terms["collective_bytes"] / hlo.NVLINK_BW


# ---------------------------------------------------------------------------
# A 1x1 mesh is the unsharded step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-27b", "mamba2-780m"])
def test_one_by_one_mesh_is_the_unsharded_step(arch):
    cfg = _cfg(arch)
    tree = _tree(cfg)
    plain = steps.make_train_step(cfg, seq_len=S, global_batch=B,
                                  device="cpu", **LR)
    with logical_devices(1, "cpu"):
        mesh = make_local_mesh(1, device="cpu")
    sharded = steps.make_train_step(cfg, mesh, seq_len=S, global_batch=B,
                                    **LR)
    state = _state(tree)
    placed = shd.place_tree(_state(tree), sharded.state_shardings)
    pipe = SyntheticLM(cfg, S, B, seed=2)
    for k in range(3):
        state, want = plain.fn(state, pipe.batch(k))
        placed, got = sharded.fn(placed, pipe.batch(k))
        assert set(got) == set(want)
        assert all(torch.equal(got[m], want[m]) for m in want)
    assert sharded.collectives.bytes == {}
    back = adamw.tree_leaves(placed[0])
    assert len(back) == len(adamw.tree_leaves(state))
    assert all(torch.equal(a, b) for a, b in
               zip(back, adamw.tree_leaves(state)))
    assert int(placed[0].opt.step) == 3


# ---------------------------------------------------------------------------
# Data and tensor parallelism against the unsharded step and the JAX calls
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """The JAX package's loss, gradients and one AdamW update of the whole
    batch (its unsharded calls), as numpy leaves."""
    cfg = _cfg(arch)
    jcfg = jconfigs.get_config(arch, smoke=True).replace(dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, _tree(cfg))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}

    def step(p, bt):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jtfm.loss_fn(q, jcfg, bt), has_aux=True)(p)
        opt = jadamw.init(p)
        lr = jadamw.warmup_cosine(opt.step, peak_lr=LR["peak_lr"],
                                  warmup=LR["warmup"],
                                  total=LR["total_steps"])
        new, opt, om = jadamw.update(grads, opt, p, lr=lr, weight_decay=0.1)
        return loss, grads, new, om["grad_norm"], opt.mu

    loss, grads, new, norm, mu = jax.jit(step).lower(params, batch).compile(
        {"xla_backend_optimization_level": 0})(params, batch)
    return Step(float(loss), _np(jax.tree.leaves(grads)),
                _np(jax.tree.leaves(new)), float(norm),
                _np(jax.tree.leaves(mu)))


@functools.lru_cache(maxsize=None)
def _plain(arch):
    cfg = _cfg(arch)
    return _unsharded(cfg, _tree(cfg), _batch(cfg))


def _storages(placed):
    ptrs = [t.untyped_storage().data_ptr() for i in placed
            for t in adamw.tree_leaves(placed[i]) if t.numel()]
    return len(ptrs), len(set(ptrs))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(
    map(str, m)))
@pytest.mark.parametrize("arch,fsdp", TP, ids=[a for a, _ in TP])
def test_sharded_step_matches_the_unsharded_step(arch, fsdp, mesh_shape):
    """Loss, gradients and the update within the bounds; every id holds
    the dry run's argument bytes in state and batch, in storages of its
    own; the collectives' bytes are counted."""
    cfg = _cfg(arch)
    got = _sharded(cfg, _tree(cfg), _batch(cfg), _mesh(mesh_shape), fsdp)
    _against_unsharded(got, _plain(arch))
    _held_as_predicted(cfg, got, fsdp)
    kinds = {k for i in got.bundle.collectives.by_id().values() for k in i}
    assert kinds == ({"all-reduce", "all-gather", "reduce-scatter"}
                     if fsdp and mesh_shape[0] > 1 else {"all-reduce"})


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(
    map(str, m)))
@pytest.mark.parametrize("arch,fsdp", TP, ids=[a for a, _ in TP])
def test_sharded_step_matches_the_jax_calls(arch, fsdp, mesh_shape):
    cfg = _cfg(arch)
    got = _sharded(cfg, _tree(cfg), _batch(cfg), _mesh(mesh_shape), fsdp)
    _against_jax(got, _jax_step(arch))


@pytest.mark.parametrize("case", [
    dict(n_heads=6, head_dim=16),        # heads 6 % 4: attention whole
    dict(d_ff=90),                       # ff 90 % 4: MLP whole
    dict(vocab=130),                     # vocab 130 % 4: loss whole
], ids=["heads", "ff", "vocab"])
def test_a_block_the_rules_replicate_is_computed_whole(case):
    """At a model axis of 4, a dimension the rules leave whole is computed
    on every rank and summed nowhere; qwen2's two KV heads are replicated
    and each rank reads the one its query heads use."""
    cfg = _cfg("qwen2-1.5b", **case)
    tree, batch = _tree(cfg), _batch(cfg)
    _against_unsharded(_sharded(cfg, tree, batch, _mesh((1, 4))),
                       _unsharded(cfg, tree, batch))


def test_kv_heads_a_rank_reads():
    layout = tfm.TPLayout(heads=True, kv_heads=False, ff=True, vocab=True)
    cfg = _cfg("qwen2-1.5b").replace(n_heads=12, n_kv_heads=2)
    got = [tfm.kv_select(cfg, layout, 4, r, "cpu").tolist()
           for r in range(4)]
    assert got == [[0], [0], [1], [1]]
    cfg = cfg.replace(n_kv_heads=4)          # heads 12, 3 a KV head
    got = [tfm.kv_select(cfg, layout, 6, r, "cpu").tolist()
           for r in range(6)]
    assert got == [[0], [0, 1], [1], [2], [2, 3], [3]]
    assert tfm.kv_select(cfg, layout._replace(kv_heads=True), 2, 0,
                         "cpu") is None


def test_gradient_compression_on_a_mesh_compresses_whole_leaves():
    """``grad_compress_ratio`` on a (2, 2) mesh: each id gathers a leaf,
    compresses it whole (the JAX step's compression of its global
    gradients) and keeps its part; two steps against the unsharded
    compressed step (the vocabulary widened to 512 so that the embedding
    and LM head reach the compressor's 2^14 entries): the losses within
    1e-6 relative, the bf16 error-feedback buffers within a bf16 rounding
    step (2^-8 max|e|) a leaf, the parameters within the bound the
    unsharded tests hold a compressed loop to, 1e-4 max(1, max|p|): the
    decompressed gradient leaks
    entries near eps into rows no token touched, and a buffer entry one
    bf16 step apart feeds the next step's gradient, which AdamW's
    g / (|g| + eps) turns into a part of lr (4.6e-6 apart at lr 1e-5)."""
    cfg = _cfg("qwen2-1.5b", vocab=512)
    tree = _tree(cfg)
    kw = dict(seq_len=S, global_batch=B, grad_compress_ratio=0.25, **LR)
    plain = steps.make_train_step(cfg, device="cpu", **kw)
    sharded = steps.make_train_step(cfg, _mesh((2, 2)), **kw)

    def fresh():
        state = _state(tree)
        return state._replace(ef_err=compress.init_error(state.params))

    state = fresh()
    placed = shd.place_tree(fresh(), sharded.state_shardings)
    pipe = SyntheticLM(cfg, S, B, seed=3)
    for k in range(2):
        state, want = plain.fn(state, pipe.batch(k))
        placed, got = sharded.fn(placed, pipe.batch(k))
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-6 * abs(
            float(want["loss"]))
    whole = shd.gather_tree(placed, sharded.state_shardings)
    assert _worst(_np(adamw.tree_leaves(whole.params)),
                  _np(adamw.tree_leaves(state.params)), 1e-4, 1.0) <= 1.0
    ef = _np(adamw.tree_leaves(whole.ef_err))
    assert any(np.abs(e).max() > 0 for e in ef)
    assert _worst(ef, _np(adamw.tree_leaves(state.ef_err)), 2.0 ** -8,
                  1e-30) <= 1.0


# ---------------------------------------------------------------------------
# The data axis for all 10 families (their model axis:
# tests/test_torch_sharded_families.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_data_axis_for_every_family(arch):
    cfg = _cfg(arch)
    tree, batch = _tree(cfg), _batch(cfg)
    _against_unsharded(_sharded(cfg, tree, batch, _mesh((4, 1))),
                       _unsharded(cfg, tree, batch))


def test_a_data_shard_must_hold_whole_moe_groups():
    cfg = _cfg("qwen3-moe-30b-a3b", moe_group=128)
    with pytest.raises(ValueError, match="whole MoE dispatch groups"):
        steps.make_train_step(cfg, _mesh((4, 1)), seq_len=S, global_batch=B)
    steps.make_train_step(cfg.replace(moe_group=64), _mesh((4, 1)),
                          seq_len=S, global_batch=B)


# ---------------------------------------------------------------------------
# train --model-axis
# ---------------------------------------------------------------------------

def _cli(tmp, steps_n, *extra, devices=4, model_axis=2, arch="qwen2-1.5b"):
    argv = ["--arch", arch, "--smoke", "--steps", str(steps_n),
            "--seq-len", "32", "--global-batch", "4", "--device", "cpu",
            "--ckpt-dir", str(tmp), "--log-every", "3",
            "--model-axis", str(model_axis), *extra]
    with logical_devices(devices, "cpu"):
        return train.run(train.parse_args(argv))


def _gathered(out):
    bundle = out["bundle"]
    if bundle.state_shardings is None:
        return out["state"]
    return shd.gather_tree(out["state"], bundle.state_shardings)


def test_cli_model_axis_resume_is_bitwise(tmp_path, capsys, monkeypatch):
    """2 steps on a (2, 2) mesh, ``--resume auto`` to 4, against 4 at
    once.  Then the elastic restart: the step-4 checkpoint resumed on one
    device continues to step 6 within the f32 bounds above of the
    sharded run's continuation (the smoke config at f32 compute: in its
    bf16 the tensor-parallel products round elsewhere, ~5e-6 of the
    loss)."""
    monkeypatch.setattr(train, "get_config", lambda arch, smoke=False:
                        configs.get_config(arch, smoke=smoke).replace(
                            dtype=torch.float32))
    first = _cli(tmp_path / "a", 2)
    assert dict(first["mesh"].shape) == {"data": 2, "model": 2}
    resumed = _cli(tmp_path / "a", 4, "--resume", "auto")
    whole = _cli(tmp_path / "b", 4)
    assert "resumed from step 2 (saved on 4 devices)" in \
        capsys.readouterr().out
    assert resumed["final_loss"] == whole["final_loss"]
    got, want = (adamw.tree_leaves(_gathered(r)) for r in (resumed, whole))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = _cli(tmp_path / "a", 6, "--resume", "auto", devices=1,
               model_axis=1)
    more = _cli(tmp_path / "b", 6, "--resume", "auto")
    assert one["start_step"] == 4 and one["bundle"].state_shardings is None
    assert abs(one["final_loss"] - more["final_loss"]) <= 1e-6 * abs(
        more["final_loss"])
    assert _worst(_np(adamw.tree_leaves(one["state"].params)),
                  _np(adamw.tree_leaves(_gathered(more).params)), 1e-6,
                  1.0) <= 1.0


def test_jax_store_restores_the_sharded_checkpoint_bitwise(tmp_path):
    out = _cli(tmp_path, 2)
    jcfg = jconfigs.get_config("qwen2-1.5b", smoke=True)
    restored, step, meta = jstore.restore_checkpoint(
        tmp_path, jsteps.abstract_train_state(jcfg))
    assert step == 2 and meta == {"mesh": 4, "arch": jcfg.name}
    got = adamw.tree_leaves(_gathered(out))
    want = jax.tree.leaves(restored)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_cli_refuses_a_mesh_the_devices_cannot_hold():
    with pytest.raises(ValueError, match="cannot be factored into a model "
                       "axis of 3"):
        _cli("unused", 1, model_axis=3)


def test_placed_state_draws_the_parameters_leaf_by_leaf():
    """``placed_train_state`` shards each parameter as it is drawn (no
    whole tree on the first device) in ``init_params``' generator order:
    bit for bit the whole tree drawn, then placed; the moments and the
    step zero, every id's storage its own."""
    cfg = _cfg("glm4-9b")
    bundle = steps.make_train_step(cfg, _mesh((2, 2)), seq_len=S,
                                   global_batch=B, fsdp=True, **LR)
    placed = steps.placed_train_state(bundle,
                                      torch.Generator().manual_seed(4))
    want = shd.place_tree(tfm.init_params(
        cfg, torch.Generator().manual_seed(4), "cpu"),
        bundle.state_shardings.params)
    for i in placed:
        got = adamw.tree_leaves(placed[i].params)
        assert all(torch.equal(a, b) for a, b in
                   zip(got, adamw.tree_leaves(want[i])))
        assert not any(m.any() for m in adamw.tree_leaves(placed[i].opt))
    n, distinct = _storages(placed)
    assert n == distinct
