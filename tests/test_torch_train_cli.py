"""The port's train step and CLI (``repro_torch.runtime.steps``,
``repro_torch.launch.train``) against the JAX package on the CPU.

The JAX package's own train CLI fails with the jax version these tests
run on (its embedding gather under an explicit mesh raises a
``ShardingTypeError``), so the
port is held to an unsharded JAX loop of the same parts:
``jax.value_and_grad(loss_fn)``, ``compress.tree_ef_compress``,
``adamw.warmup_cosine`` and ``adamw.update`` over ``SyntheticLM``, from
the same weights.  Bounds, at f32: each step's loss within 1e-5 max(1,
|loss|), the parameters after the loop within 1e-4 max(1, max|p|) a leaf
(the gradients differ in their sums' order, and AdamW's first steps move
each weight by about lr whatever the gradient's size).

Checkpoints go both ways bitwise (the JAX on-disk format).  A resumed
CLI run equals an uninterrupted one bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.runtime import steps as jsteps
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import (compress_spec_from_numpy,
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.launch import train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.optim.compress import init_error
from repro_torch.runtime import steps

ARCH = "qwen2-1.5b"
LOOP = dict(seq_len=32, global_batch=4, peak_lr=1e-3, warmup=2,
            total_steps=4)


def _cfgs(arch=ARCH, **kw):
    return (jconfigs.get_config(arch, smoke=True).replace(**kw),
            configs.get_config(arch, smoke=True).replace(**kw))


def _params(cfg, seed):
    """The port's draws as numpy (carried to both packages)."""
    return tfm.tree_map(lambda t: t.numpy().copy(), tfm.init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = float(np.abs(got - want).max())
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"max|d| {err:.3e} > {bound:.3e}"


def _jax_loop(jcfg, tree, steps_n, spec=None):
    """The JAX step of ``make_train_step`` without its mesh."""
    def step(params, opt, ef, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jtfm.loss_fn(p, jcfg, batch), has_aux=True)(params)
        if spec is not None:
            grads, ef = jcompress.tree_ef_compress(spec, grads, ef,
                                                   step=opt.step)
        lr = jadamw.warmup_cosine(opt.step, peak_lr=LOOP["peak_lr"],
                                  warmup=LOOP["warmup"],
                                  total=LOOP["total_steps"])
        params, opt, _ = jadamw.update(grads, opt, params, lr=lr,
                                       weight_decay=0.1)
        return params, opt, ef, loss

    params = jax.tree.map(jnp.asarray, tree)
    opt = jadamw.init(params)
    ef = jcompress.init_error(params) if spec is not None else None
    pipe = JSyntheticLM(jcfg, LOOP["seq_len"], LOOP["global_batch"], seed=0)
    batch = {k: jnp.asarray(v) for k, v in pipe.batch(0).items()}
    fn = jax.jit(step).lower(params, opt, ef, batch).compile(
        {"xla_backend_optimization_level": 0})
    losses = []
    for k in range(steps_n):
        batch = {kk: jnp.asarray(v) for kk, v in pipe.batch(k).items()}
        params, opt, ef, loss = fn(params, opt, ef, batch)
        losses.append(float(loss))
    return params, opt, losses


@pytest.mark.parametrize("ratio", [0.0, 0.25])
def test_train_step_loop_matches_jax(monkeypatch, ratio):
    jcfg, tcfg = _cfgs()
    jcfg, tcfg = (jcfg.replace(dtype=jnp.float32),
                  tcfg.replace(dtype=torch.float32))
    tree = _params(tcfg, seed=4)
    jspec = tspec = None
    if ratio:
        jspec = jcompress.make_spec(ratio=ratio)
        # the JAX spec's angles (jax.random draws) for the port's step
        tspec = compress_spec_from_numpy(jspec.width, jspec.keep,
                                         np.asarray(jspec.theta), "cpu")
        monkeypatch.setattr(steps.compress, "make_spec",
                            lambda **kw: tspec)
    jparams, jopt, jlosses = _jax_loop(jcfg, tree, 4, jspec)
    bundle = steps.make_train_step(tcfg, grad_compress_ratio=ratio,
                                   device="cpu", **LOOP)
    params = tfm.tree_map(torch.from_numpy, tree)
    state = steps.TrainState(params, adamw.init(params),
                             init_error(params) if ratio else None)
    pipe = SyntheticLM(tcfg, LOOP["seq_len"], LOOP["global_batch"], seed=0)
    for k in range(4):
        state, metrics = bundle.fn(state, pipe.batch(k))
        assert abs(float(metrics["loss"]) - jlosses[k]) <= 1e-5 * max(
            1.0, abs(jlosses[k])), (k, float(metrics["loss"]), jlosses[k])
        assert set(metrics) == {"loss", "ppl_proxy", "grad_norm", "lr"}
    assert state.params is params and int(state.opt.step) == 4
    assert (state.ef_err is not None) == bool(ratio)
    for got, (path, want) in zip(adamw.tree_leaves(state.params),
                                 jax.tree_util.tree_leaves_with_path(
                                     jparams)):
        _close(got, want, 1e-4)
    assert int(jopt.step) == 4


def _cli(tmp, steps_n, *extra):
    return train.run(train.parse_args([
        "--arch", ARCH, "--smoke", "--steps", str(steps_n), "--seq-len",
        "32", "--global-batch", "4", "--device", "cpu", "--ckpt-dir",
        str(tmp), "--log-every", "2", *extra]))


def test_cli_resume_is_bitwise_an_uninterrupted_run(tmp_path, capsys):
    """6 steps, then ``--resume auto`` to 10, against 10 at once.  The
    default warmup (20 steps) covers all 10, so the learning rate at each
    step does not depend on ``--steps``."""
    first = _cli(tmp_path / "a", 6, "--ckpt-every", "4")
    assert first["start_step"] == 0
    resumed = _cli(tmp_path / "a", 10, "--resume", "auto")
    assert resumed["start_step"] == 6
    whole = _cli(tmp_path / "b", 10)
    out = capsys.readouterr().out
    assert "resumed from step 6 (saved on 1 devices)" in out
    assert '{"final_step": 10, "final_loss": ' in out
    assert "step    10 loss=" in out
    assert resumed["final_loss"] == whole["final_loss"]
    assert store.latest_step(tmp_path / "a") == 10
    got = adamw.tree_leaves(resumed["state"])
    want = adamw.tree_leaves(whole["state"])
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cli_checkpoint_restores_in_jax_bitwise(tmp_path):
    """The CLI's checkpoint (one file, as the JAX CLI writes) into the
    JAX state."""
    jcfg, _ = _cfgs()
    out = _cli(tmp_path, 2)
    assert len(list((tmp_path / "step_000000002").glob("leaves_*.npz"))) == 1
    restored, step, meta = jstore.restore_checkpoint(
        tmp_path, jsteps.abstract_train_state(jcfg))
    assert step == 2 and meta == {"mesh": 1, "arch": jcfg.name}
    _bitwise(out["state"], restored)


def test_cli_grad_compression_runs(tmp_path):
    out = _cli(tmp_path, 4, "--grad-compress-ratio", "0.25")
    assert np.isfinite(out["final_loss"])
    ef = adamw.tree_leaves(out["state"].ef_err)
    assert ef and all(e.dtype == torch.bfloat16 for e in ef)
    assert any(bool(e.abs().max() > 0) for e in ef)


def _state_numpy(cfg, seed, ef=False):
    rng = np.random.default_rng(seed)
    params = _params(cfg, seed)
    like = lambda: tfm.tree_map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    return {"params": params,
            "opt": {"step": np.asarray(7, np.int32), "mu": like(),
                    "nu": tfm.tree_map(np.abs, like())},
            "ef_err": (tfm.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    like()) if ef else None)}


def _jax_state(tree):
    j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    opt = tree["opt"]
    return jsteps.TrainState(j(tree["params"]), jadamw.AdamWState(
        jnp.asarray(opt["step"]), j(opt["mu"]), j(opt["nu"])),
        None if tree["ef_err"] is None else j(tree["ef_err"]))


def _bitwise(port_state, jax_state):
    got = adamw.tree_leaves(port_state)
    want = jax.tree.leaves(jax_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            g, w = g.view(torch.int16).numpy(), w.view(np.int16)
        else:
            g = g.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    jcfg, tcfg = _cfgs()
    state = train_state_from_numpy(tcfg, _state_numpy(tcfg, 5), "cpu")
    mgr = store.CheckpointManager(tmp_path)
    mgr.save(3, state, metadata={"mesh": 1, "arch": tcfg.name})
    mgr.wait()
    restored, step, meta = jstore.restore_checkpoint(
        tmp_path, jsteps.abstract_train_state(jcfg))
    assert step == 3 and meta["arch"] == tcfg.name
    _bitwise(state, restored)


@pytest.mark.parametrize("with_ef", [False, True])
def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path, with_ef):
    """The reverse, with the bf16 error-feedback buffers too (the JAX
    store writes bf16 as raw 2-byte words)."""
    jcfg, tcfg = _cfgs()
    tree = _state_numpy(tcfg, 6, ef=with_ef)
    jstate = _jax_state(tree)
    jstore.save_checkpoint(tmp_path, 9, jstate)
    state, step, _ = store.restore_checkpoint(
        tmp_path, steps.abstract_train_state(tcfg, use_compression=with_ef),
        map_location="cpu")
    assert step == 9 and state.opt.step.dtype == torch.int32
    _bitwise(state, jstate)


def test_jax_store_cannot_restore_a_bf16_leaf(tmp_path):
    """A JAX-side fault the port does not share: the JAX store saves a
    bf16 leaf as raw words and its restore cannot cast them back, so a
    JAX train state with compression (bf16 buffers) or bf16 moments does
    not resume in the JAX package; the port restores it."""
    _, tcfg = _cfgs()
    state = train_state_from_numpy(tcfg, _state_numpy(tcfg, 7, ef=True),
                                   "cpu")
    store.save_checkpoint(tmp_path, 1, state)
    like = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.bfloat16), train_state_to_numpy(state)["ef_err"])
    with pytest.raises(ValueError, match="cast"):
        jstore.restore_checkpoint(tmp_path, jsteps.TrainState(
            None, None, like))
    back, _, _ = store.restore_checkpoint(
        tmp_path, steps.abstract_train_state(tcfg, use_compression=True),
        map_location="cpu")
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(adamw.tree_leaves(back.ef_err),
                               adamw.tree_leaves(state.ef_err)))


def test_train_state_numpy_round_trip():
    _, tcfg = _cfgs()
    tree = _state_numpy(tcfg, 8, ef=True)
    state = train_state_from_numpy(tcfg, tree, "cpu")
    again = train_state_from_numpy(tcfg, train_state_to_numpy(state), "cpu")
    a, b = adamw.tree_leaves(state), adamw.tree_leaves(again)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(again.opt.step) == 7


def test_abstract_state_and_input_specs_match_jax():
    for arch in ("qwen2-1.5b", "llama-3.2-vision-90b",
                 "seamless-m4t-large-v2"):
        jcfg, tcfg = _cfgs(arch)
        got = steps.abstract_train_state(tcfg, use_compression=True)
        want = jsteps.abstract_train_state(jcfg, use_compression=True)
        shapes = [tuple(t.shape) for t in adamw.tree_leaves(got)]
        assert shapes == [tuple(t.shape) for t in jax.tree.leaves(want)]
        assert all(t.device.type == "meta" for t in adamw.tree_leaves(got))
        for mode in ("train", "prefill", "decode"):
            g = steps.input_specs(tcfg, 48, 4, mode)
            w = jsteps.input_specs(jcfg, 48, 4, mode)
            assert sorted(g) == sorted(w)
            for k in w:
                assert tuple(g[k].shape) == w[k].shape
                assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype)


def test_prefill_and_decode_steps_wrap_the_model():
    _, tcfg = _cfgs()
    model = tfm.Transformer(tcfg, tfm.init_params(
        tcfg, torch.Generator().manual_seed(9), "cpu"))
    toks = np.random.default_rng(9).integers(0, tcfg.vocab, (2, 12))
    pre = steps.make_prefill_step(tcfg, seq_len=16, global_batch=2)
    dec = steps.make_decode_step(tcfg, seq_len=16, global_batch=2)
    cache = tfm.init_cache(tcfg, 2, 16, "cpu")
    logits, cache = pre.fn(model, cache, {"tokens": toks})
    ref = tfm.init_cache(tcfg, 2, 16, "cpu")
    want, ref, _ = model.prefill(ref, toks)
    assert torch.equal(logits, want)
    batch = {"token": toks[:, :1], "pos": np.full(2, 12)}
    got, _ = dec.fn(model, cache, batch)
    assert torch.equal(got, model.decode_step(ref, toks[:, :1],
                                              np.full(2, 12))[0])


def test_refusals():
    # --model-axis goes through make_local_mesh, as in the JAX driver: on
    # one device an axis of 2 raises its ValueError
    from repro.launch.mesh import make_local_mesh as jax_local_mesh
    with pytest.raises(ValueError) as want:
        jax_local_mesh(2)
    with pytest.raises(ValueError, match="cannot be factored into a model "
                       "axis of 2") as got:
        train.main(["--arch", ARCH, "--smoke", "--model-axis", "2",
                    "--device", "cpu"])
    assert str(got.value) == str(want.value)
    # the pod step takes a mesh with a "pod" axis
    mesh = make_local_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="multi-pod mesh required"):
        steps.make_pod_compressed_train_step(_cfgs()[1], mesh, seq_len=8,
                                             global_batch=2)


def test_train_reduces_loss_simple():
    """tests/test_models.py's end-to-end case on the port: a tiny dense
    model learns a repetitive stream."""
    _, cfg = _cfgs(n_layers=2, dtype=torch.bfloat16)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    model = tfm.Transformer(cfg, params, live=True)
    opt = adamw.init(params)
    rng = np.random.default_rng(3)
    motif = rng.integers(0, cfg.vocab, 8)
    batch = {"tokens": np.tile(motif, (4, 16))[:, :64].astype(np.int32)}
    losses = []
    for _ in range(30):
        (loss, _), grads = tfm.value_and_grad(model, cfg, batch)
        _, opt, _ = adamw.update(grads, opt, params, lr=3e-3,
                                 weight_decay=0.0)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.5, losses[::10]
