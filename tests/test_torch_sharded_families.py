"""Tensor and expert parallelism of the MoE, SSD, RG-LRU, cross-attention
and encoder groups: the port's sharded train step (``runtime/steps.py``,
``transformer.tp_nll_sums``) on a model axis above 1 for the six configs
beyond the dense and local/global groups, against the port's unsharded
step and the JAX package's unsharded calls, with the bounds and helpers
of ``tests/test_torch_sharded_step.py`` (f32 smoke configs, one step at
lr 1e-5, the cross-attention gates drawn at 0.5 so that the
cross-attention weights take a gradient).

Also: the layouts the rules give at the edges (experts that do not
divide the axis, recurrentgemma's heads and seamless's vocabulary at 2
and at 4, kimi-k2 with fsdp), expert parallelism seen on the shards and
the collectives, the differentiable all-gather and reduce-scatter, the
pod step of an MoE on a model axis against the JAX-composed oracle of
``tests/test_torch_pod_step.py``, and ``train --model-axis 2`` of
mamba2-780m resumed bitwise.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_pod_step as pod
from repro.models import blocks as jblocks
from repro_torch import configs
from repro_torch.models import blocks
from repro_torch.optim import adamw
from repro_torch.runtime import collectives as col
from test_torch_sharded_step import (B, MESHES, S,  # noqa: F401
                                     _against_jax, _against_unsharded,
                                     _batch, _cfg, _cli,
                                     _gathered, _held_as_predicted,
                                     _jax_step, _mesh, _np, _one_thread,
                                     _plain, _sharded, _tree, _unsharded)

FAMILIES = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "mamba2-780m",
            "recurrentgemma-2b", "llama-3.2-vision-90b",
            "seamless-m4t-large-v2"]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]


@functools.lru_cache(maxsize=None)
def _run(arch, mesh_shape):
    cfg = _cfg(arch)
    return _sharded(cfg, _tree(cfg), _batch(cfg), _mesh(mesh_shape))


def _all_take_gradients(got):
    """Every gradient leaf is nonzero (a gate left at 0 would zero the
    cross-attention weights' gradients and hide a missing sum)."""
    assert all(np.abs(g).max() > 0 for g in _np(got.grads))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_sharded_step_matches_the_unsharded_step(arch, mesh_shape):
    """The loss, every gradient leaf, the norm and the update within the
    unsharded bounds; every id holds the dry run's argument bytes; every
    collective key of the roofline terms is counted."""
    cfg = _cfg(arch)
    got = _run(arch, mesh_shape)
    _against_unsharded(got, _plain(arch))
    _held_as_predicted(cfg, got, False)
    _all_take_gradients(got)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_sharded_step_matches_the_jax_calls(arch, mesh_shape):
    _against_jax(_run(arch, mesh_shape), _jax_step(arch))


# ---------------------------------------------------------------------------
# Layouts at the edges
# ---------------------------------------------------------------------------

EDGES = [
    # 6 experts at 4: "ff" claims the axis, each expert Megatron-split
    ("qwen3-moe-30b-a3b", dict(n_experts=6), (1, 4), False,
     dict(expert=False, expert_ff=True)),
    # neither the experts nor their ff divide: the MoE block whole
    ("qwen3-moe-30b-a3b", dict(n_experts=6, d_ff=30), (1, 4), False,
     dict(expert=False, expert_ff=False)),
    # recurrentgemma's 10 heads, one KV head: 5 a rank at 2, whole at 4
    ("recurrentgemma-2b", dict(n_heads=10), (2, 2), False,
     dict(heads=True, kv_heads=False, inner=True)),
    ("recurrentgemma-2b", dict(n_heads=10), (1, 4), False,
     dict(heads=False, kv_heads=False, inner=True)),
    # seamless's vocabulary splits at 2, not at 4 (256206 = 2 x 128103)
    ("seamless-m4t-large-v2", dict(vocab=130), (2, 2), False,
     dict(vocab=True, heads=True)),
    ("seamless-m4t-large-v2", dict(vocab=130), (1, 4), False,
     dict(vocab=False, heads=True)),
    # an expert leaf split over "model" and, with fsdp, over "data"
    ("kimi-k2-1t-a32b", {}, (2, 2), True, dict(expert=True)),
]


@pytest.mark.parametrize("arch,kw,mesh_shape,fsdp,layout", EDGES, ids=[
    "experts-ff", "moe-whole", "rg-heads-2", "rg-heads-4", "vocab-2",
    "vocab-4", "kimi-fsdp"])
def test_layout_at_the_edges(arch, kw, mesh_shape, fsdp, layout):
    cfg = _cfg(arch, **kw)
    tree, batch = _tree(cfg), _batch(cfg)
    got = _sharded(cfg, tree, batch, _mesh(mesh_shape), fsdp)
    run = got.bundle.fn
    assert {k: getattr(run.layout, k) for k in layout} == layout
    _against_unsharded(got, _unsharded(cfg, tree, batch))
    _held_as_predicted(cfg, got, fsdp)
    if fsdp:
        w = run.param_sh[("groups", "moe", "moe", "w_gate")]
        assert tuple(w.spec) == (None, "model", "data", None)


def test_moe_is_expert_parallel(monkeypatch):
    """On (1, 4) each id of qwen3-moe holds n_experts / 4 experts'
    ``w_gate``, ``w_up`` and ``w_down`` (its own run of them), runs only
    those, and the ranks' combines are added by an all-reduce over
    "model" of one (B, S, d) output each."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    tree, batch = _tree(cfg), _batch(cfg)
    firsts, outs, sums = [], [], []
    project, total = blocks.MoEBlock.project, col.Group.sum

    def spy_project(self, h, first=0):
        firsts.append((first, self.cfg.local_experts))
        outs.append(project(self, h, first))
        return outs[-1]

    def spy_sum(self, xs):
        if any(x is o for x in xs for o in outs):
            sums.append((self.axes, [tuple(x.shape) for x in xs]))
        return total(self, xs)

    monkeypatch.setattr(blocks.MoEBlock, "project", spy_project)
    monkeypatch.setattr(col.Group, "sum", spy_sum)
    got = _sharded(cfg, tree, batch, _mesh((1, 4)))
    el = cfg.n_experts // 4
    for i, st in got.placed.items():
        moe = st.params["groups"]["moe"]["moe"]
        for name in ("w_gate", "w_up", "w_down"):
            # its own run of the experts, one step at lr 1e-5 away
            want = tree["groups"]["moe"]["moe"][name][:, i * el:(i + 1) * el]
            assert moe[name].shape == want.shape
            assert np.abs(moe[name].numpy() - want).max() < 1e-4
    assert set(firsts) == {(r * el, el) for r in range(4)}
    assert sums and all(axes == "model" and shapes == [(B, S, cfg.d_model)]
                        * 4 for axes, shapes in sums)
    assert got.bundle.collectives.by_id()[0]["all-reduce"]["model"] > 0


def test_ssd_segment_sums_are_summed_directly():
    """The SSD's decay segments at a chunk of 128 (mamba2-780m's) with
    decays ~0.7 a step: the port sums each segment directly and stays
    within a few f32 roundings of the segment itself; the JAX package's
    differences of one cumulative sum lose the digits of the running
    sum (ROADMAP C11), which a tensor-parallel step's rounding of the
    inputs then brings back into the decay parameters' gradients."""
    rng = np.random.default_rng(0)
    t = -np.log1p(np.exp(rng.standard_normal((4, 128)))).astype(np.float32)
    cs = np.cumsum(t.astype(np.float64), -1)
    exact = cs[..., :, None] - cs[..., None, :]
    low = np.tril(np.ones((128, 128), bool))
    seg = np.abs(exact[..., low])

    def err(got):
        got = np.asarray(got, np.float64)[..., low]
        return float((np.abs(got - exact[..., low]) / np.maximum(
            seg, 1e-30)).max())

    port = blocks._segsum(torch.from_numpy(t))
    assert torch.isinf(port[..., ~torch.from_numpy(low)]).all()
    assert err(port.numpy()) < 1e-6
    assert err(jblocks._segsum(jnp.asarray(t))) > 1e-5


# ---------------------------------------------------------------------------
# The differentiable all-gather and reduce-scatter
# ---------------------------------------------------------------------------

def test_gather_and_sum_scatter_carry_gradients():
    """``Group.gather``'s backward reduce-scatters the gradients and
    ``Group.sum_scatter``'s all-gathers them: each member's input
    gradient is the analytic one, and the counter sees both directions."""
    mesh = _mesh((1, 3))
    counter = col.Counter()
    group = col.mesh_groups(mesh, ("model",), counter)[0]
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 4, generator=gen, requires_grad=True)
          for _ in range(3)]
    ws = [torch.randn(2, 12, generator=gen) for _ in range(3)]
    whole = group.gather(xs, dim=-1)
    assert all(torch.equal(w, torch.cat([x.detach() for x in xs], -1))
               for w in whole)
    torch.autograd.backward([(w * y).sum() for w, y in zip(ws, whole)])
    for r, x in enumerate(xs):
        assert torch.allclose(x.grad, sum(w[:, 4 * r:4 * r + 4] for w in ws))
    ys = [torch.randn(2, 12, generator=gen, requires_grad=True)
          for _ in range(3)]
    vs = [torch.randn(2, 4, generator=gen) for _ in range(3)]
    parts = group.sum_scatter(ys, dim=-1)
    total = sum(y.detach() for y in ys)
    assert all(torch.allclose(p, total[:, 4 * r:4 * r + 4])
               for r, p in enumerate(parts))
    torch.autograd.backward([(v * p).sum() for v, p in zip(vs, parts)])
    assert all(torch.equal(y.grad, torch.cat(vs, -1)) for y in ys)
    done = counter.by_id()[0]
    assert set(done) == {"all-gather", "reduce-scatter"}
    assert done["all-gather"]["model"] == (2 * 12 + 2 * 12) * 4
    assert done["reduce-scatter"]["model"] == (2 * 4 + 2 * 4) * 4


# ---------------------------------------------------------------------------
# The pod step and the CLI
# ---------------------------------------------------------------------------

def test_pod_step_of_an_moe_on_a_model_axis():
    """qwen3-moe's pod step on (2, 1, 2): expert-parallel within each pod,
    the compact blocks averaged across pods, against the JAX-composed
    oracle's bounds."""
    pod.against_oracle("qwen3-moe-30b-a3b", (2, 1, 2))


def test_cli_model_axis_of_an_ssd_resumes_bitwise(tmp_path, capsys,
                                                  monkeypatch):
    """``train --arch mamba2-780m --smoke --model-axis 2`` on 4 logical
    devices: 2 steps, ``--resume auto`` to 4, against 4 at once."""
    monkeypatch.setattr(
        "repro_torch.launch.train.get_config", lambda arch, smoke=False:
        configs.get_config(arch, smoke=smoke).replace(dtype=torch.float32))
    arch = "mamba2-780m"
    first = _cli(tmp_path / "a", 2, arch=arch)
    assert dict(first["mesh"].shape) == {"data": 2, "model": 2}
    resumed = _cli(tmp_path / "a", 4, "--resume", "auto", arch=arch)
    whole = _cli(tmp_path / "b", 4, arch=arch)
    assert "resumed from step 2 (saved on 4 devices)" in \
        capsys.readouterr().out
    assert resumed["final_loss"] == whole["final_loss"]
    got, want = (adamw.tree_leaves(_gathered(r)) for r in (resumed, whole))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert resumed["bundle"].fn.layout.inner
