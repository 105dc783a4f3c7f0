"""Tensor-parallel partial sums in bf16 (ROADMAP C12): the port's
collectives (``runtime/collectives.py``) add bf16 or f16 values in f32
and round once, as the JAX package's program is run on the CPU.

The reference's sharded output projection (``einsum("bshk,hkd->bsd")``,
``src/repro/models/blocks.py:105``, heads on "model") is, after XLA's
``spmd-partitioning``, a bf16 ``dot`` per shard and a bf16
``all-reduce``; the CPU backend's ``all-reduce-promotion`` pass then
converts the partials to f32, all-reduces them in f32 and rounds the sum
once to bf16.  A bf16 reduce-scatter is promoted the same way.

* (a) the port's ``Group.sum`` of the reference's own rank partials is
  the reference's sum within 1 bf16 ulp (f32 sums of four bf16 values in
  another order, rounded once; the bf16 adds that round after every add
  are several ulps away where the partials cancel);
* (b) the bf16 sharded train step (gradients) and decode step on
  (2, 2) against the unsharded bf16 steps.  The bound is measured, not
  fitted to the sharded reading: ``SPLIT`` = 2 times the distance of the
  unsharded bf16 step from the f32 step on the same inputs (the split
  step rounds as often as the unsplit one, so by the triangle
  inequality it lies within twice that distance of it).  Distances:
  gradients, max over leaves of max|d| / max(1e-3, max|g|); logits, max
  over the calls of max|d| / max(1, max|logits|).  An MoE's top-k sets
  flip on a few tokens in bf16 on either comparison (router logits
  rounded to bf16 tie often); the flips are printed;
* (c) the other sums are unchanged: f32 bitwise the members added one
  after the other, a maximum bitwise the elementwise maximum, and a
  bf16 or f16 sum bitwise the f32 sum in group order rounded once.
"""
import numpy as np
import pytest
import torch

from conftest import run_in_mesh_subprocess
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import Mesh, logical_devices, process_devices
from repro_torch.models import transformer as tfm
from repro_torch.models.blocks import MoEBlock
from repro_torch.optim import adamw
from repro_torch.runtime import collectives as col
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps

S, B = 32, 8
LR = dict(peak_lr=1e-5, warmup=0, total_steps=10)
#: the split step's bound, in units of the unsharded bf16 step's measured
#: distance from the f32 step (module docstring)
SPLIT = 2.0


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(shape, axes=("data", "model")):
    n = int(np.prod(shape))
    with logical_devices(n, "cpu"):
        return Mesh(np.arange(n).reshape(shape), axes, process_devices("cpu"))


def _bf16(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, np.uint16).view(np.int16)).view(
        torch.bfloat16)


def _ordered(t: torch.Tensor) -> np.ndarray:
    """bf16 bit patterns as integers in the order of their values (one
    apart: one ulp apart)."""
    i = t.view(torch.int16).numpy().astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFF), i)


# ---------------------------------------------------------------------------
# (a) the reference's sharded bf16 output projection
# ---------------------------------------------------------------------------

_SCRIPT = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax import shard_map
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rng = np.random.default_rng(0)
o = jnp.asarray(rng.standard_normal((2, 8, 8, 16)), jnp.bfloat16)
w = jnp.asarray(rng.standard_normal((8, 16, 64)) * 0.1, jnp.bfloat16)
o = jax.device_put(o, NamedSharding(mesh, P(None, None, "model", None)))
w = jax.device_put(w, NamedSharding(mesh, P("model", None, None)))


def proj(o, w):    # src/repro/models/blocks.py:105
    return jnp.einsum("bshk,hkd->bsd", o, w.astype(o.dtype))


full = jax.jit(proj, out_shardings=NamedSharding(mesh, P()))
hlo = full.lower(o, w).compile().as_text()
parts = jax.jit(shard_map(lambda o, w: proj(o, w)[None], mesh=mesh,
                          in_specs=(P(None, None, "model", None),
                                    P("model", None, None)),
                          out_specs=P("model")))(o, w)
bits = lambda a: np.asarray(a).view(np.uint16).ravel().tolist()
print(json.dumps({"sum": bits(full(o, w)), "shape": list(full(o, w).shape),
                  "parts": [bits(p) for p in parts],
                  "promoted": "f32" in hlo.split("all-reduce(")[0]
                  .splitlines()[-1] and "_promoted" in hlo}))
"""


def test_group_sum_of_the_reference_partials_rounds_once():
    ref = run_in_mesh_subprocess(_SCRIPT, devices=4)
    # the CPU backend runs the program's bf16 all-reduce in f32
    assert ref["promoted"]
    shape = ref["shape"]
    want = _bf16(ref["sum"]).reshape(shape)
    parts = [_bf16(p).reshape(shape) for p in ref["parts"]]
    mesh = _mesh((1, 4))
    group = col.mesh_groups(mesh, ("model",), col.Counter())[0]
    got = group.sum(parts)
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, got[0])
               for g in got)
    ulps = np.abs(_ordered(got[0]) - _ordered(want))
    print(f"Group.sum vs the reference: {int((ulps > 0).sum())} of "
          f"{ulps.size} entries an ulp apart, at most {int(ulps.max())}")
    assert ulps.max() <= 1
    # the counted bytes stay the partials' (bf16): the dry run's term
    assert group.counter.bytes[0][("all-reduce", "model")] == \
        want.numel() * 2


# ---------------------------------------------------------------------------
# (b) the bf16 sharded steps against the unsharded bf16 steps
# ---------------------------------------------------------------------------

def _configs(arch):
    """(f32 config, bf16 config): the smoke config in f32, and in bf16
    compute with the recipe's parameter dtype (kimi-k2: bf16)."""
    base = configs.get_config(arch, smoke=True)
    pd = configs.registry.RECIPES[arch].get("param_dtype", "float32")
    return (base.replace(dtype=torch.float32),
            base.replace(dtype=torch.bfloat16, param_dtype=getattr(torch, pd)))


def _params(tree, cfg, device):
    return tfm.tree_map(lambda a: torch.from_numpy(a.copy()).to(
        device, cfg.param_dtype), tree)


def _routes(model):
    return [(m.routes.sort(-1).values.cpu(), m.kept.cpu())
            for m in model.modules() if isinstance(m, MoEBlock)]


def _grads(cfg, tree, batch, device):
    model = tfm.Transformer(cfg, _params(tree, cfg, device), live=True)
    (loss, _), _ = tfm.value_and_grad(model, cfg, batch)
    return [g.clone() for g in adamw.tree_leaves(model.grads)], \
        _routes(model), float(loss)


def _sharded_grads(cfg, tree, batch, mesh, fsdp, device):
    bundle = steps.make_train_step(cfg, mesh, seq_len=S, global_batch=B,
                                   fsdp=fsdp, moment_dtype=cfg.param_dtype,
                                   **LR)
    params = _params(tree, cfg, device)
    placed = shd.place_tree(steps.TrainState(params, adamw.init(
        params, cfg.param_dtype)), bundle.state_shardings)
    metrics, grads = bundle.fn.gradients(placed, batch)
    grads = shd.gather_tree(grads, bundle.state_shardings.params)
    # each data shard's first id routes that shard's rows
    model_axis = mesh.shape["model"]
    routes = [bundle.fn.live[k * model_axis][1]
              for k in range(mesh.shape["data"])]
    return adamw.tree_leaves(grads), [_routes(m) for m in routes], \
        float(metrics[bundle.fn.ids[0]]["loss"])


def _decode(cfg, tree, device, mesh=None, fsdp=False, b=4, s=16, n=2):
    """The logits of a prompt's prefill and ``n`` decode steps, unsharded
    or on ``mesh``, the cache in bf16 for a bf16 config and in f32 for
    an f32 one."""
    params = _params(tree, cfg, device)
    cache_dtype = cfg.dtype
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, s + n))
    toks = toks.astype(np.int32)
    length = s + n
    if mesh is None:
        model = tfm.Transformer(cfg, params)
        cache = tfm.init_cache(cfg, b, length, device, cache_dtype)
        out = [model.prefill(cache, toks[:, :s])[0]]
        for t in range(s, s + n):
            out.append(model.decode_step(cache, toks[:, t:t + 1],
                                         np.full((b,), t, np.int32))[0])
        return out
    pre = steps.make_prefill_step(cfg, mesh, seq_len=length, global_batch=b,
                                  fsdp=fsdp)
    dec = steps.make_decode_step(cfg, mesh, seq_len=length, global_batch=b,
                                 fsdp=fsdp)
    placed_params = shd.place_tree(params, pre.state_shardings[0])
    cache = shd.place_tree(tfm.init_cache(cfg, b, length, device,
                                          cache_dtype),
                           pre.state_shardings[1])
    got, cache = pre.fn(placed_params, cache, {"tokens": toks[:, :s]})
    out = [pre.fn.out_sharding.gather(got)]
    for t in range(s, s + n):
        got, cache = dec.fn(placed_params, cache, {
            "token": toks[:, t:t + 1], "pos": np.full((b,), t, np.int32)})
        out.append(dec.fn.out_sharding.gather(got))
    return out


def _grad_dist(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               / max(1e-3, float(w.float().abs().max()))
               for g, w in zip(got, want))


def _logit_dist(got, want) -> float:
    assert all(torch.isfinite(g.float()).all() for g in got)
    return max(float((g.float() - w.float()).abs().max())
               / max(1.0, float(w.float().abs().max()))
               for g, w in zip(got, want))


def _flips(got, want) -> int:
    """Tokens whose top-k set or kept pairs differ, over the MoE
    blocks."""
    return sum(int((g[0] != w[0]).any(-1).sum()) + int((g[1] != w[1])
                                                       .any(-1).sum())
               for g, w in zip(got, want))


def split_distances(arch, mesh, device) -> dict:
    """The bf16 sharded steps of ``arch``'s smoke config on ``mesh``
    (train: gradients; serve: a prefill and two decode steps) against
    the unsharded bf16 steps on ``device``, beside the unsharded bf16
    steps' distances from the f32 ones on the same inputs: {"d_loss",
    "d_grads", "d_logits", "loss", "grads", "logits", "flips"} (the
    losses relative, printed, not gated)."""
    f32, bf16 = _configs(arch)
    fsdp = configs.get_recipe(arch)["fsdp"]
    # one set of values for both dtypes: drawn in f32, held at the
    # parameter dtype
    tree = tfm.tree_map(lambda t: t.to(bf16.param_dtype).float().numpy(),
                        tfm.init_params(f32, torch.Generator().manual_seed(3),
                                        "cpu"))
    batch = SyntheticLM(f32, S, B, seed=1).batch(0)
    g32, r32, l32 = _grads(f32, tree, batch, device)
    g16, r16, l16 = _grads(bf16, tree, batch, device)
    gsh, rsh, lsh = _sharded_grads(bf16, tree, batch, mesh, fsdp, device)
    assert all(g.dtype == bf16.param_dtype for g in gsh)
    assert {g.device.type for g in g16 + gsh} == {torch.device(device).type}
    d16 = _decode(bf16, tree, device)
    rows = B // mesh.shape["data"]
    return {"d_loss": abs(l16 - l32) / abs(l32),
            "d_grads": _grad_dist(g16, g32),
            "d_logits": _logit_dist(d16, _decode(f32, tree, device)),
            "loss": abs(lsh - l16) / abs(l16),
            "grads": _grad_dist(gsh, g16),
            "logits": _logit_dist(_decode(bf16, tree, device, mesh, fsdp),
                                  d16),
            "flips": {"bf16 vs f32": _flips(r16, r32),
                      "sharded vs unsharded": sum(
                          _flips(r, [(a[k * rows:(k + 1) * rows],
                                      kept[k * rows:(k + 1) * rows])
                                     for a, kept in r16])
                          for k, r in enumerate(rsh))}}


def held_within_split(arch, got) -> None:
    print(f"{arch} bf16: unsharded vs f32 loss {got['d_loss']:.3e}, "
          f"gradients {got['d_grads']:.3e}, logits {got['d_logits']:.3e}; "
          f"sharded vs unsharded loss {got['loss']:.3e}, gradients "
          f"{got['grads']:.3e}, logits {got['logits']:.3e}; MoE tokens "
          f"whose routes flip {got['flips']}")
    assert got["grads"] <= SPLIT * got["d_grads"]
    assert got["logits"] <= SPLIT * got["d_logits"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "kimi-k2-1t-a32b"])
def test_bf16_sharded_steps_within_the_measured_bound(arch):
    held_within_split(arch, split_distances(arch, _mesh((2, 2)), "cpu"))


# ---------------------------------------------------------------------------
# (c) every other sum as before
# ---------------------------------------------------------------------------

def _members(dtype, n=4, shape=(6, 8)):
    rng = np.random.default_rng(1)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             * 10.0 ** rng.integers(-3, 3)).to(dtype)
            for _ in range(n)]


def _in_order(xs, wide: bool):
    total = xs[0].float() if wide else xs[0]
    for x in xs[1:]:
        total = total + x
    return total.to(xs[0].dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16],
                         ids=lambda d: str(d).split(".")[-1])
@pytest.mark.parametrize("kind", ["sum", "all_reduce", "reduce_scatter",
                                  "sum_scatter", "max"])
def test_each_collective_sums_as_the_reference(kind, dtype):
    xs = _members(dtype)
    group = col.mesh_groups(_mesh((4,), ("model",)), ("model",))[0]
    wide = dtype in (torch.bfloat16, torch.float16)
    if kind == "max":
        want = xs[0]
        for x in xs[1:]:
            want = torch.maximum(want, x)
        got = group.max(xs)
    else:
        want = _in_order(xs, wide)
        if kind in ("sum", "all_reduce"):
            got = getattr(group, kind)(xs)
        else:
            got = getattr(group, kind)(xs, dim=1)
            want = list(want.chunk(4, dim=1))
    wants = want if isinstance(want, list) else [want] * 4
    assert all(g.dtype == dtype and torch.equal(g, w)
               for g, w in zip(got, wants))
