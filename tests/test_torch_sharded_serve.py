"""The port's sharded prefill and decode steps (``runtime/steps.py``:
``make_prefill_step`` and ``make_decode_step`` on a ("data", "model")
mesh, ``transformer.tp_serve``) on logical CPU devices, against the
port's unsharded steps (``Transformer.prefill`` and ``decode_step``) and
the JAX package's ``prefill`` and ``decode_step``.

Each case: a prompt's prefill, then decode steps, the logits gathered
(``bundle.fn.out_sharding``) and the cache gathered
(``sharding.gather_tree``) against the unsharded step's, in f32 with an
f32 cache (a bf16 cache rounds K/V computed in another sum order an ulp
apart now and then).  Bound: 1e-4 max(1, max|x|) of the logits and of
every cache leaf; against the JAX package 1e-4 of the logits (the
families' own bound, ``tests/test_torch_lm_families.py``).  The smoke
configs' MoE capacity is per token in a decode step and per sequence in
a prefill, so a data shard holds whole dispatch groups and no token is
dropped on one side and kept on the other: the dropped pairs are
printed.  A batch smaller than the data shards splits the caches' slots
over "data" (``seq_shard``); a dispatch group wider than a data shard
gathers the MoE's input over "data".
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.launch.mesh import Mesh, logical_devices, process_devices
from repro_torch.models import transformer as tfm
from repro_torch.models.blocks import MoEBlock
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps

TOL = 1e-4
GATE = 0.5
MESHES = [(2, 2), (1, 4)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch, **kw):
    return configs.get_config(arch, smoke=True).replace(dtype=torch.float32,
                                                        **kw)


def _tree(cfg, seed=3):
    tree = tfm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    for grp in tree["groups"].values():
        if "cross" in grp:
            grp["cross"]["gate"].fill_(GATE)
    return tree


def _mesh(shape):
    n = int(np.prod(shape))
    with logical_devices(n, "cpu"):
        return Mesh(np.arange(n).reshape(shape), ("data", "model"),
                    process_devices("cpu"))


def _ratio(got, want) -> float:
    assert got.shape == want.shape and torch.isfinite(got).all()
    return float((got.float() - want.float()).abs().max()) / (
        TOL * max(1.0, float(want.float().abs().max())))


def _drops(model) -> int:
    """The (token, choice) pairs the model's MoE blocks dropped in its
    last call."""
    return sum(int((~blk.kept).sum()) for blk in model.modules()
               if isinstance(blk, MoEBlock) and blk.kept is not None)


class Run:
    """A prompt of ``s`` tokens and ``n`` decode steps of a batch ``b``
    through the unsharded steps, the sharded ones on ``shape`` (and the
    JAX package's calls with ``jax``): the worst ratio to the bound of
    the logits and of the cache leaves, the MoE pairs each side
    dropped."""

    def __init__(self, arch, shape, b=4, s=16, n=2, jax_too=False, **kw):
        cfg = self.cfg = _cfg(arch, **kw)
        tree = _tree(cfg)
        length = s + n
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (b, s + n)).astype(np.int32)
        batch = {"tokens": toks[:, :s]}
        mem = steps._memory_spec(cfg, s, b)
        if mem is not None:
            batch["memory"] = rng.standard_normal(mem).astype(np.float32)
        model = tfm.Transformer(cfg, tree)
        cache = tfm.init_cache(cfg, b, length, "cpu", torch.float32)
        want, cache, memory = model.prefill(cache, batch["tokens"],
                                            batch.get("memory"))
        mesh = _mesh(shape)
        fsdp = configs.get_recipe(arch)["fsdp"]
        pre = steps.make_prefill_step(cfg, mesh, seq_len=length,
                                      global_batch=b, fsdp=fsdp)
        dec = steps.make_decode_step(cfg, mesh, seq_len=length,
                                     global_batch=b, fsdp=fsdp)
        self.pre, self.dec = pre.fn, dec.fn
        params = shd.place_tree(tree, pre.state_shardings[0])
        placed = shd.place_tree(tfm.init_cache(cfg, b, length, "cpu",
                                               torch.float32),
                                pre.state_shardings[1])
        got, placed = pre.fn(params, placed, batch)
        wants, gots = [want], [pre.fn.out_sharding.gather(got)]
        #: each call's dropped pairs: (unsharded, [each id's])
        self.drops = [(_drops(model), [_drops(m) for m in
                                       pre.fn.models.values()])]
        for t in range(s, s + n):
            db = {"token": toks[:, t:t + 1], "pos": np.full((b,), t,
                                                            np.int32)}
            if memory is not None:
                db["memory"] = memory.numpy()
            want, cache = model.decode_step(cache, db["token"], db["pos"],
                                            memory)
            got, placed = dec.fn(params, placed, db)
            wants.append(want)
            gots.append(dec.fn.out_sharding.gather(got))
            self.drops.append((_drops(model), [_drops(m) for m in
                                               dec.fn.models.values()]))
        self.logits = max(_ratio(g, w) for g, w in zip(gots, wants))
        self.cache = max(_ratio(g, w) for g, w in zip(
            tree_leaves(shd.gather_tree(placed, dec.state_shardings[1])),
            tree_leaves(cache)))
        self.gots = gots
        if jax_too:
            self.jax = self._jax(tree, toks, batch, s, n, length)

    def _jax(self, tree, toks, batch, s, n, length):
        """The worst ratio of the sharded logits to the JAX package's
        ``prefill`` and ``decode_step`` of the same weights."""
        jcfg = jconfigs.get_config(self.cfg.name, smoke=True).replace(
            dtype=jnp.float32)
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
        b = toks.shape[0]
        jcache = jax.tree.map(lambda t: t.astype(jnp.float32)
                              if t.dtype == jnp.bfloat16 else t,
                              jtfm.init_cache(jcfg, b, length)[0])
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want, jcache, jmem = jtfm.prefill(jparams, jcfg, jcache, jb)
        wants = [want]
        for t in range(s, s + n):
            db = {"token": toks[:, t:t + 1], "pos": np.full((b,), t,
                                                            np.int32)}
            if jmem is not None:
                db["memory"] = jmem
            want, jcache = jtfm.decode_step(jparams, jcfg, jcache, db)
            wants.append(want)
        return max(_ratio(g, torch.from_numpy(np.array(w, np.float32)))
                   for g, w in zip(self.gots, wants))


@pytest.mark.parametrize("shape", MESHES,
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_sharded_serve_matches_the_unsharded_steps(arch, shape):
    run = Run(arch, shape)
    if run.cfg.n_experts:
        print(f"{arch} {shape}: MoE pairs dropped (unsharded, each id) a "
              f"call {run.drops}")
    assert run.pre.seq_axes is None and run.dec.seq_axes is None
    assert run.logits <= 1.0 and run.cache <= 1.0, (run.logits, run.cache)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)],
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-1.5b"])
def test_a_batch_smaller_than_the_data_shards_splits_the_cache(arch, shape):
    """Batch 1: ``seq_shard`` holds, each cache's slots are split over
    "data" and a decode token's softmax combined over the data group;
    recurrentgemma's local window (32) wraps its ring buffer (a prompt of
    36), qwen2's global cache holds every position."""
    run = Run(arch, shape, b=1, s=36, n=4)
    assert run.pre.seq_axes == ("data",) == run.dec.seq_axes
    spec = run.dec.cache_sh[tfm.group_plan(run.cfg)[0][0]]
    assert any(leaf["k"].spec[2] == "data" for leaf in spec.values()
               if "k" in leaf)
    assert run.logits <= 1.0 and run.cache <= 1.0, (run.logits, run.cache)


def test_an_moe_dispatch_group_wider_than_a_data_shard_is_gathered():
    """A dispatch group of 8 tokens over data shards of 4 rows: the MoE
    blocks' input gathered over "data", so the shards route, fill and
    drop as the whole batch does."""
    run = Run("qwen3-moe-30b-a3b", (2, 2), b=8, s=16, n=2, moe_group=8)
    assert run.dec.row_axes == ("data",) and run.pre.row_axes is None
    print(f"MoE pairs dropped (unsharded, each id) a call {run.drops}")
    for want, ids in run.drops[1:]:     # each id routes the whole batch
        assert ids == [want] * len(ids)
    assert run.logits <= 1.0 and run.cache <= 1.0, (run.logits, run.cache)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "seamless-m4t-large-v2",
                                  "mamba2-780m"])
def test_one_by_one_mesh_is_the_unsharded_serve(arch):
    run = Run(arch, (1, 1))
    assert run.logits == 0.0 and run.cache == 0.0


@pytest.mark.parametrize("arch,shape,b", [("qwen2-1.5b", (2, 2), 4),
                                         ("recurrentgemma-2b", (2, 2), 1)])
def test_sharded_serve_matches_the_jax_calls(arch, shape, b):
    run = Run(arch, shape, b=b, s=16, n=2, jax_too=True)
    assert run.jax <= 1.0, run.jax
