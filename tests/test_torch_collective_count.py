"""The representative count of a sharded step's collectives
(``runtime/collectives.py``: ``Representatives``, virtual group members),
traced on ``meta``, against the count of the same step run whole on
logical CPU devices: ``Counter.by_id()`` equal id by id, kind by kind and
axes by axes, for the train steps of the 10 smoke configs at (2, 4) and
(4, 2), the cross-pod compressed step at (2, 2, 2) (a vocabulary of
1024, so that the embedding's and the head's shards pass the
compressor's 2^14 entries), and the prefill and decode steps of one
config of each family at (2, 4), a batch-1 decode with ``seq_shard`` and
a decode whose MoE dispatch group spans the data shards among them.  A
representative trace runs one id, as the dry run does on the production
meshes.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.mesh import Mesh, logical_devices, process_devices
from repro_torch.models import transformer as tfm
from repro_torch.runtime import collectives as col
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps

S, B = 32, 8
MESHES = [(2, 4), (4, 2)]
#: one config of each family (dense, local/global, MoE, hybrid, SSM,
#: vision, audio)
FAMILIES = ["qwen2-1.5b", "gemma2-27b", "qwen3-moe-30b-a3b",
            "recurrentgemma-2b", "mamba2-780m", "llama-3.2-vision-90b",
            "seamless-m4t-large-v2"]
POD_AXES = ("pod", "data", "model")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(shape, axes=("data", "model"), platform="meta"):
    n = int(np.prod(shape))
    if platform == "meta":
        return Mesh(np.arange(n).reshape(shape), axes,
                    process_devices("meta", n))
    with logical_devices(n, platform):
        return Mesh(np.arange(n).reshape(shape), axes,
                    process_devices(platform))


def _host(abstract, vocab, seed=0):
    """Host arrays of an abstract batch's shapes and dtypes: token ids
    below ``vocab``, positions 3, memory drawn normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in abstract.items():
        if k == "pos":
            out[k] = torch.full(t.shape, 3, dtype=t.dtype)
        elif t.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(0, vocab, t.shape)
                                      .astype(np.int32))
        else:
            out[k] = torch.from_numpy(rng.standard_normal(t.shape)
                                      .astype(np.float32)).to(t.dtype)
    return out


def _count(cfg, shape, mode, axes=("data", "model"), representative=False,
           fsdp=False, pod=False, b=B, s=S):
    """One call of the sharded step: run whole on logical CPU devices (a
    fresh state drawn from seed 0) or, ``representative``, traced for one
    id on ``meta``.  Its ``Counter.by_id()`` and the ids that ran."""
    whole = not representative
    mesh = _mesh(shape, axes, "cpu" if whole else "meta")
    kw = dict(seq_len=s, global_batch=b, fsdp=fsdp,
              representative=representative)
    gen = torch.Generator().manual_seed(0)
    if mode == "train":
        make = (steps.make_pod_compressed_train_step if pod
                else steps.make_train_step)
        bundle = make(cfg, mesh, **kw)
        state = (steps.placed_train_state(bundle, gen) if whole
                 else steps.placed_abstract(bundle))
        batch = (_host(bundle.abstract_batch, cfg.vocab) if whole
                 else bundle.abstract_batch)
        bundle.fn(state, batch)
    else:
        make = (steps.make_prefill_step if mode == "prefill"
                else steps.make_decode_step)
        bundle = make(cfg, mesh, **kw)
        if whole:
            p_sh, c_sh = bundle.state_shardings
            params = shd.place_tree(tfm.init_params(cfg, gen, "cpu"), p_sh)
            cache = shd.place_tree(tfm.init_cache(cfg, b, s, "cpu"), c_sh)
            batch = _host(bundle.abstract_batch, cfg.vocab)
        else:
            (params, cache), batch = (steps.placed_abstract(bundle),
                                      bundle.abstract_batch)
        bundle.fn(params, cache, batch)
    return bundle.collectives.by_id(), bundle.fn.ids


def _held(cfg, shape, mode, axes=("data", "model"), **kw):
    """The whole run's count, then the representative trace's against
    it: equal, and from one id."""
    whole, ids = _count(cfg, shape, mode, axes, **kw)
    n = int(np.prod(shape))
    assert ids == list(range(n)) and set(whole) == set(ids)
    assert any(whole[i] for i in whole)
    rep, ids = _count(cfg, shape, mode, axes, representative=True, **kw)
    assert ids == [0]
    assert rep == whole, (rep, whole)
    return whole


@functools.lru_cache(maxsize=None)
def _cfg(arch, **kw):
    return configs.get_config(arch, smoke=True).replace(**kw)


@pytest.mark.parametrize("shape", MESHES,
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_representative_count_of_the_train_step(arch, shape):
    whole = _held(_cfg(arch), shape, "train",
                  fsdp=configs.get_recipe(arch)["fsdp"])
    # every id runs the same collectives (SPMD): the count says so
    assert len({repr(v) for v in whole.values()}) == 1


def test_representative_count_of_the_pod_step():
    cfg = _cfg("qwen2-1.5b", vocab=1024)
    whole = _held(cfg, (2, 2, 2), "train", POD_AXES, pod=True)
    assert any("pod" in axes.split(",") for kinds in whole.values()
               for axes in kinds.get("all-reduce", {}))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_representative_count_of_the_serve_steps(arch, mode):
    _held(_cfg(arch), (2, 4), mode, fsdp=configs.get_recipe(arch)["fsdp"])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-1.5b"])
def test_representative_count_of_a_sequence_sharded_decode(arch):
    """Batch 1 on a data axis of 2: the cache's ``kv_seq`` over "data"
    and each decode attention combined over the data groups."""
    whole = _held(_cfg(arch), (2, 4), "decode", b=1)
    assert all(kinds["all-reduce"].get("data") for kinds in whole.values())


def test_representative_count_of_an_moe_decode_gathered_over_data():
    """A dispatch group of 8 tokens over data shards of 4 rows: the MoE
    input all-gathered over "data"."""
    whole = _held(_cfg("qwen3-moe-30b-a3b", moe_group=8), (2, 4), "decode",
                  fsdp=True)
    assert all(kinds["all-gather"].get("data") for kinds in whole.values())


def test_representatives_partition_the_mesh():
    mesh = _mesh((2, 2, 4), POD_AXES)
    rep = col.Representatives(mesh)
    assert rep.ids == [0] and rep.stands_for == {0: list(range(16))}
    # the one group along "data" with id 0: 0 runs, 4 is virtual
    (g,) = col.mesh_groups(mesh, ("data",), col.Counter(rep.stands_for),
                           rep)
    assert g.ids == [0] and g.members == [0, 4] and g.virtual
    assert g.size == 2 and g.ranks == [0]
    (out,) = g.all_gather([torch.ones(3, 2)], dim=0)
    assert out.device.type == "meta" and out.shape == (6, 2)
    assert g.counter.by_id() == {
        j: {"all-gather": {"data": 48}} for j in range(16)}
    (g,) = col.mesh_groups(mesh, POD_AXES, None, rep)
    assert g.members == list(range(16)) and g.ids == [0]
