"""The port's dry run (``repro_torch.launch.dryrun``) and what it stands on
against the JAX package: the logical axes of every parameter and cache
leaf, the model half of ``runtime/sharding.py`` (rules, specs, shard
shapes), ``make_production_mesh``, ``adamw.state_axes``, the parameter
counts, ``model_flops`` and the dot FLOPs of the eager step traced on
``meta`` against XLA's loop-aware count.  The argument bytes against
XLA's ``memory_analysis`` are in ``test_torch_dryrun_bytes.py``.

FLOP tolerance (one smoke config of each family, S 32 x B 4, 1x1 mesh):
the port's traced dot FLOPs against ``hlo.roofline_terms(compiled)
["hlo_flops"]``.  Serving (prefill, decode): the port counts 0.1-0.5%
fewer, the JAX ``rmsnorm``'s x.x ``einsum`` (2 d FLOPs a token and norm),
a dot in XLA and an elementwise square-and-sum in the port.  Training: the
port counts 0.7-2.7% more: its loss checkpoints each chunk's projection
and recomputes it in the backward (2 B (S-1) d V FLOPs), where XLA, with
one chunk and no scan, computes it once; less the same norm dots.  So a
serving step must lie in [-1%, 0] and a training step in [0, +3%]."""
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_NAMES, SHAPES as JSHAPES, get_config as jget
from repro.configs import get_recipe as jrecipe
from repro.models import transformer as jtfm
from repro.models.common import Axes as JAxes
from repro.optim import adamw as jadamw
from repro.runtime import hlo_analysis as jhlo
from repro.runtime import sharding as jsh
from repro.runtime import steps as jsteps
from repro_torch.configs import SHAPES, get_config, get_recipe
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (Mesh, logical_devices,
                                     make_production_mesh, process_devices)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import Axes, attention
from repro_torch.optim import adamw
from repro_torch.runtime import hlo_analysis as hlo
from repro_torch.runtime import sharding as tsh
from repro_torch.runtime import steps

#: one smoke config of each family: dense, MoE, SSM, hybrid, vision, audio
FAMILIES = ("qwen2-1.5b", "qwen3-moe-30b-a3b", "mamba2-780m",
            "recurrentgemma-2b", "llama-3.2-vision-90b",
            "seamless-m4t-large-v2")
#: the band of (port / JAX - 1) per mode (module docstring)
FLOP_BAND = {"train": (0.0, 0.03), "prefill": (-0.01, 0.0),
             "decode": (-0.01, 0.0)}


def _jax_axes(tree):
    return jax.tree.map(lambda a: a.axes, tree,
                        is_leaf=lambda x: isinstance(x, JAxes))


def _axes(tree):
    return tfm.tree_map(lambda a: a.axes, tree)


class _FakeMesh:
    """The JAX functions read only a mesh's shape and axis names."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _meshes(kind):
    multi = kind == "multi"
    mesh = make_production_mesh(multi_pod=multi)
    fake = _FakeMesh((2, 16, 16) if multi else (16, 16),
                     ("pod", "data", "model") if multi
                     else ("data", "model"))
    return mesh, fake


def _leaves(tree):
    out = []
    tfm.tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# Logical axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_cache_axes_are_the_jax_trees(arch):
    """Full size: axes need no memory on either side."""
    cfg, jcfg = get_config(arch), jget(arch)
    assert _axes(tfm.param_axes(cfg)) == _jax_axes(
        jtfm.init_params(jcfg, mode="axes")[0])
    assert _axes(tfm.cache_axes(cfg)) == _jax_axes(
        jtfm.init_cache(jcfg, 2, 64, mode="axes")[0])
    # the axes sit beside shapes of their rank
    for leaf in _leaves(tfm.param_spec(cfg)):
        assert len(leaf.axes) == len(leaf.shape)
    cache = tfm.init_cache(cfg, 2, 64, device="meta")
    shapes = [t.shape for t in _leaves(cache)]
    assert [len(a.axes) for a in _leaves(tfm.cache_axes(cfg))] == \
        [len(s) for s in shapes]


def test_param_draws_keep_their_order():
    """The axes change no draw: the spec's leaves and initializers stay."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    a = tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tfm.tree_map(lambda x, y: np.testing.assert_array_equal(x, y), a, b)
    spec = tfm.param_spec(cfg)
    assert spec["embed"] == tfm.Leaf((cfg.vocab, cfg.d_model), "normal",
                                     0.01, ("vocab", "embed"))


@pytest.mark.parametrize("arch", ("qwen2-1.5b", "kimi-k2-1t-a32b"))
def test_state_axes_are_the_jax_state_axes(arch):
    got = adamw.state_axes(tfm.param_axes(get_config(arch)))
    want = jadamw.state_axes(jtfm.init_params(jget(arch), mode="axes")[0])
    assert got.step == Axes(()) and want.step.axes == ()
    assert _axes(got.mu) == _jax_axes(want.mu)
    assert _axes(got.nu) == _jax_axes(want.nu)


# ---------------------------------------------------------------------------
# Rules, specs, meshes, shard shapes
# ---------------------------------------------------------------------------

def test_production_meshes():
    single, multi = (make_production_mesh(),
                     make_production_mesh(multi_pod=True))
    assert dict(single.shape) == {"data": 16, "model": 16}
    assert single.axis_names == ("data", "model") and single.size == 256
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    for mesh in (single, multi):
        assert mesh.platform == "meta"
        assert np.array_equal(np.sort(mesh.device_ids.ravel()),
                              np.arange(mesh.size))
    assert process_devices("meta", 3) == {i: torch.device("meta")
                                          for i in range(3)}


@pytest.mark.parametrize("kind", ("single", "multi"))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_and_specs_are_the_jax_ones(arch, kind):
    """Every shape's rules and every parameter and cache leaf's spec on
    the production mesh, fsdp as the recipe says."""
    cfg, jcfg = get_config(arch), jget(arch)
    mesh, fake = _meshes(kind)
    fsdp = get_recipe(arch)["fsdp"]
    assert fsdp == jrecipe(arch)["fsdp"]
    p_axes = _leaves(tfm.param_axes(cfg))
    c_axes = _leaves(tfm.cache_axes(cfg))
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        dp = int(np.prod([mesh.shape[a] for a in tsh.dp_axes(mesh)]))
        seq_shard = shape.mode != "train" and shape.global_batch < dp
        rules = tsh.make_rules(mesh, cfg, fsdp=fsdp, seq_shard=seq_shard,
                               global_batch=shape.global_batch)
        want = jsh.make_rules(fake, jcfg, fsdp=fsdp, seq_shard=seq_shard,
                              global_batch=jshape.global_batch)
        assert rules == want
        for a in p_axes + c_axes:
            got = tsh.spec_for(a.axes, rules)
            assert tuple(got) == tuple(jsh.spec_for(a.axes, want))
            assert isinstance(got, tuple) and got == tsh.P(*got)
        for mem in (False, True):
            got = tsh.batch_sharding(mesh, rules, with_memory=mem,
                                     mode=shape.mode)
            jwant = jsh.batch_sharding(jax.sharding.AbstractMesh(
                tuple(fake.shape.values()), fake.axis_names), want,
                with_memory=mem, mode=jshape.mode)
            assert {k: tuple(v.spec) for k, v in got.items()} == \
                {k: tuple(v.spec) for k, v in jwant.items()}
        assert tsh.check_divisibility(cfg, mesh, shape.global_batch,
                                      shape.mode) == \
            jsh.check_divisibility(jcfg, fake, jshape.global_batch,
                                   jshape.mode)


def test_spec_dedupes_mesh_axes():
    rules = {"expert": "model", "embed": "data", "ff": "model", None: None}
    spec = tsh.spec_for(("expert", "embed", "ff"), rules)
    assert spec == tsh.P("model", "data", None)
    assert tuple(spec) == tuple(JP("model", "data", None))


def test_spec_dedupe_with_tuple_axes():
    rules = {"batch": ("pod", "data"), "kv_seq": "data", None: None}
    spec = tsh.spec_for(("batch", "kv_seq"), rules)
    assert spec == tsh.P(("pod", "data"), None)
    assert repr(spec) == repr(JP(("pod", "data"), None))


def test_make_rules_divisibility_fallbacks():
    mesh, _ = _meshes("single")
    cfg = get_config("qwen2-1.5b")   # 12 heads, kv=2: neither divides 16
    rules = tsh.make_rules(mesh, cfg, global_batch=256)
    assert rules["heads"] is None and rules["kv_heads"] is None
    assert rules["ff"] == "model" and rules["vocab"] == "model"
    cfg7 = get_config("qwen2-7b")    # 28 heads: not divisible either
    assert tsh.make_rules(mesh, cfg7, global_batch=256)["heads"] is None
    glm = get_config("glm4-9b")      # 32 heads divisible
    assert tsh.make_rules(mesh, glm, global_batch=256)["heads"] == "model"
    mam = get_config("mamba2-780m")  # vocab 50280 % 16 != 0
    assert tsh.make_rules(mesh, mam, global_batch=256)["vocab"] is None


def test_make_rules_batch_fallback():
    mesh, _ = _meshes("multi")
    cfg = get_config("glm4-9b")
    r = tsh.make_rules(mesh, cfg, global_batch=256)
    assert r["batch"] == ("pod", "data")
    r1 = tsh.make_rules(mesh, cfg, global_batch=1, seq_shard=True)
    assert r1["batch"] is None and r1["kv_seq"] == "data"
    r2 = tsh.make_rules(mesh, cfg, global_batch=2)
    assert r2["batch"] == ("pod",)


def test_shard_shape_and_its_error():
    mesh = Mesh(np.arange(8).reshape(2, 4), ("data", "model"),
                process_devices("meta", 8))
    s = tsh.NamedSharding(mesh, tsh.P(("data", "model"), None, "model"))
    assert s.shard_shape((16, 3, 8)) == (2, 3, 2)
    assert tsh.NamedSharding(mesh, tsh.P()).shard_shape((5, 7)) == (5, 7)
    with pytest.raises(ValueError, match="implies that array axis 0 is "
                       r"partitioned 4 times, but the dimension size is 6 "
                       r"\(full shape: \(6, 3\), per-dimension tiling "
                       r"factors: \[4, 1\] should evenly divide the shape\)"):
        tsh.NamedSharding(mesh, tsh.P("model")).shard_shape((6, 3))


@pytest.mark.parametrize("spec", [("model", None), (None, "data"),
                                  (("data", "model"),), (), ("data",
                                                             "model")])
def test_shard_and_gather_on_logical_devices(spec):
    """Each id holds its part (replicas whole copies), the parts' bytes
    are ``shard_nbytes`` and the gather is bitwise the tensor."""
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    with logical_devices(4, "cpu"):
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(2, device="cpu")
    s = tsh.NamedSharding(mesh, tsh.P(*spec))
    parts = s.shard(x)
    assert sorted(parts) == [0, 1, 2, 3]
    assert all(p.shape == s.shard_shape(x.shape) for p in parts.values())
    assert all(p.numel() * 4 == s.shard_nbytes(x) for p in parts.values())
    assert torch.equal(s.gather(parts), x)
    if spec == ("model", None):     # id 1 is (data 0, model 1)
        assert torch.equal(parts[1], x[4:])
        assert torch.equal(parts[2], x[:4])


def test_state_placed_on_logical_devices_is_the_dry_run_bytes():
    """The smoke train state and batch on a (2, 2) mesh of logical CPU
    devices through ``sharding_tree``: each id's shard bytes are the dry
    run's argument bytes, and the shards gather back bitwise."""
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    recipe = {"fsdp": True, "moment_dtype": torch.float32}
    shape = Shape("smoke", 16, 4, "train")
    with logical_devices(4, "cpu"):
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(2, device="cpu")
    want = dryrun.analyze(cfg, recipe, shape, mesh)
    rules = tsh.make_rules(mesh, cfg, fsdp=True, global_batch=4)
    state = steps.concrete_train_state(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16),
                                     dtype=torch.int32)}
    shard = {"state": steps.state_shardings(cfg, mesh, rules),
             "batch": tsh.batch_sharding(mesh, rules, mode="train")}
    held = dict.fromkeys(range(4), 0)
    for t, s in dryrun._pairs({"state": state, "batch": batch}, shard):
        parts = s.shard(t)
        for i, p in parts.items():
            held[i] += p.numel() * p.element_size()
        assert torch.equal(s.gather(parts), t)
    assert set(held.values()) == {want["memory"]["argument_size_in_bytes"]}


# ---------------------------------------------------------------------------
# Counts, terms and the trace
# ---------------------------------------------------------------------------

def _jax_n_params(jcfg):
    """``repro.launch.dryrun.n_params``, imported with the XLA_FLAGS its
    import sets (512 host devices) put back for later subprocesses."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdryrun.n_params(jcfg)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_n_params_is_the_jax_count(arch):
    assert dryrun.n_params(get_config(arch)) == _jax_n_params(jget(arch))


def test_model_flops():
    assert hlo.model_flops(10, 5, "train") == 300.0
    assert hlo.model_flops(10, 5, "serve") == 100.0
    for args in ((1.5e9, 256 * 4096, "train"), (7, 3, "serve")):
        assert hlo.model_flops(*args) == jhlo.model_flops(*args)


def test_h100_constants_and_terms():
    assert (hlo.PEAK_FLOPS_BF16, hlo.HBM_BW, hlo.HBM_BYTES) == \
        (989.4e12, 3.35e12, 80e9)
    cost = {"flops": 4 * 989.4e12, "bytes": 2 * 3.35e12}
    t = hlo.roofline_terms(cost, n_chips=2)
    assert t["compute_s"] == 2.0 and t["memory_s"] == 1.0
    assert t["dominant"] == "compute"
    assert t["hlo_flops"] == 2 * 989.4e12 and t["hlo_bytes"] == 3.35e12
    assert t["unavailable"] == list(hlo.UNAVAILABLE)
    assert all(t[k] is None for k in hlo.UNAVAILABLE)
    jax_keys = {"compute_s", "memory_s", "collective_s", "dominant",
                "hlo_flops", "hlo_bytes", "collective_bytes",
                "cross_pod_bytes", "cross_pod_s", "collective_by_kind",
                "collective_counts", "naive_cost_analysis"}
    assert set(t) == jax_keys | {"unavailable", "unavailable_why"}
    mem = hlo.memory_summary(argument=10, output=7, temp=5, alias=6)
    assert mem["per_device_bytes"] == 16.0
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes",
                        "generated_code_size_in_bytes",
                        "alias_size_in_bytes", "per_device_bytes"}


def test_step_cost_counts_dots_bytes_peak_and_reads():
    a = torch.empty((8, 16), device="meta")
    b = torch.empty((16, 4), device="meta")
    unused = torch.empty((1000,), device="meta")

    def fn(a, b, unused):
        h = (a * 2.0) @ b            # 2*8*16*4 dot FLOPs
        return h.t().contiguous()

    out, cost = hlo.step_cost(fn, a, b, unused)
    assert out.shape == (4, 8) and cost["flops"] == 2 * 8 * 16 * 4
    assert cost["flops_by_op"] == {"mm": 1024}
    # mul: a in, 128 out; mm: 128 + 64 in, 32 out; t: a view; clone: 32+32
    assert cost["bytes"] == 4 * (128 + 128 + 128 + 64 + 32 + 32 + 32)
    # a * 2 and the product live together; a * 2 is gone by the clone
    assert cost["temp_bytes"] == 4 * (128 + 32)
    assert cost["reads"] == {hlo.storage_key(a), hlo.storage_key(b)}
    assert cost["op_counts"]["mm"] == 1


def test_attention_on_meta_counts_every_tile():
    """A meta trace has no positions: the chunked path with tile skipping
    counts the dots of every tile, as without skipping."""
    b, s, h, kv, hd = 2, 64, 4, 2, 8
    q = torch.empty((b, s, h, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, s, kv, hd), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((b, s), dtype=torch.int32, device="meta")
    counts = []
    for skip in (True, False):
        _, cost = hlo.step_cost(lambda q, k: attention(
            q, k, k, pos, pos, chunk=16, skip=skip), q, k)
        counts.append(cost["flops"])
    assert counts[0] == counts[1] == 2 * 2 * b * h * s * s * hd


@pytest.mark.parametrize("mode", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_dot_flops_are_the_jax_loop_aware_count(arch, mode):
    seq, batch = 32, 4
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jcfg = jget(arch, smoke=True)
    make = {"train": jsteps.make_train_step,
            "prefill": jsteps.make_prefill_step,
            "decode": jsteps.make_decode_step}[mode]
    bundle = make(jcfg, mesh, seq_len=seq, global_batch=batch)
    state = bundle.abstract_state
    args = ((state,) if mode == "train" else tuple(state)) + (
        bundle.abstract_batch,)
    with mesh:
        want = jhlo.roofline_terms(bundle.fn.lower(*args).compile())[
            "hlo_flops"]
    got = dryrun.trace_step(get_config(arch, smoke=True),
                            Shape("smoke", seq, batch, mode), batch)
    lo, hi = FLOP_BAND[mode]
    rel = got["cost"]["flops"] / want - 1
    assert lo <= rel <= hi, (arch, mode, got["cost"]["flops"], want)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_writes_the_jax_keys(tmp_path, monkeypatch, capsys):
    """A small cell on both meshes with an override, a cached rerun, and
    the ``pod_compress`` override on the single-pod mesh recorded as a
    failure with the JAX step's assertion.  Every collective key is
    filled, from the sharded decode step traced for one id of each
    production mesh, and ``dominant`` is taken over the three terms."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    argv = ["--arch", "mamba2-780m", "--shape", "decode_32k", "--mesh",
            "both", "--override", "attn_chunk=512"]
    assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("OK mamba2-780m decode_32k") == 2
    jax_keys = {"arch", "shape", "mesh", "mode", "n_chips", "seq_len",
                "global_batch", "fsdp", "moment_dtype", "params_total",
                "params_active", "lower_s", "compile_s", "memory",
                "hbm_gb_per_chip", "roofline", "model_flops_per_chip",
                "useful_flop_frac", "overrides"}
    for kind, chips in (("single", 256), ("multi", 512)):
        res = json.loads((tmp_path / f"mamba2-780m__decode_32k__{kind}.json")
                         .read_text())
        assert jax_keys <= set(res)
        assert res["n_chips"] == chips and res["mesh"] == kind
        assert res["overrides"] == {"attn_chunk": 512}
        assert res["flops_basis"] == "global/n_chips"
        assert res["temp_basis"] == "one data shard, model axis unsplit"
        roof = res["roofline"]
        assert roof["unavailable"] == [] and roof["unavailable_why"] is None
        assert all(roof[k] is not None for k in hlo.UNAVAILABLE)
        assert roof["collective_bytes"] > 0 and roof["collective_s"] > 0
        assert roof["cross_pod_bytes"] == 0     # no group crosses a pod
        assert set(roof["collective_by_kind"]) == set(hlo.COLLECTIVES)
        assert sum(roof["collective_by_kind"].values()) == \
            roof["collective_bytes"]
        terms = {k: roof[f"{k}_s"] for k in ("compute", "memory",
                                               "collective")}
        assert roof["dominant"] == max(terms, key=terms.get)
        assert "collectives" in res["basis"]
        assert res["memory"]["per_device_bytes"] > 0
        assert res["moment_dtype"] == "float32"
        assert (res["params_total"], res["params_active"]) == \
            _jax_n_params(jget("mamba2-780m"))
    assert dryrun.main(argv) == 0
    assert capsys.readouterr().out.count("CACHED") == 2
    bad = ["--arch", "qwen2-1.5b", "--shape", "train_4k", "--override",
           "pod_compress=true"]
    assert dryrun.main(bad) == 1
    assert "FAIL qwen2-1.5b train_4k single: multi-pod mesh required\n" in \
        capsys.readouterr().out


def test_cli_pod_compress_cell_on_a_small_multi_mesh(tmp_path, monkeypatch,
                                                     capsys):
    """``--override pod_compress=true`` runs the cross-pod compressed
    step's trace on the multi mesh (here a (2, 2, 2) one and a smoke
    config at S 32 x B 8, a vocabulary of 1024 so that the embedding's
    and the head's shards are compressed): cross-pod bytes above 0 and
    under half of all collective bytes (the JAX test's gate); on the
    single mesh the JAX step's assertion."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    monkeypatch.setattr(dryrun, "SHAPES", {"train_4k": Shape(
        "train_4k", 32, 8, "train")})
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(
        arch, smoke=True).replace(vocab=1024))
    small = {True: ((2, 2, 2), ("pod", "data", "model")),
             False: ((2, 4), ("data", "model"))}

    def mesh(multi_pod=False):
        shape, axes = small[multi_pod]
        return Mesh(np.arange(8).reshape(shape), axes,
                    process_devices("meta", 8))

    monkeypatch.setattr(dryrun, "make_production_mesh", mesh)
    argv = ["--arch", "qwen2-1.5b", "--shape", "train_4k", "--override",
            "pod_compress=true"]
    assert dryrun.main(argv + ["--mesh", "multi"]) == 0
    res = json.loads((tmp_path / "qwen2-1.5b__train_4k__multi.json")
                     .read_text())
    roof = res["roofline"]
    assert 0 < roof["cross_pod_bytes"] < 0.5 * roof["collective_bytes"]
    assert roof["cross_pod_s"] == roof["cross_pod_bytes"] / hlo.NVLINK_BW
    assert "pod-compressed" in res["basis"]["collectives"]
    assert res["overrides"] == {"pod_compress": True}
    assert dryrun.main(argv + ["--mesh", "single"]) == 1
    assert "FAIL qwen2-1.5b train_4k single: multi-pod mesh required\n" in \
        capsys.readouterr().out


def test_cli_all_lists_the_jax_cells(tmp_path, monkeypatch, capsys):
    """``--all`` runs the JAX cell list: 32 cells a mesh and the 8 skips
    with their reasons (the cells themselves stubbed here: the whole run
    takes minutes)."""
    seen = []
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a: seen.append(a[:3]) or {"roofline": {
                            "compute_s": 1.0, "memory_s": 2.0,
                            "collective_s": None, "dominant": "memory"},
                            "hbm_gb_per_chip": 1.0, "lower_s": 0.0,
                            "compile_s": 0.0})
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    assert dryrun.main(["--all", "--mesh", "both"]) == 0
    out = capsys.readouterr().out
    assert len(seen) == 64 and out.count("SKIP ") == 8
    from repro.configs import cells as jcells
    run, skip = jcells(ARCH_NAMES)
    assert seen == [(a, s, m) for a, s in run for m in ("single", "multi")]
    for a, s, why in skip:
        assert f"SKIP {a} {s}: {why}" in out
