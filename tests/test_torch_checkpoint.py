"""The port's checkpoint store against the JAX package's.

Either package restores the other's checkpoints: the manifest names the
same leaf paths (``jax.tree_util.keystr`` strings) in the same order
with numpy dtype strings, a JAX basis restores in the port with staged
tables bitwise equal, a port basis restores in the JAX package (G and T,
batched and B = 1, ragged and uniform), and a JAX engine checkpoint
serves in the port within ``1e-5 * max(1, max|y|)`` of the JAX engine's
``backend="xla"`` path (its Pallas tiered path is red on jax 0.9,
ROADMAP §C).  The router checkpoints are in tests/test_torch_ragged.py,
beside the router fits they reuse."""
import json
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.core import ApproxEigenbasis as JaxBasis
from repro.core import staging as jst
from repro.core.types import GFactors as JG, TFactors as JT
from repro.launch.serve import FGFTServeEngine as JaxEngine
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    read_metadata, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core import ApproxEigenbasis, laplacian
from repro_torch.graphs import community_graph, directed_variant
from repro_torch.launch.serve import FGFTServeEngine

N, B, G = 16, 3, 40
TIERS = {"full": 1.0, "balanced": 0.5, "draft": 0.25}
SIZES = [10, 16, 9]
CASES = [(kind, batched, ragged) for kind in ("sym", "general")
         for batched in (True, False) for ragged in (True, False)]
CASE_IDS = [f"{k}-{'batched' if b else 'single'}-"
            f"{'ragged' if r else 'uniform'}" for k, b, r in CASES]


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _same_tables(jstaged, tstaged):
    np.testing.assert_array_equal(np.asarray(jstaged.cuts), tstaged.cuts)
    for a, b in zip(jstaged[:-2], tstaged[:-2]):
        assert np.asarray(a).tobytes() == b.cpu().numpy().tobytes()


def _mats(kind, batched, ragged):
    """Laplacians of community graphs (directed for "general"), zero
    padded to N; with ``ragged`` the sides are ``SIZES``."""
    sizes = SIZES if ragged else [N] * B
    if not batched:
        sizes = sizes[:1]
    out = np.zeros((len(sizes), N, N), np.float32)
    for s, n in enumerate(sizes):
        adj = community_graph(n, seed=s)
        if kind == "general":
            adj = directed_variant(adj, seed=s)
        out[s, :n, :n] = laplacian(adj)
    size = (np.asarray(sizes) if batched else sizes[0]) if ragged else None
    return (out if batched else out[0]), size


def _port_fit(kind, batched, ragged):
    mats, sizes = _mats(kind, batched, ragged)
    return ApproxEigenbasis.fit(mats, G, n_iter=1, kind=kind, sizes=sizes,
                                device="cpu")


def _jax_chain(kind, batched, ragged, seed=0):
    """A JAX basis of random chains (indices below each matrix's size),
    packed by the JAX packers: what a JAX fit saves, without a fit."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(SIZES if ragged else [N] * B)[:B if batched else 1]
    lim = sizes[:, None]
    i = rng.integers(0, lim, (len(sizes), G))
    j = (i + rng.integers(1, lim, (len(sizes), G))) % lim
    if kind == "sym":
        theta = rng.uniform(-np.pi, np.pi, i.shape)
        f = JG(jnp.asarray(np.minimum(i, j), jnp.int32),
               jnp.asarray(np.maximum(i, j), jnp.int32),
               jnp.asarray(np.cos(theta), jnp.float32),
               jnp.asarray(np.sin(theta), jnp.float32),
               jnp.asarray(rng.choice([-1.0, 1.0], i.shape), jnp.float32))
    else:
        k = rng.integers(0, 2, i.shape)
        a = np.where(k == 0, rng.uniform(0.8, 1.25, i.shape),
                     rng.uniform(-0.5, 0.5, i.shape))
        f = JT(jnp.asarray(k, jnp.int32), jnp.asarray(i, jnp.int32),
               jnp.asarray(np.where(k == 0, i, j), jnp.int32),
               jnp.asarray(a, jnp.float32))
    spec = rng.uniform(0.0, 4.0, (len(sizes), N)).astype(np.float32)
    spec[np.arange(N)[None, :] >= lim] = 0.0
    if not batched:
        f = type(f)(*(t[0] for t in f))
        spec = spec[0]
    pack = {("sym", True): lambda: jst.pack_g_batch_pair(f, N),
            ("sym", False): lambda: jst.pack_g_pair(f, n=N),
            ("general", True): lambda: jst.pack_t_batch_pair(f, N),
            ("general", False): lambda: jst.pack_t_pair(f, N)}
    fwd, bwd = pack[(kind, batched)]()
    size = ((sizes if batched else int(sizes[0])) if ragged else None)
    return JaxBasis(kind=kind, n=N, batched=batched, factors=f,
                    spectrum=jnp.asarray(spec), fwd=fwd, bwd=bwd,
                    objective=None, info={"score": "gamma"}, sizes=size)


# ---------------------------------------------------------------------------
# the store: manifest, shards, commit marker, retention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sym", "general"])
def test_manifest_paths_order_and_dtypes_are_the_jax_stores(kind, tmp_path):
    basis = _port_fit(kind, True, False)
    state = {"factors": basis.factors, "spectrum": basis.spectrum,
             "laps": torch.zeros((B, N, N))}
    save_checkpoint(tmp_path / "port", 5, state, metadata={"k": 1})
    jax_state = jax.tree.map(lambda t: np.asarray(t), {
        "factors": type(basis.factors)(*(t.numpy() for t in basis.factors)),
        "spectrum": basis.spectrum.numpy(), "laps": np.zeros((B, N, N))})
    jax_state["laps"] = jax_state["laps"].astype(np.float32)
    jsave(tmp_path / "jax", 5, jax_state, metadata={"k": 1})
    leaves = [json.loads((tmp_path / d / "step_000000005" /
                          "manifest.json").read_text())["leaves"]
              for d in ("port", "jax")]
    assert leaves[0] == leaves[1]
    fields = (("i", "j", "c", "s", "sigma") if kind == "sym"
              else ("kind", "i", "j", "a"))
    assert [e["path"] for e in leaves[0]] == (
        [f"['factors'].{f}" for f in fields] + ["['laps']", "['spectrum']"])
    assert [e["key"] for e in leaves[0]] == [f"leaf_{k:05d}"
                                             for k in range(len(fields) + 2)]
    ints = {"i", "j", "kind"}
    assert [e["dtype"] for e in leaves[0][:len(fields)]] == [
        "int32" if f in ints else "float32" for f in fields]
    assert read_metadata(tmp_path / "port") == {"k": 1}


def test_shards_split_and_both_stores_reassemble(tmp_path):
    rng = np.random.default_rng(0)
    state = {"a": torch.from_numpy(rng.standard_normal((7, 5)).astype(
                 np.float32)),
             "b": torch.arange(2, dtype=torch.int32),      # < shards: whole
             "c": torch.tensor(3.5)}                       # 0-d: whole
    final = save_checkpoint(tmp_path, 1, state, shards=3)
    manifest = json.loads((final / "manifest.json").read_text())
    assert manifest["num_shards"] == 3
    assert [e.get("shards", 1) for e in manifest["leaves"]] == [3, 1, 1]
    files = sorted(p.name for p in final.glob("leaves_*.npz"))
    assert files == ["leaves_000.npz", "leaves_001.npz", "leaves_002.npz"]
    parts = [np.load(final / f)["leaf_00000"].shape[0] for f in files]
    assert parts == [3, 2, 2]
    like = {k: torch.zeros_like(v) for k, v in state.items()}
    got, step, _ = restore_checkpoint(tmp_path, like)
    assert step == 1
    for k in state:
        assert torch.equal(got[k], state[k]) and got[k].dtype == state[k].dtype
    jgot, _, _ = jrestore(tmp_path, {k: jnp.zeros(v.shape, v.numpy().dtype)
                                     for k, v in state.items()})
    for k in state:
        np.testing.assert_array_equal(np.asarray(jgot[k]), state[k].numpy())


def test_uncommitted_step_is_ignored(tmp_path):
    state = {"x": torch.ones(3)}
    save_checkpoint(tmp_path, 1, state)
    save_checkpoint(tmp_path, 2, {"x": torch.full((3,), 2.0)})
    (tmp_path / "step_000000002.COMMITTED").unlink()   # a crashed writer
    (tmp_path / "step_000000007.tmp").mkdir()          # a half-written one
    assert latest_step(tmp_path) == 1
    got, step, _ = restore_checkpoint(tmp_path, {"x": torch.zeros(3)})
    assert step == 1 and torch.equal(got["x"], torch.ones(3))
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(tmp_path, {"y": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        read_metadata(tmp_path / "empty")
    assert latest_step(tmp_path / "empty") is None


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in range(4):
        mgr.save(step, {"w": torch.full((2, 2), float(step))},
                 metadata={"step": step})
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.is_dir())
    assert steps == [2, 3] and latest_step(tmp_path) == 3
    got, step, meta = mgr.restore_latest({"w": torch.zeros(2, 2)})
    assert step == 3 and meta == {"step": 3}
    assert torch.equal(got["w"], torch.full((2, 2), 3.0))
    mgr.save(4, {"w": torch.zeros(2, 2)}, blocking=True)
    assert latest_step(tmp_path) == 4


# ---------------------------------------------------------------------------
# bases, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,batched,ragged", CASES, ids=CASE_IDS)
def test_jax_basis_checkpoint_loads_in_port_bitwise(kind, batched, ragged,
                                                    tmp_path):
    jb = _jax_chain(kind, batched, ragged)
    jb.save(tmp_path, step=4)
    tb = ApproxEigenbasis.load(tmp_path, device="cpu")
    assert (tb.kind, tb.n, tb.batched) == (kind, N, batched)
    _same_tables(jb.fwd, tb.fwd)
    _same_tables(jb.bwd, tb.bwd)
    np.testing.assert_array_equal(tb.spectrum.numpy(),
                                  np.asarray(jb.spectrum))
    assert np.array_equal(np.asarray(tb.sizes), np.asarray(jb.sizes))
    assert tb.info["score"] == "gamma" and tb.objective is None


@pytest.mark.parametrize("kind,batched,ragged", CASES, ids=CASE_IDS)
def test_port_basis_checkpoint_loads_in_jax(kind, batched, ragged,
                                            tmp_path):
    tb = _port_fit(kind, batched, ragged)
    tb.save(tmp_path, step=2)
    jb = JaxBasis.load(tmp_path)
    assert (jb.kind, jb.n, jb.batched) == (kind, N, batched)
    _same_tables(jb.fwd, tb.fwd)
    _same_tables(jb.bwd, tb.bwd)
    np.testing.assert_array_equal(np.asarray(jb.objective),
                                  tb.objective.numpy())
    assert np.array_equal(np.asarray(jb.sizes), np.asarray(tb.sizes))
    assert jb.info.get("score") == tb.info.get("score")
    # and back: the port restores its own checkpoint bitwise
    back = ApproxEigenbasis.load(tmp_path, device="cpu")
    _same_tables(jb.fwd, back.fwd)


def test_extended_basis_keeps_its_original_cut_through_save(tmp_path):
    mats, sizes = _mats("sym", True, True)
    tb = ApproxEigenbasis.fit(mats, 24, n_iter=1, sizes=sizes, device="cpu")
    grown = tb.extend(mats, G)
    assert 24 in grown.stage_cuts[:, 1]
    grown.save(tmp_path)
    with warnings.catch_warnings():       # the repacked ladder is the saved
        warnings.simplefilter("error")
        back = ApproxEigenbasis.load(tmp_path, device="cpu")
        jb = JaxBasis.load(tmp_path)
    np.testing.assert_array_equal(back.stage_cuts, grown.stage_cuts)
    np.testing.assert_array_equal(np.asarray(jb.fwd.cuts), grown.stage_cuts)
    assert back.info["score"] == grown.info["score"] == "gamma"


def test_basis_load_refuses_a_foreign_or_empty_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        ApproxEigenbasis.load(tmp_path / "none", device="cpu")
    save_checkpoint(tmp_path, 0, {"x": torch.ones(2)})
    with pytest.raises(ValueError, match="ApproxEigenbasis"):
        ApproxEigenbasis.load(tmp_path, device="cpu")


# ---------------------------------------------------------------------------
# serve engines, both ways
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_engine():
    laps = np.stack([laplacian(community_graph(N, seed=s))
                     for s in range(B)])
    jb = JaxBasis.fit(jnp.asarray(laps), G, n_iter=1)
    eng = JaxEngine(jnp.asarray(laps), basis=jb, backend="xla", tiers=TIERS,
                    filters="heat,tikhonov")
    x = np.random.default_rng(1).standard_normal((B, 5, N)).astype(
        np.float32)
    return laps, eng, x


def test_jax_engine_checkpoint_serves_in_port(jax_engine, tmp_path):
    laps, jeng, x = jax_engine
    jeng.save(tmp_path, step=3)
    teng = FGFTServeEngine.load(tmp_path, device="cpu")
    assert teng._tier_spec == TIERS and teng._filters == "heat,tikhonov"
    np.testing.assert_array_equal(teng._laps.numpy(), laps)
    _same_tables(jeng.basis.fwd, teng.basis.fwd)
    h = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
    for name in TIERS:
        assert (teng.tiers[name]["num_stages"]
                == jeng.tiers[name]["num_stages"])
        _close(teng.step(torch.from_numpy(x), h, tier=name).numpy(),
               jeng.step(jnp.asarray(x), h, tier=name))
    _close(teng.step_bank(torch.from_numpy(x)).numpy(),
           jeng.step_bank(jnp.asarray(x)))


def test_port_engine_checkpoint_loads_in_jax(tmp_path):
    laps = np.stack([laplacian(community_graph(N, seed=s))
                     for s in range(B)])
    teng = FGFTServeEngine(laps, G, n_iter=1, tiers=TIERS, device="cpu")
    teng.save(tmp_path, step=1)
    meta = read_metadata(tmp_path)
    assert meta["serve"]["tier_spec"] == TIERS
    assert meta["serve"]["num_transforms"] == G
    jeng = JaxEngine.load(tmp_path, backend="xla")
    np.testing.assert_array_equal(np.asarray(jeng._laps_host), laps)
    x = np.random.default_rng(2).standard_normal((B, 4, N)).astype(
        np.float32)
    for name in TIERS:
        _close(teng.step(torch.from_numpy(x), tier=name).numpy(),
               jeng.step(jnp.asarray(x), tier=name))


def test_engine_load_overrides_and_refusals(tmp_path):
    laps = np.stack([laplacian(community_graph(N, seed=s))
                     for s in range(2)])
    teng = FGFTServeEngine(laps, G, n_iter=1, device="cpu")
    teng.save(tmp_path / "eng")
    # filters= and tiers= override the saved settings
    back = FGFTServeEngine.load(tmp_path / "eng", filters="heat",
                                tiers={"hq": 1.0, "lo": 0.5}, device="cpu")
    assert set(back.tiers) == {"hq", "lo"} and len(back.bank) == 1
    x = torch.randn(2, 3, N)
    assert back.step_bank(x).shape == (2, 1, 3, N)
    # a basis-only checkpoint needs laps=
    teng.basis.save(tmp_path / "basis")
    with pytest.raises(ValueError, match="laps="):
        FGFTServeEngine.load(tmp_path / "basis", device="cpu")
    eng = FGFTServeEngine.load(tmp_path / "basis", laps=laps, device="cpu")
    torch.testing.assert_close(eng.step(x), teng.step(x), rtol=0, atol=0)
    # a dynamic engine's checkpoint restores dynamic (its versions, the
    # baseline from the restored objective), or static with
    # dynamic=False; then the unported options
    teng.basis.save(tmp_path / "dyn", extra_state={"laps": teng._laps},
                    extra_metadata={"dynamic": {"versions": [2, 1]}})
    dyn = FGFTServeEngine.load(tmp_path / "dyn", device="cpu")
    assert dyn.dynamic and dyn.versions.tolist() == [2, 1]
    assert dyn._stage_pad == (dyn._stage_pad[0], N // 2)
    assert dyn.maintain()["action"] == "reuse"
    torch.testing.assert_close(dyn.step(x), teng.step(x))
    static = FGFTServeEngine.load(tmp_path / "dyn", dynamic=False,
                                  device="cpu")
    torch.testing.assert_close(static.step(x), teng.step(x), rtol=0, atol=0)
    # placement is ported: the JAX engine's rules on a placement that
    # does not fit the fleet, with its messages
    from repro.runtime.sharding import BucketPlacement as JaxPlacement
    from repro_torch.runtime.sharding import BucketPlacement
    for cls, place, stack in ((JaxEngine, JaxPlacement, jnp.asarray),
                              (FGFTServeEngine, BucketPlacement, np.asarray)):
        with pytest.raises(ValueError, match=r"placement\.batch=3 != fleet "
                           r"batch 2"):
            cls(stack(laps), basis=teng.basis if cls is FGFTServeEngine
                else None, num_transforms=G, placement=place((0,), 3),
                **({"device": "cpu"} if cls is FGFTServeEngine else {}))
        with pytest.raises(ValueError, match=r"placement requires a "
                           r"batched \(B, n, n\) Laplacian stack"):
            cls(stack(laps[0]), num_transforms=G, placement=place((0,), 1),
                **({"device": "cpu"} if cls is FGFTServeEngine else {}))
    # bf16 table storage is ported: the restored engine serves bf16
    # tables, within the bf16 rounding of the f32 engine
    half = FGFTServeEngine.load(tmp_path / "eng", precision="bf16",
                                device="cpu")
    assert half._live.fwd[2].dtype == torch.bfloat16
    assert half._live.fwd[0].dtype == torch.int32
    assert half.basis.fwd.c.dtype == torch.float32
    y16, y32 = half.step(x), teng.step(x)
    assert y16.dtype == torch.float32
    assert float((y16 - y32).abs().max()) <= 0.03 * float(y32.abs().max())
    with pytest.raises(ValueError, match="precision"):
        FGFTServeEngine.load(tmp_path / "eng", precision="fp8",
                             device="cpu")
