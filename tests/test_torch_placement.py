"""Fleet placement in the port against its own unplaced path and the JAX
package, on logical CPU devices (``logical_devices``).

Placed answers must be BITWISE the unplaced ones: the placement pads the
batch with structural no-op rows (``pad_batch``, bitwise the JAX tables)
and runs every shard through the same program.  Against the JAX package:
a placed JAX engine on 4 forced host devices (``backend="xla"``: its
Pallas path is red under a mesh, ROADMAP C3) within the port-vs-JAX
tolerance 1e-5 * max(1, max|y|), and placed router checkpoints both ways
(JAX saves on 4 devices, the port loads on 1 and 8; the port saves on 4,
JAX loads on 1 and 8), each load re-placed onto the reader's devices.
Two JAX subprocesses in all (conftest.run_in_mesh_subprocess)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_in_mesh_subprocess
from repro.core import staging as jst
from repro.core.types import GFactors as JG, TFactors as JT
from repro.launch.serve import RaggedFGFTServeEngine as JaxRouter
from repro_torch.core import ApproxEigenbasis, laplacian
from repro_torch.core import staging as tst
from repro_torch.graphs import community_graph, directed_variant
from repro_torch.interop import basis_from_numpy
from repro_torch.kernels.plan import ApplyPlan, plan_cache_stats
from repro_torch.launch import service as tsvc
from repro_torch.launch.mesh import logical_devices, make_local_mesh
from repro_torch.launch.serve import FGFTServeEngine, RaggedFGFTServeEngine
from repro_torch.runtime.sharding import (BucketPlacement, FleetPlacement,
                                          fleet_placement,
                                          single_bucket_placement)

TIERS = {"full": 1.0, "balanced": 0.5, "draft": 0.25}
FILTERS = "heat,tikhonov"
B, N, G = 6, 16, 40
SIZES = [10, 16, 24, 24, 12, 30, 9, 24]


def _h(lam):
    return 1.0 / (1.0 + lam)


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _mesh(devices: int):
    with logical_devices(devices, "cpu"):
        return make_local_mesh(device="cpu")


def _laps(directed: bool = False, b: int = B, n: int = N):
    adjs = [community_graph(n, seed=s) for s in range(b)]
    if directed:
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    return np.stack([laplacian(a) for a in adjs])


def _fleet():
    return [laplacian(community_graph(s, seed=s)) for s in SIZES]


def _signals():
    return [np.random.default_rng(100 + i).normal(size=(2, s)).astype(
        np.float32) for i, s in enumerate(SIZES)]


@pytest.fixture(scope="module")
def bases():
    """Small port fits of both families (B = 5: 4 devices pad to 8)."""
    sym = ApproxEigenbasis.fit(_laps(b=5, n=12), 20, n_iter=1, device="cpu")
    gen = ApproxEigenbasis.fit(_laps(True, b=5, n=12), 12, n_iter=0,
                               kind="general", device="cpu")
    return {"sym": sym, "general": gen}


# ---------------------------------------------------------------------------
# pad_batch
# ---------------------------------------------------------------------------

def _jax_staged(basis, precision):
    """The JAX packer's tables of the port basis's factors."""
    f = {k: jnp.asarray(v.numpy()) for k, v in basis.factors._asdict().items()}
    if basis.kind == "sym":
        fwd, _ = jst.pack_g_batch_pair(JG(**f), basis.n)
    else:
        fwd, _ = jst.pack_t_batch_pair(JT(**f), basis.n)
    return jst.with_precision(fwd, precision)


@pytest.mark.parametrize("quantum", [1, 3, 8])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["sym", "general"])
def test_pad_batch_is_the_jax_tables(bases, family, precision, quantum):
    basis = bases[family]
    got = tst.pad_batch(tst.with_precision(basis.fwd, precision), quantum)
    want = jst.pad_batch(_jax_staged(basis, precision), quantum)
    b_pad = -(-5 // quantum) * quantum
    assert got.idx_i.shape[0] == b_pad and got.n == want.n
    np.testing.assert_array_equal(got.cuts, np.asarray(want.cuts))
    for g, w in zip(tst.table_arrays(got), jst.table_arrays(want)):
        w = np.asarray(w)
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(np.int16)
        assert g.numpy().tobytes() == w.tobytes()
    if quantum == 1:
        assert tst.pad_batch(basis.fwd, quantum) is basis.fwd
    with pytest.raises(ValueError, match="quantum must be >= 1"):
        tst.pad_batch(basis.fwd, 0)
    with pytest.raises(ValueError, match="expects batched"):
        tst.pad_batch(type(basis.fwd)(*(t[0] for t in basis.fwd[:-2]),
                                      basis.fwd.cuts, basis.n), 2)


# ---------------------------------------------------------------------------
# placed plans, fits and bases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["apply", "operator", "bank"])
@pytest.mark.parametrize("family", ["sym", "general"])
def test_placed_plan_is_bitwise_unplaced(bases, family, mode, precision):
    basis = bases[family]
    pl = single_bucket_placement(_mesh(4), 5)
    assert pl.batch_padded == 8
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 3, basis.n)).astype(np.float32))
    kw = dict(family=basis.kind, mode=mode, n=basis.n, batched=True,
              precision=precision, device="cpu")
    flat, placed = ApplyPlan(**kw), ApplyPlan(**kw, placement=pl)
    assert flat != placed and hash(placed) == hash(ApplyPlan(**kw,
                                                             placement=pl))
    if mode == "apply":
        for keep in ("head", "tail"):
            cut = basis.fwd.num_stages // 2
            a = ApplyPlan(**{**kw, "num_stages": cut, "keep": keep})
            b = ApplyPlan(**{**kw, "num_stages": cut, "keep": keep},
                          placement=pl)
            assert torch.equal(a.apply(basis.fwd, x), b.apply(basis.fwd, x))
        got, want = placed.apply(basis.bwd, x), flat.apply(basis.bwd, x)
    elif mode == "operator":
        got = placed.operator(basis.fwd, basis.bwd, basis.spectrum, x)
        want = flat.operator(basis.fwd, basis.bwd, basis.spectrum, x)
    else:
        gains = torch.stack([_h(basis.spectrum.abs()), basis.spectrum], 1)
        got = placed.bank(basis.fwd, basis.bwd, gains, x)
        want = flat.bank(basis.fwd, basis.bwd, gains, x)
    assert got.shape == want.shape and torch.equal(got, want)
    # the placed tables are kept beside the basis's: a second prepare
    # returns the same shards
    assert placed.prepare(basis.fwd)[1][0] is placed.prepare(basis.fwd)[1][0]
    assert len(placed.prepare(basis.fwd)) == 4


def test_pad_rows_are_the_identity_and_zero(bases):
    """A whole batch row of pad entries: ``apply`` gives its input back
    bitwise, the operator and the bank give exactly 0 on a zero
    spectrum/gain row."""
    for basis in bases.values():
        fwd = tst.pad_batch(basis.fwd, 8)
        bwd = tst.pad_batch(basis.bwd, 8)
        x = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (8, 3, basis.n)).astype(np.float32))
        kw = dict(family=basis.kind, n=basis.n, batched=True, device="cpu")
        y = ApplyPlan(mode="apply", **kw).apply(fwd, x)
        assert torch.equal(y[5:], x[5:])
        assert torch.equal(y[:5], ApplyPlan(mode="apply", **kw).apply(
            basis.fwd, x[:5]))
        spec = torch.cat([basis.spectrum, torch.zeros(3, basis.n)])
        y = ApplyPlan(mode="operator", **kw).operator(fwd, bwd, spec, x)
        assert torch.equal(y[5:], torch.zeros_like(y[5:]))
        gains = torch.stack([spec, spec], 1)
        y = ApplyPlan(mode="bank", **kw).bank(fwd, bwd, gains, x)
        assert torch.equal(y[5:], torch.zeros_like(y[5:]))


def test_unbatched_placed_plan_raises_as_jax():
    from repro.kernels.plan import ApplyPlan as JaxPlan
    from repro.runtime.sharding import BucketPlacement as JaxPlacement
    with pytest.raises(ValueError) as want:
        JaxPlan(family="sym", mode="apply", n=8,
                placement=JaxPlacement((0,), 1))
    with pytest.raises(ValueError) as got:
        ApplyPlan(family="sym", mode="apply", n=8, device="cpu",
                  placement=BucketPlacement((0,), 1))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("family", ["sym", "general"])
def test_fit_and_extend_on_a_mesh_equal_unplaced(bases, family):
    """Each batch shard fits on its own device; the factors, spectrum,
    objective and tables equal the unplaced fit's, bitwise."""
    directed = family == "general"
    laps = _laps(directed, b=8, n=12)
    kw = dict(n_iter=1 if family == "sym" else 0, kind=family, device="cpu")
    g = 20 if family == "sym" else 12
    flat = ApproxEigenbasis.fit(laps, g, **kw)
    for devices in (2, 4, 3):       # 3 does not divide 8: one device
        placed = ApproxEigenbasis.fit(laps, g, mesh=_mesh(devices), **kw)
        for a, b in zip(flat.factors + (flat.spectrum, flat.objective),
                        placed.factors + (placed.spectrum,
                                          placed.objective)):
            assert torch.equal(a, b)
        for a, b in zip(tst.table_arrays(flat.fwd),
                        tst.table_arrays(placed.fwd)):
            assert torch.equal(a, b)
    ext_flat = flat.extend(laps, g + 6)
    ext = flat.extend(laps, g + 6, mesh=_mesh(4))
    for a, b in zip(ext_flat.factors + (ext_flat.spectrum,),
                    ext.factors + (ext.spectrum,)):
        assert torch.equal(a, b)
    # shard(): apply/project through the mesh's devices, bitwise
    sharded = flat.shard(_mesh(4))
    assert sharded.placement.num_devices == 4
    assert flat.shard(_mesh(1)) is flat and flat.shard(_mesh(3)) is flat
    x = torch.randn(8, 3, 12)
    assert torch.equal(sharded.apply(x), flat.apply(x))
    assert torch.equal(sharded.apply(x, inverse=True),
                       flat.apply(x, inverse=True))
    assert torch.equal(sharded.project(x, _h), flat.project(x, _h))
    assert sharded.extend(laps, g + 6).placement == sharded.placement


# ---------------------------------------------------------------------------
# placed engines
# ---------------------------------------------------------------------------

def _steps(engine, x):
    out = {t: engine.step(x, _h, tier=t) for t in engine.tiers}
    out.update({f"{t}/plain": engine.step(x, tier=t) for t in engine.tiers})
    y, v = engine.step_versioned(x, _h, tier="draft")
    out["versioned"] = y
    out["bank"] = engine.step_bank(x)
    return out


@pytest.mark.parametrize("devices", [4, 8])
@pytest.mark.parametrize("family", ["sym", "general"])
def test_placed_engine_is_bitwise_unplaced(bases, family, devices):
    basis = bases[family]
    laps = _laps(family == "general", b=5, n=12)
    flat = FGFTServeEngine(laps, basis=basis, tiers=TIERS, filters=FILTERS,
                           device="cpu")
    pl = single_bucket_placement(_mesh(devices), 5)
    placed = FGFTServeEngine(laps, basis=basis, tiers=TIERS,
                             filters=FILTERS, placement=pl, device="cpu")
    assert placed.placement is pl and placed.device == torch.device("cpu")
    # never more devices than graphs: 8 devices give 5 shards of one
    assert len(placed._live.fwd) == min(devices, 5) == pl.num_devices
    assert placed.mesh.device_ids.tolist() == list(pl.device_ids)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (5, 3, 12)).astype(np.float32))
    want, got = _steps(flat, x), _steps(placed, x)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key


def test_ragged_bucket_engine_masks_pad_coordinates_placed():
    """A masked bucket (sizes < n) placed: h(0) = 1 on pad coordinates
    must stay masked in every shard, pad rows included."""
    fleet = [laplacian(community_graph(s, seed=s)) for s in (9, 12, 16)]
    basis = ApproxEigenbasis.fit(fleet, 20, n_iter=1, device="cpu")
    stack = np.zeros((3, 16, 16), np.float32)
    for i, m in enumerate(fleet):
        stack[i, :m.shape[0], :m.shape[0]] = m
    flat = FGFTServeEngine(stack, basis=basis, tiers=TIERS, filters=FILTERS,
                           device="cpu")
    placed = FGFTServeEngine(stack, basis=basis, tiers=TIERS,
                             filters=FILTERS, device="cpu",
                             placement=single_bucket_placement(_mesh(2), 3))
    x = torch.randn(3, 2, 16)
    for t in TIERS:
        assert torch.equal(placed.step(x, lambda lam: torch.exp(-lam),
                                       tier=t),
                           flat.step(x, lambda lam: torch.exp(-lam), tier=t))
    assert torch.equal(placed.step_bank(x), flat.step_bank(x))


def test_placed_engine_saves_its_placement_and_reloads(bases, tmp_path):
    from repro_torch.checkpoint import read_metadata
    laps = _laps(b=5, n=12)
    pl = single_bucket_placement(_mesh(4), 5)
    placed = FGFTServeEngine(laps, basis=bases["sym"], tiers=TIERS,
                             placement=pl, device="cpu")
    placed.save(tmp_path, step=2)
    meta = read_metadata(tmp_path)
    assert meta["serve"]["placement"] == {"device_ids": [0, 1, 2, 3],
                                          "batch": 5}
    assert len(list(tmp_path.rglob("leaves_*.npz"))) == 4
    x = torch.randn(5, 2, 12)
    for devices in (1, 8):
        back = FGFTServeEngine.load(
            tmp_path, placement=single_bucket_placement(_mesh(devices), 5),
            device="cpu")
        assert torch.equal(back.step(x, _h), placed.step(x, _h))
    with pytest.raises(ValueError, match="placement.batch=4 != fleet "
                       "batch 5"):
        FGFTServeEngine.load(tmp_path, device="cpu",
                             placement=single_bucket_placement(_mesh(2), 4))


def _forced(engine, action: str):
    """One maintain tick under thresholds that make ``action`` the
    controller's choice at the engine's current drift."""
    from dataclasses import replace
    pol = engine.controller.policy
    engine.controller.policy = replace(pol, refresh=1e9, extend=1e9,
                                       refit=1e9)
    assert engine.maintain()["action"] == "reuse"
    d = float(engine.drift().max())
    mult = {"refresh": (0.1, 1e6, 2e6), "extend": (0.01, 0.1, 1e6),
            "refit": (0.001, 0.01, 0.1)}[action]
    engine.controller.policy = replace(
        pol, **dict(zip(("refresh", "extend", "refit"),
                        (m * d for m in mult))))
    return engine.maintain()


@pytest.mark.parametrize("family", ["sym", "general"])
def test_placed_dynamic_engine_ticks_as_unplaced(family):
    """A placed dynamic engine matches the unplaced one tick for tick:
    the same drift, actions, versions and served answers after each
    swap; a spectrum refresh is a plan-cache hit with the placed tables
    kept (no new program, no new shards)."""
    directed = family == "general"
    laps = _laps(directed, b=6, n=12)
    kw = dict(n_iter=1 if family == "sym" else 0, tiers=TIERS,
              filters=FILTERS, dynamic=True, kind=family, device="cpu")
    g = 20 if family == "sym" else 12
    flat = FGFTServeEngine(laps, g, **kw)
    placed = FGFTServeEngine(laps, g, placement=single_bucket_placement(
        _mesh(4), 6), **kw)
    x = torch.randn(6, 2, 12)
    assert torch.equal(placed.step(x, _h), flat.step(x, _h))
    rng = np.random.default_rng(9)
    actions = ["refresh", "extend", "refit"] if family == "sym" else [
        "extend", "refit"]
    for rnd, action in enumerate(actions):
        delta = rng.standard_normal((12, 12)).astype(np.float32) * 0.05
        delta = delta + delta.T
        for eng in (flat, placed):
            eng.apply_updates(rnd % 6, delta)
        assert np.array_equal(flat.drift(), placed.drift())
        misses = plan_cache_stats()["misses"]
        shards = placed._live.fwd[0][0]
        res_f, res_p = _forced(flat, action), _forced(placed, action)
        assert res_f["action"] == res_p["action"] == action
        assert np.array_equal(res_f["versions"], res_p["versions"])
        assert np.array_equal(res_f["post_drift"], res_p["post_drift"])
        if action == "refresh":
            assert plan_cache_stats()["misses"] == misses
            assert placed._live.fwd[0][0] is shards
        for key, y in _steps(flat, x).items():
            assert torch.equal(_steps(placed, x)[key], y), (action, key)


# ---------------------------------------------------------------------------
# routers, checkpoints both ways, the service
# ---------------------------------------------------------------------------

def test_placed_router_is_bitwise_unplaced():
    fleet = _fleet()
    flat = RaggedFGFTServeEngine(fleet, n_iter=1, tiers=TIERS,
                                 filters=FILTERS, device="cpu")
    placed = RaggedFGFTServeEngine(fleet, n_iter=1, tiers=TIERS,
                                   filters=FILTERS, mesh=_mesh(8),
                                   placement="auto", device="cpu")
    man = placed.placement.manifest()
    assert man["num_devices"] == 8
    owned = [i for b in man["buckets"].values() for i in b["device_ids"]]
    assert sorted(owned) == list(range(8))        # disjoint, all used
    for w, eng in placed.engines.items():
        assert eng.placement is placed.placement[w]
    sig = _signals()
    for t in TIERS:
        for a, b in zip(placed.step(sig, _h, tier=t),
                        flat.step(sig, _h, tier=t)):
            assert torch.equal(a, b)
    for a, b in zip(placed.step_bank(sig), flat.step_bank(sig)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="has no entry for bucket"):
        RaggedFGFTServeEngine(fleet, n_iter=0, device="cpu",
                              placement=FleetPlacement({}, 8))
    with pytest.raises(ValueError, match="sized for batch"):
        RaggedFGFTServeEngine(fleet, n_iter=0, device="cpu",
                              placement=fleet_placement(
                                  _mesh(4), {16: 1, 32: 4}))
    with pytest.raises(TypeError, match="FleetPlacement"):
        RaggedFGFTServeEngine(fleet, n_iter=0, device="cpu", placement=3)


def test_placed_router_dirty_tick_touches_only_the_dirty_bucket():
    """The port's counterpart of tests/test_fleet_mesh.py::
    test_overlapped_maintenance_touches_only_dirty_bucket: a dirty
    bucket's tick bumps only its own engine's version, on its own
    devices; the service of a placed router ticks dirty-only and carries
    the manifest in its snapshot."""
    router = RaggedFGFTServeEngine(_fleet(), n_iter=1, mesh=_mesh(8),
                                   placement="auto", dynamic=True,
                                   device="cpu")
    before = {w: e._live.version for w, e in router.engines.items()}
    assert router.maintain(dirty_only=True) == {}
    dirty = 2
    w_dirty = router.widths[dirty]
    router.apply_updates(dirty, np.eye(SIZES[dirty], dtype=np.float32)
                         * 0.05)
    assert sorted(router.maintain(dirty_only=True)) == [w_dirty]
    after = {w: e._live.version for w, e in router.engines.items()}
    for w, v0 in before.items():
        assert after[w] >= v0 if w == w_dirty else after[w] == v0
    eng = router.engines[w_dirty]
    assert sorted(eng.mesh.device_ids.tolist()) == sorted(
        router.placement[w_dirty].device_ids)
    router.apply_updates(dirty, np.eye(SIZES[dirty], dtype=np.float32)
                         * 0.05)
    with tsvc.AsyncFGFTService(router, auto_start=False) as svc:
        assert svc.maintain_stream is None and svc.maintain_streams == {}
        assert sorted(svc.maintain_now()) == [w_dirty]
        assert svc.stats()["placement"] == router.placement.manifest()
    engine = FGFTServeEngine(_laps(b=5, n=12), 20, n_iter=0, device="cpu",
                             placement=single_bucket_placement(_mesh(2), 5))
    with tsvc.AsyncFGFTService(engine, auto_start=False) as svc:
        fut = svc.submit(3, np.ones((2, 12), np.float32), tier="full")
        svc.drain_once()
        want = engine.step(torch.from_numpy(np.pad(
            np.ones((2, 12), np.float32)[None], ((3, 1), (0, 6), (0, 0)))),
            tier="full")[3, :2]
        assert np.array_equal(fut.result(timeout=5).y, want.numpy())
        assert svc.stats()["placement"] == {"device_ids": [0, 1],
                                            "batch": 5}


_JAX_SAVE = """
    import json, pathlib
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.core.fgft import laplacian
    from repro.graphs import community_graph
    from repro.launch.mesh import make_local_mesh
    from repro.launch.serve import FGFTServeEngine, RaggedFGFTServeEngine
    from repro.runtime.sharding import single_bucket_placement
    OUT = pathlib.Path(%r)
    TIERS, FILTERS, B, N, G, SIZES = %r, %r, %d, %d, %d, %r
    h = lambda lam: 1.0 / (1.0 + lam)
    mesh = make_local_mesh()
    laps = np.stack([np.asarray(laplacian(community_graph(N, seed=s)))
                     for s in range(B)])
    eng = FGFTServeEngine(jnp.asarray(laps), G, n_iter=1, mesh=mesh,
                          tiers=TIERS, filters=FILTERS,
                          placement=single_bucket_placement(mesh, B))
    x = np.random.default_rng(7).standard_normal((B, 3, N)).astype(
        np.float32)
    outs = {t: np.asarray(eng.step(jnp.asarray(x), h, tier=t))
            for t in TIERS}
    outs["bank"] = np.asarray(eng.step_bank(jnp.asarray(x)))
    b = eng.basis
    np.savez(OUT / "engine.npz", x=x, laps=laps,
             spectrum=np.asarray(b.spectrum),
             objective=np.asarray(b.objective),
             **{"f_" + k: np.asarray(v)
                for k, v in b.factors._asdict().items()},
             **{"y_" + k: v for k, v in outs.items()})
    fleet = [np.asarray(laplacian(community_graph(s, seed=s)))
             for s in SIZES]
    r = RaggedFGFTServeEngine(fleet, n_iter=1, mesh=mesh, placement="auto")
    r.save(OUT / "jax_router", step=3)
    print(json.dumps({"devices": len(jax.devices()),
                      "placement": r.placement.manifest(),
                      "padded": eng.placement.batch_padded}))
"""


@pytest.fixture(scope="module")
def jax_placed(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_placed")
    res = run_in_mesh_subprocess(_JAX_SAVE % (
        str(out), TIERS, FILTERS, B, N, G, SIZES), devices=4)
    assert res["devices"] == 4 and res["padded"] == 8
    return out, res


def test_placed_engine_matches_the_jax_placed_engine(jax_placed):
    out, _ = jax_placed
    z = np.load(out / "engine.npz")
    factors = {k[2:]: z[k] for k in z.files if k.startswith("f_")}
    basis = basis_from_numpy("sym", N, factors, z["spectrum"],
                             objective=z["objective"], device="cpu")
    placed = FGFTServeEngine(z["laps"], basis=basis, tiers=TIERS,
                             filters=FILTERS, device="cpu",
                             placement=single_bucket_placement(_mesh(4), B))
    flat = FGFTServeEngine(z["laps"], basis=basis, tiers=TIERS,
                           filters=FILTERS, device="cpu")
    x = torch.from_numpy(z["x"])
    for t in TIERS:
        y = placed.step(x, _h, tier=t)
        assert torch.equal(y, flat.step(x, _h, tier=t))
        _close(y.numpy(), z["y_" + t])
    yb = placed.step_bank(x)
    assert torch.equal(yb, flat.step_bank(x))
    _close(yb.numpy(), z["y_bank"])


@pytest.mark.parametrize("devices", [1, 8])
def test_jax_placed_router_loads_replaced_in_port(jax_placed, devices):
    """JAX saved on 4 devices; the port re-places onto 1 or 8 logical
    devices and serves bitwise its own unplaced load of the same
    checkpoint, within the tolerance of the JAX router's answers."""
    out, res = jax_placed
    ckpt = out / "jax_router"
    assert json.loads((ckpt / "placement.json").read_text()) == \
        res["placement"]
    if devices == 1:
        placed = RaggedFGFTServeEngine.load(ckpt, device="cpu")
    else:
        with logical_devices(devices, "cpu"):
            placed = RaggedFGFTServeEngine.load(ckpt, device="cpu")
    flat = RaggedFGFTServeEngine.load(ckpt, placement=False, device="cpu")
    assert flat.placement is None
    assert placed.placement.num_devices == devices
    jr = JaxRouter.load(ckpt, placement=False)
    sig = _signals()
    for a, b, c in zip(placed.step(sig, _h), flat.step(sig, _h),
                       jr.step(sig, _h)):
        assert torch.equal(a, b)
        _close(a.numpy(), c)


_JAX_LOAD = """
    import json, pathlib
    import numpy as np
    import jax
    from repro.launch.serve import RaggedFGFTServeEngine
    CKPT, SIZES = pathlib.Path(%r), %r
    h = lambda lam: 1.0 / (1.0 + lam)
    r = RaggedFGFTServeEngine.load(CKPT)
    sig = [np.random.default_rng(100 + i).normal(size=(2, s)).astype(
        np.float32) for i, s in enumerate(SIZES)]
    for i, y in enumerate(r.step(sig, h)):
        np.save(CKPT / f"jax8_{i}.npy", np.asarray(y))
    print(json.dumps({"devices": len(jax.devices()),
                      "placement": r.placement.manifest()}))
"""


@pytest.fixture(scope="module")
def port_placed_ckpt(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("port_placed") / "router"
    router = RaggedFGFTServeEngine(_fleet(), n_iter=1, mesh=_mesh(4),
                                   placement="auto", device="cpu")
    router.save(ckpt, step=5)
    return ckpt, router


@pytest.mark.parametrize("devices", [1, 8])
def test_port_placed_router_loads_replaced_in_jax(port_placed_ckpt,
                                                  devices):
    ckpt, router = port_placed_ckpt
    manifest = json.loads((ckpt / "placement.json").read_text())
    assert manifest == router.placement.manifest()
    assert not (ckpt / "placement.json.tmp").exists()
    sig = _signals()
    want = router.step(sig, _h)
    if devices == 1:                  # this process's one JAX device
        jr = JaxRouter.load(ckpt)
        assert jr.placement.manifest()["num_devices"] == 1
        got = jr.step(sig, _h)
    else:
        res = run_in_mesh_subprocess(_JAX_LOAD % (str(ckpt), SIZES),
                                     devices=8)
        assert res["devices"] == 8
        assert res["placement"]["num_devices"] == 8
        got = [np.load(ckpt / f"jax8_{i}.npy") for i in range(len(SIZES))]
    for a, b in zip(want, got):
        _close(a.numpy(), b)
