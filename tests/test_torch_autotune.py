"""The port's tile autotuner (``repro_torch.kernels.autotune``) and the
``block_b`` dial it tunes, on the CPU.

The JAX package's autotune cases (tests/test_plan.py) run on the port.
The cache is the JAX module's, byte for byte, for the same records.  The
dial: ``block_b=None`` gives exactly the geometry the launcher chose
before the dial existed (a copy of those functions is kept here and
held to the launcher on a grid of shapes and cards), and a cap is
honoured by a valid geometry.  A plan resolves ``block_b=None`` through
the cache when its program is built (the staleness rule), the torch
backend ignores the dial, and ``autotune_block_b`` records its choice,
its counter and its span (timed by a stand-in)."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package loads core before kernels)
from repro.kernels import autotune as jat
from repro.kernels.plan import ApplyPlan as JaxPlan
from repro_torch import obs
from repro_torch.core import staging as tst
from repro_torch.core.types import GFactors, TFactors
from repro_torch.kernels import autotune, launcher, plan as tplan
from repro_torch.kernels import butterfly as bf
from repro_torch.kernels import shear as sh
from repro_torch.kernels import spectral as ksp
from repro_torch.kernels.plan import ApplyPlan, clear_plan_cache

#: H100 SXM: shared memory per block (opt-in), per SM, SMs
H100 = (232448, 233472, 132)


@pytest.fixture(autouse=True)
def _fresh_plans():
    clear_plan_cache()
    yield
    clear_plan_cache()


# -- the JAX package's cases, on the port ---------------------------------

def test_autotune_cache_roundtrip(tmp_path):
    path = tmp_path / "autotune.json"
    plan = ApplyPlan(family="sym", mode="operator", n=32, batched=True,
                     device="cpu")
    assert autotune.cached_block_b(plan, path) is None
    autotune.record(autotune.plan_key(plan), path=path, source="prior",
                    block_b=64)
    assert autotune.cached_block_b(plan, path) == 64
    # a measurement overwrites a prior...
    autotune.record(autotune.plan_key(plan), path=path,
                    source="measured", block_b=128)
    assert autotune.cached_block_b(plan, path) == 128
    # ...but a later prior never clobbers the measurement
    autotune.record(autotune.plan_key(plan), path=path, source="prior",
                    block_b=32)
    assert autotune.cached_block_b(plan, path) == 128
    autotune.record(autotune.chunk_key("sym", 32), path=path,
                    source="prior", num_chunks=4)
    assert autotune.cached_num_chunks("sym", 32, path=path) == 4
    assert autotune.cached_num_chunks("general", 64, default=2,
                                      path=path) == 2


def test_autotune_corrupt_cache_is_fresh(tmp_path):
    path = tmp_path / "autotune.json"
    path.write_text("{not json")
    cache = autotune.load_cache(path)
    assert cache == {"version": autotune.CACHE_VERSION, "entries": {}}
    path.write_text('{"version": 99, "entries": {"k": {}}}')
    assert autotune.load_cache(path)["entries"] == {}


def test_prior_block_b_shrinks_with_working_set():
    small = autotune.prior_block_b(16, 8, smem_block=H100[0])
    big = autotune.prior_block_b(4096, 2048, smem_block=H100[0])
    assert small == max(autotune.BLOCK_B_CANDIDATES)
    assert big <= small
    assert small in autotune.BLOCK_B_CANDIDATES
    assert big in autotune.BLOCK_B_CANDIDATES
    # the bank's ring grows with the stage width
    wide = autotune.prior_block_b(256, 4096, mode="bank",
                                  smem_block=H100[0])
    narrow = autotune.prior_block_b(256, 8, mode="bank", smem_block=H100[0])
    assert wide <= narrow
    # each pick fits and the next candidate up would not
    for n in (64, 256, 1024):
        got = autotune.prior_block_b(n, 128, smem_block=H100[0])
        ring = -(-got // 32) * launcher.operator_ring_bytes("g")
        assert got * ((n + 1) | 1) * 4 + ring <= H100[0]


# -- the cache against the JAX module's ------------------------------------

@pytest.mark.parametrize("family", ["sym", "general"])
@pytest.mark.parametrize("mode", ["apply", "operator", "bank"])
@pytest.mark.parametrize("batched", [False, True])
def test_plan_key_matches_jax(family, mode, batched):
    plan = ApplyPlan(family=family, mode=mode, n=48, batched=batched,
                     device="cpu")
    jplan = JaxPlan(family=family, mode=mode, n=48, batched=batched)
    assert autotune.plan_key(plan) == jat.plan_key(jplan)
    assert autotune.chunk_key(family, 48) == jat.chunk_key(family, 48)


def test_cache_file_bytes_match_jax(tmp_path):
    records = [("sym/operator/batched/n256", "prior", {"block_b": 128}),
               ("sym/operator/batched/n256", "measured",
                {"block_b": 64, "timings_us": {"32": 12.5, "64": 9.25}}),
               ("sym/operator/batched/n256", "prior", {"block_b": 32}),
               ("chunks/general/n64", "prior",
                {"num_chunks": 4, "depth_overhead": {"1": 0.0}}),
               ("sym/bank/single/n16", "measured", {"block_b": 32})]
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    for key, source, fields in records:
        got = autotune.record(key, path=ours, source=source, **fields)
        want = jat.record(key, path=theirs, source=source, **fields)
        assert got == want
    assert ours.read_bytes() == theirs.read_bytes()
    assert autotune.load_cache(ours) == jat.load_cache(theirs)
    assert autotune.cached_num_chunks("general", 64, path=ours) == \
        jat.cached_num_chunks("general", 64, path=theirs) == 4


def test_cache_path_is_the_ports_own(tmp_path, monkeypatch):
    assert autotune.CACHE_ENV != jat.CACHE_ENV
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.setenv(jat.CACHE_ENV, str(tmp_path / "jax.json"))
    assert autotune.cache_path().name == "autotune.json"
    assert "repro_torch" in autotune.cache_path().parts
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "port.json"))
    assert autotune.cache_path() == tmp_path / "port.json"


# -- the geometry cap -------------------------------------------------------

def _parent_operator_geometry(batch, rows, n, ring_bytes, smem_block,
                              smem_sm, sms):
    """launcher.operator_geometry as it was before the tile dial."""
    row_bytes = ((n + 1) | 1) * 4
    fit = (smem_block - 16 - ring_bytes) // row_bytes
    for lanes in launcher.OPERATOR_LANES:
        per_warp = min(32 // lanes, rows, fit)
        warps_per_matrix = -(-rows // per_warp)
        if batch * warps_per_matrix >= 2 * sms:
            break

    def smem(warps):
        rows_bytes = -(-warps * per_warp * row_bytes // 16) * 16
        return rows_bytes + warps * ring_bytes

    best, best_key = None, None
    for warps in range(1, min(8, warps_per_matrix) + 1):
        if smem(warps) > smem_block:
            break
        tiles = -(-warps_per_matrix // warps)
        key = (-(-(batch * tiles) // sms) * warps, -warps)
        if best_key is None or key < best_key:
            best_key, best = key, (warps, tiles)
    warps, tiles = best
    resident = min(smem_sm // (smem(warps) + 1024), 64 // warps, 32)
    return (lanes, per_warp, warps, tiles, smem(warps), resident)


def _parent_bank_geometry(batch, rows, n, filters, ring_bytes, smem_block,
                          smem_sm, sms):
    """launcher.bank_geometry as it was before the tile dial."""
    ld = (n + 1) | 1
    per_cta = min(smem_block, smem_sm // 3 - 1024) - ring_bytes
    max_rows = 4 * (per_cta // 16) // ld if per_cta > 0 else 0
    target = 2 * sms
    best, best_key = None, None
    for groups in range(1, filters + 1):
        fg = -(-filters // groups)
        if -(-filters // fg) != groups:
            continue
        rmax = min(rows, max_rows // fg)
        if rmax < 1:
            continue
        want = -(-target // (batch * groups))
        r = rmax if want <= 1 else max(1, min(rmax,
                                              -(-rows // (want - 1)) - 1))
        tiles = -(-rows // r)
        r = -(-rows // tiles)
        key = (min(batch * groups * tiles, target), -groups, r)
        if best_key is None or key > best_key:
            best_key, best = key, (r, fg, tiles, groups)
    r, fg, tiles, groups = best
    smem = -(-r * fg * ld // 4) * 16 + ring_bytes
    return (r, fg, tiles, groups, smem, smem_sm // (smem + 1024))


CARDS = [H100, (101376, 102400, 84), (49152, 65536, 8)]
GRID = list(itertools.product((1, 2, 7, 64, 300), (1, 8, 130, 256, 4096),
                              (16, 48, 256, 1024)))


@pytest.mark.parametrize("card", CARDS, ids=lambda c: f"smem{c[0]}")
def test_no_cap_is_the_parent_geometry(card):
    for batch, rows, n in GRID:
        for fam, prec in (("g", "f32"), ("t", "f32"), ("g", "bf16")):
            ring = launcher.operator_ring_bytes(fam, prec)
            if (card[0] - 16 - ring) // (((n + 1) | 1) * 4) < 1:
                continue
            want = _parent_operator_geometry(batch, rows, n, ring, *card)
            assert tuple(launcher.operator_geometry(
                batch, rows, n, ring, *card)) == want
            assert tuple(launcher.operator_geometry(
                batch, rows, n, ring, *card, None)) == want
        for filters, slots in ((1, 8), (7, 128), (33, 128)):
            ring = launcher.bank_ring_bytes(slots, "g")
            try:
                want = _parent_bank_geometry(batch, rows, n, filters, ring,
                                             *card)
            except TypeError:            # too wide: the launcher raises
                with pytest.raises(ValueError, match="too wide"):
                    launcher.bank_geometry(batch, rows, n, filters, ring,
                                           *card)
                continue
            assert tuple(launcher.bank_geometry(
                batch, rows, n, filters, ring, *card)) == want


@pytest.mark.parametrize("cap", [1, 3, 8, 32, 64, 128, 256])
def test_cap_is_honoured(cap):
    for batch, rows, n in GRID:
        ring = launcher.operator_ring_bytes("g")
        geo = launcher.operator_geometry(batch, rows, n, ring, *H100, cap)
        assert geo.warps * geo.rows_per_warp <= cap
        assert geo.lanes in launcher.OPERATOR_LANES
        assert geo.rows_per_warp * geo.lanes <= 32
        assert 1 <= geo.warps <= 8 and geo.smem <= H100[0]
        assert geo.row_tiles * geo.warps * geo.rows_per_warp >= rows
        free = launcher.operator_geometry(batch, rows, n, ring, *H100)
        if free.warps * free.rows_per_warp <= cap:
            assert geo == free            # a cap above the tile is moot
        for filters in (1, 7, 33):
            bring = launcher.bank_ring_bytes(128, "g")
            if n == 1024 and filters > 1:
                continue
            bg = launcher.bank_geometry(batch, rows, n, filters, bring,
                                        *H100, cap)
            assert 1 <= bg.rows <= cap
            assert bg.row_tiles * bg.rows >= rows
            assert bg.groups * bg.filters >= filters
            assert bg.resident >= 3


@pytest.mark.parametrize("bad", [0, -4])
def test_geometry_rejects_a_bad_cap(bad):
    with pytest.raises(ValueError, match="block_b must be positive"):
        launcher.operator_geometry(1, 8, 16, 1024, *H100, bad)
    with pytest.raises(ValueError, match="block_b must be positive"):
        launcher.bank_geometry(1, 8, 16, 1, 1024, *H100, bad)


# -- the 12 entry points take block_b ---------------------------------------

def _g_tables(n, batch, g, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, (batch, g))
    b = (a + rng.integers(1, n, (batch, g))) % n
    th = rng.uniform(-np.pi, np.pi, (batch, g))
    f = GFactors(np.minimum(a, b).astype(np.int32),
                 np.maximum(a, b).astype(np.int32),
                 np.cos(th).astype(np.float32), np.sin(th).astype(np.float32),
                 rng.choice([-1.0, 1.0], (batch, g)).astype(np.float32))
    return (tst.pack_g_batch_pair(f, n, device="cpu"),
            tst.pack_g_pair(GFactors(*(t[0] for t in f)), n=n, device="cpu"))


def _t_tables(n, batch, m, seed=1):
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 2, (batch, m)).astype(np.int32)
    i = rng.integers(0, n, (batch, m))
    j = np.where(kind == 1, (i + rng.integers(1, n, (batch, m))) % n, i)
    a = np.where(kind == 1, rng.uniform(-0.5, 0.5, (batch, m)),
                 rng.uniform(0.5, 1.5, (batch, m))).astype(np.float32)
    f = TFactors(kind, i.astype(np.int32), j.astype(np.int32), a)
    return (tst.pack_t_batch_pair(f, n, device="cpu"),
            tst.pack_t_pair(TFactors(*(t[0] for t in f)), n, device="cpu"))


def _entry_calls(n=16, batch=2, rows=5):
    """(name, fn, args) of each of the 12 entry points on CPU tensors."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((batch, rows, n), generator=gen)
    d = torch.rand((batch, n), generator=gen)
    gains = torch.rand((batch, 3, n), generator=gen)
    (gf, ga), (sgf, sga) = _g_tables(n, batch, 40)
    (tf, ti), (stf, sti) = _t_tables(n, batch, 40)
    return [
        ("batched_butterfly_apply", bf.batched_butterfly_apply, (gf, x)),
        ("butterfly_apply", bf.butterfly_apply, (sgf, x[0])),
        ("batched_sym_operator_apply", bf.batched_sym_operator_apply,
         (gf, ga, d, x)),
        ("sym_operator_apply", bf.sym_operator_apply, (sgf, sga, d[0], x[0])),
        ("batched_shear_apply", sh.batched_shear_apply, (tf, x)),
        ("shear_apply", sh.shear_apply, (stf, x[0])),
        ("batched_gen_operator_apply", sh.batched_gen_operator_apply,
         (tf, ti, d, x)),
        ("gen_operator_apply", sh.gen_operator_apply, (stf, sti, d[0], x[0])),
        ("batched_sym_filter_bank_apply", ksp.batched_sym_filter_bank_apply,
         (gf, ga, gains, x)),
        ("sym_filter_bank_apply", ksp.sym_filter_bank_apply,
         (sgf, sga, gains[0], x[0])),
        ("batched_gen_filter_bank_apply", ksp.batched_gen_filter_bank_apply,
         (tf, ti, gains, x)),
        ("gen_filter_bank_apply", ksp.gen_filter_bank_apply,
         (stf, sti, gains[0], x[0])),
    ]


def test_entry_points_take_block_b():
    calls = _entry_calls()
    assert sorted(name for name, _, _ in calls) == sorted(launcher.ENTRIES)
    for name, fn, args in calls:
        want = fn(*args)
        for bb in (1, 64):
            assert torch.equal(fn(*args, block_b=bb), want), name
        with pytest.raises(ValueError, match="block_b must be positive"):
            fn(*args, block_b=0)


# -- plan resolution --------------------------------------------------------

@pytest.fixture
def spy(monkeypatch):
    """The block_b each built "cuda" sym operator program passes on."""
    seen = []

    def entry(fwd, bwd, d, x, cut, block_b=None):
        seen.append(block_b)
        return tplan._ENTRY[("sym", "operator", "torch", False)](
            fwd, bwd, d, x, cut)
    monkeypatch.setitem(tplan._ENTRY, ("sym", "operator", "cuda", False),
                        entry)
    return seen


def test_plan_block_b_validation():
    for bad in (0, -1):
        with pytest.raises(ValueError, match="block_b must be positive"):
            ApplyPlan(family="sym", mode="apply", n=8, device="cpu",
                      block_b=bad)
    plan = ApplyPlan(family="general", mode="bank", n=8, device="cpu",
                     block_b=64)
    assert plan.block_b == 64 and plan != dataclasses.replace(plan,
                                                              block_b=32)


def test_plan_resolves_persisted_block_b(tmp_path, monkeypatch, spy):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    (fwd, adj), _ = _g_tables(8, 1, 20)
    fwd1, adj1 = (tst.StagedG(*(t[0] for t in tst.table_arrays(s)), s.cuts,
                              s.n) for s in (fwd, adj))
    d, x = torch.ones(8), torch.randn((3, 8))
    plan = ApplyPlan(family="sym", mode="operator", n=8, device="cpu",
                     backend="cuda")
    assert plan._resolved_block_b() is None          # the launcher's own
    y = plan.operator(fwd1, adj1, d, x)
    autotune.record(autotune.plan_key(plan), source="measured", block_b=32)
    assert plan._resolved_block_b() == 32
    # staleness: the program built before the record keeps its tile ...
    assert torch.equal(plan.operator(fwd1, adj1, d, x), y)
    assert spy == [None, None]
    # ... until the plan cache is cleared
    clear_plan_cache()
    assert torch.equal(plan.operator(fwd1, adj1, d, x), y)
    assert spy[-1] == 32
    # an explicit block_b always wins
    assert dataclasses.replace(plan, block_b=8)._resolved_block_b() == 8
    dataclasses.replace(plan, block_b=8).operator(fwd1, adj1, d, x)
    assert spy[-1] == 8


def test_torch_backend_ignores_block_b(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "a.json"))
    seen = []

    def entry(*args):
        seen.append(len(args))
        return x
    monkeypatch.setitem(tplan._ENTRY, ("sym", "apply", "torch", False),
                        entry)
    (fwd, _), _ = _g_tables(8, 1, 20)
    x = torch.randn((3, 8))
    for bb in (None, 16):
        ApplyPlan(family="sym", mode="apply", n=8, device="cpu",
                  block_b=bb).program()(tst.table_arrays(fwd), x)
    assert seen == [4, 4]       # (staged, x, num_stages, keep): no block_b
    assert not (tmp_path / "a.json").exists()


# -- autotune_block_b -------------------------------------------------------

def test_autotune_block_b_with_a_stand_in_timer(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    timed = []
    times = iter([3e-6, 1e-6, 2e-6])

    def stand_in(fn, args, repeats=5, warmup=2):
        timed.append(fn(*args))
        return next(times)
    monkeypatch.setattr(autotune, "_median_time", stand_in)
    (fwd, adj), _ = _g_tables(16, 2, 40)
    plan = ApplyPlan(family="sym", mode="operator", n=16, batched=True,
                     device="cpu", backend="cuda")
    x = torch.randn((2, 100, 16))
    d = torch.rand((2, 16))
    counter = obs.counter("autotune_measurements_total")
    before = counter.value()
    tracer = obs.default_tracer()
    spans_before = len(tracer.spans(name="autotune_measure"))
    best = autotune.autotune_block_b(
        plan, (plan.prepare(fwd), plan.prepare(adj), d, x),
        candidates=(128, 32, 64, 256), path=path)
    # 100 rows cap the candidates at 64: the grid is (32, 64), the
    # stand-in's second time is the least
    assert best == 64
    assert len(timed) == 2 and torch.equal(timed[0], timed[1])
    entry = autotune.load_cache(path)["entries"][autotune.plan_key(plan)]
    assert entry == {"source": "measured", "block_b": 64,
                     "timings_us": {"32": 3.0, "64": 1.0}}
    assert counter.value() == before + 1
    spans = tracer.spans(name="autotune_measure")
    assert len(spans) == spans_before + 1
    assert spans[-1]["args"]["key"] == "sym/operator/batched/n16"
    assert spans[-1]["args"]["block_b"] == 64


def test_autotune_measured_pass(tmp_path):
    """The real timer (perf_counter on the CPU), as the JAX package's
    case runs it in interpret mode."""
    path = tmp_path / "autotune.json"
    (_, _), (fwd, adj) = _g_tables(16, 1, 32)
    plan = ApplyPlan(family="sym", mode="operator", n=16, device="cpu",
                     backend="cuda")
    d = torch.rand(16)
    x = torch.randn((32, 16))
    best = autotune.autotune_block_b(
        plan, (plan.prepare(fwd), plan.prepare(adj), d, x),
        candidates=(8, 16), repeats=1, path=path)
    assert best in (8, 16)
    entry = autotune.load_cache(path)["entries"][autotune.plan_key(plan)]
    assert entry["source"] == "measured"
    assert set(entry["timings_us"]) == {"8", "16"}
