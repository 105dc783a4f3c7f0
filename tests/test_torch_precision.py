"""bf16 table storage in the port against the JAX package's precision
policy.  ``with_precision`` casts the same bits; port plans at
``precision="bf16"`` (backend "torch") agree with JAX plans at "bf16"
(backends "xla" and "pallas", the latter in interpret mode as the JAX
tests run it) on carried tables within 2e-5, the bound the JAX package
holds between its own backends (tests/test_plan.py); the JAX package's
bf16 gates hold against the port's own f32 path; engines, routers and
checkpoints run at bf16 across the packages; the CLI serves
``--precision bf16``; the launcher's bf16 stream and its caches are
right on CPU tensors."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ApproxEigenbasis as JaxBasis
from repro.core import approximate_general, approximate_symmetric
from repro.core import staging as jst
from repro.kernels.plan import ApplyPlan as JaxPlan
from repro.launch.serve import FGFTServeEngine as JaxEngine
from repro.launch.serve import RaggedFGFTServeEngine as JaxRouter
from repro_torch.core import ApproxEigenbasis, laplacian, pad_ragged
from repro_torch.core import staging
from repro_torch.core.staging import StagedG, StagedT, table_arrays
from repro_torch.graphs import community_graph, directed_variant
from repro_torch.interop import basis_from_numpy
from repro_torch.kernels import launcher
from repro_torch.kernels.plan import ApplyPlan
from repro_torch.launch import serve
from repro_torch.launch.serve import FGFTServeEngine, RaggedFGFTServeEngine

N, B = 16, 2
TOL = 2e-5
FIELDS = {"sym": ("i", "j", "c", "s", "sigma"),
          "general": ("kind", "i", "j", "a")}
H = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
JH = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731


def _agree(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _carry_tables(jstaged):
    """The JAX package's f32 tables as the port's, bit for bit."""
    cls = StagedG if isinstance(jstaged, jst.StagedG) else StagedT
    k = len(cls._fields) - 2
    return cls(*(torch.from_numpy(np.array(a)) for a in jstaged[:k]),
               np.asarray(jstaged.cuts), jstaged.n)


def _carry(jb):
    factors = {k: np.asarray(getattr(jb.factors, k)) for k in FIELDS[jb.kind]}
    return basis_from_numpy(jb.kind, jb.n, factors, np.asarray(jb.spectrum),
                            objective=np.asarray(jb.objective),
                            sizes=jb.sizes, device="cpu")


def _laps(family, n=N, b=B, seed=0):
    adjs = [community_graph(n, seed=seed + s) for s in range(b)]
    if family == "general":
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    return np.stack([laplacian(a) for a in adjs])


@pytest.fixture(scope="module", params=["sym", "general"])
def fits(request):
    """Per family: a batched JAX fit (B = 2) and a single chain, with
    their f32 tables carried into the port."""
    family = request.param
    laps = _laps(family)
    kind = "general" if family == "general" else "sym"
    jb = JaxBasis.fit(jnp.asarray(laps), 4 * N, n_iter=1, kind=kind)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((N, N)).astype(np.float32)
    if family == "sym":
        f, spec, _ = approximate_symmetric(jnp.asarray(a + a.T), g=2 * N,
                                           n_iter=1)
        jf, jbw = jst.pack_g_pair(f)
    else:
        f, spec, _ = approximate_general(jnp.asarray(a), m=2 * N, n_iter=1)
        jf, jbw = jst.pack_t_pair(f, N)
    return {"family": family, "laps": laps, "basis": jb,
            True: (jb.fwd, jb.bwd, np.asarray(jb.spectrum)),
            False: (jf, jbw, np.asarray(spec))}


# -- with_precision ------------------------------------------------------

def test_with_precision_casts_values_only_as_jax_does(fits):
    jfwd, jbwd, _ = fits[True]
    for jstaged in (jfwd, jbwd, fits[False][0]):
        t32 = _carry_tables(jstaged)
        lo = staging.with_precision(t32, "bf16")
        names = staging._table_fields(lo)
        for name in names[:2]:
            assert getattr(lo, name) is getattr(t32, name)
            assert getattr(lo, name).dtype == torch.int32
        for name in names[2:]:
            assert getattr(lo, name).dtype == torch.bfloat16
        assert lo.cuts is t32.cuts and lo.n == t32.n
        assert staging.with_precision(lo, "bf16") is lo
        assert staging.with_precision(t32, "f32") is t32
        assert staging.table_precision(lo) == "bf16"
        back = staging.with_precision(lo, "f32")
        assert all(getattr(back, f).dtype == torch.float32
                   for f in names[2:])
        # round to nearest even on both sides: the same bits
        jlo = jst.with_precision(jstaged, "bf16")
        for name in names[2:]:
            want = np.asarray(getattr(jlo, name)).view(np.uint16)
            got = getattr(lo, name).view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="precision"):
            staging.with_precision(t32, "f16")


# -- plans: the port's bf16 against the JAX package's bf16 ---------------

def _cuts(staged, backend):
    ks = sorted({int(k) for k in np.asarray(staged.cuts)[:, 0]})
    return [k for k in ks if k > 0 or backend == "xla"]


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "B=1"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bf16_apply_matches_jax_at_every_cut(fits, batched, backend):
    family = fits["family"]
    jfwd, jbwd, _ = fits[batched]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(((B,) if batched else ()) + (5, N)).astype(
        np.float32)
    for jstaged in (jfwd, jbwd):
        tstaged = _carry_tables(jstaged)
        for keep in ("head", "tail"):
            for k in _cuts(jstaged, backend)[::2] + [None]:
                kw = dict(family=family, mode="apply", n=N, batched=batched,
                          num_stages=k, keep=keep, precision="bf16")
                want = JaxPlan(backend=backend, **kw).apply(
                    jstaged, jnp.asarray(x))
                got = ApplyPlan(backend="torch", device="cpu", **kw).apply(
                    tstaged, torch.from_numpy(x))
                _agree(got, want)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "B=1"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bf16_operator_and_bank_match_jax(fits, batched, backend):
    family = fits["family"]
    jfwd, jbwd, spec = fits[batched]
    tfwd, tbwd = _carry_tables(jfwd), _carry_tables(jbwd)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(((B,) if batched else ()) + (4, N)).astype(
        np.float32)
    d = (1.0 / (1.0 + np.abs(spec))).astype(np.float32)
    gains = np.stack([d, d ** 2, np.exp(-np.abs(spec))],
                     axis=1 if batched else 0).astype(np.float32)
    mid = _cuts(jfwd, backend)[len(_cuts(jfwd, backend)) // 2]
    fused_set = (True, False) if backend == "xla" else (True,)
    for k in (None, mid):
        for fused in fused_set:
            kw = dict(family=family, n=N, batched=batched, num_stages=k,
                      precision="bf16", fused=fused)
            jop = JaxPlan(mode="operator", backend=backend, **kw)
            top = ApplyPlan(mode="operator", backend="torch", device="cpu",
                            **kw)
            _agree(top.operator(tfwd, tbwd, torch.from_numpy(d),
                                torch.from_numpy(x)),
                   jop.operator(jfwd, jbwd, jnp.asarray(d), jnp.asarray(x)))
            jbank = JaxPlan(mode="bank", backend=backend, **kw)
            tbank = ApplyPlan(mode="bank", backend="torch", device="cpu",
                              **kw)
            _agree(tbank.bank(tfwd, tbwd, torch.from_numpy(gains),
                              torch.from_numpy(x)),
                   jbank.bank(jfwd, jbwd, jnp.asarray(gains),
                              jnp.asarray(x)))


def test_bf16_signal_returns_bf16(fits):
    """The policy around a bf16 program: a bf16 signal is walked in f32
    and comes back bf16, equal to the f32 signal's result, cast."""
    family = fits["family"]
    jfwd, jbwd, spec = fits[True]
    tfwd, tbwd = _carry_tables(jfwd), _carry_tables(jbwd)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, 4, N)).astype(np.float32)).to(torch.bfloat16)
    d = torch.from_numpy(spec.copy())
    for mode in ("apply", "operator"):
        plan = ApplyPlan(family=family, mode=mode, n=N, batched=True,
                         precision="bf16", device="cpu")
        if mode == "apply":
            y16, y32 = plan.apply(tfwd, x), plan.apply(tfwd, x.float())
        else:
            y16 = plan.operator(tfwd, tbwd, d, x)
            y32 = plan.operator(tfwd, tbwd, d, x.float())
        assert y16.dtype == torch.bfloat16 and y32.dtype == torch.float32
        assert torch.equal(y16, y32.to(torch.bfloat16))
        want = JaxPlan(family=family, mode=mode, n=N, batched=True,
                       precision="bf16")
        jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        jy = (want.apply(jfwd, jx) if mode == "apply"
              else want.operator(jfwd, jbwd, jnp.asarray(spec), jx))
        assert jy.dtype == jnp.bfloat16
        _agree(y16.float(), np.asarray(jy.astype(jnp.float32)))


# -- the JAX package's bf16 gates, against the port's own f32 ------------

def test_bf16_operator_tracks_f32(fits):
    family = fits["family"]
    tfwd, tbwd = (_carry_tables(t) for t in fits[False][:2])
    spec = torch.from_numpy(fits[False][2].copy())
    d = 1.0 / (1.0 + spec.abs())
    eye = torch.eye(N)
    ops = {p: ApplyPlan(family=family, mode="operator", n=N, precision=p,
                        device="cpu").operator(tfwd, tbwd, d, eye).numpy()
           for p in ("f32", "bf16")}
    delta = (np.linalg.norm(ops["bf16"] - ops["f32"])
             / max(np.linalg.norm(ops["f32"]), 1e-12))
    assert 0 < delta < 0.03
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (8, N)).astype(np.float32))
    y = {p: ApplyPlan(family=family, mode="operator", n=N, precision=p,
                      device="cpu").operator(tfwd, tbwd, d, x).numpy()
         for p in ("f32", "bf16")}
    dev = (np.linalg.norm(y["bf16"] - y["f32"])
           / max(np.linalg.norm(y["f32"]), 1e-12))
    assert dev <= 2.0 * delta + 1e-3


def test_bf16_ragged_masked_fleet():
    """Pad coordinates stay exactly 0 under bf16 tables when the gains
    are pad-masked; the real ones track the f32 path."""
    fleet = [laplacian(community_graph(s, seed=s)) for s in (10, 14)]
    stack, sizes = pad_ragged(fleet, width=16, device="cpu")
    basis = ApproxEigenbasis.fit(stack, 48, n_iter=1, sizes=sizes,
                                 device="cpu")
    valid = torch.arange(basis.n)[None, :] < torch.as_tensor(sizes)[:, None]
    d = torch.where(valid, 1.0 / (1.0 + basis.spectrum.abs()),
                    torch.zeros(()))
    x = torch.zeros((2, 4, basis.n))
    gen = torch.Generator().manual_seed(8)
    for i, s in enumerate(sizes):
        x[i, :, :s] = torch.randn((4, s), generator=gen)
    y = {p: ApplyPlan(family=basis.kind, mode="operator", n=basis.n,
                      batched=True, precision=p, device="cpu").operator(
                          basis.fwd, basis.bwd, d, x)
         for p in ("f32", "bf16")}
    for i, s in enumerate(sizes):
        assert bool((y["bf16"][i, :, s:] == 0).all())
    dev = float(torch.linalg.norm(y["bf16"] - y["f32"])
                / torch.linalg.norm(y["f32"]))
    assert dev < 0.03


def test_bf16_filter_within_lipschitz_bound():
    from repro_torch.spectral import response_lipschitz
    n = 32
    lap = laplacian(community_graph(n, seed=0))
    basis = ApproxEigenbasis.fit(lap, int(n * np.log2(n) / 2), n_iter=1,
                                 device="cpu")
    delta = float(np.sqrt(float(basis.objective) / (lap * lap).sum()))
    lam, u = np.linalg.eigh(lap.astype(np.float64))
    lip = max(response_lipschitz(H), 1.0)
    x = np.random.default_rng(9).standard_normal((8, n)).astype(np.float32)
    dense = x @ (u * H(lam)[None, :]) @ u.T
    scale = max(float(np.linalg.norm(dense)), 1e-12)
    for precision in ("f32", "bf16"):
        y = basis.project(x, h=H, precision=precision).numpy()
        err = float(np.linalg.norm(y - dense)) / scale
        assert err <= 2.0 * lip * delta + 5e-3, (precision, err)


# -- engines, routers and checkpoints at bf16 ----------------------------

TIERS = {"full": 1.0, "draft": 0.25}


def test_engines_at_bf16_match_jax(fits, tmp_path):
    """A carried basis served at bf16 in both packages: every tier and
    the bank agree; an engine saved at bf16 by either package loads at
    bf16 in the other and serves the same."""
    family, laps, jb = fits["family"], fits["laps"], fits["basis"]
    kw = dict(tiers=TIERS, filters="heat,tikhonov", precision="bf16")
    je = JaxEngine(jnp.asarray(laps), basis=jb, **kw)
    te = FGFTServeEngine(laps, basis=_carry(jb), device="cpu", **kw)
    assert te._live.fwd[2].dtype == torch.bfloat16
    assert te.basis.fwd[2].dtype == torch.float32
    x = np.random.default_rng(4).standard_normal((B, 3, N)).astype(
        np.float32)
    for tier in TIERS:
        _agree(te.step(torch.from_numpy(x), H, tier=tier),
               je.step(jnp.asarray(x), JH, tier=tier))
    _agree(te.step_bank(torch.from_numpy(x)), je.step_bank(jnp.asarray(x)))
    je.save(tmp_path / "jax")
    te.save(tmp_path / "port")
    back = FGFTServeEngine.load(tmp_path / "jax", device="cpu")
    jback = JaxEngine.load(tmp_path / "port", backend="xla")
    assert back._precision == "bf16" and jback._precision == "bf16"
    assert back._live.fwd[2].dtype == torch.bfloat16
    for tier in TIERS:
        _agree(back.step(torch.from_numpy(x), tier=tier),
               jback.step(jnp.asarray(x), tier=tier))


def test_ragged_router_at_bf16_zeroes_the_pads():
    sizes = [10, 16, 24, 30]
    laps = [laplacian(community_graph(n, seed=s))
            for s, n in enumerate(sizes)]
    jr = JaxRouter(laps, 40, n_iter=1, tiers=TIERS, precision="bf16")
    engines = {w: FGFTServeEngine(np.asarray(e._laps_host),
                                  basis=_carry(e.basis), tiers=TIERS,
                                  precision="bf16", device="cpu")
               for w, e in jr.engines.items()}
    tr = RaggedFGFTServeEngine(laps, _engines=engines, device="cpu")
    rng = np.random.default_rng(5)
    sig = [rng.standard_normal((3, n)).astype(np.float32) for n in sizes]
    for got, want in zip(tr.step([torch.from_numpy(s) for s in sig], H),
                         jr.step(sig, JH)):
        _agree(got, want)
    blocks = tr._scatter(sig)
    for w, eng in tr.engines.items():
        y = eng.step(blocks[w], H)
        for row, pos in enumerate(tr.bucket_of[w]):
            assert bool((y[row, :, sizes[pos]:] == 0).all())


def test_dynamic_engine_probes_f32_and_steps_bf16():
    """A bf16 dynamic engine: drift and the Lemma-1 refresh run on the
    basis's f32 tables, the served steps on the bf16 cast, and a REFRESH
    swap keeps the cast, so its steps hit the stream cache."""
    from repro_torch.dynamic import RefitPolicy
    laps = _laps("sym", b=3)
    eng = FGFTServeEngine(laps, 48, n_iter=1, tiers=TIERS, dynamic=True,
                          precision="bf16",
                          policy=RefitPolicy(refresh=1e-9, extend=10.0,
                                             refit=20.0),
                          device="cpu")
    assert eng.basis.fwd.c.dtype == torch.float32
    assert eng._live.fwd[2].dtype == torch.bfloat16
    x = torch.randn((3, 4, N), generator=torch.Generator().manual_seed(0))
    eng.step(x, H)
    cast = eng._live.fwd
    streams = [launcher._cached_stream(StagedG(*t, None, N))
               for t in (eng._live.fwd, eng._live.bwd)]
    eng.apply_updates(0, torch.from_numpy(0.01 * (laps[0] - laps[1])))
    res = eng.maintain()
    assert res["action"] == "refresh"
    assert eng._live.fwd[2] is cast[2]          # the same bf16 tables
    # the card's launches would find their streams cached
    launcher.reset_stream_cache_counts()
    for t, want in zip((eng._live.fwd, eng._live.bwd), streams):
        assert launcher._cached_stream(StagedG(*t, None, N)) is want
    assert launcher.stream_cache_counts() == {"hits": 2, "misses": 0}
    y = eng.step(x, H)
    plain = ApplyPlan(family="sym", mode="operator", n=N, batched=True,
                      precision="bf16", device="cpu").operator(
                          eng.basis.fwd, eng.basis.bwd,
                          H(eng.tiers["full"]["spectrum"]), x)
    assert torch.equal(y, plain)


# -- the CLI ---------------------------------------------------------------

@pytest.mark.parametrize("directed", [False, True],
                         ids=["undirected", "directed"])
def test_cli_serves_bf16_filter_bank(directed, capsys):
    argv = ["--fgft", "--precision", "bf16", "--filter", "heat,tikhonov",
            "--graphs", "2", "--graph-n", "16", "--signals", "4",
            "--filter-steps", "2", "--device", "cpu", "--backend", "torch"]
    out = serve.main(argv + (["--directed"] if directed else []))
    eng = out["engine"]
    assert eng._precision == "bf16"
    assert eng._live.fwd[2].dtype == torch.bfloat16
    assert out["kind"] == ("general" if directed else "sym")
    assert "responses/s" in capsys.readouterr().out


# -- the launcher's bf16 stream and caches, on CPU tensors ---------------

def test_bf16_stream_decodes_to_the_table_bits(fits):
    for jstaged in fits[True][:2] + fits[False][:2]:
        lo = staging.with_precision(_carry_tables(jstaged), "bf16")
        words, off = launcher.entry_stream(lo)
        words32, off32 = launcher.entry_stream(
            staging.with_precision(lo, "f32"))
        assert torch.equal(off, off32)
        assert words.shape[1] == 4
        assert torch.equal(words[:, :2], words32[:, :2])
        tabs = table_arrays(lo)
        real = tabs[0].reshape(-1) < lo.n
        vals = [t.reshape(-1)[real].view(torch.int16) for t in tabs[2:]]
        low = (words[:, 2:] & 0xFFFF).to(torch.int16)
        high = ((words[:, 2:] >> 16) & 0xFFFF).to(torch.int16)
        assert torch.equal(low[:, 0], vals[0])
        assert torch.equal(high[:, 0], vals[1])
        if isinstance(lo, StagedG):
            assert torch.equal(low[:, 1], vals[2])
        assert bool((high[:, 1] == 0).all())
        # widened, the bf16 values are the f32 stream's
        assert torch.equal((words[:, 2] << 16).view(torch.float32),
                           words32[:, 2].view(torch.float32))


def test_bf16_ring_bytes():
    assert launcher.operator_ring_bytes("g", "bf16") == 4096
    assert launcher.operator_ring_bytes("t", "bf16") == 4096
    assert launcher.operator_ring_bytes("g") == 8192
    # a bank ring holds the f32 form's words at either precision
    assert launcher.bank_ring_bytes(63, "g") == 4 * (63 * 8 + 1) * 4
    assert launcher.bank_ring_bytes(72, "t") == 4 * (72 * 4 + 1) * 4
    assert launcher.KERNEL_OF["batched_butterfly_apply_bf16"] == \
        "g_chain_bf16_kernel"
    assert launcher.form("gen_filter_bank_apply", "bf16") == \
        "gen_filter_bank_apply_bf16"
    # four forms an entry point: (f32 | bf16 tables) x (f32 | bf16 signal)
    assert len(launcher.ENTRIES) == 12 and len(launcher.KERNEL_OF) == 48


def test_stream_cache_keeps_both_precisions(fits):
    jfwd, _, _ = fits[True]
    t32 = _carry_tables(jfwd)
    lo = launcher.cast_tables(t32, "bf16")
    assert launcher.cast_tables(t32, "bf16") is lo
    assert launcher.cast_tables(t32, "f32") is t32
    launcher.reset_stream_cache_counts()
    for _ in range(3):
        launcher._cached_stream(t32)
        launcher._cached_stream(lo)
    assert launcher.stream_cache_counts() == {"hits": 4, "misses": 2}
    table_arrays(t32)[2].mul_(1.0)               # a write: a new cast
    assert launcher.cast_tables(t32, "bf16") is not lo
    with pytest.raises(TypeError, match="differ in precision"):
        launcher._form("batched_butterfly_apply", t32, lo)
    mixed = dict(zip(t32._fields[3:4], table_arrays(lo)[3:4]))
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        staging.table_precision(t32._replace(**mixed))


def test_plan_one_shot_calls_share_the_cast(fits):
    jfwd, jbwd, spec = fits[True]
    tfwd, tbwd = _carry_tables(jfwd), _carry_tables(jbwd)
    plan = ApplyPlan.for_staged(tfwd, "operator", precision="bf16",
                                device="cpu")
    a, b = plan.prepare(tfwd), plan.prepare(tfwd)
    assert a[2].dtype == torch.bfloat16
    assert all(x is y for x, y in zip(a, b))
    assert a[0] is tfwd.idx_i
