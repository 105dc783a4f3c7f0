"""bf16 signals in the port against the JAX package, which computes a
bf16 signal in bf16 at every one of its 12 Pallas entry points (each
table value, spectrum entry and gain cast to the signal's dtype, every
product and sum rounded to it).

* Each of the 12 plain versions (``repro_torch.kernels.ref``, which the
  CUDA wrappers use on CPU tensors and against which the kernels'
  bf16-signal forms are held on the card) against the JAX Pallas entry
  point in interpret mode on the same bf16 signal and the same tables
  (packed by both packers from one set of factors: bitwise equal),
  f32 and bf16 value tables, at the shapes of tests/test_kernels.py and
  at a ladder cut, banks at F in {1, 3}: bitwise.
* The bases, banks, FGFT and engine (every tier, the bank) on carried
  bases against the same JAX calls (backend "pallas", interpret): bf16
  in, bf16 out on both sides, bitwise.  (The tier spectra and the bank's
  gains are computed in f32 by each package; at these shapes they agree
  to the bit after the cast to bf16, so no bound is needed.)
* The launcher's form choice, counters and pointers for a bf16 signal,
  on CPU tensors with a stand-in for the kernel library (no card)."""
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ApproxEigenbasis as JaxBasis
from repro.core import build_fgft as jax_build_fgft
from repro.core import staging as jst
from repro.core.types import GFactors as JG
from repro.core.types import TFactors as JT
from repro.kernels import butterfly as jbf
from repro.kernels import shear as jsh
from repro.kernels import spectral as jsp
from repro.launch.serve import FGFTServeEngine as JaxEngine
from repro.spectral import SpectralFilterBank as JaxBank
from repro_torch.core import laplacian, staging
from repro_torch.core.fgft import FGFT
from repro_torch.core.types import GFactors, TFactors, as_signal
from repro_torch.graphs import community_graph, directed_variant
from repro_torch.interop import basis_from_numpy
from repro_torch.kernels import launcher, ref
from repro_torch.launch.serve import FGFTServeEngine
from repro_torch.spectral import SpectralFilterBank

#: (rows, n) of tests/test_kernels.py's sweeps
SHAPES = [(1, 16), (7, 32), (64, 48), (130, 16)]
BATCH = 2
FIELDS = {"sym": ("i", "j", "c", "s", "sigma"),
          "general": ("kind", "i", "j", "a")}


def _bits(y) -> np.ndarray:
    """A bf16 array or tensor as its 16-bit patterns."""
    if isinstance(y, torch.Tensor):
        assert y.dtype == torch.bfloat16
        return y.view(torch.int16).numpy().view(np.uint16)
    assert y.dtype == jnp.bfloat16
    return np.asarray(y).view(np.uint16)


def _same(got, want) -> None:
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _bf16(a: np.ndarray):
    """(the JAX array, the port's tensor) of one bf16 signal: cast once
    by JAX, the same bits on both sides."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)
    return j, t


def _factors(family: str, n: int, batch: int, g: int, seed: int) -> tuple:
    """Numpy fields of ``batch`` random chains of g components."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, (batch, g))
    j = (i + rng.integers(1, n, (batch, g))) % n
    if family == "sym":
        theta = rng.uniform(-np.pi, np.pi, (batch, g))
        return (np.minimum(i, j).astype(np.int32),
                np.maximum(i, j).astype(np.int32),
                np.cos(theta).astype(np.float32),
                np.sin(theta).astype(np.float32),
                rng.choice([-1.0, 1.0], (batch, g)).astype(np.float32))
    kind = rng.integers(0, 2, (batch, g)).astype(np.int32)
    scale = (rng.uniform(0.8, 1.25, (batch, g))
             * rng.choice([-1.0, 1.0], (batch, g)))
    a = np.where(kind == 0, scale, rng.uniform(-0.5, 0.5, (batch, g)))
    return (kind, i.astype(np.int32), np.where(kind == 0, i, j).astype(
        np.int32), a.astype(np.float32))


def _tables(family: str, n: int, batched: bool, precision: str):
    """((jax fwd, jax bwd), (port fwd, port bwd)) of random chains, packed
    by both packers, at a table precision."""
    fields = _factors(family, n, BATCH, 3 * n, seed=n)
    if not batched:
        fields = tuple(f[0] for f in fields)
    if family == "sym":
        jf = JG(*map(jnp.asarray, fields))
        tf = GFactors(*map(torch.from_numpy, fields))
        jt = (jst.pack_g_batch_pair(jf, n) if batched
              else jst.pack_g_pair(jf, n=n))
        tt = (staging.pack_g_batch_pair(tf, n, device="cpu") if batched
              else staging.pack_g_pair(tf, n=n, device="cpu"))
    else:
        jf = JT(*map(jnp.asarray, fields))
        tf = TFactors(*map(torch.from_numpy, fields))
        jt = (jst.pack_t_batch_pair(jf, n) if batched
              else jst.pack_t_pair(jf, n))
        tt = (staging.pack_t_batch_pair(tf, n, device="cpu") if batched
              else staging.pack_t_pair(tf, n, device="cpu"))
    return (tuple(jst.with_precision(t, precision) for t in jt),
            tuple(staging.with_precision(t, precision) for t in tt))


#: family -> (jax module, chain, operator, bank names; port plain chain)
_NAMES = {"sym": (jbf, "butterfly_apply", "sym_operator_apply",
                  "sym_filter_bank_apply", "g_apply"),
          "general": (jsh, "shear_apply", "gen_operator_apply",
                      "gen_filter_bank_apply", "t_apply")}


def _plain_chain(family: str, batched: bool):
    short = _NAMES[family][4]
    return getattr(ref, ("batched_" if batched else "staged_") + short)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "B=1"])
@pytest.mark.parametrize("family", ["sym", "general"])
@pytest.mark.parametrize("rows,n", SHAPES)
def test_plain_versions_match_pallas_bitwise(rows, n, family, batched,
                                             precision):
    """The chain (both keeps), operator and bank (F = 1 and 3) plain
    versions against the Pallas entry points, full chain and a mid cut:
    the same bf16 bits."""
    (jfwd, jbwd), (fwd, bwd) = _tables(family, n, batched, precision)
    mod, chain, op, bank, _ = _NAMES[family]
    pre = "batched_" if batched else ""
    lead = (BATCH,) if batched else ()
    rng = np.random.default_rng(rows + n)
    jx, x = _bf16(rng.standard_normal(lead + (rows, n)).astype(np.float32))
    diag = rng.uniform(0.0, 2.0, lead + (n,)).astype(np.float32)
    gains = rng.uniform(0.0, 2.0, lead + (3, n)).astype(np.float32)
    cuts = fwd.cuts[:, 0]
    mid = int(cuts[len(cuts) // 2])
    chain_fn = getattr(mod, pre + chain)
    chain_plain = _plain_chain(family, batched)
    for k, keep in ((None, "head"), (mid, "tail")):
        for jt, tt in ((jfwd, fwd), (jbwd, bwd)):
            want = chain_fn(jt, jx, interpret=True, num_stages=k, keep=keep)
            _same(chain_plain(tt, x, k, keep), want)
    for k in (None, mid):
        want = getattr(mod, pre + op)(jfwd, jbwd, jnp.asarray(diag), jx,
                                      interpret=True, num_stages=k)
        _same(getattr(ref, pre + op)(fwd, bwd, torch.from_numpy(diag), x,
                                     k), want)
    for k, f in ((None, 3), (mid, 1)):
        g = gains[..., :f, :]
        want = getattr(jsp, pre + bank)(jfwd, jbwd, jnp.asarray(g), jx,
                                        interpret=True, num_stages=k)
        got = getattr(ref, pre + bank)(fwd, bwd, torch.from_numpy(g), x, k)
        assert got.shape == want.shape
        _same(got, want)


def test_plain_versions_on_a_bf16_signal_cast_table_values_per_entry():
    """On f32 tables the plain version computes what it computes on the
    tables cast once to bf16 (RNE both ways): the launcher's route for
    the bf16-signal forms on f32 tables."""
    for family in ("sym", "general"):
        _, (fwd, bwd) = _tables(family, 32, True, "f32")
        lo = [staging.with_precision(t, "bf16") for t in (fwd, bwd)]
        _, x = _bf16(np.random.default_rng(5).standard_normal(
            (BATCH, 9, 32)).astype(np.float32))
        d = torch.rand((BATCH, 32))
        chain = _plain_chain(family, True)
        op = (ref.batched_sym_operator_apply if family == "sym"
              else ref.batched_gen_operator_apply)
        _same(chain(fwd, x), chain(lo[0], x))
        _same(op(fwd, bwd, d, x), op(lo[0], lo[1], d, x))


# -- bases, banks, FGFT and engines on carried bases ---------------------

N, B = 16, 2
H = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731


def _laps(kind, n=N, b=B):
    adjs = [community_graph(n, seed=s) for s in range(b)]
    if kind == "general":
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    return np.stack([laplacian(a) for a in adjs])


def _carry(jb):
    factors = {k: np.asarray(getattr(jb.factors, k))
               for k in FIELDS[jb.kind]}
    return basis_from_numpy(jb.kind, jb.n, factors, np.asarray(jb.spectrum),
                            objective=np.asarray(jb.objective),
                            sizes=jb.sizes, device="cpu")


@pytest.fixture(scope="module", params=["sym", "general"])
def carried(request):
    kind = request.param
    laps = _laps(kind)
    jb = JaxBasis.fit(jnp.asarray(laps), 4 * N, n_iter=1, kind=kind)
    return {"kind": kind, "laps": laps, "jax": jb, "port": _carry(jb)}


def _block(shape, seed):
    return _bf16(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32))


def test_basis_apply_and_project_stay_bf16(carried):
    jb, tb = carried["jax"], carried["port"]
    jx, x = _block((B, 5, N), 11)
    mid = int(tb.fwd.cuts[len(tb.fwd.cuts) // 2, 0])
    for k in (None, mid):
        for inverse in (False, True):
            _same(tb.apply(x, inverse=inverse, num_stages=k),
                  jb.apply(jx, inverse=inverse, backend="pallas",
                           num_stages=k))
        _same(tb.project(x, num_stages=k),
              jb.project(jx, backend="pallas", num_stages=k))
        _same(tb.project(x, h=H, num_stages=k),
              jb.project(jx, h=H, backend="pallas", num_stages=k))
    # the three-pass baseline rounds as the fused operator does
    _same(tb.project(x, h=H, fused=False), tb.project(x, h=H))


def test_filter_bank_stays_bf16(carried):
    jb, tb = carried["jax"], carried["port"]
    responses = {"low": H, "identity": lambda lam: lam}
    jbank, bank = JaxBank(jb, responses), SpectralFilterBank(tb, responses)
    np.testing.assert_array_equal(bank.gains().numpy(),
                                  np.asarray(jbank.gains()))
    jx, x = _block((B, 6, N), 12)
    y = bank.apply(x)
    assert y.shape == (B, 2, 6, N)
    _same(y, jbank.apply(jx, backend="pallas"))
    for f in range(2):
        _same(y[:, f], bank.filters[f].apply(x))


@pytest.mark.parametrize("directed", [False, True],
                         ids=["undirected", "directed"])
def test_fgft_stays_bf16(directed):
    n = 32
    adj = community_graph(n, seed=3)
    if directed:
        adj = directed_variant(adj, seed=3)
    jf = jax_build_fgft(jnp.asarray(laplacian(adj)), 3 * n,
                        directed=directed, n_iter=1)
    if directed:
        tf = TFactors(*(torch.from_numpy(np.asarray(a).copy())
                        for a in jf.t_factors))
        fwd, bwd = staging.pack_t_pair(tf, n, device="cpu")
        f = FGFT(n=n, spectrum=torch.from_numpy(np.array(jf.spectrum)),
                 g_factors=None, fwd=fwd, bwd=bwd, directed=True,
                 t_factors=tf)
    else:
        g = GFactors(*(torch.from_numpy(np.asarray(a).copy())
                       for a in jf.g_factors))
        fwd, bwd = staging.pack_g_pair(g, n=n, device="cpu")
        f = FGFT(n=n, spectrum=torch.from_numpy(np.array(jf.spectrum)),
                 g_factors=g, fwd=fwd, bwd=bwd)
    jx, x = _block((7, n), 13)
    mid = int(f.stage_cuts[len(f.stage_cuts) // 2, 0])
    for k in (None, mid):
        xh = f.analysis(x, num_stages=k)
        _same(xh, jf.analysis(jx, backend="pallas", num_stages=k))
        _same(f.synthesis(xh, num_stages=k),
              jf.synthesis(jf.analysis(jx, backend="pallas", num_stages=k),
                           backend="pallas", num_stages=k))
        _same(f.filter(x, H, num_stages=k),
              jf.filter(jx, H, backend="pallas", num_stages=k))


TIERS = {"full": 1.0, "draft": 0.25}


def test_engine_step_and_bank_stay_bf16(carried):
    laps, jb, tb = carried["laps"], carried["jax"], carried["port"]
    kw = dict(tiers=TIERS, filters="heat,tikhonov")
    je = JaxEngine(jnp.asarray(laps), basis=jb, backend="pallas", **kw)
    te = FGFTServeEngine(laps, basis=tb, device="cpu", **kw)
    jx, x = _block((B, 3, N), 14)
    _same(te.step(x, tier="full"), je.step(jx, tier="full"))
    for tier in TIERS:
        y = te.step(x, H, tier=tier)
        _same(y, je.step(jx, H, tier=tier))
        # the engine's answer is the basis's own operator at its tier
        t = te._live.tiers[tier]
        want = tb.project(x, h=lambda _: H(t["spectrum"]),
                          num_stages=t["num_stages"])
        _same(y, want)
    yb = te.step_bank(x)
    assert yb.shape == (B, 2, 3, N)
    _same(yb, je.step_bank(jx))
    _same(yb, te.bank.apply(x))
    # an f32 block still serves f32
    assert te.step(x.float()).dtype == torch.float32


def test_as_signal_keeps_f32_and_bf16():
    x16 = torch.zeros(3, dtype=torch.bfloat16)
    assert as_signal(x16, "cpu").dtype == torch.bfloat16
    assert as_signal(x16.float(), "cpu").dtype == torch.float32
    assert as_signal(x16.double(), "cpu").dtype == torch.float32
    assert as_signal(np.zeros(3), "cpu").dtype == torch.float32
    assert as_signal([1, 2], "cpu").dtype == torch.float32


# -- the launcher's choice of form, on CPU tensors -----------------------

def test_form_names_and_kernels():
    assert launcher.form("batched_butterfly_apply", "f32", "bf16") == \
        "batched_butterfly_apply_xbf16"
    assert launcher.form("shear_apply", "bf16", "bf16") == \
        "shear_apply_bf16_xbf16"
    assert launcher.form("shear_apply", "bf16") == "shear_apply_bf16"
    for entry, kernel in launcher._F32_KERNEL_OF.items():
        x = kernel.replace("_kernel", "_xbf16_kernel")
        assert launcher.KERNEL_OF[f"{entry}_xbf16"] == x
        assert launcher.KERNEL_OF[f"{entry}_bf16_xbf16"] == x
    assert len(launcher.KERNELS) == 18
    assert len(launcher.KERNEL_OF) == 48
    assert set(launcher.entry_launch_counts()) == set(launcher.KERNEL_OF)
    assert set(launcher.launch_counts()) == set(launcher.KERNELS)
    x16 = torch.zeros((1, 2, 4), dtype=torch.bfloat16, device="meta")
    for bad in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32"):
            launcher._check_signal(x16.to(bad), 3, "t")
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher._check_signal(x16, 3, "t")


class _FakeLib:
    """Records each C launcher's call; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def fake_card(monkeypatch):
    """The launcher's launch path on CPU tensors: a stand-in library, a
    fixed geometry and a stream handle of 0."""
    lib = _FakeLib()
    monkeypatch.setattr(launcher.build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    geo = launcher.OperatorGeometry(1, 32, 1, 1, 0, 1)
    monkeypatch.setattr(launcher, "_operator_geometry_on",
                        lambda *a: geo)
    monkeypatch.setattr(launcher, "_bank_geometry_on",
                        lambda *a: launcher.BankGeometry(4, 1, 1, 1, 0, 3))
    return lib


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["sym", "general"])
def test_bf16_signal_launches_the_xbf16_form(fake_card, monkeypatch,
                                             family, precision):
    """A bf16 signal launches ``<kernel>_xbf16`` on bf16 tables (f32
    ones cast once and kept), counts ``form(entry, precision, "bf16")``,
    returns y in bf16 and offsets the signal pointers by 2-byte elements
    across batch slices; an f32 signal still launches its table form."""
    _, (fwd, bwd) = _tables(family, 16, True, precision)
    batch = fwd.idx_i.shape[0]
    x = torch.zeros((batch, 5, 16), dtype=torch.bfloat16)
    d = torch.ones((batch, 16))
    gains = torch.ones((batch, 2, 16))
    k = "g" if family == "sym" else "t"
    names = (("batched_butterfly_apply", "batched_sym_operator_apply",
              "batched_sym_filter_bank_apply") if family == "sym" else
             ("batched_shear_apply", "batched_gen_operator_apply",
              "batched_gen_filter_bank_apply"))
    monkeypatch.setattr(launcher, "_GRID_B", 1)   # one launch a matrix
    launcher.reset_launch_counts()
    ys = (launcher._chain_launch(names[0], fwd, x, None, "head"),
          launcher._operator_launch(names[1], fwd, bwd, d, x, None),
          launcher._bank_launch(names[2], fwd, bwd, gains, x, None))
    assert [y.dtype for y in ys] == [torch.bfloat16] * 3
    assert ys[2].shape == (batch, 2, 5, 16)
    counts = launcher.entry_launch_counts()
    for name in names:
        assert counts[launcher.form(name, precision, "bf16")] == batch
    assert sum(counts.values()) == 3 * batch
    kernels = launcher.launch_counts()
    for kind in ("chain", "operator", "bank"):
        assert kernels[f"{k}_{kind}_xbf16_kernel"] == batch
    called = [name for name, _ in fake_card.calls]
    assert called == [f"{k}_{kind}_xbf16_launch"
                      for kind in ("chain", "operator", "bank")
                      for _ in range(batch)]
    # the second matrix's signal pointers: one (R, n) block of 2 bytes on
    chain_calls = [a for name, a in fake_card.calls if "chain" in name]
    assert chain_calls[1][0] - chain_calls[0][0] == 5 * 16 * 2
    assert chain_calls[1][1] - chain_calls[0][1] == 5 * 16 * 2
    assert chain_calls[0][0] == x.data_ptr()
    # the stream the chain walked is the bf16 tables' (f32 cast, kept)
    lo = launcher.cast_tables(fwd, "bf16")
    assert lo is launcher._walked(fwd, x)
    words, _ = launcher._cached_stream(lo)
    assert chain_calls[0][5] == words.data_ptr()
    assert words.shape[1] == 4
    # the bank walks the bf16 value tables (its first leg: bwd's)
    bank_calls = [a for name, a in fake_card.calls if "bank" in name]
    lob = launcher.cast_tables(bwd, "bf16")
    assert bank_calls[0][9] == staging.table_arrays(lob)[2].data_ptr()
    # an f32 signal: the tables' own form
    fake_card.calls.clear()
    launcher.reset_launch_counts()
    launcher._chain_launch(names[0], fwd, x.float(), None, "head")
    assert launcher.entry_launch_counts()[
        launcher.form(names[0], precision)] == batch
    assert fake_card.calls[0][0] == (f"{k}_chain_launch" if precision == "f32"
                                     else f"{k}_chain_bf16_launch")


def test_fresh_imports_have_no_cycle():
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    for order in ("repro_torch.core, repro_torch.kernels",
                  "repro_torch.kernels, repro_torch.core"):
        out = subprocess.run([sys.executable, "-c", f"import {order}"],
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "PYTHONPATH": src})
        assert out.returncode == 0, out.stderr
