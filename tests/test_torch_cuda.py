"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Every test here is marked ``cuda`` and skips without a card;
the module imports neither JAX nor the JAX package, so it also runs on a
machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: ``1e-4 * max(1, max|y|)`` — the G kernels and their plain
versions round their FMA contractions differently across about 2S
stages.  The T kernels round each entry as their plain versions do (no
FMA contraction) and are held to bitwise equality; so are the T bank
kernel and each of its filters against the T operator kernel with that
filter's gains (the same leg walks and multiply)."""
import numpy as np
import pytest
import torch

from repro_torch.core import staging as tst
from repro_torch.core.types import GFactors, TFactors
from repro_torch.kernels import butterfly as bf
from repro_torch.kernels import launcher
from repro_torch.kernels import shear as sh
from repro_torch.kernels import spectral as ksp
from repro_torch.kernels import ref
from repro_torch.kernels.plan import ApplyPlan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    return torch.device("cuda")


def _tables(n, batch, g, device):
    rng = np.random.default_rng(n)
    a = rng.integers(0, n, (batch, g))
    b = (a + rng.integers(1, n, (batch, g))) % n
    theta = rng.uniform(-np.pi, np.pi, (batch, g))
    f = GFactors(np.minimum(a, b).astype(np.int32),
                 np.maximum(a, b).astype(np.int32),
                 np.cos(theta).astype(np.float32),
                 np.sin(theta).astype(np.float32),
                 rng.choice([-1.0, 1.0], (batch, g)).astype(np.float32))
    fwd, adj = tst.pack_g_batch_pair(f, n, device=device)
    sfwd, sadj = tst.pack_g_pair(GFactors(*(t[0] for t in f)), n=n,
                                 device=device)
    diag = torch.from_numpy(rng.uniform(0.0, 2.0 * n, (batch, n)).astype(
        np.float32)).to(device)
    return fwd, adj, sfwd, sadj, diag


def _close(got, want):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("n,batch,g", [(16, 3, 64), (48, 2, 200),
                                       (256, 2, 4096)])
def test_kernels_match_plain_versions_at_every_cut(cuda, n, batch, g):
    fwd, adj, sfwd, sadj, diag = _tables(n, batch, g, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((batch, 130, n), generator=gen, device=cuda)
    for k in sorted({0, *fwd.cuts[:, 0].tolist()}):
        for keep in ("head", "tail"):
            _close(bf.batched_butterfly_apply(fwd, x, k, keep),
                   ref.batched_g_apply(fwd, x, k, keep))
        _close(bf.batched_sym_operator_apply(fwd, adj, diag, x, k),
               ref.batched_sym_operator_apply(fwd, adj, diag, x, k))
    x1 = x[0].contiguous()
    for k in sorted({0, *sfwd.cuts[:, 0].tolist()}):
        _close(bf.butterfly_apply(sfwd, x1, k, "tail"),
               ref.staged_g_apply(sfwd, x1, k, "tail"))
        _close(bf.sym_operator_apply(sfwd, sadj, diag[0], x1, k),
               ref.sym_operator_apply(sfwd, sadj, diag[0], x1, k))
    torch.cuda.synchronize()


def test_cuda_plans_launch_the_kernels(cuda):
    fwd, adj, _, _, diag = _tables(32, 2, 160, cuda)
    x = torch.randn((2, 5, 7, 32), device=cuda)
    launcher.reset_launch_counts()
    op = ApplyPlan.for_staged(fwd, "operator")
    assert op.backend == "cuda"
    y = op.operator(fwd, adj, diag, x)
    y_plain = ApplyPlan.for_staged(fwd, "operator", backend="torch"
                                   ).operator(fwd, adj, diag, x)
    _close(y, y_plain)
    ApplyPlan.for_staged(fwd, "apply", keep="tail").apply(fwd, x)
    assert launcher.launch_counts() == {
        **dict.fromkeys(launcher.KERNELS, 0), "g_chain_kernel": 1,
        "g_operator_kernel": 1}
    assert launcher.entry_launch_counts() == {
        **dict.fromkeys(launcher.KERNEL_OF, 0),
        "batched_butterfly_apply": 1, "batched_sym_operator_apply": 1}


def test_cuda_wrapper_validation(cuda):
    fwd, adj, _, _, diag = _tables(16, 2, 64, cuda)
    x = torch.randn((2, 4, 16), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        bf.batched_butterfly_apply(fwd, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        bf.batched_butterfly_apply(fwd, x.transpose(1, 2).contiguous()
                                   .transpose(1, 2))
    with pytest.raises(ValueError, match="do not match"):
        bf.batched_butterfly_apply(fwd, torch.randn((3, 4, 16), device=cuda))
    with pytest.raises(ValueError, match="diag shape"):
        bf.batched_sym_operator_apply(fwd, adj, diag[:, :8], x)
    cpu_fwd = tst.StagedG(*(t.cpu() for t in fwd[:5]), fwd.cuts, fwd.n)
    with pytest.raises(ValueError, match="on cpu"):
        bf.batched_butterfly_apply(cpu_fwd, x)


def _t_tables(n, batch, m, device):
    rng = np.random.default_rng(n)
    shape = (batch, m)
    kind = rng.integers(0, 2, shape).astype(np.int32)
    i = rng.integers(0, n, shape).astype(np.int32)
    j = np.where(kind == 0, i, (i + rng.integers(1, n, shape)) % n)
    scale = rng.uniform(0.8, 1.25, shape) * rng.choice([-1.0, 1.0], shape)
    a = np.where(kind == 0, scale, rng.uniform(-0.5, 0.5, shape))
    f = TFactors(kind, i, j.astype(np.int32), a.astype(np.float32))
    fwd, inv = tst.pack_t_batch_pair(f, n, device=device)
    sfwd, sinv = tst.pack_t_pair(TFactors(*(t[0] for t in f)), n,
                                 device=device)
    diag = torch.from_numpy(rng.uniform(0.0, 2.0 * n, (batch, n)).astype(
        np.float32)).to(device)
    return fwd, inv, sfwd, sinv, diag


@pytest.mark.parametrize("n,batch,m", [(16, 3, 64), (48, 2, 200),
                                       (256, 2, 4096)])
def test_t_kernels_equal_plain_versions_at_every_cut(cuda, n, batch, m):
    fwd, inv, sfwd, sinv, diag = _t_tables(n, batch, m, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((batch, 130, n), generator=gen, device=cuda)
    for k in sorted({0, *fwd.cuts[:, 0].tolist()}):
        for keep in ("head", "tail"):
            assert torch.equal(sh.batched_shear_apply(inv, x, k, keep),
                               ref.batched_t_apply(inv, x, k, keep))
        assert torch.equal(
            sh.batched_gen_operator_apply(fwd, inv, diag, x, k),
            ref.batched_gen_operator_apply(fwd, inv, diag, x, k))
    x1 = x[0].contiguous()
    for k in sorted({0, *sfwd.cuts[:, 0].tolist()}):
        assert torch.equal(sh.shear_apply(sfwd, x1, k, "head"),
                           ref.staged_t_apply(sfwd, x1, k, "head"))
        assert torch.equal(sh.gen_operator_apply(sfwd, sinv, diag[0], x1, k),
                           ref.gen_operator_apply(sfwd, sinv, diag[0], x1, k))
    torch.cuda.synchronize()


def test_cuda_general_plans_launch_the_t_kernels(cuda):
    fwd, inv, _, _, diag = _t_tables(32, 2, 160, cuda)
    x = torch.randn((2, 5, 7, 32), device=cuda)
    launcher.reset_launch_counts()
    op = ApplyPlan.for_staged(fwd, "operator")
    assert op.family == "general" and op.backend == "cuda"
    y = op.operator(fwd, inv, diag, x)
    y_plain = ApplyPlan.for_staged(fwd, "operator", backend="torch"
                                   ).operator(fwd, inv, diag, x)
    assert torch.equal(y, y_plain)
    ApplyPlan.for_staged(inv, "apply", keep="tail").apply(inv, x)
    assert launcher.launch_counts() == {
        **dict.fromkeys(launcher.KERNELS, 0), "t_chain_kernel": 1,
        "t_operator_kernel": 1}
    assert launcher.entry_launch_counts() == {
        **dict.fromkeys(launcher.KERNEL_OF, 0),
        "batched_shear_apply": 1, "batched_gen_operator_apply": 1}


def test_t_wrapper_validation(cuda):
    fwd, inv, _, _, diag = _t_tables(16, 2, 64, cuda)
    x = torch.randn((2, 4, 16), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        sh.batched_shear_apply(fwd, x.double())
    with pytest.raises(ValueError, match="do not match"):
        sh.batched_shear_apply(fwd, torch.randn((3, 4, 16), device=cuda))
    with pytest.raises(ValueError, match="diag shape"):
        sh.batched_gen_operator_apply(fwd, inv, diag[:, :8], x)
    cpu_fwd = tst.StagedT(*(t.cpu() for t in fwd[:4]), fwd.cuts, fwd.n)
    with pytest.raises(ValueError, match="on cpu"):
        sh.batched_shear_apply(cpu_fwd, x)


def _batch_for_lanes(lanes, rows, n, family, device):
    """The fewest matrices at which the operator geometry on this card
    takes ``lanes`` lanes per row."""
    for batch in range(1, 257):
        geo = launcher._operator_geometry_on(device, batch, rows, n, family,
                                             "f32")
        if geo.lanes == lanes:
            return batch
    pytest.fail(f"no batch up to 256 takes {lanes} lanes per row")


@pytest.mark.parametrize("family", ["sym", "general"])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [255, 256])
def test_operator_kernels_at_each_lane_count(cuda, family, lanes, n):
    """Both operator kernels at a batch where the geometry takes each
    lane count it can (launcher.operator_geometry), R = 130 signal rows
    (no multiple of any rows per warp: every matrix ends in a partial
    warp), n = 255 and 256, every cut; the B = 1 entry points too where
    the batch is one.  G within the tolerance, T bitwise."""
    rows = 130
    batch = _batch_for_lanes(lanes, rows, n,
                             "g" if family == "sym" else "t", cuda)
    if family == "sym":
        fwd, bwd, sfwd, sbwd, diag = _tables(n, batch, 2 * n, cuda)
        op, op1 = bf.batched_sym_operator_apply, bf.sym_operator_apply
        plain = ref.batched_sym_operator_apply
        plain1 = ref.sym_operator_apply
        check, entry = _close, "batched_sym_operator_apply"
    else:
        fwd, bwd, sfwd, sbwd, diag = _t_tables(n, batch, 2 * n, cuda)
        op, op1 = sh.batched_gen_operator_apply, sh.gen_operator_apply
        plain = ref.batched_gen_operator_apply
        plain1 = ref.gen_operator_apply
        check, entry = _equal, "batched_gen_operator_apply"
    geo = launcher.launch_geometry(entry, batch, rows, n)
    assert geo["lanes_per_row"] == lanes
    assert rows % geo["rows_per_warp"] != 0
    gen = torch.Generator(device=cuda).manual_seed(lanes)
    x = torch.randn((batch, rows, n), generator=gen, device=cuda)
    launcher.reset_launch_counts()
    cuts = sorted({0, *fwd.cuts[:, 0].tolist()})
    for k in cuts:
        check(op(fwd, bwd, diag, x, k), plain(fwd, bwd, diag, x, k))
    assert launcher.entry_launch_counts()[entry] == len(cuts)
    if batch == 1:
        x1 = x[0].contiguous()
        for k in sorted({0, *sfwd.cuts[:, 0].tolist()}):
            check(op1(sfwd, sbwd, diag[0], x1, k),
                  plain1(sfwd, sbwd, diag[0], x1, k))
    torch.cuda.synchronize()


@pytest.mark.parametrize("family", ["sym", "general"])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [255, 256])
def test_chain_kernels_at_each_lane_count(cuda, family, lanes, n):
    """Both chain kernels at a batch where the geometry takes each lane
    count, R = 130 signal rows (every matrix ends in a partial warp),
    n = 255 and 256, every cut at both keeps, on both table sets; the
    B = 1 entry points too where the batch is one.  G within the
    tolerance, T bitwise."""
    rows = 130
    batch = _batch_for_lanes(lanes, rows, n,
                             "g" if family == "sym" else "t", cuda)
    if family == "sym":
        tabs = _tables(n, batch, 2 * n, cuda)
        chain, chain1 = bf.batched_butterfly_apply, bf.butterfly_apply
        plain, plain1 = ref.batched_g_apply, ref.staged_g_apply
        check, entry = _close, "batched_butterfly_apply"
    else:
        tabs = _t_tables(n, batch, 2 * n, cuda)
        chain, chain1 = sh.batched_shear_apply, sh.shear_apply
        plain, plain1 = ref.batched_t_apply, ref.staged_t_apply
        check, entry = _equal, "batched_shear_apply"
    fwd, bwd, sfwd, sbwd, _ = tabs
    geo = launcher.launch_geometry(entry, batch, rows, n)
    assert geo["lanes_per_row"] == lanes
    assert rows % geo["rows_per_warp"] != 0
    gen = torch.Generator(device=cuda).manual_seed(lanes)
    x = torch.randn((batch, rows, n), generator=gen, device=cuda)
    launcher.reset_launch_counts()
    calls = 0
    for staged in (fwd, bwd):
        for k in sorted({0, *staged.cuts[:, 0].tolist()}):
            for keep in ("head", "tail"):
                check(chain(staged, x, k, keep), plain(staged, x, k, keep))
                calls += 1
    assert launcher.entry_launch_counts()[entry] == calls
    if batch == 1:
        x1 = x[0].contiguous()
        for staged in (sfwd, sbwd):
            for k in sorted({0, *staged.cuts[:, 0].tolist()}):
                for keep in ("head", "tail"):
                    check(chain1(staged, x1, k, keep),
                          plain1(staged, x1, k, keep))
    torch.cuda.synchronize()


@pytest.mark.parametrize("family", ["sym", "general"])
def test_batches_split_at_the_grid_limit(cuda, family, monkeypatch):
    """A batch of 7 at a grid limit of 3 matrices: the chain, operator and
    bank entry points each launch three times, on [0, 3), [3, 6) and
    [6, 7), and equal their unsplit launches bitwise."""
    if family == "sym":
        fwd, bwd, _, _, diag = _tables(48, 7, 200, cuda)
        chain, op = bf.batched_butterfly_apply, bf.batched_sym_operator_apply
        bank = ksp.batched_sym_filter_bank_apply
        names = ("batched_butterfly_apply", "batched_sym_operator_apply",
                 "batched_sym_filter_bank_apply")
    else:
        fwd, bwd, _, _, diag = _t_tables(48, 7, 200, cuda)
        chain, op = sh.batched_shear_apply, sh.batched_gen_operator_apply
        bank = ksp.batched_gen_filter_bank_apply
        names = ("batched_shear_apply", "batched_gen_operator_apply",
                 "batched_gen_filter_bank_apply")
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((7, 130, 48), generator=gen, device=cuda)
    gains = _gains((7, 5, 48), cuda, 6)
    k = int(fwd.cuts[1, 0])
    calls = (lambda: chain(fwd, x, k, "tail"),
             lambda: op(fwd, bwd, diag, x, k),
             lambda: bank(fwd, bwd, gains, x, k))
    whole = [call() for call in calls]
    monkeypatch.setattr(launcher, "_GRID_B", 3)
    launcher.reset_launch_counts()
    for call, want in zip(calls, whole):
        assert torch.equal(call(), want)
    counts = launcher.entry_launch_counts()
    assert [counts[e] for e in names] == [3, 3, 3]
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# filter banks: g_bank_kernel and t_bank_kernel
# ---------------------------------------------------------------------------

def _gains(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) * 2.0


@pytest.mark.parametrize("family", ["sym", "general"])
@pytest.mark.parametrize("n,batch,g", [(16, 3, 64), (48, 2, 200),
                                       (256, 2, 4096)])
@pytest.mark.parametrize("filters", [1, 7, 33])
def test_bank_kernels_match_plain_versions_at_every_cut(cuda, family, n,
                                                        batch, g, filters):
    """Both bank kernels, batched and B = 1, at every cut: R = 130 (a
    ragged last tile), F in {1, 7, 33}, and n = 256, where 33 filters
    split into several filter groups per row tile (launcher.bank_geometry)
    both at B = 2 and at B = 1.  G within the tolerance, T bitwise."""
    if family == "sym":
        fwd, bwd, sfwd, sbwd, _ = _tables(n, batch, g, cuda)
        bank, bank1 = ksp.batched_sym_filter_bank_apply, ksp.sym_filter_bank_apply
        plain = ref.batched_sym_filter_bank_apply
        plain1 = ref.sym_filter_bank_apply
        check = _close
    else:
        fwd, bwd, sfwd, sbwd, _ = _t_tables(n, batch, g, cuda)
        bank, bank1 = ksp.batched_gen_filter_bank_apply, ksp.gen_filter_bank_apply
        plain = ref.batched_gen_filter_bank_apply
        plain1 = ref.gen_filter_bank_apply
        check = _equal
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((batch, 130, n), generator=gen, device=cuda)
    gains = _gains((batch, filters, n), cuda, n)
    for k in sorted({0, *fwd.cuts[:, 0].tolist()}):
        y = bank(fwd, bwd, gains, x, k)
        assert y.shape == (batch, filters, 130, n)
        check(y, plain(fwd, bwd, gains, x, k))
    x1 = x[0].contiguous()
    for k in sorted({0, *sfwd.cuts[:, 0].tolist()}):
        y = bank1(sfwd, sbwd, gains[0], x1, k)
        assert y.shape == (filters, 130, n)
        check(y, plain1(sfwd, sbwd, gains[0], x1, k))
    torch.cuda.synchronize()


def _equal(got, want):
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("family", ["sym", "general"])
def test_bank_filters_equal_the_operator_kernel(cuda, family):
    """Each filter slice of the bank kernel equals the operator kernel
    with that filter's gains, at every cut, batched and B = 1: T
    bitwise, G within the tolerance (the two kernels are compiled apart,
    and nvcc may contract a pair's products into FMAs differently)."""
    if family == "sym":
        fwd, bwd, sfwd, sbwd, _ = _tables(256, 2, 4096, cuda)
        bank, bank1 = ksp.batched_sym_filter_bank_apply, ksp.sym_filter_bank_apply
        op, op1 = bf.batched_sym_operator_apply, bf.sym_operator_apply
        check = _close
    else:
        fwd, bwd, sfwd, sbwd, _ = _t_tables(256, 2, 4096, cuda)
        bank, bank1 = ksp.batched_gen_filter_bank_apply, ksp.gen_filter_bank_apply
        op, op1 = sh.batched_gen_operator_apply, sh.gen_operator_apply
        check = _equal
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 130, 256), generator=gen, device=cuda)
    gains = _gains((2, 7, 256), cuda, 3)
    for k in sorted({0, *fwd.cuts[:, 0].tolist()}):
        y = bank(fwd, bwd, gains, x, k)
        for f in range(7):
            check(y[:, f], op(fwd, bwd, gains[:, f].contiguous(), x, k))
    x1 = x[0].contiguous()
    for k in sorted({0, *sfwd.cuts[:, 0].tolist()}):
        y = bank1(sfwd, sbwd, gains[0], x1, k)
        for f in range(7):
            check(y[f], op1(sfwd, sbwd, gains[0, f].contiguous(), x1, k))
    torch.cuda.synchronize()


def test_cuda_bank_plans_launch_the_bank_kernels(cuda):
    fwd, adj, _, _, _ = _tables(32, 2, 160, cuda)
    tfwd, tinv, _, _, _ = _t_tables(32, 2, 160, cuda)
    x = torch.randn((2, 5, 7, 32), device=cuda)
    gains = _gains((2, 3, 32), cuda, 4)
    launcher.reset_launch_counts()
    for f, b in ((fwd, adj), (tfwd, tinv)):
        plan = ApplyPlan.for_staged(f, "bank")
        assert plan.backend == "cuda"
        y = plan.bank(f, b, gains, x)
        assert y.shape == (2, 3, 5, 7, 32)
        y_plain = ApplyPlan.for_staged(f, "bank", backend="torch").bank(
            f, b, gains, x)
        _close(y, y_plain)
    counts = launcher.launch_counts()
    assert counts["g_bank_kernel"] == 1 and counts["t_bank_kernel"] == 1
    assert sum(counts.values()) == 2


def test_bank_wrapper_validation(cuda):
    fwd, adj, _, _, _ = _tables(16, 2, 64, cuda)
    x = torch.randn((2, 4, 16), device=cuda)
    gains = _gains((2, 3, 16), cuda, 5)
    with pytest.raises(ValueError, match="gains shape"):
        ksp.batched_sym_filter_bank_apply(fwd, adj, gains[:, :, :8], x)
    with pytest.raises(ValueError, match="at least one filter"):
        ksp.batched_sym_filter_bank_apply(fwd, adj, gains[:, :0], x)
    with pytest.raises(TypeError, match="float32"):
        ksp.batched_sym_filter_bank_apply(fwd, adj, gains.double(), x)
    with pytest.raises(TypeError, match="float32"):
        ksp.batched_sym_filter_bank_apply(fwd, adj, gains.cpu(), x)


def test_engine_serves_a_basis_fitted_on_the_card(cuda):
    """An engine built for "cuda" takes a prefit basis whose tensors lie
    on "cuda:0" and serves its bank through the bank kernel."""
    from repro_torch.core import ApproxEigenbasis, laplacian
    from repro_torch.graphs import community_graph
    from repro_torch.launch.serve import FGFTServeEngine
    laps = np.stack([laplacian(community_graph(16, seed=s))
                     for s in range(2)])
    basis = ApproxEigenbasis.fit(laps, 64, n_iter=1, device="cuda")
    assert basis.device == torch.device("cuda:0")
    eng = FGFTServeEngine(laps, basis=basis, filters="heat,tikhonov",
                          device="cuda")
    x = torch.randn((2, 5, 16), device=cuda)
    launcher.reset_launch_counts()
    y = eng.step_bank(x)
    assert y.shape == (2, 2, 5, 16)
    assert launcher.entry_launch_counts()["batched_sym_filter_bank_apply"] == 1
    _close(y[:, 1], eng.step(x, eng.bank.filters[1].response))


def _ragged_fleet(family, sizes):
    from repro_torch.core import laplacian
    from repro_torch.graphs import community_graph, directed_variant
    adjs = [community_graph(n, seed=s) for s, n in enumerate(sizes)]
    if family == "general":
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    return [laplacian(a) for a in adjs]


@pytest.mark.parametrize("family", ["sym", "general"])
def test_ragged_basis_pads_pass_through_the_kernels_bitwise(cuda, family):
    """A masked fit never selects a pad coordinate, so the chain kernel
    passes pad coordinates through bitwise (both legs), and the operator
    and bank kernels, with gains masked at the pads, give exactly 0
    there; kernel vs plain as everywhere else."""
    from repro_torch.core import ApproxEigenbasis
    from repro_torch.spectral import SpectralFilterBank, named_responses
    sizes = [12, 20, 32, 9]
    basis = ApproxEigenbasis.fit(_ragged_fleet(family, sizes), 160,
                                 n_iter=1, kind=family, device="cuda")
    assert basis.sizes.tolist() == sizes and basis.n == 32
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((4, 130, 32), generator=gen, device=cuda)
    launcher.reset_launch_counts()
    y = basis.apply(x)
    xr = basis.apply(basis.apply(x, inverse=True))
    p = basis.project(x, h=lambda lam: torch.exp(-lam))      # h(0) = 1
    bank = SpectralFilterBank(basis, named_responses("heat,tikhonov"))
    yb = bank.apply(x)
    counts = launcher.launch_counts()
    prefix = "g" if family == "sym" else "t"
    assert counts[f"{prefix}_chain_kernel"] == 3
    assert counts[f"{prefix}_operator_kernel"] == 1
    assert counts[f"{prefix}_bank_kernel"] == 1
    for b, s in enumerate(sizes):
        assert torch.equal(y[b, :, s:], x[b, :, s:])
        assert torch.equal(xr[b, :, s:], x[b, :, s:])
        assert bool((p[b, :, s:] == 0).all())
        assert bool((yb[b, :, :, s:] == 0).all())
    plain = basis.apply(x, backend="torch")
    if family == "sym":
        _close(y, plain)
    else:
        assert torch.equal(y, plain)


def test_ragged_router_serves_through_the_kernels(cuda):
    """The router builds its padded blocks on the card, launches one
    operator per bucket without a host synchronization, and returns
    cropped device tensors in request order, each equal to its bucket
    engine's plain-version output."""
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch.serve import RaggedFGFTServeEngine
    sizes = [12, 20, 32, 9, 16]
    router = RaggedFGFTServeEngine(_ragged_fleet("sym", sizes), 160,
                                   n_iter=1, tiers={"full": 1.0},
                                   device="cuda")
    assert sorted(router.engines) == [16, 32]
    gen = torch.Generator(device=cuda).manual_seed(4)
    xs = [torch.randn((7, n), generator=gen, device=cuda) for n in sizes]
    h = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
    router.step(xs, h)                      # builds the entry streams
    launcher.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")  # a step never waits on the card
    try:
        ys = router.step(xs, h)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert launcher.entry_launch_counts()["batched_sym_operator_apply"] == 2
    blocks = router._scatter(xs)
    for w, eng in router.engines.items():
        live = eng._live
        plain = ApplyPlan(family="sym", mode="operator", n=w, batched=True,
                          backend="torch", device="cuda").program()
        valid = (torch.arange(w, device=cuda)
                 < torch.as_tensor(eng.basis.sizes, device=cuda)[:, None])
        d = torch.where(valid, h(eng.tiers["full"]["spectrum"]),
                        torch.zeros((), device=cuda))
        want = plain(live.fwd, live.bwd, d, blocks[w])
        for row, pos in enumerate(router.bucket_of[w]):
            got = ys[pos]
            assert got.device.type == "cuda" and got.shape == (7, sizes[pos])
            _close(got, want[row, :, :sizes[pos]])
            assert bool((want[row, :, sizes[pos]:] == 0).all())


@pytest.mark.parametrize("family", ["sym", "general"])
def test_pinned_tables_match_plain_versions(cuda, family):
    """A dynamic engine's pinned tables (width at the structural maximum,
    depth rounded up to whole quanta, so many stages are empty): the
    operator at R = 130 and at the drift probe's R = 8, the chain on the
    identity block (the Lemma-1 refresh) and the bank (F = 7) against
    their plain versions at every cut."""
    from repro_torch.launch.serve import FGFTServeEngine
    from repro_torch.spectral import SpectralFilterBank, named_responses
    n = 32
    laps = np.stack(_ragged_fleet(family, [n] * 3))
    eng = FGFTServeEngine(laps, 160, n_iter=1, kind=family, dynamic=True,
                          tiers={"full": 1.0}, device="cuda")
    fwd, bwd = eng.basis.fwd, eng.basis.bwd
    assert fwd.idx_i.shape[-1] == (n // 2 if family == "sym" else n)
    assert fwd.num_stages % eng._stage_pad[0] == 0
    gen = torch.Generator(device=cuda).manual_seed(5)
    diag = eng.basis.spectrum
    gains = SpectralFilterBank(
        eng.basis, named_responses("heat,tikhonov,wavelets:4")).gains()
    eye = torch.eye(n, device=cuda).expand(3, n, n).contiguous()
    mod = bf if family == "sym" else sh
    op = (mod.batched_sym_operator_apply if family == "sym"
          else mod.batched_gen_operator_apply)
    chain = (bf.batched_butterfly_apply if family == "sym"
             else sh.batched_shear_apply)
    bank = (ksp.batched_sym_filter_bank_apply if family == "sym"
            else ksp.batched_gen_filter_bank_apply)
    plain_op = (ref.batched_sym_operator_apply if family == "sym"
                else ref.batched_gen_operator_apply)
    plain_chain = ref.batched_g_apply if family == "sym" else ref.batched_t_apply
    plain_bank = (ref.batched_sym_filter_bank_apply if family == "sym"
                  else ref.batched_gen_filter_bank_apply)

    def check(got, want):
        if family == "sym":
            _close(got, want)
        else:                           # the T kernels: bitwise
            assert torch.equal(got, want)
    for rows in (130, 8):
        x = torch.randn((3, rows, n), generator=gen, device=cuda)
        for k in [None, *fwd.cuts[:, 0].tolist()]:
            check(op(fwd, bwd, diag, x, k), plain_op(fwd, bwd, diag, x, k))
            check(bank(fwd, bwd, gains, x, k),
                  plain_bank(fwd, bwd, gains, x, k))
    for keep in ("head", "tail"):
        check(chain(fwd, eye, None, keep), plain_chain(fwd, eye, None, keep))
    torch.cuda.synchronize()


def test_drift_probe_runs_one_operator_launch(cuda):
    """The Hutchinson pass on the card: one batched operator launch with
    the probes as its 8 signal rows, equal to the same pass through the
    plain operator on the same probes."""
    from repro_torch.core import ApproxEigenbasis
    from repro_torch.dynamic import estimate_rel_residual
    from repro_torch.dynamic.drift import _rademacher, _residual_program
    from repro_torch.core.staging import table_arrays
    laps = np.stack(_ragged_fleet("sym", [24] * 4))
    basis = ApproxEigenbasis.fit(laps, 96, n_iter=1, stage_pad=(4, 8),
                                 device="cuda")
    launcher.reset_launch_counts()
    est = estimate_rel_residual(basis, laps, num_probes=8, seed=3)
    assert launcher.entry_launch_counts()["batched_sym_operator_apply"] == 1
    plain = _residual_program(ApplyPlan(family="sym", mode="operator", n=24,
                                        batched=True, backend="torch",
                                        device="cuda"), 8)
    want = plain(table_arrays(basis.fwd), table_arrays(basis.bwd),
                 basis.spectrum, torch.from_numpy(laps).to(cuda),
                 _rademacher(8, 24, 3, cuda)).cpu().numpy()
    np.testing.assert_allclose(est, want, rtol=1e-4, atol=1e-7)


def test_dynamic_engine_step_never_waits(cuda):
    """A dynamic engine serves without a host synchronization before and
    after a hot swap; a REFRESH swap reuses the cached entry streams and
    an EXTEND swap builds them once per leg."""
    from repro_torch.dynamic import GraphStream, RefitPolicy
    from repro_torch.graphs import community_graph, edge_perturbation
    from repro_torch.launch.serve import FGFTServeEngine
    stream = GraphStream([community_graph(32, seed=s) for s in range(3)])
    eng = FGFTServeEngine(np.stack(stream.laplacians()), 160, n_iter=1,
                          dynamic=True, tiers={"full": 1.0, "draft": 0.25},
                          policy=RefitPolicy(refresh=1e-6, extend=10.0,
                                             refit=20.0), device="cuda")
    x = torch.randn((3, 7, 32), device=cuda)
    h = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
    eng.warmup(x)
    for action in ("refresh", "extend"):
        if action == "extend":
            eng.controller.policy = RefitPolicy(refresh=1e-7, extend=1e-6,
                                                refit=20.0)
        eng.apply_updates(1, stream.apply(1, edge_perturbation(
            stream.adjs[1], 12, seed=1)))
        assert eng.maintain()["action"] == action
        eng.step(x, h)                          # builds a new leg's stream
        torch.cuda.synchronize()
        launcher.reset_stream_cache_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = eng.step(x, h)
            eng.step(x, h, tier="draft")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert launcher.stream_cache_counts() == {"hits": 4, "misses": 0}
        live = eng._live
        plain = ApplyPlan(family="sym", mode="operator", n=32, batched=True,
                          backend="torch", device="cuda").program()
        _close(y, plain(live.fwd, live.bwd, h(live.tiers["full"]["spectrum"]),
                        x))


# ---------------------------------------------------------------------------
# bf16 value tables: the kernels' bf16 forms
# ---------------------------------------------------------------------------

def _bf16_pair(family, n, batch, g, device):
    """(fwd, bwd) f32 tables of random chains and their bf16 casts."""
    if family == "sym":
        fwd, bwd, _, _, _ = _tables(n, batch, g, device)
    else:
        fwd, bwd, _, _, _ = _t_tables(n, batch, g, device)
    return (fwd, bwd), tuple(tst.with_precision(t, "bf16")
                             for t in (fwd, bwd))


@pytest.mark.parametrize("family", ["sym", "general"])
@pytest.mark.parametrize("n,batch,g", [(16, 3, 64), (48, 2, 200),
                                       (256, 2, 4096)])
def test_bf16_forms_match_plain_versions_at_every_cut(cuda, family, n, batch,
                                                      g):
    """Every entry point's bf16 form against its plain version on the
    same bf16 tables (G within the tolerance, T bitwise) and against its
    f32 form on the widened tables, chain at both keeps, operator, and
    bank at F in {1, 7, 33}, batched and B = 1."""
    (f32, b32), (fwd, bwd) = _bf16_pair(family, n, batch, g, cuda)
    wide = tuple(tst.with_precision(t, "f32") for t in (fwd, bwd))
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((batch, 130, n), generator=gen, device=cuda)
    diag = torch.rand((batch, n), generator=gen, device=cuda) * 2.0
    gains = torch.rand((batch, 33, n), generator=gen, device=cuda) * 2.0
    mod, pre = (bf, "g") if family == "sym" else (sh, "t")
    chain = bf.batched_butterfly_apply if family == "sym" else \
        sh.batched_shear_apply
    chain_ref = ref.batched_g_apply if family == "sym" else \
        ref.batched_t_apply
    op = (bf.batched_sym_operator_apply if family == "sym"
          else sh.batched_gen_operator_apply)
    op_ref = (ref.batched_sym_operator_apply if family == "sym"
              else ref.batched_gen_operator_apply)
    bank = (ksp.batched_sym_filter_bank_apply if family == "sym"
            else ksp.batched_gen_filter_bank_apply)
    bank_ref = (ref.batched_sym_filter_bank_apply if family == "sym"
                else ref.batched_gen_filter_bank_apply)
    same = _close if family == "sym" else \
        (lambda got, want: torch.testing.assert_close(got, want, rtol=0,
                                                      atol=0))
    launcher.reset_launch_counts()
    for k in sorted({0, *fwd.cuts[:, 0].tolist()}):
        for staged, w in ((fwd, wide[0]), (bwd, wide[1])):
            for keep in ("head", "tail"):
                y = chain(staged, x, k, keep)
                same(y, chain_ref(staged, x, k, keep))
                same(y, chain(w, x, k, keep))
        y = op(fwd, bwd, diag, x, k)
        same(y, op_ref(fwd, bwd, diag, x, k))
        same(y, op(*wide, diag, x, k))
        for f in (1, 7, 33):
            gf = gains[:, :f].contiguous()
            y = bank(fwd, bwd, gf, x, k)
            same(y, bank_ref(fwd, bwd, gf, x, k))
            same(y, bank(*wide, gf, x, k))
    counts = launcher.launch_counts()
    assert counts[f"{pre}_chain_bf16_kernel"] > 0
    assert counts[f"{pre}_operator_bf16_kernel"] > 0
    assert counts[f"{pre}_bank_bf16_kernel"] > 0
    x1 = x[0].contiguous()
    sf, sb = (type(t)(*(a[0].contiguous() for a in tst.table_arrays(t)),
                      t.cuts, t.n) for t in (fwd, bwd))
    for k in sorted({0, *fwd.cuts[:, 0].tolist()}):
        single = mod.butterfly_apply if family == "sym" else mod.shear_apply
        single_ref = (ref.staged_g_apply if family == "sym"
                      else ref.staged_t_apply)
        same(single(sf, x1, k, "tail"), single_ref(sf, x1, k, "tail"))
        sop = (bf.sym_operator_apply if family == "sym"
               else sh.gen_operator_apply)
        sop_ref = (ref.sym_operator_apply if family == "sym"
                   else ref.gen_operator_apply)
        same(sop(sf, sb, diag[0], x1, k), sop_ref(sf, sb, diag[0], x1, k))
        sbank = (ksp.sym_filter_bank_apply if family == "sym"
                 else ksp.gen_filter_bank_apply)
        sbank_ref = (ref.sym_filter_bank_apply if family == "sym"
                     else ref.gen_filter_bank_apply)
        g1 = gains[0].contiguous()
        same(sbank(sf, sb, g1, x1, k), sbank_ref(sf, sb, g1, x1, k))
    torch.cuda.synchronize()
    assert launcher.entry_launch_counts()[
        launcher.form("sym_filter_bank_apply" if family == "sym"
                      else "gen_filter_bank_apply", "bf16")] > 0


@pytest.mark.parametrize("family", ["sym", "general"])
def test_bf16_batches_split_at_the_grid_limit(cuda, family, monkeypatch):
    """The bf16 value tables advance 2 bytes a slot: a split launch on
    offset pointers equals the unsplit one."""
    _, (fwd, bwd) = _bf16_pair(family, 48, 7, 200, cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((7, 130, 48), generator=gen, device=cuda)
    diag = torch.rand((7, 48), generator=gen, device=cuda)
    gains = torch.rand((7, 5, 48), generator=gen, device=cuda)
    mod = bf if family == "sym" else sh
    names = (("batched_butterfly_apply", "batched_sym_operator_apply",
              "batched_sym_filter_bank_apply") if family == "sym" else
             ("batched_shear_apply", "batched_gen_operator_apply",
              "batched_gen_filter_bank_apply"))
    k = int(fwd.cuts[1, 0])
    calls = (lambda: getattr(mod, names[0])(fwd, x, k, "tail"),
             lambda: getattr(mod, names[1])(fwd, bwd, diag, x, k),
             lambda: getattr(ksp, names[2])(fwd, bwd, gains, x, k))
    whole = [c() for c in calls]
    monkeypatch.setattr(launcher, "_GRID_B", 3)
    launcher.reset_launch_counts()
    split = [c() for c in calls]
    counts = launcher.entry_launch_counts()
    for name, got, want in zip(names, split, whole):
        assert torch.equal(got, want)
        assert counts[launcher.form(name, "bf16")] == 3


def test_bf16_plans_launch_the_bf16_forms(cuda):
    (fwd, adj), _ = _bf16_pair("sym", 32, 2, 160, cuda)
    x = torch.randn((2, 5, 7, 32), device=cuda)
    diag = torch.rand((2, 32), device=cuda)
    launcher.reset_launch_counts()
    plan = ApplyPlan.for_staged(fwd, "operator", precision="bf16")
    y = plan.operator(fwd, adj, diag, x)
    again = plan.operator(fwd, adj, diag, x)
    assert torch.equal(y, again)
    y32 = ApplyPlan.for_staged(fwd, "operator").operator(fwd, adj, diag, x)
    assert float((y - y32).abs().max()) <= 0.03 * float(y32.abs().max())
    counts = launcher.entry_launch_counts()
    assert counts["batched_sym_operator_apply_bf16"] == 2
    assert counts["batched_sym_operator_apply"] == 1
    with pytest.raises(TypeError, match="float32"):
        bf.batched_sym_operator_apply(fwd, adj, diag,
                                      x[:, 0].to(torch.bfloat16))



def test_async_service_on_the_card(cuda):
    """The async front end on the card: one operator launch per fused
    dispatch, every answer equal to ``step_versioned`` on the request
    alone, and every maintenance tick on the service's own stream (not
    the dispatcher's)."""
    from repro_torch.core.fgft import laplacian
    from repro_torch.dynamic import RefitPolicy
    from repro_torch.graphs import erdos_renyi, weight_jitter
    from repro_torch.launch.serve import FGFTServeEngine
    from repro_torch.launch.service import AsyncFGFTService
    adjs = [erdos_renyi(16, 0.4, seed=s) for s in range(3)]
    engine = FGFTServeEngine(np.stack([laplacian(a) for a in adjs]), 48,
                             n_iter=1, dynamic=True,
                             policy=RefitPolicy(refresh=1e-9, extend=10.0,
                                                refit=10.0), device=cuda)
    ticks = []
    real = engine.maintain

    def spy():
        ticks.append(torch.cuda.current_stream(cuda).cuda_stream)
        return real()

    engine.maintain = spy
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 16)).astype(np.float32) for _ in range(12)]
    with AsyncFGFTService(engine, max_batch=4) as svc:
        launcher.reset_launch_counts()
        results = [f.result(timeout=60) for f in
                   [svc.submit(k % 3, x) for k, x in enumerate(xs)]]
        stats = svc.stats()
        assert launcher.entry_launch_counts()[
            "batched_sym_operator_apply"] == stats["dispatches"]
        for k, (x, res) in enumerate(zip(xs, results)):
            block = torch.zeros((3, 8, 16), device=cuda)
            block[k % 3, :2] = torch.from_numpy(x).to(cuda)
            y, v = engine.step_versioned(block, tier="full")
            assert v == res.version == 0
            _close(torch.from_numpy(res.y).to(cuda), y[k % 3, :2])
        engine.apply_updates(1, weight_jitter(adjs[1], 6, scale=0.2,
                                              seed=1))
        assert svc.maintain_now(timeout=60)["action"] == "refresh"
        assert engine._live.version == 1
        stream = svc.maintain_stream.cuda_stream
    assert ticks and set(ticks) == {stream}
    assert stream != torch.cuda.default_stream(cuda).cuda_stream
