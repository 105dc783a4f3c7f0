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


def _close(got, want, floor=1.0):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    tol = 1e-4 * max(floor, float(want.abs().max()))
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
    # a bf16 signal on the f32 tables is computed in bf16: the operator's
    # bf16-signal form, bitwise its plain version
    xs = x[:, 0].to(torch.bfloat16)
    launcher.reset_launch_counts()
    ys = bf.batched_sym_operator_apply(fwd, adj, diag, xs)
    assert ys.dtype == torch.bfloat16
    assert torch.equal(ys, ref.batched_sym_operator_apply(fwd, adj, diag,
                                                          xs))
    assert launcher.entry_launch_counts()[
        "batched_sym_operator_apply_xbf16"] == 1


# ---------------------------------------------------------------------------
# bf16 signals: the kernels' bf16-signal forms
# ---------------------------------------------------------------------------

#: mode -> the family's (batched, B = 1) wrappers and plain versions
_X_MODES = {
    "sym": {"chain": (bf.batched_butterfly_apply, bf.butterfly_apply,
                      ref.batched_g_apply, ref.staged_g_apply),
            "operator": (bf.batched_sym_operator_apply,
                         bf.sym_operator_apply,
                         ref.batched_sym_operator_apply,
                         ref.sym_operator_apply),
            "bank": (ksp.batched_sym_filter_bank_apply,
                     ksp.sym_filter_bank_apply,
                     ref.batched_sym_filter_bank_apply,
                     ref.sym_filter_bank_apply)},
    "general": {"chain": (sh.batched_shear_apply, sh.shear_apply,
                          ref.batched_t_apply, ref.staged_t_apply),
                "operator": (sh.batched_gen_operator_apply,
                             sh.gen_operator_apply,
                             ref.batched_gen_operator_apply,
                             ref.gen_operator_apply),
                "bank": (ksp.batched_gen_filter_bank_apply,
                         ksp.gen_filter_bank_apply,
                         ref.batched_gen_filter_bank_apply,
                         ref.gen_filter_bank_apply)}}


def _first(staged):
    """The B = 1 tables of matrix 0."""
    return type(staged)(*(a[0].contiguous() for a in tst.table_arrays(staged)),
                        staged.cuts, staged.n)


@pytest.mark.parametrize("mode", ["chain", "operator", "bank"])
@pytest.mark.parametrize("family", ["sym", "general"])
@pytest.mark.parametrize("n,batch,g", [(16, 3, 64), (48, 2, 200),
                                       (256, 2, 4096)])
def test_bf16_signal_forms_equal_plain_versions_bitwise(cuda, family, mode,
                                                        n, batch, g):
    """A bf16 signal through the mode's entry points, batched and B = 1,
    on f32 and on bf16 value tables, at every cut (chains at both keeps,
    banks at F in {1, 7, 33}): the bf16-signal forms round every
    operation as their plain versions do, so they are bitwise equal, and
    each form counts its launches."""
    tables = _bf16_pair(family, n, batch, g, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((batch, 130, n), generator=gen, device=cuda).to(
        torch.bfloat16)
    diag = torch.rand((batch, n), generator=gen, device=cuda) * 2.0
    gains = torch.rand((batch, 33, n), generator=gen, device=cuda) * 2.0
    fn, fn1, plain, plain1 = _X_MODES[family][mode]
    names = {"sym": {"chain": "butterfly_apply",
                     "operator": "sym_operator_apply",
                     "bank": "sym_filter_bank_apply"},
             "general": {"chain": "shear_apply",
                         "operator": "gen_operator_apply",
                         "bank": "gen_filter_bank_apply"}}[family][mode]

    def cases(fwd, bwd, d, g, xin, k):
        if mode == "chain":
            return [(staged, xin, k, keep) for staged in (fwd, bwd)
                    for keep in ("head", "tail")]
        if mode == "operator":
            return [(fwd, bwd, d, xin, k)]
        return [(fwd, bwd, g[..., :f, :].contiguous(), xin, k)
                for f in (1, 7, 33)]
    for precision, (fwd, bwd) in zip(("f32", "bf16"), tables):
        launcher.reset_launch_counts()
        calls = 0
        for k in sorted({0, *fwd.cuts[:, 0].tolist()}):
            for args in cases(fwd, bwd, diag, gains, x, k):
                y = fn(*args)
                assert y.dtype == torch.bfloat16
                assert torch.equal(y, plain(*args))
                calls += 1
            for args in cases(_first(fwd), _first(bwd), diag[0], gains[0],
                              x[0].contiguous(), k):
                y = fn1(*args)
                assert y.dtype == torch.bfloat16
                assert torch.equal(y, plain1(*args))
                calls += 1
        torch.cuda.synchronize()
        counts = launcher.entry_launch_counts()
        got = (counts[launcher.form("batched_" + names, precision, "bf16")]
               + counts[launcher.form(names, precision, "bf16")])
        assert got == calls
        kernel = launcher.KERNEL_OF[launcher.form(names, precision, "bf16")]
        assert kernel.endswith("_xbf16_kernel")
        assert launcher.launch_counts()[kernel] == calls


@pytest.mark.parametrize("family", ["sym", "general"])
def test_bf16_signal_batches_split_at_the_grid_limit(cuda, family,
                                                     monkeypatch):
    """A bf16 signal advances 2 bytes an element: each mode's split
    launch on offset pointers equals the unsplit one, on f32 and bf16
    tables."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((7, 130, 48), generator=gen, device=cuda).to(
        torch.bfloat16)
    diag = torch.rand((7, 48), generator=gen, device=cuda)
    gains = torch.rand((7, 5, 48), generator=gen, device=cuda)
    fn = [_X_MODES[family][m][0] for m in ("chain", "operator", "bank")]
    for precision, (fwd, bwd) in zip(
            ("f32", "bf16"), _bf16_pair(family, 48, 7, 200, cuda)):
        k = int(fwd.cuts[1, 0])
        calls = (lambda: fn[0](fwd, x, k, "tail"),
                 lambda: fn[1](fwd, bwd, diag, x, k),
                 lambda: fn[2](fwd, bwd, gains, x, k))
        whole = [c() for c in calls]
        monkeypatch.setattr(launcher, "_GRID_B", 3)
        launcher.reset_launch_counts()
        split = [c() for c in calls]
        monkeypatch.undo()
        assert sum(launcher.entry_launch_counts().values()) == 9
        for got, want in zip(split, whole):
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, want)



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


# ---------------------------------------------------------------------------
# fleet placement: pad rows and batch shards through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["sym", "general"])
def test_pad_rows_through_the_kernels(cuda, family, precision):
    """``pad_batch`` tables (5 -> 8 rows) through chain, operator and bank
    kernels: the real rows bitwise the unpadded launch, a pad row bitwise
    its input through the chain and exactly 0 through the operator and
    the bank on a zero spectrum and zero gains (a row of no real entry:
    an empty entry stream and zero stage extents)."""
    make = _tables if family == "sym" else _t_tables
    fwd, bwd, _, _, diag = make(48, 5, 200, cuda)
    fwd, bwd = (tst.with_precision(t, precision) for t in (fwd, bwd))
    pf, pb = tst.pad_batch(fwd, 8), tst.pad_batch(bwd, 8)
    words, offsets = launcher.entry_stream(pf)
    assert bool((offsets[5:] == offsets[5:, :1]).all())
    assert int(launcher.stage_extents(pf)[5:].abs().sum()) == 0
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((8, 40, 48), generator=gen, device=cuda)
    dpad = torch.cat([diag, diag.new_zeros(3, 48)])
    gains = torch.cat([_gains((5, 7, 48), cuda, 4),
                       torch.zeros((3, 7, 48), device=cuda)])
    kw = dict(family=family, n=48, batched=True, precision=precision,
              device="cuda")
    ap = ApplyPlan(mode="apply", **kw)
    launcher.reset_launch_counts()
    y = ap.apply(pf, x)
    form = launcher.form("batched_butterfly_apply" if family == "sym"
                         else "batched_shear_apply", precision)
    assert launcher.entry_launch_counts()[form] == 1
    _equal(y[:5], ap.apply(fwd, x[:5].contiguous()))
    _equal(y[5:], x[5:])
    op = ApplyPlan(mode="operator", **kw)
    y = op.operator(pf, pb, dpad, x)
    _equal(y[:5], op.operator(fwd, bwd, diag, x[:5].contiguous()))
    assert not bool(y[5:].any())
    bk = ApplyPlan(mode="bank", **kw)
    y = bk.bank(pf, pb, gains, x)
    _equal(y[:5], bk.bank(fwd, bwd, gains[:5].contiguous(),
                          x[:5].contiguous()))
    assert not bool(y[5:].any())
    torch.cuda.synchronize()


@pytest.mark.parametrize("family", ["sym", "general"])
def test_fit_on_a_mesh_is_bitwise_on_the_card(cuda, family):
    """``fit(mesh=)`` on 4 logical devices of the card: each shard of 2
    graphs fitted alone gives the whole batch's factors, spectrum and
    objective bitwise.  The objective's sum of squares runs as two passes
    of n (``gtransform._sq_sum``), each row's order independent of the
    number of rows reduced together."""
    from repro_torch.core import ApproxEigenbasis
    from repro_torch.core import gtransform as gt
    from repro_torch.core.fgft import laplacian
    from repro_torch.graphs import community_graph, directed_variant
    from repro_torch.launch.mesh import logical_devices, make_local_mesh
    gen = torch.Generator(device=cuda).manual_seed(6)
    for n in (64, 256):
        d = torch.randn((8, n, n), generator=gen, device=cuda)
        for lo in range(0, 8, 2):
            _equal(gt._sq_sum(d[lo:lo + 2].clone()), gt._sq_sum(d)[lo:lo + 2])
    n, g = (64, 256) if family == "sym" else (32, 64)
    adjs = [community_graph(n, seed=40 + s) for s in range(8)]
    if family == "general":
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    laps = np.stack([laplacian(a) for a in adjs])
    with logical_devices(4, "cuda"):
        mesh = make_local_mesh()
    flat = ApproxEigenbasis.fit(laps, g, n_iter=1, kind=family, device=cuda)
    placed = ApproxEigenbasis.fit(laps, g, n_iter=1, kind=family,
                                  mesh=mesh, device=cuda)
    for a, b in zip(flat.factors + (flat.spectrum, flat.objective),
                    placed.factors + (placed.spectrum, placed.objective)):
        _equal(b, a)
    ext_flat, ext = flat.extend(laps, g + 32), flat.extend(laps, g + 32,
                                                          mesh=mesh)
    for a, b in zip(ext_flat.factors + (ext_flat.spectrum,),
                    ext.factors + (ext.spectrum,)):
        _equal(b, a)


@pytest.mark.parametrize("family", ["sym", "general"])
def test_placed_engine_on_logical_shards_of_the_card(cuda, family):
    """An engine placed on 4 logical devices of the one card: every tier,
    ``step_versioned`` and the bank bitwise the unplaced engine's, one
    launch per shard per dispatch, every shard's tables their own
    contiguous tensors."""
    from repro_torch.core import ApproxEigenbasis
    from repro_torch.core.fgft import laplacian
    from repro_torch.graphs import community_graph, directed_variant
    from repro_torch.launch.mesh import logical_devices, make_local_mesh
    from repro_torch.launch.serve import FGFTServeEngine
    from repro_torch.runtime.sharding import single_bucket_placement
    adjs = [community_graph(32, seed=s) for s in range(6)]
    if family == "general":
        adjs = [directed_variant(a, seed=s) for s, a in enumerate(adjs)]
    laps = np.stack([laplacian(a) for a in adjs])
    basis = ApproxEigenbasis.fit(laps, 64, n_iter=1, kind=family,
                                 device=cuda)
    tiers = {"full": 1.0, "balanced": 0.5, "draft": 0.25}
    flat = FGFTServeEngine(laps, basis=basis, tiers=tiers,
                           filters="heat,tikhonov", device=cuda)
    with logical_devices(4, "cuda"):
        mesh = make_local_mesh()
    placed = FGFTServeEngine(laps, basis=basis, tiers=tiers,
                             filters="heat,tikhonov", device=cuda,
                             placement=single_bucket_placement(mesh, 6))
    ptrs = [t.data_ptr() for shard in placed._live.fwd for t in shard]
    assert len(set(ptrs)) == len(ptrs) == 4 * len(placed._live.fwd[0])
    assert all(t.is_contiguous() for shard in placed._live.fwd
               for t in shard)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((6, 24, 32), generator=gen, device=cuda)
    op = "batched_sym_operator_apply" if family == "sym" else \
        "batched_gen_operator_apply"
    bank = "batched_sym_filter_bank_apply" if family == "sym" else \
        "batched_gen_filter_bank_apply"
    lowpass = lambda lam: 1.0 / (1.0 + lam)  # noqa: E731
    for tier in tiers:
        want = flat.step(x, lowpass, tier=tier)
        launcher.reset_launch_counts()
        got = placed.step(x, lowpass, tier=tier)
        assert launcher.entry_launch_counts()[op] == 4
        _equal(got, want)
        _equal(placed.step_versioned(x, tier=tier)[0],
               flat.step_versioned(x, tier=tier)[0])
    want = flat.step_bank(x)
    launcher.reset_launch_counts()
    got = placed.step_bank(x)
    assert launcher.entry_launch_counts()[bank] == 4
    _equal(got, want)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the rest of repro.core: compressed linear, baselines, butterfly layer;
# the tile dial
# ---------------------------------------------------------------------------

def test_compressed_linear_kernels_match_plain_at_1024(cuda):
    """compressed_linear_apply at n = 1024 (random chains): one operator
    and one chain launch a call, equal to its plain version."""
    from repro_torch.core import compressed_linear_apply
    from repro_torch.interop import compressed_linear_from_numpy
    n, g = 1024, 4096
    chains = [_chain_fields(n, g, seed) for seed in (1, 2)]
    diag = np.random.default_rng(3).uniform(0.0, 2.0, n).astype(np.float32)
    comp = compressed_linear_from_numpy(*chains, diag, n, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4096, n), generator=gen, device=cuda)
    launcher.reset_launch_counts()
    y = compressed_linear_apply(comp, x)
    torch.cuda.synchronize()
    got = {k: v for k, v in launcher.entry_launch_counts().items() if v}
    assert got == {"sym_operator_apply": 1, "butterfly_apply": 1}
    _close(y, compressed_linear_apply(comp, x, backend="torch"))
    for entry in got:
        geo = launcher.launch_geometry(entry, 1, 4096, n)
        assert geo["resident_per_sm"] >= 1 and geo["ctas"] >= 1


def _chain_fields(n, g, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, g)
    b = (a + rng.integers(1, n, g)) % n
    theta = rng.uniform(-np.pi, np.pi, g)
    return {"i": np.minimum(a, b).astype(np.int32),
            "j": np.maximum(a, b).astype(np.int32),
            "c": np.cos(theta).astype(np.float32),
            "s": np.sin(theta).astype(np.float32),
            "sigma": rng.choice([-1.0, 1.0], g).astype(np.float32)}


@pytest.mark.parametrize("n,batch,g", [(48, 3, 200), (256, 2, 4096)])
def test_every_entry_point_is_bitwise_at_each_block_b(cuda, n, batch, g):
    """Every geometry gives the same bits: each of the 12 entry points
    (and the batched G operator's bf16-table and bf16-signal forms) at
    each tile equals its block_b=None launch."""
    gf, ga, sgf, sga, d = _tables(n, batch, g, cuda)
    tf, ti, stf, sti, _ = _t_tables(n, batch, g, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((batch, 130, n), generator=gen, device=cuda)
    gains = _gains((batch, 7, n), cuda, 2)
    x1 = x[0].contiguous()
    bgf, bga = (tst.with_precision(t, "bf16") for t in (gf, ga))
    calls = [
        (bf.batched_butterfly_apply, (gf, x)),
        (bf.butterfly_apply, (sgf, x1)),
        (bf.batched_sym_operator_apply, (gf, ga, d, x)),
        (bf.sym_operator_apply, (sgf, sga, d[0], x1)),
        (sh.batched_shear_apply, (tf, x)),
        (sh.shear_apply, (stf, x1)),
        (sh.batched_gen_operator_apply, (tf, ti, d, x)),
        (sh.gen_operator_apply, (stf, sti, d[0], x1)),
        (ksp.batched_sym_filter_bank_apply, (gf, ga, gains, x)),
        (ksp.sym_filter_bank_apply, (sgf, sga, gains[0], x1)),
        (ksp.batched_gen_filter_bank_apply, (tf, ti, gains, x)),
        (ksp.gen_filter_bank_apply, (stf, sti, gains[0], x1)),
        (bf.batched_sym_operator_apply, (bgf, bga, d, x)),
        (bf.batched_sym_operator_apply, (gf, ga, d, x.to(torch.bfloat16))),
    ]
    for fn, args in calls:
        want = fn(*args)
        for block_b in (1, 8, 32, 64, 128, 256):
            assert torch.equal(fn(*args, block_b=block_b), want), \
                (fn.__name__, block_b)
    with pytest.raises(ValueError, match="block_b must be positive"):
        bf.batched_butterfly_apply(gf, x, block_b=0)
    torch.cuda.synchronize()


def test_cuda_plan_launches_the_cached_tile(cuda, tmp_path, monkeypatch):
    from repro_torch.kernels import autotune
    from repro_torch.kernels.plan import clear_plan_cache
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "a.json"))
    gf, ga, _, _, d = _tables(48, 3, 200, cuda)
    x = torch.randn((3, 130, 48), device=cuda)
    plan = ApplyPlan(family="sym", mode="operator", n=48, batched=True,
                     device=cuda)
    seen = []
    real = launcher._operator_geometry_on

    def spy(*a):
        seen.append(a[-1])
        return real(*a)
    monkeypatch.setattr(launcher, "_operator_geometry_on", spy)
    clear_plan_cache()
    y = plan.operator(gf, ga, d, x)
    best = autotune.autotune_block_b(
        plan, (plan.prepare(gf), plan.prepare(ga), d, x),
        candidates=(32, 64), repeats=2)
    clear_plan_cache()
    seen.clear()
    assert torch.equal(plan.operator(gf, ga, d, x), y)
    assert seen == [best]
    clear_plan_cache()


def test_truncated_jacobi_on_the_card_matches_the_cpu(cuda):
    """The greedy loops on the card (no host sync) pick the CPU port's
    pairs; values within 1e-5, spectrum within 1e-4."""
    from repro_torch.core import factorize_orthonormal, truncated_jacobi
    rng = np.random.default_rng(24)
    a = rng.standard_normal((24, 24)).astype(np.float32)
    s = torch.from_numpy(a + a.T)
    q = torch.from_numpy(np.linalg.qr(rng.standard_normal((24, 24)))[0]
                         .astype(np.float32))
    s_card, q_card = s.to(cuda), q.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fj, spec = truncated_jacobi(s_card, 72)
        fo = factorize_orthonormal(q_card, 96)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cj, cspec = truncated_jacobi(s, 72)
    co = factorize_orthonormal(q, 96)
    for got, want in ((fj, cj), (fo, co)):
        for k, (a_, b_) in enumerate(zip(got, want)):
            if k < 2:
                assert torch.equal(a_.cpu(), b_)
            else:
                assert float((a_.cpu() - b_).abs().max()) <= 1e-5
    assert float((spec.cpu() - cspec).abs().max()) <= 1e-4


@pytest.mark.parametrize("n", [24, 1024])
def test_butterfly_layer_gradients_on_the_card(cuda, n):
    from repro_torch.core import ButterflyParams, butterfly_apply, fft_pattern
    rng = np.random.default_rng(n)
    pat = fft_pattern(n, device="cpu")
    theta = torch.from_numpy(rng.normal(0, 1, tuple(pat.idx_i.shape))
                             .astype(np.float32))
    diag = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((64, n)).astype(np.float32))

    def grads(device):
        p = ButterflyParams(theta.to(device).requires_grad_(True),
                            diag.to(device).requires_grad_(True))
        xx = x.to(device).requires_grad_(True)
        pt = pat._replace(idx_i=pat.idx_i.to(device),
                          idx_j=pat.idx_j.to(device))
        (butterfly_apply(p, pt, xx) ** 2).sum().backward()
        return [t.grad.cpu() for t in (*p, xx)]
    for got, want in zip(grads(cuda), grads("cpu")):
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())


# ---------------------------------------------------------------------------
# the LM serving path (repro_torch.models, ServeEngine) at full width
# ---------------------------------------------------------------------------

def _lm(arch, dtype, cuda, layers=2):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(arch).replace(n_layers=layers, dtype=dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    return tfm.Transformer(cfg, tfm.init_params(cfg, gen, cuda))


def _lm_bound(logits, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    return tol * max(1.0, float(logits.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-27b"])
def test_lm_decode_matches_forward_on_the_card(cuda, arch, dtype):
    """Prefill + one decode against the forward of the extended sequence
    at full width (2 layers), the cache in the compute dtype."""
    from repro_torch.models import transformer as tfm
    model = _lm(arch, dtype, cuda)
    b, s = 2, 32
    toks = np.random.default_rng(2).integers(0, model.cfg.vocab, (b, s))
    cache = tfm.init_cache(model.cfg, b, 64, cuda, dtype=dtype)
    logits_p, cache, _ = model.prefill(cache, toks)
    tok = logits_p[:, -1].argmax(-1)[:, None]
    logits_d, _ = model.decode_step(cache, tok, torch.full((b,), s))
    logits_f = model.forward(np.concatenate([toks, tok.cpu().numpy()], 1))
    bound = _lm_bound(logits_f, dtype)
    assert bool(torch.isfinite(logits_f.float()).all())
    assert float((logits_f[:, s - 1] - logits_p[:, 0]).abs().max()) <= bound
    assert float((logits_f[:, s] - logits_d[:, 0]).abs().max()) <= bound


def test_lm_slots_give_each_request_what_it_gets_alone(cuda):
    """Six requests through four slots of a full-width qwen2-1.5b (2
    layers, bf16) against each request alone in one slot, fed the same
    tokens: prefill is slot-local."""
    from repro_torch.launch import serve
    model = _lm("qwen2-1.5b", torch.bfloat16, cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab, 10).astype(np.int32)
               for _ in range(6)]
    seen = {}

    def on_logits(rid, logits):
        seen.setdefault(rid, []).append(logits.clone())

    out = serve.run_requests(serve.ServeEngine(model.cfg, 4, 32,
                                               model=model),
                             prompts, 6, on_logits=on_logits)["outputs"]
    alone = serve.ServeEngine(model.cfg, 1, 32, model=model)
    for rid, prompt in enumerate(prompts):
        alone.prefill_slot(0, prompt)
        got = [alone.logits[0].clone()]
        for step in range(1, 6):
            alone.decode(np.array([out[rid][step - 1]], np.int32))
            got.append(alone.logits[0].clone())
        for g, w in zip(got, seen[rid]):
            bound = _lm_bound(w, torch.bfloat16)
            assert float((g.float() - w.float()).abs().max()) <= bound


# ---------------------------------------------------------------------------
# the MoE, SSM, hybrid, vision and audio families (small, f32)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "mamba2-780m",
                "recurrentgemma-2b", "llama-3.2-vision-90b",
                "seamless-m4t-large-v2"]
#: block -> (module, spec, the smoke config it is built for)
FAMILY_BLOCKS = {"cross": ("CrossAttnBlock", "cross_attn_spec",
                           "llama-3.2-vision-90b"),
                 "moe": ("MoEBlock", "moe_spec", "qwen3-moe-30b-a3b"),
                 "ssd": ("SSDBlock", "ssd_spec", "mamba2-780m"),
                 "rglru": ("RGLRUBlock", "rglru_spec", "recurrentgemma-2b")}


def _family_tree(tree, device):
    return {k: (_family_tree(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in tree.items()}


@pytest.mark.parametrize("block", list(FAMILY_BLOCKS))
def test_lm_family_block_on_the_card(cuda, block):
    """Each new block, card against CPU on the same weights (f32): no
    cache, then (SSD, RG-LRU) a prefill and two decodes on a cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    cls, spec, arch = FAMILY_BLOCKS[block]
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32,
                                               attn_chunk=16)
    gen = torch.Generator().manual_seed(1)
    w = {k: torch.randn(shape, generator=gen) * 0.3
         for k, (shape, *_) in getattr(blocks, spec)(cfg).items()}
    x = torch.randn((2, 37, cfg.d_model), generator=gen)
    mem = torch.randn((2, 40, cfg.d_model), generator=gen)
    got, want = [], []
    for device, out in ((cuda, got), ("cpu", want)):
        blk = getattr(blocks, cls)(cfg, _family_tree(w, device))
        xx = x.to(device)
        if block == "cross":
            out.append(blk(xx, mem.to(device)))
        elif block == "moe":
            out.append(blk(xx))
            out.append(blk.routes)
        else:
            out.append(blk(xx)[0])
            cache = _family_block_cache(block, cfg, device)
            out.append(blk(xx[:, :35], cache)[0])
            for t in (35, 36):
                out.append(blk(xx[:, t:t + 1], cache)[0])
            out.extend(cache.values())
    for g, w_ in zip(got, want):
        if g.dtype == torch.long:
            assert torch.equal(g.cpu(), w_)
        else:
            _close(g.cpu(), w_)


def _family_block_cache(block, cfg, device):
    cw = cfg.conv_width - 1
    if block == "ssd":
        d_in = cfg.ssm_expand * cfg.d_model
        hs = d_in // cfg.ssm_head_dim
        return {"conv": torch.zeros((2, cw, d_in + 2 * cfg.ssm_state),
                                    device=device),
                "state": torch.zeros((2, hs, cfg.ssm_head_dim,
                                      cfg.ssm_state), device=device)}
    return {"conv": torch.zeros((2, cw, cfg.lru_width), device=device),
            "h": torch.zeros((2, cfg.lru_width), device=device)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_lm_family_decode_step_on_the_card(cuda, arch):
    """Each family at its smoke size, f32 with an f32 cache, parameters
    made on the CPU and copied: prefill and one decode step on the card
    against the CPU (cross-attention gates at 1, so the memory counts)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    tree = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for grp in tree["groups"].values():
        if "cross" in grp:
            grp["cross"]["gate"].fill_(1.0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 17))
    mem = None
    if cfg.family == "vlm":
        mem = rng.standard_normal((2, cfg.num_patches, cfg.d_model))
    elif cfg.is_encdec:
        mem = rng.standard_normal((2, 4, cfg.d_model))
    mem = None if mem is None else (mem * 0.02).astype(np.float32)
    out = {}
    for where, device in (("card", cuda), ("cpu", "cpu")):
        model = tfm.Transformer(cfg, _family_tree(tree, device))
        cache = tfm.init_cache(cfg, 2, 32, device, dtype=torch.float32)
        lp, cache, memory = model.prefill(cache, toks[:, :16], mem)
        ld, _ = model.decode_step(cache, toks[:, 16:], torch.full((2,), 16),
                                  memory)
        out[where] = (lp.cpu(), ld.cpu())
    for g, w in zip(out["card"], out["cpu"]):
        _close(g, w)


# ---------------------------------------------------------------------------
# the LM training path (loss_fn, value_and_grad, AdamW, the train step)
# ---------------------------------------------------------------------------

@pytest.fixture
def no_tf32():
    """f32 products in f32 on the card (TF32 off) for card-vs-CPU checks."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _train_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    if cfg.family == "vlm":
        shape = (b, cfg.num_patches, cfg.d_model)
    elif cfg.is_encdec:
        shape = (b, max(s // cfg.enc_ratio, 1), cfg.d_model)
    else:
        return batch
    batch["memory"] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-27b"] + FAMILY_ARCHS)
def test_train_loss_and_gradients_on_the_card(cuda, no_tf32, arch):
    """Each family's smoke config (f32, cross-attention gates at 1): the
    loss and every gradient leaf (within 1e-4 of its own scale, floored
    at 1e-3) on the card against the CPU, on
    parameters made on the CPU and copied, over S = 80 > attn_chunk (the
    chunked attention's checkpoints) with loss chunks of 32 under a mask;
    an MoE model's top-k sets must agree first."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.blocks import MoEBlock
    from repro_torch.optim.adamw import tree_leaves
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    tree = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for grp in tree["groups"].values():
        if "cross" in grp:
            grp["cross"]["gate"].fill_(1.0)
    batch = _train_batch(cfg, 2, 80, seed=0)
    out = {}
    for where, device in (("card", cuda), ("cpu", "cpu")):
        model = tfm.Transformer(cfg, _family_tree(tree, device), live=True)
        (loss, _), grads = tfm.value_and_grad(model, cfg, batch,
                                              loss_chunk=32)
        routes = [m.routes.cpu() for m in model.modules()
                  if isinstance(m, MoEBlock)]
        out[where] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)],
                      routes)
    for g, w in zip(out["card"][2], out["cpu"][2]):
        assert torch.equal(g.sort(-1).values, w.sort(-1).values)
    _close(out["card"][0], out["cpu"][0])
    assert len(out["card"][1]) == len(out["cpu"][1])
    for g, w in zip(out["card"][1], out["cpu"][1]):
        _close(g, w, floor=1e-3)


def test_train_step_on_the_card(cuda, no_tf32):
    """Three steps of ``make_train_step`` (with gradient compression: the
    spec's angles are drawn on the CPU for either device) on the card
    against the CPU: losses and the parameters after."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw, compress
    from repro_torch.runtime import steps
    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype=torch.float32)
    tree = tfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    pipe = SyntheticLM(cfg, 48, 4, seed=1)
    out = {}
    for where, device in (("card", cuda), ("cpu", "cpu")):
        params = _family_tree(tree, device)
        bundle = steps.make_train_step(
            cfg, seq_len=48, global_batch=4, peak_lr=1e-3, warmup=1,
            total_steps=3, grad_compress_ratio=0.25, device=device)
        state = steps.TrainState(params, adamw.init(params),
                                 compress.init_error(params))
        losses = []
        for k in range(3):
            state, metrics = bundle.fn(state, pipe.batch(k))
            losses.append(metrics["loss"].cpu())
        out[where] = (torch.stack(losses),
                      [p.cpu() for p in adamw.tree_leaves(state.params)])
    _close(out["card"][0], out["cpu"][0])
    for g, w in zip(out["card"][1], out["cpu"][1]):
        _close(g, w)


def test_train_cli_resume_on_the_card(cuda, tmp_path):
    """The smoke CLI on the card: 3 steps, ``--resume auto`` to 6, against
    6 at once (warmup 20 covers all six steps): the same parameters."""
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves

    def run(directory, n, *extra):
        return train.run(train.parse_args([
            "--arch", "qwen2-1.5b", "--smoke", "--steps", str(n),
            "--seq-len", "32", "--global-batch", "4", "--log-every", "3",
            "--ckpt-dir", str(directory), *extra]))

    run(tmp_path / "a", 3)
    resumed = run(tmp_path / "a", 6, "--resume", "auto")
    whole = run(tmp_path / "b", 6)
    assert resumed["start_step"] == 3
    assert resumed["final_loss"] == whole["final_loss"]
    for a, b in zip(tree_leaves(resumed["state"].params),
                    tree_leaves(whole["state"].params)):
        assert torch.equal(a, b)


def _dryrun_setup(cuda, layers: int = 2):
    """qwen2-1.5b at full width, ``layers`` layers, B 8 x S 256 (the
    smoke script's [main-train] step): the config, recipe, shape, a fresh
    state and a batch on the card, and the step."""
    from repro_torch.configs import get_config, get_recipe
    from repro_torch.configs.shapes import Shape
    from repro_torch.runtime import steps
    cfg = get_config("qwen2-1.5b").replace(n_layers=layers)
    recipe = get_recipe("qwen2-1.5b")
    shape = Shape("card", 256, 8, "train")
    state = steps.concrete_train_state(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda,
        moment_dtype=recipe["moment_dtype"])
    bundle = steps.make_train_step(cfg, seq_len=256, global_batch=8,
                                   moment_dtype=recipe["moment_dtype"],
                                   device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 256), generator=g,
                                     device=cuda, dtype=torch.int32)}
    return cfg, recipe, shape, state, bundle, batch


def test_dryrun_prediction_on_the_card(cuda, no_tf32):
    """The dry run's one-device prediction (a 1x1 mesh of meta devices)
    against one real step: the argument bytes are the state's and batch's
    tensors exactly, the dot FLOPs within 1% of the profiler's product
    events that launched a kernel (an event whose op a checkpoint's early
    stop aborted before its kernel launches none)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, process_devices
    from repro_torch.optim.adamw import tree_leaves
    cfg, recipe, shape, state, bundle, batch = _dryrun_setup(cuda)
    mesh = Mesh([[0]], ("data", "model"), process_devices("meta", 1))
    pred = dryrun.analyze(cfg, recipe, shape, mesh)
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves(state) + list(batch.values()))
    assert pred["memory"]["argument_size_in_bytes"] == held
    bundle.fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        bundle.fn(state, batch)
        torch.cuda.synchronize()
    products = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
    launched = sum(int(ev.flops) for ev in prof.events()
                   if ev.name in products and ev.flops
                   and ev.device_time_total > 0)
    want = pred["roofline"]["hlo_flops"]
    assert abs(launched / want - 1) <= 0.01, (launched, want)


def test_dryrun_shards_on_logical_devices_of_the_card(cuda):
    """The state and batch on 4 logical devices of the card, a (2, 2)
    mesh, through ``sharding_tree``: each id's shard bytes are the dry
    run's per-device argument bytes; every leaf gathers back bitwise."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import logical_devices, make_local_mesh
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    cfg, recipe, shape, state, _bundle, batch = _dryrun_setup(cuda)
    with logical_devices(4, "cuda"):
        mesh = make_local_mesh(2, device="cuda")
    want = dryrun.argument_bytes(cfg, recipe, shape, mesh)
    rules = shd.make_rules(mesh, cfg, fsdp=recipe["fsdp"], global_batch=8)
    shardings = {"state": steps.state_shardings(cfg, mesh, rules),
                 "batch": shd.batch_sharding(mesh, rules, mode="train")}
    held = dict.fromkeys(range(4), 0)
    for t, s in dryrun._pairs({"state": state, "batch": batch}, shardings):
        parts = s.shard(t)
        for i, p in parts.items():
            assert p.is_cuda
            held[i] += p.numel() * p.element_size()
        back = s.gather(parts)
        assert torch.equal(back.reshape(-1).view(torch.uint8),
                           t.reshape(-1).contiguous().view(torch.uint8))
    assert set(held.values()) == {want}


def _logical_mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import Mesh, logical_devices, \
        process_devices
    n = int(np.prod(shape))
    with logical_devices(n, "cuda"):
        return Mesh(np.arange(n).reshape(shape), axes,
                    process_devices("cuda"))


def _ratio(got, want, tol, floor):
    return max(float((g.float() - w.float()).abs().max())
               / (tol * max(floor, float(w.float().abs().max())))
               for g, w in zip(got, want))


def _moved(got, want, bound):
    """max over the entries of |got - want| / bound."""
    return max(float(((g.float() - w.float()).abs() / b).max())
               for g, w, b in zip(got, want, bound))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)],
                         ids=["2x2", "1x4"])
def test_sharded_train_step_on_logical_devices_of_the_card(
        cuda, no_tf32, mesh_shape):
    """``chip_smoke.py``'s [main-sharded] a at 1 layer and B 4 x S 64:
    qwen2-1.5b at full width, f32, one step of the sharded step on 4
    logical devices of the card against the unsharded step on the card:
    the loss within 1e-6 relative, every gradient leaf within 1e-5
    max(1e-3, max|g|), the global norm within 1e-5 relative, and each
    parameter after AdamW at lr 1e-5 within ``adamw.first_step_tolerance``
    of those gradient and norm bounds (AdamW's g / (|g| + eps) turns a
    rounding difference of a gradient entry near eps into a part of lr:
    the tolerance allows that there and ~2^-16 lr elsewhere); the update
    path alone within the same tolerance, with no gradient term and the
    norm within 1e-6, of the unsharded AdamW update of the step's own
    gradients.  At (1, 4) the two KV heads are replicated."""
    from repro_torch.configs import get_config
    _sharded_step_on_the_card(cuda, get_config("qwen2-1.5b").replace(
        n_layers=1, dtype=torch.float32), mesh_shape)


def test_sharded_families_on_logical_devices_of_the_card(cuda, no_tf32):
    """``chip_smoke.py``'s [main-sharded] e at a reduced width: mamba2-780m
    (d_model 512: 16 SSD heads, 4 a rank, ``in_xz``'s runs rank 0-1 x and
    2-3 z) and qwen3-moe-30b-a3b (d_model 512, 32 experts: 8 a rank) at 2
    layers, B 4 x S 64, one step on a (1, 4) mesh of logical devices
    against the unsharded step on the card, within the bounds above."""
    from repro_torch.configs import get_config
    for arch, width in (("mamba2-780m", dict(d_model=512)),
                        ("qwen3-moe-30b-a3b", dict(d_model=512,
                                                   n_experts=32))):
        _sharded_step_on_the_card(cuda, get_config(arch).replace(
            n_layers=2, dtype=torch.float32, **width), (1, 4))


def _sharded_step_on_the_card(cuda, cfg, mesh_shape):
    """One step of ``cfg``'s sharded step at B 4 x S 64 on a mesh of
    ``mesh_shape`` logical devices of the card against the unsharded
    step on the card (the bounds of
    ``test_sharded_train_step_on_logical_devices_of_the_card``)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    hyper = dict(seq_len=64, global_batch=4, peak_lr=1e-5, warmup=0,
                 total_steps=10)
    tree = tfm.init_params(cfg, torch.Generator(device=cuda).manual_seed(7),
                           cuda)
    batch = SyntheticLM(cfg, 64, 4, seed=7).batch(0)

    def fresh():
        params = tfm.tree_map(lambda t: t.clone(), tree)
        return steps.TrainState(params, adamw.init(params))

    state = fresh()
    model = tfm.Transformer(cfg, state.params, live=True)
    (loss, _), grads = tfm.value_and_grad(model, cfg, batch)
    want_g = [g.clone() for g in adamw.tree_leaves(grads)]
    del model, grads
    state, want = steps.make_train_step(cfg, device=cuda, **hyper).fn(
        state, batch)
    bundle = steps.make_train_step(cfg, _logical_mesh(mesh_shape), **hyper)
    placed = shd.place_tree(fresh(), bundle.state_shardings)
    _, got_g = bundle.fn.gradients(placed, batch)
    got_g = tfm.tree_map(lambda g: g.clone(), shd.gather_tree(
        got_g, bundle.state_shardings.params))
    placed, metrics = bundle.fn(placed, batch)
    got_p = adamw.tree_leaves(shd.gather_tree(
        placed, bundle.state_shardings).params)
    assert all(t.is_cuda for i in placed
               for t in adamw.tree_leaves(placed[i]))
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-6 * abs(
        float(loss))
    assert _ratio(adamw.tree_leaves(got_g), want_g, 1e-5, 1e-3) <= 1.0
    assert abs(float(metrics["grad_norm"]) - float(want["grad_norm"])) <= \
        1e-5 * float(want["grad_norm"])
    want_p = adamw.tree_leaves(state.params)
    assert _moved(got_p, want_p, adamw.first_step_tolerance(
        want_g, want_p, want["grad_norm"], lr=hyper["peak_lr"],
        grad_tol=1e-5, norm_tol=1e-5)) <= 1.0
    own = fresh()
    _, _, om = adamw.update(got_g, own.opt, own.params, lr=hyper["peak_lr"])
    own_p = adamw.tree_leaves(own.params)
    assert _moved(got_p, own_p, adamw.first_step_tolerance(
        got_g, own_p, om["grad_norm"], lr=hyper["peak_lr"], grad_tol=0.0,
        norm_tol=1e-6)) <= 1.0


@pytest.mark.parametrize("mesh_shape", [(2, 1, 2), (2, 2, 2)],
                         ids=["2x1x2", "2x2x2"])
def test_pod_step_on_logical_devices_of_the_card(cuda, mesh_shape):
    """``chip_smoke.py``'s [main-sharded] c at one layer: the cross-pod
    compressed step at full width, ratio 0.125, two steps: finite losses;
    ``cross_pod_bytes`` equal to the count from the leaves' shard shapes
    and under half of what the uncompressed reduction would move; with a
    data axis also under half of ``collective_bytes`` (the JAX test's
    gate: at a data axis of 1 the pod's only other collectives are the
    model axis's activation sums, and the cross-pod blocks are most of
    the traffic)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import hlo_analysis as hlo
    from repro_torch.runtime import steps
    cfg = get_config("qwen2-1.5b").replace(n_layers=1)
    bundle = steps.make_pod_compressed_train_step(
        cfg, _logical_mesh(mesh_shape, ("pod", "data", "model")),
        seq_len=64, global_batch=4, compress_ratio=0.125, warmup=1,
        total_steps=2)
    state = steps.placed_train_state(
        bundle, torch.Generator(device=cuda).manual_seed(5))
    pipe = SyntheticLM(cfg, 64, 4, seed=5)
    losses = []
    for k in range(2):
        state, metrics = bundle.fn(state, pipe.batch(k))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    spec, kept, whole = bundle.fn.spec, 0, 0
    for meta, sh in zip(tree_leaves(bundle.abstract_state.params),
                        tree_leaves(bundle.state_shardings.params)):
        n = int(np.prod(sh.shard_shape(meta.shape)))
        kept += n if n < 1 << 14 else -(-n // spec.width) * spec.keep
        whole += n
    terms = hlo.collective_terms(bundle.collectives)
    cross = terms["cross_pod_bytes"]
    assert cross == 2 * 2 * 4 * (kept + 2 + 1)
    assert 0 < cross < 0.5 * 2 * 2 * 4 * (whole + 2 + 1)
    if mesh_shape[1] > 1:
        assert cross < 0.5 * terms["collective_bytes"]
