"""What the operator kernels (csrc/chain.cuh: stream_leg, operator_rows)
rely on, checked on the CPU without a card:

* the compacted entry stream (launcher.entry_stream) of tables packed by
  the JAX package and carried across with ``interop.basis_from_numpy``
  holds exactly the real entries, stage by stage in slot order, in the
  ring form, and its stage offsets are the running sums of the stage
  extents — G and T, single and batched, forward and mirrored, with and
  without ``stage_pad``;
* walking the stream as the kernel does (each leg's entry range at the
  family's cut, the spectrum between the legs) equals the plain
  operators at every cut: G within 1e-6, T bitwise;
* the operator geometry (launcher.operator_geometry) on H100 figures:
  its warps cover every row once, within the shared memory given, with
  one lane per row where the rows fill the card and more lanes where
  they do not; worked examples and refusals;
* the stream cache: one stream per live, unwritten table set."""
import numpy as np
import pytest
import torch

from repro_torch.core.staging import table_arrays
from repro_torch.kernels import launcher
from repro_torch.kernels import ref
from test_torch_bank_geometry import CASES, H100, IDS, N, _carried

SMS = H100["sms"]


def _rows(words, off, b, st):
    return words[int(off[b, st]):int(off[b, st + 1])]


@pytest.mark.parametrize("kind,batched,pad", CASES, ids=IDS)
@pytest.mark.parametrize("leg", [0, 1], ids=["fwd", "mirrored"])
def test_stream_holds_the_real_entries_in_stage_order(kind, batched, pad,
                                                      leg):
    jtab, ttab = _carried(kind, batched, pad)
    staged = ttab[leg]
    jt = [np.asarray(a) for a in jtab[leg][:len(table_arrays(staged))]]
    if not batched:
        jt = [a[None] for a in jt]
    words, off = launcher.entry_stream(staged)
    width = 8 if kind == "sym" else 4
    assert words.dtype == torch.int32 and off.dtype == torch.int32
    bsz, s_tot, _ = jt[0].shape
    assert tuple(off.shape) == (bsz, s_tot + 1)
    assert tuple(words.shape) == (int((jt[0] < N).sum()), width)
    ext = launcher.stage_extents(staged).reshape(bsz, s_tot)
    np.testing.assert_array_equal(
        off[:, 1:].numpy() - off[:, :1].numpy(),
        np.cumsum(ext.numpy(), axis=1))
    np.testing.assert_array_equal(off[1:, 0].numpy(), off[:-1, -1].numpy())
    assert int(off[0, 0]) == 0 and int(off[-1, -1]) == words.shape[0]
    for b in range(bsz):
        for st in range(s_tot):
            real = jt[0][b, st] < N
            want = np.stack([a[b, st][real].view(np.int32) for a in jt], 1)
            got = _rows(words, off, b, st).numpy()
            np.testing.assert_array_equal(got[:, :len(jt)], want)
            assert not got[:, len(jt):].any()


def _walk(words, off, b, s0, ns, xp, kind):
    """Stages [s0, s0 + ns) of matrix b's stream on rows xp (M, n), in
    place: the kernel's walk in plain torch."""
    for st in range(s0, s0 + ns):
        e = _rows(words, off, b, st)
        i, j = e[:, 0].long(), e[:, 1].long()
        v = e[:, 2:].contiguous().view(torch.float32)
        xi, xj = xp[:, i], xp[:, j]
        if kind == "sym":
            xp[:, i] = v[:, 0] * xi + v[:, 1] * xj
            xp[:, j] = v[:, 2] * (-v[:, 1] * xi + v[:, 0] * xj)
        else:
            xp[:, i] = v[:, 0] * xi + v[:, 1] * xj
    return xp


def _stream_operator(fwd, bwd, diag, x, k, kind):
    """The operator as the kernel computes it: each leg's entry range at
    the family's cut, the spectrum between the legs."""
    a_keep, s_keep = launcher.leg_orientation(kind)
    s_tot = fwd.idx_i.shape[-2]
    (a0, na), (f0, nf) = (launcher._leg_range(s_tot, k, a_keep),
                          launcher._leg_range(s_tot, k, s_keep))
    (aw, ao), (fw, fo) = launcher.entry_stream(bwd), launcher.entry_stream(
        fwd)
    lead = x.dim() == 3
    xs, ds = (x, diag) if lead else (x[None], diag[None])
    out = []
    for b in range(xs.shape[0]):
        xp = _walk(aw, ao, b, a0, na, xs[b].clone(), kind) * ds[b]
        out.append(_walk(fw, fo, b, f0, nf, xp, kind))
    y = torch.stack(out)
    return y if lead else y[0]


@pytest.mark.parametrize("kind,batched,pad", CASES, ids=IDS)
def test_stream_walk_equals_the_plain_operator_at_every_cut(kind, batched,
                                                            pad):
    _, (fwd, bwd) = _carried(kind, batched, pad)
    rng = np.random.default_rng(7)
    lead = (3,) if batched else ()
    x = torch.from_numpy(rng.standard_normal(lead + (5, N)).astype(
        np.float32))
    diag = torch.from_numpy(rng.uniform(0.0, 2.0, lead + (N,)).astype(
        np.float32))
    name = (("batched_" if batched else "")
            + ("sym" if kind == "sym" else "gen") + "_operator_apply")
    plain = getattr(ref, name)
    for k in sorted({0, *fwd.cuts[:, 0].tolist()}) + [None]:
        got = _stream_operator(fwd, bwd, diag, x, k, kind)
        want = plain(fwd, bwd, diag, x, k)
        if kind == "sym":
            tol = 1e-6 * max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= tol
        else:
            assert torch.equal(got, want)


def _covered(geo, rows):
    """Rows each warp owns, split as csrc/chain.cuh::operator_rows splits
    blockIdx.x and the warp index."""
    seen = np.zeros(rows, np.int64)
    for cta in range(geo.row_tiles):
        for w in range(geo.warps):
            r0 = (cta * geo.warps + w) * geo.rows_per_warp
            seen[r0:min(rows, r0 + geo.rows_per_warp)] += 1
    return seen


@pytest.mark.parametrize("family", ["g", "t"])
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("rows", [1, 130, 256])
@pytest.mark.parametrize("n", [16, 48, 256])
def test_operator_geometry_on_h100_figures(family, batch, rows, n):
    ring = launcher.operator_ring_bytes(family)
    geo = launcher.operator_geometry(batch, rows, n, ring, **H100)
    assert geo.lanes in launcher.OPERATOR_LANES
    assert 1 <= geo.rows_per_warp <= min(32 // geo.lanes, rows)
    assert (_covered(geo, rows) == 1).all()
    last = (geo.row_tiles - 1) * geo.warps * geo.rows_per_warp
    assert last < rows                           # no empty CTA
    ld = (n + 1) | 1
    tile = geo.warps * geo.rows_per_warp * ld * 4
    assert geo.smem == -(-tile // 16) * 16 + geo.warps * ring
    assert geo.smem <= H100["smem_block"]
    assert geo.resident >= 1
    assert geo.resident * (geo.smem + 1024) <= H100["smem_sm"]
    warps = batch * -(-rows // geo.rows_per_warp)
    # one lane per row where the rows fill the card, more where they
    # do not (and only then)
    assert warps >= 2 * SMS or geo.lanes == max(launcher.OPERATOR_LANES)
    if geo.lanes > 1:
        half = min(64 // geo.lanes, rows)
        assert batch * -(-rows // half) < 2 * SMS


def _geometry(batch, rows, n, family="g"):
    return launcher.operator_geometry(
        batch, rows, n, launcher.operator_ring_bytes(family), **H100)


def test_operator_geometry_worked_examples():
    assert launcher.operator_ring_bytes("g") == 8192
    assert launcher.operator_ring_bytes("t") == 4096
    # the main paths: 16384 rows fill the card with one lane per row;
    # four warps per CTA (128 CTAs on 132 SMs, four warps on the busiest)
    assert _geometry(64, 256, 256) == launcher.OperatorGeometry(
        1, 32, 4, 2, 4 * 32 * 1028 + 4 * 8192, 1)
    assert _geometry(64, 256, 256, "t").smem == 4 * 32 * 1028 + 4 * 4096
    # B = 1: 256 rows on 8 lanes each, 64 one-warp CTAs
    assert _geometry(1, 256, 256) == launcher.OperatorGeometry(
        8, 4, 1, 64, 4 * 1028 + 8192, 17)
    # one row: a warp of 8 active lanes
    geo = _geometry(1, 1, 256)
    assert (geo.lanes, geo.rows_per_warp, geo.warps) == (8, 1, 1)
    # R = 130 (5 warps per matrix): three-warp CTAs, three warps on the
    # busiest SM
    geo = _geometry(64, 130, 256)
    assert (geo.lanes, geo.rows_per_warp, geo.warps, geo.row_tiles) == (
        1, 32, 3, 2)
    # narrow rows at B = 4: 132 one-warp CTAs of 4 rows x 8 lanes
    for n in (16, 48):
        geo = _geometry(4, 130, n)
        assert (geo.lanes, geo.rows_per_warp, geo.warps,
                geo.row_tiles) == (8, 4, 1, 33)
    # a row of 20,000 floats: 2 rows and a ring fit in one block, one
    # warp of 2 rows x 8 lanes
    geo = _geometry(1, 16, 20_000)
    assert (geo.lanes, geo.rows_per_warp, geo.warps) == (8, 2, 1)


def test_operator_geometry_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="too wide"):
        _geometry(1, 8, 60_000)
    with pytest.raises(ValueError, match="B, R"):
        _geometry(0, 8, 256)
    with pytest.raises(ValueError, match="B, R"):
        _geometry(1, 0, 256)


def test_streams_are_kept_beside_their_tables():
    """The operator launch's stream cache: one build per live, unwritten
    table set; an in-place write of any table or a new index table
    rebuilds, and the entry goes with its index tensor."""
    _, (fwd, _) = _carried("sym", True, None)
    out = launcher._cached_stream(fwd)
    for got, want in zip(out, launcher.entry_stream(fwd)):
        assert torch.equal(got, want)
    assert launcher._cached_stream(fwd) is out
    ii = fwd.idx_i.clone()
    moved = fwd._replace(idx_i=ii)
    assert launcher._cached_stream(moved) is not out
    ii[:, :, 0] = fwd.n                          # first slot of every stage
    got = launcher._cached_stream(moved)
    assert torch.equal(got[1], launcher.entry_stream(moved)[1])
    assert not torch.equal(got[1], out[1])
    moved.c.mul_(0.5)                            # a value table, in place
    again = launcher._cached_stream(moved)
    assert again is not got
    assert torch.equal(again[0], launcher.entry_stream(moved)[0])
    key = id(ii)
    assert key in launcher._STREAMS
    del moved, ii, got, again
    assert key not in launcher._STREAMS
