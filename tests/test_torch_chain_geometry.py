"""What the chain kernels (csrc/chain.cuh: chain_rows on stream_leg) and
every launch's batch split rely on, checked on the CPU without a card:

* walking a leg's compacted entry stream (launcher.entry_stream) over
  the chain's entry range, as the kernel walks it, equals the plain
  chains (ref.batched_g_apply, staged_g_apply, batched_t_apply,
  staged_t_apply) at every ladder cut including 0, at both keeps, on
  tables packed by the JAX package and carried across — G and T, single
  and batched, forward and mirrored tables: G within 1e-6, T bitwise;
* the batch split (launcher.batch_slices) covers [0, B) in order with
  slices of at most ``_GRID_B`` matrices, and each slice's C arguments
  (launcher._sliced) point at the slice's first matrix in x, y, the
  stream offsets, the spectrum, the gains and a bank leg's tables and
  extents, while a stream's words stay as they are."""
import numpy as np
import pytest
import torch

from repro_torch.core.staging import table_arrays
from repro_torch.interop import basis_from_numpy
from repro_torch.kernels import launcher
from repro_torch.kernels import ref
from test_torch_bank_geometry import (CASES, IDS, N, _carried, _g_fields,
                                      _t_fields)
from test_torch_operator_geometry import _walk

PLAIN = {("sym", True): ref.batched_g_apply,
         ("sym", False): ref.staged_g_apply,
         ("general", True): ref.batched_t_apply,
         ("general", False): ref.staged_t_apply}


def _stream_chain(staged, x, k, keep, kind):
    """The chain as the kernel computes it: the stages of the leg's cut
    at ``keep``, walked over the stream matrix by matrix."""
    s0, ns = launcher._leg_range(staged.idx_i.shape[-2], k, keep)
    words, off = launcher.entry_stream(staged)
    xs = x if x.dim() == 3 else x[None]
    y = torch.stack([_walk(words, off, b, s0, ns, xs[b].clone(), kind)
                     for b in range(xs.shape[0])])
    return y if x.dim() == 3 else y[0]


@pytest.mark.parametrize("kind,batched,pad", CASES, ids=IDS)
@pytest.mark.parametrize("leg", [0, 1], ids=["fwd", "mirrored"])
def test_stream_walk_equals_the_plain_chain_at_every_cut(kind, batched, pad,
                                                         leg):
    _, tables = _carried(kind, batched, pad)
    staged = tables[leg]
    rng = np.random.default_rng(11)
    lead = (3,) if batched else ()
    x = torch.from_numpy(rng.standard_normal(lead + (5, N)).astype(
        np.float32))
    plain = PLAIN[(kind, batched)]
    for k in sorted({0, *staged.cuts[:, 0].tolist()}) + [None]:
        for keep in ("head", "tail"):
            got = _stream_chain(staged, x, k, keep, kind)
            want = plain(staged, x, k, keep)
            if kind == "sym":
                tol = 1e-6 * max(1.0, float(want.abs().max()))
                assert float((got - want).abs().max()) <= tol
            else:
                assert torch.equal(got, want)


@pytest.mark.parametrize("grid", [1, 3, 65535])
@pytest.mark.parametrize("bsz", [0, 1, 2, 3, 7, 65535, 65536, 200_000])
def test_batch_slices_cover_the_batch_in_order(monkeypatch, grid, bsz):
    monkeypatch.setattr(launcher, "_GRID_B", grid)
    slices = list(launcher.batch_slices(bsz))
    assert len(slices) == -(-bsz // grid)
    assert all(0 < b1 - b0 <= grid for b0, b1 in slices)
    ends = [0] + [b1 for _, b1 in slices]
    assert [b0 for b0, _ in slices] == ends[:-1]
    assert ends[-1] == bsz


def _batch(kind, bsz):
    fields = (_g_fields if kind == "sym" else _t_fields)(bsz, 160, 3)
    spec = np.zeros((bsz, N), np.float32)
    return basis_from_numpy(kind, N, fields, spec, device="cpu")


@pytest.mark.parametrize("kind", ["sym", "general"])
def test_each_slice_launches_on_its_own_matrices(monkeypatch, kind):
    """B = 7 at a grid of 3 matrices: three launches on [0, 3), [3, 6),
    [6, 7), each of the three kinds' arguments offset to matrix b0."""
    monkeypatch.setattr(launcher, "_GRID_B", 3)
    basis = _batch(kind, 7)
    fwd, bwd = basis.fwd, basis.bwd
    x = torch.zeros((7, 5, N))
    y = torch.empty_like(x)
    diag = torch.zeros((7, N))
    gains = torch.zeros((7, 4, N + 1))
    yb = torch.empty((7, 4, 5, N))
    s_tot = fwd.idx_i.shape[-2]

    def check(out, extra):
        """``out``: the sliced argument tuples; ``extra``: per argument
        after (x, y, B, R, n), the tensor whose matrix b0 it must point
        at, or the plain value it must keep."""
        assert [a[2] for a in out] == [3, 3, 1]
        for (b0, _), a in zip(launcher.batch_slices(7), out):
            assert a[3:5] == (5, N) and len(a) == 5 + len(extra)
            for got, want in zip(a[5:], extra):
                if isinstance(want, torch.Tensor):
                    assert got == want[b0].data_ptr()
                else:
                    assert got == want

    words, off = launcher._cached_stream(fwd)
    leg = launcher._stream_leg(fwd, x, True, 4, "tail", "chain")
    assert leg[2:] == (s_tot, s_tot - 4, 4)
    out = list(launcher._sliced(x, y, leg))
    for (b0, _), a in zip(launcher.batch_slices(7), out):
        assert a[:2] == (x[b0].data_ptr(), y[b0].data_ptr())
    check(out, (words.data_ptr(), off) + leg[2:])

    bwords, boff = launcher._cached_stream(bwd)
    args = (launcher._PerMatrix(diag.data_ptr(), N),
            *launcher._stream_leg(bwd, x, True, None, "head", "bwd"), *leg)
    check(list(launcher._sliced(x, y, args)),
          (diag, bwords.data_ptr(), boff, s_tot, 0, s_tot)
          + (words.data_ptr(), off) + leg[2:])

    bleg = launcher._bank_leg(fwd, x, True, None, "head", "bank")
    tabs = table_arrays(fwd)
    p = fwd.idx_i.shape[-1]
    assert bleg[len(tabs) + 1:] == (s_tot * p, p, 0, s_tot)
    args = (launcher._PerMatrix(gains.data_ptr(), 4 * (N + 1)), 4, *bleg)
    out = list(launcher._sliced(x, yb, args))
    for (b0, _), a in zip(launcher.batch_slices(7), out):
        assert a[1] == yb[b0].data_ptr()
    check(out, (gains, 4, *tabs, launcher._cached_extents(fwd))
          + bleg[len(tabs) + 1:])
