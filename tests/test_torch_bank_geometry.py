"""What the bank kernels (csrc/chain.cuh: walk_leg, bank_tile) rely on,
checked on the CPU without a card:

* the stage extents (launcher.stage_extents) of tables packed by the JAX
  package and carried across with ``interop.basis_from_numpy``: each
  equals its stage's real-entry count and no slot past it is real — G and
  T, single and batched, forward and mirrored, with and without
  ``stage_pad``;
* walking only a stage's extent is exact: the plain versions give
  bitwise the same output when every slot at or past the extent holds
  an arbitrary pad (index n, random values), at every cut;
* the bank geometry (launcher.bank_geometry) on H100 figures: its CTAs,
  split as the kernel splits them, cover every (row, filter) exactly
  once, each within the shared memory it is given and with room for at
  least three resident CTAs per SM; the grid reaches two CTAs per SM
  where the work allows, and F_g = F where that costs nothing."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import staging as jst
from repro.core.types import GFactors as JG
from repro.core.types import TFactors as JT
from repro_torch.core.staging import table_arrays
from repro_torch.interop import basis_from_numpy
from repro_torch.kernels import launcher
from repro_torch.kernels import ref

N = 24
H100 = dict(smem_block=232_448, smem_sm=233_472, sms=132)


def _g_fields(batch, g, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, N, (batch, g))
    b = (a + rng.integers(1, N, (batch, g))) % N
    theta = rng.uniform(-np.pi, np.pi, (batch, g))
    return dict(i=np.minimum(a, b).astype(np.int32),
                j=np.maximum(a, b).astype(np.int32),
                c=np.cos(theta).astype(np.float32),
                s=np.sin(theta).astype(np.float32),
                sigma=rng.choice([-1.0, 1.0], (batch, g)).astype(np.float32))


def _t_fields(batch, m, seed):
    rng = np.random.default_rng(seed)
    shape = (batch, m)
    kind = rng.integers(0, 2, shape).astype(np.int32)
    i = rng.integers(0, N, shape).astype(np.int32)
    j = np.where(kind == 0, i, (i + rng.integers(1, N, shape)) % N)
    scale = rng.uniform(0.8, 1.25, shape) * rng.choice([-1.0, 1.0], shape)
    a = np.where(kind == 0, scale, rng.uniform(-0.5, 0.5, shape))
    return dict(kind=kind, i=i, j=j.astype(np.int32), a=a.astype(np.float32))


def _carried(kind, batched, pad):
    """(JAX-packed (fwd, bwd), the port's (fwd, bwd) from
    basis_from_numpy) of the same random chains."""
    fields = (_g_fields if kind == "sym" else _t_fields)(3, 160, 5)
    if not batched:
        fields = {k: v[1] for k, v in fields.items()}
    spec = np.zeros((3, N) if batched else (N,), np.float32)
    basis = basis_from_numpy(kind, N, fields, spec, stage_pad=pad,
                             device="cpu")
    jc = JG if kind == "sym" else JT
    jf = jc(**{k: jnp.asarray(v) for k, v in fields.items()})
    if kind == "sym":
        jtab = (jst.pack_g_batch_pair(jf, N, pad=pad) if batched
                else jst.pack_g_pair(jf, n=N))
    else:
        jtab = (jst.pack_t_batch_pair(jf, N, pad=pad) if batched
                else jst.pack_t_pair(jf, N))
    return jtab, (basis.fwd, basis.bwd)


CASES = [(kind, batched, pad) for kind in ("sym", "general")
         for batched, pad in ((False, None), (True, None), (True, (4, 8)))]
IDS = [f"{k}-{'batched' if b else 'single'}-{'pad' if p else 'nopad'}"
       for k, b, p in CASES]


@pytest.mark.parametrize("kind,batched,pad", CASES, ids=IDS)
@pytest.mark.parametrize("leg", [0, 1], ids=["fwd", "mirrored"])
def test_extent_is_the_real_entry_count(kind, batched, pad, leg):
    jtab, ttab = _carried(kind, batched, pad)
    staged = ttab[leg]
    idx = np.asarray(jtab[leg].idx_i)
    np.testing.assert_array_equal(staged.idx_i.numpy(), idx)
    ext = launcher.stage_extents(staged)
    assert ext.dtype == torch.int32
    assert tuple(ext.shape) == idx.shape[:-1]
    real = idx < N
    np.testing.assert_array_equal(ext.numpy(), real.sum(-1))
    slot = np.arange(idx.shape[-1])
    assert not (real & (slot >= ext.numpy()[..., None])).any()
    if pad is not None:
        assert (ext.numpy() == 0).any()      # whole pad stages: extent 0


def _scrambled_past_extent(staged, seed):
    """The tables with every slot at or past its stage's extent replaced
    by a pad (index n) with random values."""
    ext = launcher.stage_extents(staged)
    past = (torch.arange(staged.idx_i.shape[-1])
            >= ext.unsqueeze(-1).long())
    gen = torch.Generator().manual_seed(seed)
    out = []
    for name, t in zip(staged._fields, table_arrays(staged)):
        fill = (torch.full_like(t, staged.n) if name.startswith("idx_")
                else torch.rand(t.shape, generator=gen) * 4.0 - 2.0)
        out.append(torch.where(past, fill, t))
    return type(staged)(*out, staged.cuts, staged.n)


@pytest.mark.parametrize("kind,batched,pad", CASES, ids=IDS)
def test_plain_walk_ignores_every_slot_past_the_extent(kind, batched, pad):
    _, (fwd, bwd) = _carried(kind, batched, pad)
    sfwd, sbwd = _scrambled_past_extent(fwd, 1), _scrambled_past_extent(
        bwd, 2)
    assert not all(torch.equal(a, b) for a, b in
                   zip(table_arrays(fwd), table_arrays(sfwd)))
    rng = np.random.default_rng(3)
    lead = (3,) if batched else ()
    x = torch.from_numpy(rng.standard_normal(lead + (5, N)).astype(
        np.float32))
    gains = torch.from_numpy(rng.uniform(0.0, 2.0, lead + (4, N)).astype(
        np.float32))
    name = (("batched_" if batched else "")
            + ("sym" if kind == "sym" else "gen") + "_filter_bank_apply")
    chain = {(True, "sym"): ref.batched_g_apply,
             (False, "sym"): ref.staged_g_apply,
             (True, "general"): ref.batched_t_apply,
             (False, "general"): ref.staged_t_apply}[(batched, kind)]
    bank = getattr(ref, name)
    for k in sorted({0, *fwd.cuts[:, 0].tolist()}):
        assert torch.equal(bank(sfwd, sbwd, gains, x, k),
                           bank(fwd, bwd, gains, x, k))
        for keep in ("head", "tail"):
            assert torch.equal(chain(sbwd, x, k, keep),
                               chain(bwd, x, k, keep))


def _ctas(geo, rows, filters):
    """Each CTA's (first row, rows, first filter, filters), split as
    csrc/chain.cuh::bank_tile splits blockIdx.x."""
    for cta in range(geo.row_tiles * geo.groups):
        r0 = (cta % geo.row_tiles) * geo.rows
        f0 = (cta // geo.row_tiles) * geo.filters
        yield (r0, min(geo.rows, rows - r0), f0,
               min(geo.filters, filters - f0))


@pytest.mark.parametrize("family,slots", [("g", 63), ("g", 128), ("t", 72),
                                          ("t", 256)])
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("rows", [1, 130, 256])
@pytest.mark.parametrize("filters", [1, 7, 33])
def test_bank_geometry_on_h100_figures(family, slots, batch, rows, filters):
    n = 256
    ring = launcher.bank_ring_bytes(slots, family)
    geo = launcher.bank_geometry(batch, rows, n, filters, ring, **H100)
    seen = np.zeros((rows, filters), np.int64)
    for r0, nr, f0, nf in _ctas(geo, rows, filters):
        assert nr >= 1 and nf >= 1               # no empty CTA
        seen[r0:r0 + nr, f0:f0 + nf] += 1
    assert (seen == 1).all()
    ld = (n + 1) | 1
    assert geo.smem >= geo.rows * geo.filters * ld * 4 + ring
    assert geo.smem <= H100["smem_block"]
    assert geo.resident >= 3
    assert 3 * (geo.smem + 1024) <= H100["smem_sm"]
    ctas = batch * geo.row_tiles * geo.groups
    assert ctas >= min(2 * H100["sms"], batch * rows * filters)
    if batch * rows >= 2 * H100["sms"] and filters * ld * 4 + ring <= (
            H100["smem_sm"] // 3 - 1024):
        assert geo.filters == filters            # the analysis runs once


def test_bank_geometry_worked_examples():
    ring = launcher.bank_ring_bytes(63, "g")
    geo = launcher.bank_geometry(64, 256, 256, 7, ring, **H100)
    assert (geo.rows, geo.filters, geo.groups) == (9, 7, 1)
    assert 64 * geo.row_tiles == 1856
    # B = 1: the filters split over CTAs rather than leave SMs idle
    geo = launcher.bank_geometry(1, 256, 256, 7, ring, **H100)
    assert geo.groups > 1 and geo.row_tiles * geo.groups >= 264
    # one row: every filter gets a CTA of its own (33 CTAs, short of the
    # target), since no grid of fewer groups has more CTAs
    geo = launcher.bank_geometry(1, 1, 256, 33, ring, **H100)
    assert (geo.rows, geo.filters, geo.row_tiles, geo.groups) == (1, 1, 1, 33)
    # enough CTAs anyway: F_g = F, the analysis runs once per row
    geo = launcher.bank_geometry(64, 256, 256, 1, ring, **H100)
    assert (geo.filters, geo.groups) == (1, 1) and 64 * geo.row_tiles >= 264


def test_bank_geometry_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="too wide"):
        launcher.bank_geometry(1, 8, 20_000, 1, 0, **H100)
    with pytest.raises(ValueError, match="B, R, F"):
        launcher.bank_geometry(1, 8, 256, 0, 0, **H100)
    # F * r rows that do not fit in one CTA fall back to filter groups
    geo = launcher.bank_geometry(64, 256, 1024, 33,
                                 launcher.bank_ring_bytes(512, "g"), **H100)
    assert geo.groups > 1 and geo.resident >= 3


def test_extents_are_kept_beside_their_index_table():
    """The bank launch's extent cache: one reduction per live, unwritten
    index table; an in-place write or a new table recomputes, and the
    entry goes with its tensor."""
    _, (fwd, _) = _carried("sym", True, None)
    ext = launcher._cached_extents(fwd)
    assert torch.equal(ext, launcher.stage_extents(fwd))
    assert launcher._cached_extents(fwd) is ext
    ii = fwd.idx_i.clone()
    moved = fwd._replace(idx_i=ii)
    assert launcher._cached_extents(moved) is not ext
    ii[:, :, 0] = fwd.n                          # first slot of every stage
    got = launcher._cached_extents(moved)
    assert torch.equal(got, launcher.stage_extents(moved))
    assert not torch.equal(got, ext)
    key = id(ii)
    assert key in launcher._EXTENTS
    del moved, ii
    assert key not in launcher._EXTENTS
