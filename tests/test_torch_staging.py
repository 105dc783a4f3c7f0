"""Stage packing of the PyTorch port against the JAX package: for the
same factors the packed tables and cut ladders are BITWISE equal, for G
and T chains, single and batched, forward and mirror, with and without
shape quanta; the cut helpers agree."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import staging as jst
from repro.core.types import GFactors as JGFactors
from repro.core.types import TFactors as JTFactors
from repro_torch.core import staging as tst
from repro_torch.core.types import GFactors, TFactors


def _chain(n, g, seed, batch=None):
    """Random valid G chains (i < j, canonical values) as numpy fields."""
    rng = np.random.default_rng(seed)
    shape = (g,) if batch is None else (batch, g)
    a = rng.integers(0, n, shape)
    b = (a + rng.integers(1, n, shape)) % n
    theta = rng.uniform(-np.pi, np.pi, shape)
    return (np.minimum(a, b).astype(np.int32),
            np.maximum(a, b).astype(np.int32),
            np.cos(theta).astype(np.float32),
            np.sin(theta).astype(np.float32),
            rng.choice([-1.0, 1.0], shape).astype(np.float32))


def _bitwise_equal(jax_staged, torch_staged):
    assert jax_staged.n == torch_staged.n
    np.testing.assert_array_equal(np.asarray(jax_staged.cuts),
                                  torch_staged.cuts)
    for a, b in zip(jax_staged[:5], torch_staged[:5]):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,g", [(16, 64), (32, 320), (48, 128)])
@pytest.mark.parametrize("cuts", [None, (5, 17, 40)])
def test_single_pack_bitwise(n, g, cuts):
    fields = _chain(n, g, seed=n + g)
    jf, tf = JGFactors(*map(jnp.asarray, fields)), GFactors(*fields)
    jfwd, jadj = jst.pack_g_pair(jf, cuts=cuts, n=n)
    tfwd, tadj = tst.pack_g_pair(tf, cuts=cuts, n=n, device="cpu")
    _bitwise_equal(jfwd, tfwd)
    _bitwise_equal(jadj, tadj)
    _bitwise_equal(jst.pack_g(jf, cuts=cuts, n=n),
                   tst.pack_g(tf, cuts=cuts, n=n, device="cpu"))
    _bitwise_equal(jst.pack_g_adjoint(jf, cuts=cuts, n=n),
                   tst.pack_g_adjoint(tf, cuts=cuts, n=n, device="cpu"))


@pytest.mark.parametrize("n,g,batch", [(16, 64, 3), (32, 160, 4),
                                       (48, 200, 2)])
@pytest.mark.parametrize("pad", [None, (4, 8)])
def test_batched_pack_bitwise(n, g, batch, pad):
    fields = _chain(n, g, seed=batch * n, batch=batch)
    jf, tf = JGFactors(*map(jnp.asarray, fields)), GFactors(*fields)
    jfwd, jadj = jst.pack_g_batch_pair(jf, n, pad=pad)
    tfwd, tadj = tst.pack_g_batch_pair(tf, n, pad=pad, device="cpu")
    _bitwise_equal(jfwd, tfwd)
    _bitwise_equal(jadj, tadj)
    _bitwise_equal(jst.pack_g_batch(jf, n, adjoint=True, pad=pad),
                   tst.pack_g_batch(tf, n, adjoint=True, pad=pad,
                                    device="cpu"))


def test_torch_factor_tensors_pack_like_numpy():
    fields = _chain(16, 48, seed=3, batch=2)
    a = tst.pack_g_batch_pair(GFactors(*fields), 16, device="cpu")
    b = tst.pack_g_batch_pair(GFactors(*map(torch.from_numpy, fields)), 16,
                              device="cpu")
    for sa, sb in zip(a, b):
        _bitwise_equal(sa, sb)


@pytest.mark.parametrize("keep", ["head", "tail"])
def test_truncate_and_select_cut_match(keep):
    fields = _chain(32, 200, seed=7, batch=3)
    jfwd = jst.pack_g_batch(JGFactors(*map(jnp.asarray, fields)), 32)
    tfwd = tst.pack_g_batch(GFactors(*fields), 32, device="cpu")
    for k in [0, *tfwd.cuts[:, 0].tolist()]:
        _bitwise_equal(jst.truncate_staged(jfwd, k, keep),
                       tst.truncate_staged(tfwd, k, keep))
    for frac in (0.1, 0.25, 0.5, 0.8, 1.0):
        assert (jst.select_cut(jfwd, fraction=frac)
                == tst.select_cut(tfwd, fraction=frac))
    for k in (0, 1, 49, 51, 199, 200):
        assert (jst.select_cut(jfwd, num_transforms=k)
                == tst.select_cut(tfwd, num_transforms=k))
    with pytest.raises(ValueError):
        tst.truncate_staged(tfwd, tfwd.num_stages + 1)
    with pytest.raises(ValueError):
        tst.truncate_staged(tfwd, 1, keep="middle")


def test_ladder_matches():
    for g in (0, 1, 7, 128, 4096):
        np.testing.assert_array_equal(jst.default_cut_ladder(g),
                                      tst.default_cut_ladder(g))


# ---------------------------------------------------------------------------
# T family (scaling / shear chains)
# ---------------------------------------------------------------------------

def _t_chain(n, m, seed, batch=None):
    """Random valid T chains: scalings (j == i), shears (j != i)."""
    rng = np.random.default_rng(seed)
    shape = (m,) if batch is None else (batch, m)
    kind = rng.integers(0, 2, shape).astype(np.int32)
    i = rng.integers(0, n, shape).astype(np.int32)
    j = np.where(kind == 0, i, (i + rng.integers(1, n, shape)) % n)
    a = np.where(kind == 0, rng.uniform(0.5, 2.0, shape),
                 rng.uniform(-1.0, 1.0, shape))
    return kind, i, j.astype(np.int32), a.astype(np.float32)


def _t_bitwise_equal(jax_staged, torch_staged):
    assert isinstance(torch_staged, tst.StagedT)
    assert jax_staged.n == torch_staged.n
    np.testing.assert_array_equal(np.asarray(jax_staged.cuts),
                                  torch_staged.cuts)
    for a, b in zip(jax_staged[:4], torch_staged[:4]):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,m", [(16, 64), (32, 320), (48, 128)])
@pytest.mark.parametrize("cuts", [None, (5, 17, 40)])
def test_t_single_pack_bitwise(n, m, cuts):
    fields = _t_chain(n, m, seed=n + m)
    jf, tf = JTFactors(*map(jnp.asarray, fields)), TFactors(*fields)
    jfwd, jinv = jst.pack_t_pair(jf, n, cuts=cuts)
    tfwd, tinv = tst.pack_t_pair(tf, n, cuts=cuts, device="cpu")
    _t_bitwise_equal(jfwd, tfwd)
    _t_bitwise_equal(jinv, tinv)
    _t_bitwise_equal(jst.pack_t(jf, n, cuts=cuts),
                     tst.pack_t(tf, n, cuts=cuts, device="cpu"))
    _t_bitwise_equal(jst.pack_t_inverse(jf, n, cuts=cuts),
                     tst.pack_t_inverse(tf, n, cuts=cuts, device="cpu"))
    # pads: index n with (alpha, beta) = (1, 0), mirrored to (1, -0)
    pad = tfwd.idx_i.numpy() == n
    assert (tfwd.alpha.numpy()[pad] == 1).all()
    assert (tfwd.beta.numpy()[pad] == 0).all()


@pytest.mark.parametrize("n,m,batch", [(16, 64, 3), (32, 160, 4),
                                       (48, 200, 2)])
@pytest.mark.parametrize("pad", [None, (4, 8)])
def test_t_batched_pack_bitwise(n, m, batch, pad):
    fields = _t_chain(n, m, seed=batch * n, batch=batch)
    jf, tf = JTFactors(*map(jnp.asarray, fields)), TFactors(*fields)
    jfwd, jinv = jst.pack_t_batch_pair(jf, n, pad=pad)
    tfwd, tinv = tst.pack_t_batch_pair(tf, n, pad=pad, device="cpu")
    _t_bitwise_equal(jfwd, tfwd)
    _t_bitwise_equal(jinv, tinv)
    _t_bitwise_equal(jst.pack_t_batch(jf, n, inverse=True, pad=pad),
                     tst.pack_t_batch(tf, n, inverse=True, pad=pad,
                                      device="cpu"))
    b = tst.pack_t_batch_pair(TFactors(*map(torch.from_numpy, fields)), n,
                              pad=pad, device="cpu")
    _t_bitwise_equal(jfwd, b[0])


@pytest.mark.parametrize("keep", ["head", "tail"])
def test_t_truncate_and_select_cut_match(keep):
    fields = _t_chain(32, 200, seed=7, batch=3)
    jinv = jst.pack_t_batch(JTFactors(*map(jnp.asarray, fields)), 32,
                            inverse=True)
    tinv = tst.pack_t_batch(TFactors(*fields), 32, inverse=True,
                            device="cpu")
    for k in [0, *tinv.cuts[:, 0].tolist()]:
        _t_bitwise_equal(jst.truncate_staged(jinv, k, keep),
                         tst.truncate_staged(tinv, k, keep))
    for frac in (0.1, 0.25, 0.5, 0.8, 1.0):
        assert (jst.select_cut(jinv, fraction=frac)
                == tst.select_cut(tinv, fraction=frac))
    assert tst.table_arrays(tinv) == tuple(tinv[:4])
