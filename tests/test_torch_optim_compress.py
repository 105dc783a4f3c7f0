"""The port's butterfly gradient compression
(``repro_torch.optim.compress``) against the JAX package's on the CPU.

The JAX package's compression cases (tests/test_optim.py, from
``test_butterfly_basis_is_orthonormal`` on) run on the port.  Then parity
on a carried spec (``interop.compress_spec_from_numpy``: the JAX
``make_spec`` angles; the port draws its own from a torch.Generator),
inputs from numpy seeds: the stage indices and the round-robin window
``_keep_idx`` bitwise, and every function within 1e-6 x the input's
scale."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import compress as jc
from repro_torch.interop import compress_spec_from_numpy
from repro_torch.optim import compress


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the JAX package's cases, on the port ---------------------------------

def test_butterfly_basis_is_orthonormal():
    spec = compress.make_spec(width=64, ratio=1.0, device="cpu")
    x = torch.from_numpy(_x((5, 64), 1))
    coeffs = compress._butterfly(spec.theta, x, 64, adjoint=True)
    back = compress._butterfly(spec.theta, coeffs, 64, adjoint=False)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-5)
    np.testing.assert_allclose(float((coeffs ** 2).sum()),
                               float((x ** 2).sum()), rtol=1e-5)


def test_compress_roundtrip_identity_at_ratio_1():
    spec = compress.make_spec(width=64, ratio=1.0, device="cpu")
    leaf = torch.from_numpy(_x((130,), 2))
    compact = compress.compress(spec, leaf)
    back = compress.decompress(spec, compact, leaf.shape, leaf.dtype)
    np.testing.assert_allclose(back.numpy(), leaf.numpy(), atol=1e-5)


def test_error_feedback_identity_decomposition():
    """decompress(compress(g)) + residual(g) == g (orthonormal split)."""
    spec = compress.make_spec(width=64, ratio=0.25, device="cpu")
    leaf = torch.from_numpy(_x((200,), 3))
    low = compress.decompress(spec, compress.compress(spec, leaf),
                              leaf.shape, torch.float32)
    res = compress.residual(spec, leaf)
    np.testing.assert_allclose((low + res).numpy(), leaf.numpy(), atol=1e-5)


def _descend(step_of):
    spec = compress.make_spec(width=32, ratio=0.25, device="cpu")
    target = torch.from_numpy(_x((64,), 4 if step_of(1) else 5))
    w = torch.zeros(64)
    err = torch.zeros(64)
    for t in range(300):
        g = 2 * (w - target)
        g_c, err = compress.ef_roundtrip(spec, g, err, step=step_of(t))
        w = w - 0.05 * g_c
    return w, target


def test_ef_sgd_converges_despite_compression():
    """EF-compressed gradient descent still reaches the optimum (requires
    the round-robin kept window — a fixed window provably cannot)."""
    w, target = _descend(lambda t: t)
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=0.05)


def test_fixed_window_does_not_converge():
    """Negative control for the round-robin design decision."""
    w, target = _descend(lambda t: 0)
    assert float((w - target).abs().max()) > 0.1


def test_compression_ratio_bytes():
    spec = compress.make_spec(width=128, ratio=0.125, device="cpu")
    leaf = torch.zeros((1024,))
    compact = compress.compress(spec, leaf)
    assert tuple(compact.shape) == (8, 16)  # 1024/128 chunks x 16 kept
    assert compact.numel() * 8 == leaf.numel()


def test_tree_ef_small_leaves_passthrough():
    spec = compress.make_spec(width=64, ratio=0.25, device="cpu")
    grads = {"big": torch.ones((1 << 15,)), "small": torch.ones((8,))}
    errs = {"big": torch.zeros((1 << 15,)), "small": torch.zeros((8,))}
    new_g, new_e = compress.tree_ef_compress(spec, grads, errs)
    np.testing.assert_allclose(new_g["small"].numpy(), 1.0)  # untouched
    np.testing.assert_allclose(new_e["small"].numpy(), 0.0)


# -- parity with the JAX package ------------------------------------------

def _spec(width, ratio, seed=0):
    js = jc.make_spec(width, ratio, seed)
    return js, compress_spec_from_numpy(js.width, js.keep,
                                        np.asarray(js.theta), device="cpu")


def test_make_spec_shapes_match_jax():
    for width, ratio in ((64, 0.25), (128, 0.125), (16, 1.0), (32, 0.01)):
        js = jc.make_spec(width, ratio)
        ts = compress.make_spec(width, ratio, device="cpu")
        assert (ts.width, ts.depth, ts.keep) == (js.width, js.depth,
                                                 js.keep)
        assert tuple(ts.theta.shape) == js.theta.shape
        assert ts.theta.dtype == torch.float32
        assert float(ts.theta.abs().max()) <= np.pi
    again = compress.make_spec(64, 0.25, seed=3, device="cpu")
    assert torch.equal(again.theta,
                       compress.make_spec(64, 0.25, seed=3,
                                          device="cpu").theta)
    with pytest.raises(ValueError, match="power of two"):
        compress.make_spec(48, device="cpu")


@pytest.mark.parametrize("width", [16, 64, 256])
def test_stage_indices_bitwise(width):
    for k in range(int(np.log2(width)) + 2):
        for t, j in zip(compress._stage_indices(width, k, device="cpu"),
                        jc._stage_indices(width, k)):
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("step", [0, 1, 5, 7, 1000, 2 ** 26])
def test_keep_idx_bitwise(step):
    for width, ratio in ((64, 0.25), (128, 0.125), (32, 0.3)):
        js, ts = _spec(width, ratio)
        got = compress._keep_idx(ts, step)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jc._keep_idx(js, step)))
    js, ts = _spec(64, 0.25)
    np.testing.assert_array_equal(
        compress._keep_idx(ts, torch.tensor(step)).numpy(),
        np.asarray(jc._keep_idx(js, jnp.asarray(step))))


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=1e-6 * scale, rtol=0)


@pytest.mark.parametrize("shape", [(200,), (3, 70), (4, 64)])
@pytest.mark.parametrize("step", [0, 3])
def test_functions_match_jax(shape, step):
    js, ts = _spec(64, 0.25, seed=1)
    leaf = _x(shape, 11) * 3.0
    err = (_x(shape, 12) * 0.1).astype(np.float32)
    scale = float(np.abs(leaf).max())
    jl, tl = jnp.asarray(leaf), torch.from_numpy(leaf)
    x = _x((5, 64), 13)
    for adjoint in (False, True):
        _close(compress._butterfly(ts.theta, torch.from_numpy(x), 64,
                                   adjoint),
               jc._butterfly(js.theta, jnp.asarray(x), 64, adjoint),
               float(np.abs(x).max()))
    compact = compress.compress(ts, tl, step)
    _close(compact, jc.compress(js, jl, step), scale)
    _close(compress.decompress(ts, compact, shape, torch.float32, step),
           jc.decompress(js, jnp.asarray(compact.numpy()), shape,
                         jnp.float32, step), scale)
    _close(compress.residual(ts, tl, step), jc.residual(js, jl, step),
           scale)
    out, new_err = compress.ef_roundtrip(ts, tl, torch.from_numpy(err),
                                         step=step)
    jout, jerr = jc.ef_roundtrip(js, jl, jnp.asarray(err), step=step)
    _close(out, jout, scale)
    _close(new_err, jerr, scale)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape


def test_ef_roundtrip_dtypes_and_reduce_match_jax():
    js, ts = _spec(32, 0.25, seed=2)
    grad = _x((4, 32), 20)
    err = np.zeros((4, 32), np.float32)
    tg = torch.from_numpy(grad).to(torch.bfloat16)
    te = torch.from_numpy(err).to(torch.bfloat16)
    out, new_err = compress.ef_roundtrip(ts, tg, te,
                                         reduce_fn=lambda c: 2.0 * c,
                                         step=1)
    jout, jerr = jc.ef_roundtrip(js, jnp.asarray(grad, jnp.bfloat16),
                                 jnp.asarray(err, jnp.bfloat16),
                                 reduce_fn=lambda c: 2.0 * c, step=1)
    assert out.dtype == new_err.dtype == torch.bfloat16
    # bf16 outputs: one bf16 rounding apart at most
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(new_err.float().numpy(),
                               np.asarray(jerr, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_tree_ef_compress_matches_jax():
    js, ts = _spec(64, 0.25, seed=3)
    big, mid, small = _x((300, 64), 30), _x((70, 300), 31), _x((8,), 32)
    jtree = {"layers": [{"w": jnp.asarray(big)}, {"w": jnp.asarray(mid)}],
             "bias": [jnp.asarray(small)]}
    ttree = {"layers": [{"w": torch.from_numpy(big)},
                        {"w": torch.from_numpy(mid)}],
             "bias": [torch.from_numpy(small)]}
    jerr = jc.init_error(jtree)
    terr = compress.init_error(ttree)
    assert terr["layers"][0]["w"].dtype == torch.bfloat16
    assert not bool(terr["layers"][1]["w"].any())
    jg, je = jc.tree_ef_compress(js, jtree, jerr, min_size=1 << 14, step=2)
    tg, te = compress.tree_ef_compress(ts, ttree, terr, min_size=1 << 14,
                                       step=2)
    assert isinstance(tg["layers"], list) and isinstance(tg["layers"][0],
                                                          dict)
    jl, _ = jax.tree.flatten(jg)
    tl = [tg["bias"][0], tg["layers"][0]["w"], tg["layers"][1]["w"]]
    for got, want in zip(tl, jl):
        _close(got, want, 4.0 * float(np.abs(np.asarray(want)).max() + 1))
    assert tg["bias"][0] is ttree["bias"][0]              # passed through
    assert te["bias"][0] is terr["bias"][0]
    for got, want in zip([te["layers"][0]["w"], te["layers"][1]["w"]],
                         [je["layers"][0]["w"], je["layers"][1]["w"]]):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=2e-2)
    # tuples keep their type (the JAX package's map treats a tuple as a
    # pair leaf, so it is held on the port alone)
    pair = compress.tree_ef_compress(
        ts, (ttree["layers"][0]["w"],), (terr["layers"][0]["w"],), step=2)
    assert isinstance(pair[0], tuple) and isinstance(pair[1], tuple)
    assert torch.equal(pair[0][0], tg["layers"][0]["w"])


def test_init_error_abstract_is_meta():
    tree = {"a": torch.zeros((3, 4)), "b": [torch.zeros(5)]}
    out = compress.init_error_abstract(tree)
    want = jc.init_error_abstract({"a": jnp.zeros((3, 4)),
                                   "b": [jnp.zeros(5)]})
    for got, w in ((out["a"], want["a"]), (out["b"][0], want["b"][0])):
        assert got.device.type == "meta" and got.dtype == torch.bfloat16
        assert tuple(got.shape) == w.shape and w.dtype == jnp.bfloat16


def test_carried_spec_is_checked():
    with pytest.raises(ValueError, match="does not fit"):
        compress_spec_from_numpy(64, 16, np.zeros((5, 32)), device="cpu")
    with pytest.raises(ValueError, match="keep"):
        compress_spec_from_numpy(64, 0, np.zeros((6, 32)), device="cpu")
