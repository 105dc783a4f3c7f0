"""The port's public API against the JAX package's, where reference code
calls it:

* ``FGFT.filter(x, h, backend, num_stages, precision, fused)`` on a
  single-graph fit made by the JAX package and carried across (its
  factors packed by the port) equals the JAX ``FGFT.filter`` within
  ``1e-5 * max(1, max|y|)`` (the tolerance of test_torch_serve.py's
  parity tests) — undirected and directed, n = 16 and 32, the full chain
  and a mid cut, fused and three-pass; ``project`` is ``filter`` with
  the identity default, and bf16 tables are refused as ``ApplyPlan``
  refuses them;
* ``hint=`` on ``ApproxEigenbasis.fit`` and ``FGFTServeEngine``: an
  unknown hint raises the JAX package's ``ValueError``; ``kind="auto"``
  resolving against the hint warns with the JAX package's text, at the
  caller's line; an agreeing hint, or a forced kind, does not warn;
* ``repro_torch.kernels`` exports every name the JAX package's
  ``repro.kernels`` exports (``ApplyPlan`` and the kernel submodules)
  but ``autotune``, which is not ported, and ``plan.plan_cache_size()``
  counts resident programs as the JAX package's does."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ApproxEigenbasis as JaxBasis
from repro.core import build_fgft as jax_build_fgft
from repro_torch.core import ApproxEigenbasis, laplacian
from repro_torch.core.fgft import FGFT
from repro_torch.core.staging import pack_g_pair, pack_t_pair
from repro_torch.core.types import GFactors, TFactors
from repro_torch.graphs import community_graph, directed_variant
from repro_torch.launch.serve import FGFTServeEngine


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _lap(n, directed):
    adj = community_graph(n, seed=3)
    if directed:
        adj = directed_variant(adj, seed=3)
    return laplacian(adj)


def _carried_fgft(jf, directed):
    """The port's FGFT of a JAX single-graph fit: its factors packed by
    the port's packer (bitwise the JAX tables)."""
    n = jf.n
    if directed:
        f = TFactors(*(torch.from_numpy(np.asarray(a).copy())
                       for a in jf.t_factors))
        fwd, bwd = pack_t_pair(f, n, device="cpu")
        g = None
    else:
        g = GFactors(*(torch.from_numpy(np.asarray(a).copy())
                       for a in jf.g_factors))
        fwd, bwd = pack_g_pair(g, n=n, device="cpu")
        f = None
    return FGFT(n=n, spectrum=torch.from_numpy(np.array(jf.spectrum)),
                g_factors=g, fwd=fwd, bwd=bwd, directed=directed,
                t_factors=f)


@pytest.mark.parametrize("directed", [False, True],
                         ids=["undirected", "directed"])
@pytest.mark.parametrize("n", [16, 32])
def test_fgft_filter_matches_jax(n, directed):
    lap = _lap(n, directed)
    jf = jax_build_fgft(jnp.asarray(lap), 3 * n, directed=directed,
                        n_iter=1)
    f = _carried_fgft(jf, directed)
    for js, ts in ((jf.fwd, f.fwd), (jf.bwd, f.bwd)):
        for a, b in zip(js[:len(ts) - 2], ts[:len(ts) - 2]):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
    x = np.random.default_rng(n).standard_normal((7, n)).astype(np.float32)
    xt = torch.from_numpy(x)
    mid = int(f.stage_cuts[len(f.stage_cuts) // 2, 0])
    for k in (None, mid):
        want = jf.filter(jnp.asarray(x), lambda s: jnp.exp(-0.3 * s),
                         num_stages=k)
        for fused in (True, False):
            _close(f.filter(xt, lambda s: torch.exp(-0.3 * s), num_stages=k,
                            fused=fused), want)
        _close(f.project(xt, num_stages=k),
               jf.filter(jnp.asarray(x), lambda s: s, num_stages=k))
    # bf16 table storage with f32 accumulation, fused and three-pass
    for k in (None, mid):
        want = jf.filter(jnp.asarray(x), lambda s: jnp.exp(-0.3 * s),
                         num_stages=k, precision="bf16")
        for fused in (True, False):
            _close(f.filter(xt, lambda s: torch.exp(-0.3 * s), num_stages=k,
                            precision="bf16", fused=fused), want)


def _sym_laps(n=16, batch=2):
    return np.stack([laplacian(community_graph(n, seed=s))
                     for s in range(batch)])


def test_unknown_hint_raises_the_reference_error():
    laps = _sym_laps()
    with pytest.raises(ValueError) as want:
        JaxBasis.fit(jnp.asarray(laps), 8, n_iter=1, hint="bogus")
    with pytest.raises(ValueError) as got:
        ApproxEigenbasis.fit(laps, 8, n_iter=1, hint="bogus", device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown hint 'bogus'"):
        FGFTServeEngine(laps, 8, n_iter=1, hint="bogus", device="cpu")


def test_auto_against_the_hint_warns_as_the_reference():
    laps = _sym_laps()
    with pytest.warns(UserWarning) as want:
        JaxBasis.fit(jnp.asarray(laps), 8, n_iter=1, hint="general")
    with pytest.warns(UserWarning) as got:
        basis = ApproxEigenbasis.fit(laps, 8, n_iter=1, hint="general",
                                     device="cpu")
    assert basis.kind == "sym"
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert "overriding the caller hint 'general'" in str(got[0].message)
    assert got[0].filename == __file__           # stacklevel=2: the caller


def test_agreeing_hint_or_forced_kind_does_not_warn():
    laps = _sym_laps()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ApproxEigenbasis.fit(laps, 8, n_iter=1, hint="sym",
                                    device="cpu").kind == "sym"
        assert ApproxEigenbasis.fit(laps, 8, n_iter=1, kind="general",
                                    hint="sym", device="cpu").kind == \
            "general"


def test_engine_passes_the_hint_through():
    laps = _sym_laps()
    with pytest.warns(UserWarning, match="overriding the caller hint"):
        eng = FGFTServeEngine(laps, 8, n_iter=1, hint="general",
                              device="cpu")
    assert eng.basis.kind == "sym"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        FGFTServeEngine(laps, 8, n_iter=1, hint="sym", device="cpu")


#: names of the JAX package's ``repro.kernels`` that are not ported
NOT_PORTED: set = set()


def test_kernels_package_exports_the_reference_names():
    import repro.kernels as jk
    import repro_torch.kernels as tk
    from repro.kernels.plan import ApplyPlan as JaxPlan
    want = {name for name in dir(jk) if not name.startswith("_")}
    assert "ApplyPlan" in want and NOT_PORTED <= want
    for name in sorted(want - NOT_PORTED):
        assert hasattr(tk, name), name
    for name in NOT_PORTED:
        assert not hasattr(tk, name), name
    assert tk.ApplyPlan is tk.plan.ApplyPlan
    assert tk.ApplyPlan.__name__ == JaxPlan.__name__
    assert tk.autotune.BLOCK_B_CANDIDATES == jk.autotune.BLOCK_B_CANDIDATES


def test_core_package_exports_the_reference_names():
    import repro.core as jc
    import repro_torch.core as tc
    want = {name for name in dir(jc) if not name.startswith("_")}
    assert {"truncated_jacobi", "compress_linear", "fft_pattern"} <= want
    missing = sorted(name for name in want if not hasattr(tc, name))
    assert not missing, missing
    for name in ("ButterflyParams", "ButterflyPattern", "CompressedLinear"):
        assert getattr(tc, name)._fields == getattr(jc, name)._fields


def test_plan_cache_size_counts_programs_as_the_reference():
    from repro.kernels import plan as jplan
    from repro_torch.kernels import plan as tplan
    sizes = []
    for mod, kw in ((jplan, {}), (tplan, {"device": "cpu"})):
        mod.clear_plan_cache()
        got = [mod.plan_cache_size()]
        for mode in ("apply", "operator", "apply"):
            mod.ApplyPlan(family="sym", mode=mode, n=8, **kw).program()
            got.append(mod.plan_cache_size())
        assert got[-1] == mod.plan_cache_stats()["currsize"]
        sizes.append(got)
    assert sizes[0] == sizes[1] == [0, 1, 2, 2]
