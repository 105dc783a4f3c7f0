"""The port's dynamic subsystem against the JAX package's: graph
generators and update streams bitwise, the Hutchinson probe pass on
given probes within rtol 1e-5 of numpy on the JAX basis's dense
reconstruction, the estimator within rtol 0.3 of the exact residual at
256 probes (the reference's own bound: its probes cannot be reproduced,
so estimates are never matched draw for draw), drift scores, the Lemma-1
refresh on a carried basis within 1e-5, and the refit controller tick
for tick (actions and ``state_dict``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.dynamic as jdyn
import repro.graphs as jgraphs
from repro.core import ApproxEigenbasis as JaxBasis
from repro_torch import dynamic as tdyn
from repro_torch import graphs as tgraphs
from repro_torch.core import ApproxEigenbasis, laplacian
from repro_torch.dynamic.drift import _rademacher, _rel_residual_on
from repro_torch.interop import basis_from_numpy

N, B, G = 16, 3, 48
FIELDS = {"sym": ("i", "j", "c", "s", "sigma"),
          "general": ("kind", "i", "j", "a")}


def _same_batch(a, b):
    assert a.symmetric == b.symmetric
    for f in ("i", "j", "dw"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _carry(jb, sizes=None):
    """The port's basis of a JAX fit (tables bitwise the JAX packer's)."""
    factors = {k: np.asarray(getattr(jb.factors, k)) for k in FIELDS[jb.kind]}
    return basis_from_numpy(jb.kind, jb.n, factors, np.asarray(jb.spectrum),
                            objective=np.asarray(jb.objective),
                            sizes=sizes, device="cpu")


def _sym_laps(b=B, n=N, seed=0):
    return np.stack([laplacian(tgraphs.erdos_renyi(n, 0.3, seed=seed + s))
                     for s in range(b)])


def _perturbed(laps, rows, num_edges, seed=7):
    """``laps`` with a topology perturbation of the given rows, through the
    adjacency so each stays a Laplacian."""
    out = laps.copy()
    for r in rows:
        adj = np.diag(np.diag(laps[r])) - laps[r]
        np.fill_diagonal(adj, 0.0)
        batch = tgraphs.edge_perturbation(adj, num_edges, seed=seed + r)
        out[r] = laplacian(tdyn.apply_update(adj, batch))
    return out


@pytest.fixture(scope="module")
def sym_fit():
    laps = _sym_laps()
    jb = JaxBasis.fit(jnp.asarray(laps), G, n_iter=1)
    return laps, jb, _carry(jb)


# ---------------------------------------------------------------------------
# generators and streams: bitwise the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("community_graph", (20,)), ("erdos_renyi", (20, 0.3)),
    ("sensor_graph", (24, 5)), ("directed_variant", None)])
def test_static_generators_bitwise(name, args):
    for seed in (0, 3):
        if args is None:
            adj = tgraphs.erdos_renyi(20, seed=seed)
            got = tgraphs.directed_variant(adj, seed=seed)
            want = jgraphs.directed_variant(adj, seed=seed)
        else:
            got = getattr(tgraphs, name)(*args, seed=seed)
            want = getattr(jgraphs, name)(*args, seed=seed)
        _bitwise(got, want)
    assert sorted(tgraphs.GRAPHS) == sorted(jgraphs.GRAPHS)


@pytest.mark.parametrize("name", ["minnesota", "human_protein", "email",
                                  "facebook"])
def test_real_graph_standins_bitwise(name):
    got = tgraphs.real_graph_standin(name, seed=1)
    _bitwise(got, jgraphs.real_graph_standin(name, seed=1))


@pytest.mark.parametrize("directed", [False, True])
def test_update_generators_bitwise(directed):
    adj = tgraphs.community_graph(24, seed=2)
    if directed:
        adj = tgraphs.directed_variant(adj, seed=2)
    for seed in range(3):
        _same_batch(tgraphs.edge_perturbation(adj, 30, seed=seed,
                                              directed=directed),
                    jgraphs.edge_perturbation(adj, 30, seed=seed,
                                              directed=directed))
        _same_batch(tgraphs.weight_jitter(adj, 10, seed=seed,
                                          directed=directed),
                    jgraphs.weight_jitter(adj, 10, seed=seed,
                                          directed=directed))
    a0, batches = tgraphs.evolving_erdos_renyi(20, churn=0.05, steps=3,
                                               seed=4, directed=directed)
    j0, jbatches = jgraphs.evolving_erdos_renyi(20, churn=0.05, steps=3,
                                                seed=4, directed=directed)
    _bitwise(a0, j0)
    for a, b in zip(batches, jbatches, strict=True):
        _same_batch(a, b)
    with pytest.raises(ValueError, match="scale"):
        tgraphs.weight_jitter(adj, 3, scale=1.0)
    with pytest.raises(ValueError, match="churn"):
        tgraphs.evolving_erdos_renyi(8, churn=0.0)


@pytest.mark.parametrize("directed", [False, True])
def test_stream_deltas_bitwise(directed):
    adjs = [tgraphs.community_graph(n, seed=s)
            for s, n in enumerate([10, 14])]
    if directed:
        adjs = [tgraphs.directed_variant(a, seed=s)
                for s, a in enumerate(adjs)]
    ts = tdyn.GraphStream(adjs, directed=directed)
    js = jdyn.GraphStream(adjs, directed=directed)
    assert ts.sizes == js.sizes == [10, 14]
    for rnd in range(3):
        for gid in range(2):
            batch = tgraphs.edge_perturbation(ts.adjs[gid], 6,
                                              seed=10 * rnd + gid,
                                              directed=directed)
            _bitwise(tdyn.delta_adjacency(batch, ts.sizes[gid]),
                     jdyn.delta_adjacency(batch, js.sizes[gid]))
            _bitwise(ts.apply(gid, batch), js.apply(gid, batch))
            _bitwise(ts.adjs[gid], js.adjs[gid])
            _bitwise(ts.laplacian(gid), js.laplacian(gid))
    assert ts.updates_applied.tolist() == js.updates_applied.tolist()
    for a, b in zip(ts.laplacians(), js.laplacians(), strict=True):
        _bitwise(a, b)
    wrong = tdyn.UpdateBatch(np.array([0]), np.array([1]),
                             np.array([1.0], np.float32),
                             symmetric=directed)
    with pytest.raises(ValueError, match="directed"):
        ts.apply(0, wrong)


def test_update_batch_validation_and_merge():
    with pytest.raises(ValueError, match="off-diagonal"):
        tdyn.make_update_batch([0], [0], [1.0])
    with pytest.raises(ValueError, match="one length"):
        tdyn.make_update_batch([0, 1], [2], [1.0])
    with pytest.raises(ValueError, match=">= n"):
        tdyn.laplacian_delta(tdyn.make_update_batch([0], [9], [1.0]), 4)
    a = tdyn.make_update_batch([0], [1], [1.0])
    b = tdyn.make_update_batch([2], [3], [-1.0])
    _same_batch(tdyn.merge_batches([a, b]),
                jdyn.merge_batches([jdyn.make_update_batch([0], [1], [1.0]),
                                    jdyn.make_update_batch([2], [3],
                                                           [-1.0])]))
    assert tdyn.merge_batches([]) is None
    with pytest.raises(ValueError, match="merge"):
        tdyn.merge_batches([a, tdyn.make_update_batch([0], [1], [1.0],
                                                      symmetric=False)])
    adj = tgraphs.community_graph(12, seed=0)
    batch = tgraphs.edge_perturbation(adj, 5, seed=1)
    np.testing.assert_allclose(
        laplacian(adj) + tdyn.laplacian_delta(batch, 12),
        laplacian(tdyn.apply_update(adj, batch)), atol=1e-6)


# ---------------------------------------------------------------------------
# drift: the probe pass, the estimator, the score
# ---------------------------------------------------------------------------


def _numpy_probe_pass(recon, laps, z):
    """mean_k ||(L - recon) z_k||^2 / ||L||_F^2 in float64 numpy."""
    resid = np.asarray(laps, np.float64) - np.asarray(recon, np.float64)
    rz = np.einsum("...ij,kj->...ki", resid, z.astype(np.float64))
    den = (np.asarray(laps, np.float64) ** 2).sum((-2, -1))
    return (rz ** 2).sum(-1).mean(-1) / den


@pytest.mark.parametrize("case", ["sym", "sym-single", "general",
                                  "sym-ragged"])
def test_probe_pass_on_given_probes_matches_numpy(case):
    """The port's probe pass (einsum + the operator plan) on GIVEN
    probes, against numpy on the JAX basis's dense reconstruction."""
    rng = np.random.default_rng(5)
    sizes = None
    if case == "general":
        mats = np.stack([laplacian(tgraphs.directed_variant(
            tgraphs.community_graph(12, seed=s), seed=s)) for s in range(2)])
        jb = JaxBasis.fit(jnp.asarray(mats), 36, n_iter=1, kind="general")
    elif case == "sym-ragged":
        from repro.core import pad_ragged
        # members with a real residual: a near-exact fit's residual sits
        # at f32 cancellation level (~2 eps sqrt(r))
        fleet = [laplacian(tgraphs.community_graph(n, seed=s))
                 for s, n in enumerate([12, 16, 14])]
        stack, sizes = pad_ragged(fleet)
        mats = np.array(stack)
        jb = JaxBasis.fit(fleet, 24, n_iter=1)
    else:
        mats = _sym_laps()
        if case == "sym-single":
            mats = mats[1]
        jb = JaxBasis.fit(jnp.asarray(mats), G, n_iter=1)
    tb = _carry(jb, sizes=sizes)
    z = (2 * rng.integers(0, 2, (8, tb.n)) - 1).astype(np.float32)
    want = _numpy_probe_pass(np.asarray(jb.reconstruct()), mats, z)
    assert np.all(want > 1e-4)
    got = _rel_residual_on(tb, mats, z)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(tdyn.exact_rel_residual(tb, mats),
                               jdyn.exact_rel_residual(jb, mats), rtol=1e-5)


def test_probes_are_seeded_rademacher():
    a = _rademacher(64, 16, 3, "cpu")
    assert a.shape == (64, 16) and a.dtype == torch.float32
    assert set(torch.unique(a).tolist()) == {-1.0, 1.0}
    assert torch.equal(a, _rademacher(64, 16, 3, "cpu"))
    assert not torch.equal(a, _rademacher(64, 16, 4, "cpu"))


@pytest.mark.parametrize("case", ["sym", "general", "sym-ragged"])
def test_estimate_matches_exact(case):
    if case == "general":
        mats = np.random.default_rng(0).standard_normal(
            (2, 12, 12)).astype(np.float32)
        basis = ApproxEigenbasis.fit(mats, 24, n_iter=1, kind="general",
                                     device="cpu")
    elif case == "sym-ragged":
        fleet = [laplacian(tgraphs.community_graph(n, seed=s))
                 for s, n in enumerate([9, 16, 12])]
        basis = ApproxEigenbasis.fit(fleet, G, n_iter=1, device="cpu")
        mats = np.zeros((3, 16, 16), np.float32)
        for b, lap in enumerate(fleet):
            mats[b, :lap.shape[0], :lap.shape[0]] = lap
    else:
        mats = _sym_laps()
        basis = ApproxEigenbasis.fit(mats, 32, n_iter=1, device="cpu")
    exact = tdyn.exact_rel_residual(basis, mats)
    est = tdyn.estimate_rel_residual(basis, mats, num_probes=256, seed=2)
    np.testing.assert_allclose(est, exact, rtol=0.3, atol=1e-4)


def test_drift_score_zero_on_own_laps_and_monotone():
    laps = _sym_laps()
    basis = ApproxEigenbasis.fit(laps, G, n_iter=1, device="cpu")
    base = tdyn.drift_score(basis, laps, num_probes=128)
    assert base.shape == (B,) and np.all(base < 0.01)
    prev = base[1]
    for num_edges in (4, 12, 30):          # growing perturbation
        pert = _perturbed(laps, [1], num_edges)
        d = tdyn.drift_score(basis, pert, num_probes=128)
        assert d[1] > prev - 1e-6 and d[1] > base[1]
        assert d[0] == pytest.approx(base[0], abs=1e-6)  # untouched rows
        prev = d[1]
    from dataclasses import replace
    with pytest.raises(ValueError, match="baseline"):
        tdyn.drift_score(replace(basis, objective=None), laps)
    single = tdyn.drift_score(basis_from_numpy(
        "sym", N, {k: getattr(basis.factors, k)[0].numpy()
                   for k in FIELDS["sym"]}, basis.spectrum[0].numpy(),
        objective=basis.objective[0].numpy(), device="cpu"), laps[0])
    assert np.ndim(single) == 0 and single < 0.01


def test_relative_objective_matches_reference(sym_fit):
    laps, jb, tb = sym_fit
    np.testing.assert_allclose(
        tdyn.relative_objective(tb.objective, laps),
        jdyn.relative_objective(jb.objective, laps), rtol=1e-6)


def test_lemma1_refresh_on_carried_basis_matches_jax(sym_fit):
    laps, jb, tb = sym_fit
    pert = _perturbed(laps, [0, 2], 6)
    got = tdyn.lemma1_refresh(tb, pert).numpy()
    want = np.asarray(jdyn.lemma1_refresh(jb, jnp.asarray(pert)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    k = int(tb.stage_cuts[1, 0])
    np.testing.assert_allclose(
        tdyn.prefix_spectrum(tb, pert, k).numpy(),
        np.asarray(jdyn.prefix_spectrum(jb, jnp.asarray(pert), k)),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="symmetric"):
        from dataclasses import replace
        tdyn.lemma1_refresh(replace(tb, kind="general"), pert)


# ---------------------------------------------------------------------------
# the refit controller, tick for tick against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(refresh=0.5, extend=0.1), dict(refresh=0.0), dict(hysteresis=0.0),
    dict(hysteresis=1.5), dict(extend_fraction=0.0), dict(max_extends=-1),
    dict(num_probes=0)])
def test_policy_validation_matches_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jdyn.RefitPolicy(**kwargs)
    with pytest.raises(ValueError) as got:
        tdyn.RefitPolicy(**kwargs)
    assert str(got.value) == str(want.value)


#: (drift, can_refresh, post-action drift): a script through every
#: threshold, hysteresis escalation and its saturation, the general
#: family's escalation, the max_extends budget and quiescent REUSE ticks
SCRIPT = [([0.001], True, None), ([0.05], True, [0.02]),
          ([0.05], True, [0.001]), ([0.05], True, [0.001]),
          ([], True, None), ([0.2], True, [0.15]), ([0.2], True, [0.001]),
          ([0.05], False, [0.03]), ([0.05], False, [0.001]),
          ([0.9], True, [0.9]), ([0.9], True, [0.001]),
          ([0.3], True, [0.001]), ([0.3], True, [0.001]),
          ([0.3], True, [0.001]), ([0.002], True, None),
          ([0.04, 0.001], True, [0.004, 0.0])]


@pytest.mark.parametrize("max_extends", [0, 2, 4])
def test_controller_matches_reference_tick_for_tick(max_extends):
    kw = dict(refresh=0.01, extend=0.1, refit=0.5, hysteresis=0.5,
              max_extends=max_extends)
    tc = tdyn.RefitController(tdyn.RefitPolicy(**kw))
    jc = jdyn.RefitController(jdyn.RefitPolicy(**kw))
    for drift, can_refresh, post in SCRIPT:
        act = tc.decide(drift, can_refresh=can_refresh)
        assert act.value == jc.decide(drift, can_refresh=can_refresh).value
        post = [0.0] if post is None or act.value == "reuse" else post
        tc.record(act, post, drift=drift)
        jc.record(jdyn.Action(act.value), post, drift=drift)
        assert tc.state_dict() == jc.state_dict()
        assert tc.timeline[-1] == jc.timeline[-1]
    assert len(tc.timeline) == len(SCRIPT)
    back = tdyn.RefitController(tc.policy)
    back.load_state_dict(jc.state_dict())
    assert back.state_dict() == tc.state_dict()
    for drift, can_refresh, _ in SCRIPT:
        assert back.decide(drift, can_refresh) is tc.decide(drift,
                                                             can_refresh)
