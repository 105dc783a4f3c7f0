"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's ``repro.optim.adamw`` on the CPU.

The four AdamW cases of tests/test_optim.py run on the port.  Then
``update``, ``clip_by_global_norm``, ``global_norm`` and
``warmup_cosine`` on carried trees: the JAX functions and the port's do
each elementwise operation in the same order and dtype, but a sum of a
leaf's squares is reduced in each library's own order (XLA's vectorised
tree against torch's), so the global norm, and with it the clip scale
and everything after, may differ in the last f32 bits: each leaf is
held within 1e-6 x max|leaf| (a bf16 moment within one bf16 ulp of its
max, 2^-8, where the f32 moments round to neighbouring bf16 values).
The warmup ramp, one product and one quotient, is held bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

REL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((5, 7)).astype(np.float32) * scale,
                  "bias": rng.standard_normal(7).astype(np.float32) * scale},
            "a": rng.standard_normal((3, 4, 2)).astype(np.float32) * scale,
            "z": rng.standard_normal(11).astype(np.float32) * scale}


def _t(tree):
    return adamw.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = rel * float(np.abs(want).max()) if want.size else 0.0
    assert err <= bound, f"max|d| {err:.3e} > {bound:.3e}"


def _leaves_close(got_tree, want_tree, rel=REL):
    got = adamw.tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, rel)


# ---------------------------------------------------------------------------
# tests/test_optim.py's AdamW cases on the port
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    target = torch.from_numpy(np.random.default_rng(0)
                              .standard_normal(32).astype(np.float32))
    params = {"w": torch.zeros(32)}
    opt = adamw.init(params)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw.update(g, opt, params, lr=0.05,
                                      weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 10.0), "b": torch.full((9,), 10.0)}
    clipped, norm = adamw.clip_by_global_norm(tree, 1.0)
    got = float(adamw.global_norm(clipped))
    np.testing.assert_allclose(got, 1.0, rtol=1e-5)
    assert float(norm) > 1.0
    small = {"a": torch.full((4,), 1e-3)}
    kept, _ = adamw.clip_by_global_norm(small, 1.0)
    np.testing.assert_allclose(kept["a"].numpy(), small["a"].numpy())


def test_warmup_cosine_schedule():
    lr0 = adamw.warmup_cosine(torch.tensor(0), peak_lr=1e-3, warmup=10,
                              total=100)
    lr_peak = adamw.warmup_cosine(torch.tensor(10), peak_lr=1e-3,
                                  warmup=10, total=100)
    lr_end = adamw.warmup_cosine(torch.tensor(100), peak_lr=1e-3,
                                 warmup=10, total=100)
    assert float(lr0) == 0.0
    np.testing.assert_allclose(float(lr_peak), 1e-3, rtol=1e-5)
    np.testing.assert_allclose(float(lr_end), 1e-4, rtol=1e-3)  # floor 0.1


def test_moment_dtype():
    params = {"w": torch.zeros(8)}
    opt = adamw.init(params, moment_dtype=torch.bfloat16)
    assert opt.mu["w"].dtype == torch.bfloat16
    g = {"w": torch.ones(8)}
    p2, o2, _ = adamw.update(g, opt, params, lr=1e-2)
    assert o2.mu["w"].dtype == torch.bfloat16
    assert p2["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# against the JAX functions
# ---------------------------------------------------------------------------

def test_tree_leaves_follow_the_jax_order():
    tree = _tree(0)
    got = [a.shape for a in adamw.tree_leaves(_t(tree))]
    assert got == [a.shape for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_global_norm_and_clip_match_jax(scale):
    """Above the clip (scale 1) and below it (the tree kept as it is)."""
    tree = _tree(1, scale)
    _close(adamw.global_norm(_t(tree)), jadamw.global_norm(tree))
    got, gn = adamw.clip_by_global_norm(_t(tree), 1.0)
    want, wn = jadamw.clip_by_global_norm(tree, 1.0)
    _close(gn, wn)
    _leaves_close(got, want)


@pytest.mark.parametrize("warmup,total", [(20, 100), (0, 7), (5, 5)])
def test_warmup_cosine_matches_jax(warmup, total):
    for step in range(0, total + 3):
        got = adamw.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                  peak_lr=3e-4, warmup=warmup, total=total)
        want = jadamw.warmup_cosine(jnp.asarray(step, jnp.int32),
                                    peak_lr=3e-4, warmup=warmup,
                                    total=total)
        assert got.dtype == torch.float32
        _close(got, want)
        if step <= warmup:   # the warmup ramp: a product and a quotient
            assert float(got) == float(want), (step, float(got),
                                               float(want))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_update_matches_jax_on_carried_trees(moments):
    """Five steps of ``update`` on the same parameters and gradients, with
    the schedule's lr, weight decay and the clip active: parameters,
    moments, step and grad norm after each."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[moments]
    params = _tree(2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _t(params)
    jo, to = jadamw.init(jp, jd), adamw.init(tp, td)
    for k in range(5):
        grads = _tree(10 + k, scale=0.5 if k % 2 else 3.0)
        lr_j = jadamw.warmup_cosine(jo.step, peak_lr=1e-2, warmup=2,
                                    total=5)
        lr_t = adamw.warmup_cosine(to.step, peak_lr=1e-2, warmup=2,
                                   total=5)
        jp, jo, jm = jadamw.update(jax.tree.map(jnp.asarray, grads), jo, jp,
                                   lr=lr_j)
        tp, to, tm = adamw.update(_t(grads), to, tp, lr=lr_t)
        assert int(to.step) == int(jo.step) == k + 1
        assert to.step.dtype == torch.int32
        _close(tm["grad_norm"], jm["grad_norm"])
        _leaves_close(tp, jp)
        rel = REL if moments == "float32" else 2.0 ** -8
        _leaves_close(to.mu, jo.mu, rel)
        _leaves_close(to.nu, jo.nu, rel)
        for m in adamw.tree_leaves(to.mu) + adamw.tree_leaves(to.nu):
            assert m.dtype == td


def test_update_writes_in_place():
    params = _t(_tree(3))
    ptrs = [p.data_ptr() for p in adamw.tree_leaves(params)]
    opt = adamw.init(params)
    new, opt2, _ = adamw.update(_t(_tree(4)), opt, params, lr=1e-3)
    assert [p.data_ptr() for p in adamw.tree_leaves(new)] == ptrs
    assert opt2.mu is opt.mu and int(opt.step) == 0 and int(opt2.step) == 1


def test_init_abstract_is_meta():
    opt = adamw.init_abstract(_t(_tree(0)), torch.bfloat16)
    assert opt.step.device.type == "meta" and opt.step.dtype == torch.int32
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in adamw.tree_leaves(opt.mu) + adamw.tree_leaves(opt.nu))
