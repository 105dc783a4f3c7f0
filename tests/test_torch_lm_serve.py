"""The port's LM serving engine (``repro_torch.launch.serve.ServeEngine``,
``serve --arch``) against the JAX package's, on the CPU at the configs'
smoke sizes, with the JAX engine's weights carried across
(``interop.lm_params_from_numpy``).

The JAX engine prefills a slot by running all slots with zero tokens in
the others, which overwrites the other slots' caches at the prompt's
positions (ROADMAP.md C4); the port's prefill is slot-local, so the two
are compared with one slot, and the port's multi-slot engine is held to
the same requests served alone.  Tolerance: 1e-4 * max(1, max|logits|)
at f32, 1e-2 * max(1, max|logits|) at bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm

#: one architecture of each family beside the dense ones (their parity
#: tests: tests/test_torch_lm_families_serve.py)
FAMILIES = ["qwen3-moe-30b-a3b", "recurrentgemma-2b", "mamba2-780m",
            "llama-3.2-vision-90b", "seamless-m4t-large-v2"]
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _cfgs(arch, dtype):
    return (jget_config(arch, smoke=True).replace(dtype=getattr(jnp, dtype)),
            get_config(arch, smoke=True).replace(dtype=getattr(torch, dtype)))


def _prompts(cfg, count, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, length).astype(np.int32)
            for _ in range(count)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max|d| {err:.3e} > {bound:.3e}"


def _model_of(jengine, tcfg):
    tree = jax.tree.map(np.asarray, jengine.params)
    return tfm.Transformer(tcfg, lm_params_from_numpy(tcfg, tree,
                                                      device="cpu"))


def _recorder():
    seen = {}

    def on_logits(rid, logits):
        seen.setdefault(rid, []).append(logits.clone())
    return seen, on_logits


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-27b"])
def test_one_slot_engine_matches_the_jax_engine(arch, monkeypatch):
    jcfg, tcfg = _cfgs(arch, "float32")
    jeng = jserve.ServeEngine(jcfg, 1, 64)
    teng = serve.ServeEngine(tcfg, 1, 64, model=_model_of(jeng, tcfg))
    # both caches in f32: the engines' bf16 caches would round f32 K/V
    # that differ in their last ulp a bf16 ulp apart now and then
    jeng.cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                              if a.dtype == jnp.bfloat16 else a, jeng.cache)
    teng.cache = tfm.init_cache(tcfg, 1, 64, "cpu", dtype=torch.float32)
    jlogits = []
    real_prefill, real_decode = jtfm.prefill, jeng._decode

    def prefill(*a, **kw):
        out = real_prefill(*a, **kw)
        jlogits.append(out[0][0, -1])
        return out

    def decode(*a):
        # ROADMAP.md C5: the JAX engine increments ``self.pos`` in place
        # right after this call, and ``jnp.asarray`` may alias that numpy
        # buffer on the CPU: finish the step before it returns
        out = jax.block_until_ready(real_decode(*a))
        jlogits.append(out[0][0, 0])
        return out

    monkeypatch.setattr(jtfm, "prefill", prefill)
    jeng._decode = decode
    prompts = _prompts(tcfg, 3, 12, seed=1)
    want = serve.run_requests(jeng, prompts, 5, np.random.default_rng(0))
    seen, on_logits = _recorder()
    got = serve.run_requests(teng, prompts, 5, on_logits=on_logits)
    assert got["outputs"] == want["outputs"]
    ours = [t for rid in sorted(seen) for t in seen[rid]]
    assert len(ours) == len(jlogits) == 3 * 5
    for g, w in zip(ours, jlogits):
        _close(g, w, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-27b"])
def test_slots_give_each_request_what_it_gets_alone(arch, dtype):
    """Six requests through four slots (two slots are reused) against each
    request alone in a one-slot engine on the same model, fed the same
    tokens."""
    _, cfg = _cfgs(arch, dtype)
    model = tfm.Transformer(cfg, tfm.init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu"))
    prompts = _prompts(cfg, 6, 10, seed=3)
    seen, on_logits = _recorder()
    out = serve.run_requests(serve.ServeEngine(cfg, 4, 32, model=model),
                             prompts, 6, on_logits=on_logits)
    alone = serve.ServeEngine(cfg, 1, 32, model=model)
    for rid, prompt in enumerate(prompts):
        toks = out["outputs"][rid]
        assert len(toks) == 6 and len(seen[rid]) == 6
        alone.prefill_slot(0, prompt)
        _close(alone.logits[0], seen[rid][0], TOL[dtype])
        for step in range(1, 6):
            alone.decode(np.array([toks[step - 1]], np.int32))
            _close(alone.logits[0], seen[rid][step], TOL[dtype])
            if dtype == "float32":
                assert int(alone.logits[0].argmax()) == toks[step]


def test_jax_engine_prefill_overwrites_other_slots():
    """ROADMAP.md C4: the JAX engine's ``prefill_slot(1, ...)`` rewrites
    slot 0's cache at the prompt's positions (it prefills every slot);
    the port's leaves slot 0 bitwise as it was."""
    jcfg, tcfg = _cfgs("qwen2-1.5b", "bfloat16")
    jeng = jserve.ServeEngine(jcfg, 2, 32)
    teng = serve.ServeEngine(tcfg, 2, 32, model=_model_of(jeng, tcfg))
    p0, p1 = _prompts(tcfg, 2, 8, seed=4)
    rng = np.random.default_rng(0)
    for eng in (jeng, teng):
        eng.prefill_slot(0, p0, rng)
    jk0 = np.asarray(jeng.cache["dense"]["attn"]["k"][:, 0, :8]
                     .astype(jnp.float32))
    tk0 = teng.cache["dense"]["attn"]["k"][:, 0].clone()
    for eng in (jeng, teng):
        eng.prefill_slot(1, p1, rng)
    jk0_after = np.asarray(jeng.cache["dense"]["attn"]["k"][:, 0, :8]
                           .astype(jnp.float32))
    assert float(np.abs(jk0_after - jk0).max()) > 0.1
    assert torch.equal(teng.cache["dense"]["attn"]["k"][:, 0], tk0)
    # the slot the port filled holds what the JAX engine wrote there
    np.testing.assert_allclose(
        teng.cache["dense"]["attn"]["k"][:, 1, :8].float().numpy(),
        np.asarray(jeng.cache["dense"]["attn"]["k"][:, 1, :8]
                   .astype(jnp.float32)), atol=2e-2)


def test_cli_serves_an_arch_on_the_cpu(capsys):
    out = serve.main(["--arch", "qwen2-1.5b", "--smoke", "--requests", "4",
                      "--prompt-len", "16", "--gen-len", "8",
                      "--device", "cpu"])
    toks = out["outputs"]
    assert sorted(toks) == [0, 1, 2, 3]
    assert all(len(t) == 8 for t in toks.values())
    vocab = out["engine"].cfg.vocab
    assert all(0 <= x < vocab for t in toks.values() for x in t)
    assert out["tokens"] == 32 and len(out["prefill_s"]) == 4
    assert "served 4 requests, 32 tokens, " in capsys.readouterr().out


def test_cli_prompts_are_the_jax_clis():
    """The same --seed draws the same prompts as the JAX CLI."""
    args = serve.parse_args(["--arch", "qwen2-1.5b", "--smoke",
                             "--requests", "3", "--prompt-len", "5",
                             "--gen-len", "2", "--device", "cpu"])
    out = serve.serve_lm(args)
    rng = np.random.default_rng(0)
    want = [rng.integers(0, 128, 5).astype(np.int32) for _ in range(3)]
    assert all(np.array_equal(a, b) for a, b in zip(out["prompts"], want))


@pytest.mark.parametrize("arch", FAMILIES)
def test_cli_refuses_unported_families(arch):
    """These families were refused until their blocks were ported; now
    the CLI takes them and a one-slot engine serves a token."""
    args = serve.parse_args(["--arch", arch, "--device", "cpu"])
    assert args.arch == arch and not args.fgft
    cfg = get_config(arch, smoke=True)
    engine = serve.ServeEngine(cfg, 1, 8, device="cpu")
    tok = engine.prefill_slot(0, np.arange(4, dtype=np.int32),
                              np.random.default_rng(0))
    assert 0 <= tok < cfg.vocab
    assert engine.decode(np.array([tok], np.int32)).shape == (1,)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-27b"])
def test_lm_params_from_numpy_round_trips_the_jax_tree(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    params, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, params)
    back = tfm.Transformer(tcfg, lm_params_from_numpy(
        tcfg, tree, device="cpu")).params_tree()
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), leaf), path
