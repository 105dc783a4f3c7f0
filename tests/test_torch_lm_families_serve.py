"""The port's ``ServeEngine`` for the MoE, SSM, hybrid, vision and audio
families against the JAX package's, on the CPU at the configs' smoke
sizes, with the JAX engine's weights carried across
(``interop.lm_params_from_numpy``) and its cross-attention gates set to
0.5 (their init, 0, would hide the memory).

Both engines draw each request's memory from the same seeded ``rng`` by
the JAX engine's rule.  The JAX engine keeps the whole draw as every
slot's memory, redrawn at each prefill (ROADMAP.md C7), and decodes
audio on the raw frames (C6); the port keeps the prefilled slot's row,
encoded for audio.  So the engines are compared with one slot, and the
audio engine against ``tfm.prefill``/``decode_step`` on the encoded
memory.  Tolerance: 1e-4 * max(1, max|logits|) at f32, 1e-2 at bf16.
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

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
GATE = 0.5


def _cfgs(arch, dtype="float32"):
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


def _err(got, want) -> float:
    return float(np.abs(_np(got) - _np(want)).max())


def _close(got, want, tol):
    bound = tol * max(1.0, float(np.abs(_np(want)).max()))
    err = _err(got, want)
    assert err <= bound, f"max|d| {err:.3e} > {bound:.3e}"


def _gate(jeng):
    """Set the JAX engine's cross-attention gates to GATE."""
    for grp in jeng.params["groups"].values():
        if "cross" in grp:
            grp["cross"]["gate"] = jnp.full_like(grp["cross"]["gate"], GATE)


def _engines(arch, slots, max_len, dtype="float32"):
    jcfg, tcfg = _cfgs(arch, dtype)
    jeng = jserve.ServeEngine(jcfg, slots, max_len)
    _gate(jeng)
    tree = jax.tree.map(np.asarray, jeng.params)
    model = tfm.Transformer(tcfg, lm_params_from_numpy(tcfg, tree, "cpu"))
    return jeng, serve.ServeEngine(tcfg, slots, max_len, model=model)


def _recorder():
    seen = {}

    def on_logits(rid, logits):
        seen.setdefault(rid, []).append(logits.clone())
    return seen, on_logits


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b",
                                  "qwen3-moe-30b-a3b",
                                  "llama-3.2-vision-90b"])
def test_one_slot_engine_matches_the_jax_engine(arch, monkeypatch):
    jeng, teng = _engines(arch, 1, 64)
    tcfg = teng.cfg
    # both caches with f32 K/V and conv tails (see test_torch_lm_serve.py)
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
        # ROADMAP.md C5: finish the step before the engine bumps self.pos
        out = jax.block_until_ready(real_decode(*a))
        jlogits.append(out[0][0, 0])
        return out

    monkeypatch.setattr(jtfm, "prefill", prefill)
    jeng._decode = decode
    prompts = _prompts(tcfg, 3, 12, seed=1)
    want = serve.run_requests(jeng, prompts, 5, np.random.default_rng(0))
    seen, on_logits = _recorder()
    got = serve.run_requests(teng, prompts, 5, np.random.default_rng(0),
                             on_logits=on_logits)
    assert got["outputs"] == want["outputs"]
    ours = [t for rid in sorted(seen) for t in seen[rid]]
    assert len(ours) == len(jlogits) == 3 * 5
    for g, w in zip(ours, jlogits):
        _close(g, w, TOL["float32"])
    if tcfg.family == "vlm":   # the last request's memory, as JAX drew it
        np.testing.assert_array_equal(
            teng.memory[0].numpy(), np.asarray(jeng.memory[0]))


def test_audio_engine_decodes_on_the_encoded_memory():
    """The port's audio engine against ``tfm.prefill``/``decode_step``
    with the memory ``prefill`` returns, on the memory the JAX engine's
    rule draws from the same rng."""
    jeng, teng = _engines("seamless-m4t-large-v2", 1, 32)
    jcfg, tcfg = jeng.cfg, teng.cfg
    teng.cache = tfm.init_cache(tcfg, 1, 32, "cpu", dtype=torch.float32)
    prompt = _prompts(tcfg, 1, 16, seed=2)[0]
    teng.prefill_slot(0, prompt, np.random.default_rng(0))
    frames = np.random.default_rng(0).standard_normal(
        (1, 4, tcfg.d_model), np.float32) * 0.02
    np.testing.assert_array_equal(teng.memory_in, frames[0])
    jcache = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a,
                          jtfm.init_cache(jcfg, 1, 32)[0])
    jl, jcache, enc = jtfm.prefill(jeng.params, jcfg, jcache,
                                   {"tokens": prompt[None],
                                    "memory": frames})
    _close(teng.logits, jl[:, -1], TOL["float32"])
    _close(teng.memory, enc, TOL["float32"])
    tok = int(teng.logits[0].argmax())
    for t in range(16, 20):
        teng.decode(np.array([tok], np.int32))
        jl, jcache = jtfm.decode_step(jeng.params, jcfg, jcache, {
            "token": np.array([[tok]], np.int32),
            "pos": np.array([t], np.int32), "memory": enc})
        _close(teng.logits, jl[:, 0], TOL["float32"])
        tok = int(teng.logits[0].argmax())


def test_jax_audio_engine_decodes_on_raw_frames():
    """ROADMAP.md C6: the JAX engine keeps the raw frames it drew and
    decodes on them (``decode_step`` expects the encoded memory that
    ``prefill`` returns and the engine drops); its logits are those of
    ``decode_step`` on the raw frames.  The port's engine decodes on the
    encoded memory."""
    jeng, teng = _engines("seamless-m4t-large-v2", 1, 32)
    jcfg = jeng.cfg
    prompt = _prompts(teng.cfg, 1, 16, seed=3)[0]
    for eng in (jeng, teng):
        tok = eng.prefill_slot(0, prompt, np.random.default_rng(1))
    raw = np.asarray(jeng.memory)
    np.testing.assert_array_equal(raw[0], teng.memory_in)
    cache0 = jtfm.init_cache(jcfg, 1, 32)[0]
    batch = {"tokens": prompt[None], "memory": raw}
    _, cache, enc = jtfm.prefill(jeng.params, jcfg, cache0, batch)
    step = {"token": np.array([[tok]], np.int32),
            "pos": np.array([16], np.int32)}
    on_raw, _ = jtfm.decode_step(jeng.params, jcfg, cache,
                                 {**step, "memory": raw})
    on_enc, _ = jtfm.decode_step(jeng.params, jcfg, cache,
                                 {**step, "memory": enc})
    captured = []
    real = jeng._decode

    def decode(*a):
        out = jax.block_until_ready(real(*a))
        captured.append(out[0])
        return out

    jeng._decode = decode
    jeng.decode(np.array([tok], np.int32))
    teng.decode(np.array([tok], np.int32))
    gap = _err(on_raw, on_enc)
    assert gap > 1e-2                                 # the fault shows
    assert _err(captured[0], on_raw) <= 1e-2 * gap    # JAX: raw frames
    _close(teng.logits, on_enc[:, 0], TOL["bfloat16"])  # port: encoded
    assert _err(teng.logits, on_raw[:, 0]) > 0.5 * gap


def test_jax_prefill_redraws_every_slots_memory():
    """ROADMAP.md C7: the JAX engine's second prefill replaces the memory
    of the slot already served (one (slots, P, D) block for all slots,
    drawn anew); the port keeps slot 0's memory bitwise, and its slot 1
    holds the same draw's row 1."""
    jeng, teng = _engines("llama-3.2-vision-90b", 2, 32)
    p0, p1 = _prompts(teng.cfg, 2, 8, seed=4)
    rngs = {"jax": np.random.default_rng(0), "port": np.random.default_rng(0)}
    jeng.prefill_slot(0, p0, rngs["jax"])
    teng.prefill_slot(0, p0, rngs["port"])
    j0 = np.asarray(jeng.memory[0]).copy()
    t0 = teng.memory[0].clone()
    np.testing.assert_array_equal(t0.numpy(), j0)
    jeng.prefill_slot(1, p1, rngs["jax"])
    teng.prefill_slot(1, p1, rngs["port"])
    assert float(np.abs(np.asarray(jeng.memory[0]) - j0).max()) > 1e-2
    assert torch.equal(teng.memory[0], t0)
    np.testing.assert_array_equal(teng.memory[1].numpy(),
                                  np.asarray(jeng.memory[1]))


def test_audio_memory_length_is_set_by_the_first_prompt():
    _, cfg = _cfgs("seamless-m4t-large-v2")
    eng = serve.ServeEngine(cfg, 2, 32, device="cpu")
    rng = np.random.default_rng(0)
    a, b = _prompts(cfg, 2, 16, seed=5)
    eng.prefill_slot(0, a, rng)
    assert tuple(eng.memory.shape) == (2, 4, cfg.d_model)
    eng.prefill_slot(1, b, rng)             # 16 tokens: 4 frames again
    with pytest.raises(ValueError, match="memory positions"):
        eng.prefill_slot(1, b[:8], rng)     # 2 frames
    with pytest.raises(ValueError, match="rng"):
        eng.prefill_slot(0, a)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2",
                                  "qwen3-moe-30b-a3b"])
def test_slots_give_each_request_what_it_gets_alone(arch):
    """Six requests through four slots against each request alone in a
    one-slot engine, fed the same tokens and the same memory (bf16).
    MoE at a capacity that drops no pair: in the JAX semantics capacity
    couples the slots of one decode step."""
    _, cfg = _cfgs(arch, "bfloat16")
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    gen = torch.Generator().manual_seed(3)
    tree = tfm.init_params(cfg, gen, device="cpu")
    for grp in tree["groups"].values():
        if "cross" in grp:
            grp["cross"]["gate"].fill_(GATE)
    model = tfm.Transformer(cfg, tree)
    prompts = _prompts(cfg, 6, 12, seed=3)
    seen, on_logits = _recorder()
    memories = {}
    engine = serve.ServeEngine(cfg, 4, 32, model=model)

    def record(rid, logits):
        if rid not in seen:
            memories[rid] = engine.memory_in
        on_logits(rid, logits)

    out = serve.run_requests(engine, prompts, 6, np.random.default_rng(3),
                             on_logits=record)
    alone = serve.ServeEngine(cfg, 1, 32, model=model)
    for rid, prompt in enumerate(prompts):
        toks = out["outputs"][rid]
        alone.prefill_slot(0, prompt, memory=memories[rid])
        _close(alone.logits[0], seen[rid][0], TOL["bfloat16"])
        for step in range(1, 6):
            alone.decode(np.array([toks[step - 1]], np.int32))
            _close(alone.logits[0], seen[rid][step], TOL["bfloat16"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_cli_serves_the_families_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--requests", "3",
                      "--batch-slots", "2", "--prompt-len", "8",
                      "--gen-len", "4", "--device", "cpu"])
    toks = out["outputs"]
    assert sorted(toks) == [0, 1, 2]
    assert all(len(t) == 4 for t in toks.values())
    assert "served 3 requests, 12 tokens, " in capsys.readouterr().out
