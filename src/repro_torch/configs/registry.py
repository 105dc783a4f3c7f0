"""--arch <id> lookup for every assigned architecture (+ smoke variants),
the JAX package's configs field for field with torch dtypes."""
import importlib

import torch

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "glm4-9b": "glm4_9b",
    "gemma2-27b": "gemma2_27b",
    "qwen2-7b": "qwen2_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "mamba2-780m": "mamba2_780m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_NAMES = list(_MODULES)

# Per-arch training memory recipe: whether FSDP (shard "embed" over "data")
# is required and the AdamW moment dtype.  Derived from per-chip HBM (v5e:
# 16 GB) at the production meshes; documented in EXPERIMENTS.md §Dry-run.
# kimi-k2 (1T params) additionally drops params+moments to bf16 — with f32
# everywhere, 12 TB of optimizer state cannot fit 512 x 16 GB at all.
# remat_block: k super-layers per activation-checkpoint block (nested
# remat) — trades ~+20% compute-term for ~-27% peak activation memory
# (measured, EXPERIMENTS.md §Perf).  Must divide the super-layer count
# (gemma2's 23 and kimi's 61 are prime -> 1).
RECIPES = {
    "qwen3-moe-30b-a3b": dict(fsdp=True, moment_dtype="float32",
                              remat_block=2),
    "kimi-k2-1t-a32b": dict(fsdp=True, moment_dtype="bfloat16",
                            param_dtype="bfloat16", remat_block=1),
    "glm4-9b": dict(fsdp=True, moment_dtype="float32", remat_block=2),
    "gemma2-27b": dict(fsdp=True, moment_dtype="float32", remat_block=1),
    "qwen2-7b": dict(fsdp=False, moment_dtype="float32", remat_block=4),
    "qwen2-1.5b": dict(fsdp=False, moment_dtype="float32", remat_block=4),
    "recurrentgemma-2b": dict(fsdp=False, moment_dtype="float32",
                              remat_block=2),
    "llama-3.2-vision-90b": dict(fsdp=True, moment_dtype="float32",
                                 remat_block=4),
    "mamba2-780m": dict(fsdp=False, moment_dtype="float32", remat_block=4),
    "seamless-m4t-large-v2": dict(fsdp=False, moment_dtype="float32",
                                  remat_block=4),
}


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg = mod.smoke() if smoke else mod.CONFIG
    if not smoke:
        r = RECIPES.get(name, {})
        pd = r.get("param_dtype")
        if pd is not None:
            cfg = cfg.replace(param_dtype=getattr(torch, pd))
        rb = r.get("remat_block", 1)
        if rb > 1:
            cfg = cfg.replace(remat_block=rb)
    return cfg


def get_recipe(name: str):
    """FSDP flag + moment dtype for the launcher / dry-run."""
    r = dict(RECIPES.get(name, dict(fsdp=False, moment_dtype="float32")))
    r["moment_dtype"] = getattr(torch, r["moment_dtype"])
    r.pop("param_dtype", None)
    r.pop("remat_block", None)  # applied through get_config
    return r
