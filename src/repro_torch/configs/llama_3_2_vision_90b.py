"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [hf:meta-llama/Llama-3.2-11B-Vision (90B scale); unverified]
# 100L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer is a
# gated cross-attention layer over precomputed vision patch embeddings
# (frontend is a stub per the assignment: input_specs provides patches).
CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672, vocab=128256,
    layer_pattern="cross5", cross_every=5, num_patches=1600,
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=128, num_patches=8,
                          attn_chunk=64)
