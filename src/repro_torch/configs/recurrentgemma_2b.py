"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [arXiv:2402.19427; hf] 26L d=2560 10H (GQA kv=1) d_ff=7680 vocab=256000
# RG-LRU + local attention in a (recurrent, recurrent, attention) pattern;
# head_dim=256, lru_width=2560, local window 2048.
CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680, vocab=256000,
    layer_pattern="rrl", local_window=2048, lru_width=2560,
    mlp_type="geglu",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
                          head_dim=16, d_ff=128, vocab=128, local_window=32,
                          lru_width=64, attn_chunk=64)
