"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [arXiv:2407.10671; hf] 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
# GQA with QKV bias; head_dim=128.
CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, head_dim=128, d_ff=8960, vocab=151936,
    layer_pattern="global", qkv_bias=True,
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=128, attn_chunk=64)
