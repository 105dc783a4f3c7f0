"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [arXiv:2407.10671; hf] 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
# GQA with QKV bias; head_dim=128.
CONFIG = ModelConfig(
    name="qwen2-7b", family="dense", n_layers=28, d_model=3584, n_heads=28,
    n_kv_heads=4, head_dim=128, d_ff=18944, vocab=152064,
    layer_pattern="global", qkv_bias=True,
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=128, attn_chunk=64)
