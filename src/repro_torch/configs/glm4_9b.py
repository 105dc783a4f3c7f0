"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [hf:THUDM/glm-4-9b; hf] 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552
# RoPE + GQA; head_dim=128.
CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096, n_heads=32,
    n_kv_heads=2, head_dim=128, d_ff=13696, vocab=151552,
    layer_pattern="global", qkv_bias=True,
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=128, attn_chunk=64)
