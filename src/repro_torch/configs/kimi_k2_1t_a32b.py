"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [arXiv:2501.kimi2; unverified, paper-table] 61L d=7168 64H (GQA kv=8)
# expert-d_ff=2048 vocab=163840, MoE 384 experts top-8. head_dim=128.
CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, layer_pattern="global", moe_group=1024,
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=32, vocab=128, n_experts=8,
                          top_k=2, moe_group=0, attn_chunk=64)
