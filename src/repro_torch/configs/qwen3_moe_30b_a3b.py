"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [hf:Qwen/Qwen3-30B-A3B; hf] 48L d=2048 32H (GQA kv=4) expert-d_ff=768
# vocab=151936, MoE 128 experts top-8.  head_dim=128 per the HF config.
CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab=151936,
    n_experts=128, top_k=8, layer_pattern="global", moe_group=1024,
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=32, vocab=128, n_experts=8,
                          top_k=2, moe_group=0, attn_chunk=64)
