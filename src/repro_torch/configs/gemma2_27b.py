"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [arXiv:2408.00118; hf] 46L d=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
# alternating local(4096)/global attention, attn softcap 50, logit softcap 30.
CONFIG = ModelConfig(
    name="gemma2-27b", family="dense", n_layers=46, d_model=4608, n_heads=32,
    n_kv_heads=16, head_dim=128, d_ff=36864, vocab=256000,
    layer_pattern="local_global", local_window=4096, mlp_type="geglu",
    logit_softcap=30.0, attn_softcap=50.0,
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab=128, local_window=32,
                          attn_chunk=64)
