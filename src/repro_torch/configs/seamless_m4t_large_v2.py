"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [arXiv:2308.11596; hf] enc-dec multimodal backbone: 24 encoder + 24
# decoder layers, d=1024 16H (kv=16, i.e. MHA) d_ff=8192 vocab=256206.
# The speech frontend is a stub: input_specs provides frame embeddings of
# length seq_len // enc_ratio.
CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=8192, vocab=256206,
    layer_pattern="encdec", is_encdec=True, n_enc_layers=24, enc_ratio=4,
    mlp_type="gelu",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
                          attn_chunk=64)
