"""Architecture config — exact spec from the assignment table."""
from repro_torch.models.common import ModelConfig

# [arXiv:2405.21060; unverified] 48L d=1536, attention-free SSD
# (state-space duality), ssm_state=128, vocab=50280, expand=2, headdim=64.
CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, layer_pattern="ssm", ssm_state=128,
    ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
)

def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, vocab=128, ssm_state=16,
                          ssm_head_dim=16, ssm_chunk=16)
