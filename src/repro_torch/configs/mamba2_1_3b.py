"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free, no FFN
sublayer (pure mamba blocks).  [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,  # attention-free; unused
    n_kv_heads=1,
    d_ff=0,  # no FFN sublayer
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    subquadratic=True,  # O(1) state: the canonical long_500k arch
)
