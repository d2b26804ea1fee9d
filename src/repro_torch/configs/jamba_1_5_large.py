"""jamba-1.5-large-398b [hybrid] — mamba+attention 1:7 interleave, MoE 16e
top-2 on every other layer.  [arXiv:2403.19887; hf]

Hardware adaptation note (DESIGN.md section 2): Jamba's SSM layers are
mamba-1; this framework standardizes on the mamba-2 SSD formulation for all
SSM blocks (chunked-scan + O(1) decode), keeping d_state/conv/expand shapes.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    attn_every=8,  # 1 attention layer per 8 (1:7 mamba:attn)
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576),
    moe_every=2,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    rope_theta=10_000.0,
    subquadratic=True,  # 7/8 layers are O(1)-state SSM
)
