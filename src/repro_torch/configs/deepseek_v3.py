"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8,
aux-free load balancing, multi-token prediction.  [arXiv:2412.19437; hf]

d_ff=18432 applies to the first 3 dense layers (official config); the
assignment's d_ff=2048 is the routed-expert hidden size (d_expert below).
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,  # MLA: all heads share the compressed latent
    d_ff=18432,  # dense FFN on the first 3 layers
    vocab=129280,
    first_dense=3,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_expert=2048,
        n_shared=1,
        router_aux_free=True,
        router_scale=2.5,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    mtp_depth=1,
    rope_theta=10_000.0,
)
