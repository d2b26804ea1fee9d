"""paligemma-3b [vlm] — SigLIP vision frontend (STUB: input_specs provides
precomputed patch embeddings) + gemma-2b text backbone, prefix-LM attention
over the image prefix.  [arXiv:2407.07726; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,  # MQA
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    tied_embeddings=True,
    frontend="vision",
    frontend_tokens=256,  # 224x224 / 14x14 SigLIP patches
    rope_theta=10_000.0,
)
