"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    sliding_window=1024,  # local layers
    global_every=6,  # 5 local : 1 global
    rope_theta=1_000_000.0,
    tied_embeddings=True,
    subquadratic=True,  # 5/6 of layers have window-bounded caches
)
