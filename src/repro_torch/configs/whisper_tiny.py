"""whisper-tiny [audio] — encoder-decoder; conv/mel frontend is a STUB
(input_specs provides precomputed frame embeddings [B, 1500, 384]).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder depth
    encoder_layers=4,
    encoder_tokens=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    frontend="audio",
    norm="layernorm",
    act="gelu",
    rope_theta=0.0,  # sinusoidal absolute positions
    tied_embeddings=True,
)
