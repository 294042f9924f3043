"""phi4-mini-3.8b — dense, RoPE + SwiGLU + GQA kv=8, 200k vocab.
[arXiv:2412.08905; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200_064, head_dim=128,
    rope_theta=10_000.0, tie_embeddings=True,
)
