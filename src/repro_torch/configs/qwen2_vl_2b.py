"""qwen2-vl-2b — VLM backbone with M-RoPE (sections 16/24/24), GQA kv=2.
The vision tower is a stub: launch/specs.py's make_batch supplies
precomputed patch embeddings merged into the sequence.
[arXiv:2409.12191; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151_936, head_dim=128,
    mrope_sections=(16, 24, 24), n_patches=1024,
    rope_theta=1_000_000.0, tie_embeddings=True,
)
