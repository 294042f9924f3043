"""hubert-xlarge — encoder-only audio transformer (w2v2 arch). The conv
waveform frontend is a stub: launch/specs.py's make_batch supplies
precomputed (B, T, 1280) frame embeddings. No decode shapes (encoder).
[arXiv:2106.07447; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80,
    causal=False, embed_inputs=False,
)
