"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config):
61L, d_model 7168, GQA kv=8, 384 routed experts top-8 (+1 shared),
expert d_ff=2048. [arXiv:2501.kimi2; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=0, vocab_size=163_840, head_dim=128,
    n_experts=384, experts_per_token=8, n_shared_experts=1, moe_d_ff=2048,
    rope_theta=50_000.0,
)
