"""deepseek-v2-lite-16b — MoE with MLA (kv_lora=512), 64 routed experts
top-6 + 2 shared, expert d_ff=1408. [arXiv:2405.04434; hf]

Note (DESIGN.md #4): the assignment sheet's primary spec says 64 routed
experts; the bracket note "160 routed" conflicts and the primary spec
wins. Every layer is MoE (the real model's first dense layer is omitted
for a uniform scanned stack; parameter deviation < 1%).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab_size=102_400,
    n_experts=64, experts_per_token=6, n_shared_experts=2, moe_d_ff=1408,
    use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
)
