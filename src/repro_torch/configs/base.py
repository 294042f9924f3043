"""Model and input-shape configs of the port (plain dataclasses).

A copy of ``ModelConfig``, ``ShapeConfig`` and ``SHAPES`` from the JAX
package's ``configs/base.py``, kept field for field so that both packages
read one configuration the same way: ``reduced()`` (the CPU smoke-test
variant), ``padded_vocab`` and ``param_count`` are unchanged, and so are
``MeshConfig`` and ``TrainConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "MeshConfig", "TrainConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads

    # -- MoE ------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0            # per-expert FFN width
    capacity_factor: float = 1.25

    # -- MLA (DeepSeek-style latent attention) ----------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # -- SSM / hybrid ------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0          # hybrid: shared attn block every k ssm layers

    # -- positional / misc ---------------------------------------------------
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = ()   # qwen2-vl M-RoPE
    causal: bool = True          # False => encoder-only (no decode shapes)
    embed_inputs: bool = True    # False => frontend stub supplies embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    n_patches: int = 1024        # vlm: image patch count inside the sequence

    # -- dtypes ---------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables padded to a multiple of 256 so the vocab
        dim shards evenly under any plausible TP degree (standard
        framework practice); logits are sliced back to ``vocab_size``."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_decoder(self) -> bool:
        return self.causal

    @property
    def is_ssm_family(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: preserves every family switch, shrinks dims."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(3, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads
            else 4,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.n_experts else 0,
            kv_lora_rank=32 if self.use_mla else 0,
            qk_nope_dim=32 if self.use_mla else self.qk_nope_dim,
            qk_rope_dim=16 if self.use_mla else self.qk_rope_dim,
            v_head_dim=32 if self.use_mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=16 if self.ssm_state else self.ssm_chunk,
            attn_every=2 if self.attn_every else 0,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
            n_patches=16 if self.family == "vlm" else self.n_patches,
        )

    # -- parameter counting (for MODEL_FLOPS = 6 N D) ---------------------------
    def param_count(self, active_only: bool = False) -> int:
        D, hd = self.d_model, self.resolved_head_dim
        H, KV, L = self.n_heads, self.n_kv_heads, self.n_layers
        embed = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        if not self.embed_inputs:
            embed = self.vocab_size * D  # output head only
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            if self.use_mla:
                r = self.kv_lora_rank
                qk = self.qk_nope_dim + self.qk_rope_dim
                attn = (D * H * qk                       # q proj
                        + D * (r + self.qk_rope_dim)     # kv compress + k_rope
                        + r * H * (self.qk_nope_dim + self.v_head_dim)
                        + H * self.v_head_dim * D)       # o proj
            else:
                attn = D * H * hd + 2 * D * KV * hd + H * hd * D
            if self.n_experts:
                experts = self.experts_per_token if active_only else self.n_experts
                ff = 3 * D * self.moe_d_ff * (experts + self.n_shared_experts)
                ff += D * self.n_experts  # router
            else:
                ff = 3 * D * self.d_ff
            per_layer = attn + ff
        elif self.family == "ssm":
            d_in = self.ssm_expand * D
            nh = d_in // self.ssm_head_dim
            per_layer = (D * (2 * d_in + 2 * self.ssm_state + nh)
                         + d_in * D + self.ssm_conv_width * (d_in + 2 * self.ssm_state))
        elif self.family == "hybrid":
            d_in = self.ssm_expand * D
            nh = d_in // self.ssm_head_dim
            mamba = (D * (2 * d_in + 2 * self.ssm_state + nh)
                     + d_in * D + self.ssm_conv_width * (d_in + 2 * self.ssm_state))
            shared_attn = (D * H * hd + 2 * D * KV * hd + H * hd * D
                           + 3 * D * self.d_ff)  # one shared block
            return embed + L * mamba + shared_attn
        return embed + L * per_layer


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 10_000
    optimizer: str = "adamw"     # adamw | adafactor
    remat: str = "dots"          # none | dots | full
    fsdp: bool = True            # ZeRO-shard params/opt over the data axis
    grad_compression: str = "none"  # none | int8
    seed: int = 0
