"""Config system: architecture + input-shape descriptors, CLI registry.

A copy of ``repro.configs.base`` as data; only ``activation_dtype`` maps
to a torch dtype."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # -- variants ------------------------------------------------------------
    activation: str = "swiglu"  # swiglu | relu2 | gelu
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    # -- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1  # MoE replaces the MLP on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "onehot"  # onehot (paper-era baseline) | sort (optimized)
    # -- SSM (Mamba-1) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    # -- hybrid (Jamba): one attention layer per `attn_period` layers -----------
    attn_period: int = 0
    attn_offset: int = 0
    # -- encoder-decoder ----------------------------------------------------------
    n_enc_layers: int = 0
    # -- modality frontend stubs -----------------------------------------------
    frontend: Optional[str] = None  # vision | audio
    n_prefix: int = 256  # vision patches / audio frames prepended or encoded
    # -- numerics / compilation ---------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    scan_layers: bool = True
    remat: bool = True
    loss_chunk: Optional[int] = None  # token-chunked CE (memory optimization)
    # -- training ---------------------------------------------------------------
    optimizer: str = "adamw"  # adamw | adamw8bit | adafactor
    microbatch: Optional[int] = None  # grad-accum microbatch (global); None = no accum

    # ------------------------------------------------------------------ derived
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def uses_attention(self, layer_idx: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return layer_idx % self.attn_period == self.attn_offset
        return True

    def uses_moe(self, layer_idx: int) -> bool:
        if self.n_experts == 0:
            return False
        return layer_idx % self.moe_every == self.moe_offset

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / sliding-window attention."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (no encoder-only)

    # Parameter count for MODEL_FLOPS = 6*N*D (N_active for MoE).
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        n = 0
        vocab = self.vocab_size
        n += vocab * d  # embed
        if not self.tie_embeddings:
            n += vocab * d  # unembed
        enc_layers = self.n_enc_layers
        for i in range(L):
            if self.uses_attention(i):
                qkv = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
                n += qkv + self.n_heads * self.head_dim * d
            elif self.family in ("ssm", "hybrid"):
                di, ns, dr = self.d_inner, self.ssm_state, self.dt_rank_actual
                n += d * 2 * di + self.ssm_conv * di + di * (dr + 2 * ns)
                n += dr * di + di * ns + di + di * d  # dt_proj, A, D, out
            if self.uses_moe(i):
                e = self.n_experts if not active_only else self.top_k
                ff = self.moe_d_ff or self.d_ff
                mult = 3 if self.activation == "swiglu" else 2
                n += e * mult * d * ff + d * self.n_experts  # experts + router
            else:
                mult = 3 if self.activation == "swiglu" else 2
                n += mult * d * self.d_ff
            n += 2 * d  # norms
        for _ in range(enc_layers):  # encoder stack (full attention + mlp)
            qkv = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
            n += qkv + self.n_heads * self.head_dim * d
            mult = 3 if self.activation == "swiglu" else 2
            n += mult * d * self.d_ff + 2 * d
            if self.family == "encdec":  # decoder cross-attention params
                n += qkv + self.n_heads * self.head_dim * d
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
