"""Architecture configuration + registry.

The port's copy of ``repro/configs/base.py`` (no JAX in it): the same
numbers, so both packages build the same models.

One ``ArchConfig`` per assigned architecture (exact numbers from the
assignment table) plus reduced smoke variants.  ``block_pattern`` describes
one *period* of the layer stack; the model is a scan over
``n_layers // len(block_pattern)`` stacked periods (homogeneous pytree), which
keeps compile time and HLO size flat in depth.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

# block kinds: "attn" (GQA + dense FFN), "attn_moe" (GQA + MoE FFN),
# "mamba" / "mamba_moe", "mlstm", "slstm"
BlockPattern = tuple[str, ...]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: BlockPattern = ("attn",)
    d_head: int = 0                # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0      # qwen2-moe style always-on experts
    moe_d_ff: int = 0              # per-expert hidden dim (if != d_ff)
    capacity_factor: float = 1.25

    # --- attention details ---
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    gated_mlp: bool = True         # SwiGLU (3-mat) vs classic 2-mat GELU
    tie_embeddings: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    pos_embedding: str = "rope"    # rope | learned | sinusoidal

    # --- SSM (mamba) ---
    ssm_expand: int = 2
    ssm_state: int = 16
    ssm_conv: int = 4

    # --- xLSTM ---
    xlstm_proj_factor: float = 2.0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0        # 0 -> decoder-only
    max_target_len: int = 448      # whisper decoder position bound
    n_audio_frames_per_s: int = 50

    # --- modality frontend stub ---
    frontend: str = "none"         # none | audio_stub | vision_stub
    n_image_tokens: int = 256      # vlm stub: patch-embedding count

    # --- TP-friendliness padding (dry-run/production overrides; 0/1 = off).
    # Padded q-heads are output-masked so the model is EXACTLY the assigned
    # architecture (zero gradient into pad heads); padded vocab rows are
    # ordinary unused slots (standard Megatron vocab padding).
    head_pad: int = 0              # pad n_heads up to a multiple of this
    vocab_pad_to: int = 1          # pad vocab_size up to a multiple of this
    expert_pad_to: int = 0         # pad n_experts up to a multiple (EP)
    moe_ep: bool = False           # expert parallelism over 'data' (A2A
    #                                dispatch) instead of FSDP weight gathers

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    norm_eps: float = 1e-5

    # --- capability flags ---
    subquadratic: bool = False     # supports long_500k decode

    def __post_init__(self):
        object.__setattr__(self, "d_head",
                           self.d_head or self.d_model // max(self.n_heads, 1))
        assert self.n_layers % len(self.block_pattern) == 0, \
            (self.name, self.n_layers, self.block_pattern)

    @property
    def padded_heads(self) -> int:
        if not self.head_pad:
            return self.n_heads
        return -(-self.n_heads // self.head_pad) * self.head_pad

    @property
    def padded_kv_heads(self) -> int:
        # MHA (KV == H) pads with the q heads; GQA keeps KV (replicated)
        return self.padded_heads if self.n_kv_heads == self.n_heads \
            else self.n_kv_heads

    @property
    def padded_experts(self) -> int:
        if not self.expert_pad_to or not self.n_experts:
            return self.n_experts
        return -(-self.n_experts // self.expert_pad_to) * self.expert_pad_to

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // self.vocab_pad_to) * self.vocab_pad_to

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def param_count(self) -> int:
        """Total parameters (embedding + blocks), exact per block kind."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, dh = self.n_heads, self.n_kv_heads, self.d_head
        tied = self.tie_embeddings or self.is_encdec  # enc-dec always ties
        total = V * D + (0 if tied else V * D)  # embed + head
        attn = D * H * dh + 2 * D * KV * dh + H * dh * D
        if self.qkv_bias:
            attn += (H + 2 * KV) * dh
        dense_ffn = (3 if self.gated_mlp else 2) * D * F
        moe_ffn = (self.n_experts * 3 * D * (self.moe_d_ff or F)
                   + self.n_shared_experts * 3 * D * (self.moe_d_ff or F)
                   + D * self.n_experts)
        d_in = self.ssm_expand * D
        mamba = (D * 2 * d_in + d_in * self.ssm_conv
                 + d_in * (2 * self.ssm_state + 2) + d_in * D)
        pf = self.xlstm_proj_factor
        d_x = int(pf * D)
        mlstm = D * 2 * d_x + d_x * D + 3 * d_x * d_x + 4 * d_x
        slstm = 4 * D * D + D * D + 2 * int(2.7 * D) * D
        per_kind = dict(attn=attn + dense_ffn, attn_moe=attn + moe_ffn,
                        mamba=mamba + dense_ffn if F else mamba,
                        mamba_moe=mamba + moe_ffn,
                        mlstm=mlstm, slstm=slstm)
        n_per = self.n_layers // len(self.block_pattern)
        for kind in self.block_pattern:
            total += n_per * per_kind[kind]
        total += 2 * self.n_layers * D  # norms
        if self.is_encdec:
            enc_attn = 4 * D * H * dh
            total += self.encoder_layers * (enc_attn + dense_ffn + 2 * D)
            total += self.n_layers * (attn + 2 * D)  # cross-attn per dec layer
        return total

    @property
    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count
        Fm = self.moe_d_ff or self.d_ff
        unused = (self.n_experts - self.experts_per_token) * 3 * self.d_model * Fm
        n_moe = sum(1 for k in self.block_pattern if k.endswith("_moe"))
        return self.param_count - self.n_periods * n_moe * unused


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> ArchConfig:
    import repro_torch.configs.all_archs  # noqa: F401  (populates registry)
    try:
        cfg = _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}") from None
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_archs() -> list[str]:
    import repro_torch.configs.all_archs  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (assignment table)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention architecture: 500k-token decode "
                       "requires sub-quadratic attention (skip per assignment)")
    return True, ""
