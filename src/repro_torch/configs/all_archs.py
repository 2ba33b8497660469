"""The 10 assigned architectures, exact configuration numbers from the
assignment table (sources in brackets), plus reduced smoke variants.

The port's copy of ``repro/configs/all_archs.py``.  The port runs every
one of them (qwen2.5-3b is the serving default).  ``param_count`` is the
reference's estimate, kept as it is: the models' exact counts are the
reference's ``exact_param_count`` (xlstm-1.3b 3,609,147,728 against
3,639,533,568; whisper-tiny 36,620,160 against 36,440,448), pinned by
tests/test_torch_models.py.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, register


@register("internvl2-1b")
def internvl2_1b() -> ArchConfig:
    # [vlm] InternViT frontend (stub) + InternLM2-1B backbone [arXiv:2404.16821]
    return ArchConfig(
        name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
        n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151_655,
        rope_theta=1e6, frontend="vision_stub", n_image_tokens=256)


@register("qwen2-moe-a2.7b")
def qwen2_moe() -> ArchConfig:
    # [moe] 4 shared + 60 routed experts, top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]
    return ArchConfig(
        name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=151_936,
        block_pattern=("attn_moe",), n_experts=60, experts_per_token=4,
        n_shared_experts=4, moe_d_ff=1408, qkv_bias=True, rope_theta=1e6)


@register("grok-1-314b")
def grok_1() -> ArchConfig:
    # [moe] 8 experts top-2 [hf:xai-org/grok-1; unverified]
    return ArchConfig(
        name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=32_768, vocab_size=131_072,
        block_pattern=("attn_moe",), n_experts=8, experts_per_token=2,
        moe_d_ff=32_768, rope_theta=1e4)


@register("starcoder2-3b")
def starcoder2() -> ArchConfig:
    # [dense] GQA kv=2, RoPE [arXiv:2402.19173]
    return ArchConfig(
        name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
        n_heads=24, n_kv_heads=2, d_ff=12_288, vocab_size=49_152,
        qkv_bias=True, norm="layernorm", gated_mlp=False, rope_theta=1e5)


@register("codeqwen1.5-7b")
def codeqwen() -> ArchConfig:
    # [dense] qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B]
    return ArchConfig(
        name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=13_440, vocab_size=92_416,
        qkv_bias=True, rope_theta=1e6)


@register("yi-34b")
def yi_34b() -> ArchConfig:
    # [dense] llama-arch GQA [arXiv:2403.04652]
    return ArchConfig(
        name="yi-34b", family="dense", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20_480, vocab_size=64_000,
        rope_theta=5e6)


@register("qwen2.5-3b")
def qwen25_3b() -> ArchConfig:
    # [dense] GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-3B]
    return ArchConfig(
        name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
        n_heads=16, n_kv_heads=2, d_ff=11_008, vocab_size=151_936,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True)


@register("xlstm-1.3b")
def xlstm() -> ArchConfig:
    # [ssm] sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM) [arXiv:2405.04517]
    return ArchConfig(
        name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50_304,
        block_pattern=("mlstm",) * 7 + ("slstm",),
        subquadratic=True, pos_embedding="none")


@register("jamba-v0.1-52b")
def jamba() -> ArchConfig:
    # [hybrid] Mamba+attn 1:7 interleave, MoE every other layer, 16e top-2
    # [arXiv:2403.19887]
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14_336, vocab_size=65_536,
        block_pattern=("mamba", "mamba_moe", "mamba", "mamba_moe",
                       "attn", "mamba_moe", "mamba", "mamba_moe"),
        n_experts=16, experts_per_token=2, moe_d_ff=14_336,
        subquadratic=True, pos_embedding="none",
        ssm_expand=2, ssm_state=16, ssm_conv=4)


@register("whisper-tiny")
def whisper_tiny() -> ArchConfig:
    # [audio] enc-dec, conv frontend stub [arXiv:2212.04356]
    return ArchConfig(
        name="whisper-tiny", family="audio", n_layers=4, d_model=384,
        n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51_865,
        encoder_layers=4, norm="layernorm", gated_mlp=False,
        pos_embedding="learned",
        frontend="audio_stub", max_target_len=448)


# ---------------------------------------------------------------------------
# Reduced smoke variants: same family/block structure, tiny dims
# ---------------------------------------------------------------------------
def smoke_config(name: str) -> ArchConfig:
    from repro_torch.configs.base import get_config
    cfg = get_config(name)
    pat_len = len(cfg.block_pattern)
    return dataclasses.replace(
        cfg,
        n_layers=2 * pat_len if cfg.name != "whisper-tiny" else 2,
        d_model=64,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        moe_d_ff=96 if cfg.moe_d_ff else 0,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        vocab_size=512,
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_image_tokens=16 if cfg.frontend == "vision_stub" else cfg.n_image_tokens,
        max_target_len=64 if cfg.is_encdec else cfg.max_target_len)
