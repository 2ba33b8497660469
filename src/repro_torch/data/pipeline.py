"""Deterministic, checkpointable, sharded synthetic LM data pipeline.

The port's copy of ``repro/data/pipeline.py`` (numpy only): the same
(seed, step, shard) gives the same tokens in both packages.

Real deployments drop in a tokenised corpus reader behind the same API.  The
synthetic stream is a counter-based hash (stateless — batch i is a pure
function of (seed, step, shard)), which gives us:
  * exact restart: resuming at step k reproduces the same batches bitwise
    (tested in tests/test_checkpoint.py),
  * per-host sharding with no coordination: each data-parallel rank draws its
    slice of the global batch by index,
  * infinite length without storage.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32_000
    seq_len: int = 1024
    global_batch: int = 8


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """splitmix-ish integer hash, vectorised."""
    x = (x ^ (x >> 16)) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * np.uint32(0x846CA68B)
    return x ^ (x >> 16)


def synth_batch(cfg: DataConfig, step: int, *, shard: int = 0,
                n_shards: int = 1, with_labels: bool = True) -> dict:
    """Global batch slice for `shard` of `n_shards` at `step`."""
    assert cfg.global_batch % n_shards == 0
    b = cfg.global_batch // n_shards
    rows = (np.arange(b) + shard * b).astype(np.uint32)
    cols = np.arange(cfg.seq_len + 1, dtype=np.uint32)
    base = (np.uint32(cfg.seed) * np.uint32(2654435761)
            + np.uint32(step) * np.uint32(97531))
    grid = _hash_u32(base + rows[:, None] * np.uint32(7919) + cols[None, :])
    toks = (grid % np.uint32(cfg.vocab_size)).astype(np.int32)
    out = {"tokens": toks[:, :-1]}
    if with_labels:
        out["labels"] = toks[:, 1:]
    return out


def model_batch(arch: ArchConfig, cfg: DataConfig, step: int) -> dict:
    """``synth_batch``'s global batch at ``step`` with the inputs that
    ``arch`` takes beside its tokens, each a pure function of (seed, step)
    so that a resumed run sees the same batches: the vision stub's image
    embeddings [b, n_img, D] (the tokens cut so that the sequence stays
    ``seq_len`` long, the labels not), the encoder-decoder's frames [b,
    seq_len, D] with its decoder's tokens and labels cut to
    ``min(max_target_len, max(8, seq_len // 8))``, as ``batches_for``
    shapes them.  A text-only model's batch is ``synth_batch``'s."""
    batch = synth_batch(cfg, step)
    if arch.frontend != "vision_stub" and not arch.is_encdec:
        return batch
    rng = np.random.default_rng([cfg.seed, step])
    b = cfg.global_batch
    if arch.is_encdec:
        dec = min(arch.max_target_len, max(8, cfg.seq_len // 8))
        return {"frames": rng.standard_normal((b, cfg.seq_len, arch.d_model), np.float32),
                "tokens": batch["tokens"][:, :dec], "labels": batch["labels"][:, :dec]}
    n_img = arch.n_image_tokens
    return {"tokens": batch["tokens"][:, :cfg.seq_len - n_img],
            "image_embeds": rng.standard_normal((b, n_img, arch.d_model), np.float32),
            "labels": batch["labels"]}


def batches_for(cfg: ArchConfig, shape: ShapeSpec, *, seed=0):
    """Iterator of global batches matching the model's input_specs."""
    dc = DataConfig(seed=seed, vocab_size=cfg.vocab_size,
                    seq_len=shape.seq_len, global_batch=shape.global_batch)
    step = 0
    rng = np.random.default_rng(seed)
    while True:
        batch = synth_batch(dc, step)
        if cfg.frontend == "vision_stub":
            n_img = cfg.n_image_tokens
            batch["tokens"] = batch["tokens"][:, : shape.seq_len - n_img]
            batch["image_embeds"] = rng.standard_normal(
                (shape.global_batch, n_img, cfg.d_model), np.float32)
            batch["labels"] = batch["labels"][:, : shape.seq_len]
        if cfg.is_encdec:
            dec = min(cfg.max_target_len, max(8, shape.seq_len // 8))
            batch = {
                "frames": rng.standard_normal(
                    (shape.global_batch, shape.seq_len, cfg.d_model),
                    np.float32),
                "tokens": batch["tokens"][:, :dec],
                "labels": batch["labels"][:, :dec],
            }
        yield step, batch
        step += 1
