"""kNN-LM serving: the SM-tree datastore as a first-class LM feature (port
of ``examples/knnlm_serve.py``).

    python -m repro_torch.examples.knnlm_serve [--steps 60] [--store-batches 4]
        [--device cpu]

1. Trains a small LM briefly on the synthetic stream (``--steps``).
2. Builds a kNN datastore of (hidden state -> next token) pairs from
   held-out batches (``--store-batches`` of them; bulk build).
3. Serves batched requests with kNN-LM mixing p = (1-l)*p_LM + l*p_kNN and
   shows retrieval changes predictions.
4. Evicts the oldest half of the datastore ONLINE with the paper's Delete
   (no rebuild), validates the tree and keeps serving.

Runs on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models import model as M
from repro_torch.models.transformer import hidden_states
from repro_torch.serve.knnlm import KnnLmConfig, KnnLmDatastore, mix_logits
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainSettings, init_all, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--store-batches", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(smoke_config("qwen2.5-3b"), n_layers=2, block_pattern=("attn",))
    dc = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    params, opt = init_all(cfg, 0, device=args.device)
    dev = params.embed.device

    def batch(step):
        return {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(dc, step).items()}

    # --- 1. brief training ---------------------------------------------------
    step_fn = make_train_step(cfg, settings=TrainSettings(
        opt=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)))
    for step in range(args.steps):
        params, opt, metrics = step_fn(params, opt, batch(step))
    loss = float(metrics["loss"])
    print(f"trained {args.steps} steps, loss {loss:.3f}")

    # --- 2. datastore of (hidden, next_token) from held-out batches ----------
    keys, vals = [], []
    with torch.no_grad():
        for step in range(100, 100 + args.store_batches):
            b = synth_batch(dc, step)
            h = hidden_states(params, cfg, {"tokens": torch.from_numpy(b["tokens"]).to(dev)})
            keys.append(h[:, :-1].reshape(-1, cfg.d_model).cpu().numpy())
            vals.append(b["tokens"][:, 1:].reshape(-1))
    keys, vals = np.concatenate(keys), np.concatenate(vals)
    store = KnnLmDatastore(KnnLmConfig(k=8, lam=0.3, metric="l2"), cfg.d_model, device=dev)
    store.build(keys, vals)
    print(f"datastore: {len(vals)} entries, "
          f"{int(store.engine.tree.alive.sum())} tree nodes")

    # --- 3. batched serving with retrieval mixing -----------------------------
    req = torch.from_numpy(synth_batch(dc, 200)["tokens"][:, :16]).to(dev)
    b, s0 = req.shape
    cache = M.init_cache(cfg, b, s0 + 8, device=dev)
    with torch.no_grad():
        for pos in range(s0):
            logits, cache = M.decode_step(params, cfg, req[:, pos], cache, pos)
        h_last = hidden_states(params, cfg, {"tokens": req})[:, -1]
    knn_logp = store.knn_logits(h_last, cfg.padded_vocab)
    base_tok = logits.argmax(-1).cpu().numpy()
    mixed_tok = mix_logits(logits, knn_logp, lam=0.3).argmax(-1).cpu().numpy()
    print("LM argmax:    ", base_tok)
    print("kNN-LM argmax:", mixed_tok)
    print(f"retrieval changed {int((base_tok != mixed_tok).sum())}/{b} predictions")

    # --- 4. ONLINE eviction via the paper's Delete ----------------------------
    n_before = store.engine.n_objects
    evicted = store.evict_before(len(vals) // 2)
    store.engine.validate()
    print(f"evicted {evicted} of {n_before} entries online "
          f"(SM-tree Delete; invariants still hold)")
    knn_logp2 = store.knn_logits(h_last, cfg.padded_vocab)
    mixed2 = mix_logits(logits, knn_logp2, 0.3).argmax(-1).cpu().numpy()
    print("post-eviction kNN-LM argmax:", mixed2)
    return {"loss": loss, "entries": int(len(vals)), "evicted": int(evicted),
            "lm_argmax": base_tok.tolist(), "knnlm_argmax": mixed_tok.tolist(),
            "post_eviction_argmax": mixed2.tolist()}


if __name__ == "__main__":
    main()
