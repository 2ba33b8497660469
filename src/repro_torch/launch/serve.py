"""Batched serving driver: prompt feed + cached greedy decode on one card,
optional kNN-LM mixing from an SM-tree datastore.  Port of the
single-device path of ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch qwen2.5-3b --knn     # the card
    python -m repro_torch.launch.serve --smoke --knn --device cpu  # the CPU

The flags are the reference's, plus ``--device``.  Those of parts not
ported yet (the streaming store, the front-end, replicas, the sharded
forest, the mesh, the observability plane) stop with an argparse error
naming their ROADMAP item.  Weights are random (seed 0, drawn on the
device); ``serve_loop`` takes any parameters, so a test can pass weights
converted from the JAX package.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import get_config
from repro_torch.core.smtree import resolve_device
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models import model as M
from repro_torch.serve.knnlm import KnnLmConfig, KnnLmDatastore, mix_logits
from repro_torch.serve.serve_step import make_decode_step

_UNPORTED = {
    "knn_mutate": "--knn-mutate needs the streaming store (ROADMAP Queue 1 item 10)",
    "frontend": "--frontend needs the serving front-end (ROADMAP Queue 1 item 11)",
    "replicas": "--replicas needs WAL shipping (ROADMAP Queue 1 items 10-11)",
    "knn_shards": "--knn-shards needs the streaming forest (ROADMAP Queue 1 items 6, 10)",
    "slo_ms": "--slo-ms needs the serving front-end (ROADMAP Queue 1 item 11)",
    "cohort_width": "--cohort-width needs the serving front-end (ROADMAP Queue 1 item 11)",
    "rebalance_mode": "--rebalance-mode needs the streaming forest (ROADMAP Queue 1 items 6, 10)",
    "obs": "--obs needs the observability plane (ROADMAP Queue 1 item 11)",
    "obs_out": "--obs-out needs the observability plane (ROADMAP Queue 1 item 11)",
}


def _build_store(cfg, lam: float, device) -> KnnLmDatastore:
    """Synthetic kNN-LM datastore: 2048 random keys of width d_model under
    l2, random next-token values (the reference's ``_build_store``)."""
    rng = np.random.default_rng(0)
    keys = rng.standard_normal((2048, cfg.d_model)).astype(np.float32)
    vals = rng.integers(0, cfg.vocab_size, 2048).astype(np.int32)
    store = KnnLmDatastore(KnnLmConfig(lam=lam, metric="l2"), cfg.d_model,
                           device=device)
    store.build(keys, vals)
    return store


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(args, cfg, params, store=None):
    """Feed the prompt through the cached decode, then ``args.steps``
    greedy steps, mixing each step's logits with the store's kNN log-probs
    when ``store`` is given.  Returns (tokens [b, steps + 1] numpy, timings
    dict)."""
    dev = params.embed.device
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.prompt_len,
                    global_batch=args.batch)
    prompt = torch.from_numpy(synth_batch(dc, 0, with_labels=False)["tokens"]).to(dev)
    cache = M.init_cache(cfg, args.batch, args.prompt_len + args.steps + 1,
                         device=dev)

    step_fn = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    for pos in range(args.prompt_len):
        tok, logits, cache = step_fn(params, prompt[:, pos], cache, pos)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for step in range(args.steps):
        fed = tok
        tok, logits, cache = step_fn(params, fed, cache, args.prompt_len + step)
        if store is not None:
            h = params.embed[fed.long()].float()
            mixed = mix_logits(logits, store.knn_logits(h, logits.shape[-1]),
                               args.lam)
            tok = mixed.argmax(-1).to(torch.int32)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    toks = torch.stack(out, dim=1).cpu().numpy()
    return toks, dict(prefill_s=prefill_s, decode_s=decode_s,
                      ms_per_step=decode_s / max(1, args.steps) * 1e3)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--knn", action="store_true",
                    help="mix with an SM-tree kNN-LM datastore")
    ap.add_argument("--knn-mutate", action="store_true", help="not ported yet")
    ap.add_argument("--frontend", action="store_true", help="not ported yet")
    ap.add_argument("--slo-ms", type=float, default=None, help="not ported yet")
    ap.add_argument("--cohort-width", type=int, default=None,
                    help="not ported yet")
    ap.add_argument("--replicas", type=int, default=None, help="not ported yet")
    ap.add_argument("--knn-shards", type=int, default=None,
                    help="not ported yet")
    ap.add_argument("--rebalance-mode", default=None,
                    choices=["stop_world", "incremental"], help="not ported yet")
    ap.add_argument("--obs", action="store_true", help="not ported yet")
    ap.add_argument("--obs-out", default=None, metavar="PATH",
                    help="not ported yet")
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--mesh", default="single", choices=["single", "host"],
                    help="'host' (sharded decode) is not ported yet")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.prompt_len < 1:
        ap.error("--prompt-len must be >= 1 (decode needs a seed token)")
    for name, why in _UNPORTED.items():
        if getattr(args, name) is not None and getattr(args, name) is not False:
            ap.error(f"{why}: not ported yet")
    if args.mesh == "host":
        ap.error("--mesh host needs the sharded decode (ROADMAP Queue 1 "
                 "items 14-15): not ported yet")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    params = M.init_params(cfg, 0, device=dev)
    store = _build_store(cfg, args.lam, dev) if args.knn else None
    toks, t = serve_loop(args, cfg, params, store)
    print(f"[serve] {dev} batch {args.batch}: prompt {t['prefill_s']:.2f}s, "
          f"decode {args.steps} steps in {t['decode_s']:.2f}s "
          f"({t['ms_per_step']:.1f} ms/step"
          f"{', kNN-LM mixed' if store else ''})")
    print("[serve] sample:", toks[0][:12])
    return toks


if __name__ == "__main__":
    main()
