"""Batched serving entry point: prompt feed + cached greedy decode, optional
kNN-LM mixing from an SM-tree datastore.  Port of ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch qwen2.5-3b --knn     # the card
    python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --knn  # MoE, 57 GB f32
    python -m repro_torch.launch.serve --arch xlstm-1.3b --knn     # xLSTM, 14 GB f32
    python -m repro_torch.launch.serve --arch whisper-tiny --knn   # enc-dec
    python -m repro_torch.launch.serve --smoke --knn --device cpu  # the CPU
    python -m repro_torch.launch.serve --knn --knn-mutate [--knn-shards 4] --obs
    python -m repro_torch.launch.serve --knn --knn-mutate --frontend --replicas 2 --obs
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --smoke --knn --mesh host --device cpu

The flags are the reference's, plus ``--device``.  ``--knn-mutate`` adds
and evicts a decode step's entries through the streaming store, and
``--knn-shards N`` makes that store a streaming forest of N shards;
``--frontend`` routes retrieval through the serving front-end (cohorts of
``--cohort-width`` rows, dispatched when full or after ``--slo-ms``) and
the mutations through its scheduler; ``--replicas N`` ships the store's
WAL over a socket to N read replicas behind a router; ``--obs`` turns the
observability plane on and prints its final snapshot as one ``[obs]
{...}`` line.  ``--mesh host`` over more than one rank runs
``serve_sharded``: the decode on a ('data', 'model') mesh
(``launch/mesh.py:host_mesh``; the rank and world from the
``torch.distributed`` environment), with ``--knn`` the mesh store; on one
rank it prints that it falls back to the unsharded path, as the
reference does, and ``--knn-shards`` with it is refused.  For an encoder-decoder (whisper) the loop
runs no encoder, as the reference's does: the cross-attention reads the
zero K/V of ``init_cache``, and ``--prompt-len`` + ``--steps`` may not pass
the decoder's ``max_target_len`` positions.  Weights are random (seed 0, drawn on the
device); ``serve_loop`` takes any parameters, so a test can pass weights
converted from the JAX package.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import get_config
from repro_torch.core.smtree import resolve_device
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models import model as M
from repro_torch.serve.knnlm import KnnLmConfig, KnnLmDatastore, mix_logits
from repro_torch.serve.serve_step import make_decode_step

def _dump_obs(args) -> None:
    """With ``--obs``: print the final metrics snapshot as one parseable
    ``[obs] {...}`` line (and write it to ``--obs-out`` when given)."""
    if not args.obs:
        return
    import json

    from repro_torch.obs.export import metrics_snapshot
    body = json.dumps(metrics_snapshot(), sort_keys=True, default=repr)
    if args.obs_out:
        with open(args.obs_out, "w") as f:
            f.write(body + "\n")
    print(f"[obs] {body}", flush=True)


def _build_store(args, cfg, device, mesh=None) -> KnnLmDatastore:
    """Synthetic kNN-LM datastore: 2048 random keys of width d_model under
    l2, random next-token values (the reference's ``_build_store``).  With
    ``--knn-mutate`` or ``--frontend`` its mutations go through the stream
    plane, as a streaming forest of ``--knn-shards`` shards when that is
    above 1 (the reference's skew settings: max skew 1.3, 256 objects at
    least).  ``--frontend`` puts the serving front-end before the stream;
    ``--replicas N`` gives the stream a WAL (in a temporary directory that
    ``_finish_frontend`` removes) and ships it to N replicas.  With a
    ``mesh`` it is the mesh store (query rows split over its data axis)."""
    rng = np.random.default_rng(0)
    keys = rng.standard_normal((2048, cfg.d_model)).astype(np.float32)
    vals = rng.integers(0, cfg.vocab_size, 2048).astype(np.int32)
    store = KnnLmDatastore(KnnLmConfig(lam=args.lam, metric="l2"), cfg.d_model,
                           mesh=mesh, device=device)
    store.build(keys, vals)
    if args.knn_mutate or args.frontend:
        wal_dir = None
        if args.replicas:
            # replication is log shipping: the stream needs a real WAL
            args._repl_root = tempfile.mkdtemp(prefix="serve-repl-")
            wal_dir = f"{args._repl_root}/wal"
        kw = {}
        if args.knn_shards > 1:
            kw = {"shards": args.knn_shards, "rebalance_mode": args.rebalance_mode,
                  "max_skew": 1.3, "min_objects": 256}
        store.enable_stream(wal_dir=wal_dir, **kw)
    if args.frontend:
        store.enable_frontend(cohort_width=args.cohort_width or args.batch,
                              slo_ms=args.slo_ms)
        if args.replicas:
            store.enable_replication(f"{args._repl_root}/mirrors",
                                     n_replicas=args.replicas)
    return store


def _finish_frontend(store, args) -> dict | None:
    """Drain the scheduler (every submitted mutation applied), let the
    replicas catch up with the tail the drain appended, close the
    replication and the front-end, and return the serving counters: the
    front-end's ``stats.snapshot()``, the router's ``snapshot()`` (None
    without replicas) and the WAL's last seq.  None without a front-end."""
    if store is None or store.frontend is None:
        return None
    store.frontend.drain()
    out = dict(frontend=store.frontend.stats.snapshot(), router=None, wal_seq=None)
    if store.router is not None:
        seq = store.stream.wal.next_seq - 1
        for rep in store.replicas:
            try:
                rep.catch_up(seq, timeout=10.0)
            except TimeoutError:
                pass                      # lag reported honestly below
        out.update(router=store.router.snapshot(), wal_seq=seq)
        store.close_replication()
    store.close_frontend()
    root = getattr(args, "_repl_root", None)
    if root is not None:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _frontend_summary(fe: dict | None) -> str:
    if fe is None:
        return ""
    s, r = fe["frontend"], fe["router"]
    repl = "" if r is None else (f", {len(r['replica_lags'])} replicas "
                                 f"(max lag {r['max_replica_lag']} records)")
    return (f", frontend: {s['n_cohorts']} cohorts "
            f"(fill {s['mean_cohort_fill']}, "
            f"{s['n_mutation_batches']} mutation batches, "
            f"p50 {s['p50_ms']}ms p99 {s['p99_ms']}ms){repl}")


class _WindowMutator:
    """Sliding-window live mutation under serving: every decode step adds
    the step's (hidden-state, next-token) pairs to the datastore and evicts
    the same number of oldest entries, batched through the stream plane
    (one apply per step and kind instead of one per entry)."""

    def __init__(self, store: KnnLmDatastore):
        self.store = store
        self.evict_cursor = 0
        self.n_ops = 0

    def step(self, h: torch.Tensor, toks: torch.Tensor):
        toks = toks.cpu().numpy().astype(np.int32)
        self.store.add_batch(h.cpu().numpy().astype(np.float32), toks)
        b = len(toks)
        self.store.evict_batch(np.arange(self.evict_cursor, self.evict_cursor + b))
        self.evict_cursor += b
        self.n_ops += 2 * b


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Laps:
    """Per-part host times of each decode step, for ``serve_loop``'s
    ``_split`` (``tools/serve_decode_split.py``); off when ``rows`` is None.
    A mark closes a part: ``host_ms`` up to the mark, ``cpu_ms`` the
    calling thread's CPU time in that span, then a synchronize whose wait
    is ``sync_ms``, so the next part starts with an idle card.  A step's
    ``start`` is its first part's start on the ``perf_counter`` clock."""

    def __init__(self, dev, rows: list | None):
        self.dev, self.rows = dev, rows
        if rows is not None:
            _sync(dev)
            self.t, self.cpu = time.perf_counter(), time.thread_time()
            self.row = {"start": self.t}

    def mark(self, part: str) -> None:
        if self.rows is None:
            return
        t, cpu = time.perf_counter(), time.thread_time()
        _sync(self.dev)
        t2 = time.perf_counter()
        self.row[part] = dict(host_ms=(t - self.t) * 1e3, cpu_ms=(cpu - self.cpu) * 1e3,
                              sync_ms=(t2 - t) * 1e3)
        self.t, self.cpu = t2, time.thread_time()

    def end_step(self) -> None:
        if self.rows is not None:
            self.rows.append(self.row)
            self.row = {"start": self.t}


def serve_loop(args, cfg, params, store=None, _split: list | None = None):
    """Feed the prompt through the cached decode, then ``args.steps``
    greedy steps, mixing each step's logits with the store's kNN log-probs
    when ``store`` is given (and, with ``--knn-mutate``, adding and
    evicting each step's entries).  Returns (tokens [b, steps + 1] numpy,
    timings dict).  ``_split`` (a list) gets one dict a decode step: each
    part's (``decode``, ``mix``, ``mutate``) times from ``_Laps``; the
    synchronizes it adds are in the step times too."""
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

    mutator = _WindowMutator(store) if store is not None and args.knn_mutate else None
    out = [tok]
    t0 = time.perf_counter()
    laps = _Laps(dev, _split)
    for step in range(args.steps):
        fed = tok
        tok, logits, cache = step_fn(params, fed, cache, args.prompt_len + step)
        laps.mark("decode")
        if store is not None:
            h = params.embed[fed.long()].float()
            mixed = mix_logits(logits, store.knn_logits(h, logits.shape[-1]),
                               args.lam)
            tok = mixed.argmax(-1).to(torch.int32)
            laps.mark("mix")
            if mutator is not None:
                mutator.step(h, tok)
                laps.mark("mutate")
        out.append(tok)
        laps.end_step()
    _sync(dev)
    decode_s = time.perf_counter() - t0
    toks = torch.stack(out, dim=1).cpu().numpy()
    return toks, dict(prefill_s=prefill_s, decode_s=decode_s,
                      ms_per_step=decode_s / max(1, args.steps) * 1e3,
                      mutations=mutator.n_ops if mutator else 0)


def serve_sharded(args, cfg, mesh):
    """Greedy decode on a ('data', 'model') ``DeviceMesh`` through the
    serve_step builders' mesh forms, on every rank of it: this rank's
    shards of the seeded weights (``ShardedLM``), the token rows its data
    coordinate holds, the KV cache split as ``cache_pspecs`` says.  Each
    step's tokens and logits are gathered whole on every rank.  With
    ``--knn`` the mesh store rides along (``make_knnlm_mixer``): the query
    cohort's rows split over 'data', every rank's own copy of the tree;
    with ``--knn-mutate`` every rank applies the same window of mutations,
    so the trees stay equal.  Returns (tokens [b, steps + 1] numpy, the
    store or None, timings dict), and prints the reference's summary."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.collectives import all_gather
    from repro_torch.dist.parallel import ShardedLM
    from repro_torch.dist.sharding import local_slices
    from repro_torch.serve.serve_step import make_knnlm_mixer

    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    total = args.prompt_len + args.steps + 1
    shape = ShapeSpec("serve", total, args.batch, "decode")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.prompt_len,
                    global_batch=args.batch)
    prompt = torch.from_numpy(synth_batch(dc, 0, with_labels=False)["tokens"]).to(dev)
    fn, sh = make_decode_step(cfg, mesh, shape)
    rows = local_slices(sh["token"], (args.batch,), mesh)[0]
    split = sh["token"][0] is not None
    data = mesh.get_group("data")
    whole = (lambda t: all_gather(t, 0, data)) if split else (lambda t: t)
    params = ShardedLM.from_model(M.init_params(cfg, 0, device=dev), cfg, mesh)
    cache = params.init_cache(args.batch, total, sh["cache"])
    store = mix_fn = mutator = None
    if args.knn:
        store = _build_store(args, cfg, dev, mesh=mesh)
        mix_fn, _ = make_knnlm_mixer(cfg, mesh, shape, store, lam=args.lam)
        if args.knn_mutate:
            mutator = _WindowMutator(store)

    _sync(dev)
    t0 = time.perf_counter()
    for pos in range(args.prompt_len):
        tok, logits, cache = fn(params, prompt[rows, pos], cache, pos)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    tok = whole(tok)
    out = [tok]
    t0 = time.perf_counter()
    for step in range(args.steps):
        fed = tok
        tok, logits, cache = fn(params, fed[rows], cache, args.prompt_len + step)
        tok = whole(tok)
        if mix_fn is not None:
            h = params.embed_tokens(fed[:, None].long())[:, 0].float()
            tok = mix_fn(whole(logits), h).argmax(-1).to(torch.int32)
            if mutator is not None:
                mutator.step(h, tok)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    toks = torch.stack(out, dim=1).cpu().numpy()
    fe = _frontend_summary(_finish_frontend(store, args))
    mut = (f", {mutator.n_ops} live mutations ({mutator.n_ops / decode_s:.0f} ops/s)"
           if mutator else "")
    ms = decode_s / max(1, args.steps) * 1e3
    print(f"[serve] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} batch {args.batch}: "
          f"prompt {prefill_s:.2f}s, decode {args.steps} steps in {decode_s:.2f}s "
          f"({ms:.1f} ms/step{', kNN-LM mixed' if mix_fn else ''}{mut}{fe})")
    print("[serve] sample:", toks[0][:12])
    _dump_obs(args)
    return toks, store, dict(prefill_s=prefill_s, decode_s=decode_s, ms_per_step=ms,
                             mutations=mutator.n_ops if mutator else 0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--knn", action="store_true",
                    help="mix with an SM-tree kNN-LM datastore")
    ap.add_argument("--knn-mutate", action="store_true",
                    help="with --knn: live sliding-window add/evict of "
                         "datastore entries each decode step (batched "
                         "through the stream plane)")
    ap.add_argument("--frontend", action="store_true",
                    help="with --knn: route retrieval through the async "
                         "serving front-end (admission queue -> epoch-"
                         "pinned cohorts; mutations ride the scheduler "
                         "between epoch publishes)")
    ap.add_argument("--slo-ms", type=float, default=5.0,
                    help="front-end admission SLO: a partial cohort "
                         "dispatches once its oldest request is this old")
    ap.add_argument("--cohort-width", type=int, default=0,
                    help="front-end cohort width (0: use --batch)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="with --frontend: ship the WAL over a socket to "
                         "N read replicas and route queries through the "
                         "replica-aware router")
    ap.add_argument("--knn-shards", type=int, default=0,
                    help="with --knn-mutate/--frontend: shard the datastore "
                         "into a streaming forest of N SM-trees (per-shard "
                         "descent + top-k merge)")
    ap.add_argument("--rebalance-mode", default="incremental",
                    choices=["stop_world", "incremental"],
                    help="with --knn-shards: skew repair strategy")
    ap.add_argument("--obs", action="store_true",
                    help="enable the observability plane (metrics registry, "
                         "trace spans, flight recorder); prints a final "
                         "'[obs] {...}' JSON snapshot line")
    ap.add_argument("--obs-out", default=None, metavar="PATH",
                    help="with --obs: also write the final snapshot JSON to PATH")
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--mesh", default="single", choices=["single", "host"],
                    help="'host': the sharded decode over the process group's ranks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.prompt_len < 1:
        ap.error("--prompt-len must be >= 1 (decode needs a seed token)")
    if args.replicas and not args.frontend:
        ap.error("--replicas requires --frontend (the router fronts the "
                 "admission queue)")
    if args.knn_shards > 1:
        if not (args.knn_mutate or args.frontend):
            ap.error("--knn-shards requires --knn-mutate or --frontend "
                     "(the forest lives in the stream pipeline)")
        if args.replicas:
            ap.error("--knn-shards does not compose with --replicas "
                     "(socket replication follows single-tree engines)")
        if args.mesh == "host":
            ap.error("--knn-shards is the host-side forest; it does not "
                     "compose with --mesh host")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encdec and args.prompt_len + args.steps > cfg.max_target_len:
        ap.error(f"--prompt-len + --steps = {args.prompt_len + args.steps} passes "
                 f"{cfg.name}'s {cfg.max_target_len} decoder positions")
    if args.obs:
        obs.enable()
    dev = resolve_device(args.device)
    if args.mesh == "host":
        from repro_torch.launch.mesh import host_mesh
        mesh = host_mesh(dev)
        if mesh is not None:
            return serve_sharded(args, cfg, mesh)[0]
        print("[serve] --mesh host requested but only 1 rank is up; falling back to "
              "the UNSHARDED single-device path (start N ranks, e.g. torchrun "
              "--nproc-per-node N, to shard)", flush=True)
    params = M.init_params(cfg, 0, device=dev)
    store = _build_store(args, cfg, dev) if args.knn else None
    toks, t = serve_loop(args, cfg, params, store)
    fe = _frontend_summary(_finish_frontend(store, args))
    mut = (f", {t['mutations']} live mutations "
           f"({t['mutations'] / t['decode_s']:.0f} ops/s)" if t["mutations"] else "")
    print(f"[serve] {dev} batch {args.batch}: prompt {t['prefill_s']:.2f}s, "
          f"decode {args.steps} steps in {t['decode_s']:.2f}s "
          f"({t['ms_per_step']:.1f} ms/step"
          f"{', kNN-LM mixed' if store else ''}{mut}{fe})")
    print("[serve] sample:", toks[0][:12])
    _dump_obs(args)
    return toks


if __name__ == "__main__":
    main()
