"""The trainer, with checkpoint and restart (port of
``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch qwen2.5-3b --smoke --steps 200 \\
        --ckpt-dir /tmp/ckpt [--resume] [--fail-at 120] [--device cpu]

Runs on the CUDA card unless ``--device`` names another.  The fault-
tolerance contract is the reference's: the data pipeline is stateless in
the step index and a checkpoint carries (params, optimizer state, step), so
a run killed at any step and resumed gives the same trajectory as an
uninterrupted run, bitwise.  ``--fail-at`` injects the failure: it raises
``SystemExit`` before that step runs, once the checkpoint writes already
started have finished (as they do at the interpreter's exit).  A save
after step ``s`` is checkpoint ``s + 1``, the next step to run.
Checkpoints are the reference's ``{"params", "opt": {"step", "mu",
"nu"}}`` tree, leaf for leaf (``models/convert.py``), so either package
resumes the other's.

``--mesh host`` over more than one rank runs the sharded train step
(``train_step.make_train_step(cfg, mesh, ...)``) on a ('data', 'model')
mesh of shape (W // nm, nm), nm = 2 when the world size W is even, as the
reference lays out its devices.  The rank and the world come from the
usual ``torch.distributed`` environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``; ``torchrun`` sets them),
or from a process group the caller already started; the backend is NCCL
on the card (one card a rank) and gloo on the CPU.  Checkpoints hold the
full tree, written by rank 0 from the shards that every rank sends it leaf
by leaf, so a run resumes on any mesh or on one device; a resume on a
mesh reads each rank's shards of each leaf straight onto its card
(``restore_checkpoint(shardings=)``).  On one rank ``--mesh host`` is the one-device
run, as the reference's is on one device.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.smtree import resolve_device
from repro_torch.data.pipeline import DataConfig, model_batch
from repro_torch.dist.checkpoint import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.dist.sharding import to_named
from repro_torch.launch.mesh import host_mesh
from repro_torch.models.convert import reference_layout, to_reference_tree
from repro_torch.models.model import param_specs
from repro_torch.train.optimizer import AdamWConfig, AdamWState
from repro_torch.train.train_step import (TrainSettings, gather_state, init_all,
                                          init_sharded, make_train_step)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a crash at this step (restart demo)")
    ap.add_argument("--mesh", default="host", choices=["host", "single"])
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    return ap


def state_tree(params, opt: AdamWState, layout: dict, *, device="cpu") -> dict:
    """The checkpoint tree: the reference's ``{"params", "opt"}``, stacked
    on the host (or on ``device``)."""
    tree = lambda values: to_reference_tree(values, layout, device=device)
    return {"params": tree(dict(params.named_parameters())),
            "opt": {"step": opt.step.to(device), "mu": tree(opt.mu), "nu": tree(opt.nu)}}


def restore_template(params, opt: AdamWState, layout: dict):
    """The checkpoint tree's structure with an empty CPU tensor for every
    leaf: what a restore needs, without a host copy of the state (built on
    the meta device, which holds no data)."""
    def empty(node):
        if isinstance(node, dict):
            return {k: empty(v) for k, v in node.items()}
        if isinstance(node, list):
            return [empty(v) for v in node]
        return torch.empty(0)
    return empty(state_tree(params, opt, layout, device="meta"))


@torch.no_grad()
def load_state(tree: dict, params, opt: AdamWState, layout: dict) -> AdamWState:
    """Copy a restored checkpoint tree into the model's parameters and the
    optimizer's moments; -> the optimizer state at the restored step.  On
    a mesh the tree is this rank's shards (``restore_checkpoint(
    shardings=)``), ``params`` a ``ShardedLM`` and ``opt`` this rank's
    ZeRO-1 moments; a stacked leaf whose period axis the table splits
    holds only this rank's ``n`` periods, layer ``i`` at ``i % n``, and
    the moments of a layer another data rank holds are not loaded here."""
    for dst, src in ((dict(params.named_parameters()), tree["params"]),
                     (opt.mu, tree["opt"]["mu"]), (opt.nu, tree["opt"]["nu"])):
        for name, (path, idx) in layout.items():
            if name not in dst:
                continue
            node = src
            for k in path:
                node = node[k]
            dst[name].copy_(node if idx is None else node[idx % node.shape[0]])
    return AdamWState(tree["opt"]["step"].to(opt.step.device), opt.mu, opt.nu)


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend == "vision_stub" and args.seq_len <= cfg.n_image_tokens:
        ap.error(f"--seq-len {args.seq_len} leaves no text after {cfg.name}'s "
                 f"{cfg.n_image_tokens} image positions")
    dev = resolve_device(args.device)
    mesh = host_mesh(dev) if args.mesh == "host" else None
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    lead = mesh is None or dist.get_rank() == 0

    dc = DataConfig(seed=args.data_seed, vocab_size=cfg.vocab_size,
                    seq_len=args.seq_len, global_batch=args.global_batch)
    settings = TrainSettings(opt=AdamWConfig(
        lr=args.lr, warmup_steps=max(5, args.steps // 20), total_steps=args.steps))
    if mesh is None:
        step_fn = make_train_step(cfg, settings=settings)
        params, opt = init_all(cfg, 0, device=dev)
        layout = reference_layout(params, cfg)
        save_tree = lambda: state_tree(params, opt, layout)
    else:
        step_fn, shardings = make_train_step(cfg, mesh, model_batch(cfg, dc, 0), settings)
        params, opt = init_sharded(cfg, mesh, 0, device=dev)
        layout = reference_layout(param_specs(cfg), cfg)
        save_tree = lambda: sharded_state_tree(params, opt, cfg, mesh, layout)
    start = 0
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir and lead else None
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        if mesh is None:
            tree, manifest = mgr.restore_latest(restore_template(params, opt, layout))
        else:
            # every rank reads its own shards of each leaf, straight to its card
            meta = param_specs(cfg)
            named = dict(meta.named_parameters())
            template = restore_template(meta, AdamWState(torch.zeros(()), named, named), layout)
            tree, manifest = restore_checkpoint(
                args.ckpt_dir, template, shardings=to_named(
                    {"params": shardings["params"], "opt": shardings["opt"]}, mesh))
        opt = load_state(tree, params, opt, layout)
        start = manifest["step"]
        if lead:
            print(f"[train] resumed from step {start}")

    if start >= args.steps:
        print(f"[train] nothing to do: resumed at step {start} >= "
              f"--steps {args.steps}")
        return None

    t0 = time.time()
    for step in range(start, args.steps):
        if step == args.fail_at:
            if mgr:
                mgr.wait()
            raise SystemExit(f"[train] injected failure at step {step}")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in model_batch(cfg, dc, step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            loss = float(metrics["loss"])
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / max(step - start, 1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            # step + 1 = the next step to run: resume must not replay this one
            _save(mgr, step + 1, save_tree, mesh)
    if args.ckpt_dir:
        _save(mgr, args.steps, save_tree, mesh)
        if mgr:
            mgr.wait()
    if lead:
        print(f"[train] done: {args.steps - start} steps, final loss "
              f"{float(metrics['loss']):.4f}")
    return float(metrics["loss"])


def _save(mgr, step: int, tree, mesh) -> None:
    """Rank 0 writes; in a sharded run every rank sends its shards to rank
    0 first."""
    t = tree()
    if mgr:
        mgr.save(step, t)
    if mesh is not None:
        dist.barrier()


def sharded_state_tree(params, opt: AdamWState, cfg, mesh, layout: dict) -> dict | None:
    """The checkpoint tree of a sharded state on rank 0 (None on the
    others): the shards gathered to its host leaf by leaf
    (``gather_state``), then the reference's ``{"params", "opt"}``."""
    state = gather_state(params, opt, cfg, mesh)
    if state is None:
        return None
    full_p, full_mu, full_nu = state
    tree = lambda values: to_reference_tree(values, layout, device="cpu")
    return {"params": tree(full_p),
            "opt": {"step": opt.step.cpu(), "mu": tree(full_mu), "nu": tree(full_nu)}}


if __name__ == "__main__":
    main()
