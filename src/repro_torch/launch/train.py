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

``--mesh host`` on one process is the one-device run, as the reference's
is on one device; with ``torch.distributed`` up at more than one rank it
stops, since the sharded train step is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.smtree import resolve_device
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.dist.checkpoint import CheckpointManager, latest_step
from repro_torch.models.convert import (from_reference_tree, reference_layout,
                                        to_reference_tree)
from repro_torch.train.optimizer import AdamWConfig, AdamWState
from repro_torch.train.train_step import TrainSettings, init_all, make_train_step


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
    optimizer's moments; -> the optimizer state at the restored step."""
    for dst, src in ((dict(params.named_parameters()), tree["params"]),
                     (opt.mu, tree["opt"]["mu"]), (opt.nu, tree["opt"]["nu"])):
        for name, t in from_reference_tree(src, layout).items():
            dst[name].copy_(t)
    return AdamWState(tree["opt"]["step"].to(opt.step.device), opt.mu, opt.nu)


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encdec or cfg.frontend == "vision_stub":
        ap.error(f"{cfg.name} takes inputs beside the tokens; the trainer feeds "
                 f"synth_batch's tokens and labels only, as the reference's does")
    if (args.mesh == "host" and torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        ap.error("--mesh host over more than one rank needs the sharded train step "
                 "(ROADMAP Queue 1 item 17): not ported yet")
    dev = resolve_device(args.device)

    dc = DataConfig(seed=args.data_seed, vocab_size=cfg.vocab_size,
                    seq_len=args.seq_len, global_batch=args.global_batch)
    settings = TrainSettings(opt=AdamWConfig(
        lr=args.lr, warmup_steps=max(5, args.steps // 20), total_steps=args.steps))
    step_fn = make_train_step(cfg, settings)

    params, opt = init_all(cfg, 0, device=dev)
    layout = reference_layout(params, cfg)
    start = 0
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tree, manifest = mgr.restore_latest(restore_template(params, opt, layout))
        opt = load_state(tree, params, opt, layout)
        start = manifest["step"]
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
        batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(dc, step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / max(step - start, 1):.2f}s/step)",
                  flush=True)
        if mgr and step and step % args.ckpt_every == 0:
            # step + 1 = the next step to run: resume must not replay this one
            mgr.save(step + 1, state_tree(params, opt, layout))
    if mgr:
        mgr.save(args.steps, state_tree(params, opt, layout))
        mgr.wait()
    print(f"[train] done: {args.steps - start} steps, final loss "
          f"{float(metrics['loss']):.4f}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
