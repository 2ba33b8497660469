"""End-to-end training example: a few hundred steps with checkpoints
and a kill/resume demonstration (port of ``examples/train_lm.py``).

    python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]

Uses the production trainer (``repro_torch.launch.train``) on a reduced
qwen2.5-family config, on the card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.launch import train


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    steps = args.steps
    dev = [] if args.device is None else ["--device", args.device]
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        # 1. train with an injected failure half-way
        try:
            train.main(["--smoke", "--steps", str(steps), "--ckpt-dir", ckpt,
                        "--ckpt-every", str(max(10, steps // 4)),
                        "--fail-at", str(steps // 2), "--log-every", "20"] + dev)
            raise AssertionError("expected injected failure")
        except SystemExit as e:
            print(f"-> {e}")

        # 2. resume from the latest checkpoint and finish
        loss = train.main(["--smoke", "--steps", str(steps), "--ckpt-dir", ckpt,
                           "--resume", "--log-every", "20"] + dev)
        print(f"resumed run finished with loss {loss:.4f}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return loss


if __name__ == "__main__":
    main()
