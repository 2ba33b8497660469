#!/usr/bin/env python3
"""Time the two forms of the log-step scans in a serving prefill, in turns.

    python3 tools/scan_forms.py [--device cpu --smoke]

``models/ssm.py:_scan_chunk`` (Mamba) and ``models/xlstm.py:_stabiliser``
(the mLSTM's stabiliser) scan in log2(L) passes.  Each pass can write its
tensors in place, or build new ones, which autograd needs (it keeps the
values a pass read).  This script times a prefill with each form, to show
what a form costs where no autograd records:

  * ``hybrid``: jamba-v0.1-52b cut to one 8-layer period, at full width in
    f32 (``chip_smoke.LM_FAMILIES_FULL["hybrid"]``), b=4 x 2048 tokens;
  * ``xlstm``: xlstm-1.3b at full size in f32, b=4 x 2048.

For each model, one warm prefill, then turns in the order in place, new,
new, in place; each turn runs ``REPS`` prefills through
``serve_step.make_prefill_step`` with the module's scan replaced by this
script's copy of that form, and reports the host ms of each (ending in a
synchronize), the CUDA-event ms and the peak memory.  The two forms'
logits must be equal bitwise.  Prints one JSON line a model and the card's
name and power limit.  Needs one CUDA card; ``--device cpu --smoke`` runs
the smoke configs on the CPU, to check the script.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm, xlstm  # noqa: E402
from repro_torch.serve.serve_step import make_prefill_step  # noqa: E402

REPS = 2
MODELS = {"hybrid": ("jamba-v0.1-52b", {"n_layers": 8}, ssm, "_scan_chunk"),
          "xlstm": ("xlstm-1.3b", {}, xlstm, "_stabiliser")}


def scan_in_place(a, u):
    L, d = a.shape[1], 1
    while d < L:
        u[:, d:] += a[:, d:] * u[:, :-d]
        a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return a, u


def scan_new(a, u):
    L, d = a.shape[1], 1
    while d < L:
        u = torch.cat([u[:, :d], u[:, d:] + a[:, d:] * u[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, u


def stabiliser_in_place(log_f, log_i, m0):
    A, B = log_f.clone(), log_i.clone()
    s, d = A.shape[1], 1
    while d < s:
        B[:, d:] = torch.maximum(B[:, :-d] + A[:, d:], B[:, d:])
        A[:, d:] = A[:, :-d] + A[:, d:]
        d *= 2
    return torch.maximum(m0[:, None] + A, B)


def stabiliser_new(log_f, log_i, m0):
    A, B = log_f, log_i
    s, d = A.shape[1], 1
    while d < s:
        B = torch.cat([B[:, :d], torch.maximum(B[:, :-d] + A[:, d:], B[:, d:])], dim=1)
        A = torch.cat([A[:, :d], A[:, :-d] + A[:, d:]], dim=1)
        d *= 2
    return torch.maximum(m0[:, None] + A, B)


FORMS = {"_scan_chunk": {"in_place": scan_in_place, "new": scan_new},
         "_stabiliser": {"in_place": stabiliser_in_place, "new": stabiliser_new}}


def time_model(name: str, device: str, smoke: bool) -> dict:
    arch, overrides, module, fn_name = MODELS[name]
    on_card = device == "cuda"
    mcfg = smoke_config(arch) if smoke else dataclasses.replace(get_config(arch), **overrides)
    params = M.init_params(mcfg, 0, device=device)
    b, s = (2, 32) if smoke else (4, 2048)
    tokens = synth_batch(DataConfig(vocab_size=mcfg.vocab_size, seq_len=s, global_batch=b),
                         0, with_labels=False)["tokens"]
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    prefill = make_prefill_step(mcfg)
    shipped = getattr(module, fn_name)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def run(form):
        setattr(module, fn_name, FORMS[fn_name][form])
        try:
            with torch.no_grad():
                out = prefill(params, batch)
            sync()
            return out
        finally:
            setattr(module, fn_name, shipped)

    logits = {form: run(form).cpu() for form in ("in_place", "new")}       # warm
    bitwise = bool(torch.equal(logits["in_place"], logits["new"]))
    del logits
    turns = []
    for form in ("in_place", "new", "new", "in_place"):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        host, dev_ms = [], []
        for _ in range(REPS):
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            run(form)
            host.append((time.perf_counter() - t0) * 1e3)
            if on_card:
                end.record()
                end.synchronize()
                dev_ms.append(start.elapsed_time(end))
        turns.append(dict(form=form, host_ms=host, event_ms=dev_ms or None,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card
                          else None))
    summary = {form: statistics.median(ms for t in turns if t["form"] == form
                                       for ms in t["host_ms"])
               for form in ("in_place", "new")}
    del params
    if on_card:
        torch.cuda.empty_cache()
    return dict(model=name, arch=mcfg.name, n_layers=mcfg.n_layers, b=b, s=s,
                function=f"{module.__name__}.{fn_name}", logits_bitwise=bitwise,
                turns=turns, median_host_ms=summary,
                new_over_in_place=summary["new"] / summary["in_place"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    ok = True
    for name in MODELS:
        rec = time_model(name, args.device, args.smoke)
        ok &= rec["logits_bitwise"]
        print(json.dumps(rec), flush=True)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
