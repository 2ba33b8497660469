#!/usr/bin/env python3
"""Hold the bf16 flash kernel with P rounded to bf16 once to
``chip_smoke.py``'s bf16 checks beside the current kernel.

    python3 tools/flash_bf16_parts.py

The bf16 kernel takes P V with P in two bf16 parts, hi = bf16(p) and lo =
bf16(p - hi) (``pv()``), as the reference's kernel keeps p in f32.  This
tool shows what the checks see when it does not: ``one_part`` is the
current source with the lo product left out (P rounded to bf16 once),
written to a temporary directory and built there with the port's flags.
Beside the two builds, the plain version with its f32 sums
in key chunks of 256 and 1024 instead of 512 (``reordered256``,
``reordered1024``): how far a mere reordering moves the result.  Needs one
CUDA card, like ``chip_smoke.py``, whose helpers it uses.

  1. Every bf16 ``flash_cases`` shape of ``chip_smoke.LM_FULL``: max |err|
     against the plain version, the share of outputs that round apart from
     it (phase 8 holds the current kernel under 1%) and the share apart by
     more than one bf16 ulp (under 0.1%), and the kernel's ms.
  2. The bf16 prefills of ``chip_smoke.LM_ARCHS_FULL`` (yi-34b, 60 layers,
     and grok-1-314b at 4 layers) at b=4 x 2048, each run
     against the plain attention's: the share of MoE routings that differ
     (against 1e-3), the max |logit| error on the tokens whose routing
     agreed against two bf16 ulps of max |plain logit|, and the argmax
     where the plain top-1 leads by more than twice that (``lm_family``'s
     end-to-end backstop takes the larger of each bound and twice the
     ``reordered256`` run's value).
  3. Both layer by layer, each build against the plain run: after each
     layer, the largest |difference| of the residual stream in bf16 ulps
     of its largest |value| (``cum_ulps``), and the same for that layer
     alone, run on the plain run's input (``local_ulps``), with the rest
     of ``chip_smoke.layer_rows``' row for it: the attention's outputs
     against the plain version's on the same q, k, v (the share that
     rounds apart, the share apart by more than one ulp) and, on MoE
     layers, the share of routings that differ.  ``chip_smoke.py`` holds
     the current kernel's local rows to its per-layer bounds.

Prints one JSON line per row.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the line of ``pv()`` that issues the lo product first; starting its loop
# at 1 leaves only hi = bf16(p)
TWO_PARTS = "for (int part = 0; part < 2; ++part) {  // 0: lo, 1: hi"
ONE_PART = "for (int part = 1; part < 2; ++part) {  // hi alone"


def one_part_source(tmp: Path) -> Path:
    """The current source with P rounded to bf16 once, under ``tmp``."""
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu").read_text()
    if src.count(TWO_PARTS) != 1:
        raise RuntimeError("pv()'s two-part loop not found in flash_attention.cu")
    out = tmp / "flash_attention_one_part.cu"
    out.write_text(src.replace(TWO_PARTS, ONE_PART))
    return out


def builds(baselines: dict[str, Path]) -> dict:
    """name -> a flash forward (q, k, v, causal) through that build of the
    source, the current kernel as ``two_parts``."""
    sys.path.insert(0, str(ROOT / "tools"))
    from frontier_turns import build_libs

    from repro_torch.kernels import flash_attention as FA
    current = FA._lib
    fns = {"two_parts": FA.flash_attention_fwd}
    for name, (lib, _) in build_libs("flash_attention", baselines).items():
        lib.flash_attention_fwd_launch.argtypes = current().flash_attention_fwd_launch.argtypes
        lib.flash_attention_fwd_launch.restype = current().flash_attention_fwd_launch.restype
        lib.flash_attention_max_head_dim.restype = current().flash_attention_max_head_dim.restype

        def fwd(q, k, v, causal=True, lib=lib):
            FA._lib = lambda: lib
            try:
                return FA.flash_attention_fwd(q, k, v, causal=causal)
            finally:
                FA._lib = current
        fns[name] = fwd
    return fns


def reordered(chunk: int):
    from repro_torch.kernels.attention_plain import chunked_attention
    return lambda q, k, v, causal=True: chunked_attention(q, k, v, causal=causal, chunk=chunk)


def kernel_rows(fns: dict, chip_smoke) -> None:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_torch
    _, time_ms, _ = chip_smoke.timers(True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for case, (b, h, hk, sq, sk, d, causal, dt) in chip_smoke.LM_FULL["flash_cases"].items():
        if dt != "bfloat16":
            continue
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").bfloat16()
        q, k, v = rnd(b, h, sq, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d)
        want = flash_attention_torch(q, k, v, causal=causal)
        row = {}
        for name, fn in fns.items():
            got = fn(q, k, v, causal=causal)
            row[name] = dict(max_abs_err=float((got.float() - want.float()).abs().max()),
                             **chip_smoke.rounding_shares(got, want))
            if not name.startswith("reordered"):
                row[name]["ms"] = time_ms(lambda: fn(q, k, v, causal=causal), iters=10)
            row[name]["passes_phase_8"] = chip_smoke.within_rounding(row[name])
            del got
        print(json.dumps({"phase": "flash_bf16_parts", "case": case,
                          "shape": [b, h, hk, sq, sk, d], "rows": row}), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()


def layer_rows(fns: dict, mcfg, params, batch, chip_smoke) -> None:
    """Where the runs part, through ``chip_smoke``'s per-layer helpers: the
    plain run's input to every layer (and the last layer's output) kept
    on the host (``layer_inputs``); then each build's whole run compared
    with it after every layer (``cum_ulps``), and each layer run alone on
    the plain run's input (``layer_rows``: ``local_ulps``, with the
    attention's rounding shares and, on MoE layers, the routing share)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_torch

    plain = chip_smoke.layer_inputs(mcfg, params, batch, flash_attention_torch)
    local = chip_smoke.layer_rows(mcfg, params, batch, fns, plain)
    for name, fn in fns.items():
        run, _ = chip_smoke.layer_inputs(mcfg, params, batch, fn)
        rows = []
        for r in local[name]:
            i, want = r["layer"], plain[0][r["layer"] + 1].float()
            cum = float((run[i + 1].float() - want).abs().max())
            rows.append(dict(r, cum_ulps=cum / chip_smoke.bf16_ulp(r["top"]),
                             local_ulps=r["layer_ulps"]))
        del run
        first = next((r["layer"] for r in rows if r["cum_ulps"] > 0), None)
        print(json.dumps({"phase": "layers_bf16_parts", "arch": mcfg.name, "build": name,
                          "first_layer_apart": first,
                          "largest": chip_smoke.largest(rows), "rows": rows}), flush=True)
        torch.cuda.empty_cache()


def prefill_rows(fns: dict, chip_smoke) -> None:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, model_batch
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import make_prefill_step

    for key in ("yi", "grok"):
        fcfg = chip_smoke.LM_ARCHS_FULL[key]
        mcfg = dataclasses.replace(get_config(fcfg["arch"]), **fcfg["overrides"])
        B, S = fcfg["prefill_b"], fcfg["prefill_s"]
        params = M.init_params(mcfg, 0, device="cuda")
        batch = {k: torch.from_numpy(v).cuda() for k, v in model_batch(mcfg, DataConfig(
            vocab_size=mcfg.vocab_size, seq_len=S, global_batch=B), 0).items()
            if k != "labels"}
        rp = []
        plain = make_prefill_step(mcfg, _attention=flash_attention_torch,
                                  _routing=rp)(params, batch)
        top = float(plain.abs().max())
        tol, rule = chip_smoke.logit_bound(top, mcfg.compute_dtype)
        rows = {}
        for name, fn in fns.items():
            rk = []
            got = make_prefill_step(mcfg, _attention=fn, _routing=rk)(params, batch).cpu()
            flip, agree = chip_smoke.routing_agreement(rk, rp, (B, S))
            cmp = chip_smoke.logits_against_plain(got, plain, agree, 2 * tol)
            rows[name] = dict(routing_differs_share=flip,
                              max_abs_logit_err=cmp["max_abs_logit_err"],
                              within_logit_bound=cmp["max_abs_logit_err"] <= tol,
                              within_routing_bound=flip <= 1e-3,
                              argmax_positions=cmp["argmax_positions"],
                              argmax_positions_equal=cmp["argmax_positions_equal"],
                              tokens_compared=cmp["tokens_compared"])
            # yi's 68.8 GB of weights leave ~10 GB: give back what each run cached
            del got, rk
            torch.cuda.empty_cache()
        print(json.dumps({"phase": "prefill_bf16_parts", "arch": mcfg.name,
                          "n_layers": mcfg.n_layers, "b": B, "s": S, "max_abs_logit": top,
                          "logit_bound": tol, "bound_rule": rule, "rows": rows}), flush=True)
        del plain, rp
        torch.cuda.empty_cache()
        layer_rows(fns, mcfg, params, batch, chip_smoke)
        del params, batch
        torch.cuda.empty_cache()


def main() -> int:
    # yi's prefills run within ~10 GB of the card's memory: let the
    # allocator grow segments rather than fragment them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("flash_bf16_parts: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    print(chip_smoke.nvidia_smi_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = builds({"one_part": one_part_source(Path(tmp))})
    fns.update(reordered256=reordered(256), reordered1024=reordered(1024))
    kernel_rows(fns, chip_smoke)
    prefill_rows(fns, chip_smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
