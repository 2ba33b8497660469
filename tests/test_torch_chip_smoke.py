"""``chip_smoke.py`` rehearsed on the CPU at a tiny size.

Every phase of the on-card smoke test except the kernel build and the
profiler runs here on CPU tensors (plain versions of the kernels), with
JAX blocked: the index slice (``run``) and the kNN-LM serving slice
(``run_lm``, a 2-layer qwen2.5-3b smoke model).  This keeps the script's
control flow, shapes and checks working between chip runs; the launch
counts are only checked on the card.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(n=3000, dims=6, capacity=8, b_bench=16, b_exact=8, b_parity=8,
            b_recheck=8, n_small=1000, kernel_b=8, kernel_F=8, kernel_N=50,
            dist_nq=16, dist_ne=64, dist_path_nq=8, dist_path_ne=200, n_insert=40,
            timing_reps=2)
LM_TINY = dict(
    arch="qwen2.5-3b", smoke=True, prefill_b=2, prefill_s=16,
    serve_argv=["--knn", "--batch", "2", "--prompt-len", "4", "--steps", "3"],
    ds_seqs=4, ds_len=32, ds_chunk=2, ds_evict=16, ret_bs=[2, 4],
    wide_b=2, wide_F=4, wide_cap=8, wide_N=16, wide_dims=[160, 129, 131],
    flash_cases={"path_f32": [1, 4, 4, 40, 40, 16, True, "float32"],
                 "path_bf16": [1, 4, 4, 40, 40, 16, True, "bfloat16"],
                 "gqa_sq<sk": [1, 4, 2, 20, 40, 16, True, "float32"],
                 "noncausal_sq>sk": [1, 4, 2, 30, 12, 16, False, "float32"]},
    prune_nq=16, prune_ne=64, prune_d=5, timing_reps=2)
KEYS = {"name", "route", "source", "replaces", "launches", "launches_per_pass",
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def _rehearse(call: str, keep: tuple = ()):
    code = textwrap.dedent(f"""
        import json, sys
        sys.modules["jax"] = None
        sys.path.insert(0, {str(ROOT)!r})
        import chip_smoke
        out = chip_smoke.{call}
        print("RESULT", json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    rows = json.loads(proc.stdout.split("RESULT ", 1)[1])
    kept = [next(ln for ln in lines if ln["phase"] == k) for k in keep]
    return ([ln["phase"] for ln in lines], rows, *kept)


def test_index_slice_rehearses_on_the_cpu():
    phases, rows, replay, dist = _rehearse(f"run({TINY!r}, 'cpu')",
                                           keep=("frontier_replay_index", "kernel_distance"))
    assert phases == ["kernel_frontier", "kernel_distance", "build_tree",
                      "knn_bench_geometry", "knn_exact_geometry", "range_search",
                      "insert_delete", "frontier_replay_index", "descent_kernel_vs_plain"]
    # one cohort's frontiers at each geometry, replayed level by level: the
    # root level unfiltered, then every internal level and the leaf chunks
    res = replay["results"]
    assert set(res) == {"bench", "exact"}
    for geo, b in (("bench", TINY["b_bench"]), ("exact", TINY["b_exact"])):
        levels = res[geo]["levels"]
        assert len(levels) >= 3 and levels[0]["w"] == 1 and not levels[0]["prune"]
        assert all(lv["prune"] for lv in levels[1:])
        assert all(lv["pairs"] == b * lv["w"] and lv["bound_ms"] > 0 for lv in levels)
        total = res[geo]["per_descent"]
        assert total["pairs"] == sum(lv["pairs"] for lv in levels)
        assert total["live_evals"] == sum(lv["live_evals"] for lv in levels) > 0
    assert [r["name"] for r in rows] == ["frontier_scores", "frontier_scores[parent_prune]",
                                         "pairwise_distance"]
    for r in rows[:2]:
        assert set(r) == KEYS and r["route"] == "cuda"
    # the scan at the index path's shape, with its synthetic-shape row beside it
    scan = rows[2]
    assert set(scan) == KEYS | {"device_ms", "shape", "synthetic"}
    assert scan["shape"] == dict(nq=TINY["dist_path_nq"], ne=TINY["dist_path_ne"],
                                 d=TINY["dims"])
    assert scan["device_ms"] is None                 # measured on the card only
    assert scan["synthetic"]["nq"] == TINY["dist_nq"] and scan["synthetic"]["bound_ms"] > 0
    assert set(dist["results"]) == {f"{s}/{m}" for s in ("path", "synthetic")
                                    for m in ("d_inf", "sqeuclidean", "ip")}
    assert all(r["bound_by"] == "bytes" for r in dist["results"].values())


def test_lm_slice_rehearses_on_the_cpu():
    cfg = json.loads(json.dumps(LM_TINY))
    phases, rows = _rehearse(f"run_lm({cfg!r}, 'cpu')")
    assert phases == ["kernel_frontier_wide", "kernel_flash", "kernel_distance_prune",
                      "lm_serve", "knnlm_datastore", "lm_path_launches",
                      "frontier_replay"]
    assert [r["name"] for r in rows] == [
        "frontier_scores[wide]", "frontier_scores[wide,parent_prune]",
        "pairwise_distance_prune", "flash_attention_fwd"]
    assert [r["replaces"].rsplit(":", 1)[1] for r in rows] == ["109", "121", "62", "38"]
    for r in rows:
        extra = {"f32_cuda_core_bound_ms"} if r["name"] == "flash_attention_fwd" else set()
        extra |= {"device_ms"} if r["name"] == "pairwise_distance_prune" else set()
        assert set(r) == KEYS | extra and r["route"] == "cuda"
        assert (ROOT / r["source"]).exists()


def test_ptxas_summary_groups_instantiations_and_counts_spills():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    entry = ("_ZN44_GLOBAL__N__53518cb6_11_frontier_cu_d44215d6{}ILi{}ELb0ELi1EEEvPKiPKf")
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{entry.format('22frontier_narrow_kernel', 0)}' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 4816 bytes smem",
        f"ptxas info    : Compiling entry function '{entry.format('22frontier_narrow_kernel', 1)}' "
        "for 'sm_90a'",
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 4816 bytes smem",
        f"ptxas info    : Compiling entry function '{entry.format('20frontier_wide_kernel', 2)}' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 4816 bytes smem",
    ])
    assert chip_smoke.ptxas_summary(log) == {
        "frontier_narrow_kernel": {"instances": 2, "registers": [64, 128], "spill_bytes": 28,
                                   "spilling": ["<1,0,1>"]},
        "frontier_wide_kernel": {"instances": 1, "registers": [72, 72], "spill_bytes": 0,
                                 "spilling": []}}
