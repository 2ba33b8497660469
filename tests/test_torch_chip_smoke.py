"""``chip_smoke.py`` rehearsed on the CPU at a tiny size.

Every phase of the on-card smoke test except the kernel build and the
profiler runs here on CPU tensors (plain versions of the kernels), with
JAX blocked: the index slice (``run``), the forest pass (``run_forest``)
and the kNN-LM serving slice (``run_lm``, a 2-layer qwen2.5-3b smoke
model).  This keeps the script's
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

from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(n=3000, dims=6, capacity=8, b_bench=16, b_exact=8, b_parity=8,
            b_recheck=8, n_small=1000, kernel_b=8, kernel_F=8, kernel_N=50,
            dist_nq=16, dist_ne=64, dist_path_nq=8, dist_path_ne=200, n_insert=40,
            sm_rows=400, sm_min_rows=10, timing_reps=2)
LM_TINY = dict(
    arch="qwen2.5-3b", smoke=True, prefill_b=2, prefill_s=16,
    serve_argv=["--knn", "--batch", "2", "--prompt-len", "4", "--steps", "3"],
    ds_seqs=4, ds_len=32, ds_chunk=2, ds_evict=16, ds_evict_before=8, ret_bs=[2, 4],
    wide_b=2, wide_F=4, wide_cap=8, wide_N=16, wide_dims=[160, 129, 131],
    wide_timed=[160, 131],
    flash_cases={"path_f32": [1, 4, 4, 40, 40, 16, True, "float32"],
                 "path_bf16": [1, 4, 4, 40, 40, 16, True, "bfloat16"],
                 "gqa_sq<sk": [1, 4, 2, 20, 40, 16, True, "float32"],
                 "noncausal_sq>sk": [1, 4, 2, 30, 12, 16, False, "float32"],
                 "whisper_encoder": [2, 2, 2, 30, 30, 8, False, "float32"],
                 "whisper_decoder": [2, 2, 2, 12, 12, 8, True, "float32"],
                 "whisper_cross": [2, 2, 2, 12, 30, 8, False, "float32"]},
    prune_nq=16, prune_ne=64, prune_d=5, timing_reps=2)
FOREST_TINY = dict(n=4000, dims=6, capacity=8, n_shards=4, b_bench=16, b_exact=8,
                   exact_fs=[64, 256, 1024, 4096], n_insert=60, n_delete=60,
                   n_extract=16, b_recheck=8, timing_reps=2)
LM_ARGV = ["--batch", "2", "--prompt-len", "4", "--steps", "3"]
STREAM_TINY = dict(
    ds_fs=[8, 32, 128, 512], ds_b=4,
    forest=dict(n=8000, dims=6, capacity=8, n_shards=4, drain=600, batch=300,
                both_planes=2, steps=6, snapshot_at=3, max_skew=1.3, min_objects=256,
                b_bench=16, b_exact=8, exact_fs=[64, 256, 1024, 4096]),
    serve_argvs={"knn_mutate": ["--knn", "--knn-mutate", "--obs"] + LM_ARGV,
                 "knn_shards4": ["--knn", "--knn-mutate", "--knn-shards", "4", "--obs"]
                 + LM_ARGV})
SERVE_TINY = dict(
    n=3000, dims=6, capacity=8, clients=4, widths=[8, 1], per_client={8: 4, 1: 2},
    slo_ms=5.0, pool=256, drill_batches=3, drill_rows=40, drill_min_per_client=2,
    exact_b=8, exact_fs=[64, 256, 1024, 4096], replicas=2,
    fault=dict(seed=7, drop_p=0.05, reorder_p=0.05), chunk_bytes=64, router_b=8,
    write_rows=8,
    torn_rows=16, forest_b=16,
    serve_argv=["--knn", "--knn-mutate", "--frontend", "--replicas", "2", "--obs"] + LM_ARGV)
LM_FAMILIES_TINY = dict(       # params: filled in from the reference's exact count
    moe=dict(arch="qwen2-moe-a2.7b", smoke=True, overrides={}, params=None, prefill_b=2,
             prefill_s=16, serve_argv=["--arch", "qwen2-moe-a2.7b", "--knn"] + LM_ARGV),
    hybrid=dict(arch="jamba-v0.1-52b", smoke=True, overrides={"n_layers": 8}, params=None,
                prefill_b=2, prefill_s=16, decode_b=2, decode_len=8,
                serve_argv=["--arch", "jamba-v0.1-52b", "--knn"] + LM_ARGV),
    xlstm=dict(arch="xlstm-1.3b", smoke=True, overrides={}, params=None, prefill_b=2,
               prefill_s=16, decode_b=2, decode_len=8,
               serve_argv=["--arch", "xlstm-1.3b", "--knn"] + LM_ARGV),
    audio=dict(arch="whisper-tiny", smoke=True, overrides={}, params=None, prefill_b=2,
               frames=24, prefill_s=16, decode_len=8,
               serve_argv=["--arch", "whisper-tiny", "--knn"] + LM_ARGV),
    max_flip_share=1e-3, timing_reps=2)
KEYS = {"name", "route", "source", "replaces", "launches", "launches_per_pass",
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def _rehearse(call: str, keep: tuple = ()):
    code = textwrap.dedent(f"""
        import json, sys
        sys.modules["jax"] = None
        sys.path.insert(0, {str(ROOT)!r})
        import chip_smoke
        out = eval({call!r}, vars(chip_smoke))
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
    phases, rows, replay, dist, sm = _rehearse(
        f"run({TINY!r}, 'cpu')",
        keep=("frontier_replay_index", "kernel_distance", "device_split_merge"))
    assert phases == ["kernel_frontier", "kernel_distance", "build_tree",
                      "knn_bench_geometry", "knn_exact_geometry", "range_search",
                      "insert_delete", "frontier_replay_index", "device_split_merge",
                      "descent_kernel_vs_plain"]
    # the cohort through the device passes, held against the host plane
    assert sm["bitwise_vs_host_plane"] and sm["validate"] and sm["recheck_rows_bitwise"] > 0
    assert sm["resolved_by_split"] >= TINY["sm_min_rows"] <= sm["resolved_by_merge"]
    assert sm["split_pass"]["rows"] == sm["scan_statuses"]["overflow"] > 0
    assert sm["merge_pass"]["rows"] == sm["scan_statuses"]["underflow"] > 0
    assert sm["split_pass"]["internal_nodes_added"] > 0 and sm["merge_pass"]["merges"] > 0
    assert sm["merge_pass"]["redistributions"] > 0
    assert sm["host_plane"]["rows"] == sm["split_pass"]["rows"] + sm["merge_pass"]["rows"]
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


def test_forest_pass_rehearses_on_the_cpu():
    phases, counts, build, exact, perq, mut = _rehearse(
        f"run_forest({FOREST_TINY!r}, 'cpu')",
        keep=("forest_build", "forest_knn_exact", "forest_perquery", "forest_mutations"))
    assert phases == ["forest_build", "forest_knn_bench", "forest_knn_exact",
                      "forest_perquery", "forest_mutations", "forest_path_launches"]
    assert len(build["heights"]) == FOREST_TINY["n_shards"] == len(build["n_nodes"])
    assert build["common_height"] == build["heights"][0] and build["device_bytes"] > 0
    # the exact geometry: no shard overflowed, every row held against the scan
    assert exact["no_overflow"] and exact["rows_checked_bitwise"] == FOREST_TINY["b_exact"]
    assert exact["sharded_scan"]["equals_one_device_scan"]
    assert perq["results"]["exact"]["rows_checked"] > 0
    assert "rows_checked" not in perq["results"]["bench"]     # timed, not compared
    assert mut["replay_bitwise"] and mut["extract"]["bitwise"]
    assert sum(mut["statuses"].values()) == FOREST_TINY["n_insert"] + FOREST_TINY["n_delete"]
    # the log through both planes of StreamingForest: the stacked plane's
    # split and merge fronts (or the host plane's passes) take every row
    # the scan left, and the planes agree bit for bit
    fronts = mut["fronts"]
    assert fronts["planes_bitwise"] and fronts["n_shards"] == FOREST_TINY["n_shards"]
    left = mut["statuses"]["overflow"] + mut["statuses"]["underflow"]
    assert left > 0 and mut["escalation_rows_left"] == 0
    for plane in ("stacked", "host"):
        p = fronts[plane]
        assert p["split_rows"] + p["merge_rows"] + p["escalated_rows"] == left
        assert p["ms_per_row"] > 0
    assert set(counts) == {"launches", "knn", "scan"}      # launches count on the card only


def test_forest_counts_join_the_index_rows():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rows = [dict(name=n, launches=c, launches_per_pass={p: c})
            for n, c, p in (("f", 17, "knn_bench"), ("fp", 119, "knn_bench"),
                            ("d", 2, "brute_force_knn"))]
    forest = dict(launches=dict(frontier=8, frontier_pruned=64, distance=9),
                  knn=dict(frontier=8, frontier_pruned=24, distance=0),
                  scan=dict(frontier=0, frontier_pruned=0, distance=8))
    f, fp, d = chip_smoke.with_forest(rows, forest)
    # ``launches`` stays the index path's count; the forest pass has its own
    assert f["launches"] == 17 and f["launches_by_path"] == {"index": 17, "forest": 8}
    assert f["launches_per_pass"] == {"knn_bench": 17, "forest_knn": 8}
    assert fp["launches_per_pass"]["forest_knn"] == 24 and fp["launches"] == 119
    assert d["launches_per_pass"] == {"brute_force_knn": 2, "brute_force_knn_sharded": 8}
    assert rows[0]["launches"] == 17                          # inputs untouched


@pytest.fixture(scope="module")
def lm_and_stream():
    """The kNN-LM slice, then the stream path (S1-S3) and the serving path
    (R1-R4) on its state, in one rehearsal."""
    cfg = json.loads(json.dumps(LM_TINY))
    serve = json.loads(json.dumps(SERVE_TINY))
    serve["per_client"] = {int(k): v for k, v in serve["per_client"].items()}
    return _rehearse(f"(lambda ctx, rows: [rows, run_stream(ctx, {STREAM_TINY!r}, 'cpu'), "
                     f"run_serve(ctx, {serve!r}, 'cpu')])"
                     f"(*run_lm({cfg!r}, 'cpu'))",
                     keep=("knnlm_batched_evict", "stream_datastore", "stream_forest",
                           "lm_serve_stream", "stream_path_launches", "serve_frontend",
                           "serve_replication", "serve_failover", "lm_serve_frontend",
                           "serve_path_launches"))


def test_lm_slice_rehearses_on_the_cpu(lm_and_stream):
    phases, (rows, *_), ev, *_ = lm_and_stream
    assert phases[:8] == ["kernel_frontier_wide", "kernel_flash", "kernel_distance_prune",
                          "lm_serve", "knnlm_datastore", "lm_path_launches",
                          "knnlm_batched_evict", "frontier_replay"]
    assert ev["deletes"] == LM_TINY["ds_evict"] == sum(ev["statuses"].values())
    assert ev["validate"] and ev["live_ids_equal_evict_before"]
    assert set(ev["retrieval"]) == {f"b{b}" for b in LM_TINY["ret_bs"]}
    assert [r["name"] for r in rows] == [
        "frontier_scores[wide]", "frontier_scores[wide,parent_prune]",
        "pairwise_distance_prune", "flash_attention_fwd"]
    assert [r["replaces"].rsplit(":", 1)[1] for r in rows] == ["109", "121", "62", "38"]
    for r in rows:
        extra = ({"f32_cuda_core_bound_ms", "by_shape"} if r["name"] == "flash_attention_fwd"
                 else set())
        extra |= {"device_ms"} if r["name"] == "pairwise_distance_prune" else set()
        extra |= {"dim", "by_dim"} if "[wide" in r["name"] else set()
        assert set(r) == KEYS | extra and r["route"] == "cuda"
        assert (ROOT / r["source"]).exists()
    for r in rows[:2]:              # the first served width in the row, the others apart
        assert r["dim"] == 160 and set(r["by_dim"]) == {"131"}
        assert set(r["by_dim"]["131"]) == {"ms", "plain_ms", "bound_ms", "bound_by"}
    # whisper's three attentions, timed and bounded beside the LM's shape
    shapes = rows[3]["by_shape"]
    assert set(shapes) == {"whisper_encoder", "whisper_decoder", "whisper_cross"}
    assert [shapes[k]["causal"] for k in sorted(shapes)] == [False, True, False]
    assert all(v["bound_ms"] > 0 and v["ms"] > 0 and v["plain_ms"] > 0 for v in shapes.values())
    assert shapes["whisper_cross"]["shape"] == [2, 2, 2, 12, 30, 8]


def test_stream_path_rehearses_on_the_cpu(lm_and_stream):
    phases, (_, counts, _), _, s1, s2, s3, launches, *_ = lm_and_stream
    assert phases[8:12] == ["stream_datastore", "lm_serve_stream", "stream_forest",
                            "stream_path_launches"]
    # S1: the batches through the stream, each beside a pinned epoch
    n_ev = LM_TINY["ds_evict"]
    assert s1["batches"]["evict"]["rows"] == s1["batches"]["add"]["rows"] == n_ev
    assert s1["pinned_epochs_unchanged"] and s1["live_ids_equal_evict_before"]
    for b in s1["batches"].values():
        assert b["wal_append_seconds"] > 0 and b["apply_seconds"] > 0
        assert b["publish_seconds"] > 0 and b["resident_epoch_bytes"] > 0
    assert s1["wal_appends"] == 4 and s1["wal_bytes"] > 0
    assert s1["snapshot"]["restore_equals_live"] and s1["replica"]["digest_equal"]
    assert s1["snapshot"]["bytes"] > 0
    assert set(s1["retrieval"]) == {"b4"} and s1["retrieval"]["b4"]["bitwise_vs_plain"]
    assert s1["smallest_exact_F_b64"] in STREAM_TINY["ds_fs"] + [None]
    # S2: the drain, both planes, the migration, the crash drill, kNN
    f = STREAM_TINY["forest"]
    assert len(s2["batches"]) == f["drain"] // f["batch"]
    assert all(b["planes_bitwise"] for b in s2["batches"][:f["both_planes"]])
    assert s2["migration"]["steps_run"] == f["steps"] and s2["migration"]["objects_moved"] > 0
    assert s2["migration"]["skew_at_plan"] > f["max_skew"] > s2["migration"]["skew_after"] or \
        s2["migration"]["skew_after"] < s2["migration"]["skew_at_plan"]
    assert s2["crash_drill"]["restore_equals_live"]
    assert s2["knn"]["bench"]["bitwise_vs_plain"] and s2["knn"]["exact"]["rows_checked"] == 8
    assert s2["stop_world"]["moved"] > 0 and s2["stop_world"]["skew_after"] < 1.05
    # S3: the launcher with the streaming store, one tree and 4 shards
    for name, run in s3["runs"].items():
        assert run["mutations"] == 2 * 2 * 3 and run["ms_per_decode_step"] > 0
        assert run["obs_rows"]["stream.batches_total"] == 6
        assert run["obs_rows"]["epoch.publishes_total"] == 6
    assert set(counts) == set(launches) - {"phase"} == {
        "frontier", "frontier_pruned", "frontier_wide", "frontier_wide_pruned",
        "distance", "flash"}


def test_stream_counts_join_every_row():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rows = [dict(name="frontier_scores", launches=17, launches_by_path={"index": 17,
                                                                        "forest": 8}),
            dict(name="frontier_scores[wide]", launches=46),
            dict(name="pairwise_distance_prune", launches=0)]
    stream = dict(frontier=5, frontier_pruned=30, frontier_wide=20, frontier_wide_pruned=90,
                  distance=2, flash=0)
    a, b, c = chip_smoke.with_path(rows, stream, "stream")
    assert a["launches_by_path"] == {"index": 17, "forest": 8, "stream": 5}
    assert b["launches_by_path"] == {"lm": 46, "stream": 20} and b["launches"] == 46
    assert c["launches_by_path"] == {"lm": 0, "stream": 0}
    assert "launches_by_path" not in rows[1]                  # inputs untouched
    serve = dict(stream, frontier=7, frontier_wide=3)
    a, b, c = chip_smoke.with_path([a, b, c], serve, "serve")
    assert a["launches_by_path"] == {"index": 17, "forest": 8, "stream": 5, "serve": 7}
    assert b["launches_by_path"] == {"lm": 46, "stream": 20, "serve": 3}
    assert c["launches_by_path"]["serve"] == 0 and a["launches"] == 17


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


@pytest.mark.timeout(600)
def test_serve_path_rehearses_on_the_cpu(lm_and_stream):
    phases, (_, _, counts), *kept = lm_and_stream
    r1, r2, r3, r4, launches = kept[-5:]
    assert phases[12:] == ["serve_frontend", "serve_replication", "serve_failover",
                           "lm_serve_frontend", "serve_path_launches"]
    # R1: both widths served every client's queries; the drill pinned every
    # epoch and re-ran every ticket on it, bitwise
    w_hi, w_lo = (str(w) for w in SERVE_TINY["widths"])
    assert r1["widths"][w_hi]["queries"] == SERVE_TINY["clients"] * 4
    assert r1["widths"][w_lo]["mean_fill"] == 1.0
    assert r1["widths"][w_hi]["mean_fill"] > 1.0 and r1["coalesce_speedup"] > 0
    d = r1["drill"]
    assert d["epochs_pinned"] == SERVE_TINY["drill_batches"] + 1
    assert sum(d["rows_rechecked_by_epoch"].values()) == d["queries"]
    assert len(d["batch_seconds"]) == SERVE_TINY["drill_batches"]
    assert d["cohorts_behind_apply"] <= d["cohorts"]
    assert r1["tickets_bitwise_on_their_epochs"] and r1["plain_scorer_cohort_bitwise"]
    # R2: the replicas caught up under faults; the router's three modes
    assert [c["digest_equal"] for c in r2["catch_up"]] == [True, True]
    assert all(c["lag_after"] == 0 and c["bytes"] > 0 for c in r2["catch_up"])
    assert r2["bytes_shipped"] > 0
    assert r2["router"]["replica_reads_bitwise_to_leader"]
    assert r2["router"]["degraded_staleness"] == [1]
    # R3: promoted at the acknowledged state under a higher token
    assert r3["token_after"] > r3["token_before"] and r3["digest_equal"] and r3["fenced_out"]
    assert r3["writes_after_promotion_seq"] == r3["seq"] + 1 and r3["failover_ms"] > 0
    assert r3["forest"]["knn_bitwise_to_live"]
    # R4: the launcher with the front-end and 2 replicas
    assert r4["frontend"]["n_queries"] == 2 * 3 and r4["replicas"]["max_lag"] == 0
    assert r4["missing_rows"] == [] and {"frontend", "router", "replica", "wal",
                                         "descent"} <= set(r4["fetch_metrics_families"])
    assert set(counts) == set(launches) - {"phase", "seconds"}
    assert set(launches["seconds"]) == {"R1", "R2", "R3", "R4"}


def test_lm_families_rehearse_on_the_cpu():
    """``run_lm_families``: qwen2-moe's smoke model and jamba's cut to one
    period, with the exact parameter counts the reference gives them."""
    import copy
    import dataclasses

    from repro.configs.all_archs import smoke_config
    from repro.models.model import exact_param_count
    cfg = copy.deepcopy(LM_FAMILIES_TINY)
    for fam in ("moe", "hybrid", "xlstm", "audio"):
        c = cfg[fam]
        c["params"] = exact_param_count(dataclasses.replace(smoke_config(c["arch"]),
                                                            **c["overrides"]))
    phases, fam, moe, hyb, xl, audio, launches = _rehearse(
        f"run_lm_families({cfg!r}, 'cpu')", keep=("lm_moe", "lm_hybrid", "lm_xlstm",
                                                  "lm_audio", "lm_families_launches"))
    assert phases == ["lm_moe", "lm_hybrid", "lm_xlstm", "lm_audio", "lm_families_launches"]
    assert moe["params"] == cfg["moe"]["params"] and hyb["params"] == cfg["hybrid"]["params"]
    assert moe["reduced"] == [] and "8 of 16 layers" in hyb["reduced"][0]
    for ln, n_moe in ((moe, 2), (hyb, 4)):
        pf = ln["prefill"]
        assert pf["moe_layers"] == n_moe and len(pf["ms"]) == 1 + cfg["timing_reps"]
        assert pf["routing_differs_share"] == 0.0 and pf["tokens_compared"] == 2 * 16
        assert pf["last_argmax_equal"] and 0 < pf["aux"]["drop_frac"] < 1
        blocks = pf["profile"]["blocks"]
        assert blocks["moe"]["calls"] == n_moe and blocks["attn"]["calls"]
        assert ln["serve"]["store_keys"] == 2048 and ln["serve"]["key_width"] == 64
        assert ln["serve"]["retrieval_bitwise_vs_plain"]["b"] == 2
        assert len(ln["serve"]["sample"]) == 4
    assert hyb["prefill"]["profile"]["blocks"]["mamba"]["calls"] == 7   # 7 of 8 blocks
    assert hyb["prefill"]["profile"]["blocks"]["attn"]["calls"] == 1
    assert "mlp" in hyb["prefill"]["profile"]["blocks"]          # the dense FFNs
    d = hyb["decode_vs_forward"]
    assert d["tokens_compared"] == 2 * 8 and d["max_abs_logit_err"] < 1e-4
    assert d["capacity_factor"] == 8 / 2
    # L3: xLSTM, no attention and no MoE layer; decode against the forward
    pf = xl["prefill"]
    assert xl["params"] == cfg["xlstm"]["params"] and xl["reduced"] == []
    assert pf["moe_layers"] == 0 and pf["routing_differs_share"] == 0.0
    assert pf["tokens_compared"] == 2 * 16 and pf["max_abs_logit_err"] == 0.0
    assert {k: v["calls"] for k, v in pf["profile"]["blocks"].items()} == {"mlstm": 14,
                                                                          "slstm": 2}
    d = xl["decode_vs_forward"]
    assert d["tokens_compared"] == 2 * 8 and d["max_abs_logit_err"] < 1e-4
    assert xl["serve"]["key_width"] == 64 and len(xl["serve"]["sample"]) == 4
    # L4: whisper, the forward, the cross K/V and the cached decode
    assert audio["params"] == cfg["audio"]["params"] and audio["enc_layers"] == 2
    fw = audio["forward"]
    assert (fw["b"], fw["frames"], fw["tokens"]) == (2, 24, 16) and fw["last_argmax_equal"]
    assert fw["max_abs_logit_err"] <= 1e-3 * fw["max_abs_logit"]
    assert {k: v["calls"] for k, v in fw["profile"]["blocks"].items()} == {
        "enc_attn": 2, "attn": 2, "xattn": 2, "mlp": 4}
    assert audio["decode_vs_forward"]["tokens"] == 8
    assert audio["decode_vs_forward"]["max_abs_logit_err"] < 1e-4
    assert audio["serve"]["key_width"] == 64 and audio["serve"]["store_keys"] == 2048
    assert set(fam) == {"lm_moe", "lm_hybrid", "lm_xlstm", "lm_audio"}
    for phase, got in fam.items():
        extra = {"prefill_cache"} if phase == "lm_audio" else set()
        assert set(got["per_pass"]) == {"prefill_forward", "decode_step_knn",
                                        "decode_step_knn_pruned"} | extra
        assert set(got["counts"]) == {"frontier", "frontier_pruned", "frontier_wide",
                                      "frontier_wide_pruned", "distance", "flash"}
    assert launches["lm_moe"]["seconds"] > 0 and launches["lm_audio"]["seconds"] > 0


def test_family_counts_join_the_rows():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rows = [dict(name=n, launches=c, launches_per_pass={"p": c}) for n, c in
            (("frontier_scores[wide]", 46), ("frontier_scores[wide,parent_prune]", 258),
             ("pairwise_distance_prune", 0), ("flash_attention_fwd", 468))]
    counts = dict(frontier=0, frontier_pruned=0, frontier_wide=16, frontier_wide_pruned=80,
                  distance=0, flash=72)
    fam = {"lm_moe": dict(counts=counts, per_pass=dict(prefill_forward=24, decode_step_knn=1.0,
                                                       decode_step_knn_pruned=5.0)),
           "lm_hybrid": dict(counts=dict(counts, flash=3),
                             per_pass=dict(prefill_forward=1, decode_step_knn=1.0,
                                           decode_step_knn_pruned=6.0))}
    w, wp, d, f = chip_smoke.with_families(rows, fam)
    assert w["launches_by_path"] == {"lm": 46, "lm_moe": 16, "lm_hybrid": 16}
    assert wp["launches_by_path"] == {"lm": 258, "lm_moe": 80, "lm_hybrid": 80}
    assert f["launches_by_path"] == {"lm": 468, "lm_moe": 72, "lm_hybrid": 3}
    assert d["launches_by_path"] == {"lm": 0, "lm_moe": 0, "lm_hybrid": 0}
    assert f["launches_per_pass"] == {"p": 468, "lm_moe:prefill_forward": 24,
                                      "lm_hybrid:prefill_forward": 1}
    assert wp["launches_per_pass"]["lm_hybrid:decode_step_knn"] == 6.0
    assert d["launches_per_pass"] == {"p": 0} and rows[3]["launches_per_pass"] == {"p": 468}


def test_xlstm_and_audio_counts_join_the_rows():
    """The L3/L4 phases' counts under ``launches_by_path``; the flash row
    gains the audio phase's forward and cross-K/V passes, and xLSTM's
    flash count is 0."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rows = [dict(name=n, launches=c, launches_per_pass={"p": c}) for n, c in
            (("frontier_scores[wide]", 46), ("frontier_scores[wide,parent_prune]", 258),
             ("flash_attention_fwd", 468))]
    counts = dict(frontier=0, frontier_pruned=0, frontier_wide=16, frontier_wide_pruned=80,
                  distance=0, flash=0)
    fam = {"lm_xlstm": dict(counts=counts, per_pass=dict(prefill_forward=0, decode_step_knn=1.0,
                                                         decode_step_knn_pruned=5.0)),
           "lm_audio": dict(counts=dict(counts, flash=52),
                            per_pass=dict(prefill_forward=12, prefill_cache=4,
                                          decode_step_knn=1.0, decode_step_knn_pruned=2.0))}
    w, wp, f = chip_smoke.with_families(rows, fam)
    assert f["launches_by_path"] == {"lm": 468, "lm_xlstm": 0, "lm_audio": 52}
    assert f["launches_per_pass"] == {"p": 468, "lm_xlstm:prefill_forward": 0,
                                      "lm_audio:prefill_forward": 12,
                                      "lm_audio:prefill_cache": 4}
    assert w["launches_by_path"] == {"lm": 46, "lm_xlstm": 16, "lm_audio": 16}
    assert wp["launches_per_pass"]["lm_audio:decode_step_knn"] == 2.0


def test_xlstm_and_audio_phases_pin_their_full_sizes():
    """L3 and L4 run at full width: xlstm-1.3b at all 48 layers, b=4 x
    2,048 and a 64-token decode; whisper-tiny at b=16 with 1,500 frames,
    448 decoder positions and a 64-token decode; phase 8 times whisper's
    three attention shapes at L4's batch."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    fam = chip_smoke.LM_FAMILIES_FULL
    assert fam["xlstm"] == dict(arch="xlstm-1.3b", smoke=False, overrides={},
                                params=3_609_147_728, prefill_b=4, prefill_s=2048,
                                decode_b=4, decode_len=64,
                                serve_argv=["--arch", "xlstm-1.3b", "--knn"])
    assert fam["audio"] == dict(arch="whisper-tiny", smoke=False, overrides={},
                                params=36_620_160, prefill_b=16, frames=1500,
                                prefill_s=448, decode_len=64,
                                serve_argv=["--arch", "whisper-tiny", "--knn"])
    cases = chip_smoke.LM_FULL["flash_cases"]
    assert cases["whisper_encoder"] == (16, 6, 6, 1500, 1500, 64, False, "float32")
    assert cases["whisper_decoder"] == (16, 6, 6, 448, 448, 64, True, "float32")
    assert cases["whisper_cross"] == (16, 6, 6, 448, 1500, 64, False, "float32")
    # the bounds worked out from the shapes: three TF32 products per f32
    # product at 495 TFLOP/s against the bytes of q, k, v and o at 3.35 TB/s
    enc_ms, by = chip_smoke.flash_bound(4 * 16 * 6 * 1500 * 64 * 4,
                                        4.0 * 16 * 6 * 64 * 1500 * 1500, "float32")
    assert by == "operations" and abs(enc_ms - 0.335) < 0.001
    cross_ms, _ = chip_smoke.flash_bound((2 * 448 + 2 * 1500) * 16 * 6 * 64 * 4,
                                         4.0 * 16 * 6 * 64 * 448 * 1500, "float32")
    assert abs(cross_ms - 0.100) < 0.001


TRAIN_TINY = dict(      # full["params"]: filled in from the reference's exact count
    full=dict(arch="qwen2.5-3b", smoke=True, params=None, b=2, s=16, timed_steps=2,
              opt=dict(lr=3e-4, warmup_steps=2, total_steps=100), loss_rtol=1e-4,
              gnorm_rtol=1e-3, attn_tol=2e-4, reduced=[]),
    resume=dict(arch="qwen2.5-3b", steps=6, seq_len=16, global_batch=2, ckpt_every=2,
                fail_at=3, hook_steps=2))


def test_train_path_rehearses_on_the_cpu():
    """``run_train``: T1 on qwen2.5-3b's smoke model (the checks, the
    steps, the profiled step's phases and blocks) and T2's kill/resume
    through ``launch/train.main`` and the hook's device-vs-CPU check."""
    import copy

    from repro.configs.all_archs import smoke_config
    from repro.models.model import exact_param_count
    cfg = copy.deepcopy(TRAIN_TINY)
    cfg["full"]["params"] = exact_param_count(smoke_config("qwen2.5-3b"))
    phases, train, full, resume, launches = _rehearse(
        f"run_train({cfg!r}, 'cpu')", keep=("train_full", "train_resume", "train_path_launches"))
    assert phases == ["train_full", "train_resume", "train_path_launches"]
    assert full["params"] == cfg["full"]["params"] and full["remat"] and full["tied"]
    assert (full["b"], full["s"]) == (2, 16) and len(full["step_ms"]) == 2
    assert len(full["losses"]) == len(full["grad_norms"]) == 4       # warm, 2 timed, profiled
    assert all(g > 0 for g in full["grad_norms"]) and full["tokens_per_s"] > 0
    ch = full["checks"]
    assert ch["grad_norm_bitwise_twice"] and ch["loss_kernel"] == ch["loss_plain"]
    # every layer's attention held element by element, at the step's shape
    mcfg = smoke_config("qwen2.5-3b")
    assert ch["attention_shape"] == [2, mcfg.n_heads, 16, mcfg.d_head]
    assert ch["attention_max_abs_err_by_layer"] == [0.0] * mcfg.n_layers
    assert ch["attention_tol"] == 2e-4
    prof = full["profile"]["phases"]
    assert set(prof) == {"forward", "backward", "optimizer"}
    # the blocks run once in the forward and again in remat's recompute
    assert {k: v["calls"] for k, v in prof["forward"]["blocks"].items()} == {"attn": 2, "mlp": 2}
    assert {k: v["calls"] for k, v in prof["backward"]["blocks"].items()} == {"attn": 2, "mlp": 2}
    assert prof["optimizer"]["blocks"] == {}
    assert resume["bitwise"] and resume["final_loss_resumed"] == resume["final_loss_straight"]
    # 26 parameters (12 a layer, the embedding, the final norm): 14 reference leaves
    assert resume["hook_ef_device_vs_cpu"] == dict(steps=2, leaves=26, bitwise=True)
    assert set(train["counts"]) == {"frontier", "frontier_pruned", "frontier_wide",
                                    "frontier_wide_pruned", "distance", "flash"}
    assert train["per_pass"] == {"train_step": 0.0}          # counted on the card only
    assert launches["seconds"] > 0


def test_train_counts_join_the_rows():
    """The train path's counts under ``launches_by_path.train`` on every
    row; the flash row gains its launches a step."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rows = [dict(name=n, launches=c, launches_per_pass={"p": c}) for n, c in
            (("frontier_scores[wide]", 46), ("pairwise_distance", 3),
             ("flash_attention_fwd", 468))]
    counts = dict(frontier=0, frontier_pruned=0, frontier_wide=0, frontier_wide_pruned=0,
                  distance=0, flash=456)
    w, d, f = chip_smoke.with_families(rows, {"train": dict(counts=counts,
                                                            per_pass=dict(train_step=72.0))})
    assert f["launches_by_path"] == {"lm": 468, "train": 456}
    assert f["launches_per_pass"] == {"p": 468, "train:step": 72.0}
    assert w["launches_by_path"] == {"lm": 46, "train": 0}
    assert d["launches_by_path"] == {"lm": 3, "train": 0}


def test_train_path_pins_its_full_size():
    """T1 runs qwen2.5-3b at full width and depth (its exact parameter
    count) at b=2 x 2048; T2 is the reference's kill/resume contract."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    full, resume = chip_smoke.TRAIN_FULL["full"], chip_smoke.TRAIN_FULL["resume"]
    assert (full["arch"], full["smoke"], full["params"]) == ("qwen2.5-3b", False, 3_085_938_688)
    assert (full["b"], full["s"], full["timed_steps"]) == (2, 2048, 3)
    assert full["attn_tol"] == 2e-4                  # phase 8's f32 tolerance
    assert (resume["steps"], resume["ckpt_every"], resume["fail_at"]) == (24, 8, 13)
    assert (resume["seq_len"], resume["global_batch"]) == (32, 4)


MESH_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
MESH_TINY = dict(train=dict(arch="qwen2.5-3b", smoke=True, b=2, s=16, opt=MESH_OPT),
                 serve_argv=["--knn", "--smoke"] + LM_ARGV,
                 families=dict(
                     hybrid=dict(arch="jamba-v0.1-52b", smoke=True, overrides={"n_layers": 8},
                                 prefill_b=2, prefill_s=16,
                                 serve_argv=["--arch", "jamba-v0.1-52b", "--knn"] + LM_ARGV),
                     xlstm=dict(arch="xlstm-1.3b", smoke=True, overrides={},
                                serve_argv=["--arch", "xlstm-1.3b", "--knn"] + LM_ARGV,
                                train=dict(overrides={"n_layers": 8}, b=2, s=16, steps=3,
                                           opt=MESH_OPT)),
                     audio=dict(arch="whisper-tiny", smoke=True, b=2, frames=24, tokens=16,
                                decode_steps=8, train_steps=3, opt=MESH_OPT)))


def test_mesh_path_rehearses_on_the_cpu():
    """``run_mesh`` over a one-rank gloo group after ``run_train``: M1's
    losses and grad norms bitwise T1's, M2's tokens bitwise the
    single-device ``launch/serve --knn``'s on the same argv and its decode
    step's logits bitwise the one-device decode step's; M3's jamba, xlstm
    and whisper runs bitwise their one-device runs (tokens, logits, losses,
    grad norms)."""
    import copy

    from repro.configs.all_archs import smoke_config
    from repro.models.model import exact_param_count
    tcfg = copy.deepcopy(TRAIN_TINY)
    tcfg["full"]["params"] = exact_param_count(smoke_config("qwen2.5-3b"))
    call = (f"(lambda train: run_mesh({MESH_TINY!r}, 'cpu', train['t1'], "
            f"__import__('repro_torch.launch.serve', fromlist=['x']).main("
            f"{MESH_TINY['serve_argv'] + ['--device', 'cpu']!r})))"
            f"(run_train({tcfg!r}, 'cpu'))")
    phases, mesh, m1, m2, logits, launches, hy, xl, au = _rehearse(
        call, keep=("train_sharded", "serve_sharded", "serve_sharded_logits",
                    "mesh_path_launches", "mesh_hybrid", "mesh_xlstm", "mesh_audio"))
    assert phases[-7:] == ["train_sharded", "serve_sharded", "mesh_hybrid", "mesh_xlstm",
                           "mesh_audio", "serve_sharded_logits", "mesh_path_launches"]
    # M3: every run held bitwise to one device
    assert hy["prefill"]["max_abs_err"] == 0.0 == hy["prefill"]["tolerance"]
    assert (hy["prefill"]["b"], hy["prefill"]["s"], hy["n_layers"]) == (2, 16, 8)
    assert hy["serve"]["tokens_bitwise"] and not hy["trains"]
    assert xl["serve"]["tokens_bitwise"] and xl["n_layers"] == 16
    t = xl["train"]
    assert t["bitwise_one_device"] and t["n_layers"] == 8 and len(t["losses"]) == 3
    assert au["forward"]["max_abs_err"] == 0.0 and au["decode"]["max_abs_err"] == 0.0
    assert au["decode"]["tokens_bitwise"] and au["decode"]["steps"] == 8
    assert au["train"]["bitwise_one_device"] and len(au["train"]["grad_norms"]) == 3
    assert set(launches["m3_seconds"]) == {"mesh_hybrid", "mesh_xlstm", "mesh_audio"}
    assert m1["bitwise_t1"] and m1["steps"] == 4 and len(m1["losses"]) == 4
    assert m1["mesh"] == {"data": 1, "model": 1} and m1["backend"] == "gloo"
    assert set(m1["profile"]["phases"]) == {"forward", "backward", "optimizer"}
    assert m2["tokens_bitwise_lm_serve"] and (m2["batch"], m2["steps"]) == (2, 3)
    # the sharded decode's logits, every step, bitwise the one-device ones
    assert logits["max_abs_err"] == 0.0 == logits["tolerance"]
    assert logits["positions"] == m2["prompt_len"] + m2["steps"]
    assert logits["distinct_tokens_fed"] > 1
    assert set(mesh["counts"]) == {"frontier", "frontier_pruned", "frontier_wide",
                                   "frontier_wide_pruned", "distance", "flash"}
    assert set(mesh["per_pass"]) == {
        "train_step", "decode_step_knn", "decode_step_knn_pruned", "hybrid_prefill",
        "hybrid_decode_step_knn", "hybrid_decode_step_knn_pruned", "xlstm_decode_step_knn",
        "xlstm_decode_step_knn_pruned", "xlstm_train_step", "audio_forward",
        "audio_prefill_cache", "audio_train_step"}
    assert launches["seconds"] > 0


def test_mesh_counts_join_the_rows():
    """The mesh path's counts under ``launches_by_path.mesh`` on every row;
    the flash row gains its launches a train step, the wide rows theirs a
    decode step."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rows = [dict(name=n, launches=c, launches_per_pass={"p": c}) for n, c in
            (("frontier_scores[wide]", 46), ("frontier_scores[wide,parent_prune]", 30),
             ("pairwise_distance", 3), ("flash_attention_fwd", 468))]
    counts = dict(frontier=0, frontier_pruned=0, frontier_wide=32, frontier_wide_pruned=96,
                  distance=0, flash=360)
    w, wp, d, f = chip_smoke.with_families(rows, {"mesh": dict(
        counts=counts, per_pass=dict(train_step=72.0, decode_step_knn=2.0,
                                     decode_step_knn_pruned=6.0))})
    assert f["launches_by_path"] == {"lm": 468, "mesh": 360}
    assert f["launches_per_pass"] == {"p": 468, "mesh:step": 72.0}
    assert w["launches_by_path"] == {"lm": 46, "mesh": 32}
    assert w["launches_per_pass"] == {"p": 46, "mesh:decode_step_knn": 2.0}
    assert wp["launches_by_path"] == {"lm": 30, "mesh": 96}
    assert wp["launches_per_pass"] == {"p": 30, "mesh:decode_step_knn": 6.0}
    assert d["launches_by_path"] == {"lm": 3, "mesh": 0}


def test_mesh_path_pins_its_size():
    """M1 is T1's model and optimizer at T1's batch; M2 lm_serve's argv."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    m, t = chip_smoke.MESH_FULL["train"], chip_smoke.TRAIN_FULL["full"]
    assert (m["arch"], m["smoke"], m["b"], m["s"], m["opt"]) == (
        t["arch"], t["smoke"], t["b"], t["s"], t["opt"])
    assert chip_smoke.MESH_FULL["serve_argv"] == chip_smoke.LM_FULL["serve_argv"] == ["--knn"]
    fam, lm = chip_smoke.MESH_FULL["families"], chip_smoke.LM_FAMILIES_FULL
    # M3: jamba's full-width period as the family phase serves it, at the
    # family phase's prefill; xlstm-1.3b at full depth served, one 8-layer
    # period trained at b=2 x 2048; whisper-tiny at full size
    h = fam["hybrid"]
    assert (h["arch"], h["smoke"], h["overrides"]) == ("jamba-v0.1-52b", False, {"n_layers": 8})
    assert (h["prefill_b"], h["prefill_s"]) == (4, 2048)
    assert h["serve_argv"] == lm["hybrid"]["serve_argv"]
    x = fam["xlstm"]
    assert (x["arch"], x["smoke"], x["overrides"]) == ("xlstm-1.3b", False, {})
    assert x["serve_argv"] == lm["xlstm"]["serve_argv"]
    assert (x["train"]["overrides"], x["train"]["b"], x["train"]["s"], x["train"]["steps"]) \
        == ({"n_layers": 8}, 2, 2048, 3)
    a = fam["audio"]
    assert (a["arch"], a["smoke"], a["b"], a["frames"], a["tokens"], a["decode_steps"]) == (
        "whisper-tiny", False, 16, 1500, 448, 64)


DRYRUN_TINY = dict(
    cells=[["qwen2.5-3b", "decode_32k"]], skips=["yi-34b"],
    t1=dict(arch="qwen2.5-3b", smoke=True, b=2, s=16, params=None,
            cfg_extra=dict(param_dtype="float32", compute_dtype="float32", head_pad=0,
                           vocab_pad_to=1)),
    forest_argv=["--n", "4000", "--dim", "8", "--batch", "16"],
    examples=dict(knnlm_argv=["--steps", "1", "--store-batches", "1"], train_steps=4))


def test_dryrun_and_examples_rehearse_on_the_cpu():
    """``run_dryrun`` at its smallest size: the dry-run worker's cells (one
    full-size cell on the 16 x 16 mesh, a long_500k skip, T1's cell on the
    smoke model) in their own process, the forest dry run in another, the
    four examples, then T1's cell held against one real step of the same
    program on the CPU (equal counts)."""
    call = (f"(__import__('torch').set_num_threads(1), "
            f"run_dryrun({DRYRUN_TINY!r}, 'cpu', 100.0))[1]")
    phases, (dry, ex), forest, examples, cells, card, launches = _rehearse(
        call, keep=("forest_dryrun", "examples", "dryrun", "dryrun_vs_card",
                    "dryrun_path_launches"))
    assert phases[-4:] == ["examples", "dryrun", "dryrun_vs_card", "dryrun_path_launches"]
    assert phases[0] == "forest_dryrun" and forest["bitwise_vs_plain"]
    assert len(forest["heights"]) == 16 and forest["launches"]["per_step"] == 0
    assert set(examples["seconds"]) == {"quickstart", "distributed_index", "knnlm_serve",
                                        "train_lm"}
    assert examples["train_lm"]["bitwise"] and examples["knnlm_serve"]["evicted"] == 252
    c = cells["cells"]["qwen2.5-3b/decode_32k"]
    assert c["bottleneck"] in ("compute", "memory", "collective") and c["of_gb"] == 80
    assert cells["skipped"] == 1 and "sub-quadratic" in cells["skip_reason"]
    assert all(card["counts_equal"].values()) and card["flops"] > 0
    assert card["kernels"]["flash_attention_fwd"]["calls"] == 4
    assert card["t1_share_of_model_flops"] > 0
    assert set(dry["counts"]) == set(ex["counts"]) == {
        "frontier", "frontier_pruned", "frontier_wide", "frontier_wide_pruned", "distance",
        "flash"}
    assert dry["per_pass"]["train_step"] == 4 and launches["seconds"] > 0


def test_dryrun_and_examples_counts_join_the_rows():
    """The dry-run path's and the examples' counts under their own
    ``launches_by_path`` keys; the flash row gains the dry run's launches a
    train step."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rows = [dict(name=n, launches=c, launches_per_pass={"p": c}) for n, c in
            (("frontier_scores", 17), ("pairwise_distance", 3), ("flash_attention_fwd", 468))]
    zero = dict(frontier=0, frontier_pruned=0, frontier_wide=0, frontier_wide_pruned=0)
    n, d, f = chip_smoke.with_families(rows, {
        "dryrun": dict(counts=dict(zero, frontier=40, distance=0, flash=72),
                       per_pass=dict(train_step=72, forest_step=4.0)),
        "examples": dict(counts=dict(zero, frontier=9, distance=2, flash=130), per_pass={})})
    assert n["launches_by_path"] == {"lm": 17, "dryrun": 40, "examples": 9}
    assert d["launches_by_path"] == {"lm": 3, "dryrun": 0, "examples": 2}
    assert f["launches_by_path"] == {"lm": 468, "dryrun": 72, "examples": 130}
    assert f["launches_per_pass"] == {"p": 468, "dryrun:step": 72}


def test_dryrun_path_pins_its_size():
    """T1's cell is T1's model, dtype and batch; one cell per family; the
    eight full-attention archs' long_500k skips; the forest's reference
    cell."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config, list_archs
    cfg, t = chip_smoke.DRYRUN_FULL, chip_smoke.TRAIN_FULL["full"]
    t1 = cfg["t1"]
    assert (t1["arch"], t1["smoke"], t1["b"], t1["s"], t1["params"]) == (
        t["arch"], t["smoke"], t["b"], t["s"], t["params"])
    assert t1["cfg_extra"]["param_dtype"] == t1["cfg_extra"]["compute_dtype"] == "float32"
    fams = {get_config(a).family for a, _ in cfg["cells"]}
    assert fams == {get_config(a).family for a in list_archs()}
    assert sorted(cfg["skips"]) == sorted(a for a in list_archs()
                                          if not get_config(a).subquadratic)
    assert cfg["forest_argv"] == []
