"""``tools/distance_turns.py`` on the CPU: the SASS loop reader, the checks
every build passes before it is timed, and the rows at a tiny cut of the
tool's shapes, with the plain version standing in for each build."""
import importlib.util
import itertools
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.distance import (pairwise_distance_prune_torch,  # noqa: E402
                                          pairwise_distance_torch)

ROOT = Path(__file__).resolve().parents[1]

SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_111dist_kernelILi0ELb0EEEvPKfS2_S2_S2_PfPhiii
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;         /* 0x00000a00ff017b82 */
                                                                  /* 0x000e220000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;             /* 0x00000000001a7919 */
        /*0020*/                   LDS.128 R4, [R2] ;             /* 0x00000000001a7919 */
        /*0030*/                   LDS.128 R8, [R3+0x400] ;       /* 0x00000000001a7919 */
        /*0040*/                   FADD R12, R4, -R8 ;            /* 0x00000000001a7919 */
        /*0050*/                   FMNMX R20, |R12|, R20, !PT ;   /* 0x00000000001a7919 */
        /*0060*/                   FADD R13, R5, -R9 ;            /* 0x00000000001a7919 */
        /*0070*/                   FMNMX R21, |R13|, R21, !PT ;   /* 0x00000000001a7919 */
        /*0080*/              @!P0 BRA 0x30 ;                     /* 0xfffffff8006c8947 */
        /*0090*/                   STG.E.128 desc[UR4][R14.64], R20 ;
        /*00a0*/               @P1 BRA 0x20 ;                     /* 0xfffffff8006c8947 */
        /*00b0*/               @P2 BRA 0xd0 ;                     /* 0x0000000000fc8947 */
        /*00c0*/                   FADD R1, R1, R1 ;
        /*00d0*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_111dist_kernelILi2ELb1EEEvPKfS2_S2_S2_PfPhiii
        /*0000*/                   EXIT ;
"""


def _tool():
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]   # the tool imports chip_smoke
    spec = importlib.util.spec_from_file_location("distance_turns",
                                                  ROOT / "tools" / "distance_turns.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sass_reader_takes_the_innermost_arithmetic_loop():
    loops = _tool().parse_sass(SASS)
    (name, loop), = loops.items()                # the second function has no loop
    assert "dist_kernelILi0ELb0EE" in name
    assert loop == dict(instructions=6, fp=4,
                        opcodes={"FADD": 2, "FMNMX": 2, "LDS": 1, "BRA": 1})


def _plain(q, e, metric, rq, re_):
    if rq is None:
        return pairwise_distance_torch(q, e, metric), None
    return pairwise_distance_prune_torch(q, e, rq, re_, metric)


@pytest.mark.parametrize("metric", ["d_inf", "sqeuclidean", "ip"])
def test_checks_pass_the_plain_version_and_catch_a_miss(metric):
    tool = _tool()
    q, e = tool.inputs(5, 9, 3, "cpu")
    want = pairwise_distance_torch(q, e, metric)
    assert tool.check_against_plain(_plain(q, e, metric, None, None), want, metric, "x") == 0
    off = want.clone()
    off[2, 3] += 1e-3
    with pytest.raises(RuntimeError, match="x"):
        tool.check_against_plain((off, None), want, metric, "x")
    rq, re_ = tool.radii(5, 9, 3, metric, "cpu")
    pw = pairwise_distance_prune_torch(q, e, rq, re_, metric)
    assert tool.check_against_plain(_plain(q, e, metric, rq, re_), pw, metric, "p", rq, re_) == 0
    flipped = pw[1].clone()
    flipped[0, 0] = ~flipped[0, 0]
    decided = bool((_true(pw[0], metric)[0, 0] - (rq[0] + re_[0])).abs() > 1e-6)
    if decided:
        with pytest.raises(RuntimeError, match="masks"):
            tool.check_against_plain((pw[0], flipped), pw, metric, "p", rq, re_)


def _true(d, metric):
    return d.clamp_min(0).double().sqrt() if metric == "sqeuclidean" else d.double()


def test_rows_at_a_tiny_cut_of_the_shapes(monkeypatch, capsys):
    """Every shape and metric, the prune form where the tool takes it,
    each build checked, its turns and the library call recorded; then the
    brute-force scan with each build in turns."""
    tool = _tool()
    import chip_smoke
    monkeypatch.setattr(tool, "SHAPES", {"synthetic": (6, 40, 5), "path": (3, 70, 5)})
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, iters=20: float(fn() is not None))
    seen = []

    def build(name):
        def f(q, e, metric, rq, re_):
            seen.append((name, q.shape[0], metric, rq is not None))
            return _plain(q, e, metric, rq, re_)
        return f
    fns = {"old": build("old"), "new": build("new")}
    order = ["old", "new", "new", "old"]
    tool.scan_rows(fns, order, torch.device("cpu"))
    from repro_torch.kernels import distance
    launch = distance._launch
    tool.scan_wall(fns, order, torch.device("cpu"), reps=1)
    assert distance._launch is launch               # put back after the scan
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    scans = [r for r in rows if r["phase"] == "distance"]
    assert [(r["shape"], r["metric"], r["prune"]) for r in scans] == (
        [("synthetic", m, False) for m in tool.METRICS]
        + [("synthetic", m, True) for m in tool.METRICS]
        + [("path", m, False) for m in tool.METRICS])
    for r in scans:
        assert len(r["device_ms_turns"]) == len(order) == len(r["ms_turns"])
        assert set(r["max_abs_err"]) == {"old", "new"} and r["bound_ms"] > 0
        assert (r["library_device_ms"] is None) == r["prune"]
    wall, = [r for r in rows if r["phase"] == "brute_force_knn"]
    assert (wall["nq"], wall["ne"], wall["k"]) == (3, 70, 11)
    assert len(wall["ms_old"]) == len(wall["ms_new"]) == 2
    # each scan row held every build against the plain version once (old,
    # new), then timed them in turns, host ms and then device ms (old, new,
    # new, old twice; a build's repeated calls run together)
    runs = [k for k, _ in itertools.groupby(s[0] for s in seen if s[1:] == (3, "ip", False))]
    assert runs == ["old", "new", "old", "new", "old", "new", "old"]
    assert seen[-1][0] == "new"          # the scan's kernel time: the current build



def test_sustained_rows_cover_every_metric(monkeypatch, capsys):
    """Phase 4 on the CPU: every metric, a count of calls, no device
    numbers (nvidia-smi is sampled on the card only)."""
    tool = _tool()
    monkeypatch.setattr(tool, "SHAPES", {"path": (3, 70, 5)})
    monkeypatch.setattr(tool.sustained, "__defaults__", (0.05,))
    tool.sustain_rows(lambda q, e, m, rq, re_: _plain(q, e, m, rq, re_), torch.device("cpu"))
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in rows] == list(tool.METRICS)
    assert all(r["calls"] >= 10 and r["device_ms"] is None and "sm_clock_mhz" not in r
               for r in rows)
