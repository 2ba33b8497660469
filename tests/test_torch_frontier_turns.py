"""``tools/frontier_turns.py`` on the CPU: the node sort puts every output
back where the launch had it, and builds are timed in turns."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.frontier import frontier_scores_torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    sys.path.insert(0, str(ROOT))          # the tool imports chip_smoke
    spec = importlib.util.spec_from_file_location("frontier_turns",
                                                  ROOT / "tools" / "frontier_turns.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("metric", ["d_inf", "l2", "l1"])
def test_by_node_restores_the_launch_order(metric, prune):
    rng = np.random.default_rng(14)
    b, F, N, cap, dim = 5, 6, 4, 8, 33
    fids = rng.integers(-1, N, (b, F)).astype(np.int32)   # repeats among -1 slots
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (t(fids), t(rng.normal(size=(b, dim)).astype(np.float32)),
            t(rng.normal(size=(N, cap, dim)).astype(np.float32)),
            t(rng.uniform(0, 1, (N, cap)).astype(np.float32)),
            t(rng.uniform(size=(N, cap)) < 0.5), t(rng.uniform(size=(N, cap)) < 0.4))
    filt = dict(pdist=t(rng.uniform(0, 8, (N, cap)).astype(np.float32)),
                qpd=t(rng.uniform(0, 8, (b, F)).astype(np.float32)),
                rq=t(rng.uniform(0, 2, b).astype(np.float32))) if prune else {}
    kw = dict(metric=metric, **filt)
    got, kernel = _tool().by_node(frontier_scores_torch, *args, **kw)
    want = frontier_scores_torch(*args, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernel()[0].shape == (b * F, 1, cap)    # the sorted [b*F, 1] frontier


def test_builds_are_timed_in_turns():
    tool = _tool()
    turns = tool.Turns({"old": None, "seg": None, "new": None}, [])
    assert turns.order == ["old", "seg", "new", "new", "seg", "old"]


def test_narrow_rows_cover_both_filters_and_the_root(capsys):
    """The narrow rows at a tiny cut of chip_smoke's synthetic geometry:
    every metric with the filter off and on, then level 0's shape (every
    pair on one node), each handed to the turns with its own label."""
    tool = _tool()
    seen = []

    def turns(args, kw, what):
        seen.append(what)
        return {"device_ms_new": 0.0}, frontier_scores_torch(*args, **kw)

    cfg = dict(kernel_N=40, capacity=8, dims=5, kernel_b=6, kernel_F=4)
    tool.narrow(turns, cfg, "cpu")
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["geo"], r["metric"], r["prune"]) for r in rows] == [
        ("synthetic", m, p) for m in ("d_inf", "l2", "l1") for p in (False, True)] + [
        ("root", m, False) for m in ("d_inf", "l2", "l1")]
    assert len(seen) == len(set(seen)) == 9
    assert all(r["pairs"] == (24 if r["geo"] == "synthetic" else 6) for r in rows)
    assert all(r["bound_ms"] > 0 and r["live_evals"] > 0 and "device_ms_new" in r
               for r in rows)
