"""Each cell's driver end to end on the CPU at a tiny size (the port's
plain kernels), and the same runs with the timed path broken underneath:
each fault that a cell can have must turn ``correct`` false.  The
card-only tests run the control (the plain reference in the next lower
precision, in the program's place) at a size a test run holds and see it
fail one of the cell's numbers."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.conftest import SMALL, TINY

CELLS = sorted(TINY)


def _run(workload, *, trace=False, device="cpu", sizes=TINY, control=False, seconds=1.5):
    out = []
    line, checks = harness.run_cell(workload, 2**31 + 101, seconds, trace, device=device,
                                    overrides=sizes[workload], control=control, outcome=out)
    return line, out[0]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end_and_is_correct(workload, trace):
    line, out = _run(workload, trace=trace)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    spec = harness.load_spec()
    if trace:
        names = {m["name"] for m in spec["per_layer"] if workload in m["workloads"]}
        # off the card no device metric is read
        assert set(line["metrics"]) <= names
        assert not any("roofline" in n or "idle" in n for n in line["metrics"])
    else:
        names = {m["name"] for m in spec["end_to_end"]
                 if workload in m.get("workloads", [workload])}
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0


def _fault_answer_altered(monkeypatch):
    import repro_torch.serve.frontend as fe

    orig = fe.pinned_knn

    def bad(pinned, q, **kw):
        d, i = orig(pinned, q, **kw)
        i = i.clone()
        i[:, 0] = i[:, -1]               # the nearest answer replaced by the k-th
        return d, i
    monkeypatch.setattr(fe, "pinned_knn", bad)


def _fault_state_unchanged(monkeypatch):
    from repro_torch.core.smtree import ST_APPLIED
    from repro_torch.stream import batcher

    def unchanged(self, ops, xs, oids):
        return batcher.BatchResult(np.full(len(ops), ST_APPLIED, np.int32), len(ops), 0, 1)
    monkeypatch.setattr(batcher.MutationBatcher, "apply", unchanged)


def _fault_insert_altered(monkeypatch):
    from repro_torch.core import smtree

    orig = smtree.apply_mutations

    def bad(tree, ops, xs, oids, **kw):
        xs = np.array(xs, np.float32)
        xs[np.asarray(ops) == smtree.OP_INSERT] += 1e-3
        return orig(tree, ops, xs, oids, **kw)
    monkeypatch.setattr(smtree, "apply_mutations", bad)


def _fault_cache_unchanged(monkeypatch):
    from repro_torch.models import model

    orig = model.decode_step

    def bad(params, cfg, token, cache, pos, **kw):
        logits, _ = orig(params, cfg, token, cache, pos, **kw)
        return logits, cache
    monkeypatch.setattr(model, "decode_step", bad)


def _fault_token_altered(monkeypatch):
    from repro_torch.serve import knnlm

    orig = knnlm.mix_logits

    def bad(lm, knn, lam):
        out = orig(lm, knn, lam)
        out[:, 0] += 100.0               # every mixed step serves token 0
        return out
    monkeypatch.setattr(knnlm, "mix_logits", bad)


def _fault_first_token_altered(monkeypatch):
    from repro_torch.serve import serve_step

    orig = serve_step.make_decode_step

    def make(cfg, *a, **kw):
        fn = orig(cfg, *a, **kw)

        def bad(params, token, cache, pos):
            tok, logits, cache = fn(params, token, cache, pos)
            return (tok + 1) % logits.shape[-1], logits, cache   # not the argmax
        return bad
    monkeypatch.setattr(serve_step, "make_decode_step", make)


FAULTS = [("idx1m-dinf.knn-exact", _fault_answer_altered),
          ("idx1m-dinf.churn", _fault_state_unchanged),
          ("idx1m-dinf.churn", _fault_insert_altered),
          ("sc2-knnlm.decode-b256", _fault_cache_unchanged),
          ("sc2-knnlm.decode-b256", _fault_token_altered),
          ("sc2-knnlm.decode-b256", _fault_first_token_altered)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f.__name__ for _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    line, _ = _run(workload)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["idx1m-dinf.knn-exact", "idx1m-dinf.churn"])
def test_the_control_fails_on_the_cpu(workload):
    """bfloat16 has no hardware behind it here, but its rounding is the
    same: the index cells' control already fails on the CPU."""
    line, out = _run(workload, control=True)
    assert line["correct"]
    limits = {c.name: c.limit for c in out.checks}
    assert any(v > limits[n] for n, v in out.sources["control"].items())


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_on_the_card(workload, card):
    line, out = _run(workload, device=card, sizes=SMALL, control=True, seconds=3.0)
    assert line["correct"], line["checks"]
    limits = {c.name: c.limit for c in out.checks}
    ctl = {n: v for n, v in out.sources["control"].items() if n in limits}
    assert any(v > limits[n] for n, v in ctl.items()), (ctl, limits)
    torch.cuda.empty_cache()
