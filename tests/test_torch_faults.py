"""The port's fault injector (``repro_torch.stream.faults``) against the
reference's: the same plan and the same call sequence give the same
outputs and the same ``counts`` in both packages, on several seeds."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.stream import faults as JF  # noqa: E402
from repro_torch.stream import faults as TF  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

PLANS = {
    "frames": dict(drop_p=0.2, dup_p=0.15, reorder_p=0.25, torn_p=0.3),
    "heavy": dict(drop_p=0.5, dup_p=0.5, reorder_p=0.5, torn_p=0.9,
                  heartbeat_drop_p=0.5),
    "liveness": dict(heartbeat_drop_p=0.3, delay_p=0.2, delay_max_s=1e-4),
}


def _drive(mod, plan: dict, seed: int):
    """A mixed call sequence: message lists of varying length through
    ``filter``, bodies through ``torn``, heartbeats and delays."""
    inj = mod.FaultInjector(mod.FaultPlan(seed=seed, **plan))
    rng = np.random.default_rng(seed)
    out = []
    for r in range(40):
        msgs = [(r, i) for i in range(int(rng.integers(0, 9)))]
        out.append(("filter", inj.filter(msgs)))
        body = bytes(range(int(rng.integers(0, 50))))
        out.append(("torn", inj.torn(body)))
        out.append(("hb", inj.drop_heartbeat()))
        inj.maybe_delay()
    return out, dict(inj.counts)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("seed", [0, 1, 6, 101, 202])
def test_same_schedule_as_the_reference(plan, seed):
    got, got_counts = _drive(TF, PLANS[plan], seed)
    want, want_counts = _drive(JF, PLANS[plan], seed)
    assert got == want
    assert got_counts == want_counts
    assert sum(got_counts.values()) > 0


def test_no_faults_is_a_no_op():
    msgs = [("a", 1), ("b", 2), ("c", 3)]
    assert TF.NO_FAULTS.filter(list(msgs)) == msgs
    assert TF.NO_FAULTS.torn(b"abc") == b"abc"
    assert not TF.NO_FAULTS.drop_heartbeat()
    assert sum(TF.NO_FAULTS.counts.values()) == 0
