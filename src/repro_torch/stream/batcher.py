"""The host plane of a mutation cohort: the rows that the device passes
could not absorb, resolved by the engine's host-side split and merge code.

Port of ``repro/stream/batcher.py:escalate_rows``.  It is the reference's
definition of the host plane, and the device split and merge passes
(core/smtree.py) are held bitwise against it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.smtree import (OP_INSERT, ST_APPLIED, ST_NOTFOUND,
                                     ST_OVERFLOW, ST_UNDERFLOW, TreeArrays)

__all__ = ["escalate_rows"]


def escalate_rows(tree: TreeArrays, statuses: np.ndarray, ops, xs,
                  oids) -> TreeArrays:
    """Resolve a cohort's ST_OVERFLOW and ST_UNDERFLOW rows on the host.

    One ``_HostView`` copy of the tree for the batch: the overflow rows
    first, then the underflow rows, each in log order (the device split
    pass resolves a log-order prefix of the overflow rows, so this order
    keeps the split order the same with the passes on or off; within a
    conflict-free cohort the two groups touch disjoint objects), then one
    ``to_tree``.  ``ops``/``xs``/``oids`` are the cohort's [B] rows on the
    host.  Mutates ``statuses`` in place (ST_APPLIED, or ST_NOTFOUND for a
    delete whose target is gone) and returns the new tree, or ``tree``
    itself when no row escalates."""
    rows = [i for i, s in enumerate(statuses) if s == ST_OVERFLOW]
    rows += [i for i, s in enumerate(statuses) if s == ST_UNDERFLOW]
    if not rows:
        return tree
    from repro_torch.core.engine import _HostView
    hv = _HostView(tree)
    for i in rows:
        if ops[i] == OP_INSERT:
            hv.insert_with_split(np.asarray(xs[i], np.float32), int(oids[i]))
            statuses[i] = ST_APPLIED
        else:
            ok = hv.delete_with_merge(np.asarray(xs[i], np.float32),
                                      int(oids[i]))
            statuses[i] = ST_APPLIED if ok else ST_NOTFOUND
    return hv.to_tree()
