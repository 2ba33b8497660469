"""Carry a tree or a stacked forest across backends as numpy arrays.

``tree_from_numpy`` (defined beside ``TreeArrays`` in core/smtree.py, which
builds every tree through it) makes the port's tree from the 16 array
fields and 5 meta fields of any SM-tree — the JAX package's included, read
out as numpy — and ``tree_to_numpy`` goes back.  ``forest_from_numpy`` and
``forest_to_numpy`` do the same for a stacked forest (core/distributed.py:
every field with a leading shard axis), such as the JAX package's
``stack_trees`` or ``build_forest`` output.  The tests use them to feed one
JAX-built tree or forest to both engines and to compare them field by
field.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.smtree import (ARRAY_FIELDS, META_FIELDS,
                                     NODE_TABLE_FIELDS, TreeArrays,
                                     tree_from_numpy)

__all__ = ["tree_from_numpy", "tree_to_numpy", "forest_from_numpy"]


def tree_to_numpy(tree: TreeArrays) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, meta) of ``tree`` (or of a stacked forest) on the host."""
    arrays = {f: getattr(tree, f).cpu().numpy() for f in ARRAY_FIELDS}
    meta = {f: getattr(tree, f) for f in META_FIELDS}
    return arrays, meta


def forest_from_numpy(arrays: dict, meta: dict, device) -> TreeArrays:
    """The port's stacked forest on ``device`` from a stacked forest's 16
    array fields (each with a leading ``[n_shards]`` axis) and 5 meta
    fields; a field whose shape does not fit raises ``ValueError``."""
    n_shards = np.shape(arrays["root"])
    if len(n_shards) != 1:
        raise ValueError(f"root of a stacked forest is [n_shards]; got {n_shards}")
    for f in ARRAY_FIELDS:
        shape = np.shape(arrays[f])
        lead = n_shards + ((meta["max_nodes"],) if f in NODE_TABLE_FIELDS else ())
        if shape[:len(lead)] != lead:
            raise ValueError(f"{f}: shape {shape} does not start with {lead}")
    return tree_from_numpy(arrays, meta, device)

