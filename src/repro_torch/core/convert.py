"""Carry a tree across backends as numpy arrays.

``tree_from_numpy`` (defined beside ``TreeArrays`` in core/smtree.py, which
builds every tree through it) makes the port's tree from the 16 array
fields and 5 meta fields of any SM-tree — the JAX package's included, read
out as numpy — and ``tree_to_numpy`` goes back.  The tests use the pair to
feed one JAX-built tree to both engines and to compare trees field by
field.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.smtree import (ARRAY_FIELDS, META_FIELDS, TreeArrays,
                                     tree_from_numpy)

__all__ = ["tree_from_numpy", "tree_to_numpy"]


def tree_to_numpy(tree: TreeArrays) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, meta) of ``tree`` on the host."""
    arrays = {f: getattr(tree, f).cpu().numpy() for f in ARRAY_FIELDS}
    meta = {f: getattr(tree, f) for f in META_FIELDS}
    return arrays, meta
