"""The narrow frontier kernel's l1/l2 fold, replayed in PyTorch on the CPU.

``csrc/frontier.cu`` ("narrow rows" in its header) scores one entry a lane
and sums its ``dim`` terms in registers, in ``_sum_last``'s association:

  * ``_sum_last`` over dim terms is a tree of L = floor(log2 dim) levels
    whose leaves are the elements base + sum of (dim >> (j + 1)) over the
    set bits j of the leaf's number (base 0), then, innermost first, one
    tree of 2^lev leaves for every level lev < L whose length dim >> lev is
    odd (base (dim >> lev) - 1), each added to the running sum;
  * ``fold_leaf`` lists those leaves in that order, once a block, as
    offsets down a lane's term column (``leaf_off``);
  * a lane writes its terms down its own column of a term buffer, then
    sums each tree as its two halves added (``LeafTree<M>``, unrolled at
    compile time; ``fold_terms<L>``, one case of a switch for each L): each
    add is one of ``_sum_last``'s adds, only done earlier.

``narrow_fold`` below is that order, step by step, and the tests hold it
bitwise against the port's ``_sum_last`` and the JAX package's at every
dim the narrow kernel takes (1..128).  ``test_model_reads_the_kernel_source``
finds, in frontier.cu, the kernel lines the model copies, so that a change
there fails here until the model follows; the GPU tests
(``tests/test_torch_kernels_gpu.py``) hold the kernel itself bitwise
against the plain version on the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.metric import _sum_last as ref_sum_last  # noqa: E402
from repro_torch.core.metric import _sum_last  # noqa: E402

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
      / "csrc" / "frontier.cu")
SOURCE = CU.read_text()
NARROW_MAX_DIM = int(re.search(r"constexpr int kNarrowMaxDim = (\d+);", SOURCE).group(1))
# metric_narrow's switch on L = floor(log2 dim): its last case the deepest tree
FOLD_LEVELS = int(re.search(r"default: s = fold_terms<(\d+)>\(col, leaf_off, dim\);",
                            SOURCE).group(1))
KERNEL_LINES = [
    "const int L = 31 - __clz(dim);",
    "if (x >= (1 << L)) {",
    "x -= 1 << L;",
    "for (lev = L - 1; lev >= 0; --lev) {",
    "if (!((dim >> lev) & 1)) continue;",
    "if (x < (1 << lev)) break;",
    "x -= 1 << lev;",
    "base = (dim >> lev) - 1;",
    "for (int j = 0; j < lev; ++j)",
    "if ((x >> j) & 1) idx += dim >> (j + 1);",
    "leaf_off[x] = fold_leaf(x, dim) * kTermPitch;",
    "return __fadd_rn(LeafTree<M - 1>::sum(col, leaf_off, x),",
    "LeafTree<M - 1>::sum(col, leaf_off, x + (1 << (M - 1))));",
    "return col[leaf_off[x]];",
    "if ((dim >> LEV) & 1) {",
    "s = __fadd_rn(s, LeafTree<LEV>::sum(col, leaf_off, x));",
    "x += 1 << LEV;",
    "return add_tail_trees<LEV - 1>(col, leaf_off, dim, x, s);",
    "return add_tail_trees<L - 1>(col, leaf_off, dim, 1 << L, LeafTree<L>::sum(col, leaf_off, 0));",
    "switch (31 - __clz(dim)) {",
]


def fold_leaf(x: int, dim: int) -> int:
    """fold_leaf in csrc/frontier.cu: the element that is leaf x."""
    L = dim.bit_length() - 1
    lev, base = L, 0
    if x >= 1 << L:
        x -= 1 << L
        for lev in range(L - 1, -1, -1):
            if not (dim >> lev) & 1:
                continue
            if x < 1 << lev:
                break
            x -= 1 << lev
        base = (dim >> lev) - 1
    return base + sum(dim >> (j + 1) for j in range(lev) if (x >> j) & 1)


def _tree(leaves):
    """LeafTree<M>::sum over 2^M leaves [rows] in order: its two halves,
    each a tree, added."""
    if len(leaves) == 1:
        return leaves[0]
    h = len(leaves) // 2
    return _tree(leaves[:h]) + _tree(leaves[h:])


def narrow_fold(x):
    """metric_narrow's l1/l2 sum of the terms x [rows, dim] (f32)."""
    dim = x.shape[1]
    L = dim.bit_length() - 1
    cols = [x[:, fold_leaf(i, dim)] for i in range(dim)]
    s = _tree(cols[:1 << L])
    at = 1 << L
    for lev in range(L - 1, -1, -1):      # the tails, innermost first
        if (dim >> lev) & 1:
            s = s + _tree(cols[at:at + (1 << lev)])
            at += 1 << lev
    assert at == dim
    return s


def _terms(metric: str, dim: int, rows: int = 8):
    rng = np.random.default_rng(dim * 10 + (metric == "l2"))
    q = rng.random((rows, dim), np.float32)
    e = (rng.random((rows, dim), np.float32) * rng.uniform(0.1, 10.0, (rows, 1))
         ).astype(np.float32)
    d = q - e
    return d * d if metric == "l2" else np.abs(d)


@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("dim", range(1, 129))
def test_narrow_fold_order_is_sum_last(metric, dim):
    terms = _terms(metric, dim)
    x = torch.from_numpy(terms)
    want = _sum_last(x)
    assert torch.equal(torch.from_numpy(np.asarray(ref_sum_last(terms))), want)
    assert torch.equal(narrow_fold(x), want)


def test_leaves_are_each_element_once_within_the_stack():
    """Every dim the narrow kernel takes lists each element once, and its
    deepest tree has a case in the kernel's switch."""
    assert NARROW_MAX_DIM == 128
    for dim in range(1, NARROW_MAX_DIM + 1):
        assert sorted(fold_leaf(x, dim) for x in range(dim)) == list(range(dim))
        assert dim.bit_length() - 1 <= FOLD_LEVELS
    assert [fold_leaf(x, 7) for x in range(7)] == [0, 3, 1, 4, 2, 5, 6]


def test_model_reads_the_kernel_source():
    flat = " ".join(SOURCE.split())
    missing = [line for line in KERNEL_LINES if " ".join(line.split()) not in flat]
    assert not missing, f"frontier.cu changed; update this model: {missing}"
