"""The wide frontier kernel's l1/l2 fold, replayed in PyTorch on the CPU.

``csrc/frontier.cu`` (its header, "The fold in registers" and "The end of
the fold") sums a row's terms without shared memory where it can:

  * lane l owns the elements t with t mod P in [V*l, V*l + V), P = 32*V
    (V = 4 with 16-byte loads, else 1: ``_vec``); t = P*j + V*l + c is
    slot j, component c of lane l;
  * while _sum_last's half-length is a multiple of P (at most
    ``kMaxRegLevels`` levels, R of them), a lane folds its own slots: slot i
    of the remaining M = len/P is a tree over slots i + M*u, u < 2^R,
    streamed in bit-reversed order of u through a binary-counter stack;
  * M == 1: the last levels are shuffles down by h/V lanes, then the adds
    inside the float4; otherwise the lane's M partials go to a warp buffer
    at i*P + V*l + c, and the warp finishes with the cooperative fold and
    ``add_tails`` over that buffer;
  * R == 0 (no level keeps the mapping): the lane adds element t and
    t + dim/2 itself, and the buffer takes the dim/2 partials of level 1;
  * an odd dim's level-0 tail, element dim - 1, comes last.

``kernel_fold`` below is that order, step by step (``reg_levels`` and
``launch_wide`` choose R and M as ``_plan`` does here), and the tests hold
it bitwise against the port's ``_sum_last`` and the JAX package's on the
same numpy terms.  The card cannot be asked here; this is where the
kernel's arithmetic is rehearsed.  What binds this model to the kernel is
twofold: ``test_model_reads_the_kernel_source`` finds, in frontier.cu, the
lines of the kernel that the model copies (``LAUNCHER_LINES``), so that a
change there fails here until the model follows; and the GPU tests
(``tests/test_torch_kernels_gpu.py``) hold the kernel itself bitwise
against the plain version at these dims on the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.metric import _sum_last as ref_sum_last  # noqa: E402
from repro_torch.core.metric import _sum_last  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
      / "csrc" / "frontier.cu")
SOURCE = CU.read_text()
MAX_REG_LEVELS = int(re.search(r"constexpr int kMaxRegLevels = (\d+);", SOURCE).group(1))
# l1/l2 take 16-byte loads where dim % VEC_DIVISOR == 0 (and rows are aligned)
VEC_DIVISOR = int(re.search(r"const bool aligned = a\.dim % (\d+) == 0 &&[^;]*;\s*"
                            r"if \(aligned\) return launch_wide_levels", SOURCE).group(1))
# the kernel's lines that _plan, _vec, _shuffle_fold and kernel_fold copy
LAUNCHER_LINES = [
    "while (R < kMaxRegLevels && (n >> 1) >= P && (n >> 1) % P == 0) {",
    "const int n = a.dim >> R;",
    "fold.M = R > 0 ? n / (32 * V) : 0;",
    "fold.buf_len = R == 0 ? a.dim >> 1 : (fold.M == 1 ? 0 : n);",
    "e[u] = load_global<V>(ev + (i + M * bitrev(k0 + u, R)) * P + V * lane);",
    "if (!((k >> l) & 1)) { st[l] = carry; break; }",
    "carry = add_vec<V>(st[l], carry);",
    "for (int x = 16; x >= 1; x >>= 1) {",
    "return __fadd_rn(__fadd_rn(a.v[0], a.v[2]), __fadd_rn(a.v[1], a.v[3]));",
    "d = f.M == 1 ? shuffle_fold<V>(c) : buffer_fold(buf, f.M * P, lane);",
    "const int h = dim >> 1, nv = h / V;",
    "d = buffer_fold(buf, h, lane);",
    "if (dim & 1)",
    "d = __fadd_rn(d, term<METRIC>(q[dim - 1], __ldg(ev + dim - 1)));",
]
NAMED_DIMS = [129, 384, 896, 1023, 2048, 3072, 4096, 6144, 7168, 8192]
SAMPLED_DIMS = sorted(set(np.random.default_rng(14).integers(129, 8193, 12).tolist()
                          + [256 * int(m) for m in
                             np.random.default_rng(15).integers(1, 33, 4)]))


def _plan(dim: int, vec: int):
    """(R, M, buffer length) of launch_wide in csrc/frontier.cu."""
    P, R, n = 32 * vec, 0, dim
    while R < MAX_REG_LEVELS:
        h = n >> 1
        if h < P or h % P:
            break
        n, R = h, R + 1
    M = n // P if R else 0
    return R, M, (dim >> 1 if R == 0 else (0 if M == 1 else n))


def _vec(dim: int) -> int:
    """launch's vector width for l1/l2 on 16-byte aligned rows: 4 where
    dim % 8 == 0 (level 0's t + dim/2 is then aligned too)."""
    return 4 if dim % VEC_DIVISOR == 0 else 1


def _bitrev(k: int, bits: int) -> int:
    return int(format(k, f"0{bits}b")[::-1], 2)


def _buffer_fold(buf):
    """buffer_fold: each level's adds split across lanes (the order within a
    level does not matter), then add_tails innermost first."""
    buf = buf.clone()
    n = m = buf.shape[1]
    while m > 1:
        h = m >> 1
        buf[:, :h] = buf[:, :h] + buf[:, h:2 * h]
        m = h
    s = buf[:, 0]
    for k in range(n.bit_length() - 2, -1, -1):
        if (n >> k) & 1:
            s = s + buf[:, (n >> k) - 1]
    return s


def _shuffle_fold(a, vec: int):
    """shuffle_fold: a [rows, 32 lanes, vec]; __shfl_down_sync by 16 .. 1
    lanes (a lane past the warp's end reads its own value), then the adds
    inside the vector; the total in lane 0."""
    for x in (16, 8, 4, 2, 1):
        other = a.clone()
        other[:, :32 - x] = a[:, x:]
        a = a + other
    v = a[:, 0]
    if vec == 4:
        return (v[:, 0] + v[:, 2]) + (v[:, 1] + v[:, 3])
    return v[:, 0]


def kernel_fold(x, vec: int):
    """metric_wide's l1/l2 sum of the terms x [rows, dim] (f32)."""
    rows, dim = x.shape
    P = 32 * vec
    R, M, _ = _plan(dim, vec)
    if R == 0:                           # level 0 in a lane, then the buffer
        h = dim // 2
        s = _buffer_fold(x[:, :h] + x[:, h:2 * h])
        return s + x[:, dim - 1] if dim & 1 else s
    slots = x[:, :P * (M << R)].reshape(rows, M << R, 32, vec)
    parts = []
    for i in range(M):
        stack = [None] * R
        for k in range(1 << R):          # push_leaf, k in bit-reversed order
            carry = slots[:, i + M * _bitrev(k, R)]
            for lvl in range(R):
                if not (k >> lvl) & 1:
                    stack[lvl] = carry
                    break
                carry = stack[lvl] + carry
        parts.append(carry)
    if M == 1:
        s = _shuffle_fold(parts[0], vec)
    else:                                # buf[i*P + V*l + c]
        s = _buffer_fold(torch.stack(parts, 1).reshape(rows, M * P))
    if dim & 1:                          # level 0's tail, element dim - 1
        s = s + x[:, dim - 1]
    return s


def _terms(metric: str, dim: int, rows: int = 6):
    rng = np.random.default_rng(dim * 10 + (metric == "l2"))
    q = rng.normal(size=(rows, dim)).astype(np.float32)
    e = (rng.normal(size=(rows, dim)) * rng.uniform(0.1, 10.0, (rows, 1))).astype(np.float32)
    d = q - e
    return d * d if metric == "l2" else np.abs(d)


@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("dim", NAMED_DIMS + SAMPLED_DIMS)
def test_kernel_fold_order_is_sum_last(metric, dim):
    terms = _terms(metric, dim)
    x = torch.from_numpy(terms)
    want = _sum_last(x)
    assert torch.equal(torch.from_numpy(np.asarray(ref_sum_last(terms))), want)
    for vec in ((1, 4) if dim % 4 == 0 else (1,)):
        assert torch.equal(kernel_fold(x, vec), want), f"vec={vec} plan={_plan(dim, vec)}"


def test_plan_covers_each_end_of_the_fold():
    """The named dims reach every branch of metric_wide's fold at V = 4
    and V = 1: no register level, registers then shuffles, registers then
    the buffer (also when kMaxRegLevels caps R), and an odd dim's tail."""
    plans = {(dim, vec): _plan(dim, vec) for dim in NAMED_DIMS for vec in (1, 4)
             if vec == 1 or dim % 4 == 0}
    assert plans[(2048, 4)] == (4, 1, 0)          # the kNN-LM keys: registers only
    assert plans[(896, 4)] == (0, 0, 448) and plans[(896, 1)] == (2, 7, 224)
    assert [_vec(d) for d in (2048, 896, 1023, 3072, 129, 132)] == [4, 4, 1, 4, 1, 1]
    assert plans[(1023, 1)] == (0, 0, 511)
    assert plans[(3072, 4)] == (3, 3, 384)
    # the served key widths of grok-1 and yi (run_lm_archs): the buffer
    # after 4 and 3 register levels, 3 and 7 slots a lane
    assert plans[(6144, 4)] == (4, 3, 384) and plans[(7168, 4)] == (3, 7, 896)
    assert plans[(129, 1)] == (2, 1, 0)            # with the odd tail
    assert plans[(8192, 4)] == (MAX_REG_LEVELS, 64 >> MAX_REG_LEVELS, 8192 >> MAX_REG_LEVELS)


def test_model_reads_the_kernel_source():
    """Every kernel line the model copies is still in frontier.cu, word for
    word (whitespace aside), and the constants it reads are the ones that
    make the named dims take the branches ``test_plan_covers_each_end_of_the_fold``
    names."""
    flat = " ".join(SOURCE.split())
    missing = [line for line in LAUNCHER_LINES if " ".join(line.split()) not in flat]
    assert not missing, f"frontier.cu changed; update this model: {missing}"
    assert (MAX_REG_LEVELS, VEC_DIVISOR) == (4, 8)
