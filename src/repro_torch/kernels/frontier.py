"""Fused frontier scoring for the SM-tree cohort descent.

Port of ``repro/kernels/frontier.py``.  Every level of the level-synchronous
kNN descent evaluates the metric between each query of the cohort and every
entry of every node on that query's frontier and derives four per-entry
outputs, each ``[b, F, cap]`` f32 with +inf at masked positions:

  * ``dmax``   = d + r   at valid internal entries (the d_max bound)
  * ``score``  = d - r   at valid internal entries (prune test / closest key)
  * ``leaf_d`` = d       at valid leaf entries (exact candidates)
  * ``dq``     = d       at valid internal entries (carried as d(q, parent))

With the parent-distance filter inputs (``pdist``, ``qpd``, ``rq``: all or
none) an entry with ``|qpd - pdist| > rq + r + _PRUNE_PAD`` is dropped before
its metric is evaluated; outputs of kept entries are bitwise unchanged.

Two implementations of one function:

  * ``frontier_scores_torch`` — the plain PyTorch version, the same
    computation as the reference's ``frontier_scores_xla`` (a
    ``[b, F, cap, dim]`` gather, then the shared metric);
  * the CUDA kernel ``csrc/frontier.cu`` (replaces ``_frontier_kernel`` and
    ``_frontier_kernel_pruned``), bitwise equal to the plain version.  It
    has a variant for narrow rows (``dim <= 128``: persistent warps, each
    on every T-th frontier slot; a slot's node metadata read at its keep
    step, slots with no live entry written at once, live slots' rows
    copied into a ring of page stages while an earlier one is scored, and
    the l1/l2 fold in registers) and one for wide rows; the launcher picks
    one from ``dim``.  Both take pages of any ``cap``: a page wider than
    64 entries is scored as segments of at most 64, in the same launch.
    The wide variant reads entry rows straight from device memory with 16-byte
    loads and folds l1/l2 in registers (each lane's slots in ``_sum_last``'s
    order, then shuffles; a warp buffer in shared memory only for dims
    whose halving leaves the lane mapping early).  A block takes a run of
    up to 8 consecutive pairs, stages their query rows once and writes
    their outputs as whole rows; a warp scores one (pair, entry) at a
    time.

``frontier_scores`` dispatches on the tensors' device: CPU tensors take the
plain version; CUDA tensors launch the kernel or raise — there is no
fallback.  ``frontier_scores.launches`` counts kernel launches,
``frontier_scores.pruned_launches`` the subset that ran with the filter and
``frontier_scores.wide_launches`` the subset that ran the wide variant.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.metric import get_metric

_INF = float("inf")

# Filter slack, as in the reference: the descent's prune-test pad (1e-5)
# plus 1e-5 absorbing f32 rounding of the triangle lower bound.  The CUDA
# kernel carries the same constant (csrc/frontier.cu:kPrunePad).
_PRUNE_PAD = 2e-5

_METRIC_CODES = {"d_inf": 0, "l2": 1, "l1": 2}


def _check_prune_args(pdist, qpd, rq):
    given = [x is not None for x in (pdist, qpd, rq)]
    if any(given) and not all(given):
        raise ValueError("parent-distance filtering needs all of "
                         "pdist, qpd and rq (or none of them)")
    return all(given)


def frontier_scores_torch(fids, queries, vecs, radius, internal_valid,
                          leaf_valid, *, metric: str,
                          pdist=None, qpd=None, rq=None):
    """Plain PyTorch version (the reference's ``frontier_scores_xla``).

    fids           [b, F] int32 — frontier node ids (-1 = empty slot)
    queries        [b, dim] f32
    vecs           [N, cap, dim] f32 — node pages
    radius         [N, cap] f32
    internal_valid [N, cap] bool — valid internal entries
    leaf_valid     [N, cap] bool — valid leaf entries
    pdist [N, cap] f32, qpd [b, F] f32, rq [b] f32 — optional filter inputs

    Materialises the ``[b, F, cap, dim]`` gather the kernel avoids."""
    prune = _check_prune_args(pdist, qpd, rq)
    # empty slots clamp to node 0 and are masked below (the reference's
    # jnp.maximum(fids, 0)); the upper clamp mirrors XLA's clamped gather
    nodes = fids.clamp(0, vecs.shape[0] - 1).long()
    ok = (fids >= 0)[:, :, None]
    r = radius[nodes]
    iv = (internal_valid[nodes] != 0) & ok
    lv = (leaf_valid[nodes] != 0) & ok
    e = vecs[nodes]
    if prune:
        lb = (qpd[:, :, None] - pdist[nodes]).abs()
        keep = lb <= rq[:, None, None] + r + _PRUNE_PAD
        iv = iv & keep
        lv = lv & keep
        e = torch.where((iv | lv)[..., None], e, 0.0)
    d = get_metric(metric)(queries[:, None, None, :], e)
    return (torch.where(iv, d + r, _INF),
            torch.where(iv, d - r, _INF),
            torch.where(lv, d, _INF),
            torch.where(iv, d, _INF))


def _declare(lib):
    """Declare the C signatures of a build of ``csrc/frontier.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.frontier_scores_launch.argtypes = [p] * 13 + [i] * 7 + [p]
    lib.frontier_scores_launch.restype = i
    lib.frontier_max_dim.restype = i
    lib.frontier_narrow_max_dim.restype = i
    return lib


@functools.cache
def _lib():
    """The built library, with its C signatures declared (once)."""
    from repro_torch.kernels import _build
    return _declare(_build.load("frontier"))


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _frontier_scores_cuda(fids, queries, vecs, radius, internal_valid,
                          leaf_valid, *, metric, pdist, qpd, rq, prune):
    if metric not in _METRIC_CODES:
        raise ValueError(f"frontier kernel supports {sorted(_METRIC_CODES)}; "
                         f"got {metric!r}")
    dev = fids.device
    b, w = fids.shape
    N, cap, dim = vecs.shape
    _check("fids", fids, torch.int32, (b, w), dev)
    _check("queries", queries, torch.float32, (b, dim), dev)
    _check("vecs", vecs, torch.float32, (N, cap, dim), dev)
    _check("radius", radius, torch.float32, (N, cap), dev)
    _check("internal_valid", internal_valid, torch.bool, (N, cap), dev)
    _check("leaf_valid", leaf_valid, torch.bool, (N, cap), dev)
    if prune:
        _check("pdist", pdist, torch.float32, (N, cap), dev)
        _check("qpd", qpd, torch.float32, (b, w), dev)
        _check("rq", rq, torch.float32, (b,), dev)
    lib = _lib()
    if dim > lib.frontier_max_dim() or N < 1:
        raise ValueError(f"frontier kernel takes dim <= {lib.frontier_max_dim()} "
                         f"and N >= 1; got dim={dim}, N={N}")
    outs = tuple(torch.empty((b, w, cap), dtype=torch.float32, device=dev)
                 for _ in range(4))
    if b * w == 0:
        return outs
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.frontier_scores_launch(
            ptr(fids), ptr(queries), ptr(vecs), ptr(radius),
            ptr(internal_valid), ptr(leaf_valid),
            ptr(pdist if prune else None), ptr(qpd if prune else None),
            ptr(rq if prune else None), *(o.data_ptr() for o in outs),
            b, w, N, cap, dim, _METRIC_CODES[metric], int(prune), stream)
    if rc != 0:
        raise RuntimeError(f"frontier kernel launch failed: cudaError {rc}")
    frontier_scores.launches += 1
    if prune:
        frontier_scores.pruned_launches += 1
    if dim > lib.frontier_narrow_max_dim():
        frontier_scores.wide_launches += 1
    return outs


def frontier_scores(fids, queries, vecs, radius, internal_valid, leaf_valid,
                    *, metric: str, pdist=None, qpd=None, rq=None):
    """Score one level's frontier: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (dmax, score, leaf_d, dq)."""
    prune = _check_prune_args(pdist, qpd, rq)
    if fids.device.type == "cuda":
        return _frontier_scores_cuda(
            fids, queries, vecs, radius, internal_valid, leaf_valid,
            metric=metric, pdist=pdist, qpd=qpd, rq=rq, prune=prune)
    if fids.device.type != "cpu":
        raise ValueError(f"frontier_scores runs on cuda or cpu, not {fids.device}")
    return frontier_scores_torch(
        fids, queries, vecs, radius, internal_valid, leaf_valid,
        metric=metric, pdist=pdist, qpd=qpd, rq=rq)


frontier_scores.launches = 0
frontier_scores.pruned_launches = 0
frontier_scores.wide_launches = 0
