"""Pairwise distances ``[nq, d] x [ne, d] -> [nq, ne]`` f32.

Port of ``repro/kernels/distance.py:pairwise_distance_pallas`` (kernel body
``_dist_kernel``) with the metric set of that kernel: ``d_inf``,
``sqeuclidean`` and ``ip`` (negative inner product).  Any other metric
raises ``ValueError``, as ``_dist_kernel`` does.  Inputs are upcast to f32,
as the TPU kernel upcasts f32/bf16 blocks.

  * ``pairwise_distance_torch`` — the plain PyTorch version (the
    reference's ``kernels/ref.py:pairwise_distance_ref`` for this metric
    set), chunked over entries to bound its ``[nq, chunk, d]`` intermediate;
  * the CUDA kernel ``csrc/distance.cu``: ``d_inf`` bitwise equal to the
    plain version, ``sqeuclidean``/``ip`` within 1e-5 (another summation
    order).

``pairwise_distance`` dispatches on the device like ``frontier_scores``: CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
``pairwise_distance.launches`` counts kernel launches.

``pairwise_distance_prune`` (port of ``pairwise_distance_prune_pallas``,
kernel body ``_dist_prune_kernel``) returns the same distances and the
triangle-inequality survival mask ``d <= r_q + r_e`` of the SM-tree's prune
test: for ``sqeuclidean`` the mask is taken on ``sqrt(max(d, 0))`` while
the distances stay squared; equality survives.  Its plain version is
``pairwise_distance_prune_torch``; on the card the same CUDA kernel runs
with its ``PRUNE`` epilogue (``pairwise_distance_prune.launches``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.roofline.counts import distance_work, kernel_call

METRICS = ("d_inf", "sqeuclidean", "ip")
_METRIC_CODES = {m: i for i, m in enumerate(METRICS)}
# elements of the plain version's [nq, chunk, d] intermediate per step
_PLAIN_CHUNK_ELEMS = 1 << 27


def _check_metric(metric: str):
    if metric not in _METRIC_CODES:
        raise ValueError(f"pairwise distance metric must be one of {METRICS}; "
                         f"got {metric!r}")


def _true_distance(dist, metric: str):
    """The distance the prune mask is taken on.  The root is taken in f64
    and rounded once: torch's vectorised f32 ``sqrt`` on the CPU is not
    correctly rounded (see core/metric.py), the kernel's ``__fsqrt_rn``
    is."""
    if metric == "sqeuclidean":
        return dist.clamp_min(0.0).double().sqrt().float()
    return dist


def pairwise_distance_prune_torch(q, e, r_q, r_e, metric: str = "d_inf"):
    """Plain version of the fused distances + prune mask: (dist, mask)."""
    dist = pairwise_distance_torch(q, e, metric)
    rq = torch.as_tensor(r_q, dtype=torch.float32, device=dist.device)
    re = torch.as_tensor(r_e, dtype=torch.float32, device=dist.device)
    return dist, _true_distance(dist, metric) <= rq[:, None] + re[None, :]


def pairwise_distance_torch(q, e, metric: str = "d_inf"):
    """Plain version: broadcast differences, reduced over d, in entry chunks."""
    _check_metric(metric)
    q = q.float()
    e = e.float()
    nq, d = q.shape
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, nq * d))
    out = torch.empty((nq, e.shape[0]), dtype=torch.float32, device=q.device)
    for s in range(0, e.shape[0], step):
        qq, ee = q[:, None, :], e[None, s:s + step, :]
        if metric == "d_inf":
            out[:, s:s + step] = (qq - ee).abs().amax(-1)
        elif metric == "sqeuclidean":
            out[:, s:s + step] = ((qq - ee) ** 2).sum(-1)
        else:
            out[:, s:s + step] = -(qq * ee).sum(-1)
    return out


def _declare(lib):
    """Declare the C signature of a build of ``csrc/distance.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pairwise_distance_launch.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.pairwise_distance_launch.restype = i
    return lib


@functools.cache
def _lib():
    """The built library, with its C signature declared (once)."""
    from repro_torch.kernels import _build
    return _declare(_build.load("distance"))


def _pairwise_distance_cuda(q, e, metric: str, r_q=None, r_e=None):
    out = _launch(_lib(), q, e, metric, r_q, r_e)
    launched = out[0].numel() > 0
    if r_q is not None:
        pairwise_distance_prune.launches += launched
        return out
    pairwise_distance.launches += launched
    return out[0]


def _launch(lib, q, e, metric: str, r_q=None, r_e=None):
    """Check the inputs, launch ``lib``'s kernel (a build of
    ``csrc/distance.cu``) and return (dist, mask or None); counts
    nothing."""
    dev = q.device
    if e.device != dev:
        raise ValueError(f"e is on {e.device}, q on {dev}")
    if q.dim() != 2 or e.dim() != 2 or q.shape[1] != e.shape[1]:
        raise ValueError(f"expected [nq, d] and [ne, d]; got {tuple(q.shape)} "
                         f"and {tuple(e.shape)}")
    if q.dtype != torch.float32 or e.dtype != torch.float32:
        raise TypeError(f"distance kernel takes float32; got {q.dtype}, {e.dtype}")
    if not (q.is_contiguous() and e.is_contiguous()):
        raise ValueError("distance kernel inputs must be contiguous")
    nq, d = q.shape
    ne = e.shape[0]
    if d < 1:
        raise ValueError("distance kernel needs d >= 1")
    if max(nq, ne) * d >= 2 ** 31 or nq * ne >= 2 ** 62:
        raise ValueError(f"inputs too large for one launch: nq={nq}, ne={ne}, d={d}")
    prune = r_q is not None
    if prune:
        for name, r, n in (("r_q", r_q, nq), ("r_e", r_e, ne)):
            if r.device != dev or r.dtype != torch.float32 or tuple(r.shape) != (n,):
                raise ValueError(f"{name} must be float32 [{n}] on {dev}; got "
                                 f"{r.dtype} {tuple(r.shape)} on {r.device}")
    out = torch.empty((nq, ne), dtype=torch.float32, device=dev)
    mask = torch.empty((nq, ne), dtype=torch.bool, device=dev) if prune else None
    if nq == 0 or ne == 0:
        return out, mask
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pairwise_distance_launch(q.data_ptr(), e.data_ptr(), ptr(r_q),
                                          ptr(r_e), out.data_ptr(), ptr(mask),
                                          nq, ne, d, _METRIC_CODES[metric],
                                          stream)
    if rc != 0:
        raise RuntimeError(f"distance kernel launch failed: cudaError {rc}")
    return out, mask


def _work(out, q, e, *args, prune: bool = False, **kwargs):
    return distance_work(q.shape[0], e.shape[0], q.shape[1], prune)


def _prune_work(out, q, e, *args, **kwargs):
    return _work(out, q, e, prune=True)


def _meta(q, e, prune: bool):
    """The dry run's outputs: shapes only, nothing computed."""
    out = torch.empty((q.shape[0], e.shape[0]), dtype=torch.float32, device="meta")
    if not prune:
        return out
    return out, torch.empty(out.shape, dtype=torch.bool, device="meta")


@kernel_call("pairwise_distance", _work)
def pairwise_distance(q, e, metric: str = "d_inf"):
    """[nq, d] x [ne, d] -> [nq, ne] distances: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, an empty output on the
    meta device."""
    _check_metric(metric)
    if q.device.type == "meta":
        return _meta(q, e, False)
    if q.device.type == "cuda":
        return _pairwise_distance_cuda(q.float().contiguous(),
                                       e.float().contiguous(), metric)
    if q.device.type != "cpu":
        raise ValueError(f"pairwise_distance runs on cuda or cpu, not {q.device}")
    return pairwise_distance_torch(q, e, metric)


pairwise_distance.launches = 0


@kernel_call("pairwise_distance_prune", _prune_work)
def pairwise_distance_prune(q, e, r_q, r_e, metric: str = "d_inf"):
    """(dist [nq, ne] f32, mask [nq, ne] bool): the CUDA kernel with its
    prune epilogue for CUDA tensors, the plain version for CPU tensors,
    empty outputs on the meta device."""
    _check_metric(metric)
    if q.device.type == "meta":
        return _meta(q, e, True)
    if q.device.type == "cuda":
        f = lambda t: torch.as_tensor(t, dtype=torch.float32,
                                      device=q.device).contiguous()
        return _pairwise_distance_cuda(f(q), f(e), metric, f(r_q), f(r_e))
    if q.device.type != "cpu":
        raise ValueError(f"pairwise_distance_prune runs on cuda or cpu, not {q.device}")
    return pairwise_distance_prune_torch(q, e, r_q, r_e, metric)


pairwise_distance_prune.launches = 0
