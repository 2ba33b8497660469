"""Metric functions for the (S)M-tree, on numpy arrays and torch tensors.

The port's copy of ``repro/core/metric.py``.  The paper (§4.1) uses the
Chebyshev / L-infinity metric

    d_inf(x, y) = max_i |x_i - y_i|

over 20-dimensional vectors, with experiment dimensionality varied by
truncating the metric (not the stored vectors) to the first ``n_dims``
components; every metric takes an optional ``n_dims``.

Summing reductions go through ``_sum_last``, the reference's fixed-
association pairwise tree fold: the reduction tree depends only on the axis
length, so l1/l2 distances are bitwise identical whether evaluated here on
numpy, on a torch tensor of any leading shape, in the CUDA frontier kernel
(kernels/csrc/frontier.cu replays the same fold), or in the JAX package.

The torch branch needs no counterpart of the reference's ``_pin_rounding``:
that pin stops XLA from contracting the squares into the fold's adds as
FMAs inside one fused computation.  Eager torch runs each op as its own
kernel and rounds every result to f32 once, so no contraction can happen.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

MetricFn = Callable[..., "np.ndarray | torch.Tensor"]

_REGISTRY: dict[str, MetricFn] = {}


def register_metric(name: str):
    def deco(fn: MetricFn) -> MetricFn:
        _REGISTRY[name] = fn
        return fn
    return deco


def get_metric(name: str) -> MetricFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown metric {name!r}; have {sorted(_REGISTRY)}") from None


def _truncate(x, y, n_dims):
    if n_dims is not None:
        x = x[..., :n_dims]
        y = y[..., :n_dims]
    return x, y


def _sum_last(x):
    """Sum over the last axis with a fixed pairwise-tree association:
    halve, add, carry the odd tail (tails are added innermost first).  A
    function of the axis length alone, so every call site — numpy, torch on
    any device, the CUDA kernel — produces bitwise identical sums."""
    n = x.shape[-1]
    if n == 0:
        return x.sum(-1)    # empty sum: zeros, association irrelevant
    if n == 1:
        return x[..., 0]
    h = n // 2
    s = _sum_last(x[..., :h] + x[..., h:2 * h])
    if n % 2:
        s = s + x[..., -1]
    return s


@register_metric("d_inf")
def d_inf(x, y, n_dims: int | None = None):
    """Chebyshev metric; broadcasting pairwise over leading axes."""
    x, y = _truncate(x, y, n_dims)
    if isinstance(x, torch.Tensor):
        # torch's .max(-1) returns (values, indices); amax is the reduction
        return (x - y).abs().amax(-1)
    return abs(x - y).max(axis=-1)


@register_metric("l2")
def l2(x, y, n_dims: int | None = None):
    x, y = _truncate(x, y, n_dims)
    d = x - y
    s = _sum_last(d * d)
    # a correctly rounded sqrt, never s ** 0.5.  torch's vectorised f32 sqrt
    # on the CPU is not correctly rounded (an ulp off for ~0.6% of inputs),
    # its f64 sqrt is; the f64 root of an f32 value rounds to the correctly
    # rounded f32 root (53 bits leave room for the double rounding)
    if isinstance(s, torch.Tensor):
        return torch.sqrt(s.double()).float()
    return np.sqrt(s)


@register_metric("l1")
def l1(x, y, n_dims: int | None = None):
    x, y = _truncate(x, y, n_dims)
    return _sum_last(abs(x - y))


def pairwise(metric: str | MetricFn, X, Y, n_dims: int | None = None):
    """[n, d] x [m, d] -> [n, m] distance matrix."""
    fn = get_metric(metric) if isinstance(metric, str) else metric
    return fn(X[:, None, :], Y[None, :, :], n_dims=n_dims)


def make_metric(name: str, n_dims: int | None = None) -> MetricFn:
    fn = get_metric(name)
    return functools.partial(fn, n_dims=n_dims)
