"""Synthetic vector datasets reproducing the paper's §4.1 distributions.

The PyTorch port's own copy of ``repro/data/datagen.py`` (numpy only): the
same seeds give the same arrays on both sides.

Three distributions, all over [0, 1]^20 (object size is constant at 20 dims;
experiment dimensionality is varied in the *metric*, not the data):

* ``clustered`` — points distributed around randomly generated seed points
  using a trigonometric radial falloff, each vector component generated
  independently (the paper notes this produces density ridges parallel to
  the coordinate axes — we keep that artefact deliberately, Fig. 4).
* ``nonuniform`` — a polynomial transform of uniform randoms (Fig. 9).
* ``uniform`` — iid U[0,1).
"""
from __future__ import annotations

import numpy as np

FULL_DIMS = 20  # paper: constant object size, 20-d vectors


def clustered(n: int, *, dims: int = FULL_DIMS, n_clusters: int = 50,
              spread: float = 0.12, seed: int = 0) -> np.ndarray:
    """Trig-falloff clusters around random seeds, per-component independent.

    Each component c of a point near seed s is  s_c + spread * sin(pi*(u-0.5))
    with u ~ U[0,1): sin concentrates mass near the seed (higher density close
    to seed points), and independence across components yields the paper's
    axis-parallel density ridges.
    """
    rng = np.random.default_rng(seed)
    seeds = rng.random((n_clusters, dims))
    which = rng.integers(0, n_clusters, size=n)
    u = rng.random((n, dims))
    offs = spread * np.sin(np.pi * (u - 0.5)) ** 3  # odd power: peaked at 0
    pts = seeds[which] + offs
    return np.clip(pts, 0.0, 1.0).astype(np.float32)


def nonuniform(n: int, *, dims: int = FULL_DIMS, power: int = 3,
               seed: int = 0) -> np.ndarray:
    """Polynomial transform of uniforms: x -> x^power, mirrored around 0.5."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, dims))
    x = 0.5 + 0.5 * np.sign(u - 0.5) * np.abs(2 * u - 1) ** power
    return x.astype(np.float32)


def uniform(n: int, *, dims: int = FULL_DIMS, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((n, dims)).astype(np.float32)


DISTRIBUTIONS = {
    "clustered": clustered,
    "nonuniform": nonuniform,
    "uniform": uniform,
}


def make_dataset(kind: str, n: int, *, dims: int = FULL_DIMS, seed: int = 0) -> np.ndarray:
    try:
        fn = DISTRIBUTIONS[kind]
    except KeyError:
        raise KeyError(f"unknown distribution {kind!r}; have {sorted(DISTRIBUTIONS)}") from None
    return fn(n, dims=dims, seed=seed)
