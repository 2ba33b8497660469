"""Inputs made from ``--seed``: the paper's clustered objects, query and
mutation streams, and the kNN-LM datastore's keys and values.

``clustered`` is a frozen copy of ``repro_torch/data/datagen.py:clustered``
(the paper's §4.1 distribution), so a change to the program cannot change
the data it is measured on.  Every stream is drawn from a numpy generator
seeded with the run's seed and a fixed tag per stream, so one seed gives
the same inputs in every run, whatever the timing.
"""
from __future__ import annotations

import numpy as np

TAGS = {"objects": 1, "queries": 2, "fresh": 3, "churn": 4, "sample": 5,
        "prompts": 6, "values": 7, "probes": 8, "weights": 9, "keys": 10,
        "centres": 11}


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one named input stream of a run."""
    return np.random.default_rng([abs(int(seed)), TAGS[stream]])


def clustered(n: int, *, dims: int, n_clusters: int, spread: float,
              seed_rng: np.random.Generator, centres: np.ndarray | None = None):
    """Trig-falloff clusters around random centres, each component
    independent (the paper's axis-parallel density ridges).  Returns
    (points [n, dims] f32, centres): pass ``centres`` back to draw more
    points of the same distribution."""
    if centres is None:
        centres = seed_rng.random((n_clusters, dims))
    which = seed_rng.integers(0, n_clusters, size=n)
    u = seed_rng.random((n, dims))
    offs = spread * np.sin(np.pi * (u - 0.5)) ** 3
    pts = centres[which] + offs
    return np.clip(pts, 0.0, 1.0).astype(np.float32), centres


class IndexStream:
    """Indices drawn uniformly from ``[0, n)``, made in blocks as they are
    used: the same seed gives the same sequence however far it is read."""

    def __init__(self, gen: np.random.Generator, n: int, block: int = 65536):
        self.gen, self.n, self.block = gen, n, block
        self.buf = np.empty(0, np.int64)
        self.pos = 0

    def next(self) -> int:
        if self.pos == len(self.buf):
            self.buf = self.gen.integers(0, self.n, size=self.block)
            self.pos = 0
        self.pos += 1
        return int(self.buf[self.pos - 1])


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a ``torch.Generator`` of one named stream."""
    return int(rng(seed, stream).integers(0, 2**63 - 1))
