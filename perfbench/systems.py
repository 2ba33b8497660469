"""The systems under test, built from a configuration file and ``--seed``
through the port's public entry points."""
from __future__ import annotations

import numpy as np

from perfbench import datagen


def make_objects(config: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The index's objects (the paper's clustered vectors) and the cluster
    centres, to draw fresh objects of the same distribution.  The centres
    are the configuration's (drawn from its ``centres_seed``), so every
    run serves the same distribution and ``--seed`` draws its objects:
    with centres drawn from ``--seed`` the tree's shape, and with it the
    cost of a mutation, changed from seed to seed far more than between
    two runs of one seed."""
    centres = datagen.rng(config["centres_seed"], "centres").random(
        (config["n_clusters"], config["dims"]))
    return datagen.clustered(config["n_objects"], dims=config["dims"],
                             n_clusters=config["n_clusters"], spread=config["spread"],
                             seed_rng=datagen.rng(seed, "objects"), centres=centres)


def build_index(config: dict, X: np.ndarray, device: str):
    """The port's SM-tree over ``X`` (object ids = rows), built on the
    host by ``bulk_build`` and moved to ``device``."""
    from repro_torch.core import smtree
    return smtree.bulk_build(X, capacity=config["capacity"], metric=config["metric"],
                             fill_frac=config["fill_frac"],
                             min_fill_frac=config["min_fill_frac"], device=device)
