"""Synthetic datasets (numpy): a copy of the JAX package's generators."""
