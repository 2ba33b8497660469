"""Serving: the prefill and decode steps and the kNN-LM datastore."""
