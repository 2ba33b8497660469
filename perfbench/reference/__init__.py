"""Plain references of what the port computes, in PyTorch and NumPy.

They import nothing of ``repro_torch``, ``repro`` or ``jax``, take nothing
the program made, and work out every intermediate (distances, the
datastore's neighbours, the decode cache's contents) again from the raw
inputs the benchmark made.  Matrix products run with TF32 off.
"""
