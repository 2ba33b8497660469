"""PyTorch/CUDA port of the SM-tree engine (the JAX package ``repro`` is the
reference).

Plain tensor code is PyTorch; the TPU's Pallas kernels on the query path are
CUDA C++ kernels for Hopper (``sm_90a``) under ``kernels/csrc``, built with
``nvcc`` at first use and bound with ``ctypes``.  Importing the package
builds nothing and touches no CUDA device.  Entry points run on the card
unless the caller passes ``device="cpu"``; on CPU tensors every kernel
wrapper takes its plain PyTorch version.
"""
