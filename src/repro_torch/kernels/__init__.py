"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Nothing here builds or loads a kernel at import: ``_build`` runs ``nvcc`` on
``csrc/*.cu`` the first time a wrapper sees a CUDA tensor.
"""
