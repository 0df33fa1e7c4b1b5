"""PyTorch/CUDA port of the massively parallel IPOP-CMA-ES (``repro``).

Imports torch and numpy only, never jax or the ``repro`` package; see
README.md, "PyTorch/CUDA port".
"""
