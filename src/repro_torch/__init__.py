"""PyTorch/CUDA port of the filter-agnostic FVS framework (`repro`).

The JAX package `repro` is the reference; this package runs the same
search path on an NVIDIA card with hand-written CUDA kernels.  It imports
neither JAX nor anything of `repro`.
"""
