"""PyTorch/CUDA port of the CaraServe reproduction.

The JAX package `repro` is the reference; this package mirrors its layout
(configs/, kernels/, models/, core/, serving/, traces/, launch/) and runs
its serving path on an NVIDIA H100 through hand-written CUDA kernels in
csrc/. It imports torch and numpy only — never jax, never `repro`.
"""
