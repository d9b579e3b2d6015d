"""mdcommunity_tpu_torch: the PyTorch and CUDA port of mdcommunity_tpu.

This slice runs large-graph greedy dismantling by a trained unit-cost model
on one NVIDIA H100: the banded Q forward on the card, with its aggregation
in two hand-written CUDA kernels (ops/band_kernels.py, csrc/band.cu), and the
interdependency cascade on the host (env/host_env.py, native/).

The package imports torch, numpy, scipy and ctypes, and never jax or the
JAX package.  Entry points run on CUDA unless the caller passes
device="cpu"; on a CPU tensor every kernel wrapper runs its plain PyTorch
version.
"""
