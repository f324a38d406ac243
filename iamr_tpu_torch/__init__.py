"""iamr_tpu_torch: the PyTorch + CUDA port of iamr_tpu (see README.md).

Imports torch and never jax; the JAX package is the reference its tests
compare against. Slice 1: the single-level step on the spectral solvers,
with hand-written Hopper kernels for the Godunov PLM predictor and
advection (csrc/godunov_plm.cu).
"""
