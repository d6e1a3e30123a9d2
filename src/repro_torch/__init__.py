"""PyTorch and CUDA port of the JAX package `repro`, slice by slice.

Module names follow the JAX package's, so each counterpart is found under
the same path. The package imports torch and numpy, never jax or `repro`.
"""
