"""PyTorch / CUDA port of panopticdiffusionmodels_tpu for one NVIDIA H100.

The JAX package beside it is the reference that every module here is held
against; this package imports neither JAX nor that package.
"""
