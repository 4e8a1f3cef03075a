"""PyTorch/CUDA port of robustvlm_tpu.

The JAX package `robustvlm_tpu` is the reference and stays as it is. This
package imports torch and never jax; its CUDA kernels live in `csrc/` and
are built with nvcc at first use (`ops/kernels/_build.py`).
"""
