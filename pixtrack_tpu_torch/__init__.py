"""pixtrack-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX package ``pixtrack_tpu``, which stays the
reference. It mirrors that package's subpackage and module names. This
package imports torch and never JAX; the one kernel of the tracking main
path (K1, the fused ray march) is hand-written CUDA under ``csrc/``, built
at first use.
"""
