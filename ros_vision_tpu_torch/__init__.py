"""PyTorch + CUDA port of the ros_vision_tpu AprilTag main path.

The JAX package ``ros_vision_tpu`` stays the reference; this package runs
the same detector in PyTorch. Every Pallas kernel on the 1280x800 tag36h11
path has a hand-written CUDA C++ counterpart for Hopper (``csrc/*.cu``,
compiled with nvcc for ``sm_90a`` at first use, see ``_build.py``):

  K1  ops/threshold_kernel.py  <- ops/threshold_pallas.adaptive_threshold_fused
  K2  ops/frontend_kernel.py   <- ops/frontend_pallas.rank_image
  K3  ops/frontend_kernel.py   <- ops/frontend_pallas.boundary_compact
  K4  ops/gather_kernel.py     <- ops/gather_pallas.value_histogram

A kernel wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; there is no other switch and no
fallback. Nothing in this package imports jax.
"""
