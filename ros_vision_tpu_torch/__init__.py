"""PyTorch + CUDA port of the ros_vision_tpu AprilTag main path.

The JAX package ``ros_vision_tpu`` stays the reference; this package runs
the same detector, vision node and launch in PyTorch, with its own copies
of the host modules it needs (families, render, config, msg, runtime) and
nothing imported from the JAX package. Every Pallas kernel of the JAX
package has a hand-written CUDA C++ counterpart for Hopper
(``csrc/*.cu``, compiled with nvcc for ``sm_90a`` at first use, see
``_build.py``):

  K1  ops/threshold_kernel.py  <- ops/threshold_pallas.adaptive_threshold_fused
  K2  ops/frontend_kernel.py   <- ops/frontend_pallas.rank_image
  K3  ops/frontend_kernel.py   <- ops/frontend_pallas.boundary_compact
  K4  ops/gather_kernel.py     <- ops/gather_pallas.value_histogram
  K6  ops/ccl_kernel.py        <- ops/ccl_pallas.propagate_fixpoint
  K7  ops/ccl_kernel.py        <- ops/ccl_pallas.label_histogram
  K8  ops/ccl_kernel.py        <- ops/ccl_pallas.propagate
  K9  ops/sort_kernel.py       <- ops/sort_pallas.sort_tpu
  K10 ops/gather_kernel.py     <- ops/gather_pallas.table_take_cm
  K11 ops/gather_kernel.py     <- ops/gather_pallas.segment_min_max
  K12 ops/gather_kernel.py     <- ops/gather_pallas.rank_gather

A kernel wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; there is no other switch and no
fallback. Nothing in this package imports jax.

Off the AprilTag path, in plain PyTorch (the JAX modules reach no Pallas
kernel there): the game-piece detector (models/yolo.py, models/infer.py,
ops/nms.py, runtime/game_piece_node.py, tools/inference_benchmark.py) and
the rectify/debayer preprocessing (ops/rectify.py).
"""
