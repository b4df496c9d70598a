"""PyTorch + CUDA port of `tpuslam`: the SLAM system, its facade and its
glue (datasets, map checkpoints, viewer, drivers).

The JAX package `tpuslam` is the reference: every module here mirrors the
module of the same path there, and the tests feed both the same numpy inputs.
This package imports torch and numpy only; it never imports jax or tpuslam
(PIL is imported by the drawing functions alone, PyYAML by load_settings).

The two TPU Pallas kernels of the path are hand-written CUDA kernels for
Hopper (`csrc/`), built with nvcc at first use (`_build.py`). Their wrappers
(`ops/fast.py::fast_nms_pyramid`, `ops/patches.py::gather_patches`) launch the kernel
for a CUDA tensor and run the plain PyTorch version for a CPU tensor. The
host library (`csrc_host/`: PNG decoder, prefetcher, evaluation) is C++
built with g++ at first use and bound by `io/native.py`.
"""
