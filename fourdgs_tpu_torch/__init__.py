"""PyTorch + CUDA port of the 4DGS renderer and its training step.

Mirrors the module layout of the JAX package `fourdgs_tpu` (which stays the
reference) so each module's counterpart has the same relative path. This
package imports `torch`, numpy and scipy only. Its hand-written kernels live
under `csrc/` and are built with `nvcc` at first use (`ops/_build.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
CUDA present and no "cpu" requested they raise (`utils/device.py`).
"""
