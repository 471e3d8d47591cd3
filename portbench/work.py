"""The work a render or a training step needs, counted from its inputs and
never from the program: the rooflines and the mfu metrics divide these by
the chip's peak (core/peaks.py) and by device time.

Conventions (a fused multiply-add counts two operations, every other
float32 operation one, exp one):

* Blend evaluations (`reference/raster.py:Evaluations`): for each pixel,
  the entries of its tile's depth-sorted list (corner cull applied) that
  it reaches with its entering transmittance above 1e-4, "evaluated", and
  of those the ones that pass the 1/255 gate, "contributing". They are
  counted by the reference's own arithmetic on the run's own cameras and
  states, outside the timed window.
* Blend forward, from the spec of fourdgs_tpu_torch/ops/rasterize_ref.py,
  with each gaussian's constants folded beforehand (the conic times
  -1/2, log2 e): per evaluated pair 14 (dx, dy: 2; the quadratic form
  dx (a dx + b dy) + c dy dy: 7; exp: 1; times the opacity: 1; the 0.99
  clamp: 1; the 1/255 gate: 1; the transmittance test: 1); per
  contributing pair 9 more (w = alpha T: 1; three color sums: 6; the
  transmittance update T - T alpha: 2). Depth is not counted: neither the
  frame nor the loss reads it.
* Blend backward, per evaluated pair the forward's 14 again (alpha is
  recomputed); per contributing pair 30 more: the color gradient summed
  into the gaussian's row (3 FMA: 6), the suffix color sum carried back to
  front (3 FMA: 6), its dot with the pixel's cotangent (5), alpha's
  gradient from it and the transmittance (3), through the exp and the
  opacity (2), the power's partials in dx and dy (2 FMA: 4), the pixel
  centre's and the conic's gradients summed into the row (4).
* Splats per live gaussian and view: the HexPlane's taps (a spatial plane
  3 lerps of 3 per channel, a time plane 1, the six planes' product 5 per
  channel, each level), 2 in out per linear layer of the feature MLP and
  of each head the config runs, a ReLU 1 per element; the activations 20,
  degree-3 SH 130, the projection 200.
* A step: every view's splats and the loss at three times their forward
  (the backward at twice the forward), the blend forward and backward as
  above, Adam 11 per parameter (live slots x 59 and the deformation's),
  the regularizers 30 per plane cell.
* A frame: its splats and its blend forward.
Only live gaussians are counted: the work on dead slots is not needed.
"""
from __future__ import annotations

import math

from portbench.core.peaks import FP32_FLOP_S
from portbench.reference.deformation import COO_COMBS, DeformSpec

FWD_EVALUATED, FWD_CONTRIBUTING = 14, 9
BWD_EVALUATED, BWD_CONTRIBUTING = 14, 30
ACTIVATIONS, SH3, PROJECTION = 20, 130, 200
LOSS_PER_VALUE = 3
ADAM_PER_PARAM = 11
REG_PER_CELL = 30
PARAMS_PER_SLOT = 3 + 3 + 45 + 3 + 4 + 1


def hexplane_flops(spec: DeformSpec) -> int:
    c = spec.out_dim
    per_level = sum(3 * c if 3 in pair else 9 * c for pair in COO_COMBS)
    return len(spec.multires) * (per_level + 5 * c)


def mlp_flops(spec: DeformSpec) -> int:
    w = spec.net_width
    flops = 2 * spec.feat_dim * w + (max(spec.defor_depth, 1) - 1) * (
        2 * w * w + w)
    heads = [3] * (not spec.no_dx) + [3] * (not spec.no_ds) \
        + [4] * (not spec.no_dr) + [1] * (not spec.no_do) \
        + [spec.sh_coeffs * 3] * (not spec.no_dshs)
    return flops + sum(2 * w * w + 2 * w * out + 2 * w for out in heads)


def splat_flops(spec: DeformSpec, n_live: int) -> int:
    """One view's splats of n_live gaussians (forward)."""
    return n_live * (hexplane_flops(spec) + mlp_flops(spec) + ACTIVATIONS
                     + SH3 + PROJECTION)


def blend_fwd_flops(evaluated: int, contributing: int) -> int:
    return FWD_EVALUATED * evaluated + FWD_CONTRIBUTING * contributing


def blend_bwd_flops(evaluated: int, contributing: int) -> int:
    return BWD_EVALUATED * evaluated + BWD_CONTRIBUTING * contributing


def grid_cells(spec: DeformSpec) -> int:
    return sum(math.prod(s) for k, s in spec.shapes().items()
               if k.startswith("grid."))


def deform_params(spec: DeformSpec) -> int:
    return sum(math.prod(s) for s in spec.shapes().values())


def frame_flops(spec: DeformSpec, n_live: int, evaluated: int,
                contributing: int) -> int:
    return splat_flops(spec, n_live) + blend_fwd_flops(evaluated,
                                                       contributing)


def step_flops(spec: DeformSpec, n_live: int, views: list,
               pixels: int) -> int:
    """`views`: (evaluated, contributing) of each view of the batch;
    `pixels`: H x W."""
    flops = 0
    for ev, co in views:
        flops += 3 * (splat_flops(spec, n_live) + LOSS_PER_VALUE * 3 * pixels)
        flops += blend_fwd_flops(ev, co) + blend_bwd_flops(ev, co)
    flops += ADAM_PER_PARAM * (PARAMS_PER_SLOT * n_live + deform_params(spec))
    return flops + REG_PER_CELL * grid_cells(spec)


def seconds_at_peak(flops: float) -> float:
    return flops / FP32_FLOP_S
