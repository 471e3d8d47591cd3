"""blend_bwd_roofline.train (layer: blend backward K2; moves
train_rays_per_s): the least time of the traced steps' blend backwards
at the float32 peak (work.blend_bwd_flops of the evaluations the reference
counts) over the device time of the records named blend_bwd_kernel, in
%."""
from portbench.core.readers import roofline


def read(outcome, run):
    return roofline(outcome, "blend_bwd_kernel", "blend_bwd_bound_s")
