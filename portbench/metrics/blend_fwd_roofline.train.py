"""blend_fwd_roofline.train (layer: blend forward K1; moves
train_rays_per_s): the least time of the traced steps' blend forwards at
the float32 peak (work.blend_fwd_flops) over the device time of the records
named blend_fwd_kernel, in %."""
from portbench.core.readers import roofline


def read(outcome, run):
    return roofline(outcome, "blend_fwd_kernel", "blend_fwd_bound_s")
