"""blend_fwd_roofline.serve (layer: blend forward K1; moves render_fps): the
least time of the traced frames' blend forward at the float32 peak
(work.blend_fwd_flops of the evaluations the reference counts) over the
device time of the records named blend_fwd_kernel, in %."""
from portbench.core.readers import roofline


def read(outcome, run):
    return roofline(outcome, "blend_fwd_kernel", "blend_fwd_bound_s")
