"""step_mfu.train (layer: step; moves train_rays_per_s): the FLOPs the
traced steps need (work.step_flops) over the window times the float32 peak,
in %."""
from portbench.core.readers import mfu


def read(outcome, run):
    return mfu(outcome)
