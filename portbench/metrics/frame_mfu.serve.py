"""frame_mfu.serve (layer: captured frame; moves render_fps): the FLOPs the
traced frames need (work.frame_flops) over the window times the float32
peak, in %."""
from portbench.core.readers import mfu


def read(outcome, run):
    return mfu(outcome)
