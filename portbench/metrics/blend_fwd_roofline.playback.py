"""blend_fwd_roofline.playback (layer: blend forward K1; moves
frame_p95_ms): as blend_fwd_roofline.serve, over the traced frames of a
viewer asking at a fixed rate."""
from portbench.core.readers import roofline


def read(outcome, run):
    return roofline(outcome, "blend_fwd_kernel", "blend_fwd_bound_s")
