"""frame_busy_ms.playback (layer: captured frame; moves frame_p95_ms): the
device's busy milliseconds a frame over the traced window of a viewer
asking at a fixed rate."""
from portbench.core.readers import busy_ms_per_frame


def read(outcome, run):
    return busy_ms_per_frame(outcome)
