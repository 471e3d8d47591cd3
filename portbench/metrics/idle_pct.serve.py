"""idle_pct.serve (layer: device; moves render_fps): the share of the
traced window of served frames in which no kernel, copy or set ran on the
card, in %."""
from portbench.core.readers import idle_pct


def read(outcome, run):
    return idle_pct(outcome)
