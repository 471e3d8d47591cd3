"""idle_pct.train (layer: device; moves train_rays_per_s): the share of
the traced window of training steps in which no kernel, copy or set ran on
the card, in %."""
from portbench.core.readers import idle_pct


def read(outcome, run):
    return idle_pct(outcome)
