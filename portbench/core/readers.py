"""What the per-layer metric files (metrics/<name>.py) read from a traced
run's outcome. Each returns None where the run kept nothing to read (no
device record, no kernel of the name): the harness then leaves the metric
out of the line, and never reports a share of a peak as 0."""
from __future__ import annotations

from portbench.core.peaks import FP32_FLOP_S


def _trace(outcome):
    return outcome.metrics.get("trace") if outcome.metrics else None


def idle_pct(outcome):
    """100 x (1 - busy / window) over the traced window."""
    t = _trace(outcome)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(outcome):
    """The FLOPs the window's work needs (work.py) over the window's
    length times the float32 peak, in %."""
    t = _trace(outcome)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * outcome.metrics["flops"] / (t.window_s * FP32_FLOP_S)


def roofline(outcome, kernel: str, bound: str):
    """The kernel's least time at the peak (work.py's count) over its
    device time in the window, in %."""
    t = _trace(outcome)
    if t is None:
        return None
    spent = t.device_s(kernel)
    if not spent:
        return None
    return 100.0 * outcome.metrics[bound] / spent


def busy_ms_per_frame(outcome):
    """The device's busy ms a frame over the traced window."""
    t = _trace(outcome)
    frames = outcome.metrics.get("frames") if outcome.metrics else None
    if t is None or not frames:
        return None
    return 1e3 * t.busy_s / frames
