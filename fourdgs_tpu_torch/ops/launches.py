"""The kernel wrappers' launch counts (`.launches` on each wrapper).

A wrapper calls `count(wrapper)` where it launches its kernel. The counts
are the tracer's (utils/tracing.py): a graph capture records the launches
made on its stream, from any thread (autograd runs a backward's kernels on
its own device thread, on the forward's stream), in its program's record
and not on the wrappers, since nothing ran; a launch on any other stream
counts on its wrapper, under a lock (a training thread and a thread that
prewarms a program launch at once).
"""
from fourdgs_tpu_torch.utils.tracing import count

__all__ = ["count"]
