"""The kernel wrappers' launch counts (`.launches` on each wrapper).

A wrapper calls `count(wrapper)` where it launches its kernel. A graph
capture (train/graphs.py:Program) launches nothing that runs: it counts
its launches in `recording(stream)`, which takes every launch made on the
capture's stream, from any thread (autograd runs a backward's kernels on
its own device thread, on the forward's stream), out of the wrappers'
counts and into its record. A launch on any other stream counts on its
wrapper, under a lock: a training thread and a thread that prewarms a
program launch at once.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch

_lock = threading.Lock()
# capture stream (its cuda_stream handle) -> the launches recorded into it
_recording: dict[int, collections.Counter] = {}


def count(wrapper) -> None:
    """One launch of `wrapper`'s kernel on the current stream."""
    if _recording:
        record = _recording.get(torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()))
        if record is not None:
            with _lock:
                record[wrapper.__name__] += 1
            return
    with _lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording(stream: torch.cuda.Stream):
    """The launches made on `stream` inside the block, by wrapper name,
    counted there and not on the wrappers."""
    record = collections.Counter()
    with _lock:
        if stream.cuda_stream in _recording:
            raise RuntimeError("two captures on one stream")
        _recording[stream.cuda_stream] = record
    try:
        yield record
    finally:
        with _lock:
            del _recording[stream.cuda_stream]
