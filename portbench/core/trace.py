"""The traced window: torch.profiler over a loop of the cell's calls, read
into the numbers the per-layer metrics take.

The harness opens its own spans (`record_function`) around its calls:
`replay` (the program's step or frame), `copy_out` (the frame's bytes to
the host), `sync` (a wait on the device), `next_view` (the next request
or batch), all inside `window`. The device's busy time is the union of the
kernel, copy and set intervals within the window's span (the arithmetic of
fourdgs_tpu_torch/tools/profile_render.py:_busy_us, frozen here); the idle
gaps between them are named by the innermost harness span open at each
gap's middle, "other" where none is.
"""
from __future__ import annotations

import bisect
import dataclasses
import math

import torch

SPANS = ("replay", "copy_out", "sync", "next_view")
WINDOW = "window"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict          # device seconds by short kernel or copy name
    idle_s: dict            # idle seconds by harness span

    def device_s(self, fragment: str) -> float | None:
        """Seconds of the device records whose name holds `fragment`, or
        None where there is none."""
        hits = [v for k, v in self.kernel_s.items() if fragment in k]
        return sum(hits) if hits else None

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def short(name: str) -> str:
    """A record's name without its return type, namespaces' anonymity,
    template arguments and argument list."""
    head = name.replace("(anonymous namespace)::", "").strip()
    if head.startswith("void "):
        head = head[len("void "):]
    for stop in ("<", "("):
        head = head.split(stop)[0]
    return head.strip()[:120] or name[:120]


def traced(loop) -> tuple[object, "Trace | None"]:
    """Run `loop()` (which opens the harness's spans and ends in a sync)
    inside the `window` span under torch.profiler; returns its result and
    the Trace, None when no device record was kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            result = loop()
    events = prof.events()
    win = [e.time_range for e in events
           if e.name == WINDOW and e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in SPANS and e.name != WINDOW]
    if not win or not dev:
        return result, None
    w0, w1 = win[0].start, win[0].end
    ivals = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
             for e in dev if e.time_range.end > w0
             and e.time_range.start < w1]
    kernel_s: dict = {}
    for e in dev:
        k = short(e.name)
        kernel_s[k] = kernel_s.get(k, 0.0) + e.time_range.elapsed_us() / 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU
                   and e.name in SPANS)
    starts = [s[0] for s in spans]
    idle: dict = {}
    busy = merged(ivals)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "other"
        i = bisect.bisect_right(starts, mid)
        # the innermost span open at mid: the latest start before it
        for s, e, n in reversed(spans[max(0, i - 8):i]):
            if e >= mid:
                name = n
                break
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return result, Trace(window_s=(w1 - w0) / 1e6,
                         busy_s=busy_us(ivals) / 1e6, kernel_s=kernel_s,
                         idle_s=idle)

