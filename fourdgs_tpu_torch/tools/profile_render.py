"""Where a served frame's time goes on the card: render a snapshot's
look-at orbit once untimed, once timed, and once under torch.profiler,
and print the device's busy share, the launches and CUDA runtime calls
per frame, each render span's device time, and the kernels that take the
most device time. `profile_calls` does the same for any call
(chip_smoke.py profiles training steps with it).

    python -m fourdgs_tpu_torch.tools.profile_render -m output/scene \
        --frames 24

A replayed frame (the Renderer's default on the card) reports its spans
as the tracer's segments (utils/tracing.py): device milliseconds a frame
between the marks its capture holds, each segment's parent, and the
first-to-last time; and its host spans (`frame.*`). An eager frame opens
the spans as `record_function` ranges, reported with their host time,
device range and kernel time as before. The CLI profiles both ways. The
last line is the report as JSON.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import math
import time

import torch

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.render.serve import Renderer, orbit_cameras
from fourdgs_tpu_torch.utils import tracing


# the render path's spans (render/render.py, models/hexplane.py,
# models/deformation.py, ops/rasterize_tiled.py; raster.pack opens inside
# raster.blend, in ops/blend.py)
SPANS = ("render.splats", "splats.hexplane", "splats.heads",
         "raster.project", "raster.bin", "raster.pack", "raster.blend",
         "raster.compose")
# the training step's (train/loop.py; the blend's backward in ops/blend.py
# runs inside train.backward)
TRAIN_SPANS = SPANS + ("train.forward", "train.loss", "train.regulariser",
                       "train.backward", "raster.blend_backward",
                       "train.adam", "train.stats")
# CUDA runtime calls counted per frame: a stream synchronize is a host wait
# on the device (a `.item()`, a copy from the host's pageable memory, a
# data-dependent size); a captured step or frame is one cudaGraphLaunch
# (train/graphs.py) and the device-to-device copies of its inputs
_RUNTIME_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaMemcpyAsync", "cudaLaunchKernel", "cuLaunchKernel",
                  "cuLaunchKernelEx", "cudaGraphLaunch")
# the copies the device ran, by direction (their activity names read
# "Memcpy HtoD (Pageable -> Device)" and the like)
_COPY_KINDS = ("HtoD", "DtoH", "DtoD")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_calls(fn, n: int, spans=SPANS, top: int = 12,
                  label: str = "frame") -> dict:
    """Run `fn` n times under torch.profiler on the card and print, per
    call: the device's busy share of the wall time, the kernel launches
    and CUDA runtime calls, each span's host time, device range (first to
    last kernel, gaps included) and kernel time where the calls are eager,
    the tracer's segments and host spans where they replay programs
    rooted at `label` ("frame", "step"), and the kernels that take the
    most device time. The profiler's own cost inflates the host times;
    compare the unprofiled time of the same calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    # device-side copies of the spans (user annotations) are not kernels
    kernels = sorted((e for e in on_dev if e.name not in spans),
                     key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in kernels]
    busy_us = _busy_us((e.time_range.start, e.time_range.end)
                       for e in kernels)

    def kernel_us_in(r) -> float:
        i = bisect.bisect_left(starts, r.start)
        j = bisect.bisect_right(starts, r.end)
        return sum(min(e.time_range.end, r.end) - e.time_range.start
                   for e in kernels[i:j])

    span_report = {}
    for name in spans:
        host = [e.time_range for e in events
                if e.name == name and e.device_type == DeviceType.CPU]
        rng = [e.time_range for e in on_dev if e.name == name]
        span_report[name] = {
            "host_ms": sum(r.elapsed_us() for r in host) / n / 1e3,
            "device_range_ms": sum(r.elapsed_us() for r in rng) / n / 1e3,
            "kernel_ms": sum(map(kernel_us_in, rng)) / n / 1e3}
    # the replays' segments and host spans, from the tracer's records of
    # this session (none for eager calls)
    segments = tracing.segment_ms(label)
    session = tracing.last_session()
    host_spans: dict = {}
    for h in tracing.REG.host_events:
        if h.session == session and h.root == label:
            for name, a, b in h.events():
                host_spans[name] = host_spans.get(name, 0.0) + (b - a) / 1e6
    host_spans = {k: v / n for k, v in host_spans.items()}
    calls = {c: sum(e.name == c for e in events) / n for c in _RUNTIME_CALLS}
    copies = {k: sum(e.name.startswith("Memcpy") and k in e.name
                     for e in on_dev) / n for k in _COPY_KINDS}
    by_kernel: dict[str, list[float]] = {}
    for e in kernels:
        by_kernel.setdefault(e.name, []).append(e.time_range.elapsed_us())
    report = {
        label + "s": n,
        f"wall_ms_per_{label}": wall_us / n / 1e3,
        "device_busy_share": busy_us / wall_us,
        f"kernel_ms_per_{label}": sum(map(sum, by_kernel.values())) / n / 1e3,
        f"kernel_launches_per_{label}": len(kernels) / n,
        f"runtime_calls_per_{label}": {c: v for c, v in calls.items() if v},
        f"device_copies_per_{label}": copies,
        "spans": span_report,
        "segments_ms": segments,
        "segment_parents": _parents(label, session),
        "host_spans_ms": host_spans,
        "top_kernels": [
            {"name": name[:90], f"ms_per_{label}": sum(d) / n / 1e3,
             f"calls_per_{label}": len(d) / n}
            for name, d in sorted(by_kernel.items(),
                                  key=lambda kv: -sum(kv[1]))[:top]],
    }
    print(f"profile: {n} {label}s, {report[f'wall_ms_per_{label}']:.3f} "
          f"ms/{label} under the profiler; device busy "
          f"{100 * report['device_busy_share']:.1f}%; kernels "
          f"{report[f'kernel_ms_per_{label}']:.3f} ms/{label} in "
          f"{report[f'kernel_launches_per_{label}']:.1f} launches; runtime "
          f"calls per {label} {report[f'runtime_calls_per_{label}']}; "
          f"device copies per {label} {copies}")
    for k, v in span_report.items():
        if v["host_ms"]:
            print(f"  span {k:22s} host {v['host_ms']:8.3f} ms  device "
                  f"range {v['device_range_ms']:8.3f} ms  kernels "
                  f"{v['kernel_ms']:8.3f} ms")
    for k, v in sorted(segments.items(), key=lambda kv: -kv[1]):
        print(f"  segment {str(k):30s} {v:8.4f} ms/{label}")
    for k, v in host_spans.items():
        print(f"  host span {k:22s} {v:8.4f} ms/{label}")
    for k in report["top_kernels"]:
        print(f"  kernel {k[f'ms_per_{label}']:8.4f} ms x"
              f"{k[f'calls_per_{label}']:6.1f}  {k['name']}")
    print("profile json: " + json.dumps(report))
    return report


def _parents(root: str, session: int) -> dict:
    """Each segment's parent span, from the records of the session's
    replays of programs rooted at `root`."""
    out: dict = {}
    for row in tracing.rows(session):
        if row.record.root == root:
            out.update({str(k): v for k, v in row.record.tree.items()})
    return out


def profile_frames(renderer: Renderer, cams: list[Camera],
                   top: int = 12) -> dict:
    """`profile_calls` over one render of each of `cams`."""
    if renderer.device.type != "cuda":
        raise RuntimeError("profile_frames measures the card; the renderer "
                           f"is on {renderer.device}")
    it = iter(cams)
    return profile_calls(lambda: renderer.render(next(it)), len(cams),
                         top=top)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=800)
    args = parser.parse_args(argv)

    renderer = Renderer.from_snapshot(args.model_path, args.iteration,
                                      width=args.width, height=args.height)
    dev = renderer.device
    cams = orbit_cameras(args.frames, dev)
    modes = {"replayed": renderer,
             "eager": dataclasses.replace(renderer, capture=False)}
    for name, r in modes.items():
        for c in cams:                           # warm-up, untimed
            r.render(c)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for c in cams:
            r.render(c)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        print(f"device: {torch.cuda.get_device_name(dev)}; {name} frames: "
              f"{len(cams)}; {1e3 * seconds / len(cams):.3f} ms/frame "
              f"unprofiled")
    report = {}
    for name, r in modes.items():
        print(f"{name} frames:")
        report[name] = profile_frames(r, cams)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
