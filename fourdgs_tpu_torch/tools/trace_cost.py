"""What the tracer's device marks cost on the card (utils/tracing.py): the
same training step and the same frame captured with marks
(`tracing.MARKS` on) and without, replayed in turns in one process, each
turn's replays timed by CUDA events; the host's microseconds a graph
launch takes, marks on and off, without and under torch.profiler (whose
device tracing records every kernel of a replay); what the host spans
of a frame cost with no profiler; and each host phase of a frame and a
step with no profiler, the calls made back to back (as a warm-up loop
makes them) and each after a synchronize (as a caller that waits for
each result makes them): a copy from the host's pageable memory, such as
the camera's in `frame.camera_in`, first waits for the stream to drain.

    python -m fourdgs_tpu_torch.tools.trace_cost [--rounds 7] \\
        [--replays 20] [--points 100000] [--size 800]

The operating point is tools/bench.py's (100k points, 800x800, the
D-NeRF deformation width, batch 1). Each round replays each program
`--replays` times per mode, the mode that goes first alternating by round.
Prints each round's device ms a replay by program and mode, the medians,
the marks each program holds, the host spans' microseconds a frame, each
host phase's microseconds by root and mode, the card and its power limit;
the last line is JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from fourdgs_tpu_torch.render.serve import Renderer, _full_float32
from fourdgs_tpu_torch.tools.bench import card_limit, operating_point
from fourdgs_tpu_torch.train import graphs, loop
from fourdgs_tpu_torch.utils import tracing

def _timed(fn, n: int) -> float:
    """Device ms a call of `fn` over n calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def launch_us(programs: dict, n: int, rounds: int) -> dict:
    """Median host microseconds of one graph launch of each program, each
    launch after a synchronize, the programs in turns by round."""
    us: dict = {k: [] for k in programs}
    for r in range(rounds):
        keys = list(programs) if r % 2 == 0 else list(programs)[::-1]
        for k in keys:
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                programs[k].replay()
                us[k].append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in us.items()}


def host_spans_us(n: int = 100_000) -> float:
    """Microseconds a frame's five host spans take with no profiler."""
    now = tracing.now
    t0 = time.perf_counter()
    for _ in range(n):
        h = tracing.HostSpans("frame")
        h.lap(now())
        h.lap(now())
        h.lap(now())
        h.lap(now())
        h.lap(now())
        h.close(-1)
    return 1e6 * (time.perf_counter() - t0) / n


def phases_us(calls: dict, n: int) -> dict:
    """Host microseconds of each phase of a call (tracing.PHASES) with no
    profiler, by root: `calls[root]` made n times back to back, and n
    times each after a synchronize."""
    out: dict = {}
    for root, fn in calls.items():
        for mode in ("back_to_back", "synchronized"):
            torch.cuda.synchronize()
            ns0, calls0 = tracing.host_totals()
            for _ in range(n):
                if mode == "synchronized":
                    torch.cuda.synchronize()
                fn()
            torch.cuda.synchronize()
            ns1, calls1 = tracing.host_totals()
            k = calls1[root] - calls0.get(root, 0)
            out[f"{root}.{mode}"] = {
                name: (ns1[name] - ns0.get(name, 0)) / 1e3 / k
                for name in tracing.PHASES[root]}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=7)
    parser.add_argument("--replays", type=int, default=20)
    parser.add_argument("--points", type=int, default=100_000)
    parser.add_argument("--size", type=int, default=800)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_cost measures the card; no CUDA device")
    dev = torch.device("cuda", 0)
    _full_float32()
    state, tx, rc, cams, gts, bg, key, sh = operating_point(
        args.points, args.size, dev)
    step_fn = loop.step_of_key(tx)
    calls, marks, programs, renderers = {}, {}, {}, {}
    saved = tracing.MARKS
    try:
        for on in (True, False):
            tracing.MARKS = on
            mode = "marks" if on else "none"
            st = state.to(dev)
            steps = graphs.StepPrograms(step_fn)
            steps.run(key, st, cams, gts, bg, sh)       # the capture
            calls["step", mode] = (lambda s=steps, t=st: s.run(
                key, t, cams, gts, bg, sh))
            rend = Renderer(
                gauss=st.params["gauss"], alive=st.alive,
                deform=st.params["deform"], aabb=st.aabb, bg=bg,
                raster_cfg=dataclasses.replace(rc), sh_degree=3, device=dev)
            with torch.no_grad():
                rend.render(cams[0])                     # the capture
            calls["frame", mode] = (lambda r=rend: r.render(cams[0]))
            renderers[mode] = rend
            programs["step", mode] = steps.live.program
            programs["frame", mode] = next(iter(
                rend.frames.values())).program
            opens = [programs["step", mode].record.opens,
                     programs["frame", mode].record.opens]
            marks["step", mode], marks["frame", mode] = (
                0 if o is None else len(o) for o in opens)
    finally:
        tracing.MARKS = saved
    for fn in calls.values():                            # warm-up
        _timed(fn, 3)
    ms = {k: [] for k in calls}
    for r in range(args.rounds):
        for prog in ("step", "frame"):
            order = ("marks", "none") if r % 2 == 0 else ("none", "marks")
            for mode in order:
                ms[prog, mode].append(_timed(calls[prog, mode],
                                             args.replays))
        print(f"round {r}: " + ", ".join(
            f"{p} {m} {v[-1]:.4f} ms" for (p, m), v in ms.items()),
            flush=True)
    med = {f"{p}.{m}": statistics.median(v) for (p, m), v in ms.items()}
    host_cam = cams[0].to("cpu")
    launches = {"unprofiled": launch_us(programs, args.replays, 4)}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        launches["profiled"] = launch_us(programs, args.replays, 4)
    print("launch us: " + json.dumps({k: {f"{p}.{m}": v for (p, m), v
                                          in d.items()}
                                      for k, d in launches.items()}),
          flush=True)
    out = {"rounds": args.rounds, "replays": args.replays,
           "ms": {f"{p}.{m}": v for (p, m), v in ms.items()},
           "median_ms": med,
           "cost_pct": {p: 100.0 * (med[f"{p}.marks"] - med[f"{p}.none"])
                        / med[f"{p}.none"] for p in ("step", "frame")},
           "marks": {f"{p}.{m}": v for (p, m), v in marks.items()},
           "launch_us": {k: {f"{p}.{m}": v for (p, m), v in d.items()}
                         for k, d in launches.items()},
           "host_spans_us_per_frame": host_spans_us(),
           # the frame from a camera in the host's memory, as a viewer's
           # request comes
           "phases_us": phases_us(
               {"frame": lambda: renderers["marks"].render(host_cam),
                "step": calls["step", "marks"]}, args.replays),
           "device": torch.cuda.get_device_name(dev),
           "card": card_limit(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
