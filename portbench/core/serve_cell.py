"""A serving cell: one viewer asks the port for frames of a trained scene.

Set-up builds a `render/serve.py:Renderer` over the true scene at the
configuration's capacity and caps (a trained snapshot holds its gaussians
in the bucket, and its caps at the values, the driver left), runs its cap
probe (`probe_caps`) on the
path's first camera, and warms up: every distinct request of the path is
replayed once (the first capturing the frame) and the port's growth rule
(`Renderer.grow_caps`) doubles an overflowing cap until none of them drops
a pair.

A request is a camera and a timestamp on the host, as a viewer's client
sends it; it ends when the frame's bytes are in host memory: the port's
conversion rule (`viewer/network_gui.py:frame_bytes`: clipped to [0, 1],
times 255, truncated to uint8) on the device, then a copy into a pinned
host buffer of a small pool and a wait on the stream. (`frame_bytes`
itself copies into pageable memory, whose speed differs from process to
process by a third; PERF.md keeps that for the port.) The mix's `loop` says how requests come:
"closed", the next one as soon as a frame is delivered; "open", request i
due at i / `rate_hz` after the window opens, each timed from when it was
due. A frame fails if it drops a pair or holds a value that is not
finite.

A reservoir (drawn from the seed) keeps `sample_frames` delivered frames.
After the window the program is freed and the reference renders those
requests; the delivered bytes are held to the reference's by the share of
values more than one level apart and by the mean gap in levels.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import work
from portbench.core import cameras, program, scene
from portbench.core.common import Outcome, Run, reference_image
from portbench.core.trace import traced


def to_bytes(image: torch.Tensor) -> np.ndarray:
    """The reference's frame by the port's conversion rule, as uint8."""
    return (torch.clamp(image, 0, 1) * 255).to(torch.uint8).cpu().numpy()


class Reservoir:
    """A uniform sample of `k` of the frames delivered, drawn from `rng`.
    `offer` keeps the frame's buffer or not and returns the buffer that
    is free again (the one offered, or the one it replaced)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.kept: list = []

    def offer(self, request: int, buf):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((request, buf))
            return None
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            freed = self.kept[j][1]
            self.kept[j] = (request, buf)
            return freed
        return buf


def run(r: Run) -> Outcome:
    from fourdgs_tpu_torch.render.serve import Renderer, _full_float32

    dev, config, mix = r.device, r.config, r.mix
    pub, assumed = config["published"], config["assumed"]
    w, h = r.size
    cfg = program.load_config(config)
    _full_float32()
    r.mark("imports")
    truth, fixed = scene.true_scene(config, r.seed, dev)
    requests = cameras.path(assumed["rig"], mix["period"],
                            assumed["time_frames"], w, h)
    host = [program.camera(cameras.to_tensors(c, "cpu")) for c in requests]
    renderer = Renderer(
        gauss=program.gaussians(truth, False), alive=fixed["alive"],
        deform=program.deformation(cfg, truth, dev), aabb=fixed["aabb"],
        bg=fixed["bg"], raster_cfg=program.raster_config(cfg, config),
        sh_degree=pub["sh_degree"], device=dev)
    if r.fault == "altered":
        produce = renderer.render_eager

        def altered(camera, *args, **kwargs):
            out = produce(camera, *args, **kwargs)
            color = out.color.clone()
            color[:32, :32] = 1.0 - color[:32, :32]
            return out._replace(color=color)
        renderer.render_eager = altered
    renderer.probe_caps(host[0])
    r.mark("scene_and_probe")
    fails = torch.zeros((), dtype=torch.int64, device=dev)
    k = mix["sample_frames"]
    free = [torch.empty((h, w, 3), dtype=torch.uint8,
                        pin_memory=dev.type == "cuda") for _ in range(k + 1)]

    def frame(i: int):
        with record_function("replay"):
            out = renderer.render(host[i % len(host)])
        with record_function("copy_out"):
            # the port's conversion (viewer/network_gui.py:frame_bytes) on
            # the device, the bytes into pinned host memory
            u8 = (torch.clamp(out.color, 0, 1) * 255).to(torch.uint8)
            buf = free.pop()
            buf.copy_(u8, non_blocking=True)
            _sync(dev)
        nonlocal fails
        fails = fails + ((out.dropped_pairs > 0) | (out.dropped_tile > 0)
                         | ~torch.isfinite(out.color).all()).long()
        return buf

    # warm-up: every distinct request, caps grown until none drops
    grown = []
    for _ in range(8):
        dp = torch.zeros((), dtype=torch.int64, device=dev)
        dt = torch.zeros((), dtype=torch.int64, device=dev)
        for cam in host:
            out = renderer.render(cam)
            dp = torch.maximum(dp, out.dropped_pairs.long())
            dt = torch.maximum(dt, out.dropped_tile.long())
        changes = renderer.grow_caps(int(dp) > 0, int(dt) > 0)
        if not changes:
            break
        grown.append(changes)
    free.append(frame(0))
    r.mark("warmup")
    attempted = 0
    fails.zero_()
    truth = {name: v.cpu() for name, v in truth.items()}
    sample = Reservoir(k, np.random.default_rng(r.seed))
    latencies: list = []
    open_loop = mix["loop"] == "open"
    period = 1.0 / mix["rate_hz"] if open_loop else 0.0

    def serve(n_max: int | None, seconds: float | None):
        t_start = time.perf_counter()
        i = 0
        while True:
            due = t_start + i * period
            if open_loop:
                if seconds is not None and due - t_start >= seconds:
                    break
                with record_function("next_view"):
                    while time.perf_counter() < due:
                        pass
            else:
                due = time.perf_counter()
            buf = frame(i)
            done = time.perf_counter()
            latencies.append(done - due)
            freed = sample.offer(i, buf)
            if freed is not None:
                free.append(freed)
            i += 1
            if n_max is not None and i >= n_max:
                break
            if not open_loop and seconds is not None \
                    and done - t_start >= seconds:
                break
        with record_function("sync"):
            _sync(dev)
        return i, time.perf_counter() - t_start

    metrics, trace = {}, None
    captured = dev.type == "cuda"
    if not r.trace:
        setup_s = time.perf_counter() - r.t0
        frames, elapsed = serve(None, r.seconds)
        attempted += frames
        if captured:
            lat = np.sort(np.asarray(latencies))
            p95 = float(np.quantile(lat, 0.95, method="inverted_cdf"))
            print(f"frames: {frames}, latency p50 "
                  f"{1e3 * float(np.median(lat)):.4f} ms, p95 "
                  f"{1e3 * p95:.4f} ms over {len(lat)} samples",
                  flush=True)
            metrics = {"setup_s": (setup_s, "s")}
            if open_loop:
                metrics["frame_p95_ms"] = (1e3 * p95, "ms")
            else:
                metrics["render_fps"] = (frames / elapsed, "frames/s")
    else:
        def loop_fn():
            return serve(mix["trace_frames"], None)[0]
        if captured:
            frames, trace = traced(loop_fn)
        else:
            frames = loop_fn()
        attempted += frames
    failed = int(fails)
    peak = torch.cuda.max_memory_allocated(dev) if captured else 0
    capture_s, caps = renderer.capture_s, renderer.raster_cfg
    del renderer
    if captured:
        torch.cuda.empty_cache()

    # the reference after the window
    r.mark("window")
    truth = {name: v.to(dev) for name, v in truth.items()}
    gaps, off, values = 0.0, 0, 0
    for i, buf in sample.kept:
        cam = cameras.to_tensors(requests[i % len(requests)], dev)
        want = to_bytes(reference_image(truth, fixed, config, cam,
                                        r.control or "fp32"))
        if r.control:
            got = want
            want = to_bytes(reference_image(truth, fixed, config, cam,
                                            "fp32"))
        else:
            got = buf.numpy()
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        off += int((d > 1).sum())
        gaps += float(d.sum())
        values += d.size
    r.mark("reference")
    limits = r.cell["limits"]
    compared = {"off_share": (off / max(values, 1), limits["off_share"]),
                "mean_gap": (gaps / max(values, 1), limits["mean_gap"])}
    if not sample.kept:
        compared["frames_compared"] = (float("inf"), 0)

    notes = {"caps": {"tile_cap": caps.tile_cap,
                      "bin_pairs_per_chunk": caps.bin_pairs_per_chunk,
                      "grown": grown},
             "capture_s": capture_s,
             "sampled": [i for i, _ in sample.kept], "phases": r.phases}
    busy = window = breakdown = None
    if r.trace and trace is not None:
        seen = {}
        for i in range(frames):
            j = i % len(requests)
            if j not in seen:
                seen[j] = reference_image(
                    truth, fixed, config,
                    cameras.to_tensors(requests[j], dev), "fp32",
                    with_counts=True)[1]
        evs = [seen[i % len(requests)] for i in range(frames)]
        spec = scene.deform_spec(config)
        n_live = assumed["gaussians"]
        ev = sum(e.evaluated for e in evs)
        co = sum(e.contributing for e in evs)
        metrics = {"trace": trace,
                   "flops": sum(work.frame_flops(spec, n_live, e.evaluated,
                                                 e.contributing)
                                for e in evs),
                   "frames": frames,
                   "blend_fwd_bound_s": work.seconds_at_peak(
                       work.blend_fwd_flops(ev, co))}
        busy, window, breakdown = trace.busy_s, trace.window_s, \
            trace.breakdown()
    return Outcome(attempted=attempted, failed=failed, metrics=metrics,
                   compared=compared, memory_peak_bytes=peak, busy_s=busy,
                   window_s=window, breakdown=breakdown, notes=notes)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
