"""The tracer's device marks (fourdgs_tpu_torch/utils/tracing.py,
csrc/trace.cu) in captured frames and steps on the card.

Every test is marked `gpu` and takes the `cuda` fixture, which skips it
when no CUDA device is present (decided when the test runs, never at
import). Run them on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_tracing_gpu.py -q
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.train import graphs
from fourdgs_tpu_torch.utils import tracing
# tests/ is on sys.path under pytest (no __init__.py: "prepend" import)
from test_torch_graphs_gpu import _degree, _renderer, _step_state

# a mark lies within the profiler's records of its replay's first and last
# kernel by this much (microseconds)
ALIGN_US = 20.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracing.reset()
    yield torch.device("cuda", 0)
    tracing.reset()


def _frames(dev, n):
    rend = _renderer(dev, capture=True)
    cams = [look_at_camera(theta=0.4 * i, time=i / 5, device=dev)
            for i in range(n)]
    return rend, cams


@pytest.mark.gpu
def test_captured_frame_and_step_fill_one_row_a_replay(cuda):
    """Each replay of a captured frame and of a captured step fills one
    row of the device ring, whose counter moves on once a replay; every
    row's segments sum to its first-to-last time, in order of launch."""
    rend, cams = _frames(cuda, 5)
    for c in cams:
        rend.render(c)
    st, step_fn, key, scams, gt, bg = _step_state(cuda, batch=2)
    steps = graphs.StepPrograms(step_fn)
    sh = _degree(cuda)
    for _ in range(3):
        steps.run(key, st, scams, gt, bg, sh)
    got = tracing.rows()
    assert [r.record.root for r in got] == ["frame"] * 5 + ["step"] * 3
    assert [r.replay for r in got] == list(range(8))
    ring = tracing.REG.rings[0]
    assert int(ring.counter) == ring.replays == 8
    for r in got:
        segs = r.segments()
        assert sum(segs.values()) == r.first_to_last_ns > 0
        assert r.times == sorted(r.times)
    assert {"splats.hexplane/backward", "raster.blend_backward",
            "train.adam"} <= set(got[-1].segments())
    steps.close()


@pytest.mark.gpu
def test_replays_with_marks_never_sync(cuda):
    """With the tracer on, a replayed frame and a replayed step wait on
    nothing: under sync debug mode "error" any host sync raises."""
    rend, cams = _frames(cuda, 3)
    st, step_fn, key, scams, gt, bg = _step_state(cuda)
    steps = graphs.StepPrograms(step_fn)
    sh = _degree(cuda)
    rend.render(cams[0])
    steps.run(key, st, scams, gt, bg, sh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in cams:
            rend.render(c)
        for _ in range(3):
            steps.run(key, st, scams, gt, bg, sh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(tracing.rows()) == len(cams) + 1 + 4
    steps.close()


@pytest.mark.gpu
def test_marks_fall_within_their_replays_kernels(cuda, tmp_path):
    """Under torch.profiler, each profiled replay's marks, put on the
    profiler's clock by the stamp kernels' own records (`tracing.align`),
    bound the replay's other work within ALIGN_US: the first mark at or
    before the start of its first kernel, the last at or after the end of
    its last, and none before its graph launch's runtime call began. The
    replay's kernels are picked apart from the stamps: the device records
    that carry its launch's correlation id. Once the profiler has stopped,
    the readers split each replay into work and idle by its records."""
    rend, cams = _frames(cuda, 4)
    rend.render(cams[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in cams:
            rend.render(c)
        torch.cuda.synchronize()
    got = tracing.rows(tracing.last_session())
    assert len(got) == len(cams)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    launches = sorted((e for e in events
                       if e.get("name", "").startswith("cudaGraphLaunch")),
                      key=lambda e: e["ts"])
    assert len(launches) == len(cams)
    device = [e for e in events if e.get("cat") in tracing.DEVICE_CATS]
    stamps = [e["ts"] for e in device if tracing.STAMP_KERNEL in e["name"]]
    assert tracing.align(got, stamps) == len(got)
    for row, launch in zip(got, launches):
        corr = launch["args"]["correlation"]
        work = [e for e in device if tracing.STAMP_KERNEL not in e["name"]
                and e.get("args", {}).get("correlation") == corr]
        assert work
        first = min(e["ts"] for e in work)
        last = max(e["ts"] + e["dur"] for e in work)
        marks = [row.zero + t / 1e3 for t in row.times]
        assert min(marks) <= first + ALIGN_US
        assert max(marks) >= last - ALIGN_US
        assert min(marks) >= launch["ts"] - ALIGN_US
    assert tracing.REG.profiler is prof
    segs = tracing.segment_ms("frame")
    assert tracing.IDLE in segs and segs["raster.bin"] > 0
    assert sum(v for k, v in segs.items() if k != "first_to_last") == \
        pytest.approx(segs["first_to_last"], rel=1e-9)
    # the host spans of the same frames carry the same replay numbers
    numbers = {h.replay for h in tracing.REG.host_events
               if h.session == tracing.last_session()}
    assert numbers == {r.replay for r in got}
