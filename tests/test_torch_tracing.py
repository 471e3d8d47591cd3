"""The port's tracer (fourdgs_tpu_torch/utils/tracing.py) on the CPU.

A capture is stood in for by a CPU ring, whose marks the stamp kernel's
plain version writes with the host's clock as the program runs once
(`_captured`): the spans, the backward marks autograd fires and the row
counter run as a captured program's do. The card's own marks, and
replays with no host sync, are tests/test_torch_tracing_gpu.py's.
"""
import json
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.render.render import render
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import graphs, loop, optim
from fourdgs_tpu_torch.utils import tracing
# tests/ is on sys.path under pytest (no __init__.py: "prepend" import)
from test_torch_graphs import _cfg, _state

torch.set_num_threads(1)

# every layer span of the step, forward, and those whose outputs carry a
# gradient, backward
STEP_SPANS = ("step", "train.forward", "render.splats", "splats.hexplane",
              "splats.heads", "raster.project", "raster.bin", "raster.blend",
              "raster.pack", "raster.compose", "train.loss",
              "train.regulariser", "train.backward", "raster.blend_backward",
              "train.adam", "train.stats")
BACKWARDS = ("splats.hexplane", "splats.heads", "raster.project",
             "raster.blend", "raster.compose", "train.loss",
             "train.regulariser")
# the spans the eager path opened before the tracer, by name
EAGER_SPANS = ("render.splats", "raster.project", "raster.bin",
               "raster.pack", "raster.blend", "raster.compose",
               "train.forward", "train.backward", "raster.blend_backward",
               "train.adam", "train.stats")


@pytest.fixture
def tracer(monkeypatch):
    tracing.reset()
    monkeypatch.setattr(tracing, "_stream", lambda: 0)
    yield tracing
    tracing.reset()


def _captured(root, fn):
    """Run `fn` once as a traced program on the CPU ring; returns its
    record (one replay tagged) and `fn`'s result."""
    rec = tracing.program("test " + root, root)
    with tracing.capturing(types.SimpleNamespace(cuda_stream=0), root,
                           torch.device("cpu")) as cap:
        tracing.begin(cap)
        out = fn()
        tracing.end(cap, rec)
    tracing.replayed(rec)
    return rec, out


def _step(batch):
    cfg = _cfg()
    st = _state(cfg)
    tx = optim.build_optimizer(cfg.opt, 1.0)
    st.opt_state = tx.init(st.params)
    rc = tconfig.raster_config_from(cfg, 32, 32)
    key = graphs.StepKey("fine", st.capacity, rc, True, batch, 0.2,
                         (0.01, 1e-4, 1e-4), graphs.switches())
    cams = [look_at_camera(theta=0.3 * i, time=i / 3, device="cpu")
            for i in range(batch)]
    gts = torch.rand((batch, 32, 32, 3),
                     generator=torch.Generator().manual_seed(1))
    sh = torch.full((), 1, dtype=torch.int32)
    fn = loop.step_of_key(tx)(key)
    return lambda: fn(st, cams, gts, torch.zeros(3), sh), st


def test_segments_sum_to_first_to_last():
    """Each interval from a mark to the next in time belongs to the
    segment the first opens; ties keep launch order; the sum is the
    replay's first-to-last time."""
    opens = ["step", "a", "step", "a/backward", None]
    times = [100, 130, 180, 180, 260]
    assert tracing.segments(times, opens) == {"step": 30 + 0, "a": 50,
                                              "a/backward": 80}
    assert sum(tracing.segments(times, opens).values()) == 160


def test_interleaved_backward_segments():
    """Batch 2's backward marks come in whatever order autograd runs the
    two cameras: columns are launch order, times decide; every interval
    is attributed once and the segments sum to first-to-last."""
    opens = ["step", "fwd", "step", "train.backward", "blend/backward",
             "blend/backward", "hexplane/backward", "hexplane/backward",
             "step", None]
    # camera 2's backward marks (columns 5, 7) ran before camera 1's
    times = [0, 10, 40, 45, 70, 50, 95, 60, 120, 130]
    segs = tracing.segments(times, opens)
    assert segs == {"step": 10 + 5 + 10, "fwd": 30, "train.backward": 5,
                    "blend/backward": 10 + 25, "hexplane/backward": 10 + 25}
    assert sum(segs.values()) == max(times) - min(times)


@pytest.mark.parametrize("batch", [1, 2])
def test_captured_step_marks_every_layer(tracer, batch):
    """A traced step's row holds a segment for every layer span, forward
    and backward (batch 2: both cameras' backwards interleave), the
    segments sum to its first-to-last time, and the span tree names each
    segment's parent; the marks change nothing the step computes."""
    fn, st = _step(batch)
    rec, aux = _captured("step", fn)
    (row,) = tracing.rows()
    segs = row.segments()
    assert set(STEP_SPANS) <= set(segs)
    assert {s + tracing.BACKWARD for s in BACKWARDS} <= set(segs)
    assert sum(segs.values()) == row.first_to_last_ns > 0
    assert rec.opens.count("splats.hexplane") == batch
    assert rec.tree["splats.hexplane"] == "render.splats"
    assert rec.tree["render.splats"] == "train.forward"
    assert rec.tree["train.forward"] == "step"
    assert rec.tree["splats.hexplane/backward"] == "train.backward"
    assert rec.tree["raster.blend_backward"] == "train.backward"
    want_fn, want_st = _step(batch)
    want = want_fn()
    assert torch.equal(aux.loss, want.loss)
    for a, b in zip(optim.param_leaves(st.params),
                    optim.param_leaves(want_st.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_captured_frame_marks_its_layers(tracer):
    """A traced frame (no gradient) marks the forward spans only."""
    fn, st = _step(1)
    cam = look_at_camera(device="cpu")
    rc = tconfig.raster_config_from(_cfg(), 32, 32)

    def frame():
        with torch.no_grad():
            p = st.params
            return render(p["gauss"], p["deform"], cam, torch.zeros(3), rc,
                          st.aabb, st.alive, 1)
    rec, _ = _captured("frame", frame)
    (row,) = tracing.rows()
    segs = row.segments()
    assert {"frame", "render.splats", "splats.hexplane", "splats.heads",
            "raster.project", "raster.bin", "raster.blend",
            "raster.compose"} <= set(segs)
    assert not any(tracing.BACKWARD in k for k in segs)
    assert tracing.device_ms("frame", ("raster.bin",)) is None  # unprofiled


def test_marks_off_record_launches_only(tracer, monkeypatch):
    """With MARKS off a capture keeps its launches and no layout: its
    replays tag no row."""
    monkeypatch.setattr(tracing, "MARKS", False)
    rec, _ = _captured("step", _step(1)[0])
    assert rec.opens is None and rec.ring is None
    assert tracing.replayed(rec) == -1 and not tracing.rows()


def test_ring_wraps_and_counts_what_it_lost(tracer, monkeypatch):
    """A ring of 4 rows keeps the last 4 replays; the earlier ones are
    counted as lost and never read."""
    monkeypatch.setattr(tracing, "ROWS", 4)
    tracing.REG.rings.clear()
    try:
        rec, _ = _captured("frame", lambda: None)
        for _ in range(5):       # the capture's run stood for replay 0
            tracing.replayed(rec)
        assert tracing.lost() == 2
        got = tracing.rows()
        assert [r.replay for r in got] == [2, 3, 4, 5]
    finally:
        tracing.REG.rings.clear()


def test_profiled_replays_are_tagged_with_their_session(tracer):
    """Replays under a profiler carry its session's number, others 0; the
    session's first call opens the anchor range, which launches nothing;
    the readers take the last session's replays alone."""
    rec, _ = _captured("frame", lambda: None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.replayed(rec)
        tracing.replayed(rec)
    tracing.replayed(rec)
    assert [r.session for r in tracing.rows()] == [0, 1, 1, 0]
    assert len(tracing.rows(tracing.last_session())) == 2
    anchors = [e for e in prof.events() if e.name == tracing.ANCHOR]
    assert len(anchors) == 1
    assert anchors[0].device_type == DeviceType.CPU
    assert tracing.device_ms("frame", ("frame",)) is not None
    assert tracing.device_ms("step", ("frame",)) is None


def test_host_spans_count_and_keep_their_parent(tracer, monkeypatch):
    """Host spans add their nanoseconds to their counters always (summed
    a batch of calls at a time), and under a profiler are kept with their
    root and replay number, on the profiler's clock through the
    anchor."""
    monkeypatch.setattr(tracing, "FLUSH", 3)
    for _ in range(4):
        h = tracing.HostSpans("frame")
        for _ in tracing.PHASES["frame"]:
            h.lap(tracing.now())
        h.close(7)
    assert len(tracing.REG.pending["frame"]) == 1     # three were summed
    ns, calls = tracing.host_totals()
    assert calls == {"frame": 4} and not tracing.REG.pending["frame"]
    assert set(ns) == set(tracing.PHASES["frame"])
    assert all(v >= 0 for v in ns.values())
    assert not tracing.REG.host_events and tracing.host_ms("frame") is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        h = tracing.HostSpans("step")
        for _ in tracing.PHASES["step"]:
            h.lap(tracing.now())
        h.close(3)
    (rec,) = tracing.REG.host_events
    assert (rec.root, rec.replay) == ("step", 3)
    events = rec.events()
    assert [e[0] for e in events] == list(tracing.PHASES["step"])
    assert all(a <= b for _, a, b in events)
    # a call's own phases: every one but the launch
    assert tracing.host_ms("step") == pytest.approx(
        sum(b - a for name, a, b in events if name != "step.launch") / 1e6)
    anchor = [e for e in prof.events() if e.name == tracing.ANCHOR][0]
    host = anchor.time_range.start - tracing.REG.anchors[-1] / 1e3
    # the first span began after the anchor opened, within the session
    start = host + events[0][1] / 1e3
    assert 0.0 <= start - anchor.time_range.start < 1e4


def test_each_replay_is_aligned_by_its_own_stamps(tracer):
    """align() matches the stamp kernels' records, last with last, with
    the marks in order and gives each replay the median offset of its own
    marks: a step between the card's timer and the profiler's clock
    between two replays moves the second replay's offset alone. Earlier
    records (replays the ring has since overwritten) are passed over; a
    replay short of a record, or whose records stray past ALIGN_US, stays
    unaligned."""
    rec = tracing.program("frame x", "frame")
    got = [tracing.Row(rec, 0, 1, [1_000_000, 3_000_000, 4_000_000]),
           tracing.Row(rec, 1, 1, [10_000_000, 12_000_000, 13_000_000])]
    stamps = ([500 + t / 1e3 for t in got[0].times]
              + [850 + t / 1e3 for t in got[1].times])
    assert tracing.align(got, stamps[::-1]) == 2
    assert [r.zero for r in got] == [500.0, 850.0]
    lost = [100.0, 200.0, 300.0]         # a replay overwritten on the ring
    assert tracing.align(got, lost + stamps) == 2
    assert [r.zero for r in got] == [500.0, 850.0]
    assert tracing.align(got, stamps[1:]) == 1
    assert [r.zero for r in got] == [None, 850.0]
    stray = stamps[:4] + [stamps[4] + 2 * tracing.ALIGN_US + 1] + stamps[5:]
    assert tracing.align(got, stray) == 1
    assert [r.zero for r in got] == [500.0, None]


def test_device_records_split_each_segment_into_work_and_idle():
    """With the device's merged records, each segment keeps the part of
    its interval they cover and IDLE takes the rest; the segments still
    sum to first-to-last."""
    busy = tracing.merged([(1.0, 4.0), (3.0, 6.0), (9.0, 10.0)])
    assert busy == ([1.0, 9.0], [6.0, 10.0])
    assert tracing.covered_us(busy, 0.0, 2.0) == 1.0
    assert tracing.covered_us(busy, 5.0, 9.5) == 1.5
    assert tracing.covered_us(busy, 6.0, 9.0) == 0.0
    rec = tracing.program("frame x", "frame")
    rec.opens = ["frame", "a", "frame", None]
    # marks at 0, 2, 8, 10 us of the row's timer; its 0 at 0 us
    row = tracing.Row(rec, 0, 1, [0, 2_000, 8_000, 10_000], zero=0.0)
    segs = row.segments(busy)
    assert segs == pytest.approx({"frame": 1_000 + 1_000, "a": 4_000,
                                  tracing.IDLE: 1_000 + 2_000 + 1_000})
    assert sum(segs.values()) == pytest.approx(row.first_to_last_ns)
    assert row.segments() == {"frame": 4_000, "a": 6_000}


def test_readers_take_the_work_from_the_held_profilers_records(tracer):
    """The session's first call keeps the profiler its caller holds; once
    it has stopped, segment_ms and device_ms read each aligned replay's
    work by segment from its device records, the idle apart."""
    rec, _ = _captured("frame", lambda: None)
    rec.opens = ["frame", "raster.bin", "frame", None]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        n = tracing.replayed(rec)
    assert tracing.REG.profiler is prof
    marks = [0, 2_000, 8_000, 10_000]
    tracing.REG.rings[-1].ring[n, :4] = torch.tensor(marks)
    assert tracing.segment_ms("frame")["raster.bin"] == pytest.approx(
        0.006)                 # a CPU session keeps no device record

    def event(name, a, b):
        return types.SimpleNamespace(
            name=name, device_type=DeviceType.CUDA, is_user_annotation=False,
            time_range=types.SimpleNamespace(start=a, end=b))
    stamps = [event(tracing.STAMP_KERNEL, 50.0 + m / 1e3, 50.5 + m / 1e3)
              for m in marks]
    kernels = [event("k", 51.0, 52.0), event("k", 53.0, 57.0),
               event("k", 59.0, 60.0)]
    annotation = event("replay", 40.0, 70.0)
    annotation.is_user_annotation = True
    tracing.REG.profiler = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=object()),
        events=lambda: stamps + kernels + [annotation])
    segs = tracing.segment_ms("frame")
    # raster.bin's interval 52..58 us: stamp 52.0-52.5, kernel 53-57; the
    # root's 50..52 and 58..60: a stamp and a kernel's 1 us each
    assert segs["raster.bin"] == pytest.approx(0.0045)
    assert segs["frame"] == pytest.approx(0.003)
    assert segs[tracing.IDLE] == pytest.approx(0.0025)
    assert sum(v for k, v in segs.items() if k != "first_to_last") == \
        pytest.approx(segs["first_to_last"]) == pytest.approx(0.010)
    assert tracing.device_ms("frame", ("raster.bin",)) == pytest.approx(
        0.0045)


def test_a_call_that_laps_other_than_its_phases_is_refused(tracer):
    h = tracing.HostSpans("frame")
    h.lap(tracing.now())
    h.close(-1)
    with pytest.raises(RuntimeError, match="lapped"):
        tracing.host_totals()


def test_eager_path_opens_the_same_spans(tracer):
    """An eager step (no capture) opens the record_function ranges it
    opened before the tracer, now with the new layers' beside them, and
    launches no mark."""
    fn, _ = _step(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = {e.name for e in prof.events()}
    assert set(EAGER_SPANS) <= names
    assert {"splats.hexplane", "splats.heads", "train.loss",
            "train.regulariser"} <= names
    assert not tracing.REG.rings or not tracing.rows()


def test_launch_counts_fold_into_records(tracer):
    """kernel_runs() is the wrappers' launches plus each record's launches
    times its replays since zero_counts()."""
    rec = tracing.program("frame x", "frame")
    rec.launches = {"blend_forward": 1, "gather_rows": 36}
    graphs.zero_counts()
    for _ in range(3):
        tracing.replayed(rec)
    runs = graphs.kernel_runs()
    assert runs["blend_forward"] == 3 and runs["gather_rows"] == 108
    graphs.zero_counts()
    assert graphs.kernel_runs()["gather_rows"] == 0
    assert tracing.summary()["programs"][0]["replays"] == 3


def test_export_puts_host_spans_into_the_chrome_trace(tracer, tmp_path):
    """export() writes the profiler's Chrome trace with the session's host
    spans beside its records, on its clock (through the anchor), each
    with its parent and replay; device segments need the stamp kernels'
    records, which a CPU session has none of."""
    rec, _ = _captured("frame", lambda: None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            h = tracing.HostSpans("frame")
            for _ in tracing.PHASES["frame"]:
                h.lap(tracing.now())
            h.close(tracing.replayed(rec))
    path = tmp_path / "trace.json"
    added = tracing.export(prof, str(path))
    assert added == {"host_spans": 10, "segments": 0, "rows": 2,
                     "aligned": 0}
    events = json.loads(path.read_text())["traceEvents"]
    anchor = [e for e in events if e.get("name") == tracing.ANCHOR][0]
    spans = [e for e in events if e.get("tid") == "host spans"]
    assert [e["name"] for e in spans] == list(tracing.PHASES["frame"]) * 2
    assert [e["args"]["replay"] for e in spans] == [1] * 5 + [2] * 5
    assert all(e["args"]["parent"] == "frame" for e in spans)
    assert all(0 <= e["ts"] - anchor["ts"] < 1e5 for e in spans)


def test_export_aligns_the_rows_left_after_the_ring_wrapped(
        tracer, tmp_path, monkeypatch):
    """A session of more replays than the ring holds: its Chrome trace has
    a stamp record for every replay's every mark, the ring the last ROWS
    rows. export() aligns those rows by the trailing records and writes
    their segments, each with the device's work and idle inside it."""
    monkeypatch.setattr(tracing, "ROWS", 4)
    tracing.REG.rings.clear()
    rec, _ = _captured("frame", lambda: None)
    rec.opens = ["frame", "raster.bin", "frame", None]
    ring = tracing.REG.rings[-1]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stamps = []
        for k in range(7):
            n = tracing.replayed(rec)
            marks = [(10 * k + m) * 1_000 for m in (0, 2, 8, 10)]
            ring.ring[n % tracing.ROWS, :4] = torch.tensor(marks)
            # each replay's records: 300 us off its marks, plus jitter
            stamps += [300.0 + k + m / 1e3 for m in marks]
    assert tracing.lost() == 4

    class Prof:
        def export_chrome_trace(self, path):
            prof.export_chrome_trace(path)
            trace = json.loads(open(path).read())
            trace["traceEvents"] += [
                {"ph": "X", "cat": "kernel", "name": tracing.STAMP_KERNEL,
                 "ts": t, "dur": 0.5} for t in stamps] + [
                {"ph": "X", "cat": "kernel", "name": "k", "ts": t + 1.0,
                 "dur": 4.0} for t in stamps[1::4]]
            open(path, "w").write(json.dumps(trace))
    path = tmp_path / "trace.json"
    added = tracing.export(Prof(), str(path))
    assert added["rows"] == added["aligned"] == 4
    assert added["segments"] == 4 * 3
    events = json.loads(path.read_text())["traceEvents"]
    segs = [e for e in events if e.get("tid") == "device segments"]
    assert sorted({e["args"]["replay"] for e in segs}) == [4, 5, 6, 7]
    bins = [e for e in segs if e["name"] == "raster.bin"]
    for e in bins:
        k = e["args"]["replay"] - 1
        assert e["ts"] == pytest.approx(300.0 + k + 10 * k + 2)
        assert e["dur"] == pytest.approx(6.0)
        # the stamp 0.5 us and the kernel 1..5 us after the mark
        assert e["args"]["work_us"] == pytest.approx(0.5 + 4.0)
        assert e["args"]["idle_us"] == pytest.approx(1.5)
