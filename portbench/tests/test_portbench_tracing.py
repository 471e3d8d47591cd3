"""The per-layer metrics that read the port's tracer
(fourdgs_tpu_torch/utils/tracing.py): each reader returns None on an
untraced outcome, on a CPU run's (which keeps no trace) and where the
tracer recorded nothing; each reads the profiled replays of a traced
program stood in for on the CPU; and each entry of BENCHMARK.json names
cells that exist and report the metric it moves."""
import json
import types

import pytest
import torch

from portbench import run as bench_run
from portbench.core.common import Outcome
from portbench.core.trace import Trace

BENCHMARK = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
# metric -> (the program's root span, a segment it reads or "host")
TRACED = {"splats_ms.train": ("step", "splats.hexplane"),
          "hexplane_ms.train": ("step", "splats.hexplane"),
          "adam_ms.train": ("step", "train.adam"),
          "step_host_ms.train": ("step", "host"),
          "splats_ms.serve": ("frame", "render.splats"),
          "project_bin_ms.serve": ("frame", "raster.bin"),
          "frame_host_ms.serve": ("frame", "host"),
          "frame_host_ms.playback": ("frame", "host")}


def _outcome(metrics):
    return Outcome(attempted=1, failed=0, metrics=metrics, compared={},
                   memory_peak_bytes=0)


def _traced():
    return _outcome({"trace": Trace(window_s=1.0, busy_s=0.5, kernel_s={},
                                    idle_s={})})


@pytest.fixture
def tracer():
    from fourdgs_tpu_torch.utils import tracing
    tracing.reset()
    yield tracing
    tracing.reset()


@pytest.mark.parametrize("metric", sorted(TRACED))
def test_reader_returns_none_without_a_trace(metric, tracer):
    read = bench_run.reader(metric)
    assert read(_outcome({"render_fps": (100.0, "frames/s")}), None) is None
    assert read(_outcome({}), None) is None            # a CPU run
    assert read(_traced(), None) is None               # nothing recorded


@pytest.mark.parametrize("metric", sorted(TRACED))
def test_reader_reads_the_profiled_replays(metric, tracer, monkeypatch):
    """A program of two segments "captured" on the CPU (the stamp's plain
    version), replayed once before a profiler session and twice inside
    it: the reader averages the two profiled replays only."""
    root, segment = TRACED[metric]
    monkeypatch.setattr(tracer, "_stream", lambda: 0)
    rec = tracer.program("test", root)
    with tracer.capturing(types.SimpleNamespace(cuda_stream=0), root,
                          torch.device("cpu")) as cap:
        tracer.begin(cap)
        if segment != "host":
            with tracer.span(segment):
                pass
        tracer.end(cap, rec)
    ring = rec.ring
    phases = tracer.PHASES[root]
    host = tracer.HostSpans(root)
    for _ in phases:
        host.lap(tracer.now())
    host.close(tracer.replayed(rec))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for k in (1, 2):
            n = tracer.replayed(rec)
            # the replay's marks (ns): the root's, the segment's entry
            # and exit, the close; or the root's and the close
            ms = [0, 1, 1 + k, 2 + k] if segment != "host" else [0, k]
            ring.ring[n % tracer.ROWS, :len(ms)] = torch.tensor(
                [m * 1_000_000 for m in ms])
            host = tracer.HostSpans(root)
            host.times[0] -= k * 2_000_000
            for _ in phases:
                host.lap(tracer.now())
            host.close(n)
    value = bench_run.reader(metric)(_traced(), None)
    if segment == "host":
        assert value == pytest.approx(3.0, rel=0.05)
    else:
        assert value == pytest.approx(1.5)


@pytest.mark.parametrize("metric", sorted(TRACED))
def test_entry_names_existing_cells(metric):
    (entry,) = [m for m in BENCHMARK["per_layer"] if m["name"] == metric]
    cells = {c["name"] for c in BENCHMARK["workloads"]}
    assert entry["workloads"] and set(entry["workloads"]) <= cells
    assert entry["unit"] == "ms" and entry["better"] == "lower"
    assert entry["source"] in {m["source"] for m in BENCHMARK["end_to_end"]
                               + BENCHMARK["per_layer"][:9]}
    for cell in entry["workloads"]:
        reported = {m["name"] for m in bench_run.end_to_end(BENCHMARK,
                                                            cell)}
        assert entry["moves"] in reported
