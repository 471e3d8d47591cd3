"""The port's timing helpers (fourdgs_tpu_torch/utils/timing.py) on the CPU:
what `kernel_times` makes of the launch records that torch.profiler kept,
which of the host's runtime calls `kernel_records` counts as launches
that each should have left a record, what it does with a window in
which the profiler kept none, and what `kernel_times` reports when no
window kept one."""
from types import SimpleNamespace

import pytest
import torch
import torch.profiler

from fourdgs_tpu_torch.utils import timing
from fourdgs_tpu_torch.utils.timing import per_call_ms, recorded_call


@pytest.mark.parametrize("kept", [20, 19, 11, 1])
def test_per_call_ms_survives_dropped_records(kept):
    """One launch a call over 20 calls: the profiler may keep only some of
    the records (on an H100 it kept 11 of 20 in one window), and the time
    a call is still the launch's."""
    assert per_call_ms({"k": [0.4] * kept}, 20) == pytest.approx({"k": 0.4})


def test_per_call_ms_counts_launches_a_call():
    """A kernel launched twice a call, beside a fill launched once, with
    three of the kernel's 40 records dropped; with none dropped it is the
    sum of the records over the calls."""
    got = per_call_ms({"k": [0.1] * 37, "fill": [0.002] * 20}, 20)
    assert got == pytest.approx({"k": 0.2, "fill": 0.002})
    records = {"a": [0.3, 0.5, 0.4, 0.2]}
    assert per_call_ms(records, 4) == pytest.approx({"a": 0.35})


@pytest.mark.parametrize("name, recorded", [
    ("cudaLaunchKernel", True), ("cudaLaunchKernelExC", True),
    ("cuLaunchKernel", True), ("cuLaunchKernelEx", True),
    ("cudaMemsetAsync", True), ("cudaMemcpyAsync", True),
    ("cudaStreamSynchronize", False), ("cudaFuncSetAttribute", False),
    ("cudaEventRecord", False), ("aten::index_add_", False)])
def test_recorded_call_names_the_launches(name, recorded):
    """Kernel launches (K3's cluster launch is cudaLaunchKernelExC), fills
    and copies each leave one record on the card; syncs, attributes,
    events and the operators around them leave none."""
    assert recorded_call(name) is recorded


class _Window:
    """A stand-in for torch.profiler.profile: each window yields the next
    list of events from `windows`."""

    def __init__(self, windows):
        self.windows = iter(windows)

    def __call__(self, activities):
        self.events_now = next(self.windows)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self.events_now


def _event(device_type, name, us=10.0):
    return SimpleNamespace(device_type=device_type, name=name,
                           time_range=SimpleNamespace(elapsed_us=lambda: us))


@pytest.mark.parametrize("empty_windows,raises", [(0, False), (2, False),
                                                  (3, True)])
def test_kernel_records_takes_another_window_when_none_were_kept(
        monkeypatch, empty_windows, raises):
    """A window whose launches left no kernel record is profiled again;
    after three such windows kernel_records raises instead of reporting
    no device time."""
    from torch.autograd import DeviceType
    launch = _event(DeviceType.CPU, "cudaLaunchKernel")
    kept = _event(DeviceType.CUDA, "void store_last_kernel(int const*)", 12.0)
    windows = [[launch]] * empty_windows + [[launch, kept]]
    monkeypatch.setattr(torch.profiler, "profile", _Window(windows))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if raises:
        with pytest.raises(RuntimeError, match="no kernel record"):
            timing.kernel_records(lambda: None, n=1)
        return
    records, launched = timing.kernel_records(lambda: None, n=1)
    assert records == {"store_last_kernel": [0.012]}
    assert launched == 1


@pytest.mark.parametrize("empty_windows,launch_kept", [(0, True),
                                                       (3, True),
                                                       (3, False)])
def test_kernel_times_falls_back_to_a_held_stream(monkeypatch,
                                                  empty_windows,
                                                  launch_kept):
    """kernel_times reports the kept records by kernel; where three
    windows kept no kernel record, whether or not they kept the host's
    launch calls, kernel_records raises NoKernelRecords with the launches
    it saw, and kernel_times reports held_stream_ms's time under
    HELD_STREAM instead."""
    from torch.autograd import DeviceType
    launch = _event(DeviceType.CPU, "cudaLaunchCooperativeKernel")
    kept = _event(DeviceType.CUDA, "void store_last_kernel(int const*)", 12.0)
    empty = [launch] if launch_kept else []
    windows = [empty] * empty_windows + [[launch, kept]]
    monkeypatch.setattr(torch.profiler, "profile", _Window(windows))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    held = []
    monkeypatch.setattr(timing, "held_stream_ms",
                        lambda fn, n: held.append(n) or 0.0109)
    got = timing.kernel_times(lambda: None, n=1)
    if empty_windows:
        assert got == {timing.HELD_STREAM: 0.0109}
        assert held == [20]
        monkeypatch.setattr(torch.profiler, "profile", _Window([empty] * 3))
        with pytest.raises(timing.NoKernelRecords) as err:
            timing.kernel_records(lambda: None, n=1)
        assert err.value.launched == len(empty)
    else:
        assert got == {"store_last_kernel": 0.012}
        assert held == []
