"""The port's timing helpers (fourdgs_tpu_torch/utils/timing.py) on the CPU:
what `kernel_times` makes of the launch records that torch.profiler kept,
and which of the host's runtime calls `kernel_records` counts as launches
that each should have left a record."""
import pytest

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
