"""Timing of calls on the card (the counterpart of scripts/_timing.py) and
the H100 peak rates that the kernels' bounds are priced at.

`time_call` and `time_pair` give ms per call from CUDA events around a
batch of calls after a warm-up; PyTorch returns before the device
finishes, so an event pair and one synchronize are what time the device.
For a CPU device (the tools' rehearsals) they read the host clock around
the same batches instead: such numbers are host times of the plain
versions, never device metrics.
"""
from __future__ import annotations

import re
import time

import torch

# H100 SXM peaks (NVIDIA data sheet and CUDA guide): 3.35 TB/s HBM3; 128
# FP32 instructions issued per clock per SM (a fused multiply-add is one)
# and 16 SFU results (expf's MUFU.EX2), x 132 SMs x 1.98 GHz
HBM_BYTES_S = 3.35e12
BOOST_HZ = 1.98e9                  # the SM clock the peaks assume
FP32_ISSUE_SM_S = 128 * BOOST_HZ   # one SM
FP32_ISSUE_S = FP32_ISSUE_SM_S * 132
MUFU_OP_S = 16 * 132 * BOOST_HZ


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _batch_ms(fn, n: int, device) -> float:
    """ms for n calls of fn, the device drained before and after."""
    if not _on_card(device):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def clock(device) -> str:
    """What the times of `device` are, for the tools' first line."""
    if _on_card(device):
        return f"CUDA events on {torch.cuda.get_device_name(device)}"
    return f"the host clock on {device} (plain versions; host times)"


def _drain(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def time_call(fn, launches: int = 20, device="cuda") -> float:
    """ms per call of fn, CUDA events around a batch after a warm-up."""
    fn()
    _drain(device)
    return _batch_ms(fn, launches, device) / launches


def time_pair(kernel, plain, launches: int = 50,
              device="cuda") -> tuple[float, float]:
    """ms per call of each, CUDA events around batches run in the order
    plain, kernel, kernel, plain (launches/2 calls per batch)."""
    for fn in (kernel, plain):      # warm-up
        fn()
    _drain(device)
    total = {"kernel": 0.0, "plain": 0.0}
    half = max(launches // 2, 1)
    for which in ("plain", "kernel", "kernel", "plain"):
        total[which] += _batch_ms(kernel if which == "kernel" else plain,
                                  half, device)
    return total["kernel"] / (2 * half), total["plain"] / (2 * half)


def bound(nbytes: float = 0, fp32: float = 0, mufu: float = 0) -> dict:
    """The least time the card could take for work that moves `nbytes`
    through device memory and issues `fp32` FP32-pipe instructions and
    `mufu` SFU results: the larger of the three times at the peaks above.
    Returns bound_ms, bound_by ("bytes" or "operations") and the
    resource."""
    times = {"hbm bytes": nbytes / HBM_BYTES_S,
             "fp32 issue": fp32 / FP32_ISSUE_S,
             "mufu": mufu / MUFU_OP_S}
    resource = max(times, key=times.get)
    return {"bound_ms": times[resource] * 1e3,
            "bound_by": "bytes" if resource == "hbm bytes" else "operations",
            "bound_resource": resource}


# The host's runtime calls that each leave one record on the card: a kernel
# launch (runtime or driver API), a fill or a copy.
_RECORDED_CALL = re.compile(r"^(cudaLaunch|cuLaunch|cudaMemset|cuMemset"
                            r"|cudaMemcpy|cuMemcpy)")


def recorded_call(name: str) -> bool:
    """Whether a host runtime call named `name` leaves one record on the
    card (what `kernel_records` counts as launched)."""
    return _RECORDED_CALL.match(name) is not None


class NoKernelRecords(RuntimeError):
    """torch.profiler kept no record of the kernels the host launched in
    any window that `kernel_records` took; `launched` is the launches of
    the last window."""

    def __init__(self, message: str, launched: int):
        super().__init__(message)
        self.launched = launched


# the name under which `kernel_times` reports a time from `held_stream_ms`
HELD_STREAM = "all kernels (CUDA events behind a held stream)"


def kernel_records(fn, n: int = 5, windows: int = 3) -> tuple[dict, int]:
    """Each kernel's recorded launch times (ms) over n calls of fn on the
    card, by the kernel's function name (templates and arguments
    stripped), from torch.profiler; and the calls the host made in those n
    calls that each leave one record (launches, fills, copies): the
    records the profiler should have kept. A window in which the
    profiler kept no kernel record at all (seen on an H100, with and
    without the host's launch calls) is taken again, up to `windows` in
    all; then this raises NoKernelRecords, rather than report no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        records: dict[str, list[float]] = {}
        launched = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                bare = re.sub(r"^void\s+|\(anonymous namespace\)::", "",
                              e.name)
                m = re.search(r"(\w+)\s*[<(]", bare)
                name = m.group(1) if m else e.name
                records.setdefault(name, []).append(
                    e.time_range.elapsed_us() / 1e3)
            elif recorded_call(e.name):
                launched += 1
        if records:
            return records, launched
    raise NoKernelRecords(f"torch.profiler kept no kernel record in "
                          f"{windows} windows of {n} calls ({launched} "
                          f"launches each)", launched)


def held_stream_ms(fn, n: int = 20) -> float:
    """Device ms per call of fn without torch.profiler: CUDA events around
    n calls that the host enqueues while a sleep kernel holds the stream,
    so that the device runs them back to back once it is released and the
    events time its work alone (the device's own gaps between launches
    included), not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0      # enqueue and device, drained
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * enqueue_s + 1e-3) * BOOST_HZ))
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def kernel_times(fn, n: int = 5) -> dict:
    """Device ms per call of each kernel that fn launches, by name, from
    torch.profiler over n calls on the card (`kernel_records`). The
    profiler can drop a launch's record (on an H100, up to 9 of 20
    launches of one kernel in a window), so each kernel's time is taken
    from the records it kept (`per_call_ms`). Where it kept none in any
    window, the time of all of fn's kernels together is taken from
    `held_stream_ms` instead, under the name HELD_STREAM."""
    try:
        return per_call_ms(kernel_records(fn, n)[0], n)
    except NoKernelRecords:
        return {HELD_STREAM: held_stream_ms(fn, max(n, 20))}


def per_call_ms(records: dict, n: int) -> dict:
    """Device ms per call of each kernel from its recorded launch times
    (ms) over n calls, when each call launches every kernel the same
    number of times: the mean launch times the launches a call, taken as
    ceil(records / n). With every record kept this is the records' sum
    over n; it stays right while the profiler drops fewer than n of a
    kernel's records, and reads k-fold low for a kernel launched k times
    a call once n or more of its records are gone, which `kernel_records`'
    count of the host's launches shows."""
    return {name: sum(ms) / len(ms) * -(-len(ms) // n)
            for name, ms in records.items()}
