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
FP32_ISSUE_SM_S = 128 * 1.98e9     # one SM
FP32_ISSUE_S = FP32_ISSUE_SM_S * 132
MUFU_OP_S = 16 * 132 * 1.98e9


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


def kernel_times(fn, n: int = 5) -> dict:
    """Device ms per call of each kernel that fn launches, by the kernel's
    function name (templates and arguments stripped), from torch.profiler
    over n calls on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            bare = re.sub(r"^void\s+|\(anonymous namespace\)::", "", e.name)
            m = re.search(r"(\w+)\s*[<(]", bare)
            name = m.group(1) if m else e.name
            out[name] = (out.get(name, 0.0)
                         + e.time_range.elapsed_us() / 1e3 / n)
    return out
