"""Device timing with CUDA events and with the profiler's kernel events.

``torch.cuda`` calls return before the card finishes, so a host clock
without a synchronise measures the enqueue. :func:`cuda_time` records
events around a run of many launches after a warm-up, synchronises and
divides the elapsed time by the count: for short kernels that still
includes the host's enqueue time whenever the host is slower than the
card. :func:`device_time` sums the durations of the kernels, copies and
memsets the calls put on the card, from ``torch.profiler``: the card's own
time, without launch gaps. A time from here is a time on the card; there
is no CPU fallback.
"""

from __future__ import annotations

import torch

__all__ = ["cuda_time", "device_time"]


def cuda_time(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()`` on the current CUDA stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time measures the card; no CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, iters: int = 20, warmup: int = 1) -> float:
    """Milliseconds of device work per call of ``fn()``: the summed
    durations of the device-side events ``torch.profiler`` records over
    ``iters`` calls. Raises if the profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_time measures the card; no CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / 1e3 / iters
