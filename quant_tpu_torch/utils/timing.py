"""Device timing with CUDA events and with the profiler's kernel events.

``torch.cuda`` calls return before the card finishes, so a host clock
without a synchronise measures the enqueue. :func:`cuda_time` records
events around a run of many launches after a warm-up, synchronises and
divides the elapsed time by the count: for short kernels that still
includes the host's enqueue time whenever the host is slower than the
card. :func:`device_time` sums the durations of the kernels, copies and
memsets the calls put on the card, from ``torch.profiler``: the card's own
time, without launch gaps. :func:`kernel_times` takes both and refuses a
device time far below the event time. A time from here is a time on the
card; there is no CPU fallback.
"""

from __future__ import annotations

from collections import Counter

import torch

__all__ = ["cuda_time", "device_time", "kernel_times"]


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


_ATTEMPTS = 6      # traces device_time retakes before it gives up
_MIN_SHARE = 0.01  # least device / event time a whole trace can give
_WARM_CALLS = 2    # calls a trace makes before its marker
_PAD_KERNELS = 256  # empty spin kernels a trace launches before its marker
_MARK_CYCLES = 1_000_000   # the marker: a spin kernel of about 0.5 ms


def _trace(fn, calls: int):
    """Device events of ``calls`` calls of ``fn()``: (name, microseconds).
    The profiler loses the first device events of a trace, the more the
    longer the process has traced (none in a fresh process; after the
    smoke's kernels phase, the warm calls, the markers and some timed calls
    of every trace), so each trace first makes ``_WARM_CALLS`` calls and
    launches ``_PAD_KERNELS`` empty spin kernels, then a long spin kernel as
    the marker, then the calls; only the events that start after the last
    spin kernel ends (one stream, in order) are kept. A trace whose marker
    went missing gives none. Only device activity is traced: host operator
    events give no device time, and the profiler takes milliseconds of
    host time per expert to process them for a plain version that loops
    over hundreds of experts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(_WARM_CALLS):
            fn()
        for _ in range(_PAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda._sleep(_MARK_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e.time_range.end for e in dev if "spin_kernel" in e.name]
    if not marks:
        return []
    return [(e.name, e.time_range.end - e.time_range.start) for e in dev
            if e.time_range.start >= marks[-1] and "spin_kernel" not in e.name]


def device_time(fn, iters: int = 20, warmup: int = 1) -> float:
    """Milliseconds of device work per call of ``fn()``: the summed
    durations of the device-side events ``torch.profiler`` records over
    ``iters`` calls. The profiler can lose events (see :func:`_trace`), so
    a trace counts only when it holds some, each name a multiple of
    ``iters`` times, the trace before it holds the same names as often and
    no earlier trace held another; up to ``_ATTEMPTS`` traces past the
    first are taken, then this raises, listing every trace."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time measures the card; no CUDA device")
    for _ in range(warmup):
        fn()
    prev, names, traces = None, set(), []
    for _ in range(1 + _ATTEMPTS):
        events = _trace(fn, iters)
        seen = Counter(name for name, _ in events)
        traces.append(dict(seen))
        names |= seen.keys()
        if (seen and seen == prev and seen.keys() == names
                and all(n % iters == 0 for n in seen.values())):
            return sum(us for _, us in events) / 1e3 / iters
        prev = seen
    raise RuntimeError(f"the profiler's device events of {iters} calls "
                       f"disagree from trace to trace: {traces}")


def kernel_times(fn, iters: int = 20) -> tuple[float, float]:
    """(:func:`device_time`, :func:`cuda_time`) of ``fn()``. The event time
    holds the device time and the host's enqueue, so a device time below
    ``_MIN_SHARE`` of it means the trace lost the work: this raises."""
    ms, ev = device_time(fn, iters), cuda_time(fn, iters)
    if ms < _MIN_SHARE * ev:
        raise RuntimeError(f"device time {ms:.6f} ms is under {_MIN_SHARE} "
                           f"of the {ev:.6f} ms between CUDA events")
    return ms, ev
