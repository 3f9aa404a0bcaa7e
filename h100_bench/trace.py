"""What the benchmark reads from a `torch.profiler` trace of a window: the
device's operations, their union (busy time), and the idle gaps between
them, each named by the innermost host operation running at the time."""
import heapq
import time
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

Interval = Tuple[str, float, float]  # name, start, end in seconds


def profile(fn: Callable[[], dict], device: torch.device) -> dict:
    """Run ``fn`` under the profiler and return what it returned, plus
    ``window_s`` (host clock, from the call to the device's last work),
    ``device_ops`` and ``host_ops`` (lists of `Interval`)."""
    from torch.profiler import ProfilerActivity, profile as _profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with _profile(activities=activities) as prof:
        start = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - start
    device_ops, host_ops = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        (device_ops if e.device_type == torch.autograd.DeviceType.CUDA else host_ops).append(span)
    return dict(out, window_s=window_s, device_ops=device_ops, host_ops=host_ops)


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def merged(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as sorted disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(device_ops: List[Interval]) -> float:
    return sum(e - s for s, e in merged(device_ops))


def top_device_ops(device_ops: List[Interval], n: int = 10) -> List[list]:
    """The ``n`` device operations (by name, cut to 160 characters) that
    took the most time."""
    total = defaultdict(float)
    for name, s, e in device_ops:
        total[name[:160]] += e - s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device_ops: List[Interval], host_ops: List[Interval], n: int = 10) -> List[list]:
    """Idle time between device operations, summed by the innermost host
    operation (latest started, still running) at each gap's midpoint; the
    ``n`` largest sums."""
    spans = merged(device_ops)
    gaps = [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]
    hosts = sorted(host_ops, key=lambda x: x[1])
    total = defaultdict(float)
    active: list = []  # max-heap on start: (-start, end, name)
    i = 0
    for s, e in gaps:  # gaps come in time order, so do their midpoints
        mid = 0.5 * (s + e)
        while i < len(hosts) and hosts[i][1] <= mid:
            heapq.heappush(active, (-hosts[i][1], hosts[i][2], hosts[i][0]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        total[active[0][2] if active else "(no host op)"] += e - s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
