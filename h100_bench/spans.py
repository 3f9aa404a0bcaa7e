"""What the readers of the program's spans take from a traced window.

The port records its layers as profiler ranges named ``ecnf.*``
(`ecnf_tpu_torch/utils/spans.py`): ``ecnf.solve`` around each call of the
sampling layer, ``ecnf.field`` around each field evaluation.  They arrive
among the window's host operations (`trace.profile`).  A program without
them gives none, and each reader then returns None.

A device operation belongs to the span in which the host call that
launched it ran.  The window's device operations run on one stream, in
the order the host launched them, so the launch calls (the CUDA API calls
that put a kernel, a copy or a fill on the stream) and the device
operations pair one to one in time order.  They are paired from the
window's end: where the profiler lost device records, it lost those of the
window's first launches (a later profiler run in one process on an H100
with torch 2.11 lost the first 1 to 25, every record's correlation id
checked), which are left unpaired.  Where the device has more operations
than launch calls, nothing is linked.
"""
import bisect
from typing import List, Optional, Tuple

import harness

trace = harness.load_module(harness.HERE / "trace.py")

# The launch calls of the port's windows on an H100 (torch 2.11, CUDA 12.8).
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx", "cudaMemcpyAsync",
            "cudaMemsetAsync")
Pair = Tuple[float, float]


def named(traced: dict, name: str) -> List[Pair]:
    """The host ranges called ``name``, as (start, end) in time order."""
    return sorted((s, e) for n, s, e in traced["host_ops"] if n == name)


def length(pairs: List[Pair]) -> float:
    """The length of the union of the intervals."""
    return trace.busy_seconds([("", s, e) for s, e in pairs])


def overlap(a: List[Pair], b: List[Pair]) -> float:
    """The length of the intersection of the two unions."""
    return length(a) + length(b) - length(a + b)


def launched_in(traced: dict, spans: List[Pair]) -> Optional[List[Pair]]:
    """The device operations whose launch call ran inside one of ``spans``
    (time-ordered, disjoint), as (start, end); None when the window has
    more device operations than launch calls."""
    launches = sorted(s for n, s, _ in traced["host_ops"] if n in LAUNCHES)
    device = sorted((s, e) for _, s, e in traced["device_ops"])
    if len(launches) < len(device):
        return None
    starts = [s for s, _ in spans]
    out = []
    for at, op in zip(launches[len(launches) - len(device):], device):
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= spans[i][1]:
            out.append(op)
    return out
