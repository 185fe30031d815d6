"""The yardstick's arithmetic: the card's peak bandwidth, a roofline bound,
and the reading of a torch.profiler window (frozen copies of
``chip_smoke.py``'s ``bound`` and ``profiled``, so that a later change to
the program cannot move them).

Device intervals are the profiler's CUDA events (kernels, memsets and
copies); the device's busy time is the union of those intervals, so
operations on two streams at once count once.
"""

from __future__ import annotations

import collections
import math

# NVIDIA's H100 SXM data sheet, at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12

HOST_READ_OP = "aten::_local_scalar_dense"  # each item()/float()/bool() of a device tensor
TOP = 10  # entries in each list of the breakdown


def bound_s(bytes_moved: float) -> float:
    """The least time the card could take to move ``bytes_moved``: the
    analytics here do a few operations a byte, far under the card's
    ridge, so bytes bound them."""
    return bytes_moved / PEAK_BYTES_PER_S


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, -math.inf
    for start, stop in sorted(intervals):
        if stop > end:
            busy, end = busy + stop - max(start, end), stop
    return busy


def idle_gaps(device, host):
    """The gaps between the merged device intervals, each named by the
    innermost host operation running at its middle ("python" where none
    is): {name: seconds}, summed by name. ``device`` and ``host`` are
    (start, end[, name]) in microseconds."""
    merged = []
    for start, stop in sorted(device):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1]) for a, b in zip(merged, merged[1:]))
    ops = sorted(host, key=lambda e: (e[0], -e[1]))
    out = collections.Counter()
    stack, j = [], 0
    for mid, length in gaps:
        while j < len(ops) and ops[j][0] <= mid:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "python"] += length / 1e6
    return out


def read_profile(prof, wall_s: float) -> dict:
    """What the metric readers take from one torch.profiler window: its
    wall seconds, the device's busy seconds, the count of device
    operations and of host reads, and the breakdown (the device operations
    that took most time, the longest idle gaps by host operation)."""
    from torch.autograd import DeviceType

    device, host, by_op = [], [], collections.Counter()
    host_reads = 0
    for e in prof.events():
        start, stop = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device.append((start, stop))
            by_op[e.name[:120]] += (stop - start) / 1e6
        else:
            host.append((start, stop, e.name[:120]))
            host_reads += e.name == HOST_READ_OP
    gaps = idle_gaps(device, host)
    return dict(
        wall_s=wall_s,
        busy_s=busy_union(device) / 1e6,
        launches=len(device),
        host_reads=host_reads,
        device_ops=[[k, v] for k, v in by_op.most_common(TOP)],
        idle_gaps=[[k, v] for k, v in gaps.most_common(TOP)],
    )
