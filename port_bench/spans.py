"""The program's own spans (``cgt/...``, ``cugraph_tpu_torch/utils/timer.py``)
as the benchmark reads them.

From the traced window, the same ``prof.events()`` that
``timing.read_profile`` reads: the count and host time of each span, and
the device's idle gaps (as ``timing.idle_gaps`` finds them) split by the
innermost span they fall in, each gap cut at the spans' edges. The split
has three parts: inside a step (``cgt/step.*``: an iteration, a level),
inside a call (``cgt/algorithms.*``) but outside its steps, and outside
any call. From the program's ``setup_spans()``: the set-up phases.

A program without spans reads as no spans: no counts, all idle outside
calls, no set-up spans. The harness passes its readers no profiler
events, so the metrics of ``BENCHMARK.json`` take only the set-up spans
(``metrics/ingest.*_s.py``), which the program times with its own CUDA
events; ``spans_run.py`` runs a cell with the rest.
"""

from __future__ import annotations

import bisect
import collections
import importlib
import math

from . import timing

PREFIX = "cgt/"
CALL, STEP, SYNC = "cgt/algorithms.", "cgt/step.", "cgt/sync."
IN_STEPS, IN_CALLS, OUTSIDE_CALLS = "in_steps", "in_calls", "outside_calls"
NO_SPAN = "none"  # idle outside every span
# operations that wait for the device, which a read span should hold: a
# host read, nonzero (a boolean mask's selection calls it) and the runtime's
# stream synchronize (under both, and under each copy from pageable host
# memory)
BLOCKING_OPS = (timing.HOST_READ_OP, "aten::nonzero", "cudaStreamSynchronize")


def _category(name: str, parent: str) -> str:
    if parent == IN_STEPS or name.startswith(STEP):
        return IN_STEPS
    if parent == IN_CALLS or name.startswith(CALL):
        return IN_CALLS
    return parent


def partition(spans):
    """Disjoint pieces (start, end, innermost span, part of the split) that
    cover the union of ``spans`` ((start, end, name), nested as one thread
    opens and closes them; a child running past its parent is cut at the
    parent's end), in time order."""
    out, stack, t = [], [], -math.inf

    def close_until(x):
        nonlocal t
        while stack and stack[-1][0] <= x:
            end, name, part = stack.pop()
            if end > t:
                out.append((t, end, name, part))
                t = end

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(start)
        parent = OUTSIDE_CALLS
        if stack:
            if start > t:
                out.append((t, start, stack[-1][1], stack[-1][2]))
            end = min(end, stack[-1][0])
            parent = stack[-1][2]
        stack.append((end, name, _category(name, parent)))
        t = start
    close_until(math.inf)
    return out


def merged_gaps(device):
    """The gaps between the merged device intervals, in time order, as
    ``timing.idle_gaps`` finds them."""
    merged = []
    for start, stop in sorted(device):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:])]


def split_idle(gaps, pieces):
    """({part: seconds}, {innermost span: seconds}) of the gaps (time-ordered
    (start, end) in microseconds) over the pieces of ``partition``."""
    parts = collections.Counter({IN_STEPS: 0.0, IN_CALLS: 0.0, OUTSIDE_CALLS: 0.0})
    by_span = collections.Counter()
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                parts[pieces[k][3]] += (hi - lo) / 1e6
                by_span[pieces[k][2]] += (hi - lo) / 1e6
                covered += hi - lo
            k += 1
        if b - a > covered:
            parts[OUTSIDE_CALLS] += (b - a - covered) / 1e6
            by_span[NO_SPAN] += (b - a - covered) / 1e6
    return dict(parts), by_span


def syncs_holding(spans, reads):
    """(sync spans holding at least one of ``reads``, reads in no sync
    span); ``reads`` are start times of one blocking operation."""
    syncs = sorted((s, e) for s, e, name in spans if name.startswith(SYNC))
    starts = [s for s, _ in syncs]
    holding, outside = set(), 0
    for t in reads:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and syncs[i][1] >= t:
            holding.add(i)
        else:
            outside += 1
    return len(holding), outside


def summarize(device, spans, blocking=None, window=None) -> dict:
    """The spans' record from device intervals (start, end), spans (start,
    end, name), the start times of each of the ``BLOCKING_OPS``
    ({op: [start]}) and the window (start, end) the host's events cover,
    all in microseconds. ``syncs_with_host_read``: the read spans that hold
    a host read; ``outside_syncs``: by blocking operation, those no read
    span holds; ``idle_edges_s``: the device's idle time in the window
    before its first operation and after its last, which the gaps leave
    out."""
    blocking = blocking or {}
    counts, host_s = collections.Counter(), collections.Counter()
    for start, end, name in spans:
        counts[name] += 1
        host_s[name] += (end - start) / 1e6
    parts, by_span = split_idle(merged_gaps(device), partition(spans))
    held = {op: syncs_holding(spans, blocking.get(op, ())) for op in BLOCKING_OPS}
    return dict(
        counts=dict(counts), host_s=dict(host_s), idle_s=parts,
        idle_by_span=[[k, v] for k, v in by_span.most_common(timing.TOP)],
        syncs_with_host_read=held[timing.HOST_READ_OP][0],
        outside_syncs={op: outside for op, (_, outside) in held.items()},
        idle_edges_s=edges(device, window),
    )


def edges(device, window):
    """[idle before the first device operation, idle after the last] within
    ``window``, in seconds; zeros without a window or device operations."""
    if window is None or not device:
        return [0.0, 0.0]
    first = min(start for start, _ in device)
    last = max(stop for _, stop in device)
    return [max(first - window[0], 0) / 1e6, max(window[1] - last, 0) / 1e6]


def read_spans(prof) -> dict:
    """``summarize`` of one torch.profiler window."""
    from torch.autograd import DeviceType

    device, spans, blocking = [], [], collections.defaultdict(list)
    window = [math.inf, -math.inf]
    for e in prof.events():
        start, stop = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device.append((start, stop))
            continue
        window = [min(window[0], start), max(window[1], stop)]
        if e.name.startswith(PREFIX):
            spans.append((start, stop, e.name))
        elif e.name in BLOCKING_OPS:
            blocking[e.name].append(start)
    return summarize(device, spans, blocking, window if window[0] <= window[1] else None)


def device_op_counts(prof, top: int = timing.TOP) -> list:
    """[[device operation, count]] of the window, the most frequent first:
    a kernel's launches as the device saw them."""
    from torch.autograd import DeviceType

    counts = collections.Counter(e.name[:120] for e in prof.events()
                                 if e.device_type == DeviceType.CUDA)
    return [[k, v] for k, v in counts.most_common(top)]


def program_setup_spans():
    """The set-up spans of the program in this process
    (``cugraph_tpu_torch.utils.timer.setup_spans()``), or None for a
    program older than the spans, whose timer has no ``setup_spans``. A
    program without that module raises ImportError."""
    timer = importlib.import_module("cugraph_tpu_torch.utils.timer")
    read = getattr(timer, "setup_spans", None)
    return read() if read is not None else None


def setup_seconds(setup: list, name: str, key: str):
    """``key`` (``host_s`` or ``device_s``) of the newest set-up span named
    ``name`` (the graph this run built, where a process built several), or
    None."""
    values = [s[key] for s in setup if s["name"] == name]
    return values[-1] if values else None


def program_setup_seconds(name: str, key: str):
    """``setup_seconds`` of the program's own set-up spans: None for a
    program older than the spans and for a span with no such time (no
    device time on the CPU); LookupError where the program keeps set-up
    spans but none named ``name``."""
    setup = program_setup_spans()
    if setup is None:
        return None
    if not any(s["name"] == name for s in setup):
        raise LookupError(f"the program keeps set-up spans, but none named {name}")
    return setup_seconds(setup, name, key)


def per_layer(summary: dict, setup: list, analytic: str, busy_s: float) -> dict:
    """The per-layer readings of one traced run that rest on the spans:
    idle a step (ms), blocking reads, dense and sparse levels a call, and
    the set-up spans' seconds; None where there is nothing to read."""
    counts = summary["counts"]
    calls = counts.get(CALL + analytic, 0)
    steps = sum(n for k, n in counts.items() if k.startswith(f"{STEP}{analytic}."))

    def per_call(n):
        return n / calls if calls else None

    return {
        f"algorithms.idle_ms_per_step.{analytic}":
            1e3 * summary["idle_s"][IN_STEPS] / steps if steps and busy_s else None,
        f"algorithms.syncs_per_query.{analytic}":
            per_call(sum(n for k, n in counts.items() if k.startswith(SYNC))),
        f"algorithms.dense_levels_per_query.{analytic}":
            per_call(counts.get(f"{STEP}{analytic}.dense", 0)),
        f"algorithms.sparse_levels_per_query.{analytic}":
            per_call(counts.get(f"{STEP}{analytic}.sparse", 0)),
        "ingest.validate_s": setup_seconds(setup, "cgt/ingest.validate", "device_s"),
        "ingest.symmetrize_s": setup_seconds(setup, "cgt/ingest.symmetrize", "device_s"),
        "ingest.compress_s": setup_seconds(setup, "cgt/ingest.compress", "device_s"),
        "setup.port_import_s": setup_seconds(setup, "cgt/setup.import", "host_s"),
    }
