"""The port's tracing: spans on the profiler's clock, set-up spans kept in
memory, and a Chrome-trace writer.

- ``span(name)``: a context manager around a piece of the program. While a
  ``torch.profiler`` runs, the span is an event of its trace, on the same
  clock as the device's kernels and nested by time under its caller; with
  no profiler running it is one shared no-op. Names start with ``cgt/``:
  ``cgt/algorithms.<analytic>`` a call, ``cgt/step.<...>`` an iteration or
  a level, ``cgt/sync.<site>`` a read that waits for the device,
  ``cgt/kernel.<wrapper>`` a kernel wrapper's call, ``cgt/ingest.<phase>``
  and ``cgt/setup.<phase>`` the set-up. The count of a name is the count
  of what it marks: iterations, levels, blocking reads, launches.
- ``spanned(name)``: a decorator, for a span that covers each call of a
  function.
- ``span(name, setup=True, device=...)``: a span that runs once a process
  (``cgt/setup.*``: the import, a kernel library's load and build) or once
  a graph (``cgt/ingest.*``). It is also kept, profiler or not, for
  ``setup_spans()``: its host start and end, its parent set-up span, and
  where ``device`` is a CUDA device its device time, from two CUDA events
  resolved when the spans are read (the span never waits). The newest
  ``SETUP_SPANS_KEPT`` are kept.
- ``profiler_trace(log_dir)``: records a block with ``torch.profiler`` and
  writes its Chrome trace, spans and kernels together, for a look at one
  run in Perfetto.

Counterpart of ``cugraph_tpu/utils/timer.py``, whose ``HighResTimer``
(ref: cpp/src/utilities/high_res_timer.hpp:27) synchronises the device at
each stop; the port's spans never do.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from typing import List, Optional

import torch

SETUP_SPANS_KEPT = 1024  # the newest set-up spans kept; older ones drop off

_NO_SPAN = contextlib.nullcontext()
# a RecordFunction of the FUNCTION scope: an event of the host's trace
# alone, where record_function's user scope also lays an annotation over
# the kernels on the device's timeline, which would count as device time
_RecordFunction = torch._C._profiler._RecordFunctionFast
_setup_spans: collections.deque = collections.deque(maxlen=SETUP_SPANS_KEPT)
_open = threading.local()  # .names: the set-up spans open on this thread


def _open_names() -> list:
    names = getattr(_open, "names", None)
    if names is None:
        names = _open.names = []
    return names


def _parent() -> Optional[str]:
    names = _open_names()
    return names[-1] if names else None


class _SetupSpan:
    def __init__(self, name: str, device):
        self.name = name
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        self.parent = _parent()
        _open_names().append(self.name)
        self.traced = _RecordFunction(self.name) if torch.autograd._profiler_enabled() else None
        if self.traced is not None:
            self.traced.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self.traced is not None:
            self.traced.__exit__(*exc)
        _open_names().pop()
        _setup_spans.append((self.name, self.parent, self.start, end, self.events))
        return False


def span(name: str, *, setup: bool = False, device=None):
    """A context manager that marks a piece of the program as ``name``;
    ``setup`` keeps it for ``setup_spans()`` too, with its device time on
    ``device`` where that is a CUDA device."""
    if setup:
        return _SetupSpan(name, device)
    if torch.autograd._profiler_enabled():
        return _RecordFunction(name)
    return _NO_SPAN


def spanned(name: str):
    """A decorator that makes each call of the function a ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def record_setup_span(name: str, start: float, end: float) -> None:
    """Keep a set-up span timed by the caller on the ``time.perf_counter``
    clock (one whose start precedes this module, or that ran beside
    others), under the innermost set-up span open."""
    _setup_spans.append((name, _parent(), start, end, None))


def setup_spans() -> List[dict]:
    """The set-up spans kept, by start: ``name``, ``parent`` (the set-up
    span it ran in, or None), ``start_s`` and ``end_s`` on the
    ``time.perf_counter`` clock, ``host_s``, and ``device_s``: the time
    between the span's CUDA events (waiting here for the end event), None
    for a span on the CPU or on no device."""
    out = []
    for name, parent, start, end, events in sorted(_setup_spans, key=lambda kept: kept[2]):
        device_s = None
        if events is not None:
            events[1].synchronize()
            device_s = events[0].elapsed_time(events[1]) / 1e3
        out.append(dict(name=name, parent=parent, start_s=start, end_s=end,
                        host_s=end - start, device_s=device_s))
    return out


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """``with profiler_trace(log_dir): ...`` records the block with
    ``torch.profiler`` (the CPU, and CUDA where there is a card) and writes
    a Chrome trace, ``trace_<pid>.json``, into ``log_dir``, the ``cgt/``
    spans beside the kernels; open it in chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
