"""Per-phase timing: the HighResTimer analog.

Counterpart of ``cugraph_tpu/utils/timer.py`` (ref:
cpp/src/utilities/high_res_timer.hpp:27, start/stop/display per label).
``stop(label, sync=...)`` synchronises the CUDA device of every tensor in
``sync`` before it reads the clock, as the reference's cudaStreamSync
does; ``profiler_trace`` writes a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of the tensors in a tensor, tuple, list or dict."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _cuda_devices(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _cuda_devices(o, out)
    return out


class HighResTimer:
    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._open: Dict[str, float] = {}

    def start(self, label: str) -> None:
        self._open[label] = time.perf_counter()

    def stop(self, label: str, sync=None) -> float:
        """sync: a tensor, or a tuple, list or dict of them; the devices of
        its CUDA tensors are synchronised before the clock is read, so the
        time covers the work queued for them."""
        for dev in _cuda_devices(sync, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._open.pop(label)
        self._totals[label] += dt
        self._counts[label] += 1
        return dt

    @contextlib.contextmanager
    def range(self, label: str):
        """Time the block; put tensors under ``holder["sync"]`` to wait
        for them before the clock is read."""
        self.start(label)
        holder = {}
        try:
            yield holder
        finally:
            self.stop(label, sync=holder.get("sync"))

    def display(self, out=None) -> str:
        lines = [
            f"{label}: {self._totals[label]*1e3:10.3f} ms "
            f"({self._counts[label]} calls)"
            for label in sorted(self._totals)
        ]
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()
        self._open.clear()


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """``with profiler_trace(log_dir): ...`` records the block with
    ``torch.profiler`` (the CPU, and CUDA where there is a card) and writes
    a Chrome trace, ``trace_<pid>.json``, into ``log_dir``; open it in
    chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
