"""ingest.symmetrize_s: the device time of the program's set-up span
``cgt/ingest.symmetrize`` (``from_edgelist``'s union of each edge with its
reciprocal, then the coalescing). The program times it with two CUDA
events of its own, which its ``setup_spans()`` resolves; it is not read
from the profiler's trace. None on the CPU, where the span has no device
time, and for a program older than the spans; LookupError for a program
that keeps set-up spans but not this one."""

from port_bench.spans import program_setup_seconds


def read(rec):
    return program_setup_seconds("cgt/ingest.symmetrize", "device_s")
