"""ingest.compress_s: the device time of the program's set-up span
``cgt/ingest.compress`` (``from_edgelist``'s sort of the edges into the
adjacency that serves as CSR and CSC), from the traced run's record. The
program times it with two CUDA events of its own, which its
``setup_spans()`` resolves; it is not read from the profiler's trace.
None on the CPU, where the span has no device time, and for a program
older than the spans; LookupError for a program that keeps set-up spans
but not this one."""

from port_bench.spans import setup_seconds


def read(rec):
    return setup_seconds(rec, "cgt/ingest.compress", "device_s")
