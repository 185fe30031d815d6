"""ingest.coalesce_s: the device time of the program's set-up span
``cgt/ingest.coalesce`` (the streamed multi-card ingest's merge of a
rank's chunks into its distinct pairs, after the chunk loop; rank 0's on a
cell across cards), from the traced run's record. The program times it
with two CUDA events of its own, which its ``setup_spans()`` resolves; it
is not read from the profiler's trace. None on the CPU, where the span has
no device time, for a program older than the spans, and for a program
whose ingest has no such span (one that keeps parallel edges)."""

from port_bench.spans import setup_seconds


def read(rec):
    try:
        return setup_seconds(rec, "cgt/ingest.coalesce", "device_s")
    except LookupError:
        return None
