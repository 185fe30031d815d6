"""setup.port_import_s: the host seconds of the program's set-up span
``cgt/setup.import`` (``import cugraph_tpu_torch``), from the traced run's
record; None for a program older than the spans."""

from port_bench.spans import setup_seconds


def read(rec):
    return setup_seconds(rec, "cgt/setup.import", "host_s")
