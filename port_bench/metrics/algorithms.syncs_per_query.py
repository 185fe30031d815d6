"""algorithms.syncs_per_query.<analytic>: the program's blocking reads of
the device (its ``cgt/sync.*`` spans) in the traced window, over the calls
of the analytic (``cgt/algorithms.<analytic>``)."""

from port_bench.spans import SYNC, per_query


def read(rec):
    return per_query(rec, SYNC)
