"""kernels.<analytic>_roofline: the compulsory bytes of the traced queries
(``queries/<analytic>.py:compulsory_bytes``) over the datasheet's 3.35 TB/s,
over the device's busy time in the traced window (every kernel the queries
launched), in %."""

from port_bench.timing import bound_s


def read(rec):
    p = rec["profile"]
    if not p or not p["busy_s"]:
        return None
    return 100.0 * bound_s(p["bytes"]) / p["busy_s"]
