"""algorithms.host_reads_per_query.<analytic>: the host reads of a device scalar
(``aten::_local_scalar_dense``: each item(), float(), bool() or int() of a
device tensor) in the traced window, over the queries in it."""


def read(rec):
    p = rec["profile"]
    if not p or not p["queries"]:
        return None
    return p["host_reads"] / p["queries"]
