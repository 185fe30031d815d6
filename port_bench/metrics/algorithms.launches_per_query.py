"""algorithms.launches_per_query.<analytic>: the device operations (kernels,
memsets, copies) in the traced window, over the queries in it."""


def read(rec):
    p = rec["profile"]
    if not p or not p["queries"]:
        return None
    return p["launches"] / p["queries"]
