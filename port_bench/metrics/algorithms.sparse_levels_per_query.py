"""algorithms.sparse_levels_per_query.<analytic>: the analytic's sparse
levels (``cgt/step.<analytic>.sparse`` spans: a push from the frontier's
vertices) in the traced window, over its calls."""

from port_bench.spans import STEP, per_query


def read(rec):
    return per_query(rec, f"{STEP}{rec['analytic']}.sparse")
