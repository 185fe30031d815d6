"""algorithms.dense_levels_per_query.<analytic>: the analytic's dense levels
(``cgt/step.<analytic>.dense`` spans: a min-plus sweep over every vertex)
in the traced window, over its calls."""

from port_bench.spans import STEP, per_query


def read(rec):
    return per_query(rec, f"{STEP}{rec['analytic']}.dense")
