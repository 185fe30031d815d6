"""algorithms.idle_ms_per_step.<analytic>: the device's idle milliseconds
inside the analytic's steps (the program's ``cgt/step.<analytic>.*`` spans:
a PageRank iteration, a BFS level) in the traced window, over the steps;
each idle gap is cut at the spans' edges. None where the device ran
nothing."""

from port_bench.spans import idle_ms_per_step


def read(rec):
    return idle_ms_per_step(rec)
