"""kernels.spmv_rows_swept_pct: the rows the SpMVs' column segments walk in
a sweep, as a share of K passes over every major: 100 x ``rows_swept`` /
``rows_dense``, the counters of the program's newest set-up span
``cgt/setup.spmv_segments`` (the segments of the graph this run built;
rank 0's on a cell across cards), from the traced run's record. 100 where
every range is dense; lower where hypersparse ranges walk only their rows
with an edge. None untraced, where nothing is segmented (K = 1: no such
span), and for a program whose span keeps no such counters."""

SPAN = "cgt/setup.spmv_segments"


def read(rec):
    kept = [s for s in rec.get("setup_spans") or () if s["name"] == SPAN]
    counters = kept[-1].get("counters", {}) if kept else {}
    if "rows_swept" not in counters or not counters.get("rows_dense"):
        return None
    return 100.0 * counters["rows_swept"] / counters["rows_dense"]
