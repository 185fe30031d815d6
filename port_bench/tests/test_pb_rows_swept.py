"""The reader of ``kernels.spmv_rows_swept_pct``, on set-up spans as the
program keeps them: the column segments' span with its counters, without
them (a program older than hypersparse segments), and none (K = 1)."""

import pytest
from pb_helpers import BENCH

from port_bench import harness

INGEST = {"name": "cgt/ingest.compress", "parent": None, "start_s": 10.0, "end_s": 10.1,
          "host_s": 0.1, "device_s": 0.11, "counters": {"peak_bytes": 34698236928}}


def segments_span(start_s, **counters):
    span = {"name": "cgt/setup.spmv_segments", "parent": None, "start_s": start_s,
            "end_s": start_s + 0.5, "host_s": 0.5, "device_s": 0.4}
    if counters:
        span["counters"] = counters
    return span


def read(setup_spans):
    rec = dict(cell="kron27-mg.pagerank", analytic="pagerank", setup_spans=setup_spans)
    return harness.metric_reader(BENCH, "kernels.spmv_rows_swept_pct", "pagerank")(rec)


def test_the_reader_is_found_by_name():
    assert (harness.reader_path(BENCH, "kernels.spmv_rows_swept_pct", "pagerank")
            == BENCH / "metrics" / "kernels.spmv_rows_swept_pct.py")


@pytest.mark.parametrize("swept,dense,pct", [
    (12 * (1 << 26), 12 * (1 << 26), 100.0),  # every range dense
    (3 * (1 << 24) // 2, 3 * (1 << 24), 50.0),
    (0, 12 * (1 << 26), 0.0),  # every range empty
])
def test_rows_swept_pct_from_the_counters(swept, dense, pct):
    span = segments_span(11.0, rows_swept=swept, rows_dense=dense, hypersparse_segments=3)
    assert read([INGEST, span]) == pytest.approx(pct)


def test_the_newest_segments_are_read():
    older = segments_span(11.0, rows_swept=10, rows_dense=10, hypersparse_segments=0)
    newer = segments_span(12.0, rows_swept=4, rows_dense=10, hypersparse_segments=1)
    assert read([INGEST, older, newer]) == pytest.approx(40.0)


def test_nothing_to_read_reads_none():
    assert read(None) is None  # untraced, or a program older than the spans
    assert read([INGEST]) is None  # K = 1: nothing segmented
    assert read([INGEST, segments_span(11.0)]) is None  # a span without the counters
