"""ingest.build_s: the benchmark's own span around the port's
``from_edgelist(..., symmetrize=True)`` in set-up, ending in a
synchronize."""


def read(rec):
    return rec["ingest_build_s"]
