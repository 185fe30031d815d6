"""setup_s: process start to the first timed query (imports, the CUDA
context, loading or building the kernels, generation, ingest, warm-up)."""


def read(rec):
    return rec["setup_s"]
