"""dist.collective_ms_per_step.<analytic>: on a cell across cards, the device
milliseconds of the collectives' kernels in rank 0's traced window, over
the analytic's steps (the program's ``cgt/step.<analytic>.*`` spans: a
PageRank iteration).

The port launches NCCL's kernels only inside its ``cgt/collective.*``
spans (``dist/mesh.py``, ``dist/mg_prims.py``); the run record names the
device's operations, not the spans they ran under, so the collectives'
kernels are told by NCCL's prefix among the breakdown's ``device_ops``
(the ten kinds of operation that took most time; a collective is one kind
a dtype). A kernel's time runs from its start to its end, so it holds the
wait for the slowest rank. None untraced, where the device ran nothing,
without steps, and where the program marks no collective (one older than
these spans, or a cell on one card)."""

from port_bench.spans import STEP

COLLECTIVE = "cgt/collective."
NCCL = "nccl"  # the prefix of NCCL's kernel names (ncclDevKernel_*, ncclKernel_*)


def read(rec):
    summary, profile = rec.get("spans"), rec.get("profile")
    if not summary or not profile or not profile["busy_s"]:
        return None
    counts = summary["counts"]
    if not any(name.startswith(COLLECTIVE) for name in counts):
        return None
    steps = sum(n for k, n in counts.items() if k.startswith(f"{STEP}{rec['analytic']}."))
    if not steps:
        return None
    seconds = sum(s for name, s in profile["device_ops"] if name.startswith(NCCL))
    return 1e3 * seconds / steps
