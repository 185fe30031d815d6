"""One traced run of a cell with the program's spans read from the same
profiler window, on the card:

    python3 port_bench/spans_run.py --workload kron24.bfs --seed 7

from the root of a checkout. It runs the cell as ``run.py --workload ...
--trace 1`` does (the window cut to the traffic's ``trace_seconds``) and
prints the same result line on standard output. On standard error its
last line is one ``spans:`` JSON object (``spans.summarize``): each
``cgt/`` span's count and host time, the device's idle gaps split by span,
the checks of the spans against the profiler's counts, the most frequent
device operations, the program's set-up spans, and under ``per_layer``
the readings that rest on the spans (``spans.per_layer``). Exits non-zero,
printing nothing, without a CUDA card.

A stopgap: the harness hands its readers the aggregates of
``timing.read_profile`` and not the profiler's events, so this script
swaps ``timing.read_profile`` for the length of one ``harness.run_cell``.
It goes in the benchmark change that puts ``spans.read_spans(prof)`` and
the set-up spans into the run record; ``spans.per_layer`` then becomes the
code of the metrics' readers.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(root: Path, workload: str, seed: int, seconds: float, device, t_start: float):
    """(the result line's object, the ``spans:`` line's object) of one
    traced run of ``workload`` of the checkout ``root`` on ``device``."""
    from port_bench import harness, spans, timing

    read_profile, window = timing.read_profile, {}

    def read_both(prof, wall_s):
        window["spans"] = spans.read_spans(prof)
        window["device_ops"] = spans.device_op_counts(prof)
        return read_profile(prof, wall_s)

    timing.read_profile = read_both
    try:
        result = harness.run_cell(root, workload, seed, seconds, True, device, t_start, log=log)
    finally:
        timing.read_profile = read_profile
    setup = spans.program_setup_spans() or []
    analytic = harness.load_cell(root, workload).traffic["analytic"]
    return result, dict(window["spans"], device_op_counts=window["device_ops"], setup_spans=setup,
                        per_layer=spans.per_layer(window["spans"], setup, analytic,
                                                  result["device"]["busy_s"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=60.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: the spans are read on the card")
        return 2
    sys.path.insert(0, str(ROOT))
    result, line = run(ROOT, args.workload, args.seed, args.seconds, torch.device("cuda", 0),
                       T_START)
    print(json.dumps(result), flush=True)
    log("spans: " + json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
