"""gteps.<analytic>: the nominal edges of every query completed in the window
(``queries/<analytic>.py:nominal_edges``), over the window's seconds, / 1e9."""


def read(rec):
    if not rec["latencies_s"]:
        return None
    return sum(rec["nominal_edges"]) / rec["window_s"] / 1e9
