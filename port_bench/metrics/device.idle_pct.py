"""device.idle_pct.<analytic>: 1 - (the union of the device operations'
intervals) / (the traced window's wall), in %."""


def read(rec):
    p = rec["profile"]
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
