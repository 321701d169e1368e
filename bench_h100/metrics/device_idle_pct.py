"""device_idle_pct: the share of the traced window, in %, in which no
operation ran on the device: 100 x (1 - the union of device operations /
the window)."""

from bench_h100.trace import busy_us


def read(record: dict):
    trace = record.get("trace")
    if not trace:
        return None
    lo, hi = trace["window_us"]
    return 100.0 * (1.0 - busy_us(trace) / (hi - lo)) if hi > lo else None
