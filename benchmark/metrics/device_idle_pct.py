"""device_idle_pct: 1 - (the union of the trace's device intervals over the
traced model's host seconds), in percent."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
