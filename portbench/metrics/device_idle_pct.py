"""``device_idle_pct.<cell kind>``: the share of the traced window in
which nothing ran on the device: 1 - (the union of its kernel, copy and
set intervals) / the window, in percent.  Nothing to read where the
trace holds no device interval (a run on the CPU)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
