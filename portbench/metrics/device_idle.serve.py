"""``device_idle.serve``: the share of the traced window in which no kernel
or copy ran on the device, in percent."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0 or run.readings.get("kind") != "serve":
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
