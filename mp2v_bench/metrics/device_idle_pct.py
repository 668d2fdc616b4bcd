"""device_idle_pct (device trace): the share of the traced window in
which no kernel, copy or memset ran on the device."""


def read(w):
    if w.trace is None or not w.trace.window_s:
        return None
    return 100 * (1 - w.trace.busy_s / w.trace.window_s)
