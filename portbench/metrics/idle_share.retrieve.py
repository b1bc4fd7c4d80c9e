"""Card: the share of the traced window in which no operation ran on the
device, in %."""


def read(win):
    tr = win.trace
    if tr is None or not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
