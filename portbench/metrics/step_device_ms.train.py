"""Train step: milliseconds in which an operation ran on the card in the
traced window, per step."""


def read(win):
    tr = win.trace
    if tr is None or not tr.device_ops or not tr.calls:
        return None
    return 1e3 * tr.busy_s / tr.calls
