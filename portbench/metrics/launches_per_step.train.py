"""Train step: kernels the profiler saw in the traced window, per step."""


def read(win):
    tr = win.trace
    if tr is None or not tr.kernels or not tr.calls:
        return None
    return len(tr.kernels) / tr.calls
