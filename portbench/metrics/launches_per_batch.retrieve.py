"""Kernel wrappers: the program's ``ops/bin_topk.py::LAUNCHES`` counters,
summed over the measured part of a traced run, per batch."""


def read(win):
    if not win.counters or not win.calls:
        return None
    return sum(win.counters.values()) / win.calls
