"""Whole batch: the least time the card needs for the batches of the
measured part of a traced run (the query tower's matmuls at the fp32
peak, one scoring of the real catalog at the bf16 peak,
``reference/roofline.py``), over that part's seconds, in %."""

from portbench.reference.roofline import retrieve_ideal_s


def read(win):
    if not win.calls or win.seconds <= 0:
        return None
    ideal = retrieve_ideal_s(win.ctx.config, win.ctx.traffic["batch"])
    return 100.0 * ideal * win.calls / win.seconds
