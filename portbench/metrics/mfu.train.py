"""Whole step: the fp32 matmul operations a step needs (towers forward
and backward, three products for the logits; ``reference/roofline.py``)
at the fp32 peak, times the steps of the measured part of a traced run,
over that part's seconds, in %."""

from portbench.reference.roofline import train_ideal_s


def read(win):
    if not win.calls or win.seconds <= 0:
        return None
    ideal = train_ideal_s(win.ctx.config, win.ctx.traffic["batch"])
    return 100.0 * ideal * win.calls / win.seconds
