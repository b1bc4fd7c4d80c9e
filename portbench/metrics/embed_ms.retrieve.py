"""Query tower: mean CUDA-event milliseconds of ``RetrievalService.embed``
a batch (the ids' copy to the card and the tower), over the measured part
of a traced run."""


def read(win):
    ms = win.device_spans.get("embed")
    return sum(ms) / len(ms) if ms else None
