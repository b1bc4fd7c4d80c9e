"""Exact top-k driver: mean host milliseconds of
``index.topk_from_embeddings`` a batch (it syncs the host inside), over
the measured part of a traced run."""


def read(win):
    s = win.spans.get("topk")
    return 1e3 * sum(s) / len(s) if s else None
