"""Exact top-k driver: the refinement loop's rounds a query block of 128
rows, the program's counters ``topk_rounds.rounds`` over
``topk_rounds.blocks`` (``utils/tracing.py``). The counters are always on
and the window snapshots only the kernel launches, so they are read as
they stand after the window: over every batch of the run, warm-up and
traced part included. Nothing where the program has no such counters."""


def read(win):
    try:
        from hm_retrieval_tpu_torch.utils import tracing
    except ImportError:
        return None
    blocks = tracing.COUNTS.get("topk_rounds.blocks")
    if not blocks:
        return None
    return tracing.COUNTS["topk_rounds.rounds"] / blocks
