"""Exact top-k driver: the program's reads of the card's flags on the
host (each a wait for the card), a batch: the counter
``topk_rounds.host_syncs`` (``utils/tracing.py``) over every batch of the
run (the warm-up calls, the traced part's and the measured part's). The
counter is always on and the window snapshots only the kernel launches,
so it is read as it stands after the window. Nothing where the program
has no such counter."""


def read(win):
    try:
        from hm_retrieval_tpu_torch.utils import tracing
    except ImportError:
        return None
    syncs = tracing.COUNTS.get("topk_rounds.host_syncs")
    calls = (win.ctx.traffic["warmup_calls"] + win.calls
             + (win.trace.calls if win.trace is not None else 0))
    if not syncs or not calls:
        return None
    return syncs / calls
