"""Closed-loop batch retrieval: one client sends a batch of int query
ids, waits for the ids of its top k, and sends the next.

A call is ``RetrievalService.embed`` (ids to the card, the query tower),
``index.topk_from_embeddings`` and the answered ids copied to the host;
its latency runs from the send to the ids on the host. Batches are
consecutive slices of a seeded permutation of every customer. A uniform
sample of ``check_batches`` of the window's calls (a reservoir drawn from
the seed, whatever the window's length) keeps its answers; the plain
reference judges them once the window has closed: the query tower, the
catalog the index holds (rebuilt by the reference's candidate tower), the
exact top-k and the kernels together.

Traffic keys: ``batch``, ``k`` (the index's k),
``warmup_calls``, ``trace_seconds``, ``check_batches``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from portbench import compare, inputs, system
from portbench.reference import two_tower as ref
from portbench.window import Recorder, stage, timed_loop


@dataclass
class Sut:
    service: object
    batches: np.ndarray
    feature: str
    first: int  # the window's first call
    keep: int  # answers kept, at most
    rng: np.random.Generator
    kept: Dict[int, Tuple[np.ndarray, torch.Tensor]] = field(default_factory=dict)

    def offer(self, i: int, answer) -> None:
        """Reservoir sampling over the window's calls: after n calls, each
        is kept with probability keep / n."""
        n = i - self.first
        if n < 0:
            return
        if len(self.kept) < self.keep:
            self.kept[i] = answer
            return
        j = int(self.rng.integers(n + 1))
        if j < self.keep:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = answer


def setup(ctx) -> Sut:
    from hm_retrieval_tpu_torch.serving import RetrievalService

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if len(cfg["query_features"]) != 1 or tr["k"] != cfg["index"]["k"]:
        raise ValueError("one query id feature, and the index's k")
    sch = system.schema(cfg)
    mdl = system.model(sch, dev)
    stage("schema and model")
    system.load_weights(mdl, inputs.make_weights(cfg, ctx.seed, dev))
    side = inputs.catalog_features(cfg, ctx.seed, dev)
    stage("weights")
    index = system.build_index(cfg, mdl, side, dev)
    del side
    stage("index")
    sut = Sut(RetrievalService(sch, mdl.query_tower, index, device=dev),
              inputs.customer_batches(cfg["n_customers"], tr["batch"], ctx.seed),
              cfg["query_features"][0]["name"], tr["warmup_calls"],
              tr["check_batches"],
              np.random.default_rng(inputs.sub_seed(ctx.seed, "check")))
    warm = Recorder(dev)
    for i in range(tr["warmup_calls"]):
        call(sut, i, warm)
        _sync(dev)
        stage(f"warm-up call {i}")
    return sut


def call(sut: Sut, i: int, rec) -> None:
    ids = sut.batches[i % len(sut.batches)]
    with rec.device_span("embed"):
        q = sut.service.embed({sut.feature: ids})
    with rec.span("topk"):
        scores, out = sut.service.index.topk_from_embeddings(q)
    with rec.span("ids_to_host"):
        host = out.cpu().numpy()
    sut.offer(i, (host, scores))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def launch_shapes(log):
    """Records (kernel, B, E, n_pad, L, keep, thresholds) of each launch
    of the exact kernels while the block runs."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    orig = bt._launch

    def wrapped(name, q, c_padded, L, n_valid, thr=(), keep=2, walk=0):
        log.append((name, q.shape[0], q.shape[1], c_padded.shape[0], L,
                    keep, bool(thr)))
        return orig(name, q, c_padded, L, n_valid, thr, keep, walk)

    bt._launch = wrapped
    try:
        yield
    finally:
        bt._launch = orig


def window(ctx, sut: Sut, seconds: float):
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    return timed_loop(ctx, seconds, lambda i, rec: call(sut, i, rec),
                      lambda: _sync(ctx.device), first=ctx.traffic["warmup_calls"],
                      launches=lambda: dict(bt.LAUNCHES), shapes=launch_shapes)


def end_to_end(ctx, win) -> Dict[str, float]:
    return {
        "retrieve_qps": win.calls * ctx.traffic["batch"] / win.seconds,
        "retrieve_p95_ms": float(np.percentile(win.latencies_s, 95)) * 1e3,
    }


def release(sut: Sut):
    """The kept answers, each with the query ids it answered; the rest of
    the program's state is dropped."""
    kept = {i: (sut.batches[i % len(sut.batches)], ids, scores)
            for i, (ids, scores) in sut.kept.items()}
    sut.kept.clear()
    sut.service = None
    return kept


def reference_side(ctx):
    """(weights, catalog embeddings) of the plain reference, rebuilt from
    the seed."""
    cfg, dev = ctx.config, ctx.device
    w = inputs.make_weights(cfg, ctx.seed, dev)
    side = inputs.catalog_features(cfg, ctx.seed, dev)
    with ref.matmul_precision(False):
        return w, ref.catalog(cfg, w, side)


def reference_scores(ctx, w, catalog, ids: np.ndarray, operands) -> torch.Tensor:
    cfg = ctx.config
    feature = cfg["query_features"][0]["name"]
    with ref.matmul_precision(False):
        q = ref.tower(cfg, w, "query",
                      {feature: torch.as_tensor(ids, device=ctx.device)})
        return ref.scores(q, catalog, operands)


def check(ctx, kept, win) -> Dict[str, float]:
    cfg = ctx.config
    if not kept:
        return {}
    w, catalog = reference_side(ctx)
    operands = getattr(torch, cfg["score_operands"])
    parts = []
    for _, (ids, got_ids, got_scores) in sorted(kept.items()):
        s = reference_scores(ctx, w, catalog, ids, operands)
        parts.append(compare.retrieval_numbers(
            s, torch.as_tensor(got_ids, device=ctx.device),
            got_scores.to(ctx.device), ctx.traffic["k"], cfg["n_articles"]))
        del s
    return compare.merge_max(parts)
