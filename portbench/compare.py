"""The comparisons that decide ``correct``: the numbers each kind of cell
compares with the plain reference, and the rule that holds them to their
limits. Norms are summed in float64, in blocks, so a 1.37M-row table
needs no float64 copy of itself.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

BLOCK = 1 << 24  # elements a block of a float64 sum


def first_grad_norms(acc: Dict[str, torch.Tensor], acc0: float) -> Dict[str, float]:
    """{leaf: the norm of the gradient that the first Adagrad step added
    to the accumulator}: sqrt(sum(acc - acc0)), the difference taken in
    fp32 (exact where acc lies within a factor 2 of acc0) and summed in
    float64."""
    out = {}
    for name, a in acc.items():
        flat = a.reshape(-1)
        total = sum(float((flat[s:s + BLOCK] - acc0).double().sum())
                    for s in range(0, flat.numel(), BLOCK))
        out[name] = math.sqrt(max(total, 0.0))
    return out


def change_norms(after: Dict[str, torch.Tensor],
                 before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{leaf: ||after - before||}, in blocks."""
    out = {}
    for name, a in after.items():
        fa, fb = a.detach().reshape(-1), before[name].reshape(-1)
        out[name] = math.sqrt(sum(
            float((fa[s:s + BLOCK] - fb[s:s + BLOCK]).double().square().sum())
            for s in range(0, fa.numel(), BLOCK)))
    return out


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: List[str]) -> float:
    """max over ``leaves`` of |prog - ref| / max(ref of the leaf, the
    median leaf's ref): the gap between the two norms, not the norm of the
    difference; the median guards leaves whose norm is all but zero."""
    med = statistics.median(ref[n] for n in ref)
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves]
    return max(gaps) if gaps else 0.0


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """A training cell's numbers from each side's ``losses`` (the checked
    steps), ``grad`` (first step's gradient norm a leaf) and ``change``
    (the parameters' change over the checked steps, a leaf):
    ``loss1_gap``, the first step's loss; ``grad_gap`` and
    ``change_gap``, each by its worst leaf. The change leaves out
    leaves whose reference gradient is under a thousandth of the median
    leaf's: Adagrad moves those by round-off."""
    loss1_gap = math.inf
    if prog["losses"] and len(prog["losses"]) == len(ref["losses"]):
        p, r = prog["losses"][0], ref["losses"][0]
        loss1_gap = abs(p - r) / abs(r)
    med_grad = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= 1e-3 * med_grad]
    return {
        "loss1_gap": loss1_gap,
        "grad_gap": worst_leaf_gap(prog["grad"], ref["grad"], list(ref["grad"])),
        "change_gap": worst_leaf_gap(prog["change"], ref["change"], moving),
    }


@torch.no_grad()
def retrieval_numbers(ref_scores: torch.Tensor, got_ids: torch.Tensor,
                      got_scores: torch.Tensor, k: int,
                      n_articles: int) -> Dict[str, float]:
    """One batch's numbers. ``ref_scores``: (B, N) reference scores of
    articles 1..N; ``got_ids`` / ``got_scores``: the program's (B, k)
    answer. ``id_gap``: the widest gap by which an answered article's
    reference score lies below the reference's k-th best, over the row's
    best reference score; ``score_err``: the widest gap between an answered
    score and the reference's score of that article, on the same scale;
    ``malformed_rows``: rows with an id outside 1..N, a repeated id, fewer
    than k answers, a non-finite score or scores out of order."""
    B = ref_scores.shape[0]
    if tuple(got_ids.shape) != (B, k) or tuple(got_scores.shape) != (B, k):
        return {"id_gap": math.inf, "score_err": math.inf,
                "malformed_rows": float(B)}
    ids = got_ids.long()
    bad = ((ids < 1) | (ids > n_articles)).any(dim=1)
    bad |= ~torch.isfinite(got_scores).all(dim=1)
    bad |= (got_scores[:, 1:] > got_scores[:, :-1]).any(dim=1)
    srt = ids.sort(dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    top = ref_scores.topk(k, dim=1).values
    scale = top[:, 0].abs().clamp_min(1e-30)
    at = ref_scores.gather(1, (ids - 1).clamp(0, n_articles - 1))
    gap = (top[:, -1:] - at).clamp_min(0).amax(dim=1) / scale
    err = (got_scores - at).abs().amax(dim=1) / scale
    ok = ~bad
    return {
        "id_gap": float(gap[ok].max()) if ok.any() else 0.0,
        "score_err": float(err[ok].max()) if ok.any() else 0.0,
        "malformed_rows": float(bad.sum()),
    }


def merge_max(parts: List[Dict[str, float]]) -> Dict[str, float]:
    """Worst of each number over batches; row counts add up."""
    out: Dict[str, float] = {}
    for part in parts:
        for name, v in part.items():
            if name == "malformed_rows":
                out[name] = out.get(name, 0.0) + v
            else:
                out[name] = max(out.get(name, -math.inf), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit; a NaN or a missing number
    fails."""
    return all(name in numbers and numbers[name] <= limit
               for name, limit in limits.items())
