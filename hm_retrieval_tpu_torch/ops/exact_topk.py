"""Exact top-k by iterative PartialReduce refinement.

Counterpart of ``hm_retrieval_tpu/ops/exact_topk.py``. The fast path,
``approx_max_k`` (``ops/partial_reduce.py``: one read of the score matrix,
the hand-written kernel on the card), can drop true winners that share a
reduction bin with a larger element. This op makes it exact:

    scores = Q @ C^T  (materialized once, fp32)
    leaderboard <- approx_max_k(scores, k)          # round 1
    repeat:
        mask the already-returned elements to -inf  # scatter of B*k elems
        cand <- approx_max_k(masked, k)             # next bin maxima
        leaderboard <- top_k(leaderboard ++ cand)
        stop when max(cand) < tau_hat (current exact k-th best), per row

Correctness of the stop rule: an element x still hidden after a round has
an unmasked larger element y in its reduction bin (else x would be its
bin's max and be a candidate). y is itself <= the round's max candidate
(y is a bin max; even if y was not among the k returned, y <= round max).
So if round_max < tau_hat in a row, every hidden x satisfies
x <= y <= round_max < tau_hat and cannot belong to the true top-k;
stopping is safe and the leaderboard is exact. Each round masks the
current bin maxima, so every contested bin drains one element per round;
rounds needed = 1 + max number of larger same-bin elements above tau over
bins.

The masks are written into one copy of the scores; the caller's scores are
never written. Where the JAX package runs the rounds inside
``lax.while_loop``, the port reads the stop test on the host, one sync a
refinement round. The merge keeps the leaderboard first, so among equal
values the earlier round's element, then the lower bin, comes first.
"""

from __future__ import annotations

import torch

from hm_retrieval_tpu_torch.ops.bin_topk import plain_scores
from hm_retrieval_tpu_torch.ops.partial_reduce import approx_max_k
from hm_retrieval_tpu_torch.ops.topk import topk_pair


def exact_topk_scores(
    scores: torch.Tensor,  # (B, N) fp32
    k: int,
    max_rounds: int = 16,
    recall_target: float = 0.95,
):
    """Exact top-k of a materialized score matrix via iterative
    PartialReduce. Returns (values (B, k) fp32, columns (B, k) int32,
    rounds), unless ``max_rounds`` rounds end first: the leaderboard is then
    returned as it stands, as the JAX package does."""
    B, N = scores.shape
    if k > N:
        raise ValueError(f"k={k} > N={N}")
    lead_v, lead_i = approx_max_k(scores, k, recall_target)  # round 1
    masked = scores.clone()
    masked.scatter_(1, lead_i.long(), float("-inf"))
    rounds = 1
    while rounds < max_rounds:
        cand_v, cand_i = approx_max_k(masked, k, recall_target)
        lead_v, lead_i = topk_pair(
            torch.cat([lead_v, cand_v], dim=1),
            torch.cat([lead_i, cand_i], dim=1),
            k,
        )
        # Stop when this round's BEST new candidate is below the current
        # k-th best in every row (the k-th-candidate test is not sound: a
        # hidden element can sit just under a returned winner in its bin).
        rounds += 1
        if bool((cand_v[:, 0] < lead_v[:, k - 1]).all()):
            break
        masked.scatter_(1, cand_i.long(), float("-inf"))
    return lead_v, lead_i, rounds


def exact_topk_dot(
    queries: torch.Tensor,  # (B, E)
    candidates: torch.Tensor,  # (N, E)
    k: int,
    max_rounds: int = 16,
    recall_target: float = 0.95,
):
    """Scoring + exact iterative top-k: the (B, N) matrix is materialized
    once in fp32 (TF32 off on the card), then each round is one
    PartialReduce read and a B*k-element scatter. Returns (values (B, k),
    columns (B, k))."""
    scores = plain_scores(queries, candidates)
    v, i, _ = exact_topk_scores(
        scores, k, max_rounds=max_rounds, recall_target=recall_target
    )
    return v, i
