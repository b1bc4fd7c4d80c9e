"""Exact top-k: score + select, with the JAX package's tie order.

Counterpart of ``hm_retrieval_tpu/ops/topk.py``. ``lax.top_k`` and the
stable ``lax.sort`` order equal values by position, lower position first.
``torch.topk`` promises no order among ties, so every selection here is a
stable descending ``torch.sort``, whose ties keep their input order.

- ``topk_dot``: one (B, N) score matrix, then the top-k.
- ``topk_dot_chunked``: a loop over N-chunks keeping a running (B, k)
  leaderboard, so the (B, N) matrix is never materialized.
- ``merge_topk``: merge of per-shard (B, k) leaderboards, the reduction step
  of a catalog split into shards.
"""

from __future__ import annotations

import torch

# id of a slot no row filled (jnp.take's fill value for int32)
MISSING_ID = -(2**31)


def ids_at(identifiers: torch.Tensor, rows: torch.Tensor, n: int):
    """``identifiers[rows]`` for rows in [0, n); any other row (the
    ``BIG_IDX`` of a slot no row filled) maps to ``MISSING_ID`` rather than
    raising in the gather."""
    valid = (rows >= 0) & (rows < n)
    ids = identifiers[rows.clamp(0, n - 1).long()]
    return torch.where(valid, ids, torch.full_like(ids, MISSING_ID))


def topk_pair(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Row-wise top-k over (value, id) pairs, ids carried as payload.
    Returns ((..., k) values, (..., k) ids)."""
    if k > vals.shape[-1]:
        raise ValueError(f"k={k} exceeds input width {vals.shape[-1]}")
    v, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], torch.gather(ids, -1, order[..., :k])


def topk_dot(queries: torch.Tensor, candidates: torch.Tensor, k: int):
    """(scores (B, k), indices (B, k)): exact top-k of Q @ C^T in fp32."""
    scores = queries.to(torch.float32) @ candidates.to(torch.float32).T
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds input width {scores.shape[-1]}")
    v, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[:, :k], order[:, :k]


def topk_dot_chunked(
    queries: torch.Tensor,  # (B, E)
    candidates: torch.Tensor,  # (N, E), N divisible by chunk_size
    k: int,
    chunk_size: int = 4096,
):
    """Streaming exact top-k: each chunk's top-k is merged into a running
    (B, k) leaderboard, the leaderboard first, so ties keep the lower
    catalog row first as in one sort over (B, N). Peak memory is
    O(B * chunk + B * 2k). Returns (scores (B, k) fp32, rows (B, k) int32);
    slots no row could fill hold -inf and row 0."""
    B, E = queries.shape
    N = candidates.shape[0]
    if N % chunk_size != 0:
        raise ValueError(
            f"N={N} must be divisible by chunk_size={chunk_size}; pad the "
            "candidate matrix (pad rows score -inf via zero embeddings "
            "+ masking at call site)"
        )
    kc = min(k, chunk_size)
    q = queries.to(torch.float32)
    best_s = torch.full((B, k), float("-inf"), device=queries.device)
    best_i = torch.zeros((B, k), dtype=torch.int32, device=queries.device)
    cols = torch.arange(chunk_size, dtype=torch.int32, device=queries.device)
    for start in range(0, N, chunk_size):
        s = q @ candidates[start : start + chunk_size].to(torch.float32).T
        cs, ci = topk_pair(s, (cols + start).expand(B, -1), kc)
        best_s, best_i = topk_pair(
            torch.cat([best_s, cs], dim=1), torch.cat([best_i, ci], dim=1), k
        )
    return best_s, best_i


def merge_topk(
    shard_scores: torch.Tensor,  # (S, B, k) per-shard top-k scores
    shard_ids: torch.Tensor,  # (S, B, k) per-shard candidate ids
    k: int,
):
    """Merge S per-shard leaderboards into the global (B, k) top-k; equal
    scores keep shard order, then each shard's own order."""
    S, B, ks = shard_scores.shape
    flat_s = shard_scores.permute(1, 0, 2).reshape(B, S * ks)
    flat_i = shard_ids.permute(1, 0, 2).reshape(B, S * ks)
    return topk_pair(flat_s, flat_i, k)
