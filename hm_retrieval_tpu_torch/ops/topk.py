"""Exact top-k: score + select, with the JAX package's tie order.

Counterpart of ``hm_retrieval_tpu/ops/topk.py``. ``lax.top_k`` and the
stable ``lax.sort`` order equal values by position, lower position first.
``torch.topk`` promises no order among ties, so every selection here is a
stable descending ``torch.sort``, whose ties keep their input order.
"""

from __future__ import annotations

import torch


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
