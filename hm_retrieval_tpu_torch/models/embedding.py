"""Per-feature embedding front-end: table gathers, numeric passthrough,
sequence pooling, concatenated into one (B, sum(E) + n_numeric) activation.

Counterpart of ``hm_retrieval_tpu/models/embedding.py``. Batches arrive as
int ids (0 = OOV / pad) and float32 numeric columns; table row 0 is the OOV
row. Gathers go through ``F.embedding``, whose backward on the card sums the
rows of duplicate ids after a sort, in the same order on every run.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from hm_retrieval_tpu_torch.schema.features import Feature, FeatureKind


def embedding_output_dim(features: List[Feature]) -> int:
    return sum(
        1 if f.kind == FeatureKind.NUMERIC else f.embedding_size
        for f in features
    )


def pool_sequence(
    f: Feature,
    ids: torch.Tensor,
    emb: torch.Tensor,
    attention_query: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, L, E) token embeddings -> (B, E), masking pad id 0.

    ``f.pooling == "mean"``: masked mean. ``"attention"``: softmax over
    valid positions of ``emb @ attention_query``. All-pad rows pool to
    zeros in both modes: the row max is clamped at -1e30 so exp() gives 0
    instead of nan, and the denominator is floored at 1e-30."""
    valid = ids != 0
    mask = valid.to(emb.dtype)  # (B, L)
    if f.pooling == "attention":
        scores = torch.einsum("ble,e->bl", emb, attention_query)
        scores = torch.where(
            valid, scores, torch.full_like(scores, float("-inf"))
        )
        row_max = scores.amax(dim=1, keepdim=True).clamp_min(-1e30)
        z = torch.exp(scores - row_max) * mask
        denom = z.sum(dim=1, keepdim=True).clamp_min(1e-30)
        return torch.einsum("bl,ble->be", z / denom, emb)
    denom = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    return (emb * mask[:, :, None]).sum(dim=1) / denom


def apply_embeddings(
    tables: Dict[str, torch.Tensor],
    features: List[Feature],
    batch: Dict[str, torch.Tensor],
    attention: Optional[Dict[str, torch.Tensor]] = None,
    rows: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Gather + concat. ``batch[name]`` is (B,) int for categorical
    features, (B, max_len) int for sequence features and (B,) float for
    numeric ones.

    ``rows``: optional pre-gathered table rows per feature ((B, E) /
    (B, L, E)) replacing the table lookups, the sparse optimizer's point
    of differentiation (``models/sparse_optimizer.py``). Pooling and
    concat stay shared, so the dense and sparse paths cannot drift
    apart."""
    parts = []
    for f in features:
        x = batch[f.name]
        if f.kind == FeatureKind.NUMERIC:
            parts.append(x.to(torch.float32)[:, None])
            continue
        if rows is not None and f.name in rows:
            emb = rows[f.name]
        else:
            emb = F.embedding(x.long(), tables[f.name])  # (B, E) / (B, L, E)
        if f.kind == FeatureKind.SEQUENCE:
            query = attention[f.name] if f.pooling == "attention" else None
            emb = pool_sequence(f, x, emb, query)
        parts.append(emb)
    return torch.cat(parts, dim=-1)
