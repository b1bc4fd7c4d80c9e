"""Catalog collection for index builds.

Counterpart of ``collect_catalog`` in the JAX package's
``indices/builder.py``: embed every candidate batch with the candidate tower
at one fixed batch size (the tail batch is zero-padded, then trimmed after
embedding) and concatenate. The embeddings stay where the tower put them,
on the card for a model on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

Batch = Dict[str, np.ndarray]


def _pad_rows(v, batch_size: int, n: int) -> np.ndarray:
    v = np.asarray(v)
    return np.pad(v, [(0, batch_size - n)] + [(0, 0)] * (v.ndim - 1))


@torch.no_grad()
def collect_catalog(
    candidate_id_col: str,
    embed_fn: Callable[[Batch], torch.Tensor],
    batches: Iterable[Batch],
    batch_size: int,
) -> Tuple[np.ndarray, torch.Tensor]:
    """Returns (identifiers (N,) numpy, embeddings (N, E) tensor)."""
    ids_parts, emb_parts = [], []
    for batch in batches:
        n = len(batch[candidate_id_col])
        if n < batch_size:
            batch = {key: _pad_rows(v, batch_size, n) for key, v in batch.items()}
        emb_parts.append(embed_fn(batch)[:n])
        ids_parts.append(np.asarray(batch[candidate_id_col])[:n])
    return np.concatenate(ids_parts), torch.cat(emb_parts)
