"""Catalog collection for index builds.

Counterpart of the JAX package's ``indices/builder.py``: embed every
candidate batch with the candidate tower at one fixed batch size (the tail
batch is zero-padded, then trimmed after embedding) and concatenate.

- ``collect_catalog``: host numpy ids and embeddings, as the JAX package's.
- ``collect_catalog_device``: the (N, E) embeddings stay on the tower's
  device and never leave it; the ids are host numpy.
- ``iter_embedded_blocks``: one (ids, embed thunk) per batch, embedding only
  when the thunk is called.

The embedding runs under ``torch.no_grad()``. The streaming sharded build
(``place_catalog_rows``, ``collect_catalog_sharded``) takes a mesh and waits
for the distributed slice (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

Batch = Dict[str, np.ndarray]


def _pad_batch_rows(batch: Batch, batch_size: int, n: int) -> Batch:
    """Zero-pad each column to ``batch_size`` rows along axis 0. Oversized
    batches pass through unpadded."""
    if n >= batch_size:
        return batch

    def _pad(v):
        v = np.asarray(v)
        return np.pad(v, [(0, batch_size - n)] + [(0, 0)] * (v.ndim - 1))

    return {key: _pad(v) for key, v in batch.items()}


def collect_catalog(
    candidate_id_col: str,
    embed_fn: Callable[[Batch], torch.Tensor],
    batches: Iterable[Batch],
    batch_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns host ``(identifiers (N,), embeddings (N, E) float32)``."""
    ids_parts, emb_parts = [], []
    for ids, thunk in iter_embedded_blocks(
        candidate_id_col, embed_fn, batches, batch_size
    ):
        ids_parts.append(ids)
        emb_parts.append(thunk().cpu().numpy())
    return np.concatenate(ids_parts), np.concatenate(emb_parts)


def collect_catalog_device(
    candidate_id_col: str,
    embed_fn: Callable[[Batch], torch.Tensor],
    batches: Iterable[Batch],
    batch_size: int,
) -> Tuple[np.ndarray, torch.Tensor]:
    """Like ``collect_catalog``, but the embeddings never leave the tower's
    device: each batch's output is trimmed and concatenated there. Returns
    (identifiers (N,) numpy, embeddings (N, E) tensor)."""
    ids_parts, emb_parts = [], []
    for ids, thunk in iter_embedded_blocks(
        candidate_id_col, embed_fn, batches, batch_size
    ):
        ids_parts.append(ids)
        emb_parts.append(thunk())
    return np.concatenate(ids_parts), torch.cat(emb_parts)


def iter_embedded_blocks(
    candidate_id_col: str,
    embed_fn: Callable[[Batch], torch.Tensor],
    batches: Iterable[Batch],
    batch_size: int,
) -> Iterator[Tuple[np.ndarray, Callable[[], torch.Tensor]]]:
    """Yield ``(ids_block, embed_thunk)`` per candidate batch. The thunk runs
    the candidate tower lazily (under ``torch.no_grad()``) and returns the
    block's (n, E) embeddings where the tower put them, so a consumer that
    needs none of a block's rows skips its embedding."""
    for batch in batches:
        n = len(batch[candidate_id_col])
        padded = _pad_batch_rows(batch, batch_size, n)
        ids = np.asarray(padded[candidate_id_col])[:n]

        def thunk(padded=padded, n=n):
            with torch.no_grad():
                return embed_fn(padded)[:n]

        yield ids, thunk
