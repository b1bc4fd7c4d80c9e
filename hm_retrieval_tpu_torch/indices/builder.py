"""Catalog collection for index builds.

Counterpart of the JAX package's ``indices/builder.py``: embed every
candidate batch with the candidate tower at one fixed batch size (the tail
batch is zero-padded, then trimmed after embedding) and concatenate.

- ``collect_catalog``: host numpy ids and embeddings, as the JAX package's.
- ``collect_catalog_device``: the (N, E) embeddings stay on the tower's
  device and never leave it; the ids are host numpy.
- ``iter_embedded_blocks``: one (ids, embed thunk) per batch, embedding only
  when the thunk is called.

- ``place_catalog_rows`` / ``collect_catalog_sharded``: the streaming
  sharded build. Rows flow block -> shard buffer -> shard, and each shard is
  finished on its own device straight from the tower's output, so no
  catalog-sized copy reaches the host.

The embedding runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import itertools
import logging
from typing import Callable, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

Batch = Dict[str, np.ndarray]

logger = logging.getLogger(__name__)


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


def place_catalog_rows(
    row_blocks: Iterable[Tuple[np.ndarray, Callable[[], object]]],
    num_rows: int,
    dim: int,
    mesh,
    quantize: bool = False,
    keep_fp32: bool = True,
    stats: dict = None,
):
    """Stream ``(ids_block, embed_thunk)`` row blocks (in catalog row order)
    into shards over the mesh's model axis, the JAX package's
    ``place_catalog_rows``. A thunk returns a tensor (where the tower put
    it) or host numpy. Each shard's (ceil(N/S), E) fp32 buffer lives on its
    column's first device and is finished there as soon as its rows have
    streamed past (``finish_shard``: per-row int8 codes with scale 0 on the
    pad rows when ``quantize``, the fp32 rows unless ``quantize`` and not
    ``keep_fp32``, the -inf bias, the ids), then copied to the other devices
    of its column.

    Returns ``(ids_host (total,) int32, placed)``: ``placed`` maps ``emb`` (or
    ``codes`` / ``scales``, plus ``emb`` with ``keep_fp32``), ``ids`` and
    ``bias`` to ``ShardedRows``, the layouts of ``shard_candidates`` and
    ``shard_candidates_quantized``. ``stats`` (optional dict) receives
    ``embedded_blocks``, ``rows_per_shard``, ``placed_bytes`` (the finished
    shards on the devices) and ``peak_device_bytes`` (the most the build's
    tensors held on the devices at once: finished shards, the buffer and one
    shard's temporaries), where the JAX package reports its host peak."""
    from hm_retrieval_tpu_torch.parallel.distributed_topk import (
        ShardedRows,
        finish_shard,
    )
    from hm_retrieval_tpu_torch.parallel.mesh import MODEL_AXIS

    S = mesh.shape[MODEL_AXIS]
    per = -(-num_rows // S)
    total = per * S
    ids_host = np.zeros((total,), np.int32)
    parts: Dict[str, list] = {}
    embedded_blocks = 0
    placed_bytes = peak = 0

    def nbytes(t):
        return t.numel() * t.element_size()

    def new_buffer(s):
        return torch.zeros((per, dim), dtype=torch.float32,
                           device=mesh.column(s)[0])

    def finalize(s, buf, fill):
        nonlocal placed_bytes, peak
        arrays = finish_shard(buf, fill, quantize, keep_fp32)
        arrays["ids"] = torch.from_numpy(ids_host[s * per : (s + 1) * per].copy())
        made = sum(nbytes(t) for t in arrays.values() if t is not buf)
        peak = max(peak, placed_bytes + nbytes(buf) + made)
        copies = len(mesh.column(s))
        placed_bytes += copies * sum(nbytes(t) for t in arrays.values())
        for name, t in arrays.items():
            parts.setdefault(name, []).append(t)

    cursor = s_cur = fill = 0
    buf = new_buffer(0)
    for ids_block, embed_thunk in row_blocks:
        nb = len(ids_block)
        if cursor + nb > total:
            raise ValueError(
                f"catalog stream yielded more than the declared {num_rows} "
                "rows"
            )
        ids_host[cursor : cursor + nb] = ids_block
        emb = embed_thunk()
        embedded_blocks += 1
        if not isinstance(emb, torch.Tensor):
            emb = torch.from_numpy(np.asarray(emb, np.float32))
        if tuple(emb.shape) != (nb, dim):
            raise ValueError(
                f"embed_fn returned {tuple(emb.shape)}, expected ({nb}, {dim})"
            )
        off = 0
        while off < nb:
            take = min(per - fill, nb - off)
            buf[fill : fill + take] = emb[off : off + take].to(buf.device)
            fill += take
            off += take
            cursor += take
            if fill == per:
                finalize(s_cur, buf, per)
                s_cur += 1
                fill = 0
                if s_cur < S:
                    buf = new_buffer(s_cur)
    if cursor != num_rows:
        raise ValueError(
            f"catalog stream yielded {cursor} rows, expected {num_rows}"
        )
    while s_cur < S:
        # the tail shard, then trailing shards with no real row (ceil
        # rounding leaves them when N is small): all-pad arrays
        finalize(s_cur, buf, fill)
        s_cur += 1
        fill = 0
        if s_cur < S:
            buf = new_buffer(s_cur)

    if stats is not None:
        stats["embedded_blocks"] = embedded_blocks
        stats["rows_per_shard"] = per
        stats["placed_bytes"] = placed_bytes
        stats["peak_device_bytes"] = peak
    placed = {name: ShardedRows(mesh, ts) for name, ts in parts.items()}
    logger.info(
        "Streamed %d catalog rows into %d model shards (%d rows/shard, "
        "%.1f MB on the devices)",
        num_rows,
        S,
        per,
        placed_bytes / 1e6,
    )
    return ids_host, placed


def collect_catalog_sharded(
    candidate_id_col: str,
    embed_fn: Callable[[Batch], torch.Tensor],
    batches: Iterable[Batch],
    batch_size: int,
    mesh,
    num_candidates: int = None,
    dim: int = None,
    quantize: bool = False,
    keep_fp32: bool = True,
    stats: dict = None,
):
    """Sharded-build entry: embed the catalog in batches of one fixed size
    and stream the rows into shards over the mesh's model axis
    (``place_catalog_rows``). Returns ``(ids_host, placed, num_candidates)``.

    ``num_candidates`` should come from the dataset manifest
    (``ShardDataset.num_rows``); without it the feature batches are
    materialized once to count the rows. Without ``dim`` the first batch is
    embedded once to read the width."""
    if num_candidates is None:
        batches = list(batches)
        num_candidates = sum(len(b[candidate_id_col]) for b in batches)
    if dim is None:
        it = iter(batches)
        first = next(it, None)
        if first is None:
            raise ValueError("no candidate batches")
        batches = itertools.chain([first], it)
        n0 = len(first[candidate_id_col])
        with torch.no_grad():
            dim = int(embed_fn(_pad_batch_rows(first, batch_size, n0)).shape[1])
    blocks = iter_embedded_blocks(candidate_id_col, embed_fn, batches,
                                  batch_size)
    ids_host, placed = place_catalog_rows(
        blocks,
        num_candidates,
        dim,
        mesh,
        quantize=quantize,
        keep_fp32=keep_fp32,
        stats=stats,
    )
    return ids_host, placed, num_candidates
