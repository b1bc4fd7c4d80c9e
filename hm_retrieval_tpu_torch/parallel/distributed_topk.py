"""Top-k over a catalog row-sharded across a mesh's model axis.

Counterpart of the JAX package's ``parallel/distributed_topk.py``. The
catalog is cut into S shards of ``per = ceil(N / S)`` rows; shard s lives on
the devices of the mesh's column s (``ShardedRows``), its pad rows carry a
-inf score bias, and each shard scores the queries and keeps its own (B, kk)
leaderboard, kk = min(k, per). The leaderboards are gathered onto the mesh's
first device, flattened shard-major (shard 0's kk first) and merged with the
stable ``topk_pair``, so equal scores keep the order one device would give
them. The query rows are split over the data axis (the JAX indices'
``data_sharded_queries``): data row d scores its share against the shards
on ``devices[d]``.

In one process every shard runs in turn (``parallel/mesh.py``). In a
process group each rank runs only its own cells, on the whole query batch,
which every rank passes (JAX replicates the queries); the cells'
leaderboards are all-gathered in (d, s) order and every rank runs the same
shard-major merge, so every rank answers the same bits as one process.

Per-shard engines:

- exact ``"xla"``: one fp32 product plus the bias, then ``topk_pair`` (the
  JAX package computes this product outside any Pallas kernel);
- exact ``"pallas"``: ``exact_topk`` (kernels 1-2 on the card) on ``[q | 1]``
  against ``[emb | bias]``, the bias folded in as an extra column so the pad
  rows score -inf inside the kernel's product (E + 1 columns, padded to a
  multiple of 16);
- quantized ``"pallas"``: ``quantized_topk`` (kernels 3-4, or 6-7 with
  ``pallas_rounds > 1``) with the bias, after ``shrink_survivors``; the
  sentinel rows of unfilled slots are clamped before any gather;
- quantized ``"scan"``: int8 queries times the shard's codes, then
  ``approx_max_k`` at the index's ``recall_target`` (``ops/partial_reduce.py``,
  the PartialReduce kernel on the card), as the JAX package's
  ``lax.approx_max_k`` on a TPU (its CPU fallback is exact).

Then, with the fp32 rows, an exact rescore of each shard's survivors before
the merge.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.ops import quantized_topk as qt
from hm_retrieval_tpu_torch.ops.partial_reduce import approx_max_k
from hm_retrieval_tpu_torch.ops.topk import ids_at, merge_topk, topk_pair
from hm_retrieval_tpu_torch.parallel.collectives import fill
from hm_retrieval_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


class ShardedRows:
    """Rows of a (total, ...) array split over a mesh's model axis: shard s
    holds rows ``s*per .. (s+1)*per - 1`` and has one copy on each distinct
    device of this process's cells of column s (a repeated device holds one
    copy); ``None`` in ``shards`` for a column another rank holds."""

    def __init__(self, mesh: Mesh, shards: Sequence[Optional[torch.Tensor]]):
        if len(shards) != mesh.shape[MODEL_AXIS]:
            raise ValueError(
                f"{len(shards)} shards for a model axis of "
                f"{mesh.shape[MODEL_AXIS]}"
            )
        self.mesh = mesh
        self._copies: List[Optional[Dict[torch.device, torch.Tensor]]] = [
            None if t is None else {dev: t.to(dev) for dev in mesh.column(s)}
            for s, t in enumerate(shards)
        ]
        self._local = [s for s, c in enumerate(self._copies) if c is not None]
        self.per = self.shard(self._local[0]).shape[0]

    @property
    def shape(self) -> Tuple[int, ...]:
        rest = tuple(self.shard(self._local[0]).shape[1:])
        return (self.per * len(self._copies),) + rest

    @property
    def dtype(self) -> torch.dtype:
        return self.shard(self._local[0]).dtype

    def shard(self, s: int, device: Optional[torch.device] = None):
        """Shard s on ``device`` (default: its column's first device); a
        shard another rank holds raises ``KeyError``."""
        copies = self._copies[s]
        if copies is None:
            raise KeyError(f"shard {s} is held by rank "
                           f"{self.mesh.col_owner(s)}")
        return next(iter(copies.values())) if device is None else copies[device]

    def gathered(self, s: int) -> torch.Tensor:
        """Shard s on this process's first device; in a process group,
        collective: every rank calls it, and the shard is broadcast from
        its owner (one shard in flight, as JAX's ``_gathered_shard``)."""
        first = self.mesh.first_device
        if self.mesh.process_count == 1:
            return self.shard(s).to(first)
        from hm_retrieval_tpu_torch.parallel.collectives import (
            broadcast_from,
        )

        like = self.shard(self._local[0])
        mine = self.shard(s) if self._copies[s] is not None else None
        return broadcast_from(mine, like.shape, like.dtype, first,
                              self.mesh.col_owner(s))

    def shards(self) -> List[torch.Tensor]:
        """Every shard in order, on this process's first device (collective
        in a process group: ``gathered``)."""
        if self.mesh.process_count == 1:
            return [self.shard(s) for s in range(len(self._copies))]
        return [self.gathered(s) for s in range(len(self._copies))]

    def numpy(self) -> np.ndarray:
        """The (total, ...) array on the host, shard by shard (collective in
        a process group)."""
        return np.concatenate([t.cpu().numpy() for t in self.shards()])


def shard_rows(rows, lo: int, per: int, device: torch.device) -> torch.Tensor:
    """Rows ``lo .. lo + per - 1`` of ``rows`` (numpy or tensor) as a fp32
    (per, E) tensor on ``device``, zero past the end of ``rows``."""
    part = rows[lo : lo + per]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part, np.float32))
    out = torch.zeros((per,) + tuple(part.shape[1:]), dtype=torch.float32,
                      device=device)
    out[: part.shape[0]] = part.detach().to(device, torch.float32)
    return out


def finish_shard(
    buf: torch.Tensor, fill: int, quantize: bool, keep_fp32: bool = True
) -> Dict[str, torch.Tensor]:
    """One shard's device arrays from its (per, E) fp32 rows, of which the
    first ``fill`` are real: ``emb`` (or ``codes`` and ``scales``, plus
    ``emb`` with ``keep_fp32``) and ``bias`` (0, -inf on the pad rows). The
    codes are ``quantize_pad_device``'s, with scale 0 on the pad rows."""
    from hm_retrieval_tpu_torch.indices.quantized import quantize_pad_device

    per = buf.shape[0]
    if quantize:
        codes, scales, bias, emb, _ = quantize_pad_device(
            buf[:fill], per, "per_row", keep_fp32
        )
        out = {"codes": codes, "scales": scales, "bias": bias}
        if keep_fp32:
            out["emb"] = emb
        return out
    bias = torch.zeros(per, dtype=torch.float32, device=buf.device)
    bias[fill:] = float("-inf")
    return {"emb": buf, "bias": bias}


def _shard_ids(identifiers: np.ndarray, lo: int, per: int) -> torch.Tensor:
    ids = np.zeros((per,), np.int32)
    part = np.asarray(identifiers[lo : lo + per], np.int32)
    ids[: len(part)] = part
    return torch.from_numpy(ids)


def _place(mesh: Mesh, embeddings, identifiers, quantize, keep_fp32):
    S = mesh.shape[MODEL_AXIS]
    n = len(identifiers)
    per = -(-n // S)
    parts: Dict[str, List[torch.Tensor]] = {}
    for s in range(S):
        if not mesh.column(s):  # another rank's shard
            for name in parts:
                parts[name].append(None)
            continue
        lo = s * per
        dev = mesh.column(s)[0]
        fill = max(0, min(per, n - lo))
        arrays = finish_shard(
            shard_rows(embeddings, lo, per, dev), fill, quantize, keep_fp32
        )
        arrays["ids"] = _shard_ids(identifiers, lo, per)
        for name, t in arrays.items():
            parts.setdefault(name, [None] * s).append(t)
    return {name: ShardedRows(mesh, ts) for name, ts in parts.items()}


def shard_candidates(
    embeddings, identifiers: np.ndarray, mesh: Mesh
) -> Tuple[ShardedRows, ShardedRows, ShardedRows]:
    """Pad and place (embeddings, identifiers, score bias) row-sharded over
    the model axis. ``embeddings`` is (N, E) numpy or a tensor; each shard is
    cut from it on its own device."""
    placed = _place(mesh, embeddings, identifiers, False, True)
    return placed["emb"], placed["ids"], placed["bias"]


def shard_candidates_quantized(
    embeddings, identifiers: np.ndarray, mesh: Mesh, keep_fp32: bool = True
):
    """Pad, quantize and place the catalog row-sharded over the model axis:
    (codes int8, scales, fp32 rows or None, ids, bias). Each shard is
    quantized on its device with ``quantize_pad_device``, the numerics of
    the host ``quantize_rows``."""
    placed = _place(mesh, embeddings, identifiers, True, keep_fp32)
    return (placed["codes"], placed["scales"], placed.get("emb"),
            placed["ids"], placed["bias"])


def _sharded_call(mesh: Mesh, k: int, local):
    """``fn(queries)``: ``local(q, s, dev)`` -> (scores, ids) per (query
    share, shard) of this process's cells, the others' from their ranks,
    and each share's S leaderboards merged shard-major on this process's
    first device. B must divide by the data axis size."""
    first = mesh.first_device
    D = mesh.shape[DATA_AXIS]
    S = mesh.shape[MODEL_AXIS]

    def run(queries: torch.Tensor):
        B = queries.shape[0]
        if B % D:
            raise ValueError(f"B={B} must divide by the data axis size {D}")
        shares = queries.split(B // D) if B else [queries] * D
        boards = [
            {"scores": v.to(first), "ids": i.to(first)}
            for v, i in (local(shares[d], s, mesh.devices[d, s])
                         for d in range(D) for s in range(S)
                         if mesh.is_local(d, s))
        ]
        if mesh.process_count > 1:
            # every cell's leaderboard, from the rank that owns it
            cells: List[Optional[dict]] = [None] * (D * S)
            mine = [d * S + s for d in range(D) for s in range(S)
                    if mesh.is_local(d, s)]
            for c, board in zip(mine, boards):
                cells[c] = board

            def keys_of(r):
                return [d * S + s for d in range(D) for s in range(S)
                        if mesh.ranks[d, s] == r]

            boards = fill(cells, keys_of,
                          lambda c: int(mesh.ranks[c // S, c % S]))
        out_s, out_i = [], []
        for d in range(D):
            row = boards[d * S:(d + 1) * S]
            v, i = merge_topk(torch.stack([b["scores"] for b in row]),
                              torch.stack([b["ids"] for b in row]), k)
            out_s.append(v)
            out_i.append(i)
        return torch.cat(out_s), torch.cat(out_i)

    return run


def make_distributed_topk(mesh: Mesh, k: int, method: str = "xla"):
    """Returns ``topk(queries, emb, ids, bias) -> (scores (B, k), ids (B,
    k))`` on the mesh's first device, over shards placed by
    ``shard_candidates``. ``method``: "xla" (fp32 product + bias + top-k)
    or "pallas" (``exact_topk`` on the bias-augmented bf16 operands)."""
    if method not in ("xla", "pallas"):
        raise ValueError(f"unknown method {method!r}")

    def topk(queries, emb: ShardedRows, ids: ShardedRows, bias: ShardedRows):
        def local(q, s, dev):
            q = q.to(dev, torch.float32)
            emb_s, bias_s = emb.shard(s, dev), bias.shard(s, dev)
            kk = min(k, emb_s.shape[0])
            if method == "pallas":
                ones = torch.ones((q.shape[0], 1), device=dev)
                ls, li, _ = bt.exact_topk(
                    torch.cat([q, ones], dim=1),
                    torch.cat([emb_s, bias_s[:, None]], dim=1),
                    kk,
                )
            else:
                scores = bt.plain_scores(q, emb_s) + bias_s
                cols = torch.arange(
                    emb_s.shape[0], dtype=torch.int32, device=dev
                ).expand_as(scores)
                ls, li = topk_pair(scores, cols, kk)
            ids_s = ids.shard(s, dev)
            return ls, ids_at(ids_s, li, ids_s.shape[0])

        return _sharded_call(mesh, k, local)(queries)

    return topk


def make_distributed_quantized_topk(
    mesh: Mesh,
    k: int,
    oversample: int = 4,
    recall_target: float = 0.95,
    method: str = "scan",
    pallas_rounds: int = 1,
    pallas_fold: Optional[int] = None,
):
    """Returns ``topk(queries, codes, scales, emb_or_None, ids, bias) ->
    ((B, k) scores, (B, k) ids)`` on the mesh's first device, over shards
    placed by ``shard_candidates_quantized``. Per shard: ``oversample * kk``
    survivors from the int8 rows (``method`` "scan" or "pallas"), an exact
    fp32 rescore of them when fp32 rows are passed (``emb``, as in the JAX
    package), and the shard's top kk; then the shard-major merge. The
    scan's survivors are ``approx_max_k`` at ``recall_target``: approximate
    wherever a shard reduces."""
    if method not in ("scan", "pallas"):
        raise ValueError(f"unknown method {method!r}")
    from hm_retrieval_tpu_torch.indices.quantized import (
        _int_scores,
        quantize_queries,
        rescore_survivors,
        shrink_survivors,
    )
    def topk(queries, codes, scales, emb, ids, bias):
        def local(q, s, dev):
            q = q.to(dev, torch.float32)
            codes_s, scales_s = codes.shard(s, dev), scales.shard(s, dev)
            bias_s = bias.shard(s, dev)
            n_local = codes_s.shape[0]
            kk = min(k, n_local)
            k_over = min(max(oversample * kk, kk), n_local)
            t = None
            if method == "pallas":
                # the survivors must fit a bin layout: shrink, as the
                # single-device index does
                k_over = shrink_survivors(kk, k_over, codes_s.shape[1])
                cs, ci, _ = qt.quantized_topk(
                    q, codes_s, scales_s, k_over, bias=bias_s,
                    max_rounds=pallas_rounds, fold=pallas_fold,
                )
                # an unfilled slot's BIG_IDX row; its -inf keeps it out
                ci = ci.clamp(0, n_local - 1)
            else:
                qq, t = quantize_queries(q)
                scores = _int_scores(qq, codes_s) * scales_s + bias_s
                cs, ci = approx_max_k(scores, k_over, recall_target)
            if emb is not None:
                ls, li = rescore_survivors(
                    q, emb.shard(s, dev), bias_s, cs, ci, kk
                )
            elif t is None:  # "pallas": already true-scale scores
                ls, li = cs[:, :kk], ci[:, :kk]
            else:
                ls, li = cs[:, :kk] * t, ci[:, :kk]
            ids_s = ids.shard(s, dev)
            return ls, ids_at(ids_s, li, ids_s.shape[0])

        return _sharded_call(mesh, k, local)(queries)

    return topk
