"""Mesh-sharded retrieval indices.

Counterpart of the JAX package's ``indices/distributed.py``: the exact and
the int8 index with the catalog row-sharded over a mesh's model axis
(``parallel/distributed_topk.py``), behind the single-device indices' API
(``k``, ``num_candidates``, ``topk_from_embeddings``, ``query``, ``save``,
``load``, ``build_from_batches``), so ``IndexRecall``, the runners and
``RetrievalService`` take either.

- ``DistributedBruteForceIndex``: exact; per shard "xla" (fp32 product and
  top-k) or "pallas" (``exact_topk``'s kernels on the bias-augmented
  operands).
- ``DistributedQuantizedIndex``: int8 shards, per-shard survivors ("scan" or
  the "pallas" kernels), an exact fp32 rescore before the merge unless
  ``rescore=False``.

The mesh's devices are where the shards live, so the indices take no
``device``; ``make_mesh`` defaults to the cards and raises without CUDA
unless given devices. Answers come back on this process's first device of
the mesh. Query batches whose size does not divide the data axis are padded
with zero rows and the answers sliced.

Over a process group (``parallel/mesh.py``) each rank holds and finishes
only the shards of its model columns, and every call is collective: every
rank passes the same queries and gets the same answers
(``parallel/distributed_topk.py``); ``to_local`` broadcasts each shard from
its owner, one shard in flight; ``save`` is collective
(``collective_save``): each rank writes the shard files it owns in data row
0, then, after a barrier, rank 0 writes ``meta.json`` (a single-file save:
the catalog gathered, rank 0 writes it), and a last barrier lets any rank
read the artifact back; ``load`` reads every rank's own shards.

``method="auto"`` resolves by k and width alone, the same on every device:
the exact index takes "pallas" when k fits the bin counts and E + 1 (the
bias column) padded to 16 fits the kernels; the quantized index when
``pallas_feasible(k, E)``. An explicit "pallas" past the kernels' widest E
runs the other engine, with a log line, as the single-device indices do.

Artifacts are the JAX package's: ``save`` writes the single-device format
(``type`` brute_force / quantized, plus ``distributed`` and
``distributed_method``), in one ``index.npz`` for an index built from a
whole catalog, or one ``index_shard_{s:05d}.npz`` a model shard for a
streamed build or a sharded load. ``load_index`` and
``load_distributed_index`` read either layout, written by either package, and
a sharded artifact loads onto a mesh of any width.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike
from hm_retrieval_tpu_torch.indices.artifact import (
    INDEX_FILE,
    clear_stale,
    iter_shard_arrays,
    shard_file,
    shard_paths,
)
from hm_retrieval_tpu_torch.indices.builder import (
    collect_catalog_sharded,
    place_catalog_rows,
)
from hm_retrieval_tpu_torch.ops.bin_topk import (
    BIN_CHOICES,
    KERNEL_MAX_E,
    padded_width,
)
from hm_retrieval_tpu_torch.parallel.distributed_topk import (
    ShardedRows,
    make_distributed_quantized_topk,
    make_distributed_topk,
    shard_candidates,
    shard_candidates_quantized,
)
from hm_retrieval_tpu_torch.parallel.collectives import barrier
from hm_retrieval_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

logger = logging.getLogger(__name__)

Batch = Dict[str, np.ndarray]


def _shard_arrays_to_blocks(dirpath: str):
    """A sharded artifact's files as ``(ids, embed_thunk)`` row blocks for
    ``place_catalog_rows``: the ids are read at once, the rows (decompressed,
    and dequantized where the artifact holds no fp32 rows, whose
    requantization gives the codes back) only when the thunk runs."""
    for path in shard_paths(dirpath):
        with np.load(path) as z:
            ids = z["identifiers"]

        def thunk(p=path):
            with np.load(p) as z:
                if "embeddings" in z.files:
                    return z["embeddings"]
                return z["codes"].astype(np.float32) * z["scales"][:, None]

        yield ids, thunk


def _write_sharded_artifact(
    dirpath: str,
    mesh,
    num_candidates: int,
    arrays: Dict[str, ShardedRows],
    meta: dict,
) -> None:
    """One npz a model shard, holding that shard's real rows; one shard on
    the host at a time. Concatenated, the files give the single-file
    artifact's arrays. Collective in a process group: each rank writes the
    shards it owns in data row 0 (one writer a file), and rank 0 publishes
    ``meta.json`` only after every shard file is complete."""
    os.makedirs(dirpath, exist_ok=True)
    S = mesh.shape[MODEL_AXIS]
    me = mesh.process_index
    if me == 0:
        clear_stale(dirpath, keep_shards=S)
    per = next(iter(arrays.values())).per
    for s in range(S):
        if not mesh.is_local(0, s):
            continue
        fill = max(0, min(per, num_candidates - s * per))
        np.savez(
            shard_file(dirpath, s),
            **{key: a.shard(s)[:fill].cpu().numpy()
               for key, a in arrays.items()},
        )
    barrier()  # meta.json is the load trigger: every shard first
    if me == 0:
        dim = next(a.shape[1] for a in arrays.values() if len(a.shape) == 2)
        meta = dict(
            meta,
            sharded_artifact=True,
            num_shards=S,
            num_candidates=int(num_candidates),
            dim=int(dim),
        )
        with open(os.path.join(dirpath, "meta.json"), "w") as f:
            json.dump(meta, f)


def _is_sharded_artifact(dirpath: str, meta: dict) -> bool:
    if meta.get("sharded_artifact"):
        return True
    return not os.path.exists(os.path.join(dirpath, INDEX_FILE)) and bool(
        shard_paths(dirpath)
    )


def _load_sharded_placed(dirpath, meta, mesh, quantize, keep_fp32):
    """Stream a sharded artifact's files back into shards over ``mesh``,
    whatever the number of files."""
    n = meta.get("num_candidates")
    if n is None:
        n = sum(len(a["identifiers"]) for a in iter_shard_arrays(dirpath))
    dim = meta.get("dim")
    if dim is None:
        first = next(iter_shard_arrays(dirpath))
        dim = first.get("embeddings", first.get("codes")).shape[1]
    ids_host, placed = place_catalog_rows(
        _shard_arrays_to_blocks(dirpath), n, dim, mesh,
        quantize=quantize, keep_fp32=keep_fp32,
    )
    return ids_host, placed, n


def _validate(k: int, identifiers: np.ndarray, embeddings) -> None:
    if k <= 0:
        raise ValueError("k must be positive")
    if identifiers.ndim != 1 or embeddings.ndim != 2:
        raise ValueError("identifiers must be (N,), embeddings (N, E)")
    if len(identifiers) != len(embeddings):
        raise ValueError("identifiers and embeddings length mismatch")
    if len(identifiers) < k:
        raise ValueError(
            f"k={k} exceeds number of candidates {len(identifiers)}"
        )


def _as_catalog(embeddings):
    """A tensor stays where it is; anything else becomes fp32 numpy."""
    if isinstance(embeddings, torch.Tensor):
        return embeddings.detach()
    return np.asarray(embeddings, np.float32)


class _DistributedIndexBase:
    """Query padding, the catalog's host and device copies, and the save
    layout shared by both families."""

    mesh = None
    k = 0
    num_candidates = 0
    # True for streamed builds and sharded loads: save writes shard files
    saves_sharded = False

    @property
    def collective_save(self) -> bool:
        """True when every rank must call ``save`` (a mesh over a process
        group); otherwise one process writes the artifact."""
        return self.mesh.process_count > 1

    def _check_common(self, k: int, num_candidates: int, mesh) -> None:
        if mesh is None:
            raise ValueError(f"{type(self).__name__} needs a mesh")
        if k <= 0:
            raise ValueError("k must be positive")
        if num_candidates < k:
            raise ValueError(
                f"k={k} exceeds number of candidates {num_candidates}"
            )

    def _pad_queries(self, q: torch.Tensor):
        """Pad the query batch with zero rows to a multiple of the data
        axis size; returns (padded, real B)."""
        d = self.mesh.shape[DATA_AXIS]
        b = q.shape[0]
        rem = b % d
        if rem == 0:
            return q, b
        pad = torch.zeros((d - rem, q.shape[1]), dtype=q.dtype,
                          device=q.device)
        return torch.cat([q, pad]), b

    @torch.no_grad()
    def topk_from_embeddings(self, query_embeddings: torch.Tensor):
        """(B, E) query embeddings -> ((B, k) fp32 scores, (B, k) int32 ids)
        on the mesh's first device, best first."""
        q, b = self._pad_queries(
            query_embeddings.to(self.mesh.first_device, torch.float32)
        )
        scores, ids = self._fn(q, *self._arrays)
        return scores[:b], ids[:b]

    @torch.no_grad()
    def query(self, query_fn: Callable, batch) -> torch.Tensor:
        """Embed queries, score over the sharded catalog, select: (B, k) int
        ids (ref: brute_force.py:108-114 at sharded scale)."""
        _, ids = self.topk_from_embeddings(query_fn(batch))
        return ids

    def _host_identifiers(self) -> np.ndarray:
        """Every rank streamed or read the whole catalog's ids."""
        return np.asarray(self._ids_host[: self.num_candidates], np.int32)

    def _catalog(self) -> torch.Tensor:
        """The (N, E) fp32 catalog on this process's first device, from the
        fp32 shards (or the int8 codes times their scales where there are
        none). Collective in a process group: each shard is broadcast from
        its owner, one at a time."""
        first = self.mesh.first_device
        rows = self._fp32_shards()
        return torch.cat([r.to(first) for r in rows])[: self.num_candidates]

    def _host_catalog(self) -> np.ndarray:
        """The (N, E) fp32 catalog on the host (collective in a group)."""
        return self._catalog().cpu().numpy()

    def _save(self, dirpath: str, arrays: Dict[str, ShardedRows], meta):
        if self.saves_sharded:
            _write_sharded_artifact(
                dirpath, self.mesh, self.num_candidates, arrays, meta
            )
        else:
            n = self.num_candidates
            host = {key: a.numpy()[:n] for key, a in arrays.items()}
            if self.mesh.process_index == 0:
                os.makedirs(dirpath, exist_ok=True)
                clear_stale(dirpath)
                np.savez(os.path.join(dirpath, INDEX_FILE), **host)
                with open(os.path.join(dirpath, "meta.json"), "w") as f:
                    json.dump(meta, f)
        barrier()  # no rank reads the artifact before it is complete
        logger.info(
            "Saved %s (%s) to %s",
            type(self).__name__,
            "sharded" if self.saves_sharded else "one file",
            dirpath,
        )


class DistributedBruteForceIndex(_DistributedIndexBase):
    """Exact top-k over a catalog row-sharded across the mesh's model axis
    (the sharded-scale counterpart of ref:
    pkg/modelling/indices/brute_force.py:54-83).

    ``identifiers`` (N,) ints and ``embeddings`` (N, E) (numpy, or a tensor,
    cut into shards on the shards' devices); ``mesh`` from ``make_mesh``;
    ``method`` "auto", "xla" or "pallas"."""

    def _configure(self, k, num_candidates, dim, mesh, method):
        if method not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown method {method!r}")
        self._check_common(k, num_candidates, mesh)
        # +1: "pallas" folds the pad rows' bias in as an extra column
        fits = k <= BIN_CHOICES[-1] and padded_width(dim + 1) <= KERNEL_MAX_E
        if method == "auto":
            method = "pallas" if fits else "xla"
        self._engine = method
        if method == "pallas" and not fits:
            logger.warning(
                "k=%d or width %d + 1 exceeds the kernels; running the "
                "'xla' engine instead",
                k,
                dim,
            )
            self._engine = "xla"
        self.k = int(k)
        self.num_candidates = int(num_candidates)
        self.mesh = mesh
        self.method = method
        self._fn = make_distributed_topk(mesh, self.k, method=self._engine)
        logger.info(
            "Distributed brute-force index: %d candidates over mesh %s "
            "(method=%s)",
            self.num_candidates,
            mesh.shape,
            method,
        )

    def __init__(
        self,
        k: int,
        identifiers,
        embeddings,
        *,
        mesh,
        method: str = "auto",
    ):
        identifiers = np.asarray(identifiers)
        embeddings = _as_catalog(embeddings)
        _validate(k, identifiers, embeddings)
        self._configure(k, len(identifiers), embeddings.shape[1], mesh, method)
        self._ids_host = identifiers.astype(np.int32)
        self._emb, self._ids, self._bias = shard_candidates(
            embeddings, self._ids_host, mesh
        )

    @property
    def _arrays(self):
        return self._emb, self._ids, self._bias

    def _fp32_shards(self):
        return self._emb.shards()

    @classmethod
    def _from_placed(
        cls, k, num_candidates, ids_host, placed, *, mesh, method="auto"
    ) -> "DistributedBruteForceIndex":
        self = cls.__new__(cls)
        self._configure(k, num_candidates, placed["emb"].shape[1], mesh,
                        method)
        self.saves_sharded = True
        self._ids_host = ids_host
        self._emb, self._ids, self._bias = (
            placed["emb"], placed["ids"], placed["bias"]
        )
        return self

    @classmethod
    def build_from_batches(
        cls,
        k: int,
        candidate_id_col: str,
        embed_fn: Callable[[Batch], torch.Tensor],
        batches: Iterable[Batch],
        batch_size: int,
        *,
        mesh,
        num_candidates: int = None,
        dim: int = None,
        build_stats: dict = None,
        **kwargs,
    ) -> "DistributedBruteForceIndex":
        """Streaming sharded build (``collect_catalog_sharded``): rows go
        batch -> shard buffer -> shard on its device. Pass
        ``num_candidates`` (the manifest's row count) to stream without
        materializing the feature batches first."""
        ids_host, placed, n = collect_catalog_sharded(
            candidate_id_col, embed_fn, batches, batch_size, mesh,
            num_candidates=num_candidates, dim=dim, quantize=False,
            stats=build_stats,
        )
        return cls._from_placed(k, n, ids_host, placed, mesh=mesh, **kwargs)

    def to_local(self, method: str = "auto", device: DeviceLike = None):
        """Single-device ``BruteForceIndex`` over the same catalog, on
        ``device`` (None: the mesh's first device); the catalog is gathered
        there, not on the host."""
        from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex

        return BruteForceIndex(
            self.k,
            self._host_identifiers(),
            self._catalog(),
            method=method,
            device=self.mesh.first_device if device is None else device,
        )

    def save(self, dirpath: str) -> None:
        """An artifact ``load_index`` reads anywhere, plus a ``distributed``
        marker."""
        meta = {
            "k": self.k,
            "type": "brute_force",
            "method": "auto",
            "recall_target": 0.95,
            "distributed": True,
            "distributed_method": self.method,
        }
        self._save(
            dirpath, {"identifiers": self._ids, "embeddings": self._emb}, meta
        )

    @classmethod
    def load(cls, dirpath: str, *, mesh, **kwargs) -> "DistributedBruteForceIndex":
        with open(os.path.join(dirpath, "meta.json")) as f:
            meta = json.load(f)
        kwargs.setdefault("method", meta.get("distributed_method", "auto"))
        if _is_sharded_artifact(dirpath, meta):
            ids_host, placed, n = _load_sharded_placed(
                dirpath, meta, mesh, quantize=False, keep_fp32=True
            )
            return cls._from_placed(meta["k"], n, ids_host, placed, mesh=mesh,
                                    **kwargs)
        with np.load(os.path.join(dirpath, INDEX_FILE)) as z:
            return cls(
                meta["k"], z["identifiers"], z["embeddings"], mesh=mesh,
                **kwargs,
            )


class DistributedQuantizedIndex(_DistributedIndexBase):
    """Int8 scan over a row-sharded catalog (the sharded form of
    ``indices/quantized.py``): each shard selects ``oversample * k``
    survivors from its int8 rows, rescores them exactly against its fp32
    rows when ``rescore``, and the shards' leaderboards are merged.
    ``rescore=False`` keeps no fp32 rows at all. ``method`` "auto", "scan"
    or "pallas"; ``pallas_rounds`` and ``pallas_fold`` as
    ``QuantizedIndex``'s."""

    def _configure(
        self, k, num_candidates, dim, mesh, oversample, rescore,
        recall_target, method, pallas_rounds, pallas_fold,
    ):
        from hm_retrieval_tpu_torch.indices.quantized import _engine_of
        from hm_retrieval_tpu_torch.ops.quantized_topk import pallas_feasible

        if oversample < 1:
            raise ValueError("oversample must be >= 1")
        if not 0.0 < recall_target <= 1.0:
            raise ValueError("recall_target must be in (0, 1]")
        if method not in ("auto", "scan", "pallas"):
            raise ValueError(f"unknown method {method!r}")
        self._check_common(k, num_candidates, mesh)
        if method == "auto":
            method = "pallas" if pallas_feasible(k, dim) else "scan"
        self.k = int(k)
        self.num_candidates = int(num_candidates)
        self.mesh = mesh
        self.method = method
        self.oversample = int(oversample)
        self.rescore = bool(rescore)
        self.recall_target = float(recall_target)
        self.pallas_rounds = int(pallas_rounds)
        self.pallas_fold = None if pallas_fold is None else int(pallas_fold)
        self._engine = _engine_of(method, dim)
        self._fn = make_distributed_quantized_topk(
            mesh,
            self.k,
            oversample=self.oversample,
            recall_target=self.recall_target,
            method=self._engine,
            pallas_rounds=self.pallas_rounds,
            pallas_fold=self.pallas_fold,
        )
        logger.info(
            "Distributed quantized index: %d candidates over mesh %s "
            "(method=%s, rescore=%s)",
            self.num_candidates,
            mesh.shape,
            method,
            self.rescore,
        )

    def __init__(
        self,
        k: int,
        identifiers,
        embeddings,
        *,
        mesh,
        oversample: int = 4,
        rescore: bool = True,
        recall_target: float = 0.95,
        method: str = "auto",
        pallas_rounds: int = 1,
        pallas_fold: Optional[int] = None,
    ):
        identifiers = np.asarray(identifiers)
        embeddings = _as_catalog(embeddings)
        _validate(k, identifiers, embeddings)
        self._configure(
            k, len(identifiers), embeddings.shape[1], mesh, oversample,
            rescore, recall_target, method, pallas_rounds, pallas_fold,
        )
        self._ids_host = identifiers.astype(np.int32)
        self._placed = shard_candidates_quantized(
            embeddings, self._ids_host, mesh, keep_fp32=self.rescore,
        )

    @property
    def _arrays(self):
        return self._placed

    @property
    def _ids(self) -> ShardedRows:
        return self._placed[3]

    def _fp32_shards(self):
        codes, scales, emb, _, _ = self._placed
        if emb is not None:
            return emb.shards()
        return [c.to(torch.float32) * sc[:, None]
                for c, sc in zip(codes.shards(), scales.shards())]

    @classmethod
    def _from_placed(
        cls, k, num_candidates, ids_host, placed, *, mesh, oversample=4,
        rescore=True, recall_target=0.95, method="auto", pallas_rounds=1,
        pallas_fold=None,
    ) -> "DistributedQuantizedIndex":
        self = cls.__new__(cls)
        self._configure(
            k, num_candidates, placed["codes"].shape[1], mesh, oversample,
            rescore, recall_target, method, pallas_rounds, pallas_fold,
        )
        self.saves_sharded = True
        self._ids_host = ids_host
        self._placed = (
            placed["codes"], placed["scales"], placed.get("emb"),
            placed["ids"], placed["bias"],
        )
        return self

    @classmethod
    def build_from_batches(
        cls,
        k: int,
        candidate_id_col: str,
        embed_fn: Callable[[Batch], torch.Tensor],
        batches: Iterable[Batch],
        batch_size: int,
        *,
        mesh,
        num_candidates: int = None,
        dim: int = None,
        build_stats: dict = None,
        **kwargs,
    ) -> "DistributedQuantizedIndex":
        """Streaming sharded build: rows go batch -> shard buffer -> int8
        codes (and the fp32 rows only with ``rescore``) on the shard's
        device. With ``rescore=False`` no fp32 copy of the catalog is kept
        anywhere."""
        ids_host, placed, n = collect_catalog_sharded(
            candidate_id_col, embed_fn, batches, batch_size, mesh,
            num_candidates=num_candidates, dim=dim, quantize=True,
            keep_fp32=kwargs.get("rescore", True), stats=build_stats,
        )
        return cls._from_placed(k, n, ids_host, placed, mesh=mesh, **kwargs)

    def to_local(self, device: DeviceLike = None, **kwargs):
        """Single-device ``QuantizedIndex`` over the same catalog, on
        ``device`` (None: the mesh's first device)."""
        from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex

        kwargs.setdefault("oversample", self.oversample)
        kwargs.setdefault("rescore", self.rescore)
        kwargs.setdefault("recall_target", self.recall_target)
        return QuantizedIndex(
            self.k,
            self._host_identifiers(),
            self._catalog(),
            device=self.mesh.first_device if device is None else device,
            **kwargs,
        )

    def _meta(self) -> dict:
        return {
            "k": self.k,
            "type": "quantized",
            "oversample": self.oversample,
            "rescore": self.rescore,
            "chunk": 65536,
            "recall_target": self.recall_target,
            "method": "auto",
            "pallas_rounds": self.pallas_rounds,
            "pallas_fold": self.pallas_fold,
            "distributed": True,
            "distributed_method": self.method,
        }

    def save(self, dirpath: str) -> None:
        """A ``QuantizedIndex`` artifact plus a ``distributed`` marker. With
        ``rescore=False`` no fp32 rows are stored; a load rebuilds them as
        codes times scales, whose requantization gives the codes back."""
        codes, scales, emb, ids, _ = self._placed
        arrays = {"identifiers": ids, "codes": codes, "scales": scales}
        if emb is not None:
            arrays["embeddings"] = emb
        self._save(dirpath, arrays, self._meta())

    @classmethod
    def load(cls, dirpath: str, *, mesh, **kwargs) -> "DistributedQuantizedIndex":
        with open(os.path.join(dirpath, "meta.json")) as f:
            meta = json.load(f)
        kwargs.setdefault("oversample", meta.get("oversample", 4))
        kwargs.setdefault("recall_target", meta.get("recall_target", 0.95))
        kwargs.setdefault("pallas_rounds", meta.get("pallas_rounds", 1))
        kwargs.setdefault("pallas_fold", meta.get("pallas_fold"))
        kwargs.setdefault("method", meta.get("distributed_method", "auto"))
        if _is_sharded_artifact(dirpath, meta):
            kwargs.setdefault("rescore", meta.get("rescore", True))
            ids_host, placed, n = _load_sharded_placed(
                dirpath, meta, mesh, quantize=True,
                keep_fp32=kwargs["rescore"],
            )
            return cls._from_placed(meta["k"], n, ids_host, placed, mesh=mesh,
                                    **kwargs)
        with np.load(os.path.join(dirpath, INDEX_FILE)) as z:
            if "embeddings" in z.files:
                emb = z["embeddings"]
            else:
                # rescore=False artifact: the codes are the catalog
                emb = z["codes"].astype(np.float32) * z["scales"][:, None]
            kwargs.setdefault(
                "rescore", meta.get("rescore", True) and "embeddings" in z.files
            )
            return cls(meta["k"], z["identifiers"], emb, mesh=mesh, **kwargs)


DISTRIBUTED_INDEX_TYPES = {
    "brute_force": DistributedBruteForceIndex,
    "quantized": DistributedQuantizedIndex,
}


def load_distributed_index(dirpath: str, mesh, **kwargs):
    """Load whichever index type was saved at ``dirpath`` and shard it over
    ``mesh`` (the sharded counterpart of ``indices.load_index``; artifacts
    are interchangeable)."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    kind = meta.get("type", "brute_force")
    if kind not in DISTRIBUTED_INDEX_TYPES:
        raise ValueError(
            f"unknown index type {kind!r} at {dirpath} "
            f"(expected one of {sorted(DISTRIBUTED_INDEX_TYPES)})"
        )
    return DISTRIBUTED_INDEX_TYPES[kind].load(dirpath, mesh=mesh, **kwargs)


__all__ = [
    "DISTRIBUTED_INDEX_TYPES",
    "DistributedBruteForceIndex",
    "DistributedQuantizedIndex",
    "load_distributed_index",
]
