"""Exact brute-force retrieval index.

Counterpart of ``hm_retrieval_tpu/indices/brute_force.py``: an int32 id
vector plus an (N, E) fp32 embedding matrix on the device, padded with zero
rows to a multiple of ``PAD_MULTIPLE`` and a -inf score bias on the pad
rows. The artifact (``index.npz`` + ``meta.json``) is the JAX package's, so
an index saved by either package loads in the other.

``method``:

- ``"pallas"``: the streaming bin-max rounds (``ops/bin_topk.py``, CUDA
  kernels on the card). The name is the JAX package's, kept so artifacts
  stay interchangeable. It runs the exact ``"partial_reduce"`` path
  instead, with a log line, where the kernels cannot: k > 2048 (where the
  JAX index's ``pick_bins`` finds no bin count and takes the same route),
  or an embedding width that, padded to a multiple of 16, exceeds
  ``KERNEL_MAX_E`` = 8,192 (above the JAX kernels' widest, 7,296 at one
  query row and k = 10, where its VMEM estimate stops fitting and it takes
  ``"partial_reduce"``). The saved method stays ``"pallas"``.
- ``"full"``: one fp32 product plus the bias, then a stable top-k.
- ``"auto"``: ``"pallas"`` when the padded catalog exceeds 16384 rows, else
  ``"full"``, decided by size alone on every device.
- ``"partial_reduce"``: one fp32 product plus the bias, then the exact
  iterative PartialReduce refinement (``ops/exact_topk.py``) at the JAX
  package's default ``recall_target`` of 0.95.
- ``"approx"``: one fp32 product over the real rows only (no pad row takes
  a bin), then ``approx_max_k`` at the index's ``recall_target``
  (``ops/partial_reduce.py``): APPROXIMATE, the only non-exact method.

The last two run the PartialReduce kernel (``csrc/partial_reduce.cu``) on the
card and its plain version on the CPU, so they give on the CPU what they give
on the card, where the JAX package off a TPU gives the exact top-k.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Iterable

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.indices.artifact import clear_stale, load_index_arrays
from hm_retrieval_tpu_torch.ops.bin_topk import (
    BIN_CHOICES,
    KERNEL_MAX_E,
    exact_topk,
    padded_width,
    plain_scores,
)
from hm_retrieval_tpu_torch.ops.exact_topk import exact_topk_scores
from hm_retrieval_tpu_torch.ops.partial_reduce import approx_max_k
from hm_retrieval_tpu_torch.ops.topk import ids_at, topk_pair

logger = logging.getLogger(__name__)

METHODS = ("auto", "full", "partial_reduce", "pallas", "approx")


class BruteForceIndex:
    # build_from_batches keeps the catalog on the tower's device end to end
    # (runners/modelling.py::build_index)
    supports_device_build = True
    PAD_MULTIPLE = 1024
    PALLAS_MIN_ROWS = 16384  # "auto" takes the kernels above this n_pad

    def __init__(
        self,
        k: int,
        identifiers,
        embeddings,
        method: str = "auto",
        recall_target: float = 0.95,
        device: DeviceLike = None,
    ):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        if not 0.0 < recall_target <= 1.0:
            raise ValueError("recall_target must be in (0, 1]")
        self.device = resolve_device(device)
        self.recall_target = float(recall_target)
        identifiers = np.asarray(identifiers)
        if not isinstance(embeddings, torch.Tensor):
            embeddings = torch.as_tensor(np.asarray(embeddings, np.float32))
        if identifiers.ndim != 1 or embeddings.dim() != 2:
            raise ValueError("identifiers must be (N,), embeddings (N, E)")
        if len(identifiers) != len(embeddings):
            raise ValueError("identifiers and embeddings length mismatch")
        if k <= 0:
            raise ValueError("k must be positive")
        if identifiers.size and (
            identifiers.min() < -(2**31) or identifiers.max() >= 2**31
        ):
            raise ValueError("identifiers must fit in int32")
        self.k = int(k)
        self.num_candidates = n = len(identifiers)
        if n < k:
            raise ValueError(f"k={k} exceeds number of candidates {n}")
        n_pad = -(-n // self.PAD_MULTIPLE) * self.PAD_MULTIPLE
        self.identifiers = torch.zeros(
            n_pad, dtype=torch.int32, device=self.device
        )
        self.identifiers[:n] = torch.as_tensor(identifiers.astype(np.int32))
        self.embeddings = torch.zeros(
            (n_pad, embeddings.shape[1]), dtype=torch.float32, device=self.device
        )
        self.embeddings[:n] = embeddings.detach().to(self.device, torch.float32)
        self._score_bias = torch.zeros(
            n_pad, dtype=torch.float32, device=self.device
        )
        self._score_bias[n:] = float("-inf")
        if method == "auto":
            method = "pallas" if n_pad > self.PALLAS_MIN_ROWS else "full"
        self.method = method
        self._engine = method
        if method == "pallas" and self.k > BIN_CHOICES[-1]:
            logger.warning(
                "k=%d exceeds the largest bin count %d; running the exact "
                "'partial_reduce' path instead of the kernels",
                self.k,
                BIN_CHOICES[-1],
            )
            self._engine = "partial_reduce"
        elif method == "pallas" and padded_width(embeddings.shape[1]) > (
            KERNEL_MAX_E
        ):
            logger.warning(
                "embedding width %d (padded to %d) exceeds the kernels' "
                "widest %d; running the exact 'partial_reduce' path instead "
                "of the kernels",
                embeddings.shape[1],
                padded_width(embeddings.shape[1]),
                KERNEL_MAX_E,
            )
            self._engine = "partial_reduce"

    @classmethod
    def build_from_batches(
        cls,
        k: int,
        candidate_id_col: str,
        embed_fn: Callable[[Dict[str, np.ndarray]], torch.Tensor],
        batches: Iterable[Dict[str, np.ndarray]],
        batch_size: int,
        device: DeviceLike = None,
        **kwargs,
    ) -> "BruteForceIndex":
        """Embed the full catalog with the candidate tower in batches of one
        fixed size (``collect_catalog_device``: the embeddings stay on the
        tower's device) and index it on ``device``. The JAX package's
        boolean ``device`` (device build or host build) has no counterpart:
        the port's build never copies the catalog to the host."""
        from hm_retrieval_tpu_torch.indices.builder import (
            collect_catalog_device,
        )

        identifiers, embeddings = collect_catalog_device(
            candidate_id_col, embed_fn, batches, batch_size
        )
        logger.info(
            "Built brute-force index over %d candidates (dim %d)",
            len(identifiers),
            embeddings.shape[1],
        )
        return cls(k, identifiers, embeddings, device=device, **kwargs)

    def _ids_of(self, rows: torch.Tensor) -> torch.Tensor:
        """Catalog rows -> identifiers; rows outside the real catalog (a
        never-filled slot holds BIG_IDX) map to ``MISSING_ID``."""
        return ids_at(self.identifiers, rows, self.num_candidates)

    @torch.no_grad()
    def topk_from_embeddings(self, query_embeddings: torch.Tensor):
        """(B, E) query embeddings -> ((B, k) fp32 scores, (B, k) int32
        ids), best first."""
        q = query_embeddings.to(self.device, torch.float32)
        if self._engine == "pallas":
            scores, rows, _ = exact_topk(
                q, self.embeddings[: self.num_candidates], self.k
            )
            return scores, self._ids_of(rows)
        if self._engine == "approx":
            # only the real rows: -inf pad rows would take bins and lower
            # the recall below recall_target on a pad-heavy catalog
            scores = plain_scores(q, self.embeddings[: self.num_candidates])
            top_scores, rows = approx_max_k(scores, self.k, self.recall_target)
            return top_scores, self._ids_of(rows)
        scores = plain_scores(q, self.embeddings) + self._score_bias
        if self._engine == "partial_reduce":
            top_scores, rows, _ = exact_topk_scores(scores, self.k)
            return top_scores, self._ids_of(rows)
        rows = torch.arange(
            scores.shape[1], dtype=torch.int32, device=self.device
        ).expand_as(scores)
        top_scores, top_rows = topk_pair(scores, rows, self.k)
        return top_scores, self._ids_of(top_rows)

    @torch.no_grad()
    def query(self, query_fn: Callable, batch) -> torch.Tensor:
        """Embed queries, score, select (ref: brute_force.py:108-114):
        (B, k) int ids."""
        _, ids = self.topk_from_embeddings(query_fn(batch))
        return ids

    # ------------------------------------------------------------------
    # Persistence: index.npz + meta.json, as the JAX package writes them
    # ------------------------------------------------------------------
    def save(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        clear_stale(dirpath)
        n = self.num_candidates
        np.savez(
            os.path.join(dirpath, "index.npz"),
            identifiers=self.identifiers[:n].cpu().numpy(),
            embeddings=self.embeddings[:n].cpu().numpy(),
        )
        with open(os.path.join(dirpath, "meta.json"), "w") as f:
            json.dump(
                {
                    "k": self.k,
                    "type": "brute_force",
                    "method": self.method,
                    "recall_target": self.recall_target,
                },
                f,
            )
        logger.info("Saved brute-force index to %s", dirpath)

    @classmethod
    def load(cls, dirpath: str, device: DeviceLike = None) -> "BruteForceIndex":
        """Honors the saved method, so a reload keeps its result order."""
        with open(os.path.join(dirpath, "meta.json")) as f:
            meta = json.load(f)
        z = load_index_arrays(dirpath)
        return cls(
            meta["k"],
            z["identifiers"],
            z["embeddings"],
            method=meta.get("method", "auto"),
            recall_target=meta.get("recall_target", 0.95),
            device=device,
        )
