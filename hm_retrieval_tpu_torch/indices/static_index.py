"""Static (popularity) index: the rules-based baseline to beat.

Counterpart of the JAX package's ``indices/static_index.py`` (ref:
pkg/modelling/indices/static_index.py:9-96): one ordered list of candidate
ids, the same for every query row, built from transaction popularity. The
ids are an int32 tensor on the index's device, and ``query`` expands the
first k of them over the batch without a copy.

The popularity order is the JAX package's ``series.astype(str)
.value_counts()`` computed with numpy, without pandas: count descending, ties
in order of first appearance (``np.unique`` alone would order ties by
value). The artifact is the JAX package's: ``identifiers.npy`` and
``meta.json`` ``{"type": "static", "k": ...}``.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.schema.features import value_counts
from hm_retrieval_tpu_torch.schema.schema import Schema

logger = logging.getLogger(__name__)


def popularity_order(values) -> np.ndarray:
    """Distinct ``str(value)``s of the present values, most frequent first,
    ties in order of first appearance: pandas'
    ``astype(str).value_counts().index``."""
    return value_counts(values)[0]


class StaticIndex:
    def __init__(self, identifiers, device: DeviceLike = None):
        identifiers = np.asarray(identifiers)
        if identifiers.ndim != 1 or len(identifiers) == 0:
            raise ValueError("identifiers must be a non-empty 1D array")
        self.device = resolve_device(device)
        self.identifiers = torch.as_tensor(
            identifiers.astype(np.int32)
        ).to(self.device)

    @property
    def k(self) -> int:
        return len(self.identifiers)

    def query(self, batch_size: int, k: int = None) -> torch.Tensor:
        """(B, k): the same ordered ids for every row (ref:
        static_index.py:37-55)."""
        k = self.k if k is None else k
        if k > self.k:
            raise ValueError(f"k={k} exceeds index size {self.k}")
        return self.identifiers[:k].expand(batch_size, k)

    @classmethod
    def build_popularity_index_from_series(
        cls, values, schema: Schema, k: int, device: DeviceLike = None
    ) -> "StaticIndex":
        """The k most popular candidate ids by transaction count (ref:
        static_index.py:67-95). ``values`` holds the raw candidate ids as
        read; they are schema-encoded, and ids that fell out of the vocab
        (0) are dropped after the top k is taken."""
        order = popularity_order(values)[:k]
        ids = schema.candidate_id_feature.encode(order)
        ids = ids[ids != 0]
        if len(ids) < k:
            logger.warning(
                "Popularity index has %d < k=%d in-vocab ids", len(ids), k
            )
        return cls(ids, device=device)

    # ------------------------------------------------------------------
    def save(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        np.save(
            os.path.join(dirpath, "identifiers.npy"),
            self.identifiers.cpu().numpy(),
        )
        with open(os.path.join(dirpath, "meta.json"), "w") as f:
            json.dump({"type": "static", "k": self.k}, f)
        logger.info("Saved static index to %s", dirpath)

    @classmethod
    def load(cls, dirpath: str, device: DeviceLike = None) -> "StaticIndex":
        return cls(
            np.load(os.path.join(dirpath, "identifiers.npy")), device=device
        )
