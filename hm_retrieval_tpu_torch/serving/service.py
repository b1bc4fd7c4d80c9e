"""Serving: load exported artifacts and answer retrieval queries.

Counterpart of ``hm_retrieval_tpu/serving/service.py``. Strings never reach
the device: the service encodes raw string features to int ids on the host
with the schema vocabs, runs the query tower and the index's top-k on the
device (the exact ``BruteForceIndex`` or the int8 ``QuantizedIndex``, or
their mesh-sharded forms), and decodes int ids back to strings at the edge.

Artifacts consumed (written by either package):
    <schema_dir>/                 schema.json + vocabs.npz (+ logq.npy)
    <model_dir>/query_tower/params.npz
    <index_dir>/                  index.npz + meta.json
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.indices import load_distributed_index, load_index
from hm_retrieval_tpu_torch.models.bridge import tower_from_numpy
from hm_retrieval_tpu_torch.models.tower import Tower
from hm_retrieval_tpu_torch.schema.features import FeatureKind
from hm_retrieval_tpu_torch.schema.schema import Schema
from hm_retrieval_tpu_torch.utils.pytree_io import load_pytree_npz

logger = logging.getLogger(__name__)

RawQuery = Dict[str, Sequence[Union[str, float]]]


class RetrievalService:
    def __init__(
        self,
        schema: Schema,
        query_tower: Tower,
        index,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.schema = schema
        self.query_tower = query_tower.to(self.device).eval()
        self.index = index
        self._query_features = schema.query_features
        self._candidate_id_feature = schema.candidate_id_feature

    @classmethod
    def load(
        cls,
        schema_dirpath: str,
        model_dirpath: str,
        index_dirpath: str,
        mesh=None,
        distributed_index: bool = False,
        device: DeviceLike = None,
    ) -> "RetrievalService":
        """The query tower runs on ``device`` (None: the card).
        ``distributed_index=True`` shards the saved catalog over ``mesh``'s
        model axis (``load_distributed_index``) and serves through the
        sharded top-k; the index artifacts of both layouts are
        interchangeable."""
        dev = resolve_device(device)
        schema = Schema.load(schema_dirpath)
        tree = load_pytree_npz(f"{model_dirpath}/query_tower/params.npz")
        if distributed_index:
            if mesh is None:
                raise ValueError("distributed_index=True requires a mesh")
            index = load_distributed_index(index_dirpath, mesh)
        else:
            index = load_index(index_dirpath, device=dev)
        tower = tower_from_numpy(schema.query_features, tree, dev)
        logger.info(
            "Loaded retrieval service: %d candidates, k=%d, method=%s%s",
            index.num_candidates,
            index.k,
            index.method,
            " (mesh-sharded catalog)" if distributed_index else "",
        )
        return cls(schema, tower, index, dev)

    # ------------------------------------------------------------------
    def encode_query(self, raw: RawQuery) -> Dict[str, np.ndarray]:
        """Raw string/float features -> int32/float32 host batch."""
        batch = {}
        n = None
        for f in self._query_features:
            if f.name not in raw:
                raise KeyError(f"missing query feature {f.name!r}")
            vals = raw[f.name]
            if n is None:
                n = len(vals)
            elif len(vals) != n:
                raise ValueError("query features have inconsistent lengths")
            if f.kind == FeatureKind.CATEGORICAL:
                batch[f.name] = f.encode(np.asarray(vals))
            elif f.kind == FeatureKind.SEQUENCE:
                batch[f.name] = f.encode_sequence(list(vals))
            else:
                batch[f.name] = f.transform_numeric(
                    np.asarray(vals, dtype=np.float32)
                )
        return batch

    @torch.no_grad()
    def embed(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """Host batch -> (B, joint) query embeddings on the device."""
        dev_batch = {
            name: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for name, v in batch.items()
        }
        return self.query_tower(dev_batch)

    def retrieve(self, raw: RawQuery, k: int = None) -> List[List[str]]:
        """Full serving path: encode -> embed -> index top-k -> decode.
        Returns per-row lists of candidate id strings, best first."""
        if k is not None and k > self.index.k:
            raise ValueError(f"k={k} exceeds index k={self.index.k}")
        q = self.embed(self.encode_query(raw))
        _, int_ids = self.index.topk_from_embeddings(q)
        int_ids = int_ids.cpu().numpy()
        if k is not None:
            int_ids = int_ids[:, :k]
        return self._candidate_id_feature.decode(int_ids).tolist()
