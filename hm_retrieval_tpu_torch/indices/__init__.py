"""Retrieval indices, as in the JAX package:

- ``BruteForceIndex``: exact top-k (ref: pkg/modelling/indices/brute_force.py)
- ``QuantizedIndex``: int8 scan and fp32 rescore
- ``StaticIndex``: the popularity baseline
  (ref: pkg/modelling/indices/static_index.py)
- ``DistributedBruteForceIndex`` / ``DistributedQuantizedIndex``: the first
  two with the catalog row-sharded over a mesh (``indices/distributed.py``)
"""

import json
import os

from hm_retrieval_tpu_torch.device import DeviceLike
from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
from hm_retrieval_tpu_torch.indices.distributed import (
    DISTRIBUTED_INDEX_TYPES,
    DistributedBruteForceIndex,
    DistributedQuantizedIndex,
    load_distributed_index,
)
from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
from hm_retrieval_tpu_torch.indices.static_index import StaticIndex

INDEX_TYPES = {
    "brute_force": BruteForceIndex,
    "quantized": QuantizedIndex,
    "static": StaticIndex,
}


def load_index(dirpath: str, device: DeviceLike = None):
    """Load the index saved at ``dirpath`` on ``device`` (dispatch on
    meta.json's "type"; artifacts without one are brute_force)."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    kind = meta.get("type", "brute_force")
    if kind not in INDEX_TYPES:
        raise ValueError(
            f"unknown index type {kind!r} at {dirpath} "
            f"(expected one of {sorted(INDEX_TYPES)})"
        )
    return INDEX_TYPES[kind].load(dirpath, device=device)


__all__ = [
    "BruteForceIndex",
    "DISTRIBUTED_INDEX_TYPES",
    "DistributedBruteForceIndex",
    "DistributedQuantizedIndex",
    "INDEX_TYPES",
    "QuantizedIndex",
    "StaticIndex",
    "load_distributed_index",
    "load_index",
]
