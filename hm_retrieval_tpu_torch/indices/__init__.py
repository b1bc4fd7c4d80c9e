"""Retrieval indices. The exact ``BruteForceIndex`` and the int8
``QuantizedIndex`` are ported; ``_NOT_PORTED`` names the family of the JAX
package that still waits for its slice of the port (the static popularity
index, ROADMAP.md Queue 1) and raises ``NotImplementedError``."""

import json
import os

from hm_retrieval_tpu_torch.device import DeviceLike
from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex

INDEX_TYPES = {"brute_force": BruteForceIndex, "quantized": QuantizedIndex}
# index types of the JAX package that wait for a later slice
_NOT_PORTED = {
    "static": "Queue 1 (the static popularity index)",
}


def load_index(dirpath: str, device: DeviceLike = None):
    """Load the index saved at ``dirpath`` (dispatch on meta.json's
    "type"; artifacts without one are brute_force)."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    kind = meta.get("type", "brute_force")
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"index type {kind!r} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED[kind]}"
        )
    if kind not in INDEX_TYPES:
        raise ValueError(
            f"unknown index type {kind!r} at {dirpath} "
            f"(expected one of {sorted(INDEX_TYPES)})"
        )
    return INDEX_TYPES[kind].load(dirpath, device=device)


__all__ = ["BruteForceIndex", "INDEX_TYPES", "QuantizedIndex", "load_index"]
