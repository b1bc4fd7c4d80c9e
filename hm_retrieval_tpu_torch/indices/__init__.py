"""Retrieval indices. The exact ``BruteForceIndex`` is ported; the other
families of the JAX package raise ``NotImplementedError`` until their slice
of the port lands (ROADMAP.md, "Slices still to port")."""

import json
import os

from hm_retrieval_tpu_torch.device import DeviceLike
from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex

INDEX_TYPES = {"brute_force": BruteForceIndex}
# index types of the JAX package that wait for a later slice
_NOT_PORTED = {
    "quantized": "slice 1 (quantized serving)",
    "static": "slice 4 (the static popularity index)",
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


__all__ = ["BruteForceIndex", "INDEX_TYPES", "load_index"]
