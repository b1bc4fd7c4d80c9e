"""Pickle-free nested dict/list <-> npz serialization.

Same key layout as the JAX package's ``utils/pytree_io.py``: nested trees are
flattened to path keys ("query_tower/dense/0/w"), and a level whose keys are
all digits is read back as a list. Leaves are numpy arrays.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def save_pytree_npz(tree, filepath: str) -> None:
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    np.savez(filepath, **flat)


def load_pytree_npz(filepath: str):
    """Rebuilds nested dicts/lists of numpy arrays."""
    with np.load(filepath) as z:
        flat = {k: z[k] for k in z.files}
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def densify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node.keys()):
            return [densify(node[str(i)]) for i in range(len(node))]
        return {k: densify(v) for k, v in node.items()}

    return densify(root)
