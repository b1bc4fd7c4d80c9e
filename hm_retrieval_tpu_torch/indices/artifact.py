"""Index artifact IO: single-file and sharded layouts.

Same files as the JAX package's ``indices/artifact.py``: one ``index.npz``,
or per-shard ``index_shard_{s:05d}.npz`` files that concatenate to the same
arrays. Every loader accepts either layout.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import Dict, Iterator, List

import numpy as np

INDEX_FILE = "index.npz"
SHARD_PATTERN = "index_shard_*.npz"
_SHARD_RE = re.compile(r"index_shard_(\d+)\.npz$")

logger = logging.getLogger(__name__)


def shard_paths(dirpath: str) -> List[str]:
    """Shard files in shard order; names off the numeric pattern are
    skipped with a warning."""
    matched, skipped = [], []
    for p in glob.glob(os.path.join(dirpath, SHARD_PATTERN)):
        m = _SHARD_RE.search(p)
        (matched if m else skipped).append((p, m))
    if skipped:
        logger.warning(
            "ignoring non-shard files in %s: %s",
            dirpath,
            [os.path.basename(p) for p, _ in skipped],
        )
    return [p for p, _ in sorted(matched, key=lambda pm: int(pm[1].group(1)))]


def shard_file(dirpath: str, s: int) -> str:
    return os.path.join(dirpath, f"index_shard_{s:05d}.npz")


def iter_shard_arrays(dirpath: str) -> Iterator[Dict[str, np.ndarray]]:
    """Each shard file's arrays in catalog row order, one at a time."""
    for p in shard_paths(dirpath):
        with np.load(p) as z:
            yield {k: z[k] for k in z.files}


def clear_stale(dirpath: str, keep_shards: int = None) -> None:
    """Remove the artifact files a new save will not overwrite, so a loader
    cannot mix them with the new layout. ``keep_shards=None``: a single-file
    save follows, so every shard file goes. ``keep_shards=S``: a sharded
    save of S files follows, so ``index.npz`` and shards numbered >= S go."""
    if not os.path.isdir(dirpath):
        return
    doomed = shard_paths(dirpath)
    if keep_shards is not None:
        doomed = [
            p for p in doomed
            if int(_SHARD_RE.search(p).group(1)) >= keep_shards
        ]
        single = os.path.join(dirpath, INDEX_FILE)
        if os.path.exists(single):
            doomed.append(single)
    for p in doomed:
        try:
            os.unlink(p)
        except FileNotFoundError:
            pass


def load_index_arrays(dirpath: str) -> Dict[str, np.ndarray]:
    """The artifact's full arrays, whichever layout is on disk."""
    single = os.path.join(dirpath, INDEX_FILE)
    if os.path.exists(single):
        with np.load(single) as z:
            return {k: z[k] for k in z.files}
    parts: Dict[str, List[np.ndarray]] = {}
    for arrays in iter_shard_arrays(dirpath):
        for k, v in arrays.items():
            parts.setdefault(k, []).append(v)
    if not parts:
        raise FileNotFoundError(
            f"no {INDEX_FILE} or {SHARD_PATTERN} in {dirpath}"
        )
    return {k: np.concatenate(v) for k, v in parts.items()}
