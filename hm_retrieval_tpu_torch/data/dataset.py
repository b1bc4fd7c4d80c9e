"""Streaming input pipeline over columnar shards.

Own copy of the JAX package's ``data/dataset.py`` (which imports no JAX):
lazy shard reads, a two-level shuffle, fixed-size batches of host numpy
arrays, ``(B,)`` or ``(B, max_len)``. For the same shards and seed it yields
the same batches, bit for bit. Device feeding lives in
``data/device_feed.py``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from hm_retrieval_tpu_torch.data.shard_writer import MANIFEST_NAME

logger = logging.getLogger(__name__)

Batch = Dict[str, np.ndarray]


class ShardDataset:
    """Reads the shards written by the JAX package's ``ShardWriter``."""

    def __init__(
        self,
        dirpath: str,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """``process_index``/``process_count``: multi-process data
        sharding, each process reading only shards ``i % process_count ==
        process_index``. Defaults to the whole dataset."""
        self.dirpath = dirpath
        if not 0 <= process_index < process_count:
            raise ValueError("bad process_index/process_count")
        all_paths = sorted(
            glob.glob(os.path.join(dirpath, "shard_*.npz"))
        )
        if not all_paths:
            raise FileNotFoundError(f"no shards found in {dirpath}")
        self.shard_paths: List[str] = [
            p
            for i, p in enumerate(all_paths)
            if i % process_count == process_index
        ]
        if not self.shard_paths:
            raise ValueError(
                f"process {process_index}/{process_count} got no shards "
                f"({len(all_paths)} total) — write more shards or fewer "
                "hosts"
            )
        manifest_path = os.path.join(dirpath, MANIFEST_NAME)
        with open(manifest_path) as f:
            self.manifest = json.load(f)
        self.num_rows: int = self.manifest["num_rows"]
        self.feature_dtypes: Dict[str, str] = self.manifest["features"]
        self._total_num_shards = len(all_paths)
        self._all_shard_indices = [
            i
            for i in range(len(all_paths))
            if i % process_count == process_index
        ]
        self._local_num_rows: Optional[int] = None

    @property
    def local_num_rows(self) -> int:
        """Rows in THIS process's shard subset (== num_rows for a
        single-process reader). Computed from the manifest's fixed
        shard size when available; falls back to opening shard files
        (pre-max_rows artifacts)."""
        if self._local_num_rows is None:
            max_rows = self.manifest.get("max_rows")
            # fallback must be the TOTAL shard count (shard_paths is the
            # process-LOCAL subset; dividing num_rows across a local
            # count would misplace the short last shard)
            n_shards = self.manifest.get(
                "num_shards", self._total_num_shards
            )
            if max_rows:
                last = self.num_rows - (n_shards - 1) * max_rows
                self._local_num_rows = sum(
                    last if i == n_shards - 1 else max_rows
                    for i in self._all_shard_indices
                )
            else:
                total = 0
                for p in self.shard_paths:
                    with np.load(p) as z:
                        total += len(z[z.files[0]])
                self._local_num_rows = total
        return self._local_num_rows

    # ------------------------------------------------------------------
    def _read_shards(
        self, order, num_reader_threads: int
    ) -> Iterator[Batch]:
        """Yield shard dicts in ``order``, reading up to
        ``num_reader_threads`` files ahead with a thread pool."""

        def read(si) -> Batch:
            with np.load(self.shard_paths[si]) as z:
                return {k: z[k] for k in z.files}

        if num_reader_threads <= 0 or len(order) <= 1:
            for si in order:
                yield read(si)
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(num_reader_threads) as pool:
            pending = []
            order = list(order)
            for si in order[:num_reader_threads]:
                pending.append(pool.submit(read, si))
            nxt = num_reader_threads
            while pending:
                fut = pending.pop(0)
                if nxt < len(order):
                    pending.append(pool.submit(read, order[nxt]))
                    nxt += 1
                yield fut.result()

    # ------------------------------------------------------------------
    def load_all(self) -> Batch:
        """Materialize every column (used for candidate catalogs, which are
        small)."""
        parts = [dict(np.load(p)) for p in self.shard_paths]
        return {
            k: np.concatenate([p[k] for p in parts])
            for k in parts[0].keys()
        }

    def iter_batches(
        self,
        batch_size: int,
        shuffle_buffer_size: int = 0,
        seed: Optional[int] = None,
        drop_remainder: bool = False,
        num_reader_threads: int = 2,
    ) -> Iterator[Batch]:
        """Stream fixed-size batches.

        Shuffling is two-level and fully vectorized: shard order is permuted,
        then rows are permuted within a rolling buffer of
        ``>= shuffle_buffer_size`` rows (a chunk-granular reservoir
        shuffle).

        ``num_reader_threads``: shard files are read ``num_reader_threads``
        ahead by a small thread pool (np.load releases the GIL for file
        IO), overlapping disk reads with batch assembly. 0 reads
        synchronously.
        """
        # shuffling without an explicit seed still shuffles (fresh
        # entropy) — it must never silently degrade to written order
        rng = None
        if shuffle_buffer_size > 0:
            rng = np.random.default_rng(seed)
        order = np.arange(len(self.shard_paths))
        if rng is not None:
            rng.shuffle(order)

        pending: Optional[Batch] = None  # carry-over rows

        def emit(buf: Batch) -> Iterator[Batch]:
            nonlocal pending
            n = len(next(iter(buf.values())))
            if shuffle_buffer_size > 0 and rng is not None:
                perm = rng.permutation(n)
                buf = {k: v[perm] for k, v in buf.items()}
            full = (n // batch_size) * batch_size
            for lo in range(0, full, batch_size):
                yield {
                    k: v[lo : lo + batch_size] for k, v in buf.items()
                }
            if full < n:
                pending = {k: v[full:] for k, v in buf.items()}
            else:
                pending = None

        chunk: List[Batch] = []
        chunk_rows = 0
        target = max(shuffle_buffer_size, batch_size)
        for shard in self._read_shards(order, num_reader_threads):
            chunk.append(shard)
            chunk_rows += len(next(iter(shard.values())))
            if chunk_rows >= target:
                buf = {
                    k: np.concatenate([c[k] for c in chunk])
                    for k in chunk[0].keys()
                }
                if pending is not None:
                    buf = {
                        k: np.concatenate([pending[k], v])
                        for k, v in buf.items()
                    }
                yield from emit(buf)
                chunk, chunk_rows = [], 0

        # Flush the tail.
        tail_parts = ([] if pending is None else [pending]) + chunk
        if tail_parts:
            buf = {
                k: np.concatenate([p[k] for p in tail_parts])
                for k in tail_parts[0].keys()
            }
            yield from emit(buf)
            if pending is not None and not drop_remainder:
                yield pending
        pending = None
