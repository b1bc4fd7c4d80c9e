"""Columnar shard serialization: encoded int32/float32 npz shards.

Counterpart of the JAX package's ``data/shard_writer.py``, without pandas:
the string -> id vocabulary lookup happens here, once, at write time.
Categorical columns are stored as dense ``int32`` ids (0 = OOV), sequence
columns as (rows, max_len) ``int32`` windows and numeric columns as
``float32``, in ``shard_{n:05d}.npz`` files of at most ``max_rows`` rows,
beside a ``manifest.json``. The shard boundaries, arrays and manifest equal
the JAX writer's on the same rows.

A list column (``ListColumn``) encodes each distinct token once and then
gathers the windows with ``encode_sequence_ids``; no Python list is made a
row.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Iterable, List

import numpy as np

from hm_retrieval_tpu_torch.etl.transformations import ListColumn, Table
from hm_retrieval_tpu_torch.schema.features import Feature, FeatureKind

logger = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"


class ShardWriter:
    """Writes a table as encoded columnar shards (ref: TFRecordWriter,
    pkg/tfrecord_writer/tfrecord_writer.py:80-126)."""

    def __init__(self, features: List[Feature], max_rows: int = 100_000):
        if max_rows <= 0:
            raise ValueError("max_rows must be positive")
        self.features = features
        self.max_rows = max_rows

    def encode_table(self, table: Table) -> Dict[str, np.ndarray]:
        """Vectorized encode of every schema feature column."""
        out: Dict[str, np.ndarray] = {}
        for f in self.features:
            col = table[f.name]
            if f.kind == FeatureKind.CATEGORICAL:
                out[f.name] = f.encode(col)
            elif f.kind == FeatureKind.SEQUENCE:
                if isinstance(col, ListColumn):
                    # one vocab lookup a distinct token, then int windows
                    flat_ids = f.encode(col.tokens)[col.codes]
                    out[f.name] = f.encode_sequence_ids(flat_ids, col.offsets)
                else:
                    out[f.name] = f.encode_sequence(list(col))
            else:
                out[f.name] = f.transform_numeric(col)
        return out

    encode_dataframe = encode_table  # the JAX package's name

    def write_shards(self, table: Table, dirpath: str) -> int:
        """Encode + write; returns the number of shards written."""
        return self.write_shards_streaming([table], dirpath)

    def write_shards_streaming(self, tables: Iterable[Table],
                               dirpath: str) -> int:
        """Encode + write from an iterable of tables, holding one input table
        and about ``max_rows`` encoded rows. Shard boundaries and contents
        equal one ``write_shards`` over the concatenated tables."""
        os.makedirs(dirpath, exist_ok=True)
        pending: Dict[str, List[np.ndarray]] = {
            f.name: [] for f in self.features
        }
        pend_rows = 0
        n = 0
        s = 0

        def flush(final: bool) -> None:
            nonlocal pend_rows, s
            while pend_rows >= self.max_rows or (final and pend_rows > 0):
                take = min(self.max_rows, pend_rows)
                shard = {}
                for key, parts in pending.items():
                    col = parts[0] if len(parts) == 1 else np.concatenate(parts)
                    shard[key] = col[:take]
                    pending[key] = [col[take:]] if take < len(col) else []
                pend_rows -= take
                np.savez(os.path.join(dirpath, f"shard_{s:05d}.npz"), **shard)
                s += 1

        empty_template = None
        for table in tables:
            rows = len(table[self.features[0].name])
            if not rows:
                empty_template = table
                continue
            for key, arr in self.encode_table(table).items():
                pending[key].append(arr)
            pend_rows += rows
            n += rows
            flush(final=False)
        flush(final=True)
        if s == 0:
            # zero rows: the one-empty-shard layout readers expect
            if empty_template is None:
                empty_template = {f.name: np.zeros(0, dtype=object)
                                  for f in self.features}
            np.savez(os.path.join(dirpath, "shard_00000.npz"),
                     **self.encode_table(empty_template))
            s = 1
        manifest = {
            "num_rows": n,
            "num_shards": s,
            # rows per shard (the last may be short)
            "max_rows": self.max_rows,
            "features": {
                f.name: (
                    "float32" if f.kind == FeatureKind.NUMERIC else "int32"
                )
                for f in self.features
            },
        }
        with open(os.path.join(dirpath, MANIFEST_NAME), "w") as fp:
            json.dump(manifest, fp, indent=2)
        logger.info("Wrote %d rows as %d shard(s) to %s", n, s, dirpath)
        return s
