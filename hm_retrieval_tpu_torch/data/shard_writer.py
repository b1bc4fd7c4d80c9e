"""Shard layout constants (own copy of the JAX package's
``data/shard_writer.py``).

Shards are ``shard_{n:05d}.npz`` files of columnar int32 ids and float32
numeric columns, beside a ``manifest.json``. Only the manifest's name is
kept here, for the reader; the writer (pandas / pyarrow ETL) is not ported.
"""

MANIFEST_NAME = "manifest.json"
