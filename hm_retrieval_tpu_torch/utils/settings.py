"""Run settings: every filepath / date-range / shard-size knob in one place.

Own copy of the JAX package's ``utils/settings.py`` (which imports no JAX):
the same fields and the same JSON form, so one ``settings.json`` drives
either package. The fields of stages the port has not taken over yet (ETL,
schema build, shard writing, the SavedModel export) are kept so the file
round-trips unchanged. The JAX package's notes on the reference Settings
dataclass (ref: pkg/utils/settings.py:6-73) follow. Differences by design:

- JSON round-trip instead of living only in the entrypoint, so every pipeline
  stage can be launched independently with an identical config snapshot.
- Data is serialized as columnar ``.npz`` shards (ints on device) instead of
  TFRecords, so the shard paths point at directories of ``*.npz``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Settings:
    """All pipeline parameters that are not model/feature config.

    Mirrors the knob set of the reference (ref: pkg/utils/settings.py):
    raw CSV paths, train/test date ranges, processed data paths, shard row
    cap (`max_tfrecord_rows` analog), and the TensorBoard log dir.
    """

    # Raw inputs (H&M Kaggle CSVs or synthetic equivalents).
    transactions_filepath: str = "data/raw/transactions_train.csv"
    articles_filepath: str = "data/raw/articles.csv"
    customers_filepath: str = "data/raw/customers.csv"

    # Inclusive date ranges for the train/test split
    # (ref defaults: 2019-09-20..2020-08-20 train, 2020-08-21..2020-09-21
    # test, main.py:11-30).
    train_start_date: str = "2019-09-20"
    train_end_date: str = "2020-08-20"
    test_start_date: str = "2020-08-21"
    test_end_date: str = "2020-09-21"

    # ETL outputs.
    train_data_filepath: str = "data/processed/train.parquet"
    test_data_filepath: str = "data/processed/test.parquet"

    # Schema artifact directory (schema.json + vocabs.npz + logq.npy).
    schema_dirpath: str = "data/schema"

    # Encoded shard directories (the TFRecord-shard analog).
    train_shards_dirpath: str = "data/shards/train"
    test_shards_dirpath: str = "data/shards/test"
    candidate_shards_dirpath: str = "data/shards/candidates"

    # Max rows per serialized shard (ref: max_tfrecord_rows, 100k).
    max_shard_rows: int = 100_000

    # Model / index artifacts.
    model_dirpath: str = "artifacts/model"
    index_dirpath: str = "artifacts/index"
    baseline_index_dirpath: str = "artifacts/baseline_index"
    checkpoint_dirpath: str = "artifacts/checkpoints"
    # When set, the modelling runner also exports a TF-Serving
    # SavedModel (string-in/string-out, the reference's deployment
    # artifact — ref: README.md:101-105) to this directory.
    savedmodel_dirpath: Optional[str] = None

    # Observability (ref: tensorboard_logs_dir default "./logs").
    tensorboard_logs_dir: str = "logs"
    # Step window to capture a profiler trace over, or None to disable
    # (ref: profile_batch="20,40", pkg/modelling/runner.py:66).
    profile_steps: Optional[tuple] = (20, 40)

    # Column names in the raw data.
    date_column: str = "t_dat"
    customer_id_column: str = "customer_id"
    article_id_column: str = "article_id"

    # When set, ETL adds a per-transaction purchase-history column (the
    # customer's previous N article ids, computed on the merged frame
    # BEFORE the date split so test rows see train-period history;
    # current row excluded -> no label leakage). Feeds a SEQUENCE query
    # feature (BASELINE config[3]).
    history_max_len: Optional[int] = None
    history_column: str = "purchase_history"

    # When set, etl_runner streams the transactions CSV in chunks of
    # this many rows (join + split + parquet append per chunk; history
    # windows computed from O(N)-int compact arrays) instead of
    # loading everything in memory — removes the ~5x-reference-scale
    # RAM ceiling of the in-memory triple join (BASELINE.md "Full
    # pipeline at H&M scale"). None = in-memory (reference parity).
    etl_chunk_rows: Optional[int] = None

    # When set, the schema stage builds vocabs/stats/logQ in one
    # streaming pass of this many parquet rows at a time, holding
    # only count tables (O(uniques)); sequence columns with shared
    # vocabs are not read at all. Identical schema artifact.
    schema_stream_rows: Optional[int] = None

    # When set, the shards stage streams the train/test parquet
    # through encode+write this many rows at a time instead of
    # loading whole splits (identical shard files; candidates
    # collected in the same pass). Pairs with etl_chunk_rows for an
    # O(chunk)-memory pipeline.
    shard_stream_rows: Optional[int] = None

    extra: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------
    def to_json(self, filepath: str) -> None:
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        payload = dataclasses.asdict(self)
        if payload.get("profile_steps") is not None:
            payload["profile_steps"] = list(payload["profile_steps"])
        with open(filepath, "w") as f:
            json.dump(payload, f, indent=2)

    @classmethod
    def from_json(cls, filepath: str) -> "Settings":
        with open(filepath) as f:
            payload = json.load(f)
        if payload.get("profile_steps") is not None:
            payload["profile_steps"] = tuple(payload["profile_steps"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in payload.items() if k in known})
