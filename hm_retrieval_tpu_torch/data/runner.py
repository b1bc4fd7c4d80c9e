"""Serialization pipeline stage: train / test splits -> encoded shards.

Counterpart of the JAX package's ``data/runner.py`` (ref:
pkg/tfrecord_writer/runner.py:11-52), without pandas. Writes three
datasets:

1. unique candidates: the first row of each candidate id over train then
   test, its candidate-feature columns (a candidate id is assumed never to
   carry differing features, ref: runner.py:32-43);
2. train;
3. test.

With ``settings.shard_stream_rows`` the splits stream through the writer a
batch at a time (``iter_table_batches`` over ``.npz`` / ``.parquet`` /
``.csv``), the candidates collected in the same pass; the shards are the
in-memory stage's, file for file.
"""

from __future__ import annotations

import logging

import numpy as np

from hm_retrieval_tpu_torch.data.shard_writer import ShardWriter
from hm_retrieval_tpu_torch.etl.transformations import (
    concat_tables,
    drop_duplicates,
    iter_table_batches,
    load_dataframe,
    select,
    take,
)
from hm_retrieval_tpu_torch.schema.schema import Schema
from hm_retrieval_tpu_torch.utils.settings import Settings

logger = logging.getLogger(__name__)

__all__ = ["iter_table_batches", "shard_writer_runner"]


def _key(v):
    return "nan" if v != v else v  # every NaN id is one id


def _shard_writer_runner_streaming(settings: Settings, schema: Schema) -> None:
    """The splits flow through encode + write ``shard_stream_rows`` rows at a
    time (one batch and one shard buffer in memory); the unique candidates
    are collected in the same pass, first occurrence across train then
    test."""
    feature_cols = [f.name for f in schema.features]
    candidate_cols = [f.name for f in schema.candidate_features]
    cid = schema.candidate_id_col
    seen, cand_parts = set(), []
    writer = ShardWriter(schema.features, settings.max_shard_rows)
    for split_path, out_dir in (
        (settings.train_data_filepath, settings.train_shards_dirpath),
        (settings.test_data_filepath, settings.test_shards_dirpath),
    ):

        def tables():
            for batch in iter_table_batches(split_path, feature_cols,
                                            settings.shard_stream_rows):
                cand = drop_duplicates(select(batch, candidate_cols), cid)
                keys = [_key(v) for v in cand[cid].tolist()]
                fresh = np.asarray([k not in seen for k in keys], bool)
                if fresh.any():
                    cand_parts.append(take(cand, fresh))
                    seen.update(keys)
                yield batch

        writer.write_shards_streaming(tables(), out_dir)
    if cand_parts:
        candidates = concat_tables(cand_parts)
    else:
        candidates = {c: np.zeros(0, dtype=object) for c in candidate_cols}
    logger.info("Found %d unique candidates", len(candidates[cid]))
    ShardWriter(schema.candidate_features, settings.max_shard_rows
                ).write_shards(candidates, settings.candidate_shards_dirpath)


def shard_writer_runner(settings: Settings) -> None:
    schema = Schema.load(settings.schema_dirpath)
    if settings.shard_stream_rows:
        return _shard_writer_runner_streaming(settings, schema)
    feature_cols = [f.name for f in schema.features]
    train = load_dataframe(settings.train_data_filepath, columns=feature_cols)
    test = load_dataframe(settings.test_data_filepath, columns=feature_cols)

    candidate_cols = [f.name for f in schema.candidate_features]
    candidates = drop_duplicates(
        concat_tables([select(train, candidate_cols),
                       select(test, candidate_cols)]),
        schema.candidate_id_col)
    logger.info("Found %d unique candidates",
                len(candidates[schema.candidate_id_col]))

    ShardWriter(schema.candidate_features, settings.max_shard_rows
                ).write_shards(candidates, settings.candidate_shards_dirpath)
    writer = ShardWriter(schema.features, settings.max_shard_rows)
    writer.write_shards(train, settings.train_shards_dirpath)
    writer.write_shards(test, settings.test_shards_dirpath)
