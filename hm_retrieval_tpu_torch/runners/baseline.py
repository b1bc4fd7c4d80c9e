"""Popularity-baseline evaluation stage.

Counterpart of the JAX package's ``runners/baseline.py`` (ref:
baseline_modelling_runner, pkg/modelling/runner.py:111-152): build a
``StaticIndex`` from the raw transactions' popularity over the train date
range, stream the test shards through the same Recall@K, and save the index
artifact. It needs no pandas (``etl/transformations.py``).
"""

from __future__ import annotations

import logging
from typing import Dict

from hm_retrieval_tpu_torch.data.dataset import ShardDataset
from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.etl.transformations import (
    date_filter,
    load_dataframe,
)
from hm_retrieval_tpu_torch.indices.static_index import StaticIndex
from hm_retrieval_tpu_torch.metrics.index_recall import IndexRecall
from hm_retrieval_tpu_torch.schema.schema import Schema
from hm_retrieval_tpu_torch.utils.settings import Settings

logger = logging.getLogger(__name__)


def baseline_modelling_runner(
    settings: Settings, device: DeviceLike = None
) -> Dict[int, float]:
    """Recall@K of the popularity index over the test shards, on ``device``
    (None: the card). Ks larger than the index are dropped with a
    warning."""
    dev = resolve_device(device)
    schema = Schema.load(settings.schema_dirpath)
    tc, mc = schema.training_config, schema.model_config

    transactions = load_dataframe(
        settings.transactions_filepath,
        columns=[settings.date_column, settings.article_id_column],
    )
    train_range = date_filter(
        transactions,
        settings.date_column,
        settings.train_start_date,
        settings.train_end_date,
    )
    index = StaticIndex.build_popularity_index_from_series(
        train_range[settings.article_id_column], schema, max(mc.ks),
        device=dev,
    )

    usable_ks = [x for x in mc.ks if x <= index.k]
    if len(usable_ks) < len(mc.ks):
        logger.warning("Dropping ks > popularity index size %d", index.k)
    metric = IndexRecall(usable_ks)
    test_ds = ShardDataset(settings.test_shards_dirpath)
    for batch in test_ds.iter_batches(tc.test_batch_size):
        true_ids = batch[schema.candidate_id_col]
        retrieved = index.query(len(true_ids), k=metric.max_k)
        metric.update(retrieved, true_ids)
    res = metric.log_metric(None, writer=None)
    index.save(settings.baseline_index_dirpath)
    return res
