"""ETL and schema-building pipeline stages, without pandas.

Counterpart of the JAX package's ``etl/runner.py`` (ref:
pkg/etl/runner.py:9-84):

- ``etl_runner``: load transactions / articles / customers, inner-join
  articles on article_id then customers on customer_id, add the purchase
  history when asked, date-split into train / test and save. With
  ``settings.etl_chunk_rows`` the transactions stream through in chunks,
  each column typed over the whole file; the splits hold the same rows in
  the same order.
- ``build_schema_runner``: categorical vocabs, standalone sequence vocabs
  and numeric stats from the TRAIN split only, the logQ table from train
  frequencies, saved as the schema artifact. With
  ``settings.schema_stream_rows`` one pass over the split in batches holds
  only the count tables: the same vocabs and logQ; the stats by Chan's
  pairwise combine, as the JAX streaming stage computes them (trap o).

The splits are written by extension: ``.npz`` (the port's format),
``.parquet`` (where pyarrow is installed) or ``.csv`` (no history column).
"""

from __future__ import annotations

import csv
import logging
import os
import shutil

import numpy as np

from hm_retrieval_tpu_torch.etl.transformations import (
    Join,
    ListColumn,
    TableWriter,
    add_history_column,
    build_history_state,
    date_filter,
    factorize,
    history_flat_range,
    iter_csv_chunks,
    iter_table_batches,
    load_dataframe,
    merge_inner,
    save_dataframe,
    take,
    _token_strings,
)
from hm_retrieval_tpu_torch.schema.features import FeatureKind, present_strings
from hm_retrieval_tpu_torch.schema.schema import Schema
from hm_retrieval_tpu_torch.utils.settings import Settings

logger = logging.getLogger(__name__)

_NAN = object()  # the one key of every NaN


def _merge(settings: Settings, transactions, articles, customers):
    return merge_inner(
        merge_inner(transactions, articles, settings.article_id_column),
        customers, settings.customer_id_column)


def _splits(settings: Settings):
    return {
        "train": (settings.train_data_filepath, settings.train_start_date,
                  settings.train_end_date),
        "test": (settings.test_data_filepath, settings.test_start_date,
                 settings.test_end_date),
    }


def etl_runner(settings: Settings) -> None:
    """Join raw CSVs and produce train/test splits (ref:
    pkg/etl/runner.py:9-51)."""
    if settings.etl_chunk_rows:
        return _etl_runner_chunked(settings)
    merged = _merge(settings, load_dataframe(settings.transactions_filepath),
                    load_dataframe(settings.articles_filepath),
                    load_dataframe(settings.customers_filepath))
    logger.info("Merged table has %d rows",
                len(merged[settings.date_column]))
    if settings.history_max_len:
        logger.info("Adding %s (last %d items)", settings.history_column,
                    settings.history_max_len)
        merged = add_history_column(
            merged, settings.customer_id_column, settings.article_id_column,
            settings.history_column, settings.history_max_len,
            date_col=settings.date_column)
    for path, start, end in _splits(settings).values():
        save_dataframe(date_filter(merged, settings.date_column, start, end),
                       path, settings.date_column)


class _GrowingIndex:
    """Incremental factorize: codes against the distinct values seen so
    far, in order of first appearance over everything seen, as
    ``pd.factorize`` over the concatenated whole (the JAX package's
    ``_grow_codes``). With ``dropna`` a missing value is coded -1."""

    def __init__(self, dropna: bool = False):
        self.dropna = dropna
        self.lookup = {}

    def codes(self, values: np.ndarray) -> np.ndarray:
        local, uniq = factorize(values)  # first appearance in these values
        keys = uniq.tolist()
        if uniq.dtype.kind == "f":
            keys = [_NAN if k != k else k for k in keys]
        missing = {_NAN, ""}.__contains__ if self.dropna else (
            lambda k: False)
        for k in keys:
            if not missing(k):
                self.lookup.setdefault(k, len(self.lookup))
        glob = np.asarray([-1 if missing(k) else self.lookup[k]
                           for k in keys], np.int64)
        return glob[local]

    def uniques(self) -> np.ndarray:
        keys = list(self.lookup)
        if any(k is _NAN for k in keys):
            return np.asarray([np.nan if k is _NAN else k for k in keys])
        return np.asarray(keys)


def _etl_runner_chunked(settings: Settings) -> None:
    """Streaming ``etl_runner``: the transactions flow through the join
    ``etl_chunk_rows`` at a time, each column typed over the whole file
    (the JAX package's dtype pre-pass, trap p); each chunk's join is kept
    beside the splits; the history windows come from globally coded
    O(rows) int arrays (``build_history_state``), one chunk's windows at a
    time; each split is written a chunk at a time (``TableWriter``)."""
    articles = load_dataframe(settings.articles_filepath)
    customers = load_dataframe(settings.customers_filepath)
    hist = settings.history_max_len
    date_col = settings.date_column
    tmp_dir = os.path.join(
        os.path.dirname(settings.train_data_filepath) or ".", "_etl_chunks")
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)

    by_article = Join(articles, settings.article_id_column)
    by_customer = Join(customers, settings.customer_id_column)
    # a right table of unique keys codes each key by its row
    users = None if by_customer.unique_keys else _GrowingIndex()
    items = None if by_article.unique_keys else _GrowingIndex()
    dates = _GrowingIndex(dropna=True)
    user_parts, item_parts, date_parts = [], [], []
    chunk_files, template = [], None
    for i, chunk in enumerate(iter_csv_chunks(
            settings.transactions_filepath, None, settings.etl_chunk_rows)):
        a_left, a_right = by_article.rows(chunk)
        joined = by_article(chunk, (a_left, a_right))
        c_left, c_right = by_customer.rows(joined)
        merged = by_customer(joined, (c_left, c_right))
        if hist:
            user_parts.append(
                c_right if users is None
                else users.codes(merged[settings.customer_id_column]))
            item_parts.append(
                a_right[c_left] if items is None
                else items.codes(merged[settings.article_id_column]))
            date_parts.append(dates.codes(merged[date_col]))
        path = os.path.join(tmp_dir, f"chunk_{i:05d}.npz")
        save_dataframe(merged, path)
        chunk_files.append((path, len(merged[date_col])))
    logger.info("Merged table has %d rows (%d chunks)",
                sum(m for _, m in chunk_files), len(chunk_files))

    state, tokens = None, np.zeros(0, str)
    if hist and sum(m for _, m in chunk_files):
        # factorize(sort=True) for dates: codes rank the distinct dates in
        # sorted order, a missing date above every real one
        uniques = dates.uniques()
        rank = np.empty(len(uniques), np.int64)
        rank[np.argsort(uniques, kind="stable")] = np.arange(len(uniques))
        raw = np.concatenate(date_parts)
        date_codes = np.where(raw < 0, len(uniques),
                              rank[np.maximum(raw, 0)] if len(rank) else 0)
        state = build_history_state(np.concatenate(user_parts), date_codes,
                                    np.concatenate(item_parts), hist)
        tokens = _token_strings(articles[settings.article_id_column]
                                if items is None else items.uniques())
        del user_parts, item_parts, date_parts, raw, date_codes

    writers = {name: TableWriter(path)
               for name, (path, _, _) in _splits(settings).items()}
    lo = 0
    for path, m in chunk_files:
        table = load_dataframe(path)
        if hist:
            offsets, flat = (history_flat_range(state, lo, lo + m) if m
                             else (np.zeros(1, np.int64), np.zeros(0, np.int32)))
            table[settings.history_column] = ListColumn(offsets, flat, tokens)
        lo += m
        if template is None:
            template = take(table, np.zeros(0, np.int64))
        for name, (_, start, end) in _splits(settings).items():
            part = date_filter(table, date_col, start, end)
            if len(part[date_col]):
                writers[name].write(part)
    if template is None:  # no rows at all: the columns of the headers' join
        template = _empty_join(settings, articles, customers)
        if hist:
            template[settings.history_column] = ListColumn(
                np.zeros(1, np.int64), np.zeros(0, np.int32), tokens)
    for name, (path, start, end) in _splits(settings).items():
        if not writers[name].rows:
            # an empty split keeps the full column list
            writers[name].write(template)
        writers[name].close()
        logger.info("Saved %d rows covering %s..%s to %s",
                    writers[name].rows, start, end, path)
    shutil.rmtree(tmp_dir, ignore_errors=True)


def _empty_join(settings: Settings, articles, customers):
    """The join of a transactions CSV with no rows: its header's columns
    (str, the keys of the right tables' types), then the right tables'."""
    with open(settings.transactions_filepath, newline="") as f:
        names = next(csv.reader(f), [])
    table = {n: np.zeros(0, str) for n in names}
    for key, right in ((settings.article_id_column, articles),
                       (settings.customer_id_column, customers)):
        table[key] = right[key][:0]
        table = merge_inner(table, right, key)
    return table


class _StreamCounts:
    """Incremental ``value_counts``: distinct strings in order of first
    appearance over the whole split and their counts, so the final stable
    descending sort gives the in-memory order, ties included (trap n)."""

    def __init__(self):
        self.index = _GrowingIndex()
        self.counts = np.zeros(0, np.int64)

    def update(self, values: np.ndarray) -> None:
        codes = self.index.codes(present_strings(values))
        grown = np.zeros(len(self.index.lookup), np.int64)
        grown[: len(self.counts)] = self.counts
        self.counts = grown + np.bincount(codes, minlength=len(grown))

    def value_counts(self):
        order = np.argsort(-self.counts, kind="stable")
        tokens = np.asarray(list(self.index.lookup), dtype=str)
        return tokens[order], self.counts[order]


def _build_schema_runner_streaming(settings: Settings, schema: Schema) -> None:
    """Streaming vocab / stats / logQ build: one pass over the train split
    in ``schema_stream_rows`` batches, holding only count tables; sequence
    columns that share a vocab are not read (ref: the JAX package's
    ``_build_schema_runner_streaming``)."""
    cat = [f for f in schema.features
           if f.kind == FeatureKind.CATEGORICAL and not f.has_vocab]
    seq = [f for f in schema.features
           if f.kind == FeatureKind.SEQUENCE and not f.has_vocab
           and not f.shared_vocab_with]
    num = [f for f in schema.features
           if f.kind == FeatureKind.NUMERIC and f.standardize]
    need_logq = schema.training_config.use_logq_correction
    cols = {f.name for f in cat + seq + num}
    if need_logq:
        cols.add(schema.candidate_id_col)
    counters = {name: _StreamCounts()
                for name in cols - {f.name for f in num}}
    # nan-aware (n, mean, M2) with the pairwise combine (Chan et al.)
    sums = {f.name: [0, 0.0, 0.0] for f in num}
    total_rows = 0
    cat_names = {f.name for f in cat}
    for batch in iter_table_batches(settings.train_data_filepath,
                                    sorted(cols), settings.schema_stream_rows):
        total_rows += len(batch[next(iter(batch))])
        for f in cat:
            counters[f.name].update(batch[f.name])
        for f in seq:
            counters[f.name].update(batch[f.name].flat_tokens())
        if need_logq and schema.candidate_id_col not in cat_names:
            counters[schema.candidate_id_col].update(
                batch[schema.candidate_id_col])
        for f in num:
            col = np.asarray(batch[f.name], dtype=np.float64)
            col = col[~np.isnan(col)]
            cn = len(col)
            if not cn:
                continue
            cmean = float(col.mean())
            c_m2 = float(((col - cmean) ** 2).sum())
            n, m, m2 = sums[f.name]
            tot = n + cn
            delta = cmean - m
            sums[f.name] = [
                tot,
                m + delta * cn / tot,
                m2 + c_m2 + delta * delta * n * cn / tot,
            ]

    for f in cat + seq:
        tokens, _ = counters[f.name].value_counts()
        if f.max_vocab_size is not None:
            tokens = tokens[: f.max_vocab_size]
        f.vocab = tokens
        f._token_to_id = None
        logger.info("Feature %s vocab size %d (streamed)", f.name,
                    len(f.vocab))
    for f in num:
        n, m, m2 = sums[f.name]
        if n:
            f.mean = m
            f.std = float(np.sqrt(m2 / n)) or 1.0
        else:  # np.nanmean / np.nanstd over an all-NaN column
            f.mean = float("nan")
            f.std = float("nan")
    schema._wire_shared_vocabs()
    if need_logq:
        schema.build_logq_from_value_counts(
            counters[schema.candidate_id_col].value_counts(), total_rows)
        logger.info("Built logQ table with %d entries", len(schema.logq))
    schema.save(settings.schema_dirpath)


def build_schema_runner(settings: Settings, schema: Schema) -> None:
    """Build vocabs + logQ from the train split and save the schema (ref:
    pkg/etl/runner.py:54-84). ``settings.schema_stream_rows`` streams the
    pass."""
    if settings.schema_stream_rows:
        return _build_schema_runner_streaming(settings, schema)
    train = load_dataframe(settings.train_data_filepath,
                           columns=[f.name for f in schema.features])
    schema.build_features_from_dataframe(train)
    if schema.training_config.use_logq_correction:
        schema.build_logq_from_dataframe(train)
        logger.info("Built logQ table with %d entries", len(schema.logq))
    schema.save(settings.schema_dirpath)
