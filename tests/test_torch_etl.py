"""The port's synthetic data, ETL and schema stages against the JAX package's.

The same CSVs (the port's generator writes the JAX generator's bytes) go
through the JAX stages (pandas, parquet splits) and the port's (numpy,
``.npz`` splits unless named): the splits must hold the same columns, rows,
order and values, a missing string reading as ``""`` in the port where
pandas reads NaN; the schema artifacts the same vocabs and logQ, and the
statistics of each path the bits of the matching JAX path. The traps of
ROADMAP.md l-p are each held against pandas or the JAX function; a
subprocess runs the three stages with pandas and pyarrow blocked, as on the
card's machine.
"""

import dataclasses
import filecmp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from hm_retrieval_tpu.etl.runner import _StreamCounts as JaxStreamCounts
from hm_retrieval_tpu.etl.transformations import (
    date_filter as jax_date_filter,
    load_dataframe as jax_load_dataframe,
)
from hm_retrieval_tpu.runners import (
    build_schema_runner as jax_build_schema_runner,
    etl_runner as jax_etl_runner,
)
from hm_retrieval_tpu.schema import (
    Feature as JaxFeature,
    ModelConfig as JaxModelConfig,
    Schema as JaxSchema,
    TrainingConfig as JaxTrainingConfig,
)
from hm_retrieval_tpu.utils.settings import Settings as JaxSettings
from hm_retrieval_tpu.utils.synthetic import (
    generate_hm_like_csvs as jax_generate,
)
from hm_retrieval_tpu_torch.etl.runner import _StreamCounts
from hm_retrieval_tpu_torch.etl.transformations import (
    ListColumn,
    date_filter,
    load_dataframe,
    merge_inner,
    save_dataframe,
)
from hm_retrieval_tpu_torch.runners import build_schema_runner, etl_runner
from hm_retrieval_tpu_torch.schema import (
    Feature,
    ModelConfig,
    Schema,
    TrainingConfig,
)
from hm_retrieval_tpu_torch.utils import Settings
from hm_retrieval_tpu_torch.utils.synthetic import generate_hm_like_csvs

ROOT = Path(__file__).resolve().parent.parent


# --- helpers shared with tests/test_torch_shards.py ---------------------------


def feature_specs(history=False, standalone_history=False, standardize=False):
    specs = [
        dict(name="customer_id", kind="categorical", family="query",
             embedding_size=4),
        dict(name="age", kind="numeric", family="query",
             standardize=standardize),
        dict(name="article_id", kind="categorical", family="candidate",
             embedding_size=4),
        dict(name="product_type_name", kind="categorical",
             family="candidate", embedding_size=2),
    ]
    if history:
        specs.append(dict(
            name="purchase_history", kind="sequence", family="query",
            embedding_size=4, max_len=3,
            shared_vocab_with=None if standalone_history else "article_id"))
    return specs


def schemas(**kw):
    """The same schema, every vocab empty, in both packages."""
    specs = feature_specs(**kw)
    jax_schema = JaxSchema(
        [JaxFeature(**s) for s in specs], JaxModelConfig(8, ks=[1, 2]),
        JaxTrainingConfig(), candidate_id_col="article_id")
    port_schema = Schema(
        [Feature(**s) for s in specs], ModelConfig(8, ks=[1, 2]),
        TrainingConfig(), candidate_id_col="article_id")
    return jax_schema, port_schema


def stage_fields(d, raw, ext, **kw):
    fields = dict(
        transactions_filepath=raw["transactions"],
        articles_filepath=raw["articles"],
        customers_filepath=raw["customers"],
        train_start_date=raw["train_start"],
        train_end_date=raw["train_end"],
        test_start_date=raw["test_start"],
        test_end_date=raw["test_end"],
        train_data_filepath=f"{d}/processed/train.{ext}",
        test_data_filepath=f"{d}/processed/test.{ext}",
        schema_dirpath=f"{d}/schema",
        train_shards_dirpath=f"{d}/shards/train",
        test_shards_dirpath=f"{d}/shards/test",
        candidate_shards_dirpath=f"{d}/shards/candidates",
        max_shard_rows=150,
    )
    fields.update(kw)
    return fields


def both_settings(tmp_path, raw, port_ext="npz", jax_kw=None, **kw):
    """(JAX settings writing parquet splits, the port's settings writing
    ``port_ext`` splits), each in its own directory."""
    jax_settings = JaxSettings(**stage_fields(
        tmp_path / "jax", raw, "parquet", **{**kw, **(jax_kw or {})}))
    port = Settings(**stage_fields(tmp_path / "port", raw, port_ext, **kw))
    return jax_settings, port


def synthetic(tmp_path, n_transactions=1200, n_customers=50, n_articles=30,
              seed=3):
    return generate_hm_like_csvs(
        str(tmp_path / "raw"), n_transactions=n_transactions,
        n_customers=n_customers, n_articles=n_articles, seed=seed)


def assert_table_equals_frame(table, df):
    """The port's table holds the frame's columns, in order, with its
    values: int64, float64 (NaN in place), bool, str (a missing value
    ``""``) and lists of tokens."""
    assert list(table) == list(df.columns)
    for name in df.columns:
        col, want = table[name], df[name]
        if isinstance(col, ListColumn):
            assert col.tolist() == [list(x) for x in want], name
        elif want.dtype.kind in "iub":
            assert col.dtype == want.dtype, name
            np.testing.assert_array_equal(col, want.to_numpy(), err_msg=name)
        elif want.dtype.kind == "f":
            assert col.dtype == np.float64, name
            np.testing.assert_array_equal(col, want.to_numpy(), err_msg=name)
        else:
            assert col.dtype.kind == "U", (name, col.dtype)
            assert col.tolist() == [
                "" if pd.isna(v) else str(v) for v in want], name


def assert_same_schema(port_dir, jax_dir, stats=True):
    got, want = Schema.load(port_dir), JaxSchema.load(jax_dir)
    for a, b in zip(got.features, want.features):
        assert a.name == b.name
        assert a.has_vocab == b.has_vocab, a.name
        if a.has_vocab:
            assert a.vocab.dtype.kind == "U"
            np.testing.assert_array_equal(a.vocab, b.vocab, err_msg=a.name)
        if stats:
            np.testing.assert_array_equal([a.mean, a.std], [b.mean, b.std],
                                          err_msg=a.name)
    if want.logq is None:
        assert got.logq is None
    else:
        assert got.logq.dtype == want.logq.dtype == np.float32
        np.testing.assert_array_equal(got.logq, want.logq)
    return got, want


# --- the generator -----------------------------------------------------------


@pytest.mark.parametrize("seed, n_transactions, n_customers, n_articles", [
    (0, 5000, 503, 97), (3, 777, 40, 25), (11, 20000, 2003, 1000),
])
def test_generator_writes_the_jax_generators_bytes(
    tmp_path, seed, n_transactions, n_customers, n_articles
):
    kw = dict(n_transactions=n_transactions, n_customers=n_customers,
              n_articles=n_articles, seed=seed)
    want = jax_generate(str(tmp_path / "jax"), **kw)
    got = generate_hm_like_csvs(str(tmp_path / "port"), **kw)
    for name in ("transactions", "articles", "customers"):
        assert filecmp.cmp(got[name], want[name], shallow=False), name
    assert {k: v for k, v in got.items() if not v.endswith(".csv")} == {
        k: v for k, v in want.items() if not v.endswith(".csv")}


# --- trap l: CSV typing ------------------------------------------------------

CSV_BODIES = [
    # (body, pandas dtype kind of x)
    ("x,y\n1,a\n,b\n3,c\n", "f"),  # an int column with a missing value
    ("x,y\n0108775015,a\n0000000001,b\n", "i"),  # leading zeros (trap j)
    ("x,y\na,a\nNA,b\nnull,c\nnan,d\nN/A,e\n#N/A,f\nNone,g\n", "str"),
    ("x,y\n,a\n,b\n", "f"),  # every value missing
    ("x,y\n1.5,a\n2,b\n1e3,c\n.5,d\n-inf,e\nInfinity,f\n", "f"),
    ("x,y\n 12 ,a\n+3,b\n-4,c\n", "i"),
    ("x,y\ntrue,a\nFALSE,b\nTrue,c\n", "b"),
    ("x,y\n1_0,a\n2,b\n", "str"),  # not a number to pandas
    ("x,y\n1,a\nx,b\n", "str"),
    ('x,y\n"",a\n" q ",b\n', "str"),
]


@pytest.mark.parametrize("body, kind", CSV_BODIES)
def test_csv_columns_read_as_pd_read_csv_types_them(tmp_path, body, kind):
    path = tmp_path / "t.csv"
    path.write_text(body)
    df = pd.read_csv(str(path))
    assert (df["x"].dtype.kind if kind != "str"
            else pd.api.types.is_string_dtype(df["x"]))
    assert kind == "str" or df["x"].dtype.kind == kind
    assert_table_equals_frame(load_dataframe(str(path)), df)


def test_a_bool_column_with_a_missing_value_raises(tmp_path):
    """pandas reads it as an object column of True / False / NaN, which has
    no plain type here."""
    path = tmp_path / "t.csv"
    path.write_text("x,y\nTrue,a\n,b\n")
    assert pd.read_csv(str(path))["x"].dtype == object
    with pytest.raises(ValueError, match="'x'.*bool"):
        load_dataframe(str(path))
    assert_table_equals_frame(load_dataframe(str(path), columns=["y"]),
                              pd.read_csv(str(path))[["y"]])


@pytest.mark.parametrize("column", ["x", "s"])
def test_a_missing_token_is_never_in_a_vocab_and_encodes_as_oov(
    tmp_path, column
):
    """``astype(str)`` keeps NaN under pandas 3 and ``value_counts`` drops
    it: the vocab of a float column holds "1.0", and a missing value of
    either column encodes as 0, in both packages."""
    path = tmp_path / "t.csv"
    path.write_text("x,s\n1,a\n,b\n1,\n3,a\nnan,NA\n")
    df = pd.read_csv(str(path))
    table = load_dataframe(str(path))
    spec = dict(name=column, kind="categorical", family="query",
                embedding_size=2)
    want, got = JaxFeature(**spec), Feature(**spec)
    want.build_vocab_from_dataframe(df)
    got.build_vocab_from_dataframe(table)
    np.testing.assert_array_equal(got.vocab, want.vocab)
    assert "nan" not in got.vocab.tolist() and "" not in got.vocab.tolist()
    if column == "x":
        assert got.vocab.tolist() == ["1.0", "3.0"]
    np.testing.assert_array_equal(got.encode(table[column]),
                                  want.encode(df[column].to_numpy()))


# --- trap m: the inner merge ---------------------------------------------------


def _frames(lk, rk):
    left = {"k": np.asarray(lk), "a": np.arange(len(lk), dtype=np.int64),
            "v": np.arange(len(lk), dtype=np.float64) / 2}
    right = {"k": np.asarray(rk), "b": np.arange(len(rk), dtype=np.int64) * 10,
             "v": np.asarray([f"r{i}" for i in range(len(rk))])}
    return left, right


@pytest.mark.parametrize("lk, rk", [
    ([3, 1, 2, 1], [1, 2, 1]),
    (["u1", "u9", "u2", "u1"], ["u2", "u1"]),
    ([5, 6], [1, 2]),  # nothing matches
    (list(np.random.default_rng(0).integers(0, 9, 40)),
     list(np.random.default_rng(1).integers(0, 12, 25))),
])
def test_merge_inner_follows_pandas(lk, rk):
    """Left rows in order, each once a matching right row in the right
    table's order (keys [3,1,2,1] against [1,2,1] give 1,1,2,1,1); an
    unmatched left row dropped; "v" in both takes _x / _y."""
    left, right = _frames(lk, rk)
    got = merge_inner(left, right, "k")
    want = pd.DataFrame(left).merge(pd.DataFrame(right), on="k", how="inner")
    assert_table_equals_frame(got, want)
    if lk == [3, 1, 2, 1]:
        assert got["k"].tolist() == [1, 1, 2, 1, 1]


def test_merge_inner_joins_missing_keys_as_pandas_does():
    """pandas joins a missing key to a missing key; a missing str key is
    "" here, a missing float key NaN."""
    left = {"k": np.array(["a", "", "b"]), "x": np.arange(3)}
    right = {"k": np.array(["", "a"]), "y": np.array([7, 8])}
    df_l = pd.DataFrame({"k": ["a", np.nan, "b"], "x": np.arange(3)})
    df_r = pd.DataFrame({"k": [np.nan, "a"], "y": [7, 8]})
    assert_table_equals_frame(merge_inner(left, right, "k"),
                              df_l.merge(df_r, on="k", how="inner"))
    left = {"k": np.array([1.0, np.nan, 2.0]), "x": np.arange(3)}
    right = {"k": np.array([np.nan, 2.0]), "y": np.array([7, 8])}
    assert_table_equals_frame(
        merge_inner(left, right, "k"),
        pd.DataFrame(left).merge(pd.DataFrame(right), on="k", how="inner"))
    with pytest.raises(ValueError, match="merge on"):
        merge_inner({"k": np.array([1])}, {"k": np.array(["1"])}, "k")


# --- trap n: vocab order across batches ------------------------------------------


@pytest.mark.parametrize("batch", [1, 3, 5, 100])
def test_streamed_counts_keep_first_appearance_over_the_whole_split(batch):
    """Ties follow first appearance over the whole split, not per batch:
    the in-memory value_counts order, as the JAX streaming counts give."""
    values = np.array(["b", "a", "c", "a", "b", "d", "c", "e", "e", "f"])
    port, jax_counts = _StreamCounts(), JaxStreamCounts()
    for lo in range(0, len(values), batch):
        port.update(values[lo:lo + batch])
        jax_counts.update(values[lo:lo + batch])
    tokens, counts = port.value_counts()
    want = pd.Series(values).value_counts()
    assert tokens.tolist() == want.index.tolist() == (
        jax_counts.value_counts().index.tolist())
    np.testing.assert_array_equal(counts, want.to_numpy())


# --- trap o: the two numeric-stat paths --------------------------------------------


def _raw_with_ages(tmp_path, ages):
    raw = synthetic(tmp_path, n_transactions=900, n_customers=len(ages),
                    n_articles=25, seed=5)
    text = "customer_id,age\n" + "".join(
        f"cust_{i:07d},{a}\n" for i, a in enumerate(ages))
    Path(raw["customers"]).write_text(text)
    return raw


@pytest.mark.parametrize("ages", ["spread", "missing", "all_missing"])
def test_each_stat_path_gives_its_jax_paths_bits(tmp_path, ages):
    """In memory: float64 nanmean / nanstd; streamed: Chan's pairwise
    combine; each bit-equal to the JAX path of its kind (an all-missing
    column gives NaN on both). The two paths need not agree."""
    rng = np.random.default_rng(0)
    values = {
        "spread": [repr(float(x)) for x in rng.normal(1e4, 0.3, 40)],
        "missing": [("" if i % 3 == 0 else str(16 + i)) for i in range(40)],
        "all_missing": [""] * 40,
    }[ages]
    raw = _raw_with_ages(tmp_path, values)
    for stream in (None, 7):
        jax_settings, port = both_settings(tmp_path / f"s{stream}", raw,
                                           schema_stream_rows=stream)
        jax_etl_runner(jax_settings)
        etl_runner(port)
        jax_schema, port_schema = schemas(standardize=True)
        jax_build_schema_runner(jax_settings, jax_schema)
        build_schema_runner(port, port_schema)
        got, _ = assert_same_schema(port.schema_dirpath,
                                    jax_settings.schema_dirpath)
        age = got.feature("age")
        assert np.isnan(age.mean) == (ages == "all_missing")


# --- trap p: dates ----------------------------------------------------------------


@pytest.mark.parametrize("start, end", [
    ("2020-01-02", "2020-01-04"), ("2020-01-01", "2020-01-01"),
    ("2019-01-01", "2020-01-01"), ("2020-01-05", "2020-02-01"),
])
def test_date_filter_is_inclusive_and_drops_missing_dates(tmp_path, start,
                                                          end):
    path = tmp_path / "t.csv"
    path.write_text("t_dat,v\n2020-01-02,1\n,2\n2020-01-01,3\n2020-01-04,4\n"
                    "2020-01-03,5\nNA,6\n")
    want = jax_date_filter(jax_load_dataframe(str(path)), "t_dat", start, end)
    assert_table_equals_frame(
        date_filter(load_dataframe(str(path)), "t_dat", start, end), want)


def _undated_raw(d, dates, tx_extra=None):
    (d / "raw").mkdir()
    tx = pd.DataFrame({
        "t_dat": dates,
        "customer_id": ["u1"] * len(dates),
        "article_id": ["a1", "a2", "a3", "a4", "a5", "a1"][:len(dates)],
        "price": [1.0] * len(dates),
    })
    tx.to_csv(d / "raw" / "transactions.csv", index=False)
    pd.DataFrame({"article_id": ["a1", "a2", "a3", "a4", "a5"],
                  "product_type_name": ["t"] * 5}).to_csv(
        d / "raw" / "articles.csv", index=False)
    pd.DataFrame({"customer_id": ["u1"], "age": [30.0]}).to_csv(
        d / "raw" / "customers.csv", index=False)
    return {
        "transactions": str(d / "raw" / "transactions.csv"),
        "articles": str(d / "raw" / "articles.csv"),
        "customers": str(d / "raw" / "customers.csv"),
        "train_start": "2020-01-01", "train_end": "2020-01-04",
        "test_start": "2020-02-01", "test_end": "2020-02-28",
    }


@pytest.mark.parametrize("chunk", [None, 1, 2, 4])
def test_missing_dates_sort_last_across_chunks(tmp_path, chunk):
    """tests/test_etl.py's undated rows (``test_nan_dates_cross_chunk``):
    the history puts them after every dated row, in whichever chunk they
    land; the empty test split keeps its columns."""
    raw = _undated_raw(tmp_path, ["2020-01-02", None, "2020-01-01",
                                  "2020-01-03", None, "2020-01-04"])
    jax_settings, port = both_settings(tmp_path, raw, history_max_len=4,
                                       etl_chunk_rows=chunk)
    jax_etl_runner(dataclasses.replace(jax_settings, etl_chunk_rows=None))
    etl_runner(port)
    got = load_dataframe(port.train_data_filepath)
    assert_table_equals_frame(
        got, jax_load_dataframe(jax_settings.train_data_filepath))
    assert got["purchase_history"].tolist()[-1] == ["a3", "a1", "a4"]
    empty = load_dataframe(port.test_data_filepath,
                           columns=["customer_id", "article_id"])
    assert list(empty) == ["customer_id", "article_id"]
    assert len(empty["article_id"]) == 0


@pytest.mark.parametrize("chunk", [None, 2])
def test_all_dates_missing_raise_type_error_in_both_paths(tmp_path, chunk):
    """Every t_dat missing: the column reads as float64 and the date filter
    raises TypeError, as pandas does (tests/test_etl.py:314)."""
    raw = _undated_raw(tmp_path, [None] * 4)
    _, port = both_settings(tmp_path, raw, history_max_len=4,
                            etl_chunk_rows=chunk)
    with pytest.raises(TypeError):
        etl_runner(port)


def test_chunked_etl_types_each_column_over_the_whole_file(tmp_path):
    """A column of integers in the first chunk and a string later reads as
    str everywhere (leading zeros kept), an int column with a missing value
    in a later chunk as float64 everywhere: what the JAX dtype pre-pass
    intends, held against the JAX in-memory split (the JAX chunked path
    itself raises TypeError on this file under pandas 3: np.promote_types
    cannot take its str dtype)."""
    raw = synthetic(tmp_path, n_transactions=300, seed=2)
    text = Path(raw["transactions"]).read_text().splitlines()
    rows = [text[0] + ",code,qty"] + [
        f"{line},{'0042' if i < 200 else 'x7'},{'' if i == 250 else i}"
        for i, line in enumerate(text[1:])]
    Path(raw["transactions"]).write_text("\n".join(rows) + "\n")
    jax_settings, port = both_settings(tmp_path, raw, etl_chunk_rows=64,
                                       jax_kw={"etl_chunk_rows": None})
    jax_etl_runner(jax_settings)
    with pytest.raises(TypeError):
        jax_etl_runner(dataclasses.replace(
            jax_settings, etl_chunk_rows=64,
            train_data_filepath=str(tmp_path / "c" / "train.parquet")))
    etl_runner(port)
    for split in ("train_data_filepath", "test_data_filepath"):
        got = load_dataframe(getattr(port, split))
        assert_table_equals_frame(got, jax_load_dataframe(
            getattr(jax_settings, split)))
    assert got["code"].dtype.kind == "U" and got["qty"].dtype == np.float64
    assert "0042" in load_dataframe(port.train_data_filepath)["code"].tolist()


# --- the ETL stage -------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 5000, 130, 7])
@pytest.mark.parametrize("history", [False, True],
                         ids=["no_history", "history"])
def test_etl_runner_gives_the_jax_splits(tmp_path, history, chunk):
    """In memory and chunked (one chunk, 130 rows, 7 rows), with and
    without the history column: the JAX in-memory split's columns, rows and
    order."""
    raw = synthetic(tmp_path, n_transactions=900, n_customers=40,
                    n_articles=25, seed=7)
    jax_settings, port = both_settings(
        tmp_path, raw, history_max_len=3 if history else None,
        etl_chunk_rows=chunk, jax_kw={"etl_chunk_rows": None})
    jax_etl_runner(jax_settings)
    etl_runner(port)
    for split in ("train_data_filepath", "test_data_filepath"):
        assert_table_equals_frame(
            load_dataframe(getattr(port, split)),
            jax_load_dataframe(getattr(jax_settings, split)))
    assert not (Path(port.train_data_filepath).parent / "_etl_chunks").exists()


@pytest.mark.parametrize("ext, history", [("npz", True), ("csv", False)])
@pytest.mark.parametrize("chunk", [None, 97])
def test_duplicated_right_keys_repeat_rows_as_pandas(tmp_path, ext, history,
                                                     chunk):
    """A customer and an article listed twice: every transaction of theirs
    joins twice, in the right table's order, and a user's history groups
    by its id, not by its row (the chunked path's fallback from row codes);
    .csv splits are written a chunk at a time."""
    raw = synthetic(tmp_path, n_transactions=400, n_customers=20,
                    n_articles=30, seed=13)
    for name, key in (("customers", "cust_0000003"),
                      ("articles", "art_000002")):
        lines = Path(raw[name]).read_text().splitlines()
        twin = next(line for line in lines if line.startswith(key))
        Path(raw[name]).write_text("\n".join(lines + [twin]) + "\n")
    jax_settings, port = both_settings(
        tmp_path, raw, port_ext=ext, history_max_len=3 if history else None,
        etl_chunk_rows=chunk, jax_kw={"etl_chunk_rows": None})
    jax_etl_runner(jax_settings)
    etl_runner(port)
    for split in ("train_data_filepath", "test_data_filepath"):
        assert_table_equals_frame(
            load_dataframe(getattr(port, split)),
            jax_load_dataframe(getattr(jax_settings, split)))


@pytest.mark.parametrize("chunk", [None, 50])
def test_a_transactions_file_of_no_rows_gives_empty_splits(tmp_path, chunk):
    """Header only: both splits are empty and keep the join's columns."""
    raw = synthetic(tmp_path, n_transactions=10, seed=14)
    Path(raw["transactions"]).write_text("t_dat,customer_id,article_id\n")
    _, port = both_settings(tmp_path, raw, history_max_len=3,
                            etl_chunk_rows=chunk)
    etl_runner(port)
    for split in (port.train_data_filepath, port.test_data_filepath):
        table = load_dataframe(split)
        assert list(table) == ["t_dat", "customer_id", "article_id",
                               "product_type_name", "colour_group_name",
                               "age", "purchase_history"]
        assert all(len(col) == 0 for col in table.values())


def test_etl_drops_unmatched_rows_as_the_jax_stage(tmp_path):
    """tests/test_etl.py's tiny raw data: u9 has no customer row, so the
    inner join drops its transaction."""
    d = tmp_path / "raw"
    d.mkdir()
    (d / "transactions.csv").write_text(
        "t_dat,customer_id,article_id\n2020-01-01,u1,a1\n2020-01-02,u2,a2\n"
        "2020-02-01,u1,a1\n2020-02-02,u9,a3\n")
    (d / "articles.csv").write_text(
        "article_id,product_type_name\na1,shirt\na2,pants\na3,shirt\n")
    (d / "customers.csv").write_text("customer_id,age\nu1,30.0\nu2,40.0\n")
    raw = {"transactions": str(d / "transactions.csv"),
           "articles": str(d / "articles.csv"),
           "customers": str(d / "customers.csv"),
           "train_start": "2020-01-01", "train_end": "2020-01-31",
           "test_start": "2020-02-01", "test_end": "2020-02-28"}
    jax_settings, port = both_settings(tmp_path, raw)
    jax_etl_runner(jax_settings)
    etl_runner(port)
    train = load_dataframe(port.train_data_filepath)
    test = load_dataframe(port.test_data_filepath)
    assert len(train["t_dat"]) == 2 and len(test["t_dat"]) == 1
    assert list(train) == ["t_dat", "customer_id", "article_id",
                           "product_type_name", "age"]
    assert_table_equals_frame(
        train, jax_load_dataframe(jax_settings.train_data_filepath))


# --- the schema stage ---------------------------------------------------------


@pytest.mark.parametrize("stream", [None, 137, 1])
@pytest.mark.parametrize("history", ["none", "shared", "standalone"])
def test_build_schema_runner_gives_the_jax_schema(tmp_path, history, stream):
    """In memory and streamed: the vocab arrays (ties included), the logQ
    table and the standardization stats of the matching JAX path, bit for
    bit; a standalone history vocab from the tokens of every row's list."""
    raw = synthetic(tmp_path, n_transactions=1500, n_customers=60,
                    n_articles=35, seed=11)
    jax_settings, port = both_settings(
        tmp_path, raw, history_max_len=None if history == "none" else 3,
        schema_stream_rows=stream)
    jax_etl_runner(jax_settings)
    etl_runner(port)
    kw = dict(history=history != "none",
              standalone_history=history == "standalone", standardize=True)
    jax_schema, port_schema = schemas(**kw)
    jax_build_schema_runner(jax_settings, jax_schema)
    build_schema_runner(port, port_schema)
    got, _ = assert_same_schema(port.schema_dirpath,
                                jax_settings.schema_dirpath)
    np.testing.assert_allclose(
        np.exp(got.logq[1:].astype(np.float64)).sum(), 1.0, atol=1e-5)


def test_max_vocab_size_and_logq_from_value_counts():
    """Truncation keeps the most frequent tokens; the logQ table is 0 for
    ids absent from the counts; ``set_candidate_probs`` as in JAX."""
    values = np.array(["b", "a", "c", "a", "b", "d", "c", "e", "b"])
    spec = dict(name="article_id", kind="categorical", family="candidate",
                embedding_size=2, max_vocab_size=3)
    jax_schema = JaxSchema([JaxFeature(**spec)], JaxModelConfig(2, ks=[1]),
                           JaxTrainingConfig())
    port_schema = Schema([Feature(**spec)], ModelConfig(2, ks=[1]),
                         TrainingConfig())
    jax_schema.build_features_from_dataframe(pd.DataFrame({"article_id":
                                                           values}))
    port_schema.build_features_from_dataframe({"article_id": values})
    np.testing.assert_array_equal(port_schema.candidate_id_feature.vocab,
                                  jax_schema.candidate_id_feature.vocab)
    counts = (np.array(["a", "zz", "c"]), np.array([4, 9, 1]))
    jax_schema.build_logq_from_value_counts(
        pd.Series(counts[1], index=counts[0]), 20)
    port_schema.build_logq_from_value_counts(counts, 20)
    np.testing.assert_array_equal(port_schema.logq, jax_schema.logq)
    assert port_schema.logq[1] == 0.0  # "b" is not in the counts
    probs = {"a": 0.25, "b": 0.5, "nope": 0.1}
    jax_schema.set_candidate_probs(probs)
    port_schema.set_candidate_probs(probs)
    np.testing.assert_array_equal(port_schema.logq, jax_schema.logq)


# --- the split formats -----------------------------------------------------------


@pytest.mark.parametrize("history", [False, True])
def test_parquet_splits_read_in_both_packages(tmp_path, history):
    """The port's .parquet split loads in the JAX package as the JAX split
    does, and the JAX split loads in the port as the port's .npz split."""
    raw = synthetic(tmp_path, n_transactions=600, seed=4)
    kw = dict(history_max_len=3 if history else None)
    jax_settings, port_npz = both_settings(tmp_path / "a", raw, **kw)
    _, port_parquet = both_settings(tmp_path / "b", raw, port_ext="parquet",
                                    **kw)
    jax_etl_runner(jax_settings)
    etl_runner(port_npz)
    etl_runner(port_parquet)
    for split in ("train_data_filepath", "test_data_filepath"):
        want = jax_load_dataframe(getattr(jax_settings, split))
        assert_table_equals_frame(
            load_dataframe(getattr(port_npz, split)), want)
        assert_table_equals_frame(
            load_dataframe(getattr(jax_settings, split)), want)
        assert_table_equals_frame(
            load_dataframe(getattr(port_npz, split)),
            jax_load_dataframe(getattr(port_parquet, split)))


def test_table_io_round_trips_every_column_kind(tmp_path):
    """.npz keeps every column; .csv the plain ones, as pd.read_csv reads
    them back; a list column refuses .csv."""
    table = {
        "i": np.array([3, -1, 7], np.int64),
        "f": np.array([1.5, np.nan, 2.0]),
        "b": np.array([True, False, True]),
        "s": np.array(["a", "", "c, d"]),
        "h": ListColumn(np.array([0, 0, 2, 3]), np.array([1, 0, 1], np.int32),
                        np.array(["x", "y"])),
    }
    save_dataframe(table, str(tmp_path / "t.npz"))
    got = load_dataframe(str(tmp_path / "t.npz"))
    assert list(got) == list(table)
    for name in ("i", "f", "b", "s"):
        np.testing.assert_array_equal(got[name], table[name])
    assert got["h"].tolist() == [[], ["y", "x"], ["y"]]
    with pytest.raises(ValueError, match="list columns"):
        save_dataframe(table, str(tmp_path / "t.csv"))
    plain = {k: v for k, v in table.items() if k != "h"}
    save_dataframe(plain, str(tmp_path / "t.csv"))
    assert_table_equals_frame(load_dataframe(str(tmp_path / "t.csv")),
                              pd.read_csv(str(tmp_path / "t.csv")))


# --- the card's condition: no pandas, no pyarrow -----------------------------------


def test_the_three_stages_run_without_pandas_or_pyarrow(tmp_path):
    """A fresh interpreter with ``pandas`` and ``pyarrow`` blocked runs the
    port's ETL (in memory and chunked), schema and shard stages on .npz
    splits, and a .parquet split raises ImportError naming .npz; the shards
    equal the JAX stages' on the same CSVs."""
    from tests.test_torch_shards import assert_same_shards, jax_stage_run

    raw = synthetic(tmp_path, n_transactions=800, seed=9)
    jax_settings, port = both_settings(tmp_path, raw, history_max_len=3,
                                       etl_chunk_rows=150)
    jax_stage_run(jax_settings, history=True)
    port.to_json(str(tmp_path / "port_settings.json"))
    code = f"""
import dataclasses, sys
sys.modules["pandas"] = None
sys.modules["pyarrow"] = None
from hm_retrieval_tpu_torch.runners import (
    build_schema_runner, etl_runner, shard_writer_runner)
from hm_retrieval_tpu_torch.schema import Feature, ModelConfig, Schema, TrainingConfig
from hm_retrieval_tpu_torch.utils import Settings
s = Settings.from_json({str(tmp_path / 'port_settings.json')!r})
etl_runner(s)
schema = Schema([Feature(**f) for f in {feature_specs(history=True)!r}],
                ModelConfig(8, ks=[1, 2]), TrainingConfig())
build_schema_runner(s, schema)
shard_writer_runner(s)
try:
    etl_runner(dataclasses.replace(s, train_data_filepath="x/train.parquet",
                                   etl_chunk_rows=None))
except ImportError as exc:
    print("parquet:", ".npz" in str(exc))
print(sorted(m for m in sys.modules if m.split(".")[0] in ("pandas", "pyarrow")
             and sys.modules[m] is not None))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-3:] == ["parquet: True", "[]", ""]
    assert_same_shards(port, jax_settings)
