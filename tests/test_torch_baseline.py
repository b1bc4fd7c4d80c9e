"""The port's popularity baseline against the JAX package's.

``etl/transformations.py``'s ``load_dataframe`` and ``date_filter`` (numpy,
no pandas) against the JAX functions (pandas) on a CSV with zero-padded
integer ids, a string column and boundary dates; ``StaticIndex``'s
popularity order, OOV drops and artifacts against the JAX ``StaticIndex``;
and ``baseline_modelling_runner`` against the JAX runner on the tiny
pipeline of ``tests/test_torch_runners.py``. Ids and recall dicts are
compared exactly: both sides count the same integers.
"""

import dataclasses
import os

import numpy as np
import pandas as pd
import pytest
import torch

from hm_retrieval_tpu.etl.transformations import (
    date_filter as jax_date_filter,
    load_dataframe as jax_load_dataframe,
)
from hm_retrieval_tpu.indices import load_index as jax_load_index
from hm_retrieval_tpu.indices.static_index import StaticIndex as JaxStaticIndex
from hm_retrieval_tpu.runners import (
    baseline_modelling_runner as jax_baseline_runner,
)
from hm_retrieval_tpu.schema import (
    Feature as JaxFeature,
    ModelConfig as JaxModelConfig,
    Schema as JaxSchema,
    TrainingConfig as JaxTrainingConfig,
)
from hm_retrieval_tpu.utils.settings import Settings as JaxSettings
from hm_retrieval_tpu_torch.etl import date_filter, load_dataframe
from hm_retrieval_tpu_torch.indices import StaticIndex, load_index
from hm_retrieval_tpu_torch.indices.static_index import popularity_order
from hm_retrieval_tpu_torch.runners import baseline_modelling_runner
from hm_retrieval_tpu_torch.schema import (
    Feature,
    ModelConfig,
    Schema,
    TrainingConfig,
)
from tests.test_torch_runners import jax_stages  # noqa: F401 (module fixture)

TIES = ["b", "a", "c", "a", "b", "d", "c", "e"]

CSV = (
    "t_dat,article_id,name,count\n"
    "2020-09-01,0108775015,a,1\n"
    "2020-09-02,0108775044, b ,2\n"
    "2020-09-02,0108775015,c,+3\n"
    "2020-09-03,0110065001,d,-4\n"
    "2020-09-04,0108775044,e,5\n"
    "2020-09-05,0110065001,f,6\n"
)


@pytest.fixture()
def csv_path(tmp_path):
    path = tmp_path / "transactions.csv"
    path.write_text(CSV)
    return str(path)


def _same_columns(port, df):
    assert list(port) == list(df.columns)
    for name in df.columns:
        want = df[name].to_numpy()
        if want.dtype.kind in "iu":
            assert port[name].dtype == np.int64, name
            np.testing.assert_array_equal(port[name], want)
        else:
            assert port[name].tolist() == [str(v) for v in want], name


@pytest.mark.parametrize("columns", [None, ["t_dat", "article_id"],
                                     ["article_id", "name", "count"]])
def test_load_dataframe_types_match_pandas(csv_path, columns):
    """Integer columns read as int64 (the zero-padded ids lose their zeros,
    trap j) and every other column as its strings, as pd.read_csv reads
    them."""
    port = load_dataframe(csv_path, columns=columns)
    df = jax_load_dataframe(csv_path, columns=columns)
    if columns is not None:
        df = df[columns]
    _same_columns(port, df)
    assert port["article_id"][0] == 108775015


def test_load_dataframe_reads_parquet(tmp_path):
    df = pd.DataFrame({"t_dat": ["2020-09-01", "2020-09-02"],
                       "article_id": np.array([5, 7], np.int64)})
    path = str(tmp_path / "t.parquet")
    df.to_parquet(path)
    port = load_dataframe(path, columns=["article_id", "t_dat"])
    _same_columns(port, jax_load_dataframe(path,
                                           columns=["article_id", "t_dat"]))


@pytest.mark.parametrize("start, end", [
    ("2020-09-02", "2020-09-04"),  # both ends on rows
    ("2020-09-01", "2020-09-01"),  # one day
    ("2020-08-01", "2020-09-01"),  # ends on the first row
    ("2020-09-06", "2020-10-01"),  # no row
])
def test_date_filter_matches_pandas(csv_path, start, end):
    """Inclusive at both ends, comparing the column as read."""
    port = date_filter(load_dataframe(csv_path), "t_dat", start, end)
    df = jax_date_filter(jax_load_dataframe(csv_path), "t_dat", start, end)
    _same_columns(port, df)


@pytest.mark.parametrize("body, pandas_kind", [
    ("x,y\n1.5,a\n2,b\n", "f"),  # a float column
    ("x,y\n1,a\n,b\n3,c\n", "f"),  # an empty value in integers: NaN
    ("x,y\na,a\n,b\n", None),  # an empty value among strings: NaN
    ("x,y\nTrue,a\nFalse,b\n", "b"),
    ("x,y\n1,a\nNA,b\n", "f"),  # pandas' NA strings (trap l)
    ("x,y\na,a\nnull,b\nnan,c\n", None),
    ("x,y\nN/A,a\n#N/A,b\n", "f"),  # every value missing
])
def test_columns_read_as_pd_read_csv_reads_them(tmp_path, body, pandas_kind):
    """Float, bool and missing values read as pandas reads them: float64
    with NaN, bool, and a missing string as "" where pandas gives NaN."""
    path = tmp_path / "t.csv"
    path.write_text(body)
    df = pd.read_csv(str(path))
    if pandas_kind is not None:
        assert df["x"].dtype.kind == pandas_kind
    else:
        assert df["x"].isna().any() and df["x"].dtype.kind != "f"
    port = load_dataframe(str(path))
    assert list(port) == ["x", "y"]
    want = df["x"].to_numpy()
    if pandas_kind in ("f", "b"):
        assert port["x"].dtype.kind == pandas_kind
        np.testing.assert_array_equal(port["x"], want)
    else:
        assert port["x"].tolist() == ["" if pd.isna(v) else v for v in want]
    _same_columns(load_dataframe(str(path), columns=["y"]), df[["y"]])


def test_blank_lines_are_skipped_as_pandas_skips_them(tmp_path):
    path = tmp_path / "blank.csv"
    path.write_text("x,y\n1,a\n\n3,c\n")
    _same_columns(load_dataframe(str(path)), pd.read_csv(str(path)))


def _schemas(vocab):
    """The same two-feature schema in both packages, articles ``vocab``."""
    specs = [
        dict(name="customer_id", kind="categorical", family="query",
             embedding_size=4, vocab=np.array(["c1", "c2"])),
        dict(name="article_id", kind="categorical", family="candidate",
             embedding_size=4, vocab=np.asarray(vocab)),
    ]
    jax_schema = JaxSchema(
        features=[JaxFeature(**s) for s in specs],
        model_config=JaxModelConfig(joint_embedding_size=4, ks=[2]),
        training_config=JaxTrainingConfig(),
    )
    port_schema = Schema(
        features=[Feature(**s) for s in specs],
        model_config=ModelConfig(joint_embedding_size=4, ks=[2]),
        training_config=TrainingConfig(),
    )
    return jax_schema, port_schema


def test_popularity_ties_follow_first_appearance():
    """pandas 3 gives b, a, c, d, e (trap j); np.unique alone would give
    the ties in value order."""
    want = pd.Series(TIES).astype(str).value_counts().index.tolist()
    assert want == ["b", "a", "c", "d", "e"]
    assert popularity_order(np.array(TIES)).tolist() == want


@pytest.mark.parametrize("k", [3, 5, 8])
def test_popularity_index_equals_jax_with_oov_drops(k):
    """'c' and 'e' are out of the vocab: both packages take the top k first,
    then drop the OOV ids, so the index can hold fewer than k."""
    jax_schema, port_schema = _schemas(["a", "b", "d"])
    want = JaxStaticIndex.build_popularity_index_from_series(
        pd.Series(TIES), jax_schema, k
    ).identifiers
    got = StaticIndex.build_popularity_index_from_series(
        np.array(TIES), port_schema, k, device="cpu"
    )
    np.testing.assert_array_equal(got.identifiers.numpy(), want)
    assert got.k == len(want) < k


def test_popularity_index_on_the_pipelines_transactions(jax_stages):  # noqa: F811
    """The train range of the pipeline's transactions, plus an unknown
    article bought more often than any other, through both packages."""
    settings = jax_stages
    jax_schema = JaxSchema.load(settings.schema_dirpath)
    port_schema = Schema.load(settings.schema_dirpath)
    df = jax_date_filter(
        jax_load_dataframe(settings.transactions_filepath,
                           columns=["t_dat", "article_id"]),
        "t_dat", settings.train_start_date, settings.train_end_date,
    )
    table = date_filter(
        load_dataframe(settings.transactions_filepath,
                       columns=["t_dat", "article_id"]),
        "t_dat", settings.train_start_date, settings.train_end_date,
    )
    _same_columns(table, df)
    values = list(df["article_id"]) + ["art_unknown"] * 1000
    want = JaxStaticIndex.build_popularity_index_from_series(
        pd.Series(values), jax_schema, 50
    ).identifiers
    got = StaticIndex.build_popularity_index_from_series(
        np.array(values), port_schema, 50, device="cpu"
    )
    assert len(want) == 49  # the unknown article was dropped
    np.testing.assert_array_equal(got.identifiers.numpy(), want)


def test_baseline_runner_equals_jax(jax_stages, tmp_path):  # noqa: F811
    settings = dataclasses.replace(
        jax_stages, baseline_index_dirpath=str(tmp_path / "port"))
    jax_settings = JaxSettings.from_json(
        os.path.join(os.path.dirname(settings.schema_dirpath),
                     "settings.json"))
    jax_settings.baseline_index_dirpath = str(tmp_path / "jax")
    want = jax_baseline_runner(jax_settings)
    got = baseline_modelling_runner(settings, device="cpu")
    assert got == want
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "identifiers.npy"),
        np.load(tmp_path / "jax" / "identifiers.npy"),
    )


def test_static_artifacts_load_in_both_packages(tmp_path):
    ids = np.array([9, 4, 17, 2, 30], np.int32)
    JaxStaticIndex(ids).save(str(tmp_path / "jax"))
    StaticIndex(ids, device="cpu").save(str(tmp_path / "port"))
    port = load_index(str(tmp_path / "jax"), device="cpu")
    assert isinstance(port, StaticIndex)
    np.testing.assert_array_equal(port.query(3, k=4).numpy(),
                                  np.tile(ids[:4], (3, 1)))
    jax_side = jax_load_index(str(tmp_path / "port"))
    assert isinstance(jax_side, JaxStaticIndex)
    np.testing.assert_array_equal(jax_side.identifiers, ids)
    np.testing.assert_array_equal(jax_side.query(2), port.query(2).numpy())


def test_static_index_validation_and_device():
    idx = StaticIndex([3, 1, 2], device="cpu")
    assert idx.k == 3 and idx.identifiers.dtype == torch.int32
    assert tuple(idx.query(4).shape) == (4, 3)
    with pytest.raises(ValueError, match="exceeds index size"):
        idx.query(2, k=4)
    with pytest.raises(ValueError, match="non-empty"):
        StaticIndex([], device="cpu")


def test_baseline_raises_without_a_card(jax_stages, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        baseline_modelling_runner(jax_stages)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StaticIndex([1, 2])
