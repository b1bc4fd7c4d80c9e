"""The port's shard writer and shard stage against the JAX package's.

The same CSVs go through the JAX ETL, schema and shard stages and through
the port's; every shard file name, every npz array (dtype, shape and
values) and every manifest must be the JAX stages', in memory and streamed,
with and without the history column, and with an empty test split.
``ShardWriter`` is also held against the JAX writer on small tables
(tests/test_data.py's cases), and ``encode_sequence_ids`` against the JAX
feature's.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from hm_retrieval_tpu.data.shard_writer import ShardWriter as JaxShardWriter
from hm_retrieval_tpu.runners import (
    build_schema_runner as jax_build_schema_runner,
    etl_runner as jax_etl_runner,
    shard_writer_runner as jax_shard_writer_runner,
)
from hm_retrieval_tpu.schema import Feature as JaxFeature
from hm_retrieval_tpu_torch.data import ShardDataset, ShardWriter
from hm_retrieval_tpu_torch.data.runner import iter_table_batches
from hm_retrieval_tpu_torch.etl.transformations import (
    ListColumn,
    load_dataframe,
)
from hm_retrieval_tpu_torch.runners import (
    build_schema_runner,
    etl_runner,
    shard_writer_runner,
)
from hm_retrieval_tpu_torch.schema import Feature
from tests.test_torch_etl import (
    assert_same_schema,
    both_settings,
    schemas,
    synthetic,
)

SPLIT_DIRS = ("train_shards_dirpath", "test_shards_dirpath",
              "candidate_shards_dirpath")


def jax_stage_run(settings, history=False):
    schema, _ = schemas(history=history)
    jax_etl_runner(settings)
    jax_build_schema_runner(settings, schema)
    jax_shard_writer_runner(settings)


def port_stage_run(settings, history=False):
    _, schema = schemas(history=history)
    etl_runner(settings)
    build_schema_runner(settings, schema)
    shard_writer_runner(settings)


def assert_same_shards(port, jax_settings):
    """Same files; every npz array bit-equal with its dtype and shape; the
    manifests equal."""
    for attr in SPLIT_DIRS:
        a_dir, b_dir = getattr(port, attr), getattr(jax_settings, attr)
        files = sorted(os.listdir(a_dir))
        assert files == sorted(os.listdir(b_dir)), attr
        for name in files:
            a_path, b_path = os.path.join(a_dir, name), os.path.join(b_dir, name)
            if name.endswith(".json"):
                with open(a_path) as fa, open(b_path) as fb:
                    assert json.load(fa) == json.load(fb), (attr, name)
                continue
            with np.load(a_path) as a, np.load(b_path) as b:
                assert sorted(a.files) == sorted(b.files), (attr, name)
                for key in a.files:
                    assert a[key].dtype == b[key].dtype, (attr, name, key)
                    assert a[key].shape == b[key].shape, (attr, name, key)
                    np.testing.assert_array_equal(
                        a[key], b[key], err_msg=f"{attr}/{name}/{key}")


@pytest.mark.parametrize("stream", [None, 170, 50],
                         ids=["memory", "stream170", "stream50"])
@pytest.mark.parametrize("history", [False, True],
                         ids=["no_history", "history"])
def test_shard_stage_writes_the_jax_stages_shards(tmp_path, history, stream):
    """The whole front of the pipeline on the same CSVs: the shards of the
    port's in-memory or streamed shard stage (batches of 170 and 50 rows,
    neither a multiple of the 150-row shards) equal the JAX in-memory
    stages' bit for bit."""
    raw = synthetic(tmp_path)
    jax_settings, port = both_settings(
        tmp_path, raw, history_max_len=3 if history else None,
        shard_stream_rows=stream, jax_kw={"shard_stream_rows": None})
    jax_stage_run(jax_settings, history)
    port_stage_run(port, history)
    assert_same_shards(port, jax_settings)
    assert_same_schema(port.schema_dirpath, jax_settings.schema_dirpath)


@pytest.mark.parametrize("streamed", [False, True])
def test_streamed_front_equals_the_jax_streamed_front(tmp_path, streamed):
    """Chunked ETL, streamed schema and streamed shards in both packages
    (the JAX package's streaming flags against the port's), history on."""
    raw = synthetic(tmp_path, n_transactions=1000, seed=8)
    kw = dict(etl_chunk_rows=130, schema_stream_rows=137,
              shard_stream_rows=170) if streamed else {}
    jax_settings, port = both_settings(tmp_path, raw, history_max_len=3,
                                       **kw)
    jax_stage_run(jax_settings, history=True)
    port_stage_run(port, history=True)
    assert_same_shards(port, jax_settings)


@pytest.mark.parametrize("stream", [None, 64])
def test_an_empty_test_split_writes_one_empty_shard(tmp_path, stream):
    """A test range with no transactions: one empty shard with the
    features' dtypes and shapes, and a manifest of 0 rows, as in JAX."""
    raw = synthetic(tmp_path, n_transactions=500, seed=6)
    raw = dict(raw, test_start="2021-01-01", test_end="2021-01-31")
    jax_settings, port = both_settings(tmp_path, raw, history_max_len=3,
                                       shard_stream_rows=stream)
    jax_stage_run(jax_settings, history=True)
    port_stage_run(port, history=True)
    assert_same_shards(port, jax_settings)
    assert ShardDataset(port.test_shards_dirpath).num_rows == 0
    with np.load(os.path.join(port.test_shards_dirpath,
                              "shard_00000.npz")) as z:
        assert z["purchase_history"].shape == (0, 3)


@pytest.mark.parametrize("ext", ["npz", "parquet", "csv"])
def test_table_batches_cover_the_split_in_order(tmp_path, ext):
    """``iter_table_batches`` over each format gives the split's rows in
    order, a batch at a time; a list column's windows survive the cut."""
    raw = synthetic(tmp_path, n_transactions=400, seed=12)
    _, port = both_settings(tmp_path, raw, port_ext=ext,
                            history_max_len=None if ext == "csv" else 3)
    etl_runner(port)
    whole = load_dataframe(port.train_data_filepath)
    columns = [c for c in whole if c != "age"]
    got = {c: [] for c in columns}
    n = 0
    for batch in iter_table_batches(port.train_data_filepath, columns, 37):
        assert list(batch) == columns
        m = len(batch["t_dat"])
        assert m <= 37
        n += m
        for c in columns:
            got[c] += (batch[c].tolist())
    assert n == len(whole["t_dat"])
    for c in columns:
        assert got[c] == whole[c].tolist(), c


# --- ShardWriter on small tables (tests/test_data.py's cases) ----------------------


def _features(package):
    F = JaxFeature if package == "jax" else Feature
    return [
        F("uid", "categorical", "query", embedding_size=2,
          vocab=np.array(["u1", "u2", "u3"])),
        F("age", "numeric", "query"),
        F("hist", "sequence", "query", embedding_size=2, max_len=3,
          vocab=np.array(["u1", "u2", "u3"])),
    ]


@pytest.mark.parametrize("n, max_rows", [(10, 4), (8, 4), (3, 100), (0, 4)])
def test_shard_writer_equals_the_jax_writer(tmp_path, n, max_rows):
    """Boundaries (4 + 4 + 2), OOV ids (u4 -> 0), float32 ages, the windows
    of a list column, and zero rows' one empty shard."""
    uid = np.array([f"u{(i % 4) + 1}" for i in range(n)])
    age = np.arange(n, dtype=np.float64)
    lists = [[f"u{(i + j) % 5}" for j in range(i % 5)] for i in range(n)]
    lens = np.array([len(x) for x in lists], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    tokens = np.array(["u0", "u1", "u2", "u3", "u4"])
    codes = np.array([int(t[1]) for x in lists for t in x], np.int32)
    table = {"uid": uid, "age": age,
             "hist": ListColumn(offsets, codes, tokens)}
    df = pd.DataFrame({"uid": uid, "age": age,
                       "hist": pd.Series(lists, dtype=object)})
    got = ShardWriter(_features("port"), max_rows=max_rows).write_shards(
        table, str(tmp_path / "port"))
    want = JaxShardWriter(_features("jax"), max_rows=max_rows).write_shards(
        df, str(tmp_path / "jax"))
    assert got == want
    for name in sorted(os.listdir(tmp_path / "jax")):
        if name.endswith(".npz"):
            with np.load(tmp_path / "port" / name) as a, \
                    np.load(tmp_path / "jax" / name) as b:
                for key in b.files:
                    assert a[key].dtype == b[key].dtype, key
                    np.testing.assert_array_equal(a[key], b[key])
    assert ShardWriter.encode_dataframe is ShardWriter.encode_table
    with pytest.raises(ValueError, match="max_rows"):
        ShardWriter(_features("port"), max_rows=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_sequence_ids_equals_the_jax_features(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 7, 50)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    flat = rng.integers(0, 9, int(lens.sum())).astype(np.int32)
    spec = dict(name="h", kind="sequence", family="query", embedding_size=2,
                max_len=4, vocab=np.array(["a", "b"]))
    np.testing.assert_array_equal(
        Feature(**spec).encode_sequence_ids(flat, offsets),
        JaxFeature(**spec).encode_sequence_ids(flat, offsets))
