"""The port's shard reader and device feed (hm_retrieval_tpu_torch/data)
against the JAX package's.

The reader is a copy, so for the same shards and seed its batches must equal
the JAX reader's bit for bit. The feed runs here on the CPU (``device=
"cpu"``); with ``device=None`` it is the card's, and raises without one.
"""

import json
import logging
import os

import numpy as np
import pandas as pd
import pytest
import torch

from hm_retrieval_tpu.data.dataset import ShardDataset as JaxShardDataset
from hm_retrieval_tpu.data.device_feed import (
    chunk_batches as jax_chunk_batches,
)
from hm_retrieval_tpu.data.shard_writer import MANIFEST_NAME as JAX_MANIFEST
from hm_retrieval_tpu.data.shard_writer import ShardWriter
from hm_retrieval_tpu.schema import Feature as JaxFeature
from hm_retrieval_tpu_torch.data import (
    MANIFEST_NAME,
    ShardDataset,
    chunk_batches,
    device_feed,
    device_feed_chunked,
    make_chunked_train_step,
)
from hm_retrieval_tpu_torch.data.device_feed import _prefetch_host
from hm_retrieval_tpu_torch.models import (
    OptimizerFactory,
    TwoTowerModel,
    create_train_state,
    make_train_step,
    train_state_from_numpy,
    train_state_to_numpy,
)
from hm_retrieval_tpu_torch.models.mixed_negatives import CandidateCatalog
from hm_retrieval_tpu_torch.models.sparse_optimizer import (
    create_sparse_train_state,
    make_sparse_train_step,
)
from hm_retrieval_tpu_torch.schema.features import Feature

N_ROWS, MAX_ROWS = 103, 10  # 11 shards, the last short


def write_shards(dirpath, columns, max_rows):
    """``shard_*.npz`` plus the manifest, as ``ShardWriter`` lays them out."""
    os.makedirs(dirpath, exist_ok=True)
    n = len(next(iter(columns.values())))
    starts = range(0, max(n, 1), max_rows)
    for s, lo in enumerate(starts):
        np.savez(os.path.join(dirpath, f"shard_{s:05d}.npz"),
                 **{k: v[lo:lo + max_rows] for k, v in columns.items()})
    manifest = {
        "num_rows": n, "num_shards": len(starts), "max_rows": max_rows,
        "features": {k: str(v.dtype) for k, v in columns.items()},
    }
    with open(os.path.join(dirpath, MANIFEST_NAME), "w") as fp:
        json.dump(manifest, fp)


def _columns(rng, n=N_ROWS):
    return {
        "customer_id": rng.integers(0, 60, n).astype(np.int32),
        "age": rng.normal(size=n).astype(np.float32),
        "purchase_history": rng.integers(0, 41, (n, 5)).astype(np.int32),
        "article_id": np.arange(n, dtype=np.int32) % 40 + 1,
        "colour": rng.integers(0, 7, n).astype(np.int32),
    }


@pytest.fixture
def shards(tmp_path, rng):
    write_shards(str(tmp_path / "train"), _columns(rng), MAX_ROWS)
    return str(tmp_path / "train")


def _assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_manifest_name_is_the_jax_packages():
    assert MANIFEST_NAME == JAX_MANIFEST


@pytest.mark.parametrize("threads", [0, 2])
@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("shuffle", [0, 25, 1000])
@pytest.mark.parametrize("batch_size", [8, 16])
def test_iter_batches_bit_identical_to_jax(shards, batch_size, shuffle,
                                           drop_remainder, threads):
    kw = dict(shuffle_buffer_size=shuffle, seed=7,
              drop_remainder=drop_remainder, num_reader_threads=threads)
    got = ShardDataset(shards).iter_batches(batch_size, **kw)
    want = JaxShardDataset(shards).iter_batches(batch_size, **kw)
    _assert_streams_equal(got, want)


def test_drop_remainder_drops_only_the_short_batch(shards):
    full = list(ShardDataset(shards).iter_batches(16))
    dropped = list(ShardDataset(shards).iter_batches(16, drop_remainder=True))
    assert [len(b["age"]) for b in full] == [16] * 6 + [7]
    assert len(dropped) == 6


@pytest.mark.parametrize("process_count", [1, 2, 3])
def test_load_all_and_local_num_rows_match_jax(shards, process_count):
    for pi in range(process_count):
        got = ShardDataset(shards, process_index=pi,
                           process_count=process_count)
        want = JaxShardDataset(shards, process_index=pi,
                               process_count=process_count)
        assert got.local_num_rows == want.local_num_rows
        assert got.num_rows == want.num_rows == N_ROWS
        a, b = got.load_all(), want.load_all()
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
            assert len(a[k]) == got.local_num_rows


def test_reads_what_the_jax_shard_writer_writes(tmp_path):
    features = [
        JaxFeature("uid", "categorical", "query", embedding_size=2,
                   vocab=np.array(["u1", "u2", "u3"])),
        JaxFeature("age", "numeric", "query"),
    ]
    df = pd.DataFrame({"uid": [f"u{(i % 4) + 1}" for i in range(23)],
                       "age": np.arange(23, dtype=np.float64)})
    ShardWriter(features, max_rows=4).write_shards(df, str(tmp_path))
    _assert_streams_equal(
        ShardDataset(str(tmp_path)).iter_batches(5, 8, seed=1),
        JaxShardDataset(str(tmp_path)).iter_batches(5, 8, seed=1))
    assert ShardDataset(str(tmp_path)).local_num_rows == 23


def test_reader_errors_match_jax(tmp_path, shards):
    with pytest.raises(FileNotFoundError):
        ShardDataset(str(tmp_path / "nothing"))
    with pytest.raises(ValueError):
        ShardDataset(shards, process_index=2, process_count=2)
    with pytest.raises(ValueError, match="no shards"):
        ShardDataset(shards, process_index=11, process_count=12)


# --- chunking (trap i) ------------------------------------------------------
@pytest.mark.parametrize("n_batches,k", [(7, 3), (6, 3), (2, 3), (5, 1)])
def test_chunk_batches_drops_the_ragged_tail_as_jax(rng, caplog, n_batches,
                                                    k):
    batches = [{"a": rng.integers(0, 9, 4).astype(np.int32),
                "h": rng.integers(0, 9, (4, 3)).astype(np.int32)}
               for _ in range(n_batches)]
    with caplog.at_level(logging.WARNING):
        got = list(chunk_batches(iter(batches), k))
    want = list(jax_chunk_batches(iter(batches), k))
    _assert_streams_equal(got, want)
    assert len(got) == n_batches // k
    for g in got:
        assert g["a"].shape == (k, 4) and g["h"].shape == (k, 4, 3)
    tail = n_batches % k
    warned = [r.getMessage() for r in caplog.records
              if "ragged tail" in r.getMessage()]
    assert bool(warned) == bool(tail)
    if tail:
        assert f"ragged tail of {tail} batch(es)" in warned[0]
    with pytest.raises(ValueError):
        list(chunk_batches(iter(batches), 0))


# --- the feed ---------------------------------------------------------------
def test_device_feed_on_the_cpu_yields_the_batches(shards):
    want = list(ShardDataset(shards).iter_batches(16, 25, seed=3))
    got = list(device_feed(ShardDataset(shards).iter_batches(16, 25, seed=3),
                           device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_device_feed_chunked_stacks_k_batches(shards):
    batches = list(ShardDataset(shards).iter_batches(8, drop_remainder=True))
    got = list(device_feed_chunked(iter(batches), 4, device="cpu"))
    assert len(got) == len(batches) // 4
    for i, c in enumerate(got):
        for k in batches[0]:
            assert c[k].shape[0] == 4
            for j in range(4):
                np.testing.assert_array_equal(c[k][j].numpy(),
                                              batches[4 * i + j][k])


@pytest.mark.parametrize("prefetch", [0, 1, 3])
def test_prefetch_keeps_order_and_raises_the_workers_error(prefetch):
    assert list(_prefetch_host(iter(range(10)), prefetch)) == list(range(10))

    def broken():
        yield 1
        raise OSError("shard unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(_prefetch_host(broken(), prefetch))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _features():
    vocab = np.array([f"a{i}" for i in range(40)])
    query = [
        Feature("customer_id", "categorical", "query", embedding_size=8,
                vocab=np.array([f"c{i}" for i in range(60)])),
        Feature("age", "numeric", "query"),
        Feature("purchase_history", "sequence", "query", embedding_size=8,
                vocab=vocab, max_len=5, pooling="mean"),
    ]
    candidate = [
        Feature("article_id", "categorical", "candidate", embedding_size=8,
                vocab=vocab),
        Feature("colour", "categorical", "candidate", embedding_size=4,
                vocab=np.array([f"k{i}" for i in range(6)])),
    ]
    return query, candidate


def _model(device="cpu"):
    query, candidate = _features()
    logq = np.zeros(41, np.float32)
    logq[1:] = np.log(np.linspace(0.3, 0.01, 40))
    return TwoTowerModel(query, candidate, "article_id", 16, [24], [24],
                         logq=logq, device=device)


def test_training_entry_points_raise_without_a_card(no_card, shards):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_feed(iter([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_feed_chunked(iter([]), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _model(device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CandidateCatalog({"article_id": np.arange(5)})
    # device="cpu" runs
    model = _model()
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": 0.05})
    state, step = create_train_state(model, opt), make_train_step(model, opt)
    batch = next(device_feed(ShardDataset(shards).iter_batches(8),
                             device="cpu"))
    state, metrics = step(state, batch)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("sparse", [False, True])
def test_chunked_step_equals_k_single_steps(shards, sparse):
    k = 4
    model = _model()
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": 0.05})
    if sparse:
        state = create_sparse_train_state(model, opt, seed=2)
        step = make_sparse_train_step(model, opt, 0.05)
    else:
        state = create_train_state(model, opt, seed=2)
        step = make_train_step(model, opt)
    start = train_state_to_numpy(state)
    batches = list(ShardDataset(shards).iter_batches(
        8, 25, seed=1, drop_remainder=True))[: 2 * k]

    single = []
    for b in device_feed(iter(batches), device="cpu"):
        state, m = step(state, b)
        single.append(float(m["loss"]))
    after_single = train_state_to_numpy(state)

    state = train_state_from_numpy(state, start)
    chunk_step = make_chunked_train_step(step)
    chunked = []
    for c in device_feed_chunked(iter(batches), k, device="cpu"):
        state, m = chunk_step(state, c)
        assert m["losses"].shape == (k,)
        assert float(m["loss"]) == float(m["losses"][-1])
        np.testing.assert_allclose(float(m["loss_mean"]),
                                   float(m["losses"].mean()))
        chunked.extend(m["losses"].tolist())
    assert chunked == single  # the same steps, bit for bit
    after_chunked = train_state_to_numpy(state)
    assert after_chunked["step"] == after_single["step"] == 2 * k
    for name in ("params",):
        for tower in after_single[name]:
            for key, table in after_single[name][tower]["embeddings"].items():
                np.testing.assert_array_equal(
                    after_chunked[name][tower]["embeddings"][key], table)


def test_training_from_shards_lowers_the_loss(tmp_path):
    """Shards -> feed -> sparse step on a learnable stream (the article
    follows the customer): the loss falls."""
    rng = np.random.default_rng(0)
    n = 2048
    cols = _columns(rng, n)
    cols["article_id"] = (cols["customer_id"] % 40 + 1).astype(np.int32)
    write_shards(str(tmp_path / "s"), cols, 256)
    model = _model()
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": 0.05})
    state = create_sparse_train_state(model, opt, seed=0)
    step = make_sparse_train_step(model, opt, 0.05)
    losses = []
    for epoch in range(3):
        for b in device_feed(ShardDataset(str(tmp_path / "s")).iter_batches(
                64, 512, seed=epoch, drop_remainder=True), device="cpu"):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-8:]) < 0.9 * np.mean(losses[:8])
