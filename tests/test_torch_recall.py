"""The port's streaming Recall@K against the JAX package's ``IndexRecall``.

Every case feeds the same numpy-seeded ids to both metrics; the results are
ratios of integer counts and must be exactly equal. The golden values are
``tests/test_recall.py``'s (ref: tests/test_recall.py:8-95).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hm_retrieval_tpu.indices.static_index import StaticIndex
from hm_retrieval_tpu.metrics.index_recall import IndexRecall as JaxRecall

from hm_retrieval_tpu_torch.metrics import IndexRecall

ROOT = Path(__file__).resolve().parent.parent


def _both(ks):
    return IndexRecall(ks), JaxRecall(ks)


def _update(metrics, retrieved, true_ids, **kw):
    port, jax_metric = metrics
    port.update(torch.as_tensor(retrieved), torch.as_tensor(true_ids), **kw)
    jax_metric.update(retrieved, true_ids, **kw)


def _results(metrics):
    port, jax_metric = metrics
    got, want = port.results(), jax_metric.results()
    assert got == want
    assert port.seen == jax_metric.seen
    np.testing.assert_array_equal(port.hits, jax_metric.hits)
    return got


def test_reference_golden_values():
    index = StaticIndex(np.arange(1, 11, dtype=np.int32))
    metrics = _both([1, 2, 5])
    for t in (np.array([1, 2, 20], np.int32), np.array([2, 30], np.int32)):
        _update(metrics, np.asarray(index.query(batch_size=len(t), k=5)), t)
    assert _results(metrics) == {1: 1 / 5, 2: 3 / 5, 5: 3 / 5}


def test_streaming_equals_a_single_batch(rng):
    retrieved = rng.integers(0, 50, size=(10, 8)).astype(np.int32)
    true_ids = rng.integers(0, 50, size=10).astype(np.int32)
    whole = _both([1, 4, 8])
    _update(whole, retrieved, true_ids)
    parts = _both([1, 4, 8])
    for lo, hi in ((0, 3), (3, 7), (7, 10)):
        _update(parts, retrieved[lo:hi], true_ids[lo:hi])
    assert _results(whole) == _results(parts)


def test_duplicate_retrieved_ids_count_once():
    metrics = _both([2])
    _update(metrics, np.array([[7, 7]], np.int32), np.array([7], np.int32))
    assert _results(metrics) == {2: 1.0}


def test_num_valid_counts_the_leading_rows(rng):
    retrieved = rng.integers(0, 20, size=(12, 5)).astype(np.int32)
    true_ids = retrieved[:, 2].copy()  # every row hits at K >= 3
    metrics = _both([1, 3, 5])
    _update(metrics, retrieved, true_ids, num_valid=7)
    res = _results(metrics)
    assert metrics[0].seen == 7 and res[3] == 1.0


def test_interleaved_valid_mask(rng):
    retrieved = rng.integers(0, 30, size=(16, 6)).astype(np.int32)
    true_ids = rng.integers(0, 30, size=16).astype(np.int32)
    mask = rng.random(16) < 0.5
    metrics = _both([1, 6])
    _update(metrics, retrieved, true_ids, valid_mask=mask)
    _results(metrics)
    assert metrics[0].seen == int(mask.sum())


def test_both_masks_raise():
    for metric in _both([1]):
        with pytest.raises(ValueError, match="not both"):
            metric.update(np.zeros((2, 1), np.int32), np.zeros(2, np.int32),
                          num_valid=1, valid_mask=np.ones(2, bool))


def test_narrower_than_max_k_raises():
    for metric in _both([1, 5]):
        with pytest.raises(ValueError, match="max k"):
            metric.update(np.zeros((2, 4), np.int32), np.zeros(2, np.int32))


def test_empty_results_and_reset():
    metrics = _both([3])
    assert _results(metrics) == {3: 0.0}
    _update(metrics, np.array([[1, 2, 3]], np.int32), np.array([3], np.int32))
    assert _results(metrics) == {3: 1.0}
    for metric in metrics:
        metric.reset()
    assert _results(metrics) == {3: 0.0}
    assert metrics[0].seen == 0


@pytest.mark.parametrize("retrieved_dtype, true_dtype",
                         [(np.int32, np.int64), (np.int64, np.int32),
                          (np.int64, np.int64)])
def test_int32_and_int64_ids_compare_equal(rng, retrieved_dtype, true_dtype):
    """The indices return int32 ids; shards may hold int64 ones."""
    retrieved = rng.integers(0, 40, size=(9, 4)).astype(retrieved_dtype)
    true_ids = rng.integers(0, 40, size=9).astype(true_dtype)
    true_ids[:3] = retrieved[:3, 0]
    metrics = _both([1, 4])
    _update(metrics, retrieved, true_ids)
    assert _results(metrics)[1] >= 3 / 9


def test_log_metric_writes_each_k():
    class Writer:
        def __init__(self):
            self.calls = []

        def add_scalar(self, tag, value, step):
            self.calls.append((tag, value, step))

    metric = IndexRecall([1, 2])
    metric.update(np.array([[4, 5]], np.int32), np.array([5], np.int32))
    writer = Writer()
    assert metric.log_metric(3, writer) == {1: 0.0, 2: 1.0}
    assert writer.calls == [("recall_at_1", 0.0, 3), ("recall_at_2", 1.0, 3)]
    metric.log_metric(None, writer)  # no epoch: logged, not written
    assert len(writer.calls) == 2


def test_cross_process_sums_over_a_gloo_group(tmp_path):
    """Two processes of one gloo group, each with its own hits: with
    ``cross_process`` both see the summed totals, without it their own."""
    code = """
import json, sys
import numpy as np, torch
import torch.distributed as dist
from hm_retrieval_tpu_torch.metrics import IndexRecall
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method=sys.argv[2], rank=rank,
                        world_size=2)
out = {}
for cross in (True, False):
    m = IndexRecall([1, 2], cross_process=cross)
    retrieved = np.array([[1, 2], [3, 4]], np.int32)
    true_ids = np.array([1, 4], np.int32) if rank == 0 else np.array(
        [2, 9], np.int32)
    m.update(retrieved, true_ids, num_valid=2 if rank == 0 else 1)
    out[str(cross)] = {str(k): v for k, v in m.results().items()}
dist.destroy_process_group()
print(json.dumps(out))
"""
    init = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(r), init],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=str(ROOT), env=env)
        for r in range(2)
    ]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    # rank 0: hits@1 = 1, hits@2 = 2 of 2 rows; rank 1: 0, 1 of 1 row
    for out in outs:
        assert out["True"] == {"1": 1 / 3, "2": 1.0}
    assert outs[0]["False"] == {"1": 0.5, "2": 1.0}
    assert outs[1]["False"] == {"1": 0.0, "2": 1.0}


def test_counting_runs_on_the_ids_device():
    """The hits are counted where the retrieved ids live: on the 'meta'
    device, standing in for the card, nothing can be pulled to the host."""
    metric = IndexRecall([1])
    with pytest.raises(NotImplementedError):
        metric.update(torch.zeros((2, 1), dtype=torch.int32, device="meta"),
                      torch.zeros(2, dtype=torch.int32))
