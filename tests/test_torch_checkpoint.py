"""The port's train-state checkpoints, profiler window and metric writer.

``CheckpointManager`` writes one npz of ``train_state_to_numpy`` (the JAX
layout) a step; every restore must be bit for bit. The profiler and writer
hold the JAX package's contracts (``utils/profiling.py``,
``utils/summary.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from hm_retrieval_tpu_torch.models import (
    TwoTowerModel,
    make_single_device_trainer,
    train_state_to_numpy,
)
from hm_retrieval_tpu_torch.runners import CheckpointManager
from hm_retrieval_tpu_torch.schema import Feature, TrainingConfig
from hm_retrieval_tpu_torch.utils import profiling, summary
from hm_retrieval_tpu_torch.utils.profiling import StepProfiler
from hm_retrieval_tpu_torch.utils.summary import MetricWriter

B = 16
PATHS = {
    "sparse_adagrad": {},
    "dense_adagrad": {"use_sparse_embedding_optimizer": False},
    "dense_adam": {"optimizer_name": "adam",
                   "optimizer_kwargs": {"learning_rate": 1e-3}},
}


def _model():
    def vocab(prefix, n):
        return np.array([f"{prefix}{i}" for i in range(n)])

    return TwoTowerModel(
        [Feature("customer_id", "categorical", "query", embedding_size=8,
                 vocab=vocab("c", 40))],
        [Feature("article_id", "categorical", "candidate", embedding_size=8,
                 vocab=vocab("a", 25)),
         Feature("product_type_name", "categorical", "candidate",
                 embedding_size=4, vocab=vocab("p", 5))],
        "article_id", 8, [12], [12], logq=np.linspace(-3, 0, 26),
        device="cpu",
    )


def _batch(rng):
    return {
        "customer_id": torch.tensor(rng.integers(1, 41, B), dtype=torch.int32),
        "article_id": torch.tensor(rng.integers(1, 26, B), dtype=torch.int32),
        "product_type_name": torch.tensor(rng.integers(1, 6, B),
                                          dtype=torch.int32),
    }


def _trainer(path, seed=0):
    tc = TrainingConfig(seed=seed, **PATHS[path])
    return make_single_device_trainer(_model(), tc)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix: np.asarray(tree)}


def _assert_bitwise(a, b):
    fa, fb = _flat(train_state_to_numpy(a)), _flat(train_state_to_numpy(b))
    assert fa.keys() == fb.keys()
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_state_round_trips_bit_for_bit(rng, tmp_path, path):
    state, step = _trainer(path)
    for _ in range(3):
        state, _ = step(state, _batch(rng))
    ckpt = CheckpointManager(str(tmp_path), device="cpu")
    ckpt.save(state.step, state)
    ckpt.wait_until_finished()
    fresh, _ = _trainer(path, seed=7)  # other parameters, same layout
    restored = ckpt.restore(fresh)
    ckpt.close()
    assert restored.step == 3 and type(restored) is type(state)
    _assert_bitwise(restored, state)
    with open(tmp_path / "3" / "meta.json") as f:
        assert json.load(f) == {"step": 3, "state": type(state).__name__}


def test_steps_after_save_leave_the_checkpoint_unchanged(rng, tmp_path):
    """Steps update the parameters in place; ``save`` copies the state to
    the host before it returns, so the next steps cannot reach the
    checkpoint, whenever the background write lands."""
    state, step = _trainer("sparse_adagrad")
    state, _ = step(state, _batch(rng))
    saved = train_state_to_numpy(state)
    ckpt = CheckpointManager(str(tmp_path), device="cpu")
    ckpt.save(state.step, state)
    for _ in range(3):
        state, _ = step(state, _batch(rng))
    fresh, _ = _trainer("sparse_adagrad", seed=3)
    restored = ckpt.restore(fresh)
    ckpt.close()
    want = _flat(saved)
    got = _flat(train_state_to_numpy(restored))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    moved = _flat(train_state_to_numpy(state))
    assert any(not np.array_equal(moved[k], want[k]) for k in want)


def test_max_to_keep(rng, tmp_path):
    state, step = _trainer("dense_adagrad")
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2, device="cpu")
    for s in (1, 2, 3, 4):
        state, _ = step(state, _batch(rng))
        ckpt.save(s, state)
    ckpt.wait_until_finished()
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]
    ckpt.close()
    ckpt.close()  # idempotent


def test_empty_directory(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "new"), device="cpu")
    assert ckpt.latest_step() is None
    state, _ = _trainer("sparse_adagrad")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore(state)


def test_a_partial_write_is_never_the_latest(rng, tmp_path):
    state, step = _trainer("dense_adagrad")
    ckpt = CheckpointManager(str(tmp_path), device="cpu")
    ckpt.save(5, state)
    ckpt.wait_until_finished()
    # a write cut off before its rename, and a step directory without meta
    os.makedirs(tmp_path / ".tmp-9-deadbeef")
    np.savez(tmp_path / ".tmp-9-deadbeef" / "state.npz", x=np.zeros(3))
    (tmp_path / ".tmp-9-deadbeef" / "meta.json").write_text("{}")
    os.makedirs(tmp_path / "7")
    np.savez(tmp_path / "7" / "state.npz", x=np.zeros(3))
    assert ckpt.latest_step() == 5
    fresh, _ = _trainer("dense_adagrad", seed=4)
    assert ckpt.restore(fresh).step == 0  # step 5 held a state at step 0


def test_restore_into_another_kind_of_state_raises(tmp_path):
    state, _ = _trainer("sparse_adagrad")
    ckpt = CheckpointManager(str(tmp_path), device="cpu")
    ckpt.save(1, state)
    dense, _ = _trainer("dense_adagrad")
    with pytest.raises(ValueError, match="SparseTrainState"):
        ckpt.restore(dense)
    ckpt.close()


# ----------------------------------------------------------------------
# StepProfiler
# ----------------------------------------------------------------------
class FakeProfile:
    log = []

    def __init__(self, activities):
        self.activities = activities

    def start(self):
        FakeProfile.log.append("start")

    def stop(self):
        FakeProfile.log.append("stop")

    def export_chrome_trace(self, path):
        FakeProfile.log.append(os.path.basename(path))
        with open(path, "w") as f:
            f.write("{}")


@pytest.fixture
def fake_profile(monkeypatch):
    FakeProfile.log = []
    monkeypatch.setattr(profiling.torch.profiler, "profile", FakeProfile)
    return FakeProfile.log


@pytest.mark.parametrize(
    "window, steps, want",
    [
        # the trace opens at the first step >= start, closes at the next >= stop
        ((3, 5), range(1, 9), ["start", "stop", "trace_from_step_3.json"]),
        # a stride that jumps past the whole window still captures one call
        ((3, 5), [0, 8, 16, 24], ["start", "stop", "trace_from_step_8.json"]),
        ((3, 5), [0, 1, 2], []),
    ],
)
def test_profiler_thresholds(tmp_path, fake_profile, window, steps, want):
    prof = StepProfiler(str(tmp_path), window)
    for s in steps:
        prof.on_step(s)
    assert fake_profile == want
    prof.close()
    prof.close()  # idempotent
    assert fake_profile == want


def test_profiler_close_writes_an_open_trace_and_ends_the_window(
        tmp_path, fake_profile):
    prof = StepProfiler(str(tmp_path), (2, 100))
    prof.on_step(2)
    prof.close()
    assert fake_profile == ["start", "stop", "trace_from_step_2.json"]
    prof.close()
    prof.on_step(50)  # a stray step cannot reopen a trace
    assert len(fake_profile) == 3
    assert (tmp_path / "trace_from_step_2.json").exists()


def test_profiler_without_a_window_or_a_logdir(tmp_path, fake_profile):
    prof = StepProfiler(None, None)
    for s in range(10):
        prof.on_step(s)
    prof.close()
    assert fake_profile == []
    with pytest.raises(ValueError, match="log directory"):
        StepProfiler(None, (1, 2))


def test_profiler_traces_the_cpu(tmp_path):
    prof = StepProfiler(str(tmp_path), (1, 2))
    prof.on_step(1)
    torch.ones(64, 64) @ torch.ones(64, 64)
    prof.on_step(2)
    trace = tmp_path / "trace_from_step_1.json"
    assert trace.exists() and trace.stat().st_size > 0


# ----------------------------------------------------------------------
# MetricWriter
# ----------------------------------------------------------------------
def test_writer_without_a_logdir_does_nothing(tmp_path):
    w = MetricWriter(None)
    w.add_scalar("a", 1.0, 0)
    w.add_histogram("h", np.ones(3), 0)
    w.add_params_histograms(_model(), 0)
    w.flush()
    w.close()
    w.close()


def test_writer_logs_only_when_tensorboardx_is_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(summary, "_HAVE_TB", False)
    w = MetricWriter(str(tmp_path / "logs"))
    w.add_scalar("a", 1.0, 0)
    w.add_params_histograms(_model(), 0)
    w.close()
    assert not (tmp_path / "logs").exists()


def test_writer_writes_events_and_histograms_by_jax_path(tmp_path,
                                                         monkeypatch):
    if not summary._HAVE_TB:
        pytest.skip("tensorboardX is not installed")
    tags = []
    w = MetricWriter(str(tmp_path), run_name="run")
    monkeypatch.setattr(w, "add_histogram",
                        lambda tag, values, step: tags.append(tag))
    w.add_scalar("recall_at_10", 0.5, 1)
    w.add_params_histograms(_model(), 1)
    w.close()
    assert os.listdir(tmp_path / "run")
    assert "params/query_tower/dense/0/w" in tags
    assert "params/candidate_tower/embeddings/article_id" in tags


def test_a_foreign_step_directory_is_never_overwritten(tmp_path):
    """A step directory the manager did not write (an orbax checkpoint of
    the JAX package, say) stays as it was; the save raises."""
    os.makedirs(tmp_path / "4" / "orbax")
    (tmp_path / "4" / "orbax" / "data").write_text("jax")
    state, _ = _trainer("dense_adagrad")
    ckpt = CheckpointManager(str(tmp_path), device="cpu")
    ckpt.save(4, state)
    with pytest.raises(FileExistsError, match="not a checkpoint"):
        ckpt.wait_until_finished()
    ckpt.close()
    assert (tmp_path / "4" / "orbax" / "data").read_text() == "jax"
    assert sorted(os.listdir(tmp_path)) == ["4"]
