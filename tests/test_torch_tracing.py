"""The port's spans and counters (hm_retrieval_tpu_torch/utils/tracing.py)
and where the program opens them: the exact top-k driver's blocks, rounds
and host reads (ops/bin_topk.py), and the sparse training step's phases
(models/sparse_optimizer.py). On the CPU the kernel wrappers run their
plain versions, which take the same rounds and host reads as the kernels.
"""

import threading

import numpy as np
import pytest
import torch

from hm_retrieval_tpu_torch.models.optimizer_factory import OptimizerFactory
from hm_retrieval_tpu_torch.models.sparse_optimizer import (
    create_sparse_train_state,
    make_sparse_train_step,
)
from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.ops import quantized_topk as qt
from hm_retrieval_tpu_torch.schema.features import Feature
from hm_retrieval_tpu_torch.utils import tracing

E, L = 16, 256
SYNC = "topk_rounds.sync"
PHASES = ["train_step.forward", "train_step.backward",
          "train_step.dense_update", "train_step.sparse_update"]


@pytest.fixture(autouse=True)
def fresh_counts():
    tracing.reset_counts()
    yield
    tracing.reset_counts()


def _ties(rng, B=300, N=3000):
    """Integer queries and a catalog of codes in [-2, 2]: bf16-exact
    scores with many ties, which take refinement rounds."""
    q = torch.tensor(rng.integers(-4, 5, size=(B, E)), dtype=torch.float32)
    c = torch.tensor(rng.integers(-2, 3, size=(N, E)), dtype=torch.float32)
    return q, c


def _per_block(monkeypatch):
    """Wraps ``_topk_rounds``: (rounds, host syncs) of each block."""
    blocks = []
    inner = bt._topk_rounds

    def counted(*args, **kwargs):
        before = tracing.COUNTS.get("topk_rounds.host_syncs", 0)
        out = inner(*args, **kwargs)
        blocks.append((out[2],
                       tracing.COUNTS["topk_rounds.host_syncs"] - before))
        return out

    monkeypatch.setattr(bt, "_topk_rounds", counted)
    return blocks


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


def test_off_span_is_one_shared_no_op():
    first = tracing.span("a")
    assert tracing.span("b") is first
    with first, tracing.span("c"):
        pass
    assert tracing._records is None
    with tracing.collect() as spans:
        pass
    assert spans == []


def test_spans_nest_with_parent_and_root():
    with tracing.collect() as spans:
        assert spans == []  # filled when the block closes
        with tracing.span("call"):
            with tracing.span("call.a"):
                with tracing.span("call.a.x"):
                    pass
            with tracing.span("call.b"):
                pass
        with tracing.span("next"):
            with tracing.span("next.a"):
                pass
    assert [s.name for s in spans] == [
        "call", "call.a", "call.a.x", "call.b", "next", "next.a"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1, 4]
    assert [s.root for s in spans] == [0, 0, 0, 0, 4, 4]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert spans[1].end_ns <= spans[3].start_ns
    assert tracing.span("after") is tracing.span("off")


def test_span_of_another_thread_is_its_own_root():
    with tracing.collect() as spans:
        with tracing.span("main"):
            t = threading.Thread(target=_one_span, args=("worker",))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    by_name = {s.name: (i, s) for i, s in enumerate(spans)}
    i, worker = by_name["worker"]
    assert worker.parent == -1 and worker.root == i
    assert by_name["main"][1].parent == -1


def _one_span(name):
    with tracing.span(name):
        pass


def test_collect_does_not_nest_and_closes_on_error():
    with pytest.raises(ValueError):
        with tracing.collect():
            with tracing.span("a"):
                raise ValueError("inside")
    assert tracing._records is None
    with tracing.collect():
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.collect():
                pass
    assert tracing._records is None


def test_counts_add_and_reset():
    tracing.count("x")
    tracing.count("x", 4)
    tracing.count("y", 0)
    assert tracing.COUNTS == {"x": 5, "y": 0}
    tracing.reset_counts()
    assert tracing.COUNTS == {}


# ---------------------------------------------------------------------------
# The exact top-k driver
# ---------------------------------------------------------------------------


def test_exact_topk_counts_blocks_rounds_and_syncs(rng, monkeypatch):
    q, c = _ties(rng)
    blocks = _per_block(monkeypatch)
    with tracing.collect() as spans:
        _, _, most = bt.exact_topk(q, c, 100, L=L)
    assert len(blocks) == 3  # 300 rows in blocks of 128
    assert max(r for r, _ in blocks) == most > 1
    counts = tracing.COUNTS
    assert counts["topk_rounds.blocks"] == 3
    assert counts["topk_rounds.rounds"] == sum(r for r, _ in blocks)
    assert counts["topk_rounds.host_syncs"] == sum(s for _, s in blocks)
    for r, s in blocks:  # 1 + a pair of flags a round + one after a merge
        assert 1 + (r - 1) <= s <= 1 + 2 * (r - 1)
    syncs = [s for s in spans if s.name == SYNC]
    assert len(syncs) == counts["topk_rounds.host_syncs"]
    names = [s.name for s in spans]
    assert names[:2] == ["exact_topk", "exact_topk.prep"]
    assert set(names[2:]) == {SYNC}
    assert all(s.parent == 0 and s.root == 0 for s in spans[1:])


def test_lockstep_reads_once_a_round(rng, monkeypatch):
    q, c = _ties(rng, B=256)
    blocks = _per_block(monkeypatch)
    bt.exact_topk(q, c, 100, L=L, lockstep=True)
    (r, s), = blocks  # one loop over the whole batch, every round merged
    assert tracing.COUNTS["topk_rounds.blocks"] == 1
    assert r > 1 and s == r


@pytest.mark.parametrize("keep", [1, 2])
def test_exact_topk_bits_with_tracing_on_and_off(rng, keep):
    q, c = _ties(rng)
    off = bt.exact_topk(q, c, 100, L=L, keep_per_bin=keep)
    with tracing.collect():
        on = bt.exact_topk(q, c, 100, L=L, keep_per_bin=keep)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    assert on[2] == off[2]


def test_quantized_rounds_count_and_keep_their_bits(rng):
    N, k = 3000, 100
    q = torch.tensor(rng.integers(-4, 5, size=(200, E)), dtype=torch.float32)
    codes = torch.tensor(rng.integers(-127, 128, size=(N, E)),
                         dtype=torch.int8)
    scales = torch.tensor(rng.random(N) * 0.05 + 1e-3, dtype=torch.float32)
    off = qt.quantized_topk(q, codes, scales, k, L=L, max_rounds=8)
    tracing.reset_counts()
    with tracing.collect() as spans:
        on = qt.quantized_topk(q, codes, scales, k, L=L, max_rounds=8)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    assert on[2] == off[2] > 1
    assert tracing.COUNTS["topk_rounds.blocks"] == 2
    assert on[2] <= tracing.COUNTS["topk_rounds.rounds"] <= 2 * on[2]
    assert (sum(s.name == SYNC for s in spans)
            == tracing.COUNTS["topk_rounds.host_syncs"])


# ---------------------------------------------------------------------------
# The sparse training step
# ---------------------------------------------------------------------------


def _vocab(prefix, n):
    return np.array([f"{prefix}{i}" for i in range(n)])


def _sparse_trainer(seed=0):
    query = [
        Feature("customer_id", "categorical", "query", embedding_size=8,
                vocab=_vocab("c", 60)),
        Feature("purchase_history", "sequence", "query", embedding_size=8,
                vocab=_vocab("a", 40), max_len=5, pooling="mean"),
    ]
    candidate = [
        Feature("article_id", "categorical", "candidate", embedding_size=8,
                vocab=_vocab("a", 40)),
        Feature("colour", "categorical", "candidate", embedding_size=4,
                vocab=_vocab("col", 6)),
    ]
    model = TwoTowerModel(query, candidate, "article_id",
                          joint_embedding_size=16, query_tower_units=[32],
                          candidate_tower_units=[24], device="cpu")
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": 0.05})
    state = create_sparse_train_state(model, opt, seed=seed)
    return state, make_sparse_train_step(model, opt, 0.05)


def _batches(rng, n=3, B=16):
    return [{
        "customer_id": torch.tensor(rng.integers(0, 61, B), dtype=torch.int32),
        "purchase_history": torch.tensor(rng.integers(0, 41, (B, 5)),
                                         dtype=torch.int32),
        "article_id": torch.tensor(rng.integers(1, 41, B), dtype=torch.int32),
        "colour": torch.tensor(rng.integers(0, 7, B), dtype=torch.int32),
    } for _ in range(n)]


def _run(state, step, batches):
    losses = []
    for b in batches:
        state, out = step(state, b)
        losses.append(out["loss"])
    return state, losses


def test_sparse_step_records_its_four_phases_in_order(rng):
    state, step = _sparse_trainer()
    with tracing.collect() as spans:
        _run(state, step, _batches(rng, n=2))
    assert [s.name for s in spans] == (["train_step"] + PHASES) * 2
    for root in (0, 5):
        top = spans[root]
        assert top.parent == -1 and top.root == root
        phases = spans[root + 1:root + 5]
        assert all(p.parent == root and p.root == root for p in phases)
        assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
        assert top.start_ns <= phases[0].start_ns
        assert phases[-1].end_ns <= top.end_ns


def test_sparse_steps_bits_with_tracing_on_and_off(rng):
    batches = _batches(rng)
    off, off_losses = _run(*_sparse_trainer(), batches)
    state, step = _sparse_trainer()
    with tracing.collect():
        on, on_losses = _run(state, step, batches)
    assert on.step == off.step == 3
    assert all(torch.equal(a, b) for a, b in zip(on_losses, off_losses))
    for name, p in off.params.items():
        assert torch.equal(on.params[name], p), name
    for name, acc in off.sparse_state.accumulators.items():
        assert torch.equal(on.sparse_state.accumulators[name], acc), name
    for name, acc in off.dense_opt_state.sum_of_squares.items():
        assert torch.equal(on.dense_opt_state.sum_of_squares[name], acc), name
