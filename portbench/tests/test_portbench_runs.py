"""Whole runs of each cell on the plain paths at a tiny size, past the
look for a card: the result line, the traced run's metrics, and
``correct`` false with the timed path broken underneath (a planted
fault a test) or with a control in the program's place."""

import math

import pytest
import torch

from portbench import calibrate, run
from portbench.registry import Registry
from portbench.tests.sizes import overrides

REG = Registry()
RETRIEVE = "hm_e128.retrieve_b1024"
TRAIN = [c["name"] for c in REG.manifest["workloads"] if "train" in c["name"]]
SEED = 2**31 + 12345  # past 32 signed bits, as a seed may be


def tiny_run(cell, traced=False, seconds=1.0, seed=SEED):
    cfg, tr = overrides(cell)
    return run.run_cell(cell, seed, seconds, traced, device="cpu",
                        config_overrides=cfg, traffic_overrides=tr)


@pytest.mark.parametrize("cell", [RETRIEVE] + TRAIN)
def test_untraced_run(cell):
    res = tiny_run(cell)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in REG.end_to_end(cell)}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    limits = REG.limits(cell)
    assert {n: c["limit"] for n, c in res["checks"].items()} == limits


@pytest.mark.parametrize("cell", [RETRIEVE, TRAIN[0]])
def test_traced_run_reports_per_layer_metrics(cell):
    res = tiny_run(cell, traced=True)
    assert res["correct"] is True
    allowed = {m["name"] for m in REG.per_layer(cell)}
    assert set(res["metrics"]) <= allowed
    # the CPU has no device trace: only spans, counters and rates read
    assert "idle_share.retrieve" not in res["metrics"]
    assert {"device_ops", "idle_gaps"} <= set(res["breakdown"])
    assert res["device"]["window_s"] > 0
    if cell == RETRIEVE:
        assert {"topk_ms.retrieve", "mfu.retrieve"} <= set(res["metrics"])
        # CUDA-event time only: no device number from a CPU run
        assert "embed_ms.retrieve" not in res["metrics"]
    else:
        assert "mfu.train" in res["metrics"]


def test_same_seed_same_inputs():
    from portbench import inputs

    cfg, tr = overrides(TRAIN[0])
    cfg = {**REG.config("hm_e128"), **cfg}
    tr = {**REG.traffic("train_b8192"), **tr}
    a = inputs.make_weights(cfg, SEED, "cpu")
    b = inputs.make_weights(cfg, SEED, "cpu")
    c = inputs.make_weights(cfg, SEED + 1, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["query_tower.embeddings.customer_id"],
                           c["query_tower.embeddings.customer_id"])
    probs = inputs.article_probs(cfg, SEED)
    p1 = inputs.train_pool(cfg, tr, probs, SEED, "cpu")
    p2 = inputs.train_pool(cfg, tr, probs, SEED, "cpu")
    assert all(torch.equal(p1[n], p2[n]) for n in p1)
    assert inputs.customer_batches(3000, 64, -5).shape == (47, 64)


# -- planted faults: the timed path broken underneath ----------------------


def _alter_an_answer(monkeypatch):
    from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex

    orig = BruteForceIndex.topk_from_embeddings

    def altered(self, q):
        scores, ids = orig(self, q)
        ids = ids.clone()
        ids[0, 0] = int(ids[0].max()) % self.num_candidates + 1
        return scores, ids

    monkeypatch.setattr(BruteForceIndex, "topk_from_embeddings", altered)


def _retrieve_half_the_batch(monkeypatch):
    from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex

    orig = BruteForceIndex.topk_from_embeddings

    def half(self, q):
        h = q.shape[0] // 2
        scores, ids = orig(self, q[:h])
        return torch.cat([scores, scores]), torch.cat([ids, ids])

    monkeypatch.setattr(BruteForceIndex, "topk_from_embeddings", half)


def _state_unchanged(monkeypatch):
    from hm_retrieval_tpu_torch.models import optimizer_factory as of
    from hm_retrieval_tpu_torch.models import sparse_optimizer as so

    monkeypatch.setattr(so, "_sparse_adagrad_update", lambda *a, **k: None)
    monkeypatch.setattr(of.Adagrad, "update_", lambda self, g, s, p: s)


def _train_half_the_batch(monkeypatch):
    from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel

    orig = TwoTowerModel.loss

    def half(self, batch, query_rows=None, candidate_rows=None):
        h = next(iter(batch.values())).shape[0] // 2

        def cut(d):
            return None if d is None else {k: v[:h] for k, v in d.items()}

        return 2 * orig(self, cut(batch), cut(query_rows), cut(candidate_rows))

    monkeypatch.setattr(TwoTowerModel, "loss", half)


@pytest.mark.parametrize("cell,fault", [
    (RETRIEVE, _alter_an_answer),
    (RETRIEVE, _retrieve_half_the_batch),
    (TRAIN[0], _state_unchanged),
    (TRAIN[0], _train_half_the_batch),
])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = tiny_run(cell)
    assert res["correct"] is False
    bad = [n for n, c in res["checks"].items()
           if not c["value"] <= c["limit"]]
    assert bad


def test_state_unchanged_reads_one():
    # the training bullet's measure: a leaf that never moved reads 1
    from portbench import compare

    ref = {"losses": [1.0], "grad": {"a": 2.0, "b": 3.0},
           "change": {"a": 0.5, "b": 0.7}}
    prog = {"losses": [1.0], "grad": {"a": 0.0, "b": 0.0},
            "change": {"a": 0.0, "b": 0.0}}
    got = compare.train_numbers(prog, ref)
    assert got["change_gap"] == pytest.approx(1.0)
    assert got["grad_gap"] == pytest.approx(1.0)


# -- controls in the program's place ---------------------------------------


def test_fp8_scoring_control_is_not_correct():
    cfg, tr = overrides(RETRIEVE)
    got = calibrate.readings(RETRIEVE, SEED, "control", 2, "cpu", cfg, tr)
    limits = REG.limits(RETRIEVE)
    assert any(not got[n] <= limits[n] for n in limits), got


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN)
def test_tf32_control_is_not_correct(card, cell):
    cfg, tr = overrides(cell)
    got = calibrate.readings(cell, SEED, "control", 0, card, cfg, tr)
    limits = REG.limits(cell)
    assert any(not got[n] <= limits[n] for n in limits), got


def test_nan_fails_every_limit():
    from portbench import compare

    assert not compare.judge({"x": math.nan}, {"x": 1.0})
    assert not compare.judge({}, {"x": 1.0})
