"""The port's exact iterative PartialReduce top-k
(hm_retrieval_tpu_torch/ops/exact_topk.py) and the "partial_reduce" and
"approx" engines of its BruteForceIndex, held against the JAX package on
the same numpy-seeded inputs.

On the CPU, JAX's ``lax.approx_max_k`` is exact, so the JAX package's
"partial_reduce" finishes in round 2 and its "approx" is the exact top-k.
The port reduces to bins on every device, as the TPU does (the plain
version of its kernel here): its "partial_reduce" takes more rounds and
must give the same exact answers, and its "approx" is approximate, held by
recall (the deliberate difference of ROADMAP.md Queue 3).

Tolerances: scores of one matrix are compared with rtol 1e-6 (the same
fp32 values moved, or an fp32 product summed in another order at E = 16);
an index's scores within 1e-5 (rtol), its ids exactly on continuous data.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.indices import load_index as jax_load_index
from hm_retrieval_tpu.indices.brute_force import (
    BruteForceIndex as JaxBruteForceIndex,
)
from hm_retrieval_tpu.ops.exact_topk import (
    exact_topk_dot as jax_exact_topk_dot,
    exact_topk_scores as jax_exact_topk_scores,
)
from hm_retrieval_tpu.serving.service import (
    RetrievalService as JaxRetrievalService,
)
from hm_retrieval_tpu_torch.indices import load_index
from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
from hm_retrieval_tpu_torch.ops import partial_reduce as pr
from hm_retrieval_tpu_torch.ops.exact_topk import (
    exact_topk_dot,
    exact_topk_scores,
)
from hm_retrieval_tpu_torch.serving import RetrievalService
from tests.test_torch_serving import _raw_queries, write_jax_serving_artifacts


def _clustered(rng):
    # all large values packed contiguously -> maximal bin collisions under
    # strided binning
    s = np.zeros((4, 4096), np.float32)
    s[:, :64] = 1000 + rng.normal(size=(4, 64)).astype(np.float32)
    return s, 32


def _descending(rng):
    return np.tile(np.arange(2048, 0, -1, dtype=np.float32), (2, 1)), 100


def _stacked(rng):
    """32 winners stacked 4 deep in 8 bins of the port's reduction (L =
    1024, 2^r = 4 at n = 4096, k = 32): each round drains one per bin, so
    the refinement needs 4 rounds before its stop test can hold."""
    n, k = 4096, 32
    L, r = pr.reduction_size(n, k, 0.95)
    assert (L, r) == (1024, 2)
    s = rng.normal(size=(3, n)).astype(np.float32)
    for t in range(4):
        for j in range(8):
            s[:, j * 97 + t * L] = 100.0 - t - j / 10
    return s, k


def _continuous(rng):
    return rng.normal(size=(16, 2048)).astype(np.float32), 50


LAYOUTS = {"continuous": _continuous, "clustered": _clustered,
           "descending": _descending, "stacked": _stacked}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_exact_topk_scores_equal_jax(rng, layout):
    s, k = LAYOUTS[layout](rng)
    before = s.copy()
    scores = torch.tensor(s)
    v, i, rounds = exact_topk_scores(scores, k)
    jv, ji, _ = jax_exact_topk_scores(jnp.asarray(s), k)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i.dtype == torch.int32 and rounds >= 2
    np.testing.assert_array_equal(scores.numpy(), before)  # never written
    if layout == "stacked":
        assert rounds >= 5  # round 1, three to drain, one to stop


def test_duplicate_scores():
    """20 tied winners for k = 10: every value 5.0 and every row one of the
    tied ones, compared as the JAX package's own test compares them."""
    s = np.zeros((2, 1024), np.float32)
    s[:, 100:120] = 5.0
    v, i, _ = exact_topk_scores(torch.tensor(s), 10)
    np.testing.assert_allclose(v.numpy(), 5.0)
    assert all(100 <= j < 120 for j in i.numpy().ravel())
    jv, ji, _ = jax_exact_topk_scores(jnp.asarray(s), 10)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_max_rounds_returns_the_leaderboard_as_it_stands(rng):
    s, k = _stacked(rng)
    v, i, rounds = exact_topk_scores(torch.tensor(s), k, max_rounds=2)
    assert rounds == 2
    np.testing.assert_array_equal(
        np.take_along_axis(s, i.numpy().astype(np.int64), 1), v.numpy())
    exact = np.sort(s, axis=1)[:, ::-1][:, :k]
    assert (v.numpy() <= exact).all() and not np.array_equal(v.numpy(), exact)


def test_exact_topk_dot_equals_jax(rng):
    q = rng.normal(size=(8, 16)).astype(np.float32)
    c = rng.normal(size=(1024, 16)).astype(np.float32)
    v, i = exact_topk_dot(torch.tensor(q), torch.tensor(c), 20)
    jv, ji = jax_exact_topk_dot(jnp.asarray(q), jnp.asarray(c), 20)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_k_too_large_rejected():
    with pytest.raises(ValueError):
        exact_topk_scores(torch.zeros(2, 8), 9)


# ----------------------------------------------------------------------
# BruteForceIndex's engines at n = 20,000, k = 100 (L = 2,560)
# ----------------------------------------------------------------------
N, E, K = 20_000, 16, 100


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(7)
    ids = rng.permutation(N).astype(np.int32) + 1
    emb = rng.normal(size=(N, E)).astype(np.float32)
    q = rng.normal(size=(64, E)).astype(np.float32)
    return ids, emb, q


def test_partial_reduce_index_equals_jax(catalog):
    ids, emb, q = catalog
    assert pr.reduction_size(20_480, K, 0.95) == (2_560, 3)
    jv, jids = JaxBruteForceIndex(K, ids, emb, method="partial_reduce") \
        .topk_from_embeddings(jnp.asarray(q))
    idx = BruteForceIndex(K, ids, emb, method="partial_reduce", device="cpu")
    assert idx._engine == "partial_reduce"
    v, got = idx.topk_from_embeddings(torch.tensor(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jids))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5)


def test_approx_index_recall_against_jax(catalog):
    """The deliberate difference: JAX's "approx" off a TPU is exact; the
    port's reduces, and its mean recall against JAX's answers over 64
    queries must reach 0.95 (XLA's model gives 0.962)."""
    ids, emb, q = catalog
    assert pr.reduction_size(N, K, 0.95) == (2_560, 3)
    _, jids = JaxBruteForceIndex(K, ids, emb, method="approx") \
        .topk_from_embeddings(jnp.asarray(q))
    idx = BruteForceIndex(K, ids, emb, method="approx", device="cpu")
    assert idx._engine == "approx"
    v, got = idx.topk_from_embeddings(torch.tensor(q))
    v, got = v.numpy(), got.numpy()
    # real (score, id) pairs, best first, no repeats
    row_of = {int(a): r for r, a in enumerate(ids)}
    rows = np.vectorize(row_of.get)(got)
    np.testing.assert_allclose(v, np.einsum("be,bke->bk", q, emb[rows]),
                               rtol=1e-5, atol=1e-5)
    assert (np.diff(v, axis=1) <= 0).all()
    assert all(len(set(r)) == K for r in got)
    recall = np.mean([len(set(a) & set(b)) / K
                      for a, b in zip(got, np.asarray(jids))])
    assert recall >= 0.95


def test_approx_index_at_full_recall_equals_jax(catalog):
    ids, emb, q = catalog
    jv, jids = JaxBruteForceIndex(K, ids, emb, method="approx",
                                  recall_target=1.0) \
        .topk_from_embeddings(jnp.asarray(q))
    idx = BruteForceIndex(K, ids, emb, method="approx", recall_target=1.0,
                          device="cpu")
    v, got = idx.topk_from_embeddings(torch.tensor(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jids))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5)


def test_approx_raises_where_the_bins_are_fewer_than_k(catalog):
    ids, emb, q = catalog
    assert pr.reduction_size(N, 1000, 0.1) == (640, 5)
    idx = BruteForceIndex(1000, ids, emb, method="approx", recall_target=0.1,
                          device="cpu")
    with pytest.raises(ValueError, match="recall_target"):
        idx.topk_from_embeddings(torch.tensor(q))


@pytest.mark.parametrize("kind", ["normal", "integer"])
@pytest.mark.parametrize("n", [5_000, 120_000])
def test_pallas_past_the_largest_bin_count_routes_to_partial_reduce(
        rng, caplog, tmp_path, n, kind):
    """k = 3000 > 2048: JAX's pick_bins finds no bin count and its "pallas"
    index runs "partial_reduce"; the port's takes the same route, with a
    log line, and keeps "pallas" as its saved method. Against JAX's index
    (its approx_max_k exact on the CPU): normal scores within 1e-5 relative
    and ids equal wherever the competing scores differ by more
    (test_torch_bin_topk.TOL; the fp32 products sum in another order);
    integer scores bit for bit, ids up to the order of ties (between bins,
    by bin). At n = 5,000 nothing reduces; at 120,000 the
    padded catalog reduces to (60,416, 1)."""
    import logging

    from test_torch_bin_topk import _assert_same_ranking
    from test_torch_widths import _assert_exact_up_to_tie_order

    k = 3000
    ids = rng.permutation(n).astype(np.int32) + 1
    if kind == "normal":
        emb = rng.normal(size=(n, E)).astype(np.float32)
        q = rng.normal(size=(4, E)).astype(np.float32)
    else:
        emb = rng.integers(-4, 5, size=(n, E)).astype(np.float32)
        q = rng.integers(-4, 5, size=(4, E)).astype(np.float32)
    n_pad = -(-n // BruteForceIndex.PAD_MULTIPLE) * BruteForceIndex.PAD_MULTIPLE
    assert pr.reduction_size(n_pad, k, 0.95) == (
        (n_pad, 0) if n < 10_000 else (60_416, 1))
    with caplog.at_level(logging.WARNING):
        idx = BruteForceIndex(k, ids, emb, method="pallas", device="cpu")
    assert (idx.method, idx._engine) == ("pallas", "partial_reduce")
    routed = [r.getMessage() for r in caplog.records
              if "largest bin count" in r.getMessage()]
    assert len(routed) == 1 and "'partial_reduce'" in routed[0]
    want = JaxBruteForceIndex(k, ids, emb, method="pallas") \
        .topk_from_embeddings(jnp.asarray(q))
    got = idx.topk_from_embeddings(torch.tensor(q))
    if kind == "normal":
        row_of = np.zeros(n + 1, np.int64)
        row_of[ids] = np.arange(n)
        _assert_same_ranking(
            got[0].numpy(), row_of[got[1].numpy()], np.asarray(want[0]),
            row_of[np.asarray(want[1])],
            q.astype(np.float64) @ emb.astype(np.float64).T, exact=False)
    else:
        _assert_exact_up_to_tie_order(got, want, q, emb, ids)
    idx.save(str(tmp_path))
    with open(tmp_path / "meta.json") as f:
        assert json.load(f)["method"] == "pallas"
    again = load_index(str(tmp_path), device="cpu")
    assert (again.method, again._engine) == ("pallas", "partial_reduce")


# ----------------------------------------------------------------------
# Artifacts across the packages, served as strings
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Schema and towers written by the JAX package, and its index saved
    with each PartialReduce method."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("jax_pr_artifacts")
    ids, emb = write_jax_serving_artifacts(root, rng)
    for method in ("approx", "partial_reduce"):
        JaxBruteForceIndex(10, ids, emb, method=method).save(
            str(root / f"index_{method}"))
    return {"root": root, "raw": _raw_queries(rng)}


def _strings_ok(rows, vocab):
    return all(len(r) == 10 and len(set(r)) == 10 and set(r) <= vocab
               for r in rows)


@pytest.mark.parametrize("method", ["approx", "partial_reduce"])
def test_jax_artifact_serves_on_its_engine(artifacts, method, tmp_path):
    root = artifacts["root"]
    index_dir = str(root / f"index_{method}")
    idx = load_index(index_dir, device="cpu")
    assert idx.method == method and idx._engine == method
    svc = RetrievalService.load(str(root / "schema"), str(root / "model"),
                                index_dir, device="cpu")
    assert svc.index._engine == method
    got = svc.retrieve(artifacts["raw"])
    vocab = set(svc.schema.candidate_id_feature.vocab.tolist())
    assert _strings_ok(got, vocab)
    want = JaxRetrievalService.load(str(root / "schema"), str(root / "model"),
                                    index_dir).retrieve(artifacts["raw"])
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, want)])
    # exact on both sides (up to the towers' summation order), or the
    # port's bins against JAX's exact CPU answer
    assert overlap >= (0.95 if method == "partial_reduce" else 0.8)
    # and the reverse: the port's save loads in JAX on the same method
    idx.save(str(tmp_path / "port"))
    with open(tmp_path / "port" / "meta.json") as f:
        assert json.load(f)["method"] == method
    back = jax_load_index(str(tmp_path / "port"))
    assert back.method == method
    again = load_index(str(tmp_path / "port"), device="cpu")
    q = torch.tensor(np.random.default_rng(1).normal(size=(3, 16)),
                     dtype=torch.float32)
    a, b = idx.topk_from_embeddings(q), again.topk_from_embeddings(q)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    jq = jnp.asarray(q.numpy())
    assert np.asarray(back.topk_from_embeddings(jq)[1]).shape == (3, 10)
