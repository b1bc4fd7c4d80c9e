"""The slice as a whole: the JAX package writes schema, towers and index;
the port's RetrievalService loads them on the CPU and must answer string
requests as the JAX package's own functions do:

    RetrievalService.encode_query -> tower_forward
    -> pallas_exact_topk(interpret=True) -> id take -> decode

Tolerance: strings must be equal except where the two competing items'
reference scores lie within TOL of each other, relative to the row's best
score (the two packages run fp32 towers in another summation order, and a
query component whose last fp32 bit differs can round to a neighbouring bf16
value, one bf16 step of 2^-8 on one term of the product).
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
from hm_retrieval_tpu.models.tower import tower_forward
from hm_retrieval_tpu.models.two_tower import TwoTowerModel as JaxTwoTower
from hm_retrieval_tpu.ops.pallas_retrieval import pallas_exact_topk
from hm_retrieval_tpu.runners.checkpoint import export_model as jax_export
from hm_retrieval_tpu.schema import (
    Feature as JaxFeature,
    ModelConfig as JaxModelConfig,
    Schema as JaxSchema,
    TrainingConfig as JaxTrainingConfig,
)
from hm_retrieval_tpu.serving.service import (
    RetrievalService as JaxRetrievalService,
)
from hm_retrieval_tpu_torch.indices import load_index
from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.serving import RetrievalService

N_ARTICLES, N_CUSTOMERS, E, K = 20_000, 300, 16, 10
TOL = 1e-3


def _raw_queries(rng, B=7):
    customers = [f"c{int(i):04d}" for i in rng.integers(0, N_CUSTOMERS, B)]
    customers[1] = "not-a-customer"  # OOV
    ages = rng.normal(35, 8, B).astype(np.float32)
    ages[2] = np.nan
    hist = [
        [f"a{int(i):05d}" for i in rng.integers(0, N_ARTICLES, rng.integers(1, 6))]
        for _ in range(B)
    ]
    hist[3] = []  # all-pad history
    hist[4] = ["zzz", "a00007"]  # one OOV token
    return {"customer_id": customers, "age": ages, "purchase_history": hist}


def write_jax_serving_artifacts(root, rng):
    """Schema and towers written by the JAX package under ``root``; returns
    the catalog's (ids, embeddings) from its candidate tower."""
    articles = np.array([f"a{i:05d}" for i in range(N_ARTICLES)])
    customers = np.array([f"c{i:04d}" for i in range(N_CUSTOMERS)])
    features = [
        JaxFeature("customer_id", "categorical", "query", embedding_size=E,
                   vocab=customers),
        JaxFeature("age", "numeric", "query", standardize=True, mean=35.0,
                   std=8.0),
        JaxFeature("purchase_history", "sequence", "query", embedding_size=8,
                   max_len=4, shared_vocab_with="article_id",
                   pooling="attention"),
        JaxFeature("article_id", "categorical", "candidate", embedding_size=E,
                   vocab=articles),
    ]
    schema = JaxSchema(
        features,
        JaxModelConfig(E, ks=[K], query_tower_units=[32],
                       candidate_tower_units=[32]),
        JaxTrainingConfig(),
    )
    schema.save(str(root / "schema"))
    model = JaxTwoTower(
        schema.query_features, schema.candidate_features, "article_id", E,
        [32], [32],
    )
    params = jax.tree_util.tree_map(np.asarray, model.init_params(seed=0))
    params["query_tower"]["attention"]["purchase_history"] = rng.normal(
        size=8
    ).astype(np.float32)
    jax_export(params, str(root / "model"))
    ids = np.arange(1, N_ARTICLES + 1, dtype=np.int32)
    emb = np.asarray(
        model.candidate_forward(params, {"article_id": jnp.asarray(ids)})
    )
    return ids, emb


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Schema, towers and a method="pallas" index written by the JAX
    package (n_pad = 20,480 > 16384 rows)."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("jax_artifacts")
    ids, emb = write_jax_serving_artifacts(root, rng)
    JaxBruteForceIndex(K, ids, emb, method="pallas").save(str(root / "index"))
    return {
        "root": root,
        "schema": str(root / "schema"),
        "model": str(root / "model"),
        "index": str(root / "index"),
        "raw": _raw_queries(rng),
    }


def _jax_reference(art):
    svc = JaxRetrievalService.load(art["schema"], art["model"], art["index"])
    batch = svc.encode_query(art["raw"])
    q = tower_forward(svc.params, svc.schema.query_features, batch)
    with np.load(f"{art['index']}/index.npz") as z:
        identifiers, emb = z["identifiers"], z["embeddings"]
    v, rows, rounds = pallas_exact_topk(
        q, jnp.asarray(emb), K, interpret=True
    )
    ids = np.take(identifiers, np.asarray(rows))
    strings = svc.schema.candidate_id_feature.decode(ids)
    return np.asarray(q), emb, strings, int(rounds)


def _ref_scores(q, emb):
    qb = torch.tensor(q).bfloat16().double()
    cb = torch.tensor(emb).bfloat16().double()
    return (qb @ cb.T).numpy()


def _assert_same_answers(got, want, scores, vocab):
    row_of = {s: i for i, s in enumerate(vocab)}
    for r, (g_row, w_row) in enumerate(zip(got, want)):
        assert len(g_row) == len(w_row) == K
        assert len(set(g_row)) == K
        scale = TOL * max(abs(scores[r]).max(), 1e-30)
        for g, w in zip(g_row, w_row):
            if g != w:
                assert abs(scores[r, row_of[g]] - scores[r, row_of[w]]) <= scale


def test_index_resolves_to_the_kernel_path(artifacts):
    idx = load_index(artifacts["index"], device="cpu")
    assert idx.method == "pallas" and idx._engine == "pallas"
    assert idx.embeddings.shape[0] == 20_480
    assert bt.default_bins(idx.k) == 256


def test_port_service_matches_jax_functions(artifacts):
    q_ref, emb, want, rounds_ref = _jax_reference(artifacts)
    svc = RetrievalService.load(
        artifacts["schema"], artifacts["model"], artifacts["index"],
        device="cpu",
    )
    q = svc.embed(svc.encode_query(artifacts["raw"]))
    np.testing.assert_allclose(q.numpy(), q_ref, rtol=1e-5, atol=1e-6)
    got = svc.retrieve(artifacts["raw"])
    vocab = ["<OOV>"] + list(svc.schema.candidate_id_feature.vocab)
    _assert_same_answers(got, want, _ref_scores(q_ref, emb), vocab)
    assert all("<OOV>" not in row for row in got)
    _, _, rounds = bt.exact_topk(q, svc.index.embeddings[:N_ARTICLES], K)
    assert rounds == rounds_ref
    assert svc.retrieve(artifacts["raw"], k=3) == [row[:3] for row in got]


def test_request_validation(artifacts):
    svc = RetrievalService.load(
        artifacts["schema"], artifacts["model"], artifacts["index"],
        device="cpu",
    )
    with pytest.raises(ValueError, match="exceeds index k"):
        svc.retrieve(artifacts["raw"], k=K + 1)
    raw = dict(artifacts["raw"])
    raw.pop("age")
    with pytest.raises(KeyError, match="age"):
        svc.retrieve(raw)
    raw = dict(artifacts["raw"], age=[1.0])
    with pytest.raises(ValueError, match="inconsistent"):
        svc.retrieve(raw)
    with pytest.raises(ValueError, match="requires a mesh"):
        RetrievalService.load(
            artifacts["schema"], artifacts["model"], artifacts["index"],
            device="cpu", distributed_index=True,
        )


def test_jax_index_loads_in_the_port(artifacts):
    with np.load(f"{artifacts['index']}/index.npz") as z:
        ids, emb = z["identifiers"], z["embeddings"]
    idx = load_index(artifacts["index"], device="cpu")
    np.testing.assert_array_equal(idx.identifiers[: len(ids)].numpy(), ids)
    np.testing.assert_array_equal(idx.embeddings[: len(ids)].numpy(), emb)
    assert idx.k == K and idx.num_candidates == N_ARTICLES


def test_port_index_loads_in_jax(artifacts, tmp_path):
    idx = load_index(artifacts["index"], device="cpu")
    idx.save(str(tmp_path / "port_index"))
    with open(tmp_path / "port_index" / "meta.json") as f:
        meta = json.load(f)
    assert meta == {
        "k": K, "type": "brute_force", "method": "pallas",
        "recall_target": 0.95,
    }
    back = jax_load_index(str(tmp_path / "port_index"))
    with np.load(f"{artifacts['index']}/index.npz") as z:
        ids, emb = z["identifiers"], z["embeddings"]
    np.testing.assert_array_equal(
        np.asarray(back.identifiers[:N_ARTICLES]), ids
    )
    np.testing.assert_array_equal(
        np.asarray(back.embeddings[:N_ARTICLES]), emb
    )
    again = load_index(str(tmp_path / "port_index"), device="cpu")
    q = torch.randn(3, E, generator=torch.Generator().manual_seed(0)).abs()
    a, b = idx.topk_from_embeddings(q), again.topk_from_embeddings(q)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


@pytest.mark.parametrize(
    "n, method, engine",
    [
        (16_384, "auto", "full"),
        (16_385, "auto", "pallas"),
        (500, "pallas", "pallas"),
        (500, "partial_reduce", "partial_reduce"),
        (500, "approx", "approx"),
    ],
)
def test_method_resolution(n, method, engine):
    idx = BruteForceIndex(
        5, np.arange(n), np.zeros((n, 2), np.float32), method=method,
        device="cpu",
    )
    assert idx._engine == engine
    assert idx.method == (engine if method == "auto" else method)


def test_full_path_matches_jax(rng):
    N, k = 3000, 20
    ids = rng.permutation(N).astype(np.int32) + 1
    emb = rng.normal(size=(N, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    jidx = JaxBruteForceIndex(k, ids, emb, method="full")
    jv, jids = jidx.topk_from_embeddings(jnp.asarray(q))
    idx = BruteForceIndex(k, ids, emb, method="full", device="cpu")
    v, got = idx.topk_from_embeddings(torch.tensor(q))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jids))


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_index_arrays_load_like_jax(rng, tmp_path, layout):
    """Both artifact layouts read back as the JAX package reads them; a
    stray file off the shard naming is skipped."""
    from hm_retrieval_tpu.indices.artifact import (
        load_index_arrays as jax_load_arrays,
        shard_file,
    )
    from hm_retrieval_tpu_torch.indices.artifact import load_index_arrays

    ids = np.arange(1, 301, dtype=np.int32)
    emb = rng.normal(size=(300, 4)).astype(np.float32)
    if layout == "single":
        np.savez(tmp_path / "index.npz", identifiers=ids, embeddings=emb)
    else:
        for s, rows in enumerate(np.array_split(np.arange(300), 3)):
            np.savez(shard_file(str(tmp_path), s), identifiers=ids[rows],
                     embeddings=emb[rows])
        np.savez(tmp_path / "index_shard_old.npz", identifiers=ids[:1],
                 embeddings=emb[:1])
    got, want = load_index_arrays(str(tmp_path)), jax_load_arrays(str(tmp_path))
    assert sorted(got) == sorted(want) == ["embeddings", "identifiers"]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["identifiers"], ids)


def test_single_file_save_clears_stale_shards(rng, tmp_path):
    from hm_retrieval_tpu.indices.artifact import shard_file

    for s in range(2):
        np.savez(shard_file(str(tmp_path), s), identifiers=np.arange(3),
                 embeddings=np.zeros((3, 4), np.float32))
    idx = BruteForceIndex(2, np.arange(10, 15), rng.normal(size=(5, 4)),
                          device="cpu")
    idx.save(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "index.npz", "meta.json"
    ]
    np.testing.assert_array_equal(
        jax_load_index(str(tmp_path)).identifiers[:5], np.arange(10, 15)
    )


def test_unfilled_rows_map_to_missing_id_not_an_error():
    idx = BruteForceIndex(
        2, np.arange(10, 20), np.zeros((10, 4)), device="cpu"
    )
    rows = torch.tensor([[0, 9, bt.BIG_IDX, -1]], dtype=torch.int32)
    got = idx._ids_of(rows).tolist()
    assert got == [[10, 19, -(2**31), -(2**31)]]
