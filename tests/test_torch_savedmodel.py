"""The port's TF-Serving SavedModel against the JAX package's.

One set of weights (the JAX towers' initial parameters, an attention query
drawn from a seed, a catalog of 300 random article embeddings) goes through
the JAX export (``jax2tf``) and, carried by ``models/bridge.py``, through
the port's (TensorFlow ops): exact, quantized (with its fp32 rescore table,
and without it: the dequantized catalog) and sharded (``to_local()``)
indices, a categorical, a standardized numeric, a mean-pooled and an
attention-pooled sequence query feature. Both SavedModels answer the same
requests (OOV customers and tokens, a NaN age, empty and full histories)
with the same strings, except where the two competing articles'
scores lie within TOL of the row's best (the packages' float32 products sum
in another order); ids outside the vocab decode to "<OOV>" in both; the
signatures are equal; an infinite age reads as the float32 extreme and a
NaN one as the mean in both. The modelling runner exports end to end, over a mesh
with a row-sharded table and a sharded index too, and with TensorFlow
blocked it raises ``ImportError`` before any step.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from hm_retrieval_tpu.indices.brute_force import (  # noqa: E402
    BruteForceIndex as JaxBruteForceIndex,
)
from hm_retrieval_tpu.indices.quantized import (  # noqa: E402
    QuantizedIndex as JaxQuantizedIndex,
)
from hm_retrieval_tpu.models.tower import tower_forward  # noqa: E402
from hm_retrieval_tpu.models.two_tower import (  # noqa: E402
    TwoTowerModel as JaxTwoTower,
)
from hm_retrieval_tpu.schema import (  # noqa: E402
    Feature as JaxFeature,
    ModelConfig as JaxModelConfig,
    Schema as JaxSchema,
    TrainingConfig as JaxTrainingConfig,
)
from hm_retrieval_tpu.serving.savedmodel_export import (  # noqa: E402
    export_index_savedmodel as jax_export,
)
from hm_retrieval_tpu.serving.service import (  # noqa: E402
    RetrievalService as JaxRetrievalService,
)
from hm_retrieval_tpu_torch.indices.brute_force import (  # noqa: E402
    BruteForceIndex,
)
from hm_retrieval_tpu_torch.indices.distributed import (  # noqa: E402
    DistributedBruteForceIndex,
)
from hm_retrieval_tpu_torch.indices.quantized import (  # noqa: E402
    QuantizedIndex,
)
from hm_retrieval_tpu_torch.models.bridge import tower_from_numpy  # noqa: E402
from hm_retrieval_tpu_torch.parallel import make_mesh  # noqa: E402
from hm_retrieval_tpu_torch.runners import modelling_runner  # noqa: E402
from hm_retrieval_tpu_torch.schema import (  # noqa: E402
    Feature,
    ModelConfig,
    Schema,
    TrainingConfig,
)
from hm_retrieval_tpu_torch.serving import (  # noqa: E402
    RetrievalService,
    export_index_savedmodel,
)
from tests.test_torch_runners import jax_stages  # noqa: F401, E402

N_ARTICLES, N_CUSTOMERS, E, K, MAX_LEN = 300, 40, 8, 10, 4
TOL = 1e-3
ARTICLES = [f"a{i:03d}" for i in range(N_ARTICLES)]
SPECS = [
    dict(name="customer_id", kind="categorical", family="query",
         embedding_size=E, vocab=[f"c{i}" for i in range(N_CUSTOMERS)]),
    dict(name="age", kind="numeric", family="query", standardize=True,
         mean=40.0, std=12.0),
    dict(name="history", kind="sequence", family="query", embedding_size=E,
         max_len=MAX_LEN, vocab=ARTICLES),
    dict(name="recent", kind="sequence", family="query", embedding_size=4,
         max_len=MAX_LEN, vocab=ARTICLES, pooling="attention"),
    dict(name="article_id", kind="categorical", family="candidate",
         embedding_size=E, vocab=ARTICLES),
]


def schemas():
    args = dict(candidate_id_col="article_id")
    jax_schema = JaxSchema([JaxFeature(**s) for s in SPECS],
                           JaxModelConfig(E, ks=[K], query_tower_units=[16]),
                           JaxTrainingConfig(), **args)
    port_schema = Schema([Feature(**s) for s in SPECS],
                         ModelConfig(E, ks=[K], query_tower_units=[16]),
                         TrainingConfig(), **args)
    return jax_schema, port_schema


def requests():
    hist = [["a001", "a005", "a005"], [], ["a002", "never", "a009", "a000"],
            ["a299"], ["a100", "a101", "a102", "a103"], [], ["zzz"]]
    return {
        "customer_id": ["c1", "c5", "never", "c2", "c3", "c39", "c0"],
        "age": [25.0, float("nan"), 63.0, 1e3, -1e3, 40.0, -3.5],
        "history": hist,
        "recent": hist[::-1],
    }


def padded(histories):
    out = np.full((len(histories), MAX_LEN), "", dtype=object)
    for r, h in enumerate(histories):
        out[r, :len(h)] = h
    return out.astype(str)


def serve(path, raw):
    fn = tf.saved_model.load(path).signatures["serving_default"]
    got = fn(customer_id=tf.constant([[v] for v in raw["customer_id"]]),
             age=tf.constant([[v] for v in raw["age"]], dtype=tf.float32),
             history=tf.constant(padded(raw["history"])),
             recent=tf.constant(padded(raw["recent"])))["candidate_ids"]
    return [[s.decode() for s in row] for row in got.numpy()]


@pytest.fixture(scope="module")
def weights():
    jax_schema, _ = schemas()
    model = JaxTwoTower(jax_schema.query_features,
                        jax_schema.candidate_features, "article_id", E,
                        [16], [16])
    params = jax.tree_util.tree_map(np.asarray, model.init_params(seed=0))
    rng = np.random.default_rng(0)
    params["query_tower"]["attention"]["recent"] = rng.normal(
        size=4).astype(np.float32)
    ids = np.arange(1, N_ARTICLES + 1, dtype=np.int32)
    emb = rng.normal(size=(N_ARTICLES, E)).astype(np.float32)
    return params["query_tower"], ids, emb


@pytest.fixture(scope="module")
def jax_exports(weights, tmp_path_factory):
    """The JAX package's SavedModel of the exact index (its export of a
    quantized index with a rescore table is the same graph), and the scores
    the tie rule reads: over the fp32 catalog and over the rescore-less
    quantized index's dequantized one (trap h: the packages quantize alike)."""
    tree, ids, emb = weights
    jax_schema, _ = schemas()
    root = tmp_path_factory.mktemp("jax_savedmodels")
    jax_export(jax_schema, tree, JaxBruteForceIndex(K, ids, emb),
               str(root / "exact"))
    quant = JaxQuantizedIndex(K, ids, emb, rescore=False)
    svc = JaxRetrievalService(jax_schema, tree, JaxBruteForceIndex(K, ids, emb))
    q = np.asarray(tower_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jax_schema.query_features,
        svc.encode_query(requests())), np.float64)
    deq = (np.asarray(quant.codes, np.float64)
           * np.asarray(quant.scales, np.float64)[:, None])[:N_ARTICLES]
    return {"exact": str(root / "exact"),
            "scores": {"exact": q @ emb.astype(np.float64).T,
                       "quantized": q @ deq.T}}


def top_k_strings(scores):
    """The K best articles of each row of fp64 scores, ties to the lower
    index."""
    order = np.argsort(-scores, axis=1, kind="stable")[:, :K]
    return [[ARTICLES[i] for i in row] for row in order]


def assert_same_answers(got, want, scores):
    """Equal strings, except a swap between two articles whose scores lie
    within TOL of the row's best."""
    row_of = {s: i for i, s in enumerate(ARTICLES)}
    assert len(got) == len(want)
    for r, (g_row, w_row) in enumerate(zip(got, want)):
        assert len(g_row) == len(w_row) == K and len(set(g_row)) == K
        scale = TOL * max(np.abs(scores[r]).max(), 1e-30)
        for g, w in zip(g_row, w_row):
            if g != w:
                assert abs(scores[r, row_of[g]]
                           - scores[r, row_of[w]]) <= scale, (r, g, w)


def port_index(kind, ids, emb):
    if kind == "exact":
        return BruteForceIndex(K, ids, emb, device="cpu")
    if kind == "quantized_rescore":
        return QuantizedIndex(K, ids, emb, device="cpu")
    if kind == "quantized":
        return QuantizedIndex(K, ids, emb, rescore=False, device="cpu")
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    return DistributedBruteForceIndex(K, ids, emb, mesh=mesh).to_local()


@pytest.mark.parametrize("kind", ["exact", "quantized_rescore", "quantized",
                                  "sharded"])
def test_the_port_answers_the_jax_export(weights, jax_exports, tmp_path,
                                         kind):
    """The port's SavedModel, from a ``Tower`` loaded through the bridge,
    answers the JAX export's strings; a quantized index with its rescore
    table ranks by the fp32 catalog (as JAX's export of one does), without
    it by the dequantized catalog; the sharded index exports through
    ``to_local()``."""
    tree, ids, emb = weights
    _, port_schema = schemas()
    tower = tower_from_numpy(port_schema.query_features, tree, "cpu")
    export_index_savedmodel(port_schema, tower, port_index(kind, ids, emb),
                            str(tmp_path / "port"))
    raw = requests()
    got = serve(str(tmp_path / "port"), raw)
    if kind == "quantized":  # the dequantized catalog's own ranking
        scores = jax_exports["scores"]["quantized"]
        assert_same_answers(got, top_k_strings(scores), scores)
        return
    scores = jax_exports["scores"]["exact"]
    assert_same_answers(got, serve(jax_exports["exact"], raw), scores)
    # and the port's own service over the same weights
    svc = RetrievalService(port_schema, tower, BruteForceIndex(
        K, ids, emb, device="cpu"), device="cpu")
    assert_same_answers(got, svc.retrieve(raw), scores)


def test_the_signatures_equal_jaxs(weights, jax_exports, tmp_path):
    tree, ids, emb = weights
    _, port_schema = schemas()
    export_index_savedmodel(port_schema, tree,
                            BruteForceIndex(K, ids, emb, device="cpu"),
                            str(tmp_path / "port"))
    got = tf.saved_model.load(str(tmp_path / "port")).signatures
    want = tf.saved_model.load(jax_exports["exact"]).signatures
    assert list(got) == list(want) == ["serving_default"]
    g, w = got["serving_default"], want["serving_default"]
    assert g.structured_input_signature == w.structured_input_signature
    assert g.structured_outputs == w.structured_outputs
    out = g(customer_id=tf.constant([["c1"], ["x"], ["c2"]]),
            age=tf.constant([[1.0], [2.0], [3.0]]),
            history=tf.constant(padded([[], [], []])),
            recent=tf.constant(padded([[], [], []])))["candidate_ids"]
    assert out.shape == (3, K) and out.dtype == tf.string


def test_nan_and_infinite_ages_read_as_in_the_jax_export(weights,
                                                        jax_exports,
                                                        tmp_path):
    """In both exports a NaN age standardizes to 0, the mean's answer, and
    an infinite one clips to the float32 extremes instead of flowing on as
    inf: K distinct articles. (There the scores overflow float32, where the
    two packages' sums need not agree.)"""
    tree, ids, emb = weights
    _, port_schema = schemas()
    export_index_savedmodel(port_schema, tree,
                            BruteForceIndex(K, ids, emb, device="cpu"),
                            str(tmp_path / "port"))
    raw = dict(customer_id=["c1"] * 4, history=[["a001"]] * 4,
               recent=[["a002", "a003"]] * 4,
               age=[float("nan"), 40.0, float("inf"), float("-inf")])
    for path in (str(tmp_path / "port"), jax_exports["exact"]):
        got = serve(path, raw)
        assert got[0] == got[1]
        assert all(len(set(row)) == K and "<OOV>" not in row
                   for row in got[2:])


def test_ids_outside_the_vocab_decode_to_oov(weights, tmp_path):
    tree, _, emb = weights
    jax_schema, port_schema = schemas()
    rogue = np.arange(N_ARTICLES + 1, 2 * N_ARTICLES + 1, dtype=np.int32)
    rogue[:5] = [-1, 0, -7, 10**6, N_ARTICLES + 1]
    jax_export(jax_schema, tree, JaxBruteForceIndex(K, rogue, emb),
               str(tmp_path / "jax"))
    export_index_savedmodel(port_schema, tree,
                            BruteForceIndex(K, rogue, emb, device="cpu"),
                            str(tmp_path / "port"))
    raw = requests()
    got = serve(str(tmp_path / "port"), raw)
    assert got == serve(str(tmp_path / "jax"), raw)
    assert {s for row in got for s in row} == {"<OOV>"}


def test_an_unexportable_schema_raises(weights, tmp_path):
    tree, ids, emb = weights
    specs = [dict(s, mean=None) if s["name"] == "age" else s for s in SPECS]
    schema = Schema([Feature(**s) for s in specs], ModelConfig(E, ks=[K]),
                    TrainingConfig(), candidate_id_col="article_id")
    with pytest.raises(ValueError, match="train statistics"):
        export_index_savedmodel(schema, tree,
                                BruteForceIndex(K, ids, emb, device="cpu"),
                                str(tmp_path / "x"))
    assert not (tmp_path / "x").exists()


# --- the runner -------------------------------------------------------------------


def test_the_runner_exports_over_a_mesh(jax_stages, tmp_path):  # noqa: F811
    """``modelling_runner`` over a (1, 2) mesh, customer_id row-sharded, the
    sharded index: the SavedModel (unpadded tower, ``to_local()`` catalog)
    answers as the service over the runner's own artifacts."""
    settings = dataclasses.replace(
        jax_stages,
        checkpoint_dirpath=str(tmp_path / "ckpt"),
        model_dirpath=str(tmp_path / "model"),
        index_dirpath=str(tmp_path / "index"),
        savedmodel_dirpath=str(tmp_path / "savedmodel"),
    )
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    modelling_runner(settings, mesh=mesh, distributed_index=True,
                     device="cpu",
                     training_overrides={
                         "epochs": 1,
                         "sharded_embedding_features": ["customer_id"]})
    svc = RetrievalService.load(settings.schema_dirpath,
                                settings.model_dirpath,
                                settings.index_dirpath, device="cpu")
    cust = svc.schema.feature("customer_id").vocab[:6].tolist() + ["nope"]
    want = svc.retrieve({"customer_id": cust})
    fn = tf.saved_model.load(settings.savedmodel_dirpath).signatures[
        "serving_default"]
    got = fn(customer_id=tf.constant([[c] for c in cust]))["candidate_ids"]
    got = [[s.decode() for s in row] for row in got.numpy()]
    q = svc.embed(svc.encode_query({"customer_id": cust})).double()
    emb = svc.index.embeddings[:svc.index.num_candidates].double()
    scores = (q @ emb.T).numpy()
    vocab = svc.schema.candidate_id_feature.vocab.tolist()
    row_of = {s: vocab.index(s) for row in got + want for s in row}
    for r, (g_row, w_row) in enumerate(zip(got, want)):
        assert len(g_row) == len(w_row) == len(set(g_row))
        scale = TOL * max(np.abs(scores[r]).max(), 1e-30)
        for g, w in zip(g_row, w_row):
            assert g == w or abs(scores[r, row_of[g]]
                                 - scores[r, row_of[w]]) <= scale


def test_without_tensorflow_the_runner_raises_before_any_step(
        jax_stages, tmp_path, monkeypatch):  # noqa: F811
    from hm_retrieval_tpu_torch.runners import modelling

    def no_trainer(*args, **kwargs):
        raise AssertionError("a trainer was built")

    monkeypatch.setattr(modelling, "make_single_device_trainer", no_trainer)
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    settings = dataclasses.replace(
        jax_stages, checkpoint_dirpath=str(tmp_path / "ckpt"),
        savedmodel_dirpath=str(tmp_path / "savedmodel"))
    with pytest.raises(ImportError, match="tensorflow"):
        modelling_runner(settings, device="cpu")
    assert not os.path.exists(tmp_path / "ckpt")
    assert not os.path.exists(tmp_path / "savedmodel")
