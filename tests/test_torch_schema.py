"""The port's own copy of the schema (hm_retrieval_tpu_torch/schema) against
the JAX package's: the same encodings, and artifacts that load both ways.
Encodings are integers and strings, so they must be equal exactly."""

import numpy as np
import pytest

from hm_retrieval_tpu.schema import (
    Feature as JaxFeature,
    ModelConfig as JaxModelConfig,
    Schema as JaxSchema,
    TrainingConfig as JaxTrainingConfig,
)
from hm_retrieval_tpu_torch.schema import (
    Feature,
    ModelConfig,
    Schema,
    TrainingConfig,
)

VOCAB = np.array(["a1", "b2", "c3", "d4", "e5", "f6"])


def _features(cls):
    return [
        cls("customer_id", "categorical", "query", embedding_size=4,
            vocab=VOCAB),
        cls("age", "numeric", "query", standardize=True, mean=2.5, std=0.5),
        cls("purchase_history", "sequence", "query", embedding_size=4,
            max_len=3, shared_vocab_with="article_id", pooling="attention"),
        cls("article_id", "categorical", "candidate", embedding_size=4,
            vocab=VOCAB[::-1]),
    ]


def _schema(pkg):
    if pkg == "jax":
        return JaxSchema(
            _features(JaxFeature), JaxModelConfig(8, query_tower_units=[4]),
            JaxTrainingConfig(), logq=np.arange(7, dtype=np.float32),
        )
    return Schema(
        _features(Feature), ModelConfig(8, query_tower_units=[4]),
        TrainingConfig(), logq=np.arange(7, dtype=np.float32),
    )


@pytest.mark.parametrize(
    "tokens",
    [
        ["a1", "zz", "f6", "", "c3"],
        np.array(["b2", "b2", "nope"], dtype=object),
        np.array(["e5", "d4"]),
    ],
)
def test_encode_matches_jax(tokens):
    j, t = _features(JaxFeature)[0], _features(Feature)[0]
    np.testing.assert_array_equal(t.encode(tokens), j.encode(tokens))
    assert t.encode(tokens).dtype == np.int32


def test_encode_sequence_matches_jax():
    s = _schema("jax")
    p = _schema("torch")
    rows = [["a1", "b2", "c3", "d4"], [], None, float("nan"), ["zz", "f6"]]
    np.testing.assert_array_equal(
        p.feature("purchase_history").encode_sequence(rows),
        s.feature("purchase_history").encode_sequence(rows),
    )


def test_decode_and_numeric_match_jax():
    j, t = _features(JaxFeature), _features(Feature)
    ids = np.array([[0, 1, 6, 7, -3]])
    np.testing.assert_array_equal(t[0].decode(ids), j[0].decode(ids))
    vals = np.array([1.0, np.nan, 4.0], np.float32)
    np.testing.assert_array_equal(
        t[1].transform_numeric(vals), j[1].transform_numeric(vals)
    )


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_schema_artifact_loads_in_both_packages(tmp_path, writer):
    _schema(writer).save(str(tmp_path))
    a, b = JaxSchema.load(str(tmp_path)), Schema.load(str(tmp_path))
    assert [f.to_dict() for f in a.features] == [
        f.to_dict() for f in b.features
    ]
    assert a.model_config.to_dict() == b.model_config.to_dict()
    assert a.training_config.to_dict() == b.training_config.to_dict()
    np.testing.assert_array_equal(a.logq, b.logq)
    # the shared sequence vocab is wired to the candidate id vocab
    np.testing.assert_array_equal(
        b.feature("purchase_history").vocab, VOCAB[::-1]
    )
    assert [f.name for f in b.query_features] == [
        "customer_id", "age", "purchase_history"
    ]
    assert b.candidate_id_feature.name == "article_id"


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(kind="numeric", embedding_size=3),
        dict(kind="categorical"),
        dict(kind="sequence", embedding_size=3),
        dict(kind="categorical", embedding_size=3, pooling="attention"),
    ],
)
def test_feature_validation_matches_jax(kwargs):
    with pytest.raises(ValueError):
        JaxFeature("x", family="query", **kwargs)
    with pytest.raises(ValueError):
        Feature("x", family="query", **kwargs)
