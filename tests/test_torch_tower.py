"""The port's towers (hm_retrieval_tpu_torch/models) against the JAX
package's ``tower_forward`` on the same weights and inputs.

Weights are drawn by the JAX package's init (attention queries replaced by
non-zero values so attention pooling is exercised) and moved across with the
weight bridge. Tolerance: fp32, rtol=1e-5, atol=1e-6 (both sides run fp32
products on the CPU, in another summation order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.models.tower import init_tower_params, tower_forward
from hm_retrieval_tpu.models.two_tower import TwoTowerModel as JaxTwoTower
from hm_retrieval_tpu.runners.checkpoint import export_model as jax_export
from hm_retrieval_tpu.schema.features import Feature as JaxFeature
from hm_retrieval_tpu.utils.pytree_io import load_pytree_npz as jax_load_npz
from hm_retrieval_tpu_torch.models import (
    Tower,
    TwoTowerModel,
    params_from_numpy,
    params_to_numpy,
    tower_from_numpy,
)
from hm_retrieval_tpu_torch.runners.checkpoint import export_model
from hm_retrieval_tpu_torch.schema.features import Feature
from hm_retrieval_tpu_torch.utils.pytree_io import load_pytree_npz

RTOL, ATOL = 1e-5, 1e-6
VOCAB = np.array([f"tok{i}" for i in range(40)])


def _specs(pooling):
    return [
        dict(name="customer_id", kind="categorical", family="query",
             embedding_size=8, vocab=VOCAB),
        dict(name="age", kind="numeric", family="query", standardize=True,
             mean=30.0, std=5.0),
        dict(name="purchase_history", kind="sequence", family="query",
             embedding_size=6, vocab=VOCAB, max_len=5, pooling=pooling),
        dict(name="club", kind="categorical", family="query",
             embedding_size=4, vocab=VOCAB[:7]),
    ]


def _both(specs):
    return [JaxFeature(**s) for s in specs], [Feature(**s) for s in specs]


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng, B=9):
    hist = rng.integers(0, 41, size=(B, 5)).astype(np.int32)
    hist[0] = 0  # an all-pad history row
    hist[1, 2:] = 0  # a short history
    return {
        "customer_id": rng.integers(0, 41, size=B).astype(np.int32),
        "age": rng.normal(size=B).astype(np.float32),
        "purchase_history": hist,
        "club": rng.integers(0, 8, size=B).astype(np.int32),
    }


def _jax_params(features, seed, hidden, rng):
    params = _to_numpy(
        init_tower_params(jax.random.PRNGKey(seed), features, 12, hidden)
    )
    for name in params.get("attention", {}):
        params["attention"][name] = rng.normal(
            size=params["attention"][name].shape
        ).astype(np.float32)
    return params


@pytest.mark.parametrize("pooling", ["mean", "attention"])
@pytest.mark.parametrize("hidden", [None, [16], [16, 10]])
def test_query_tower_matches_jax(rng, pooling, hidden):
    jf, tf = _both(_specs(pooling))
    params = _jax_params(jf, 3, hidden, rng)
    batch = _batch(rng)
    want = np.asarray(
        tower_forward(params, jf, {k: jnp.asarray(v) for k, v in batch.items()})
    )
    tower = tower_from_numpy(tf, params, device="cpu")
    got = tower({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    assert (got >= 0).all()  # every layer ends in ReLU


def test_all_pad_attention_row_pools_to_zero(rng):
    from hm_retrieval_tpu.models.embedding import pool_sequence as jax_pool
    from hm_retrieval_tpu_torch.models.embedding import pool_sequence

    jf, tf = _both(_specs("attention"))
    ids = np.array([[0, 0, 0], [3, 0, 5]], np.int32)
    emb = rng.normal(size=(2, 3, 6)).astype(np.float32)
    w = rng.normal(size=6).astype(np.float32)
    want = np.asarray(
        jax_pool(jf[2], jnp.asarray(ids), jnp.asarray(emb),
                 {"purchase_history": jnp.asarray(w)})
    )
    got = pool_sequence(
        tf[2], torch.from_numpy(ids), torch.from_numpy(emb),
        torch.from_numpy(w),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[0], 0.0)


def test_candidate_tower_matches_jax(rng):
    specs = [
        dict(name="article_id", kind="categorical", family="candidate",
             embedding_size=8, vocab=VOCAB),
        dict(name="colour", kind="categorical", family="candidate",
             embedding_size=3, vocab=VOCAB[:5]),
    ]
    jf, tf = _both(specs)
    params = _jax_params(jf, 5, [32], rng)
    batch = {
        "article_id": rng.integers(0, 41, size=11).astype(np.int32),
        "colour": rng.integers(0, 6, size=11).astype(np.int32),
    }
    want = np.asarray(
        tower_forward(params, jf, {k: jnp.asarray(v) for k, v in batch.items()})
    )
    got = tower_from_numpy(tf, params, device="cpu")(
        {k: torch.from_numpy(v) for k, v in batch.items()}
    )
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


def _two_tower_features():
    specs = _specs("attention") + [
        dict(name="article_id", kind="categorical", family="candidate",
             embedding_size=8, vocab=VOCAB),
    ]
    jf, tf = _both(specs)
    return (jf[:4], jf[4:]), (tf[:4], tf[4:])


def test_bridge_round_trip_is_exact(rng):
    (jq, jc), (tq, tc) = _two_tower_features()
    jm = JaxTwoTower(jq, jc, "article_id", 12, [16], [16])
    params = _to_numpy(jm.init_params(seed=7))
    model = TwoTowerModel(tq, tc, "article_id", 12, [16], [16], device="cpu")
    back = params_to_numpy(params_from_numpy(model, params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_bridge_rejects_mismatched_shapes(rng):
    jf, tf = _both(_specs("mean"))
    params = _jax_params(jf, 0, [16], rng)
    tower = Tower(tf, 12, [10], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tower, params)


def test_port_init_follows_the_reference_scheme():
    (_, _), (tq, tc) = _two_tower_features()
    model = TwoTowerModel(tq, tc, "article_id", 12, [16], [16], device="cpu")
    a = params_to_numpy(model.init_params(seed=1))
    b = params_to_numpy(
        TwoTowerModel(tq, tc, "article_id", 12, [16], [16], device="cpu")
        .init_params(seed=1)
    )
    for tower in ("query_tower", "candidate_tower"):
        for name, table in a[tower]["embeddings"].items():
            assert np.abs(table).max() <= 0.05
            np.testing.assert_array_equal(table, b[tower]["embeddings"][name])
        for layer in a[tower]["dense"]:
            d_in, d_out = layer["w"].shape
            assert np.abs(layer["w"]).max() <= (6.0 / (d_in + d_out)) ** 0.5
            np.testing.assert_array_equal(layer["b"], 0.0)
    np.testing.assert_array_equal(
        a["query_tower"]["attention"]["purchase_history"], 0.0
    )


def test_init_draws_on_the_cpu_whatever_the_models_device():
    """init_params draws from a CPU generator and copies the draws to the
    model's device, so one seed gives the card and the CPU the same weights.
    On a model moved to the meta device, where no generator exists, it still
    runs: nothing is drawn there."""
    (_, _), (tq, tc) = _two_tower_features()
    model = TwoTowerModel(tq, tc, "article_id", 12, [16], [16], device="cpu")
    model.to("meta")
    model.device = torch.device("meta")
    with pytest.raises(RuntimeError):
        torch.Generator(device="meta")
    model.init_params(seed=1)
    assert all(p.device.type == "meta" for p in model.parameters())


def test_export_layout_loads_in_both_packages(tmp_path, rng):
    (jq, jc), (tq, tc) = _two_tower_features()
    model = TwoTowerModel(
        tq, tc, "article_id", 12, [16], [16], device="cpu"
    ).init_params(seed=2)
    export_model(model, str(tmp_path / "port"))
    jm = JaxTwoTower(jq, jc, "article_id", 12, [16], [16])
    jparams = jm.init_params(seed=2)
    jax_export(jparams, str(tmp_path / "jax"))
    for tower in ("two_tower", "query_tower", "candidate_tower"):
        port_file = str(tmp_path / "port" / tower / "params.npz")
        jax_file = str(tmp_path / "jax" / tower / "params.npz")
        assert os.path.exists(port_file)
        ja = jax_load_npz(port_file)  # the JAX loader reads the port's
        pa = load_pytree_npz(jax_file)  # and the reverse
        shapes_a = [x.shape for x in jax.tree_util.tree_leaves(ja)]
        shapes_b = [x.shape for x in jax.tree_util.tree_leaves(pa)]
        assert shapes_a == shapes_b
    # the JAX forward on the port's exported query tower == the port's
    batch = _batch(rng)
    tree = jax_load_npz(str(tmp_path / "port" / "query_tower" / "params.npz"))
    want = np.asarray(
        tower_forward(tree, jq, {k: jnp.asarray(v) for k, v in batch.items()})
    )
    got = model.query_forward({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
