"""The port's index builds and streaming evaluation against the JAX
package's (``indices/builder.py``, ``build_from_batches`` / ``query``,
``runners/modelling.py::build_index`` + ``evaluate``).

The towers carry integer-valued parameters (tables in [-2, 2], weights in
{-1, 0, 1}, zero biases, no hidden layer), moved across by the bridge: every
embedding is then a small integer, exact in bf16, and every score an exact
integer in fp32 in any summation order. So both packages see the same
scores, and ids and recall dicts must be equal where both order ties the
same way: the "full" paths by catalog row, the bin-max paths (the port's
plain versions on the CPU, the JAX package's Pallas drivers in interpret
mode) by bin, then row.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu import indices as jax_indices
from hm_retrieval_tpu.data.dataset import ShardDataset as JaxShardDataset
from hm_retrieval_tpu.indices.brute_force import (
    BruteForceIndex as JaxBruteForceIndex,
)
from hm_retrieval_tpu.indices.builder import (
    collect_catalog as jax_collect_catalog,
    collect_catalog_device as jax_collect_catalog_device,
    iter_embedded_blocks as jax_iter_embedded_blocks,
)
from hm_retrieval_tpu.indices.quantized import QuantizedIndex as JaxQuantized
from hm_retrieval_tpu.models import TwoTowerModel as JaxTwoTower
from hm_retrieval_tpu.ops.pallas_retrieval import pallas_exact_topk
from hm_retrieval_tpu.runners import build_index as jax_build_index
from hm_retrieval_tpu.runners import evaluate as jax_evaluate
from hm_retrieval_tpu.schema.features import Feature as JaxFeature

from hm_retrieval_tpu_torch.data import MANIFEST_NAME, ShardDataset
from hm_retrieval_tpu_torch.indices import BruteForceIndex, QuantizedIndex
from hm_retrieval_tpu_torch.indices.builder import (
    collect_catalog,
    collect_catalog_device,
    iter_embedded_blocks,
)
from hm_retrieval_tpu_torch.models import TwoTowerModel, params_from_numpy
from hm_retrieval_tpu_torch.runners import build_index, evaluate
from hm_retrieval_tpu_torch.schema import Feature

E = 8
N_CUSTOMERS = 500
N_TYPES = 7
SHARD_ROWS = 97  # shards of uneven length


def _features(module, n_articles):
    def vocab(prefix, n):
        return np.array([f"{prefix}{i}" for i in range(n)])

    return (
        [module("customer_id", "categorical", "query", embedding_size=E,
                vocab=vocab("c", N_CUSTOMERS))],
        [module("article_id", "categorical", "candidate", embedding_size=E,
                vocab=vocab("a", n_articles)),
         module("product_type_name", "categorical", "candidate",
                embedding_size=4, vocab=vocab("p", N_TYPES))],
    )


def _integer_tree(model, rng):
    """A JAX-layout numpy tree of integer-valued parameters for ``model``."""
    tree = {}
    for name in ("query_tower", "candidate_tower"):
        tower = getattr(model, name)
        tree[name] = {
            "embeddings": {
                f: rng.integers(-2, 3, tuple(t.shape)).astype(np.float32)
                for f, t in tower.embeddings.items()
            },
            "dense": [
                {"w": rng.integers(-1, 2, tuple(layer.weight.shape[::-1]))
                 .astype(np.float32),
                 "b": np.zeros(layer.weight.shape[0], np.float32)}
                for layer in tower.dense
            ],
        }
    return tree


def _models(rng, n_articles):
    """(port model on the CPU, JAX model, JAX params): the same integer
    parameters on both sides."""
    port = TwoTowerModel(*_features(Feature, n_articles), "article_id", E,
                         device="cpu")
    tree = _integer_tree(port, rng)
    params_from_numpy(port, tree)
    jmodel = JaxTwoTower(*_features(JaxFeature, n_articles), "article_id", E)
    return port, jmodel, jax.tree.map(jnp.asarray, tree)


def _write_shards(dirpath, rows, num_rows=None):
    dirpath.mkdir(parents=True)
    n = len(next(iter(rows.values())))
    for s, lo in enumerate(range(0, n, SHARD_ROWS)):
        np.savez(dirpath / f"shard_{s:05d}.npz",
                 **{k: v[lo:lo + SHARD_ROWS] for k, v in rows.items()})
    (dirpath / MANIFEST_NAME).write_text(json.dumps({
        "num_rows": n if num_rows is None else num_rows,
        "num_shards": -(-n // SHARD_ROWS), "max_rows": SHARD_ROWS,
        "features": {k: str(v.dtype) for k, v in rows.items()}}))
    return str(dirpath)


def _data(rng, tmp_path, port, n_articles, n_test):
    """Candidate and test shards. Each test customer's true article sits at
    a random rank in [0, 150) of its exact scores, so recall@10 and @100
    count real hits."""
    types = rng.integers(1, N_TYPES + 1, n_articles + 1).astype(np.int32)
    ids = np.arange(1, n_articles + 1, dtype=np.int32)
    cand = {"article_id": ids, "product_type_name": types[ids]}
    customers = rng.integers(1, N_CUSTOMERS + 1, n_test).astype(np.int32)
    with torch.no_grad():
        q = port.query_forward({"customer_id": torch.tensor(customers)})
        c = port.candidate_forward({k: torch.tensor(v) for k, v in cand.items()})
    order = torch.sort(q @ c.T, dim=1, descending=True, stable=True)[1]
    rank = rng.integers(0, min(150, n_articles), n_test)
    true = ids[order[np.arange(n_test), rank].numpy()]
    test = {"customer_id": customers, "article_id": true,
            "product_type_name": types[true]}
    return (_write_shards(tmp_path / "cand", cand),
            _write_shards(tmp_path / "test", test))


class JaxPallasBruteForce(JaxBruteForceIndex):
    """The JAX index's "pallas" engine off a TPU: its driver in interpret
    mode, as the JAX package's own tests run it."""

    def topk_from_embeddings(self, query_embeddings):
        v, rows, _ = pallas_exact_topk(
            query_embeddings, self.embeddings[: self.num_candidates], self.k,
            keep_per_bin=2, interpret=True)
        return v, jnp.take(self.identifiers, rows)


class JaxPallasQuantized(JaxQuantized):
    """The JAX quantized index built with method "pallas" (interpret mode
    off a TPU)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **{**kwargs, "method": "pallas"})


JAX_PALLAS = {"brute_force": JaxPallasBruteForce,
              "quantized": JaxPallasQuantized}


# ----------------------------------------------------------------------
# indices/builder.py
# ----------------------------------------------------------------------
def _table_embed(rng, n, width=6):
    weights = rng.normal(size=(n + 1, width)).astype(np.float32)
    wt, wj = torch.tensor(weights), jnp.asarray(weights)
    calls = []

    def port(batch):
        calls.append(len(batch["row"]))
        return wt[torch.as_tensor(batch["row"]).long()] * 2.0

    def jax_fn(batch):
        return wj[jnp.asarray(batch["row"])] * 2.0

    return port, jax_fn, calls


def _row_batches(ids, sizes):
    lo = 0
    for size in sizes:
        yield {"article": ids[lo:lo + size], "row": np.arange(lo, lo + size) + 1}
        lo += size


@pytest.mark.parametrize("sizes", [(64, 64, 64, 8), (64, 100, 64, 30)])
def test_collect_catalog_matches_jax(rng, sizes):
    """The tail batch is padded then trimmed; an oversized batch (100 rows
    at batch size 64) passes through unpadded."""
    n = sum(sizes)
    ids = rng.permutation(n).astype(np.int32) + 5
    port_fn, jax_fn, calls = _table_embed(rng, n)
    host = collect_catalog("article", port_fn, _row_batches(ids, sizes), 64)
    dev = collect_catalog_device("article", port_fn, _row_batches(ids, sizes),
                                 64)
    want = jax_collect_catalog("article", jax_fn, _row_batches(ids, sizes), 64)
    want_dev = jax_collect_catalog_device("article", jax_fn,
                                          _row_batches(ids, sizes), 64)
    assert isinstance(host[1], np.ndarray) and host[1].dtype == np.float32
    assert isinstance(dev[1], torch.Tensor) and not dev[1].requires_grad
    for got_ids, got_emb in (host, (dev[0], dev[1].numpy())):
        np.testing.assert_array_equal(got_ids, want[0])
        np.testing.assert_array_equal(got_emb, want[1])
        np.testing.assert_array_equal(got_emb, np.asarray(want_dev[1]))
    assert calls == [max(s, 64) for s in sizes] * 2


def test_iter_embedded_blocks_embeds_lazily(rng):
    ids = np.arange(1, 151, dtype=np.int32)
    port_fn, jax_fn, calls = _table_embed(rng, 150)
    blocks = list(iter_embedded_blocks("article", port_fn,
                                       _row_batches(ids, (64, 64, 22)), 64))
    want = list(jax_iter_embedded_blocks("article", jax_fn,
                                         _row_batches(ids, (64, 64, 22)), 64))
    assert calls == []  # nothing embedded until a thunk runs
    assert [len(b) for b, _ in blocks] == [64, 64, 22]
    got = blocks[2][1]()
    assert calls == [64]  # the tail, padded to the batch size
    np.testing.assert_array_equal(blocks[2][0], want[2][0])
    np.testing.assert_array_equal(got.numpy(), want[2][1]())


# ----------------------------------------------------------------------
# build_from_batches + query
# ----------------------------------------------------------------------
@pytest.mark.parametrize("family", ["brute_force", "quantized"])
def test_build_from_batches_and_query_match_jax(rng, family):
    n_articles = 300
    port, jmodel, jparams = _models(rng, n_articles)
    ids = np.arange(1, n_articles + 1, dtype=np.int32)
    types = rng.integers(1, N_TYPES + 1, n_articles).astype(np.int32)

    def batches():
        for lo in range(0, n_articles, 128):
            yield {"article_id": ids[lo:lo + 128],
                   "product_type_name": types[lo:lo + 128]}

    def port_embed(b):
        return port.candidate_forward({k: torch.tensor(v) for k, v in b.items()})

    def jax_embed(b):
        return jmodel.candidate_forward(
            jparams, {k: jnp.asarray(v) for k, v in b.items()})

    cls = {"brute_force": BruteForceIndex, "quantized": QuantizedIndex}[family]
    got = cls.build_from_batches(20, "article_id", port_embed, batches(), 128,
                                 device="cpu", method="pallas")
    assert cls.supports_device_build and got._engine == "pallas"
    want = JAX_PALLAS[family].build_from_batches(20, "article_id", jax_embed, batches(), 128,
                                   device=True)
    n = got.num_candidates
    np.testing.assert_array_equal(got.identifiers[:n].numpy(),
                                  np.asarray(want.identifiers)[:n])
    if family == "brute_force":
        np.testing.assert_array_equal(got.embeddings[:n].numpy(),
                                      np.asarray(want.embeddings)[:n])
    else:
        np.testing.assert_array_equal(got.codes[:n].numpy(),
                                      np.asarray(want.codes)[:n])
        np.testing.assert_array_equal(got.scales[:n].numpy(),
                                      np.asarray(want.scales)[:n])
    customers = rng.integers(1, N_CUSTOMERS + 1, 9).astype(np.int32)
    got_ids = got.query(lambda b: port.query_forward(
        {"customer_id": torch.tensor(b)}), customers)
    want_ids = want.query(lambda b: jmodel.query_forward(
        jparams, {"customer_id": jnp.asarray(b)}), customers)
    assert not got_ids.requires_grad
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))


# ----------------------------------------------------------------------
# build_index + evaluate
# ----------------------------------------------------------------------
# (catalog rows, candidate batch, test rows, test batch, ks, exact engine);
# at 120 rows both packages take "full" and the quantized index keeps every
# row as a survivor; at 20,000 rows the port takes its kernel paths
# ("pallas", the plain versions on the CPU)
CASES = {
    "120": (120, 64, 300, 128, [10, 50], "full"),
    "20000": (20_000, 3000, 100, 64, [10, 100], "pallas"),
}


@pytest.mark.parametrize("index_type", ["brute_force", "quantized"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_index_and_evaluate_match_jax(rng, tmp_path, monkeypatch, case,
                                            index_type):
    """At 20,000 rows the JAX package off a TPU would take its
    "partial_reduce" (ties ordered by reduction bin) and "scan" (another
    survivor set) engines; the JAX side takes its "pallas" engines in
    interpret mode instead, as the port takes its kernel paths."""
    n_articles, cand_bs, n_test, test_bs, ks, engine = CASES[case]
    port, jmodel, jparams = _models(rng, n_articles)
    cand_dir, test_dir = _data(rng, tmp_path, port, n_articles, n_test)
    k = min(max(ks), n_articles)
    if case == "20000":
        monkeypatch.setitem(jax_indices.INDEX_TYPES, index_type,
                            JAX_PALLAS[index_type])
    index = build_index(port, ShardDataset(cand_dir), cand_bs, k,
                        index_type=index_type, device="cpu")
    # the quantized "auto" takes its kernels on every device (a deliberate
    # difference, ROADMAP.md Queue 3)
    assert index._engine == ("pallas" if index_type == "quantized" else engine)
    got = evaluate(port, index, ShardDataset(test_dir), test_bs, ks)
    jindex = jax_build_index(jmodel, jparams, JaxShardDataset(cand_dir),
                             cand_bs, k, index_type=index_type)
    want = jax_evaluate(jmodel, jparams, jindex, JaxShardDataset(test_dir),
                        test_bs, ks)
    assert got == want
    assert got[ks[-1]] > 0.3  # the true articles sit at ranks < 150


def test_build_index_takes_the_host_build_without_the_flag(rng, tmp_path,
                                                           monkeypatch):
    """A family that does not advertise ``supports_device_build`` is built
    from ``collect_catalog``'s host arrays, as the JAX package builds it, and
    indexes the same catalog as the device build."""
    received = []

    class HostBuilt(BruteForceIndex):
        supports_device_build = False

        def __init__(self, k, identifiers, embeddings, **kw):
            received.append(embeddings)
            super().__init__(k, identifiers, embeddings, **kw)

    port, _, _ = _models(rng, 120)
    cand_dir, test_dir = _data(rng, tmp_path, port, 120, 200)
    device_built = build_index(port, ShardDataset(cand_dir), 64, 50,
                               device="cpu")
    import hm_retrieval_tpu_torch.indices as port_indices

    monkeypatch.setitem(port_indices.INDEX_TYPES, "brute_force", HostBuilt)
    host_built = build_index(port, ShardDataset(cand_dir), 64, 50,
                             device="cpu")
    assert type(host_built) is HostBuilt
    assert len(received) == 1 and isinstance(received[0], np.ndarray)
    assert received[0].shape == (120, E)
    assert torch.equal(host_built.identifiers, device_built.identifiers)
    assert torch.equal(host_built.embeddings, device_built.embeddings)
    ks = [10, 50]
    assert (evaluate(port, host_built, ShardDataset(test_dir), 128, ks)
            == evaluate(port, device_built, ShardDataset(test_dir), 128, ks))


def test_evaluate_drops_ks_past_the_catalog(rng, tmp_path, caplog):
    port, jmodel, jparams = _models(rng, 120)
    cand_dir, test_dir = _data(rng, tmp_path, port, 120, 200)
    index = build_index(port, ShardDataset(cand_dir), 64, 120, device="cpu")
    with caplog.at_level(logging.WARNING):
        got = evaluate(port, index, ShardDataset(test_dir), 128, [10, 120, 500])
    assert "Dropping ks [500] > catalog size 120" in caplog.text
    jindex = jax_build_index(jmodel, jparams, JaxShardDataset(cand_dir), 64,
                             120)
    want = jax_evaluate(jmodel, jparams, jindex, JaxShardDataset(test_dir),
                        128, [10, 120, 500])
    assert got == want and set(got) == {10, 120}
    assert got[120] == 1.0


def test_a_stale_manifest_raises(rng, tmp_path):
    """A manifest counting fewer rows than the shards hold would silently
    drop eval rows: both packages raise."""
    port, jmodel, jparams = _models(rng, 120)
    cand_dir, _ = _data(rng, tmp_path, port, 120, 10)
    rows = {"customer_id": np.ones(300, np.int32),
            "article_id": np.ones(300, np.int32),
            "product_type_name": np.ones(300, np.int32)}
    stale = _write_shards(tmp_path / "stale", rows, num_rows=100)
    index = build_index(port, ShardDataset(cand_dir), 64, 50, device="cpu")
    with pytest.raises(RuntimeError, match="manifest is stale"):
        evaluate(port, index, ShardDataset(stale), 64, [10])
    jindex = jax_build_index(jmodel, jparams, JaxShardDataset(cand_dir), 64, 50)
    with pytest.raises(RuntimeError, match="manifest is stale"):
        jax_evaluate(jmodel, jparams, jindex, JaxShardDataset(stale), 64, [10])


def test_a_manifest_counting_more_rows_gives_the_same_recall(rng, tmp_path):
    """A manifest counting more rows than the shards hold: the JAX package
    feeds all-padding batches, which count nothing, and the port stops; the
    recall is the same."""
    port, jmodel, jparams = _models(rng, 120)
    cand_dir, test_dir = _data(rng, tmp_path, port, 120, 200)
    with open(f"{test_dir}/{MANIFEST_NAME}") as f:
        manifest = json.load(f)
    _write_shards(tmp_path / "long", {
        k: np.load(f"{test_dir}/shard_00000.npz")[k][:50]
        for k in ("customer_id", "article_id", "product_type_name")
    }, num_rows=manifest["num_rows"])
    index = build_index(port, ShardDataset(cand_dir), 64, 50, device="cpu")
    got = evaluate(port, index, ShardDataset(str(tmp_path / "long")), 16,
                   [10, 50])
    jindex = jax_build_index(jmodel, jparams, JaxShardDataset(cand_dir), 64, 50)
    want = jax_evaluate(jmodel, jparams, jindex,
                        JaxShardDataset(str(tmp_path / "long")), 16, [10, 50])
    assert got == want and got[50] > 0
