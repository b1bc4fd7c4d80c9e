"""The port's QuantizedIndex with the int8 refinement rounds
(``method="pallas"``, ``pallas_rounds > 1``) held against the JAX package's
on the same catalogs, its artifact read and written by both packages, and
RetrievalService over such an artifact.

The JAX index runs its Pallas kernels in interpret mode on the CPU; the
port's wrappers run their plain versions.

Tolerances as in test_torch_quantized: integer-valued catalogs and queries
make every score exact in both packages, so scores and ids must be equal bit
for bit; for normal inputs scores agree within 1e-5 relative, and ids
wherever the competing scores differ by more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.indices import load_index as jax_load_index
from hm_retrieval_tpu.indices.quantized import QuantizedIndex as JaxQuantized
from hm_retrieval_tpu.models.tower import tower_forward
from hm_retrieval_tpu.serving.service import (
    RetrievalService as JaxRetrievalService,
)
from hm_retrieval_tpu_torch.indices import load_index
from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
from hm_retrieval_tpu_torch.ops import quantized_topk as qt
from hm_retrieval_tpu_torch.serving import RetrievalService
from test_torch_quantized import _assert_same_arrays, _assert_same_topk, _data
from test_torch_serving import (
    K,
    N_ARTICLES,
    _assert_same_answers,
    _raw_queries,
    write_jax_serving_artifacts,
)

ROUNDS = 8


@pytest.fixture
def passes(monkeypatch):
    """Counts of the int8 rounds passes the index runs ("first", "refine")
    and the rounds that each call of its survivor driver reported."""
    from hm_retrieval_tpu_torch.indices import quantized as pq

    seen = {"first": 0, "refine": 0, "rounds": []}

    def counting(name, key):
        fn = getattr(qt, name)

        def run(*args, **kwargs):
            seen[key] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(qt, name, run)

    counting("bin_max2_scaled_first_round", "first")
    counting("bin_max2_scaled_round", "refine")

    def recording(*args, **kwargs):
        out = qt.quantized_topk(*args, **kwargs)
        seen["rounds"].append(out[2])
        return out

    monkeypatch.setattr(pq, "quantized_topk", recording)
    return seen


class TestIndexRounds:
    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize("rescore", [True, False])
    @pytest.mark.parametrize("scale_mode", ["per_row", "global"])
    def test_index_matches_jax(self, rng, passes, kind, rescore,
                               scale_mode):
        ids, emb, q = _data(rng, kind)
        kw = dict(method="pallas", pallas_rounds=ROUNDS, scale_mode=scale_mode,
                  rescore=rescore)
        jidx = JaxQuantized(10, ids, emb, **kw)
        idx = QuantizedIndex(10, ids, emb, device="cpu", **kw)
        assert (idx.method, idx.k_over, idx.pallas_rounds) == (
            jidx.method, jidx.k_over, jidx.pallas_rounds
        )
        _assert_same_arrays(idx, jidx)
        want = jidx.topk_from_embeddings(jnp.asarray(q))
        qt.reset_launches()
        got = idx.topk_from_embeddings(torch.tensor(q))
        assert set(qt.LAUNCHES.values()) == {0}  # the CPU runs the plain path
        assert passes["first"] == 1
        assert passes["refine"] == passes["rounds"][0] - 1
        if rescore:
            ref = emb.astype(np.float64)
        else:  # ranked by the dequantized scores
            ref = idx.codes[: len(ids)].numpy().astype(np.float64) * (
                idx.scales[: len(ids)].numpy()[:, None]
            )
        _assert_same_topk(got, want, ids, (q.astype(np.float64), ref),
                          exact=kind == "integer")
        assert len(set(got[1][0].tolist())) == 10

    def test_answers_are_the_exact_dequantized_top_k(self, rng, passes):
        """Where the stop rule holds, the answer without rescore is the
        exact top-k of the dequantized scores of the bf16 queries."""
        ids, emb, q = _data(rng, "normal", n=2000, b=16)
        idx = QuantizedIndex(20, ids, emb, method="pallas", rescore=False,
                             pallas_rounds=ROUNDS, device="cpu")
        s, _ = idx.topk_from_embeddings(torch.tensor(q))
        assert 1 < passes["rounds"][0] < ROUNDS
        deq = idx.codes[:2000].numpy().astype(np.float64) * (
            idx.scales[:2000].numpy()[:, None].astype(np.float64)
        )
        qb = torch.tensor(q).bfloat16().double().numpy()
        scores = qb @ deq.T
        want = np.sort(scores, axis=1)[:, ::-1][:, :20]
        np.testing.assert_allclose(s.numpy(), want, rtol=1e-5)

    def test_rounds_cap_is_pallas_rounds(self, rng, passes):
        """The 8 best rows of every query share bin 7 of the 384 bins that
        40 survivors take: keep 2 needs more than 2 rounds to reveal them,
        and pallas_rounds=2 cuts the loop there."""
        ids, emb, q = _data(rng, "normal", n=3000)
        q = np.abs(q) + 0.1
        for j in range(8):
            emb[7 + j * 384] = 20.0 - j
        for rounds in (2, ROUNDS):
            idx = QuantizedIndex(10, ids, emb, method="pallas",
                                 pallas_rounds=rounds, device="cpu")
            assert idx.k_over == 40
            s, _ = idx.topk_from_embeddings(torch.tensor(q))
        assert passes["rounds"] == [2, 5]
        want = np.sort(q.astype(np.float64) @ emb.astype(np.float64).T,
                       axis=1)[:, ::-1][:, :10]
        np.testing.assert_allclose(s.numpy(), want, rtol=1e-5)

    def test_query_from_batches_runs_the_rounds(self, rng, passes):
        ids, emb, q = _data(rng, "normal", n=700)
        weights = torch.tensor(emb)

        def embed(batch):
            return weights[torch.as_tensor(batch["row"]).long()]

        batches = ({"article": ids[s:s + 64],
                    "row": np.arange(s, min(s + 64, 700))}
                   for s in range(0, 700, 64))
        idx = QuantizedIndex.build_from_batches(
            5, "article", embed, batches, 64, device="cpu", method="pallas",
            pallas_rounds=ROUNDS,
        )
        got = idx.query(lambda b: torch.tensor(b), q)
        want = QuantizedIndex(5, ids, emb, method="pallas", device="cpu",
                              pallas_rounds=ROUNDS)
        np.testing.assert_array_equal(
            got.numpy(), want.topk_from_embeddings(torch.tensor(q))[1].numpy()
        )
        assert passes["first"] == 2  # one query block, two indices


class TestArtifactRounds:
    @pytest.mark.parametrize("scale_mode", ["per_row", "global"])
    def test_jax_artifact_loads_in_the_port(self, rng, tmp_path, scale_mode,
                                            passes):
        ids, emb, q = _data(rng, "integer", n=2500)
        jidx = JaxQuantized(6, ids, emb, method="pallas",
                            pallas_rounds=ROUNDS, scale_mode=scale_mode)
        jidx.save(str(tmp_path))
        idx = load_index(str(tmp_path), device="cpu")
        assert isinstance(idx, QuantizedIndex)
        assert (idx.method, idx.pallas_rounds, idx.scale_mode) == (
            "pallas", ROUNDS, scale_mode
        )
        _assert_same_arrays(idx, jidx)
        _assert_same_topk(idx.topk_from_embeddings(torch.tensor(q)),
                          jidx.topk_from_embeddings(jnp.asarray(q)), ids,
                          None, exact=True)
        assert passes["first"] == 1

    @pytest.mark.parametrize("rescore", [True, False])
    def test_port_artifact_loads_in_jax(self, rng, tmp_path, rescore):
        ids, emb, q = _data(rng, "integer", n=2500)
        idx = QuantizedIndex(6, ids, emb, method="pallas", rescore=rescore,
                             pallas_rounds=ROUNDS, device="cpu")
        idx.save(str(tmp_path))
        back = jax_load_index(str(tmp_path))
        assert isinstance(back, JaxQuantized)
        assert back.pallas_rounds == ROUNDS
        back.method = "pallas"  # what the JAX package serves on a TPU
        again = load_index(str(tmp_path), device="cpu")
        assert again.pallas_rounds == ROUNDS
        _assert_same_topk(again.topk_from_embeddings(torch.tensor(q)),
                          back.topk_from_embeddings(jnp.asarray(q)), ids,
                          None, exact=True)


@pytest.fixture(scope="module")
def rounds_artifacts(tmp_path_factory):
    """Schema, towers and a method="pallas", pallas_rounds=8 quantized index
    written by the JAX package over the 20,000-article catalog of
    test_torch_serving."""
    rng = np.random.default_rng(2)
    root = tmp_path_factory.mktemp("jax_rounds_artifacts")
    ids, emb = write_jax_serving_artifacts(root, rng)
    JaxQuantized(K, ids, emb, method="pallas", pallas_rounds=ROUNDS).save(
        str(root / "index")
    )
    return {
        "schema": str(root / "schema"),
        "model": str(root / "model"),
        "index": str(root / "index"),
        "raw": _raw_queries(rng),
    }


def test_port_service_over_a_rounds_artifact(rounds_artifacts,
                                             passes):
    """RetrievalService.load over the JAX package's rounds artifact answers
    as the JAX package's functions do: encode_query -> tower_forward -> the
    quantized index's rounds -> decode."""
    art = rounds_artifacts
    jsvc = JaxRetrievalService.load(art["schema"], art["model"], art["index"])
    jidx = jsvc.index
    assert isinstance(jidx, JaxQuantized) and jidx.pallas_rounds == ROUNDS
    jidx.method = "pallas"  # what the JAX package serves on a TPU
    q_ref = tower_forward(jsvc.params, jsvc.schema.query_features,
                          jsvc.encode_query(art["raw"]))
    _, jids = jidx.topk_from_embeddings(q_ref)
    want = jsvc.schema.candidate_id_feature.decode(np.asarray(jids))

    svc = RetrievalService.load(art["schema"], art["model"], art["index"],
                                device="cpu")
    assert isinstance(svc.index, QuantizedIndex)
    assert (svc.index.method, svc.index.k_over, svc.index.pallas_rounds) == (
        "pallas", 4 * K, ROUNDS
    )
    got = svc.retrieve(art["raw"])
    assert passes["first"] == 1
    assert passes["refine"] == passes["rounds"][0] - 1
    with np.load(f"{art['index']}/index.npz") as z:
        emb = z["embeddings"]
    q64 = np.asarray(q_ref, np.float64)
    vocab = ["<OOV>"] + list(svc.schema.candidate_id_feature.vocab)
    _assert_same_answers(got, want, q64 @ emb.astype(np.float64).T, vocab)
    assert svc.index.num_candidates == N_ARTICLES
