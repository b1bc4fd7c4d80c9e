"""The port's QuantizedIndex (hm_retrieval_tpu_torch/indices/quantized.py)
held against the JAX package's on the same catalogs, its artifact read and
written by both packages, and RetrievalService over a quantized artifact.

The JAX index takes its kernel path on the CPU only when ``method="pallas"``
is given explicitly (its "auto" and its loader choose "scan" off a TPU), and
then runs its Pallas kernels in interpret mode.

Tolerances. Integer-valued catalogs and queries make every score exact in
both packages (integer dot products, one correctly rounded scale, an exact
fp32 rescore), so scores and ids must be equal bit for bit, ties included.
For normal inputs the two packages sum in another order: scores must agree
within 1e-5 relative (test_torch_bin_topk.TOL), and ids wherever the
competing scores differ by more.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.indices import load_index as jax_load_index
from hm_retrieval_tpu.indices import quantized as jq
from hm_retrieval_tpu.indices.quantized import QuantizedIndex as JaxQuantized
from hm_retrieval_tpu.models.tower import tower_forward
from hm_retrieval_tpu.serving.service import (
    RetrievalService as JaxRetrievalService,
)
from hm_retrieval_tpu_torch.indices import load_index
from hm_retrieval_tpu_torch.indices import quantized as pq
from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
from hm_retrieval_tpu_torch.ops import quantized_topk as qt
from hm_retrieval_tpu_torch.serving import RetrievalService
from test_torch_bin_topk import _assert_same_ranking
from test_torch_serving import (
    K,
    N_ARTICLES,
    _assert_same_answers,
    _raw_queries,
    write_jax_serving_artifacts,
)


def _data(rng, kind, n=3000, e=16, b=8):
    ids = rng.permutation(n).astype(np.int32) + 7
    if kind == "integer":
        emb = rng.integers(-20, 21, size=(n, e)).astype(np.float32)
        q = rng.integers(-4, 5, size=(b, e)).astype(np.float32)
    else:
        emb = rng.normal(size=(n, e)).astype(np.float32)
        q = rng.normal(size=(b, e)).astype(np.float32)
    emb[5] = 0.0  # a zero row: scale 1, codes 0
    return ids, emb, q


def _assert_same_topk(got, want, ids, ref, exact):
    """got/want: (scores, identifiers); row r of the catalog has identifier
    ids[r]. ``ref`` is (q, catalog) in fp64, the scores the answers rank
    (fp32 rows, or the dequantized codes without rescore)."""
    row_of = np.zeros(ids.max() + 1, np.int64)
    row_of[ids] = np.arange(len(ids))
    scores = None if exact else ref[0] @ ref[1].T
    _assert_same_ranking(
        np.asarray(got[0]), row_of[np.asarray(got[1])],
        np.asarray(want[0]), row_of[np.asarray(want[1])], scores, exact,
    )


def _assert_same_arrays(port, jax_idx):
    for name in ("identifiers", "codes", "scales"):
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(jax_idx, name)),
            err_msg=name,
        )
    np.testing.assert_array_equal(
        port._score_bias.numpy(), np.asarray(jax_idx._score_bias)
    )
    if jax_idx.embeddings is None:
        assert port.embeddings is None
    else:
        np.testing.assert_array_equal(
            port.embeddings.numpy(), np.asarray(jax_idx.embeddings)
        )
    assert port.global_scale == jax_idx.global_scale


class TestQuantization:
    def test_quantize_rows_bit_identical(self, rng):
        emb = rng.normal(size=(500, 24)).astype(np.float32) * rng.lognormal(
            0, 2, (500, 1)
        ).astype(np.float32)
        emb[3] = 0.0
        for port_fn, jax_fn in (
            (pq.quantize_rows, jq.quantize_rows),
            (pq.quantize_rows_global, jq.quantize_rows_global),
        ):
            (pc, ps), (jc, js) = port_fn(emb), jax_fn(emb)
            np.testing.assert_array_equal(pc, jc)
            np.testing.assert_array_equal(ps, js)
            assert pc.dtype == np.int8 and np.asarray(ps).dtype == np.float32

    def test_query_scale_is_the_fp32_reciprocal_multiply(self, rng):
        """The JAX scan engine's ``max|q| / 127.0`` compiles on the CPU to
        a multiply by the fp32 reciprocal, which the port's scan engine
        computes; a true division differs in the last bit on some rows."""
        import jax

        q = rng.normal(size=(4096, 32)).astype(np.float32)
        t = np.asarray(jax.jit(
            lambda x: jnp.max(jnp.abs(x), axis=1, keepdims=True) / 127.0
        )(q))
        m = np.max(np.abs(q), axis=1, keepdims=True)
        np.testing.assert_array_equal(t, m * np.float32(1.0 / 127.0))
        assert np.any(t != m / np.float32(127.0))

    def test_round_half_to_even(self):
        # max |x| = 127 gives the global scale 127 * fp32(1/127) == 1.0
        emb = np.array([[127.0, 2.5, 3.5, -2.5, -0.5, 0.5]], np.float32)
        codes, g = pq.quantize_rows_global(emb)
        assert g == np.float32(1.0)
        np.testing.assert_array_equal(codes, [[127, 2, 4, -2, 0, 0]])
        dev = pq.quantize_pad_device(torch.tensor(emb), 1, "global", False)
        np.testing.assert_array_equal(dev[0].numpy(), codes)

    @pytest.mark.parametrize("scale_mode", ["per_row", "global"])
    @pytest.mark.parametrize("rescore", [True, False])
    def test_device_build_equals_jax_and_host(self, rng, scale_mode, rescore):
        ids, emb, _ = _data(rng, "normal", n=1500, e=32)
        emb *= rng.lognormal(0, 1, (len(emb), 1)).astype(np.float32)
        kw = dict(scale_mode=scale_mode, rescore=rescore, method="scan")
        dev = QuantizedIndex(5, ids, torch.tensor(emb), device="cpu", **kw)
        host = QuantizedIndex(5, ids, emb, device="cpu", **kw)
        jdev = JaxQuantized(5, ids, jnp.asarray(emb), **kw)
        jhost = JaxQuantized(5, ids, emb, **kw)
        for port, ref in ((dev, jdev), (host, jhost), (dev, jhost)):
            _assert_same_arrays(port, ref)
        assert dev.codes.shape[0] == 2048  # padded to the chunk


class TestIndexParity:
    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize("rescore", [True, False])
    @pytest.mark.parametrize(
        "method, scale_mode",
        [("pallas", "per_row"), ("pallas", "global"), ("scan", "per_row"),
         ("scan", "global")],
    )
    def test_index_matches_jax(self, rng, kind, rescore, method, scale_mode):
        ids, emb, q = _data(rng, kind)
        kw = dict(method=method, scale_mode=scale_mode, rescore=rescore)
        jidx = JaxQuantized(10, ids, emb, **kw)
        idx = QuantizedIndex(10, ids, emb, device="cpu", **kw)
        assert (idx.method, idx.k_over, idx.chunk) == (
            jidx.method, jidx.k_over, jidx.chunk
        )
        _assert_same_arrays(idx, jidx)
        want = jidx.topk_from_embeddings(jnp.asarray(q))
        got = idx.topk_from_embeddings(torch.tensor(q))
        if rescore:
            ref = emb.astype(np.float64)
        else:  # ranked by the dequantized scores
            ref = idx.codes[: len(ids)].numpy().astype(np.float64) * (
                idx.scales[: len(ids)].numpy()[:, None]
            )
        _assert_same_topk(got, want, ids, (q.astype(np.float64), ref),
                          exact=kind == "integer")
        assert got[1].dtype == torch.int32
        assert len(set(got[1][0].tolist())) == 10

    def test_pallas_survivors_cover_the_catalog(self, rng):
        """k_over covers every row: the rescore makes the answer the exact
        fp32 top-k, as in the JAX package."""
        ids, emb, q = _data(rng, "normal", n=150)
        idx = QuantizedIndex(30, ids, emb, oversample=5, method="pallas",
                             device="cpu")
        s, got = idx.topk_from_embeddings(torch.tensor(q))
        scores = q.astype(np.float64) @ emb.astype(np.float64).T
        want = ids[np.argsort(-scores, axis=1, kind="stable")[:, :30]]
        np.testing.assert_array_equal(got.numpy(), want)

    def test_explicit_fold(self, rng):
        ids, emb, q = _data(rng, "integer", n=5000)
        kw = dict(method="pallas", pallas_fold=4)
        want = JaxQuantized(10, ids, emb, **kw).topk_from_embeddings(
            jnp.asarray(q)
        )
        got = QuantizedIndex(10, ids, emb, device="cpu", **kw)
        got = got.topk_from_embeddings(torch.tensor(q))
        _assert_same_topk(got, want, ids, None, exact=True)

    def test_query_and_build_from_batches(self, rng):
        ids, emb, q = _data(rng, "normal", n=700)
        weights = torch.tensor(emb)

        def embed(batch):
            return weights[torch.as_tensor(batch["row"]).long()]

        batches = ({"article": ids[s:s + 64], "row": np.arange(s, min(s + 64, 700))}
                   for s in range(0, 700, 64))
        idx = QuantizedIndex.build_from_batches(
            5, "article", embed, batches, 64, device="cpu", method="pallas"
        )
        ref = QuantizedIndex(5, ids, emb, method="pallas", device="cpu")
        _assert_same_arrays(idx, ref)
        got = idx.query(lambda b: torch.tensor(b), q)
        np.testing.assert_array_equal(
            got.numpy(), ref.topk_from_embeddings(torch.tensor(q))[1].numpy()
        )

    def test_validation(self):
        ids = np.arange(10, dtype=np.int32)
        emb = np.ones((10, 4), np.float32)
        for kw in (dict(k=0), dict(k=11), dict(oversample=0),
                   dict(method="ivf"), dict(scale_mode="pq"),
                   dict(pallas_rounds=0),
                   dict(pallas_fold=2, pallas_rounds=2)):
            args = dict(k=2, identifiers=ids, embeddings=emb, device="cpu")
            args.update(kw)
            with pytest.raises(ValueError):
                QuantizedIndex(**args)


class TestDeliberateDifferences:
    """The port's choices where the JAX package's depend on a TPU."""

    def test_auto_takes_pallas_on_every_device(self, rng):
        ids, emb, _ = _data(rng, "normal", n=600)
        assert QuantizedIndex(10, ids, emb, device="cpu").method == "pallas"
        assert JaxQuantized(10, ids, emb).method == "scan"  # off a TPU

    def test_auto_shrinks_the_survivors_on_every_device(self, rng):
        ids, emb, _ = _data(rng, "normal", n=3000)
        idx = QuantizedIndex(600, ids, emb, oversample=4, device="cpu")
        assert (idx.method, idx.k_over) == ("pallas", 1200)
        jidx = JaxQuantized(600, ids, emb, oversample=4, method="pallas")
        assert (jidx.method, jidx.k_over) == ("pallas", 1200)
        scan = QuantizedIndex(600, ids, emb, method="scan", device="cpu")
        assert scan.k_over == 2400  # an explicit scan keeps the oversample

    def test_saved_pallas_stays_pallas(self, rng, tmp_path):
        ids, emb, _ = _data(rng, "normal", n=300)
        QuantizedIndex(4, ids, emb, method="pallas", device="cpu").save(
            str(tmp_path)
        )
        assert load_index(str(tmp_path), device="cpu").method == "pallas"
        assert jax_load_index(str(tmp_path)).method == "scan"


class TestArtifact:
    @pytest.mark.parametrize("rescore", [True, False])
    @pytest.mark.parametrize("scale_mode", ["per_row", "global"])
    def test_jax_artifact_loads_in_the_port(self, rng, tmp_path, rescore,
                                            scale_mode):
        ids, emb, q = _data(rng, "integer", n=2500)
        jidx = JaxQuantized(6, ids, emb, rescore=rescore, method="pallas",
                            scale_mode=scale_mode)
        jidx.save(str(tmp_path))
        idx = load_index(str(tmp_path), device="cpu")
        assert isinstance(idx, QuantizedIndex)
        assert (idx.method, idx.k_over, idx.chunk, idx.scale_mode) == (
            "pallas", jidx.k_over, jidx.chunk, scale_mode
        )
        _assert_same_arrays(idx, jidx)
        _assert_same_topk(idx.topk_from_embeddings(torch.tensor(q)),
                          jidx.topk_from_embeddings(jnp.asarray(q)), ids,
                          None, exact=True)

    @pytest.mark.parametrize("rescore", [True, False])
    @pytest.mark.parametrize("scale_mode", ["per_row", "global"])
    def test_port_artifact_loads_in_jax(self, rng, tmp_path, rescore,
                                        scale_mode):
        ids, emb, q = _data(rng, "normal", n=2500)
        kw = dict(rescore=rescore, method="pallas", scale_mode=scale_mode)
        idx = QuantizedIndex(6, ids, emb, device="cpu", **kw)
        idx.save(str(tmp_path / "port"))
        JaxQuantized(6, ids, emb, **kw).save(str(tmp_path / "jax"))
        for name in ("meta.json", "index.npz"):
            assert os.path.exists(tmp_path / "port" / name)
        metas = [json.loads((tmp_path / d / "meta.json").read_text())
                 for d in ("port", "jax")]
        assert metas[0] == metas[1]
        with np.load(tmp_path / "port" / "index.npz") as zp, np.load(
            tmp_path / "jax" / "index.npz"
        ) as zj:
            assert sorted(zp.files) == sorted(zj.files)
            for key in zj.files:
                assert zp[key].dtype == zj[key].dtype, key
                np.testing.assert_array_equal(zp[key], zj[key])
        back = jax_load_index(str(tmp_path / "port"))
        assert isinstance(back, JaxQuantized)
        np.testing.assert_array_equal(np.asarray(back.codes), idx.codes.numpy())
        again = load_index(str(tmp_path / "port"), device="cpu")
        _assert_same_arrays(again, back)
        np.testing.assert_array_equal(
            again.topk_from_embeddings(torch.tensor(q))[1].numpy(),
            idx.topk_from_embeddings(torch.tensor(q))[1].numpy(),
        )

    def test_load_keeps_the_saved_codes(self, rng, tmp_path):
        ids, emb, _ = _data(rng, "normal", n=400)
        idx = QuantizedIndex(3, ids, emb, method="scan", device="cpu")
        idx.codes[:400] = torch.flip(idx.codes[:400], [1])  # not requantizable
        idx.save(str(tmp_path))
        back = QuantizedIndex.load(str(tmp_path), device="cpu")
        assert torch.equal(back.codes, idx.codes)

    def test_static_index_is_not_ported(self, tmp_path):
        """The static artifact the JAX package writes (identifiers.npy and
        meta type "static") loads through load_index as a StaticIndex."""
        from hm_retrieval_tpu.indices.static_index import (
            StaticIndex as JaxStaticIndex,
        )
        from hm_retrieval_tpu_torch.indices import StaticIndex

        ids = np.array([7, 3, 11, 5], np.int32)
        JaxStaticIndex(ids).save(str(tmp_path))
        idx = load_index(str(tmp_path), device="cpu")
        assert isinstance(idx, StaticIndex)
        np.testing.assert_array_equal(idx.query(2, k=3).numpy(),
                                      np.tile(ids[:3], (2, 1)))

    def test_entry_points_raise_without_a_card(self, rng, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ids, emb, _ = _data(rng, "normal", n=64)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            QuantizedIndex(3, ids, emb)


@pytest.fixture(scope="module")
def quantized_artifacts(tmp_path_factory):
    """Schema, towers and a method="pallas" quantized index written by the
    JAX package over the 20,000-article catalog of test_torch_serving."""
    rng = np.random.default_rng(1)
    root = tmp_path_factory.mktemp("jax_quantized_artifacts")
    ids, emb = write_jax_serving_artifacts(root, rng)
    JaxQuantized(K, ids, emb, method="pallas").save(str(root / "index"))
    return {
        "schema": str(root / "schema"),
        "model": str(root / "model"),
        "index": str(root / "index"),
        "raw": _raw_queries(rng),
    }


def test_port_service_over_a_quantized_artifact(quantized_artifacts):
    """RetrievalService.load over the JAX package's quantized artifact
    answers as the JAX package's functions do: encode_query ->
    tower_forward -> the quantized index's kernel path -> decode."""
    art = quantized_artifacts
    jsvc = JaxRetrievalService.load(art["schema"], art["model"], art["index"])
    jidx = jsvc.index
    assert isinstance(jidx, JaxQuantized) and jidx.method == "scan"
    jidx.method = "pallas"  # what the JAX package serves on a TPU
    q_ref = tower_forward(jsvc.params, jsvc.schema.query_features,
                          jsvc.encode_query(art["raw"]))
    _, jids = jidx.topk_from_embeddings(q_ref)
    want = jsvc.schema.candidate_id_feature.decode(np.asarray(jids))

    svc = RetrievalService.load(art["schema"], art["model"], art["index"],
                                device="cpu")
    assert isinstance(svc.index, QuantizedIndex)
    assert (svc.index.method, svc.index.k_over) == ("pallas", 4 * K)
    plan = qt.single_pass_plan(len(art["raw"]["customer_id"]), 16, 4 * K,
                               svc.index.codes.shape[0])
    assert plan == (256, 16, 512)
    qt.reset_launches()
    got = svc.retrieve(art["raw"])
    assert set(qt.LAUNCHES.values()) == {0}  # the CPU runs the plain version
    with np.load(f"{art['index']}/index.npz") as z:
        emb = z["embeddings"]
    q64 = np.asarray(q_ref, np.float64)
    vocab = ["<OOV>"] + list(svc.schema.candidate_id_feature.vocab)
    _assert_same_answers(got, want, q64 @ emb.astype(np.float64).T, vocab)
    assert svc.retrieve(art["raw"], k=3) == [row[:3] for row in got]
    assert svc.index.num_candidates == N_ARTICLES
