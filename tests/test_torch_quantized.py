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
from hm_retrieval_tpu_torch.ops import partial_reduce as pr
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


def _assert_scan_composition(idx, q, got):
    """The scan as plain steps: per chunk, the integer product scaled plus
    the bias, the bins of partial_reduce_plain at reduction_size(chunk,
    k_over), their stable top-k_over, the chunk offset, a stable merge;
    then the rescore (or the query scale). Bit for bit against ``got``."""
    qq, t = pq.quantize_queries(torch.tensor(q))
    L, r = pr.reduction_size(idx.chunk, idx.k_over, idx.recall_target)
    top_s = torch.full((len(q), idx.k_over), float("-inf"))
    top_i = torch.zeros((len(q), idx.k_over), dtype=torch.int32)
    for base in range(0, idx.codes.shape[0], idx.chunk):
        end = base + idx.chunk
        s = (pq._int_scores(qq, idx.codes[base:end]) * idx.scales[base:end]
             + idx._score_bias[base:end])
        bv, bi = pr.partial_reduce_plain(s, L, r)
        order = torch.sort(bv, dim=1, descending=True, stable=True).indices
        order = order[:, : idx.k_over]
        ms = torch.cat([top_s, bv.gather(1, order)], 1)
        mi = torch.cat([top_i, bi.gather(1, order) + base], 1)
        keep = torch.sort(ms, dim=1, descending=True, stable=True).indices
        top_s = ms.gather(1, keep[:, : idx.k_over])
        top_i = mi.gather(1, keep[:, : idx.k_over])
    if idx.embeddings is not None:
        want_v, rows = pq.rescore_survivors(
            torch.tensor(q), idx.embeddings, idx._score_bias, top_s, top_i,
            idx.k)
    else:
        want_v, rows = top_s[:, : idx.k] * t, top_i[:, : idx.k]
    assert torch.equal(got[0], want_v)
    assert torch.equal(got[1], idx.identifiers[rows.long()])


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
        """"pallas" against JAX's kernels in interpret mode. "scan" reduces
        each 3,072-row chunk to (768, 2) (approx_max_k at recall_target
        0.95), where JAX's CPU fallback keeps the exact top-40: held by its
        recall against JAX's answers and bit for bit against the port's
        plain composition of the same steps."""
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
        if method == "scan":
            assert pr.reduction_size(idx.chunk, idx.k_over, 0.95) == (768, 2)
            _assert_scan_composition(idx, q, got)
            recall = np.mean([len(set(a) & set(b)) / 10 for a, b in
                              zip(got[1].numpy(), np.asarray(want[1]))])
            assert recall >= idx.recall_target
            assert len(set(got[1][0].tolist())) == 10
            return
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

    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize("rescore", [True, False])
    @pytest.mark.parametrize("scale_mode", ["per_row", "global"])
    def test_scan_without_a_reduction_matches_jax(self, rng, kind, rescore,
                                                  scale_mode):
        """k = 100: 400 survivors of a 3,072-row chunk reduce nothing
        (r = 0, no launch), so the scan is the exact top-k_over, as JAX's."""
        ids, emb, q = _data(rng, kind)
        kw = dict(method="scan", scale_mode=scale_mode, rescore=rescore)
        idx = QuantizedIndex(100, ids, emb, device="cpu", **kw)
        assert pr.reduction_size(idx.chunk, idx.k_over, 0.95) == (3072, 0)
        want = JaxQuantized(100, ids, emb, **kw).topk_from_embeddings(
            jnp.asarray(q))
        got = idx.topk_from_embeddings(torch.tensor(q))
        ref = emb.astype(np.float64) if rescore else (
            idx.codes[: len(ids)].numpy().astype(np.float64)
            * idx.scales[: len(ids)].numpy()[:, None])
        _assert_same_topk(got, want, ids, (q.astype(np.float64), ref),
                          exact=kind == "integer")

    def test_scan_bins_at_its_own_shapes(self, rng, monkeypatch):
        """Each chunk of the scan reaches the kernel's wrapper once, at
        reduction_size(chunk, k_over), with the chunk's scores; its bins
        equal partial_reduce_plain's and the split model's at every plan."""
        ids, emb, q = _data(rng, "normal", n=9000)
        idx = QuantizedIndex(10, ids, emb, chunk=4096, method="scan",
                             device="cpu")
        L, r = pr.reduction_size(4096, 40, 0.95)
        assert (idx.k_over, L, r) == (40, 1024, 2)
        seen, wrapper = [], pr.partial_reduce

        def spy(x, L, r, split=None):
            out = wrapper(x, L, r, split)
            seen.append((x, L, r, out))
            return out

        monkeypatch.setattr(pr, "partial_reduce", spy)
        idx.topk_from_embeddings(torch.tensor(q))
        assert [(x.shape, L_, r_) for x, L_, r_, _ in seen] == (
            [((8, 4096), L, r)] * 3)
        last = seen[-1][0]
        assert torch.isneginf(last[:, 9000 - 8192:]).all()  # the pad rows
        for x, _, _, (v, i) in seen:
            want_v, want_i = pr.partial_reduce_plain(x, L, r)
            assert torch.equal(v, want_v) and torch.equal(i, want_i)
            for B in (1, 8, 1024):
                split = pr.split_plan(B, L, r, 132)
                sv, si = pr.partial_reduce_split_plain(x, L, r, split)
                assert torch.equal(sv.view(torch.int32),
                                   v.view(torch.int32))
                assert torch.equal(si, i)

    def test_scan_never_resurrects_minus_inf_survivors(self, rng):
        """Under a reduction ((768, 2)) with 3 finite rows for 40
        survivors: the 37 unfilled slots stay -inf through the rescore, and
        the 3 rows come back by their exact fp32 scores. Rows 0 and n - 1,
        where an unfilled slot's row lands, are among the finite ones."""
        ids, emb, q = _data(rng, "normal")
        idx = QuantizedIndex(10, ids, emb, method="scan", device="cpu")
        assert pr.reduction_size(idx.chunk, idx.k_over, 0.95)[1] > 0
        finite = np.array([0, 1234, len(ids) - 1])
        bias = torch.full_like(idx._score_bias, float("-inf"))
        bias[finite] = 0.0
        idx._score_bias = bias
        v, got = idx.topk_from_embeddings(torch.tensor(q))
        exact = q.astype(np.float64) @ emb[finite].astype(np.float64).T
        order = np.argsort(-exact, axis=1, kind="stable")
        np.testing.assert_allclose(
            v[:, :3].numpy(), np.take_along_axis(exact, order, 1), rtol=1e-5)
        np.testing.assert_array_equal(got[:, :3].numpy(), ids[finite][order])
        assert torch.isneginf(v[:, 3:]).all()

    def test_scan_recall_target_too_low_raises(self, rng, monkeypatch):
        """A recall_target that leaves fewer bins than k_over raises before
        any launch, as "approx" does."""
        ids, emb, q = _data(rng, "normal", n=20000)
        idx = QuantizedIndex(100, ids, emb, method="scan", recall_target=0.1,
                             device="cpu")
        assert pr.reduction_size(idx.chunk, idx.k_over, 0.1)[0] < idx.k_over
        calls = []
        monkeypatch.setattr(pr, "partial_reduce",
                            lambda *a, **kw: calls.append(a))
        with pytest.raises(ValueError, match="recall_target"):
            idx.topk_from_embeddings(torch.tensor(q))
        assert not calls

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
