"""The port's mesh-sharded indices against the JAX package's.

The cases of ``tests/test_distributed_index.py``, run by both packages on the
same numpy inputs: the port on ``make_mesh(..., devices=["cpu"] * 8)``, the
JAX package on the 8 host devices ``tests/conftest.py`` sets up, at the JAX
tests' sizes (N = 1500, E = 16). Tolerances:

- "xla" and "scan" (fp32 products in another summation order): scores
  within rtol 1e-5 / atol 1e-5, ids equal;
- "pallas" (the kernels' plain versions against the JAX kernels in
  interpret mode) on integer-valued inputs, whose bf16 products and fp32
  sums are exact: scores and ids bit for bit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.indices import (
    DistributedBruteForceIndex as JaxDistBF,
    DistributedQuantizedIndex as JaxDistQ,
    load_distributed_index as jax_load_distributed_index,
    load_index as jax_load_index,
)
from hm_retrieval_tpu.models import TwoTowerModel as JaxTwoTowerModel
from hm_retrieval_tpu.data.dataset import ShardDataset as JaxShardDataset
from hm_retrieval_tpu.parallel import make_mesh as jax_make_mesh
from hm_retrieval_tpu.runners import evaluate as jax_evaluate
from hm_retrieval_tpu.schema import Schema as JaxSchema
from hm_retrieval_tpu.serving.service import (
    RetrievalService as JaxRetrievalService,
)
from hm_retrieval_tpu.utils.pytree_io import load_pytree_npz
from hm_retrieval_tpu_torch.indices import (
    BruteForceIndex,
    DistributedBruteForceIndex,
    DistributedQuantizedIndex,
    QuantizedIndex,
    load_distributed_index,
    load_index,
)
from hm_retrieval_tpu_torch.indices.distributed import _shard_arrays_to_blocks
from hm_retrieval_tpu_torch.indices import quantized as pq
from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.ops import partial_reduce as pr
from hm_retrieval_tpu_torch.parallel import make_mesh
from hm_retrieval_tpu_torch.runners import evaluation_runner
from hm_retrieval_tpu_torch.schema import Schema
from hm_retrieval_tpu_torch.serving import RetrievalService
from test_torch_serving import (
    K as SERVE_K,
    _assert_same_answers,
    _raw_queries,
    write_jax_serving_artifacts,
)
from tests.test_torch_runners import pipeline, port_stages  # noqa: F401

RTOL = ATOL = 1e-5


def meshes(shape):
    """The JAX mesh and the port's CPU mesh of one (data, model) shape."""
    return (jax_make_mesh(data=shape[0], model=shape[1]),
            make_mesh(data=shape[0], model=shape[1], devices=["cpu"] * 8))


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(7)
    N, E = 1500, 16  # N not divisible by 8: shard padding in play
    emb = rng.normal(size=(N, E)).astype(np.float32)
    ids = np.arange(1, N + 1, dtype=np.int32)
    q = rng.normal(size=(8, E)).astype(np.float32)
    return ids, emb, q


@pytest.fixture(scope="module")
def int_catalog():
    """Integer-valued inputs in [-4, 4]: exact in bf16 and in fp32 sums,
    with ties."""
    rng = np.random.default_rng(11)
    N, E = 1500, 16
    emb = rng.integers(-4, 5, size=(N, E)).astype(np.float32)
    ids = np.arange(1, N + 1, dtype=np.int32)
    q = rng.integers(-4, 5, size=(8, E)).astype(np.float32)
    return ids, emb, q


def run_jax(index, q):
    s, i = index.topk_from_embeddings(jnp.asarray(q))
    return np.asarray(s), np.asarray(i)


def run_port(index, q):
    s, i = index.topk_from_embeddings(torch.from_numpy(q))
    return s.numpy(), i.numpy()


def assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1], want[1])


def assert_bitwise(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _batches_of(ids, batch_size):
    for s in range(0, len(ids), batch_size):
        yield {"article_id": ids[s : s + batch_size]}


def _embed_fn_for(emb, tensor):
    """Positional lookup 'tower' (ids 1..N, row i -> emb[i-1]); the pad rows
    (id 0) embed to 999, which the build must trim."""
    table = np.concatenate([np.full((1, emb.shape[1]), 999.0, np.float32),
                            emb])

    def embed(batch):
        rows = table[np.asarray(batch["article_id"])]
        return torch.from_numpy(rows) if tensor else jnp.asarray(rows)

    return embed


def build_both(cls_jax, cls_port, k, ids, emb, shape, batch_size, **kw):
    """The same streamed build in both packages."""
    jmesh, tmesh = meshes(shape)
    common = dict(num_candidates=len(ids), dim=emb.shape[1])
    jax_idx = cls_jax.build_from_batches(
        k, "article_id", _embed_fn_for(emb, False),
        _batches_of(ids, batch_size), batch_size, mesh=jmesh, **common, **kw)
    port_idx = cls_port.build_from_batches(
        k, "article_id", _embed_fn_for(emb, True),
        _batches_of(ids, batch_size), batch_size, mesh=tmesh, **common, **kw)
    return jax_idx, port_idx


class TestDistributedBruteForce:
    @pytest.mark.parametrize("shape", [(1, 8), (2, 4), (8, 1)])
    def test_xla_matches_jax(self, catalog, shape):
        ids, emb, q = catalog
        jmesh, tmesh = meshes(shape)
        want = run_jax(JaxDistBF(20, ids, emb, mesh=jmesh, method="xla"), q)
        got = run_port(
            DistributedBruteForceIndex(20, ids, emb, mesh=tmesh, method="xla"),
            q)
        assert_close(got, want)
        ref = BruteForceIndex(20, ids, emb, method="full", device="cpu")
        np.testing.assert_array_equal(
            got[1], ref.topk_from_embeddings(torch.from_numpy(q))[1].numpy())

    @pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
    def test_pallas_matches_jax_bit_for_bit(self, int_catalog, shape):
        ids, emb, q = int_catalog
        jmesh, tmesh = meshes(shape)
        want = run_jax(
            JaxDistBF(10, ids, emb, mesh=jmesh, method="pallas",
                      interpret=True), q)
        idx = DistributedBruteForceIndex(10, ids, emb, mesh=tmesh,
                                         method="pallas")
        assert idx._engine == "pallas"
        assert_bitwise(run_port(idx, q), want)

    def test_pallas_at_a_width_that_pads(self):
        """E = 20: with the bias column 21 columns, padded to 32 (the
        kernels' k step), bit for bit against the JAX kernels."""
        rng = np.random.default_rng(5)
        N, E = 700, 20
        emb = rng.integers(-4, 5, size=(N, E)).astype(np.float32)
        ids = np.arange(1, N + 1, dtype=np.int32)
        q = rng.integers(-4, 5, size=(6, E)).astype(np.float32)
        jmesh, tmesh = meshes((2, 4))
        want = run_jax(JaxDistBF(10, ids, emb, mesh=jmesh, method="pallas",
                                 interpret=True), q)
        assert_bitwise(run_port(DistributedBruteForceIndex(
            10, ids, emb, mesh=tmesh, method="pallas"), q), want)

    def test_pad_rows_and_empty_shards_in_the_kernels(self):
        """Trap k on a tiny catalog over 8 shards: N = 10 gives 2 rows a
        shard and shards 5-7 with none, so every pad row has its -inf bias
        in the bf16 operands, inside a chunk of the kernels, and k = 4 is
        larger than one shard's rows. Each shard's pass scores its pad rows
        exactly -inf (never NaN); the answers equal the JAX kernels'."""
        rng = np.random.default_rng(3)
        N, E, k = 10, 16, 4
        emb = rng.integers(-4, 5, size=(N, E)).astype(np.float32)
        ids = np.arange(1, N + 1, dtype=np.int32)
        q = rng.integers(-4, 5, size=(4, E)).astype(np.float32)
        jmesh, tmesh = meshes((1, 8))
        idx = DistributedBruteForceIndex(k, ids, emb, mesh=tmesh,
                                         method="pallas")
        want = run_jax(JaxDistBF(k, ids, emb, mesh=jmesh, method="pallas",
                                 interpret=True), q)
        got = run_port(idx, q)
        assert_bitwise(got, want)
        assert set(got[1].ravel()) <= set(ids)
        q_aug = torch.cat([torch.from_numpy(q), torch.ones(4, 1)], dim=1)
        for s in range(8):
            c_aug = torch.cat([idx._emb.shard(s), idx._bias.shard(s)[:, None]],
                              dim=1)
            scores = bt.plain_scores(q_aug.bfloat16(), c_aug.bfloat16())
            real = max(0, min(2, N - 2 * s))
            assert not torch.isnan(scores).any()
            assert torch.isneginf(scores[:, real:]).all()
            assert torch.isfinite(scores[:, :real]).all()
            v, _, _ = bt.exact_topk(q_aug, c_aug, 2)
            assert torch.isneginf(v[:, real:]).all()

    def test_query_batch_not_divisible_by_data_axis(self, catalog):
        """B = 5 on a data axis of 4: padded inside, sliced after."""
        ids, emb, q = catalog
        jmesh, tmesh = meshes((4, 2))
        want = run_jax(JaxDistBF(7, ids, emb, mesh=jmesh, method="xla"), q[:5])
        got = run_port(
            DistributedBruteForceIndex(7, ids, emb, mesh=tmesh, method="xla"),
            q[:5])
        assert got[0].shape == (5, 7)
        assert_close(got, want)

    def test_catalog_actually_sharded(self, catalog):
        ids, emb, _ = catalog
        _, tmesh = meshes((1, 8))
        idx = DistributedBruteForceIndex(10, ids, emb, mesh=tmesh)
        # 1500 rows pad to 1504 = 8 * 188
        assert {t.shape[0] for t in idx._emb.shards()} == {188}
        assert idx._emb.shape == (1504, 16)
        np.testing.assert_array_equal(idx._emb.numpy()[:1500], emb)
        bias = idx._bias.numpy()
        assert (bias[:1500] == 0).all() and np.isneginf(bias[1500:]).all()

    def test_auto_resolves_by_k_and_width(self, catalog):
        """"auto" takes the kernels whenever k fits the bins and E + 1
        padded to 16 fits the kernels, on every device."""
        ids, emb, _ = catalog
        _, tmesh = meshes((1, 8))
        assert DistributedBruteForceIndex(10, ids, emb,
                                          mesh=tmesh).method == "pallas"
        # 513 pads to 528: the kernels' sliced instance takes it
        assert DistributedBruteForceIndex(
            10, ids, np.zeros((len(ids), 512), np.float32),
            mesh=tmesh).method == "pallas"
        wide = np.zeros((len(ids), bt.KERNEL_MAX_E), np.float32)  # + 1: 8208
        assert DistributedBruteForceIndex(10, ids, wide,
                                          mesh=tmesh).method == "xla"
        idx = DistributedBruteForceIndex(10, ids, wide, mesh=tmesh,
                                         method="pallas")
        assert (idx.method, idx._engine) == ("pallas", "xla")

    def test_save_load_interchangeable_with_jax(self, catalog, tmp_path):
        """Either package's distributed save loads in the other, through
        load_index and load_distributed_index, with the same answers."""
        ids, emb, q = catalog
        jmesh, tmesh = meshes((2, 4))
        port = DistributedBruteForceIndex(10, ids, emb, mesh=tmesh,
                                          method="xla")
        want = run_port(port, q)
        port.save(str(tmp_path / "port"))
        JaxDistBF(10, ids, emb, mesh=jmesh, method="xla").save(
            str(tmp_path / "jax"))
        for d in ("port", "jax"):
            path = str(tmp_path / d)
            local = jax_load_index(path)
            np.testing.assert_array_equal(run_jax(local, q)[1], want[1])
            jd = jax_load_distributed_index(path, jmesh)
            assert_close(run_jax(jd, q), want)
            pd = load_distributed_index(path, tmesh)
            assert isinstance(pd, DistributedBruteForceIndex)
            assert_close(run_port(pd, q), want)
            pl = load_index(path, device="cpu")
            assert isinstance(pl, BruteForceIndex)
            np.testing.assert_array_equal(run_port(pl, q)[1], want[1])

    def test_validation(self, catalog):
        ids, emb, _ = catalog
        _, tmesh = meshes((1, 8))
        with pytest.raises(ValueError, match="mesh"):
            DistributedBruteForceIndex(10, ids, emb, mesh=None)
        with pytest.raises(ValueError, match="method"):
            DistributedBruteForceIndex(10, ids, emb, mesh=tmesh, method="nope")
        with pytest.raises(ValueError, match="exceeds"):
            DistributedBruteForceIndex(len(ids) + 1, ids, emb, mesh=tmesh)
        with pytest.raises(ValueError, match="divisible"):
            make_mesh(model=3, devices=["cpu"] * 8)


class TestDistributedQuantized:
    @pytest.mark.parametrize("shape", [(1, 8), (2, 4), (8, 1)])
    def test_scan_matches_jax(self, catalog, shape):
        """Shards of at most 1,500 rows at k_over 80 reduce nothing (r = 0),
        so the port's approx_max_k is the exact top-k_over, as JAX's
        lax.approx_max_k on the CPU."""
        ids, emb, q = catalog
        jmesh, tmesh = meshes(shape)
        want = run_jax(JaxDistQ(20, ids, emb, mesh=jmesh, method="scan"), q)
        got = run_port(
            DistributedQuantizedIndex(20, ids, emb, mesh=tmesh, method="scan"),
            q)
        assert_close(got, want)

    @pytest.mark.parametrize("rescore", [True, False])
    def test_scan_reduces_per_shard(self, rescore):
        """Shards of 5,000 rows (N = 19,998 over (2, 4), two pad rows) at
        k_over 40 reduce to (1280, 2), where JAX's CPU fallback keeps the
        exact top-40: held by recall >= recall_target against JAX's answers
        and bit for bit against the port's plain composition (per shard,
        partial_reduce_plain's bins, their stable top-k_over, the rescore or
        the query scale; then the shard-major stable merge)."""
        rng = np.random.default_rng(11)
        N, E, k, S = 19_998, 16, 10, 4
        emb = rng.normal(size=(N, E)).astype(np.float32)
        ids = np.arange(1, N + 1, dtype=np.int32)
        q = rng.normal(size=(32, E)).astype(np.float32)
        jmesh, tmesh = meshes((2, S))
        idx = DistributedQuantizedIndex(k, ids, emb, mesh=tmesh,
                                        method="scan", rescore=rescore)
        L, r = pr.reduction_size(5000, 4 * k, idx.recall_target)
        assert (L, r) == (1280, 2)
        got = run_port(idx, q)
        want = run_jax(JaxDistQ(k, ids, emb, mesh=jmesh, method="scan",
                                rescore=rescore), q)
        recall = np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(got[1], want[1])])
        assert recall >= idx.recall_target

        codes, scales, emb_s, ids_s, bias = idx._placed
        qt = torch.from_numpy(q)
        qq, t = pq.quantize_queries(qt)
        parts_v, parts_i = [], []
        for sh in range(S):
            b = bias.shard(sh)
            scores = pq._int_scores(qq, codes.shard(sh)) * scales.shard(sh) + b
            bv, bi = pr.partial_reduce_plain(scores, L, r)
            order = torch.sort(bv, dim=1, descending=True,
                               stable=True).indices[:, : 4 * k]
            cs, ci = bv.gather(1, order), bi.gather(1, order)
            if rescore:
                ls, li = pq.rescore_survivors(qt, emb_s.shard(sh), b, cs, ci,
                                              k)
            else:
                ls, li = cs[:, :k] * t, ci[:, :k]
            parts_v.append(ls)
            parts_i.append(ids_s.shard(sh)[li.long()])
        mv, mi = torch.cat(parts_v, 1), torch.cat(parts_i, 1)
        keep = torch.sort(mv, dim=1, descending=True, stable=True).indices
        assert_bitwise(got, (mv.gather(1, keep[:, :k]).numpy(),
                             mi.gather(1, keep[:, :k]).numpy()))

    def test_scan_never_resurrects_minus_inf_survivors(self, catalog):
        """Shards of 5,000 rows reduce ((1280, 2) at k_over 40) with 3
        finite rows each: the unfilled survivor slots stay -inf through the
        per-shard rescore, and the 6 finite rows come back first by their
        exact fp32 scores. Rows 0 and per - 1 of each shard, where an
        unfilled slot's row lands, are among the finite ones."""
        from hm_retrieval_tpu_torch.parallel.distributed_topk import (
            ShardedRows,
        )

        rng = np.random.default_rng(12)
        N, E, k = 10_000, 16, 10
        emb = rng.normal(size=(N, E)).astype(np.float32)
        ids = np.arange(1, N + 1, dtype=np.int32)
        q = rng.normal(size=(4, E)).astype(np.float32)
        tmesh = make_mesh(data=1, model=2, devices=["cpu"] * 2)
        idx = DistributedQuantizedIndex(k, ids, emb, mesh=tmesh,
                                        method="scan")
        assert pr.reduction_size(5000, 4 * k, 0.95) == (1280, 2)
        keep = np.array([0, 777, 4999])
        bias = torch.full((5000,), float("-inf"))
        bias[keep] = 0.0
        idx._placed = (*idx._placed[:4],
                       ShardedRows(tmesh, [bias.clone(), bias.clone()]))
        v, got = run_port(idx, q)
        finite = np.concatenate([keep, keep + 5000])
        exact = q.astype(np.float64) @ emb[finite].astype(np.float64).T
        order = np.argsort(-exact, axis=1, kind="stable")
        np.testing.assert_allclose(v[:, :6], np.take_along_axis(exact, order, 1),
                                   rtol=RTOL)
        np.testing.assert_array_equal(got[:, :6], ids[finite][order])
        assert np.isneginf(v[:, 6:]).all()

    @pytest.mark.parametrize("rounds", [1, 8])
    @pytest.mark.parametrize("rescore", [True, False])
    def test_pallas_matches_jax_bit_for_bit(self, int_catalog, rounds,
                                            rescore):
        ids, emb, q = int_catalog
        jmesh, tmesh = meshes((2, 4))
        want = run_jax(
            JaxDistQ(10, ids, emb, mesh=jmesh, method="pallas",
                     interpret=True, pallas_rounds=rounds, rescore=rescore), q)
        idx = DistributedQuantizedIndex(10, ids, emb, mesh=tmesh,
                                        method="pallas", pallas_rounds=rounds,
                                        rescore=rescore)
        assert idx._engine == "pallas"
        assert_bitwise(run_port(idx, q), want)

    def test_rescore_false_drops_fp32(self, catalog):
        ids, emb, q = catalog
        jmesh, tmesh = meshes((1, 8))
        idx = DistributedQuantizedIndex(10, ids, emb, mesh=tmesh,
                                        rescore=False, method="scan")
        assert idx._placed[2] is None
        got = run_port(idx, q)
        assert np.isfinite(got[0]).all()
        assert_close(got, run_jax(JaxDistQ(10, ids, emb, mesh=jmesh,
                                           rescore=False, method="scan"), q))

    @pytest.mark.parametrize("rescore", [True, False])
    def test_save_load_interchangeable_with_jax(self, catalog, tmp_path,
                                                rescore):
        ids, emb, q = catalog
        jmesh, tmesh = meshes((2, 4))
        port = DistributedQuantizedIndex(10, ids, emb, mesh=tmesh,
                                         method="scan", rescore=rescore)
        want = run_port(port, q)
        port.save(str(tmp_path / "port"))
        JaxDistQ(10, ids, emb, mesh=jmesh, method="scan",
                 rescore=rescore).save(str(tmp_path / "jax"))
        for d in ("port", "jax"):
            path = str(tmp_path / d)
            with np.load(f"{path}/index.npz") as z:
                assert ("embeddings" in z.files) == rescore
            assert_close(run_jax(jax_load_distributed_index(path, jmesh), q),
                         want)
            pd = load_distributed_index(path, tmesh)
            assert isinstance(pd, DistributedQuantizedIndex)
            assert pd.rescore == rescore
            assert_close(run_port(pd, q), want)
            local = load_index(path, device="cpu")
            assert isinstance(local, QuantizedIndex)
            assert local.num_candidates == len(ids)

    @pytest.mark.parametrize("rescore", [True, False])
    def test_large_k_oversample_shrinks_per_shard(self, rescore):
        """A per-shard k x oversample past every bin layout shrinks the
        survivors (N = 40,000 over 8 shards: per = 5000, k' = 2400 > 2048)
        as the JAX package does, with the same answers on integer inputs."""
        from hm_retrieval_tpu_torch.indices.quantized import shrink_survivors

        rng = np.random.default_rng(9)
        N, E, k = 40_000, 16, 600
        assert shrink_survivors(k, 4 * k, E) < 4 * k
        emb = rng.integers(-4, 5, size=(N, E)).astype(np.float32)
        ids = np.arange(1, N + 1, dtype=np.int32)
        q = rng.integers(-4, 5, size=(4, E)).astype(np.float32)
        jmesh, tmesh = meshes((1, 8))
        want = run_jax(JaxDistQ(k, ids, emb, mesh=jmesh, method="pallas",
                                interpret=True, rescore=rescore), q)
        got = run_port(DistributedQuantizedIndex(
            k, ids, emb, mesh=tmesh, method="pallas", rescore=rescore), q)
        assert got[0].shape == (4, k)
        assert_bitwise(got, want)


class TestShardedStreamingBuild:
    def test_quantized_matches_host_build_and_jax(self, catalog):
        ids, emb, q = catalog
        _, tmesh = meshes((2, 4))
        host = DistributedQuantizedIndex(10, ids, emb, mesh=tmesh,
                                         method="scan")
        stats = {}
        jax_idx, built = build_both(JaxDistQ, DistributedQuantizedIndex, 10,
                                    ids, emb, (2, 4), 128, method="scan",
                                    build_stats=stats)
        assert_close(run_port(built, q), run_port(host, q))
        assert_close(run_port(built, q), run_jax(jax_idx, q))
        np.testing.assert_array_equal(built._placed[0].numpy(),
                                      host._placed[0].numpy())
        np.testing.assert_array_equal(built._placed[0].numpy(),
                                      np.asarray(jax_idx._placed[0]))
        np.testing.assert_array_equal(built._placed[1].numpy(),
                                      np.asarray(jax_idx._placed[1]))
        assert stats["embedded_blocks"] == -(-len(ids) // 128)

    def test_brute_force_matches_host_build_and_jax(self, catalog):
        ids, emb, q = catalog
        _, tmesh = meshes((1, 8))
        host = DistributedBruteForceIndex(10, ids, emb, mesh=tmesh,
                                          method="xla")
        jax_idx, built = build_both(JaxDistBF, DistributedBruteForceIndex, 10,
                                    ids, emb, (1, 8), 256, method="xla")
        assert_bitwise(run_port(built, q), run_port(host, q))
        assert_close(run_port(built, q), run_jax(jax_idx, q))

    def test_device_peak_is_one_shard_over_the_index(self, catalog):
        """The build holds its finished shards, one shard buffer and one
        shard's temporaries on the devices, never a catalog-sized copy on
        the host (where the JAX package reports its host peak)."""
        ids, emb, _ = catalog
        _, tmesh = meshes((1, 8))
        stats = {}
        DistributedQuantizedIndex.build_from_batches(
            10, "article_id", _embed_fn_for(emb, True), _batches_of(ids, 128),
            128, mesh=tmesh, num_candidates=len(ids), dim=emb.shape[1],
            build_stats=stats, method="scan")
        per = stats["rows_per_shard"]
        assert per == -(-len(ids) // 8)
        shard_fp32 = per * emb.shape[1] * 4
        assert stats["placed_bytes"] < stats["peak_device_bytes"]
        assert stats["peak_device_bytes"] <= stats["placed_bytes"] + shard_fp32

    def test_tiny_catalog_with_empty_trailing_shards(self):
        """N = 10 over 8 shards (per = 2, shards 5-7 empty): every shard is
        finished, no pad row surfaces, as in the JAX package."""
        rng = np.random.default_rng(3)
        N, E, k = 10, 16, 4
        emb = rng.normal(size=(N, E)).astype(np.float32)
        ids = np.arange(1, N + 1, dtype=np.int32)
        q = rng.normal(size=(4, E)).astype(np.float32)
        jax_idx, built = build_both(JaxDistQ, DistributedQuantizedIndex, k,
                                    ids, emb, (1, 8), 4, method="scan")
        ref = QuantizedIndex(k, ids, emb, method="scan", device="cpu")
        got = run_port(built, q)
        np.testing.assert_array_equal(
            got[1], ref.topk_from_embeddings(torch.from_numpy(q))[1].numpy())
        assert_close(got, run_jax(jax_idx, q))
        assert got[1].max() <= N and got[1].min() >= 1

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_sharded_artifact_load_onto_wider_mesh(self, tmp_path, writer):
        """A 12-row sharded artifact written on model = 4 (by either
        package) loads onto a model = 8 mesh whose trailing shards are all
        padding."""
        rng = np.random.default_rng(4)
        N, E, k = 12, 8, 3
        emb = rng.normal(size=(N, E)).astype(np.float32)
        ids = np.arange(1, N + 1, dtype=np.int32)
        q = rng.normal(size=(4, E)).astype(np.float32)
        jax_idx, built = build_both(JaxDistQ, DistributedQuantizedIndex, k,
                                    ids, emb, (2, 4), 4, method="scan")
        d = str(tmp_path / "tiny")
        (built if writer == "port" else jax_idx).save(d)
        want = run_port(built, q)
        jmesh8, tmesh8 = meshes((1, 8))
        assert_close(run_port(load_distributed_index(d, tmesh8,
                                                     method="scan"), q), want)
        assert_close(run_jax(jax_load_distributed_index(d, jmesh8,
                                                        method="scan"), q),
                     want)

    def test_counts_rows_when_num_candidates_absent(self, catalog):
        ids, emb, _ = catalog
        _, tmesh = meshes((2, 4))
        built = DistributedQuantizedIndex.build_from_batches(
            10, "article_id", _embed_fn_for(emb, True), _batches_of(ids, 128),
            128, mesh=tmesh, method="scan")
        assert built.num_candidates == len(ids)

    @pytest.mark.parametrize("family", ["quantized", "brute_force"])
    def test_sharded_save_loads_in_both_packages(self, catalog, tmp_path,
                                                 family):
        """A streamed build saves one file a model shard; both packages'
        distributed loaders (onto other mesh shapes) and single-device
        loaders read it."""
        ids, emb, q = catalog
        cls_j, cls_p, kw = (
            (JaxDistQ, DistributedQuantizedIndex, {"method": "scan"})
            if family == "quantized"
            else (JaxDistBF, DistributedBruteForceIndex, {"method": "xla"}))
        _, built = build_both(cls_j, cls_p, 10, ids, emb, (2, 4), 128, **kw)
        assert built.saves_sharded
        d = str(tmp_path / "sharded")
        built.save(d)
        assert not os.path.exists(f"{d}/index.npz")
        assert len([f for f in os.listdir(d)
                    if f.startswith("index_shard_")]) == 4
        with open(f"{d}/meta.json") as f:
            meta = json.load(f)
        assert (meta["num_shards"], meta["num_candidates"], meta["dim"]) == (
            4, len(ids), 16)
        want = run_port(built, q)
        jmesh, tmesh = meshes((4, 2))
        assert_close(run_port(load_distributed_index(d, tmesh, **kw), q), want)
        assert_close(run_jax(jax_load_distributed_index(d, jmesh, **kw), q),
                     want)
        local = load_index(d, device="cpu")
        assert local.num_candidates == len(ids)
        jlocal = jax_load_index(d)
        assert jlocal.num_candidates == len(ids)
        if family == "brute_force":
            np.testing.assert_array_equal(run_port(local, q)[1], want[1])

    def test_resave_clears_stale_layouts(self, catalog, tmp_path):
        """Sharded after single-file drops index.npz; a narrower re-shard
        drops the higher shard files; single-file after sharded drops every
        shard file."""
        ids, emb, _ = catalog
        d = str(tmp_path / "swap")

        def shard_files():
            return [f for f in os.listdir(d) if f.startswith("index_shard_")]

        host = DistributedQuantizedIndex(10, ids, emb,
                                         mesh=meshes((2, 4))[1],
                                         method="scan")
        host.save(d)
        assert os.path.exists(f"{d}/index.npz")
        for shape, n in (((1, 8), 8), ((2, 4), 4)):
            _, built = build_both(JaxDistQ, DistributedQuantizedIndex, 10,
                                  ids, emb, shape, 128, method="scan")
            built.save(d)
            assert not os.path.exists(f"{d}/index.npz")
            assert len(shard_files()) == n
            assert load_index(d, device="cpu").num_candidates == len(ids)
        host.save(d)
        assert os.path.exists(f"{d}/index.npz") and not shard_files()

    def test_rescore_false_never_materializes_fp32(self, catalog, tmp_path):
        ids, emb, q = catalog
        _, built = build_both(JaxDistQ, DistributedQuantizedIndex, 10, ids,
                              emb, (1, 8), 128, method="scan", rescore=False)
        assert built._placed[2] is None
        d = str(tmp_path / "nofp32")
        built.save(d)
        for f in os.listdir(d):
            if f.startswith("index_shard_"):
                with np.load(os.path.join(d, f)) as z:
                    assert "embeddings" not in z.files
        again = load_distributed_index(d, meshes((1, 8))[1], method="scan")
        # the codes come back exactly; a rebuilt scale may differ in its
        # last bit (127 * s * fp32(1/127))
        np.testing.assert_array_equal(again._placed[0].numpy(),
                                      built._placed[0].numpy())
        assert_close(run_port(again, q), run_port(built, q))

    @pytest.mark.parametrize("family", ["quantized", "brute_force"])
    def test_to_local_of_streamed_build(self, catalog, family):
        ids, emb, q = catalog
        if family == "quantized":
            _, built = build_both(JaxDistQ, DistributedQuantizedIndex, 10,
                                  ids, emb, (2, 4), 128, method="scan")
            local = built.to_local(method="scan")
            ref = QuantizedIndex(10, ids, emb, method="scan", device="cpu")
        else:
            _, built = build_both(JaxDistBF, DistributedBruteForceIndex, 10,
                                  ids, emb, (2, 4), 128, method="xla")
            local = built.to_local(method="full")
            ref = BruteForceIndex(10, ids, emb, method="full", device="cpu")
        assert local.device == torch.device("cpu")
        assert_bitwise(run_port(local, q), run_port(ref, q))
        np.testing.assert_array_equal(built._host_catalog(), emb)

    def test_embedding_decode_is_deferred(self, catalog, tmp_path):
        """The sharded loader reads the ids at once and decodes the rows
        only when a block's thunk runs."""
        ids, emb, _ = catalog
        _, built = build_both(JaxDistQ, DistributedQuantizedIndex, 10, ids,
                              emb, (2, 4), 128, method="scan", rescore=False)
        d = str(tmp_path / "lazy")
        built.save(d)
        blocks = list(_shard_arrays_to_blocks(d))
        assert len(blocks) == 4
        np.testing.assert_array_equal(
            np.concatenate([b[0] for b in blocks]), ids)
        first = blocks[0][1]()
        assert first.dtype == np.float32 and first.shape[1] == emb.shape[1]
        for f in os.listdir(d):
            if f.startswith("index_shard_"):
                os.unlink(os.path.join(d, f))
        with pytest.raises(FileNotFoundError):
            blocks[1][1]()


# ---------------------------------------------------------------------------
# The service and the eval-only runner over a sharded index
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving_artifacts(tmp_path_factory):
    """Schema and towers written by the JAX package (20,000 articles), and
    its distributed "xla" index artifact over the candidate tower's
    catalog."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("dist_serving")
    ids, emb = write_jax_serving_artifacts(root, rng)
    jmesh, _ = meshes((2, 4))
    JaxDistBF(SERVE_K, ids, emb, mesh=jmesh, method="xla").save(
        str(root / "index"))
    return {"schema": str(root / "schema"), "model": str(root / "model"),
            "index": str(root / "index"), "raw": _raw_queries(rng),
            "ids": ids, "emb": emb}


def test_service_over_a_sharded_index_matches_jax(serving_artifacts):
    """RetrievalService.load(mesh, distributed_index=True) in both packages
    on the same artifact and strings: equal answers, except between items
    whose fp32 scores lie within 1e-3 of the row's best (the towers sum in
    another order)."""
    art = serving_artifacts
    jmesh, tmesh = meshes((2, 4))
    jsvc = JaxRetrievalService.load(art["schema"], art["model"], art["index"],
                                    mesh=jmesh, distributed_index=True)
    svc = RetrievalService.load(art["schema"], art["model"], art["index"],
                                mesh=tmesh, distributed_index=True,
                                device="cpu")
    assert isinstance(svc.index, DistributedBruteForceIndex)
    assert svc.index.method == "xla"
    want = jsvc.retrieve(art["raw"])
    got = svc.retrieve(art["raw"])
    q = svc.embed(svc.encode_query(art["raw"])).numpy().astype(np.float64)
    scores = q @ art["emb"].astype(np.float64).T
    vocab = svc.schema.candidate_id_feature.vocab
    _assert_same_answers(got, want, scores, ["<oov>"] + list(vocab))
    # and the port's single-device service over the same catalog in fp32
    local = RetrievalService(
        svc.schema, svc.query_tower,
        BruteForceIndex(SERVE_K, art["ids"], art["emb"], method="full",
                        device="cpu"),
        device="cpu")
    assert local.retrieve(art["raw"]) == got
    with pytest.raises(ValueError, match="requires a mesh"):
        RetrievalService.load(art["schema"], art["model"], art["index"],
                              device="cpu", distributed_index=True)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_evaluation_runner_over_a_sharded_index(pipeline, tmp_path, shape):  # noqa: F811
    """evaluation_runner(mesh, distributed_index=True) against the JAX
    package's distributed build_index + evaluate over its mesh, on the
    port's exported towers and the same shards (both "pallas" on bf16
    operands: the port's "auto", the JAX kernels in interpret mode): equal
    recall. The sharded artifact it saves loads in the JAX package."""
    settings, results = pipeline
    settings = dataclasses.replace(settings,
                                   index_dirpath=str(tmp_path / "index"))
    jmesh, tmesh = meshes(shape)
    got = evaluation_runner(settings, mesh=tmesh, distributed_index=True,
                            device="cpu")
    assert set(got) == set(results["final"])
    assert len([f for f in os.listdir(tmp_path / "index")
                if f.startswith("index_shard_")]) == shape[1]

    schema = JaxSchema.load(settings.schema_dirpath)
    tc, mc = schema.training_config, schema.model_config
    model = JaxTwoTowerModel.create_from_schema(schema)
    params = jax.tree.map(
        jnp.asarray,
        load_pytree_npz(f"{settings.model_dirpath}/two_tower/params.npz"))
    cand_ds = JaxShardDataset(settings.candidate_shards_dirpath)
    cand_fn = jax.jit(model.candidate_forward)
    index = JaxDistBF.build_from_batches(
        min(max(mc.ks), cand_ds.num_rows), model.candidate_id_col,
        lambda b: cand_fn(params, {k: jnp.asarray(v) for k, v in b.items()}),
        cand_ds.iter_batches(tc.candidate_batch_size),
        tc.candidate_batch_size, mesh=jmesh, num_candidates=cand_ds.num_rows,
        dim=model.joint_embedding_size, method="pallas", interpret=True)
    want = jax_evaluate(model, params, index,
                        JaxShardDataset(settings.test_shards_dirpath),
                        tc.test_batch_size, mc.ks, mesh=jmesh)
    assert got == want
    assert jax_load_index(settings.index_dirpath).num_candidates == (
        cand_ds.num_rows)


def test_evaluation_runner_mesh_options(pipeline, tmp_path):  # noqa: F811
    settings, results = pipeline
    settings = dataclasses.replace(settings,
                                   index_dirpath=str(tmp_path / "index"))
    with pytest.raises(ValueError, match="requires a mesh"):
        evaluation_runner(settings, distributed_index=True, device="cpu")
    # a mesh without the sharded index: the single-device index, the same
    # recall as the runner's final
    tmesh = make_mesh(1, 2, devices=["cpu"] * 2)
    assert evaluation_runner(settings, mesh=tmesh, device="cpu") == (
        results["final"])
    # with row-sharded tables over the mesh the template is the row-sharded
    # state: the single-device checkpoint's 301-row customer table does not
    # fill its 2 x 151 rows, and the restore refuses it, as a restore into
    # the JAX package's padded layout does
    schema = Schema.load(settings.schema_dirpath)
    schema.training_config = dataclasses.replace(
        schema.training_config, sharded_embedding_features=["customer_id"])
    schema.save(str(tmp_path / "schema"))
    sharded = dataclasses.replace(settings,
                                  schema_dirpath=str(tmp_path / "schema"))
    with pytest.raises(ValueError, match=r"\(301, 16\) does not match"):
        evaluation_runner(sharded, mesh=tmesh, device="cpu")
