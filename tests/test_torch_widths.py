"""Embedding widths the CUDA kernels do not take as they are.

The kernels step through E 16 columns at a time. So the port's drivers pad
the query and their catalog copies with zero columns to a multiple of 16 on
every device (exact: a zero column adds exact zeros to every score), while
the single-pass plan keeps the real E, since L and F decide which rows
survive and the JAX package plans with the real E. Up to a padded E of 512
(bf16) or 576 (int8) a pass runs bin_max2.cu's whole-E instances, past it
its sliced instance, which gives the same scores; on the CPU both are the
plain versions, so the wide cases here hold the drivers and indices around
them. The wrappers take padded widths up to ``KERNEL_MAX_E`` = 8,192, above
the JAX kernels' widest; past it the indices run their other engine with a
log line: ``BruteForceIndex`` the exact ``"partial_reduce"`` path,
``QuantizedIndex`` the ``"scan"`` engine, whose integer product stays
exact at every E by summing slices of at most 1040 columns in fp32 and
adding the partial sums in int32.

Everything is held against the JAX package on the same inputs: its Pallas
drivers in interpret mode and its indices. Tolerances as in
``test_torch_bin_topk``: integer inputs bit-identical, normal inputs within
TOL with ids equal wherever the competing scores differ by more.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.indices import (
    DistributedBruteForceIndex as JaxDistBF,
    DistributedQuantizedIndex as JaxDistQ,
)
from hm_retrieval_tpu.indices.brute_force import (
    BruteForceIndex as JaxBruteForceIndex,
)
from hm_retrieval_tpu.indices.quantized import QuantizedIndex as JaxQuantized
from hm_retrieval_tpu.indices.quantized import _pallas_feasible
from hm_retrieval_tpu.ops import pallas_retrieval as pr
from hm_retrieval_tpu.parallel import make_mesh as jax_make_mesh
from hm_retrieval_tpu_torch.indices import quantized as pq
from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
from hm_retrieval_tpu_torch.indices.distributed import (
    DistributedBruteForceIndex,
    DistributedQuantizedIndex,
)
from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.ops import quantized_topk as qt
from hm_retrieval_tpu_torch.parallel import make_mesh
from test_torch_bin_topk import _assert_same_ranking, _inputs

WIDTHS = (8, 100)
# past the whole-E instances: 520 -> 528 (int8 still whole-E), 600 -> 608,
# the sharded index's 769 + 1 -> 784 (784 itself here), 1040 past the scan's
# exact fp32 width
WIDE = (520, 600, 784, 1040)
KINDS = ("integer", "normal")


def _dtypes(kind):
    """(JAX, torch) compute dtypes: bf16 for exact integer inputs, fp32
    for normal inputs."""
    if kind == "integer":
        return jnp.bfloat16, torch.bfloat16
    return jnp.float32, torch.float32


def _int8_catalog(rng, N, E):
    codes = rng.integers(-127, 128, size=(N, E)).astype(np.int8)
    scales = (rng.random(N) * 0.05 + 1e-3).astype(np.float32)
    bias = np.where(rng.random(N) < 0.05, -np.inf, 0.0).astype(np.float32)
    return codes, scales, bias


def _scaled_scores(q, codes, scales, bias, n_valid):
    s = q.astype(np.float64) @ codes.astype(np.float64).T * scales + bias
    s[:, n_valid:] = -np.inf
    return np.where(np.isfinite(s), s, -np.inf)


def _spy(monkeypatch, module, names):
    """Each named wrapper of ``module`` records its (q, catalog) operands
    and runs as before."""
    seen = []
    for name in names:
        wrapper = getattr(module, name)

        def run(q, c, *args, _wrapper=wrapper, **kwargs):
            seen.append((q, c))
            return _wrapper(q, c, *args, **kwargs)

        monkeypatch.setattr(module, name, run)
    return seen


def _assert_padded(seen, E):
    """Every launch got E padded to the kernels' k step, zeros past E."""
    width = bt.padded_width(E)
    assert seen and width % 16 == 0 and width - E < 16
    for q, c in seen:
        assert q.shape[1] == c.shape[1] == width
        assert not bool(q[:, E:].any()) and not bool(c[:, E:].any())


class TestPaddedWidth:
    @pytest.mark.parametrize(
        "E, width", [(1, 16), (8, 16), (16, 16), (100, 112), (520, 528)]
    )
    def test_padded_width(self, E, width):
        assert bt.padded_width(E) == width

    def test_kernel_widths(self):
        """The widest padded E the wrappers take is at least the widest the
        JAX kernels take, each computed from the JAX package's own rules
        at its off-TPU budget: ``pick_bins`` for the exact index at one
        query row and k = 10 (7,296) and ``_pallas_feasible`` for the one
        pass at k_over = 40 (6,672). Below it the whole-E instances end
        where their int8 kind still fits a block's 232,448 bytes at 128
        query rows: the bf16 query tile (row stride E + 8) and the larger of
        two ring slots of E-byte code rows (with their scales and biases for
        the per-row passes, the codes alone for the raw pass) plus one bf16
        tile, and the keep-2 partial cells (128 rows x 40 x 8 bytes x 2), as
        shape_for counts them (231,424 at E = 576 for both kinds, read on
        the card by launch_info)."""

        def widest(fits):
            E = 16
            while fits(E + 16):
                E += 16
            return E

        exact = widest(lambda E: pr.pick_bins(1, E, 10) is not None)
        one_pass = widest(lambda E: _pallas_feasible(40, E))
        assert (exact, one_pass) == (7296, 6672)
        assert bt.KERNEL_MAX_E >= exact >= one_pass
        assert bt.KERNEL_MAX_E % bt.KERNEL_K_STEP == 0
        E = 576  # whole_e_max of the int8 kinds in csrc/bin_max2.cu
        partials = 2 * 128 * 40 * 8
        for scales_and_biases in (2 * 32 * 4, 0):  # per-row passes, raw
            ring = 2 * (32 * E + scales_and_biases) + 2 * 32 * (E + 8)
            assert 2 * 128 * (E + 8) + max(ring, partials) == 231424 <= 232448


# bin_max2.cu's shape arithmetic (shape_at, shape_for, walk_for): bins a
# block, bf16 row padding, the partial cells' row stride, the K slice, a
# block's shared bytes, the ring's depth cap, the query rows a block holds
# at most.
BN, PAD, PS, EK, SMEM, MAX_STAGES, BM = 32, 8, 40, 128, 232448, 12, 128


def _slot_bytes(E, kind):
    """One ring slot: BN bf16 rows (stride E + PAD), or BN int8 code rows
    (with BN fp32 scales and BN biases for the per-row kind)."""
    return {"bf16": BN * (E + PAD) * 2, "scaled": BN * E + 2 * BN * 4,
            "raw": BN * E}[kind]


def _shape_at(rows, E, kind, walk):
    """(rows, warp groups, ring stages, shared bytes) of a block of
    ``rows`` query rows: the most groups (of 2 warps per 32 rows, 8 warps
    in all) that keep two ring slots each. Whole-E slots hold a BN x E
    sub-tile, sliced ones a BN x EK slice, re-read ones the query's slice
    too; the int8 kinds add a bf16 tile a group; the query tile of (E +
    PAD) bf16 rows is resident but in the re-read walk; the keep-2 partial
    cells (2 x rows x PS x 8 bytes a group) reuse the ring."""
    sliced = walk != "whole"
    width = EK if sliced else E
    stage = _slot_bytes(width, kind)
    if walk == "reread":
        stage += rows * (EK + PAD) * 2
    tile = 0 if kind == "bf16" else BN * (width + PAD) * 2
    qbytes = 0 if walk == "reread" else rows * (E + PAD) * 2
    groups = 8 // (rows // 32 * 2)
    while True:
        stages = min((SMEM - qbytes - groups * tile) // (groups * stage),
                     MAX_STAGES)
        smem = qbytes + max(groups * (stages * stage + tile),
                            groups * 2 * rows * PS * 8)
        if (stages >= 2 and smem <= SMEM) or groups == 1:
            return rows, groups, stages, smem
        groups -= 1


def _fits(shape):
    return shape[2] >= 2 and shape[3] <= SMEM


def _shape_for(B, E, kind, walk):
    """min(B, 128) rows rounded up to 32; the resident walk the most of
    128, 64, 32 (so capped) that fit."""
    need = -(-min(B, BM) // 32) * 32
    cap = BM
    while True:
        shape = _shape_at(min(need, cap), E, kind, walk)
        if walk != "resident" or _fits(shape) or cap == 32:
            return shape
        cap //= 2


def _walk_for(E, kind):
    """Whole-E to 512 (bf16) or 576 (int8), then the resident walk while 32
    query rows fit, then the re-read walk."""
    if E <= (512 if kind == "bf16" else 576):
        return "whole"
    return "resident" if _fits(_shape_for(1, E, kind, "resident")) else "reread"


class TestWalks:
    """Where each walk of bin_max2.cu ends and how many query rows a block
    holds at B = 128 and B = 16, worked out from the launcher's shape
    arithmetic (``chip_smoke.check_instance_edges`` reads the same choice
    on the card through ``launch_info``): (walk, query rows, warp groups,
    ring stages) of every kind."""

    @pytest.mark.parametrize("E, kind, at_128, at_16", [
        (528, "bf16", ("resident", 128, 1, 10), ("resident", 32, 4, 5)),
        (528, "scaled", ("whole", 128, 1, 3), ("whole", 32, 2, 3)),
        (528, "raw", ("whole", 128, 1, 3), ("whole", 32, 2, 3)),
        (784, "bf16", ("resident", 64, 2, 7), ("resident", 32, 4, 5)),
        (784, "scaled", ("resident", 64, 2, 12), ("resident", 32, 4, 8)),
        (784, "raw", ("resident", 64, 2, 12), ("resident", 32, 4, 8)),
        (1024, "bf16", ("resident", 64, 2, 5), ("resident", 32, 4, 4)),
        (1024, "scaled", ("resident", 64, 2, 9), ("resident", 32, 4, 7)),
        (1024, "raw", ("resident", 64, 2, 10), ("resident", 32, 4, 8)),
        (2048, "bf16", ("resident", 32, 4, 2), ("resident", 32, 4, 2)),
        (2048, "scaled", ("resident", 32, 4, 3), ("resident", 32, 4, 3)),
        (2048, "raw", ("resident", 32, 4, 4), ("resident", 32, 4, 4)),
        (3296, "bf16", ("resident", 32, 1, 2), ("resident", 32, 1, 2)),
        (3296, "scaled", ("resident", 32, 1, 2), ("resident", 32, 1, 2)),
        (3296, "raw", ("resident", 32, 1, 3), ("resident", 32, 1, 3)),
        (3312, "bf16", ("reread", 128, 1, 5), ("reread", 32, 4, 3)),
        (3312, "scaled", ("reread", 128, 1, 5), ("reread", 32, 4, 3)),
        (3312, "raw", ("reread", 128, 1, 5), ("reread", 32, 4, 3)),
        (8192, "bf16", ("reread", 128, 1, 5), ("reread", 32, 4, 3)),
        (8192, "scaled", ("reread", 128, 1, 5), ("reread", 32, 4, 3)),
        (8192, "raw", ("reread", 128, 1, 5), ("reread", 32, 4, 3)),
    ])
    def test_walk_and_query_rows(self, E, kind, at_128, at_16):
        walk = _walk_for(E, kind)
        for B, want in ((128, at_128), (16, at_16)):
            shape = _shape_for(B, E, kind, walk)
            assert _fits(shape)
            assert (walk, *shape[:3]) == want
            # B = 128 runs 128 / rows row-group blocks a bin tile
            assert -(-B // shape[0]) * shape[0] >= B

    @pytest.mark.parametrize("kind", ["bf16", "scaled", "raw"])
    def test_resident_walk_ends_where_32_rows_stop_fitting(self, kind):
        """The resident walk runs from a k step past the whole-E instances
        to 3,296 (32 query rows of 3,304 bf16 beside one group's partial
        cells fill 231,936 bytes, or, raw, all 232,448), the re-read walk
        from 3,312 to ``KERNEL_MAX_E``; no width runs none."""
        widest = 512 if kind == "bf16" else 576
        walks = {E: _walk_for(E, kind)
                 for E in range(16, bt.KERNEL_MAX_E + 1, 16)}
        assert {E for E, w in walks.items() if w == "whole"} == set(
            range(16, widest + 1, 16))
        assert {E for E, w in walks.items() if w == "resident"} == set(
            range(widest + 16, 3297, 16))
        assert all(walks[E] == "reread"
                   for E in range(3312, bt.KERNEL_MAX_E + 1, 16))
        assert _fits(_shape_for(128, bt.KERNEL_MAX_E, kind, "reread"))
        assert 32 * (3296 + PAD) * 2 + 2 * 32 * PS * 8 == 231936
        assert 32 * (3312 + PAD) * 2 + 2 * 32 * PS * 8 > SMEM


class TestExactWidths:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("E", WIDTHS)
    def test_exact_topk_matches_jax(self, rng, E, kind):
        B, N, k, L = 8, 3000, 10, 256
        q, c = _inputs(rng, kind, B, N, E)
        jdt, tdt = _dtypes(kind)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            compute_dtype=jdt,
        )
        v, i, rounds = bt.exact_topk(
            torch.tensor(q), torch.tensor(c), k, L=L, compute_dtype=tdt
        )
        assert rounds == int(jr)
        scores = q.astype(np.float64) @ c.astype(np.float64).T
        _assert_same_ranking(v.numpy(), i.numpy(), jv, ji, scores,
                             kind == "integer")

    @pytest.mark.parametrize("keep_per_bin", [1, 2])
    @pytest.mark.parametrize("E", WIDTHS)
    def test_kernels_get_padded_operands(self, rng, monkeypatch, E,
                                         keep_per_bin):
        seen = _spy(monkeypatch, bt, ("bin_max2_first_round",
                                      "bin_max2_round", "bin_max_round"))
        q, c = _inputs(rng, "integer", 4, 2000, E)
        want = bt.exact_topk(torch.tensor(q), torch.tensor(c), 10,
                             keep_per_bin=keep_per_bin)
        _assert_padded(seen, E)
        # the same answer as the caller's own zero columns
        width = bt.padded_width(E)
        qp, cp = (np.pad(x, ((0, 0), (0, width - E))) for x in (q, c))
        got = bt.exact_topk(torch.tensor(qp), torch.tensor(cp), 10,
                            keep_per_bin=keep_per_bin)
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g, w)

    def test_no_copy_at_a_multiple_of_16(self, rng, monkeypatch):
        seen = _spy(monkeypatch, bt, ("bin_max2_first_round",))
        q, c = _inputs(rng, "integer", 4, 2000, 32)
        qb = torch.tensor(q).to(torch.bfloat16)
        bt.exact_topk(qb, torch.tensor(c), 10)
        assert seen[0][0].data_ptr() == qb.data_ptr()
        assert seen[0][1].shape == (2048, 32)

    @pytest.mark.parametrize("E", WIDTHS)
    def test_brute_force_index_matches_jax(self, rng, E):
        """The index's kernel path against the JAX index's ("pallas" runs
        only on a TPU there, so its driver in interpret mode): integer
        embeddings, exact in bf16, bit-identical."""
        n, k = 3000, 10
        q, emb = _inputs(rng, "integer", 8, n, E)
        ids = rng.permutation(n).astype(np.int32) + 3
        idx = BruteForceIndex(k, ids, emb, method="pallas", device="cpu")
        assert idx._engine == "pallas"
        jv, ji, _ = pr.pallas_exact_topk(jnp.asarray(q), jnp.asarray(emb), k,
                                         interpret=True)
        got = idx.topk_from_embeddings(torch.tensor(q))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(got[1].numpy(), ids[np.asarray(ji)])

    @pytest.mark.parametrize("E, engine, n",
                             [(100, "pallas", 17000), (512, "pallas", 17000),
                              (513, "pallas", 17000), (520, "pallas", 17000),
                              (8193, "partial_reduce", 3000),
                              (8200, "partial_reduce", 3000)])
    def test_width_past_the_kernels_routes_to_partial_reduce(
            self, rng, caplog, E, engine, n):
        """Past the wrappers' widest padded E, KERNEL_MAX_E, the index runs
        the exact "partial_reduce" engine, with a log line. On integer
        inputs its scores are the exact top-k's bit for bit, as JAX's
        "full" gives them; among equal scores its ids may come in another
        order (ties between bins go by bin), so each id is held to its own
        exact score. "auto" takes the kernels by size (n = 17,000); past
        the cap the index asks for "pallas" over fewer rows."""
        k = 10
        q, emb = _inputs(rng, "integer", 4, n, E)
        ids = np.arange(n, dtype=np.int32)
        method = "auto" if n > BruteForceIndex.PALLAS_MIN_ROWS else "pallas"
        with caplog.at_level(logging.WARNING):
            idx = BruteForceIndex(k, ids, emb, method=method, device="cpu")
        assert (idx.method, idx._engine) == ("pallas", engine)
        routed = [r for r in caplog.records if "widest" in r.getMessage()]
        assert len(routed) == (engine == "partial_reduce")
        if engine == "partial_reduce":
            assert "'partial_reduce'" in routed[0].getMessage()
            want = JaxBruteForceIndex(k, ids, emb, method="full")
            want = want.topk_from_embeddings(jnp.asarray(q))
            got = idx.topk_from_embeddings(torch.tensor(q))
            _assert_exact_up_to_tie_order(got, want, q, emb, ids)


def _assert_exact_up_to_tie_order(got, want, q, emb, ids):
    """Scores bit for bit; every returned id distinct and carrying its own
    exact score (integer inputs: exact in fp32)."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    row_of = np.zeros(ids.max() + 1, np.int64)
    row_of[ids] = np.arange(len(ids))
    rows = row_of[got[1].numpy()]
    own = np.einsum("be,bke->bk", q.astype(np.float64),
                    emb[rows].astype(np.float64))
    np.testing.assert_array_equal(own, got[0].numpy())
    assert all(len(set(r)) == r.size for r in got[1].numpy())


class TestQuantizedWidths:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("max_rounds", [1, 8])
    @pytest.mark.parametrize("E", WIDTHS)
    def test_quantized_topk_matches_jax(self, rng, E, max_rounds, kind):
        B, N, n_valid, k = 16, 3000, 2500, 10
        q = _inputs(rng, kind, B, 1, E)[0]
        codes, scales, bias = _int8_catalog(rng, N, E)
        jdt, tdt = _dtypes(kind)
        wv, wi, wr = pr.pallas_quantized_topk(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), k,
            n_valid=n_valid, bias=jnp.asarray(bias), max_rounds=max_rounds,
            interpret=True, compute_dtype=jdt,
        )
        v, i, rounds = qt.quantized_topk(
            torch.tensor(q), torch.tensor(codes), torch.tensor(scales), k,
            n_valid=n_valid, bias=torch.tensor(bias), max_rounds=max_rounds,
            compute_dtype=tdt,
        )
        assert rounds == int(wr)
        scores = _scaled_scores(q, codes, scales, bias, n_valid)
        _assert_same_ranking(v.numpy(), i.numpy(), wv, wi, scores,
                             kind == "integer")

    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("E", WIDTHS)
    def test_quantized_topk_global_matches_jax(self, rng, E, kind):
        B, n_valid, k, L, F = 8, 1500, 10, 256, 2
        q = _inputs(rng, kind, B, 1, E)[0]
        codes = rng.integers(-127, 128, size=(2048, E)).astype(np.int8)
        g = np.float32(0.013)
        jdt, tdt = _dtypes(kind)
        wv, wi, _ = pr.pallas_quantized_topk_global(
            jnp.asarray(q), jnp.asarray(codes), g, k, n_valid=n_valid, L=L,
            fold=F, interpret=True, compute_dtype=jdt,
        )
        v, i, _ = qt.quantized_topk_global(
            torch.tensor(q), torch.tensor(codes), float(g), k,
            n_valid=n_valid, L=L, fold=F, compute_dtype=tdt,
        )
        scores = (q.astype(np.float64) @ codes[:n_valid].astype(np.float64).T
                  * np.float64(g))
        _assert_same_ranking(v.numpy(), i.numpy(), wv, wi, scores,
                             kind == "integer")

    @pytest.mark.parametrize("max_rounds", [1, 8])
    @pytest.mark.parametrize("E", WIDTHS)
    def test_kernels_get_padded_operands_and_the_plan_the_real_width(
        self, rng, monkeypatch, E, max_rounds
    ):
        planned = []
        plan = qt.single_pass_plan

        def spy_plan(B, width, *args):
            planned.append(width)
            return plan(B, width, *args)

        monkeypatch.setattr(qt, "single_pass_plan", spy_plan)
        seen = _spy(monkeypatch, qt, (
            "bin_max2_scaled_single_pass", "bin_max2_scaled_fold_pass",
            "bin_max2_raw_fold_pass", "bin_max2_scaled_first_round",
            "bin_max2_scaled_round",
        ))
        q = torch.tensor(_inputs(rng, "integer", 4, 1, E)[0])
        codes, scales, _ = (torch.tensor(a) for a in
                            _int8_catalog(rng, 3000, E))
        got = qt.quantized_topk(q, codes, scales, 10, n_valid=2900,
                                max_rounds=max_rounds)
        qt.quantized_topk_global(q, codes, 0.5, 10, n_valid=2900)
        _assert_padded(seen, E)
        assert planned == ([E] if max_rounds == 1 else []) + [E]
        # the same answer as the caller's own zero columns, at the bins
        # and fold of the real width
        width = bt.padded_width(E)
        _, fold, L = plan(4, E, 10, 3000)
        if max_rounds > 1:
            fold, L = None, None
        want = qt.quantized_topk(
            torch.nn.functional.pad(q, (0, width - E)),
            torch.nn.functional.pad(codes, (0, width - E)), scales, 10,
            n_valid=2900, max_rounds=max_rounds, L=L, fold=fold,
        )
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g, w)

    def test_no_copy_at_a_multiple_of_16(self, rng, monkeypatch):
        seen = _spy(monkeypatch, qt, ("bin_max2_scaled_fold_pass",))
        q = torch.tensor(_inputs(rng, "integer", 4, 1, 32)[0])
        qb = q.to(torch.bfloat16)
        codes, scales, _ = (torch.tensor(a) for a in
                            _int8_catalog(rng, 2048, 32))
        qt.quantized_topk(qb, codes, scales, 10, max_rounds=1, fold=2)
        assert seen[0][0].data_ptr() == qb.data_ptr()
        assert seen[0][1].data_ptr() == codes.data_ptr()

    @pytest.mark.parametrize("rounds", [1, 8])
    @pytest.mark.parametrize("E", WIDTHS)
    def test_quantized_index_matches_jax(self, rng, E, rounds):
        n, k = 3000, 10
        ids = rng.permutation(n).astype(np.int32) + 7
        emb = rng.normal(size=(n, E)).astype(np.float32)
        q = rng.normal(size=(8, E)).astype(np.float32)
        kw = dict(method="pallas", pallas_rounds=rounds)
        jidx = JaxQuantized(k, ids, emb, **kw)
        idx = QuantizedIndex(k, ids, emb, device="cpu", **kw)
        assert (idx.method, idx._engine, idx.k_over) == (
            "pallas", "pallas", jidx.k_over)
        want = jidx.topk_from_embeddings(jnp.asarray(q))
        got = idx.topk_from_embeddings(torch.tensor(q))
        row_of = np.zeros(ids.max() + 1, np.int64)
        row_of[ids] = np.arange(n)
        scores = q.astype(np.float64) @ emb.astype(np.float64).T
        _assert_same_ranking(
            got[0].numpy(), row_of[got[1].numpy()], np.asarray(want[0]),
            row_of[np.asarray(want[1])], scores, False,
        )

    @pytest.mark.parametrize(
        "E, rounds, engine",
        [(512, 8, "pallas"), (520, 8, "pallas"), (520, 1, "pallas"),
         (576, 1, "pallas"), (600, 1, "pallas"), (8192, 1, "pallas"),
         (8200, 8, "scan"), (8200, 1, "scan")],
    )
    def test_width_past_the_kernels_routes_to_scan(self, rng, caplog,
                                                   tmp_path, E, rounds,
                                                   engine):
        """The one-pass kernels and the rounds take padded widths up to
        KERNEL_MAX_E = 8,192 (whole-E instances to 576, the sliced
        one past it); past it the scan engine runs, with a log line, and
        the saved method stays "pallas"."""
        n, k = 2000, 5
        ids = np.arange(n, dtype=np.int32)
        emb = rng.normal(size=(n, E)).astype(np.float32)
        q = torch.tensor(rng.normal(size=(3, E)).astype(np.float32))
        kw = dict(method="pallas", pallas_rounds=rounds, device="cpu")
        with caplog.at_level(logging.WARNING):
            idx = QuantizedIndex(k, ids, emb, **kw)
        assert (idx.method, idx._engine) == ("pallas", engine)
        routed = [r for r in caplog.records if "widest" in r.getMessage()]
        assert len(routed) == (engine == "scan")
        if engine == "scan":
            scan = QuantizedIndex(k, ids, emb, method="scan", device="cpu")
            for g, w in zip(idx.topk_from_embeddings(q),
                            scan.topk_from_embeddings(q)):
                assert torch.equal(g, w)
            idx.save(str(tmp_path))
            loaded = pq.QuantizedIndex.load(str(tmp_path), device="cpu")
            assert (loaded.method, loaded._engine) == ("pallas", "scan")


class TestWideWidths:
    """Widths past the whole-E instances (the sliced instance on the card)
    through every driver and index, against the JAX kernels in interpret
    mode on integer inputs (exact in bf16 and in fp32 sums): bit for bit,
    each at E padded to a multiple of 16 and planned at the real E."""

    N = 2500

    @pytest.mark.parametrize("keep_per_bin", [1, 2])
    @pytest.mark.parametrize("E", WIDE)
    def test_exact_topk_matches_jax(self, rng, E, keep_per_bin):
        q, c = _inputs(rng, "integer", 8, self.N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), 10, L=256, interpret=True,
            keep_per_bin=keep_per_bin)
        v, i, rounds = bt.exact_topk(torch.tensor(q), torch.tensor(c), 10,
                                     L=256, keep_per_bin=keep_per_bin)
        assert rounds == int(jr)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))

    @pytest.mark.parametrize("E", WIDE)
    def test_brute_force_index_matches_jax(self, rng, E):
        q, emb = _inputs(rng, "integer", 8, self.N, E)
        ids = rng.permutation(self.N).astype(np.int32) + 3
        idx = BruteForceIndex(10, ids, emb, method="pallas", device="cpu")
        assert idx._engine == "pallas"
        jv, ji, _ = pr.pallas_exact_topk(jnp.asarray(q), jnp.asarray(emb), 10,
                                         interpret=True)
        got = idx.topk_from_embeddings(torch.tensor(q))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(got[1].numpy(), ids[np.asarray(ji)])

    @pytest.mark.parametrize("max_rounds", [1, 8])
    @pytest.mark.parametrize("E", WIDE)
    def test_quantized_topk_matches_jax(self, rng, E, max_rounds):
        """Per-row scales, -inf bias rows, rows past n_valid: the one pass
        at the plan of the real E, or the rounds."""
        q = _inputs(rng, "integer", 16, 1, E)[0]
        codes, scales, bias = _int8_catalog(rng, self.N, E)
        wv, wi, wr = pr.pallas_quantized_topk(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), 10,
            n_valid=2400, bias=jnp.asarray(bias), max_rounds=max_rounds,
            interpret=True)
        v, i, rounds = qt.quantized_topk(
            torch.tensor(q), torch.tensor(codes), torch.tensor(scales), 10,
            n_valid=2400, bias=torch.tensor(bias), max_rounds=max_rounds)
        assert rounds == int(wr)
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))

    @pytest.mark.parametrize("E", WIDE)
    def test_quantized_topk_global_matches_jax(self, rng, E):
        q = _inputs(rng, "integer", 8, 1, E)[0]
        codes = rng.integers(-127, 128, size=(2048, E)).astype(np.int8)
        g = np.float32(0.013)
        wv, wi, _ = pr.pallas_quantized_topk_global(
            jnp.asarray(q), jnp.asarray(codes), g, 10, n_valid=1500, L=256,
            fold=2, interpret=True)
        v, i, _ = qt.quantized_topk_global(
            torch.tensor(q), torch.tensor(codes), float(g), 10, n_valid=1500,
            L=256, fold=2)
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))

    @pytest.mark.parametrize("scale_mode", ["per_row", "global"])
    @pytest.mark.parametrize("rounds", [1, 8])
    @pytest.mark.parametrize("E", WIDE)
    def test_quantized_index_matches_jax(self, rng, E, rounds, scale_mode):
        q, emb = _inputs(rng, "integer", 8, self.N, E)
        ids = rng.permutation(self.N).astype(np.int32) + 7
        kw = dict(method="pallas", pallas_rounds=rounds, scale_mode=scale_mode)
        jidx = JaxQuantized(10, ids, emb, **kw)
        idx = QuantizedIndex(10, ids, emb, device="cpu", **kw)
        assert (idx._engine, idx.k_over) == ("pallas", jidx.k_over)
        want = jidx.topk_from_embeddings(jnp.asarray(q))
        got = idx.topk_from_embeddings(torch.tensor(q))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    @pytest.mark.parametrize("family", ["exact", "one_pass", "rounds"])
    @pytest.mark.parametrize("E", WIDE + (769,))
    def test_sharded_index_matches_jax(self, rng, E, family):
        """The sharded indices over a (2, 4) mesh against the JAX package's
        over its 8 host devices, the exact one on [q | 1] and [emb | bias]
        (E + 1 columns, padded to a multiple of 16: 769 + 1 to 784)."""
        q, emb = _inputs(rng, "integer", 6, 1500, E)
        ids = np.arange(1, 1501, dtype=np.int32)
        jmesh = jax_make_mesh(data=2, model=4)
        mesh = make_mesh(data=2, model=4, devices=["cpu"] * 8)
        if family == "exact":
            jidx = JaxDistBF(10, ids, emb, mesh=jmesh, method="pallas",
                             interpret=True)
            idx = DistributedBruteForceIndex(10, ids, emb, mesh=mesh,
                                             method="pallas")
        else:
            rounds = 1 if family == "one_pass" else 8
            jidx = JaxDistQ(10, ids, emb, mesh=jmesh, method="pallas",
                            interpret=True, pallas_rounds=rounds)
            idx = DistributedQuantizedIndex(10, ids, emb, mesh=mesh,
                                            method="pallas",
                                            pallas_rounds=rounds)
        assert idx._engine == "pallas"
        want = jidx.topk_from_embeddings(jnp.asarray(q))
        got = idx.topk_from_embeddings(torch.from_numpy(q))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


class TestScanWidth:
    """The scan engine's integer product past 1040 columns, where an fp32
    sum of code products is no longer exact (127^2 * 2048 > 2^24)."""

    E, N, B, K = 2048, 1500, 16, 6

    def _data(self, rng):
        """Catalog rows of +-1 (codes +-127, one scale) near a query sign
        pattern, and integer-valued queries of magnitude 100..127 with that
        pattern: sums of 2^24 .. 2^25, most of them odd."""
        sign = rng.choice([-1.0, 1.0], size=self.E).astype(np.float32)
        flips = rng.random((self.N, self.E)) < rng.random((self.N, 1)) * 0.2
        emb = np.where(flips, -sign, sign).astype(np.float32)
        q = (sign * rng.integers(100, 128, size=(self.B, self.E))).astype(
            np.float32)
        return np.arange(self.N, dtype=np.int32) + 11, emb, q

    def _reference(self, idx, q):
        """Values and rows from an int64 product: the integer sums, each
        rounded once to fp32, then as the engine scales them."""
        t = np.max(np.abs(q), axis=1, keepdims=True) * np.float32(1 / 127)
        qq = np.clip(np.rint(q / t), -127, 127).astype(np.int64)
        codes = idx.codes[: self.N].numpy().astype(np.int64)
        dots = qq @ codes.T
        assert dots.max() > 2**24  # past fp32's exact integers
        s = dots.astype(np.float32) * idx.scales[: self.N].numpy()
        rows = np.argsort(-s, axis=1, kind="stable")[:, : self.K]
        return np.take_along_axis(s, rows, 1) * t, rows

    def test_scan_is_exact_past_1040_columns(self, rng):
        """At recall_target 1.0 the scan keeps the exact top-k of each
        chunk, so its answer is the integer sums' top-k itself."""
        ids, emb, q = self._data(rng)
        kw = dict(method="scan", rescore=False, oversample=1, chunk=1024,
                  recall_target=1.0)
        idx = QuantizedIndex(self.K, ids, emb, device="cpu", **kw)
        assert idx.codes[: self.N].abs().min() == 127
        got_v, got_ids = idx.topk_from_embeddings(torch.tensor(q))
        want_v, rows = self._reference(idx, q)
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        np.testing.assert_array_equal(got_ids.numpy(), ids[rows])
        jv, jids = JaxQuantized(self.K, ids, emb, **kw).topk_from_embeddings(
            jnp.asarray(q))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(jids))

    def test_scan_reduces_past_1040_columns(self, rng):
        """At the default recall_target each 1024-row chunk reduces to 128
        bins of 8 rows (approx_max_k): the answer is the running stable
        top-k of each chunk's bin maxima, over the same integer sums."""
        ids, emb, q = self._data(rng)
        kw = dict(method="scan", rescore=False, oversample=1, chunk=1024)
        idx = QuantizedIndex(self.K, ids, emb, device="cpu", **kw)
        got_v, got_ids = idx.topk_from_embeddings(torch.tensor(q))
        t = np.max(np.abs(q), axis=1, keepdims=True) * np.float32(1 / 127)
        qq = np.clip(np.rint(q / t), -127, 127).astype(np.int64)
        s = np.full((self.B, 2048), -np.inf, np.float32)
        s[:, : self.N] = (qq @ idx.codes[: self.N].numpy().astype(
            np.int64).T).astype(np.float32) * idx.scales[: self.N].numpy()
        top_s = np.full((self.B, self.K), -np.inf, np.float32)
        top_i = np.zeros((self.B, self.K), np.int64)
        for base in (0, 1024):
            bins = s[:, base : base + 1024].reshape(self.B, 8, 128)
            t_of = bins.argmax(axis=1)  # the first, lowest t
            bv = np.take_along_axis(bins, t_of[:, None], 1)[:, 0]
            bi = t_of * 128 + np.arange(128) + base
            order = np.argsort(-bv, axis=1, kind="stable")[:, : self.K]
            ms = np.concatenate([top_s, np.take_along_axis(bv, order, 1)], 1)
            mi = np.concatenate([top_i, np.take_along_axis(bi, order, 1)], 1)
            keep = np.argsort(-ms, axis=1, kind="stable")[:, : self.K]
            top_s = np.take_along_axis(ms, keep, 1)
            top_i = np.take_along_axis(mi, keep, 1)
        np.testing.assert_array_equal(got_v.numpy(), top_s * t)
        np.testing.assert_array_equal(got_ids.numpy(), ids[top_i])

    @pytest.mark.parametrize("E", [16, 1040, 1041, 2080, 2500])
    def test_int_scores_at_slice_edges(self, rng, E):
        qq = torch.tensor(rng.integers(-127, 128, size=(3, E)),
                          dtype=torch.float32)
        codes = torch.tensor(rng.integers(-127, 128, size=(50, E)),
                             dtype=torch.int8)
        want = (qq.numpy().astype(np.int64)
                @ codes.numpy().astype(np.int64).T).astype(np.float32)
        np.testing.assert_array_equal(pq._int_scores(qq, codes).numpy(), want)
