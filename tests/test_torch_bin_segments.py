"""The split-and-merge rule of the kernels of csrc/bin_max2.cu: the exact
passes (kernels 1, 2, 8), the int8 rounds (kernels 6-7) and the int8 single
passes (kernels 3-5).

The kernels cut each (query row, bin) cell's chunk walk into contiguous
segments, over the blocks of a cluster and over warp groups inside a block,
walk each segment in increasing chunk order with the strict '>' cascade, and
merge the partial top-2s (or top-1s) under the explicit comparison x beats y
iff x.s > y.s or (x.s == y.s and x.i < y.i): groups into their block's
partial first, then the cluster's blocks. The model below does the same in
numpy. It must equal the single walk (``bin_cells_plain``) bit for bit for
any segment count, uneven and empty segments included, on integer scores
heavy with ties, with n_valid ending inside a segment, and with thresholds
from a real first round; and the JAX package's passes in interpret mode.
The int8 rounds run the same split over scaled scores,
__fmaf_rn(q . codes, scale, bias) with a bias of 0 or -inf, so the model
holds them too, -inf bias rows included. The single passes run it over fold
chunks of F sub-tiles of L rows: a segment holds whole chunks, each chunk's
F scores per cell go through the tournament (the lower slot keeps a tie)
and only the winner enters the cascade; over the per-row scaled scores
(kernels 3-4) and over the raw sums of the global-scale index (kernel 5,
full chunks of real rows, no epilogue) the model equals
``single_pass_plain`` and the JAX single passes for F = 1, 2, 4, 8, and a
split inside a fold chunk would not. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.ops import pallas_retrieval as pr
from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.ops import quantized_topk as qt

B, L, N_CHUNKS = 5, 32, 10
N_VALID = 250  # inside chunk 7: bin 26 of rows 224 .. 255


def _tournament(scores, L, ch, fold):
    """Fold chunk ``ch``'s winner per cell: its F sub-tiles of L rows in
    increasing slot order, slot 0 taken, a later one where it scores
    strictly higher. Returns (scores, catalog rows), each (B, L)."""
    bins = np.arange(L)
    u0 = ch * fold
    s = scores[:, u0 * L : (u0 + 1) * L]
    flat = np.broadcast_to(bins + u0 * L, s.shape)
    for u in range(u0 + 1, u0 + fold):
        st = scores[:, u * L : (u + 1) * L]
        take = st > s
        s = np.where(take, st, s)
        flat = np.where(take, bins + u * L, flat)
    return s, flat


def _cascade(scores, L, n_valid, chunks, thr, keep, fold=1):
    """One segment: the strict '>' cascade over ``chunks`` in increasing
    order, each chunk F = ``fold`` sub-tiles of L rows reduced by the
    tournament first. Returns (m, a), each (keep, B, L)."""
    rows = scores.shape[0]
    m = np.full((keep, rows, L), -np.inf, np.float32)
    a = np.full((keep, rows, L), bt.BIG_IDX, np.int64)
    for ch in chunks:
        s, flat = _tournament(scores, L, ch, fold)
        ok = flat < n_valid
        if thr is not None:
            ts, ti = thr
            ok = ok & ((s < ts) | ((s == ts) & (flat > ti)))
        s = np.where(ok, s, -np.inf).astype(np.float32)
        gt1 = s > m[0]
        if keep == 2:
            gt2 = s > m[1]
            m[1] = np.where(gt1, m[0], np.where(gt2, s, m[1]))
            a[1] = np.where(gt1, a[0], np.where(gt2, flat, a[1]))
        m[0] = np.where(gt1, s, m[0])
        a[0] = np.where(gt1, flat, a[0])
    return m, a


def _merge(parts, keep):
    """Partial cells merged in the given order by the kernel's ``Top::take``:
    each slot of each part enters under the explicit lexicographic test."""
    shape = parts[0][0].shape
    ts = np.full(shape, -np.inf, np.float32)
    ti = np.full(shape, bt.BIG_IDX, np.int64)
    for m, a in parts:
        for k in range(keep):
            s, i = m[k], a[k]
            b1 = (s > ts[0]) | ((s == ts[0]) & (i < ti[0]))
            if keep == 2:
                b2 = ~b1 & ((s > ts[1]) | ((s == ts[1]) & (i < ti[1])))
                ts[1] = np.where(b1, ts[0], np.where(b2, s, ts[1]))
                ti[1] = np.where(b1, ti[0], np.where(b2, i, ti[1]))
            ts[0] = np.where(b1, s, ts[0])
            ti[0] = np.where(b1, i, ti[0])
    return ts, ti


def _kernel_bounds(n_chunks, cluster, groups):
    """Chunk ranges of the kernel's segments, by block rank then group:
    segment s = rank * groups + group walks [s*n/S, (s+1)*n/S)."""
    S = cluster * groups
    return [
        [(s * n_chunks // S, (s + 1) * n_chunks // S)
         for s in range(r * groups, (r + 1) * groups)]
        for r in range(cluster)
    ]


def _segmented(scores, n_valid, blocks, thr=None, keep=2, L=L, fold=1):
    """The kernels' cells: each block's segments walked and merged into the
    block's partial, then the blocks' partials merged. ``blocks`` lists each
    block's (first chunk, end chunk) segments, in fold chunks of ``fold``
    sub-tiles. Returns (m, a) as the plain version orders its outputs."""
    partials = [
        _merge([_cascade(scores, L, n_valid, range(c0, c1), thr, keep, fold)
                for c0, c1 in segs], keep)
        for segs in blocks
    ]
    m, a = _merge(partials, keep)
    out = []
    for k in range(keep):
        out += [m[k], a[k].astype(np.int32)]
    return out


def _tied_scores(rng):
    """Integer scores in [-3, 3]: each cell sees many ties."""
    return rng.integers(-3, 4, size=(B, N_CHUNKS * L)).astype(np.float32)


def _plain(scores, thr=None, keep=2, n_valid=N_VALID):
    ts = ti = None
    if thr is not None:
        ts, ti = (torch.tensor(x) for x in thr)
    return [
        x.numpy()
        for x in bt.bin_cells_plain(
            torch.tensor(scores), L, n_valid, ts, ti, keep=keep
        )
    ]


def _first_round_thresholds(scores, keep):
    """The thresholds a real first round reveals: the weakest slot."""
    cells = _plain(scores, keep=keep)
    return cells[-2], cells[-1]


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


class TestSegmentedWalk:
    @pytest.mark.parametrize("thresholds", [False, True])
    @pytest.mark.parametrize("keep", [1, 2])
    @pytest.mark.parametrize("segments", range(1, 9))
    def test_any_segment_count_equals_one_walk(
        self, rng, segments, keep, thresholds
    ):
        scores = _tied_scores(rng)
        thr = _first_round_thresholds(scores, keep) if thresholds else None
        blocks = _kernel_bounds(N_CHUNKS, 1, segments)
        got = _segmented(scores, N_VALID, blocks, thr, keep)
        _assert_bitwise(got, _plain(scores, thr, keep))

    @pytest.mark.parametrize(
        "blocks",
        [
            [[(0, 0), (0, 7)], [(7, 7), (7, 10)]],  # empty segments
            [[(0, 1)], [(1, 9)], [(9, 10)]],  # uneven
            [[(0, 3), (3, 3), (3, 4)], [(4, 10)], [(10, 10)]],  # both
            [[(c, c + 1)] for c in range(N_CHUNKS)],  # a chunk each
        ],
        ids=["empty", "uneven", "uneven_and_empty", "one_chunk_each"],
    )
    @pytest.mark.parametrize("keep", [1, 2])
    def test_uneven_and_empty_segments(self, rng, blocks, keep):
        scores = _tied_scores(rng)
        for thr in (None, _first_round_thresholds(scores, keep)):
            got = _segmented(scores, N_VALID, blocks, thr, keep)
            _assert_bitwise(got, _plain(scores, thr, keep))

    @pytest.mark.parametrize(
        "cluster,groups",
        [(1, 1), (4, 8), (4, 1), (8, 8), (8, 2), (2, 3), (8, 1), (4, 2)],
    )
    @pytest.mark.parametrize("keep", [1, 2])
    def test_kernel_segments_over_cluster_and_warps(
        self, rng, cluster, groups, keep
    ):
        """The kernel's two-level split: cluster blocks x warp groups,
        more segments than chunks included (8 x 8 > 10)."""
        scores = _tied_scores(rng)
        thr = _first_round_thresholds(scores, keep)
        blocks = _kernel_bounds(N_CHUNKS, cluster, groups)
        for t in (None, thr):
            got = _segmented(scores, N_VALID, blocks, t, keep)
            _assert_bitwise(got, _plain(scores, t, keep))

    @pytest.mark.parametrize("n_valid", [1, 31, 33, 319, 320])
    def test_n_valid_anywhere(self, rng, n_valid):
        scores = _tied_scores(rng)
        blocks = _kernel_bounds(N_CHUNKS, 4, 2)
        got = _segmented(scores, n_valid, blocks)
        _assert_bitwise(got, _plain(scores, n_valid=n_valid))

    def test_merge_order_does_not_matter(self, rng):
        scores = _tied_scores(rng)
        parts = [_cascade(scores, L, N_VALID, range(c0, c1), None, 2)
                 for c0, c1 in ((0, 3), (3, 6), (6, 10))]
        want = _merge(parts, 2)
        for order in ((2, 1, 0), (1, 0, 2), (0, 2, 1)):
            got = _merge([parts[i] for i in order], 2)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])

    def test_a_naive_merge_would_break_the_tie_order(self):
        """Why the merge compares indices: merged in reverse segment order,
        a strict '>' on scores alone keeps the later segment's tied entry
        first; the explicit comparison keeps the earlier one."""
        scores = np.zeros((1, 2 * L), np.float32)  # every score ties
        parts = [_cascade(scores, L, 2 * L, [ch], None, 2) for ch in (0, 1)]
        naive_i = np.full((2, 1, L), bt.BIG_IDX)
        naive_s = np.full((2, 1, L), -np.inf)
        for pm, pa in parts[::-1]:  # strict '>' on the scores alone
            for k in range(2):
                gt1, gt2 = pm[k] > naive_s[0], pm[k] > naive_s[1]
                naive_s[1] = np.where(gt1, naive_s[0],
                                      np.where(gt2, pm[k], naive_s[1]))
                naive_i[1] = np.where(gt1, naive_i[0],
                                      np.where(gt2, pa[k], naive_i[1]))
                naive_s[0] = np.where(gt1, pm[k], naive_s[0])
                naive_i[0] = np.where(gt1, pa[k], naive_i[0])
        assert (naive_i[0] == np.arange(L) + L).all()  # the later row first
        m, a = _merge(parts[::-1], 2)
        assert (a[0] == np.arange(L)).all() and (a[1] == np.arange(L) + L).all()
        _assert_bitwise(
            _segmented(scores, 2 * L, [[(1, 2)], [(0, 1)]]),
            _plain(scores, n_valid=2 * L),
        )


class TestAgainstJax:
    """On one small shape the segmented model equals the JAX package's
    passes run in interpret mode, bit for bit on integer inputs."""

    E, LJ, NPAD, NV = 16, 128, 1024, 1000

    def _inputs(self, rng):
        q = rng.integers(-4, 5, size=(4, self.E)).astype(np.float32)
        c = rng.integers(-4, 5, size=(self.NPAD, self.E)).astype(np.float32)
        return q, c

    def _model(self, q, c, thr, keep):
        scores = q @ c.T  # exact in fp32 for these integers
        blocks = _kernel_bounds(self.NPAD // self.LJ, 4, 3)
        return _segmented(scores, self.NV, blocks, thr, keep, L=self.LJ)

    def test_top2_rounds_equal_jax(self, rng):
        q, c = self._inputs(rng)
        jq, jc = jnp.asarray(q), jnp.asarray(c)
        j1 = pr.bin_max2_first_round(jq, jc, L=self.LJ, n_valid=self.NV,
                                     interpret=True)
        _assert_bitwise(self._model(q, c, None, 2),
                        [np.asarray(x) for x in j1])
        j2 = pr.bin_max2_round(jq, jc, j1[2], j1[3], L=self.LJ,
                               n_valid=self.NV, interpret=True)
        thr = (np.asarray(j1[2]), np.asarray(j1[3]))
        _assert_bitwise(self._model(q, c, thr, 2),
                        [np.asarray(x) for x in j2])

    def test_top1_rounds_equal_jax(self, rng):
        q, c = self._inputs(rng)
        jq, jc = jnp.asarray(q), jnp.asarray(c)
        inf_s = np.full((4, self.LJ), np.inf, np.float32)
        inf_i = np.full((4, self.LJ), -1, np.int32)
        j1 = pr.bin_max_round(jq, jc, jnp.asarray(inf_s), jnp.asarray(inf_i),
                              L=self.LJ, n_valid=self.NV, interpret=True)
        _assert_bitwise(self._model(q, c, (inf_s, inf_i), 1),
                        [np.asarray(x) for x in j1])
        j2 = pr.bin_max_round(jq, jc, j1[0], j1[1], L=self.LJ,
                              n_valid=self.NV, interpret=True)
        thr = (np.asarray(j1[0]), np.asarray(j1[1]))
        _assert_bitwise(self._model(q, c, thr, 1),
                        [np.asarray(x) for x in j2])


def test_int8_kernels_keep_their_own_bin_tile():
    """The int8 wrappers check L against their kernel's BN, not the bf16
    kernel's."""
    assert qt.INT8_KERNEL_BIN_TILE == 32
    assert not hasattr(qt, "KERNEL_BIN_TILE")


def _fma_scores(q, codes, scales, bias):
    """The int8 rounds' scores, __fmaf_rn(q . codes, scale, bias): the
    integer sum times an fp32 scale is exact in fp64 and the bias is 0 or
    -inf, so one rounding to fp32 is the fused multiply-add's."""
    dot = q.astype(np.float64) @ codes.astype(np.float64).T
    return (dot * scales.astype(np.float64) + bias).astype(np.float32)


def _int8_catalog(rng, kind, n_pad, n_valid, L):
    """Codes, scales and a bias over ``n_pad`` rows as the rounds' driver
    passes them: -inf on ~10% of the valid rows and on bins 0..2 of every
    chunk (cells that stay unfilled), 0 and scale 0 past n_valid."""
    if kind == "ties":
        codes = rng.integers(-2, 3, size=(n_pad, 16)).astype(np.int8)
        scales = np.full(n_pad, 0.5, np.float32)
    else:
        codes = rng.integers(-127, 128, size=(n_pad, 16)).astype(np.int8)
        scales = (rng.random(n_pad) * 0.05 + 1e-3).astype(np.float32)
    bias = np.where(rng.random(n_pad) < 0.1, -np.inf, 0.0).astype(np.float32)
    bias[np.arange(n_pad) % L < 3] = -np.inf
    scales[n_valid:] = 0.0
    bias[n_valid:] = 0.0
    return codes, scales, bias


class TestInt8Rounds:
    """Kernels 6-7 as instances of the split: the segmented model over the
    scaled scores equals the single walk (``scaled_round_plain``) and the
    JAX package's int8 rounds passes in interpret mode, bit for bit."""

    def _inputs(self, rng, kind, n_pad, n_valid, L):
        q = rng.integers(-4, 5, size=(B, 16)).astype(np.float32)
        return (q, *_int8_catalog(rng, kind, n_pad, n_valid, L))

    def _plain(self, q, codes, scales, bias, L, n_valid, thr=None):
        thr = () if thr is None else tuple(torch.tensor(x) for x in thr)
        return [x.numpy() for x in qt.scaled_round_plain(
            torch.tensor(q).to(torch.bfloat16), torch.tensor(codes),
            torch.tensor(scales), torch.tensor(bias), L, n_valid, *thr)]

    @pytest.mark.parametrize("thresholds", [False, True])
    @pytest.mark.parametrize("segments", range(1, 9))
    def test_scaled_split_equals_one_walk(self, rng, segments, thresholds):
        args = self._inputs(rng, "ties", N_CHUNKS * L, N_VALID, L)
        scores = _fma_scores(*args)
        thr = None
        if thresholds:
            thr = self._plain(*args, L, N_VALID)[2:]
        blocks = _kernel_bounds(N_CHUNKS, 1, segments)
        want = self._plain(*args, L, N_VALID, thr)
        _assert_bitwise(_segmented(scores, N_VALID, blocks, thr), want)
        bias = args[3]
        for a in want[1::2]:  # a -inf bias row is never admitted
            filled = a != bt.BIG_IDX
            assert filled.any() and np.isfinite(bias[a[filled]]).all()

    @pytest.mark.parametrize("kind", ["integer", "ties"])
    @pytest.mark.parametrize(
        "cluster,groups", [(1, 1), (1, 5), (2, 3), (4, 2), (8, 8)]
    )
    def test_scaled_rounds_equal_jax(self, rng, kind, cluster, groups):
        LJ, NPAD, NV = 128, 1024, 1000  # NV inside the last chunk
        q, codes, scales, bias = self._inputs(rng, kind, NPAD, NV, LJ)
        scores = _fma_scores(q, codes, scales, bias)
        blocks = _kernel_bounds(NPAD // LJ, cluster, groups)
        jargs = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(codes),
                 jnp.asarray(scales)[None], jnp.asarray(bias)[None])
        j1 = pr.bin_max2_scaled_first_round(*jargs, L=LJ, n_valid=NV,
                                            interpret=True)
        j1 = [np.asarray(x) for x in j1]
        _assert_bitwise(_segmented(scores, NV, blocks, None, 2, L=LJ), j1)
        j2 = pr.bin_max2_scaled_round(*jargs, j1[2], j1[3], L=LJ,
                                      n_valid=NV, interpret=True)
        j2 = [np.asarray(x) for x in j2]
        _assert_bitwise(
            _segmented(scores, NV, blocks, (j1[2], j1[3]), 2, L=LJ), j2)
        _assert_bitwise(
            self._plain(q, codes, scales, bias, LJ, NV, (j1[2], j1[3])), j2)
        for a in j1[1::2] + j2[1::2]:
            filled = a != bt.BIG_IDX
            assert filled.any() and (a[filled] < NV).all()
            assert np.isfinite(bias[a[filled]]).all()


FOLDS = [1, 2, 4, 8]


def _single_pass_catalog(rng, kind, n_pad, n_real, L):
    """Codes, scales and a bias over ``n_pad`` rows as the single pass's
    driver passes them: validity rides the bias, -inf on ~10% of the real
    rows, on bins 0..2 of every sub-tile (cells that stay unfilled) and on
    every pad row past ``n_real``, whose codes and scales are 0."""
    codes, scales, bias = _int8_catalog(rng, kind, n_pad, n_real, L)
    codes[n_real:] = 0
    bias[n_real:] = -np.inf
    return codes, scales, bias


def _raw_scores(q, codes):
    """The raw pass's scores, the integer sum q . codes as it stands: exact
    in fp64 and in fp32 for these inputs."""
    return (q.astype(np.float64) @ codes.astype(np.float64).T).astype(
        np.float32)


def _raw_catalog(rng, kind, n_rows):
    """Raw codes as the global-scale driver passes them: full chunks of real
    rows, no scale, bias or padding."""
    hi = 3 if kind == "ties" else 128
    return rng.integers(-hi + 1, hi, size=(n_rows, 16)).astype(np.int8)


class _FoldSplitCases:
    """The single passes as instances of the split: segments of whole fold
    chunks, the tournament inside each chunk, the merge unchanged. The
    model equals the single walk (``single_pass_plain``) and the JAX
    package's single passes in interpret mode, bit for bit. A subclass
    names the scores: per-row scaled (kernels 3-4) or raw (kernel 5)."""

    N_FOLD = 5  # fold chunks of the catalog
    RAW = False

    def _plain(self, q, codes, scales, bias, fold, L=L):
        scaled = () if self.RAW else (torch.tensor(scales), torch.tensor(bias))
        return [x.numpy() for x in qt.single_pass_plain(
            torch.tensor(q).to(torch.bfloat16), torch.tensor(codes), L, fold,
            *scaled)]

    def _inputs(self, rng, kind, fold, n_fold, L):
        n_pad = n_fold * fold * L
        q = rng.integers(-4, 5, size=(B, 16)).astype(np.float32)
        if self.RAW:
            return q, _raw_catalog(rng, kind, n_pad), None, None
        return (q, *_single_pass_catalog(rng, kind, n_pad, n_pad - L // 2, L))

    def _scores(self, q, codes, scales, bias):
        if self.RAW:
            return _raw_scores(q, codes)
        return _fma_scores(q, codes, scales, bias)

    def _jax(self, q, codes, scales, bias, fold, L):
        qj, cj = jnp.asarray(q, jnp.bfloat16), jnp.asarray(codes)
        if self.RAW:
            out = pr.bin_max2_raw_fold_pass(qj, cj, L=L, F=fold,
                                            interpret=True)
        elif fold == 1:
            out = pr.bin_max2_scaled_single_pass(
                qj, cj, jnp.asarray(scales)[None], jnp.asarray(bias)[None],
                L=L, interpret=True)
        else:
            out = pr.bin_max2_scaled_fold_pass(
                qj, cj, jnp.asarray(scales)[None], jnp.asarray(bias)[None],
                L=L, F=fold, interpret=True)
        return [np.asarray(x) for x in out]

    @pytest.mark.parametrize("kind", ["integer", "ties"])
    @pytest.mark.parametrize(
        "cluster,groups",
        [(1, 1), (1, 3), (2, 3), (4, 2), (8, 1), (8, 8)],
    )
    @pytest.mark.parametrize("fold", FOLDS)
    def test_fold_split_equals_single_pass_plain(self, rng, fold, cluster,
                                                 groups, kind):
        """Any cluster x group count, more segments than chunks (empty
        segments) included."""
        args = self._inputs(rng, kind, fold, self.N_FOLD, L)
        n_pad = args[1].shape[0]
        blocks = _kernel_bounds(self.N_FOLD, cluster, groups)
        got = _segmented(self._scores(*args), n_pad, blocks, fold=fold)
        want = self._plain(*args, fold)
        _assert_bitwise(got, want)
        bias = args[3]
        for a in want[1::2]:
            filled = a != bt.BIG_IDX
            if self.RAW:  # every cell sees N_FOLD winners
                assert filled.all()
            else:  # a -inf bias row is never admitted
                assert filled.any() and not filled.all()
                assert np.isfinite(bias[a[filled]]).all()

    @pytest.mark.parametrize(
        "blocks",
        [
            [[(0, 0), (0, 3)], [(3, 3), (3, 5)]],  # empty segments
            [[(0, 1)], [(1, 4)], [(4, 5)]],  # uneven
            [[(c, c + 1)] for c in range(5)],  # a chunk each
        ],
        ids=["empty", "uneven", "one_chunk_each"],
    )
    @pytest.mark.parametrize("fold", FOLDS)
    def test_uneven_and_empty_fold_segments(self, rng, fold, blocks):
        args = self._inputs(rng, "ties", fold, self.N_FOLD, L)
        got = _segmented(self._scores(*args), args[1].shape[0], blocks,
                         fold=fold)
        _assert_bitwise(got, self._plain(*args, fold))

    @pytest.mark.parametrize("kind", ["integer", "ties"])
    @pytest.mark.parametrize("fold", FOLDS)
    def test_fold_split_equals_jax(self, rng, fold, kind):
        LJ = 128
        args = self._inputs(rng, kind, fold, 2, LJ)
        n_pad = args[1].shape[0]
        want = self._jax(*args, fold, LJ)
        scores = self._scores(*args)
        for cluster, groups in ((1, 1), (2, 1), (2, 4)):
            blocks = _kernel_bounds(2, cluster, groups)
            got = _segmented(scores, n_pad, blocks, L=LJ, fold=fold)
            _assert_bitwise(got, want)
        _assert_bitwise(self._plain(*args, fold, LJ), want)


class TestFoldSplit(_FoldSplitCases):
    """Kernels 3-4, the per-row single passes, over scaled scores with -inf
    bias rows."""

    def test_a_sub_tile_split_would_change_the_survivors(self):
        """Why segments hold whole fold chunks: cut one chunk of F = 2 at
        its sub-tile boundary and each half sends its own winner, so two
        rows of one (chunk, bin) survive, where the single walk keeps the
        tournament's one winner and leaves the second slot unfilled."""
        fold = 2
        scores = np.zeros((1, fold * L), np.float32)
        scores[:, :L] = 2.0  # slot 0 wins every bin
        scores[:, L:] = 1.0
        one_chunk = _segmented(scores, fold * L, [[(0, 1)]], fold=fold)
        np.testing.assert_array_equal(one_chunk[1][0], np.arange(L))
        assert (one_chunk[3] == bt.BIG_IDX).all()
        _assert_bitwise(one_chunk, [x.numpy() for x in qt.single_pass_plain(
            torch.ones(1, 1), torch.ones(fold * L, 1, dtype=torch.int8), L,
            fold, torch.tensor(scores[0]), torch.zeros(fold * L))])
        # the same rows split at the sub-tile boundary, as two chunks of
        # one sub-tile
        split = _segmented(scores, fold * L, [[(0, 1)], [(1, 2)]], fold=1)
        np.testing.assert_array_equal(split[1][0], np.arange(L))
        np.testing.assert_array_equal(split[3][0], np.arange(L) + L)
        assert not np.array_equal(split[3], one_chunk[3])


class TestRawFoldSplit(_FoldSplitCases):
    """Kernel 5, the global-scale index's raw single pass, as the template's
    raw kind: the same split over the raw sums, full chunks of real rows, no
    scale, bias or mask."""

    RAW = True

    @pytest.mark.parametrize(
        "fold,n_fold,cluster,groups",
        [(8, 6, 2, 4), (16, 12, 4, 4), (2, 25, 2, 1), (1, 51, 1, 1)],
        ids=["F8_6_over_8", "F16_12_over_16", "F2_25_over_2",
             "F1_51_over_1"],
    )
    def test_served_chunk_counts(self, rng, fold, n_fold, cluster, groups):
        """The chunk and segment counts of the served plans (F, L, B) =
        (8, 2048, <= 16), (16, 512, 16), (2, 2048, 128), (1, 2048, 1024)
        over the 105,542 real articles: 6 full chunks over 2 blocks of 4
        groups leave 2 segments empty, 12 over 16 leave 4."""
        args = self._inputs(rng, "integer", fold, n_fold, L)
        blocks = _kernel_bounds(n_fold, cluster, groups)
        if n_fold < cluster * groups:
            assert any(c0 == c1 for segs in blocks for c0, c1 in segs)
        got = _segmented(self._scores(*args), args[1].shape[0], blocks,
                         fold=fold)
        _assert_bitwise(got, self._plain(*args, fold))

    def test_raw_scores_need_no_epilogue(self):
        """The raw kind hands each sum to the tournament as it stands. An
        identity epilogue written as fmaf(sum, 1, 0) is not one: it turns a
        -0 sum into +0, so the cells whose maximum is -0 would change their
        bits."""
        fold, n_fold = 2, 3
        scores = np.full((1, n_fold * fold * L), -1.0, np.float32)
        scores[:, L:2 * L] = -0.0  # slot 1 of chunk 0 wins every bin
        blocks = _kernel_bounds(n_fold, 2, 2)
        raw = _segmented(scores, scores.shape[1], blocks, fold=fold)
        assert (raw[0] == 0).all() and np.signbit(raw[0]).all()
        np.testing.assert_array_equal(raw[1][0], np.arange(L) + L)
        assert (raw[2] == -1).all()
        _assert_bitwise(raw, _segmented(scores, scores.shape[1],
                                        [[(0, n_fold)]], fold=fold))
        # fmaf(s, 1, 0), one rounding of the exact s * 1 + 0
        fma = (scores.astype(np.float64) * 1.0 + 0.0).astype(np.float32)
        fma = _segmented(fma, scores.shape[1], blocks, fold=fold)
        assert (fma[0] == 0).all() and not np.signbit(fma[0]).any()
        np.testing.assert_array_equal(fma[1], raw[1])
        assert not np.array_equal(fma[0].view(np.int32),
                                  raw[0].view(np.int32))
