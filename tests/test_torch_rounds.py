"""The port's refinement rounds held against the JAX package's Pallas
functions run in interpret mode on the CPU: the int8 rounds passes
(kernels 6-7, hm_retrieval_tpu_torch/ops/quantized_topk.py), the single-keep
pass (kernel 8, ops/bin_topk.py) and the drivers that run them:
quantized_topk with max_rounds > 1, exact_topk with keep_per_bin=1, and the
lockstep driver.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py.

Tolerances. Integer-valued queries in [-4, 4] (exact in bf16) make every
dot product with the int8 codes (or integer catalog rows) an exact integer,
times one correctly rounded scale, so the outputs must be bit-identical; the
"ties" catalog (codes in [-2, 2], one scale) ties heavily, which tests the
(score desc, index asc) order. Normal inputs run with fp32 operands on both
sides, which sum in another order: values must agree within 1e-5 relative
(test_torch_bin_topk.TOL), and ids wherever the competing scores differ by
more.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.ops import pallas_retrieval as pr
from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.ops import quantized_topk as qt
from test_torch_bin_topk import TOL, _assert_same_ranking, _inputs

E, L = 16, 256


def _int8_catalog(rng, kind, n_pad, n_valid):
    """Codes, scales (0 on pad rows) and a bias (0, -inf on ~5% of the
    rows and on every row of bins 0..6, 0 on pad rows, as the drivers pad
    it) over ``n_pad`` rows, and queries of ``kind``."""
    if kind == "ties":
        codes = rng.integers(-2, 3, size=(n_pad, E)).astype(np.int8)
        scales = np.full(n_pad, 0.5, np.float32)
    else:
        codes = rng.integers(-127, 128, size=(n_pad, E)).astype(np.int8)
        scales = (rng.random(n_pad) * 0.05 + 1e-3).astype(np.float32)
    scales[n_valid:] = 0.0
    bias = np.where(rng.random(n_pad) < 0.05, -np.inf, 0.0).astype(np.float32)
    bias[np.arange(n_pad) % L < 7] = -np.inf  # these cells stay unfilled
    bias[n_valid:] = 0.0
    return codes, scales, bias


def _queries(rng, kind, B):
    if kind == "normal":
        return rng.normal(size=(B, E)).astype(np.float32)
    return rng.integers(-4, 5, size=(B, E)).astype(np.float32)


def _dtypes(kind):
    """(JAX, torch) compute dtypes: bf16 for exact integer inputs, fp32
    for normal inputs."""
    if kind == "normal":
        return jnp.float32, torch.float32
    return jnp.bfloat16, torch.bfloat16


def _scaled_scores(q, codes, scales, bias, n_valid):
    s = q.astype(np.float64) @ codes.astype(np.float64).T * scales + bias
    s[:, n_valid:] = -np.inf
    return np.where(np.isfinite(s), s, -np.inf)


def _assert_cells(got, want, scores, exact):
    got = [g.numpy() for g in got]
    for vi in range(0, len(got), 2):
        _assert_same_ranking(got[vi], got[vi + 1], want[vi], want[vi + 1],
                             scores, exact)


class TestScaledRoundsPasses:
    """Kernels 6 and 7 (plain versions) against the JAX wrappers."""

    @pytest.mark.parametrize("kind", ["integer", "ties", "normal"])
    def test_first_and_refinement_rounds_match_jax(self, rng, kind):
        B, n_pad = 8, 4 * L
        n_valid = n_pad - L // 2 - 3  # cuts into the last chunk
        q = _queries(rng, kind, B)
        codes, scales, bias = _int8_catalog(rng, kind, n_pad, n_valid)
        jdt, tdt = _dtypes(kind)
        jargs = (jnp.asarray(q, jdt), jnp.asarray(codes),
                 jnp.asarray(scales)[None], jnp.asarray(bias)[None])
        targs = (torch.tensor(q).to(tdt), torch.tensor(codes),
                 torch.tensor(scales), torch.tensor(bias))
        scores = _scaled_scores(q, codes, scales, bias, n_valid)
        exact = kind != "normal"
        want = pr.bin_max2_scaled_first_round(
            *jargs, L=L, n_valid=n_valid, interpret=True
        )
        got = qt.bin_max2_scaled_first_round(*targs, L, n_valid)
        _assert_cells(got, want, scores, exact)
        for a in (got[1], got[3]):
            assert bool((a[:, :7] == bt.BIG_IDX).all())
            assert bool(((a < n_valid) | (a == bt.BIG_IDX)).all())
        # two refinement rounds, each chain on its own thresholds
        for _ in range(2):
            want = pr.bin_max2_scaled_round(
                *jargs, want[2], want[3], L=L, n_valid=n_valid,
                interpret=True,
            )
            got = qt.bin_max2_scaled_round(*targs, got[2], got[3], L, n_valid)
            _assert_cells(got, want, scores, exact)
            # a cell whose threshold is -inf admits nothing (trap g)
            assert bool(torch.isneginf(got[0][:, :7]).all())
            assert bool((got[1][:, :7] == bt.BIG_IDX).all())

    def test_rounds_reveal_each_cell_in_order(self, rng):
        """Chained rounds reveal every valid row of a cell exactly once, in
        (score desc, index asc) order."""
        B, n_pad = 3, 6 * L
        n_valid = n_pad
        q = torch.tensor(_queries(rng, "integer", B))
        codes, scales, bias = (torch.tensor(a) for a in _int8_catalog(
            rng, "ties", n_pad, n_valid))
        bias.zero_()
        cells = [qt.bin_max2_scaled_first_round(q, codes, scales, bias, L,
                                                n_valid)]
        for _ in range(2):
            cells.append(qt.bin_max2_scaled_round(
                q, codes, scales, bias, cells[-1][2], cells[-1][3], L, n_valid
            ))
        ids = torch.stack([c[i] for c in cells for i in (1, 3)], dim=2)
        vals = torch.stack([c[i] for c in cells for i in (0, 2)], dim=2)
        assert bool((ids % L == torch.arange(L).view(1, L, 1)).all())
        order = torch.tensor(
            _scaled_scores(q.numpy(), codes.numpy(), scales.numpy(),
                           bias.numpy(), n_valid)
        )
        want = torch.gather(order, 1, ids.view(B, -1).long()).view(ids.shape)
        assert torch.equal(vals.double(), want)
        assert bool((vals[..., :-1] >= vals[..., 1:]).all())
        ties = vals[..., :-1] == vals[..., 1:]
        assert bool((ids[..., :-1] < ids[..., 1:])[ties].all())
        assert torch.equal(ids.view(B, -1).sort(dim=1).values,
                           torch.arange(n_pad, dtype=torch.int32).expand(B, -1))

    @pytest.mark.parametrize(
        "bad", ["threshold_shape", "threshold_dtype", "n_valid", "scales"]
    )
    def test_wrapper_validation(self, bad):
        q = torch.zeros(4, 16)
        codes = torch.zeros(512, 16, dtype=torch.int8)
        scales, bias = torch.ones(512), torch.zeros(512)
        thr_s = torch.zeros(4, 128)
        thr_i = torch.zeros(4, 128, dtype=torch.int32)
        n_valid = 500
        if bad == "threshold_shape":
            thr_s = torch.zeros(4, 64)
        elif bad == "threshold_dtype":
            thr_i = torch.zeros(4, 128)
        elif bad == "n_valid":
            n_valid = 600
        else:
            scales = torch.ones(500)
        with pytest.raises((ValueError, TypeError)):
            qt.bin_max2_scaled_round(q, codes, scales, bias, thr_s, thr_i,
                                     128, n_valid)

    def test_non_cpu_tensor_is_never_run_on_the_plain_path(self):
        q = torch.zeros(4, 16, device="meta")
        codes = torch.zeros(512, 16, dtype=torch.int8, device="meta")
        ones = torch.ones(512, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            qt.bin_max2_scaled_first_round(q, codes, ones, ones, 128, 500)


class TestSingleKeepPass:
    """Kernel 8 (plain version) against the JAX wrapper: round 1 at +inf /
    -1 thresholds, then rounds on each chain's own thresholds."""

    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize("n_valid", [1024, 1000])
    def test_bin_max_round_matches_jax(self, rng, kind, n_valid):
        B = 8
        q, c = _inputs(rng, kind, B, 1024, E)
        scores = q.astype(np.float64) @ c.astype(np.float64).T
        scores[:, n_valid:] = -np.inf
        thr = (np.full((B, L), np.inf, np.float32),
               np.full((B, L), -1, np.int32))
        want, got = thr, tuple(torch.tensor(t) for t in thr)
        for _ in range(3):
            want = pr.bin_max_round(
                jnp.asarray(q), jnp.asarray(c), jnp.asarray(want[0]),
                jnp.asarray(want[1]), L=L, n_valid=n_valid, interpret=True,
            )
            got = bt.bin_max_round(torch.tensor(q), torch.tensor(c), got[0],
                                   got[1], L, n_valid)
            assert len(got) == 2
            _assert_cells(got, want, scores, exact=kind == "integer")
            assert bool(((got[1] < n_valid) | (got[1] == bt.BIG_IDX)).all())

    def test_exhausted_threshold_admits_nothing(self, rng):
        q, c = _inputs(rng, "normal", 2, 512, E)
        m, a = bt.bin_max_round(
            torch.tensor(q), torch.tensor(c),
            torch.full((2, L), float("-inf")),
            torch.full((2, L), bt.BIG_IDX, dtype=torch.int32), L, 512,
        )
        assert bool(torch.isneginf(m).all()) and bool((a == bt.BIG_IDX).all())

    def test_non_cpu_tensor_is_never_run_on_the_plain_path(self):
        q = torch.zeros(4, 16, device="meta")
        c = torch.zeros(256, 16, device="meta")
        thr_s = torch.zeros(4, 64, device="meta")
        thr_i = torch.zeros(4, 64, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            bt.bin_max_round(q, c, thr_s, thr_i, 64, 256)


class TestQuantizedRounds:
    """quantized_topk with max_rounds > 1 against pallas_quantized_topk."""

    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize("max_rounds", [2, 8])
    @pytest.mark.parametrize("B", [8, 256])
    def test_matches_jax(self, rng, kind, max_rounds, B):
        N, n_valid, k = 3000, 2600, 100
        q = _queries(rng, kind, B)
        codes = rng.integers(-127, 128, size=(N, E)).astype(np.int8)
        scales = (rng.random(N) * 0.05 + 1e-3).astype(np.float32)
        bias = np.where(rng.random(N) < 0.05, -np.inf, 0.0).astype(np.float32)
        jdt, tdt = _dtypes(kind)
        wv, wi, wr = pr.pallas_quantized_topk(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), k,
            n_valid=n_valid, bias=jnp.asarray(bias), L=L,
            max_rounds=max_rounds, interpret=True, compute_dtype=jdt,
        )
        v, i, rounds = qt.quantized_topk(
            torch.tensor(q), torch.tensor(codes), torch.tensor(scales), k,
            n_valid=n_valid, bias=torch.tensor(bias), L=L,
            max_rounds=max_rounds, compute_dtype=tdt,
        )
        assert rounds == int(wr) and 2 <= rounds <= max_rounds
        scores = _scaled_scores(q, codes, scales, bias, n_valid)
        _assert_same_ranking(v.numpy(), i.numpy(), wv, wi, scores,
                             exact=kind == "integer")
        assert i.numpy().max() < n_valid
        if rounds < max_rounds:  # the stop rule held: the exact top-k
            want = np.sort(scores, axis=1)[:, ::-1][:, :k]
            np.testing.assert_allclose(v.numpy(), want, rtol=TOL)

    def test_blocks_refine_on_their_own(self, rng):
        """max_rounds caps each block of 128 rows: a batch answers as its
        blocks answer alone, and its rounds are their maximum."""
        N, k = 3000, 100
        q = torch.tensor(_queries(rng, "integer", 200))
        codes = torch.tensor(rng.integers(-127, 128, size=(N, E)),
                             dtype=torch.int8)
        scales = torch.tensor(rng.random(N) * 0.05 + 1e-3, dtype=torch.float32)
        v, i, rounds = qt.quantized_topk(q, codes, scales, k, L=L,
                                         max_rounds=2)
        parts = [qt.quantized_topk(q[s:s + 128], codes, scales, k, L=L,
                                   max_rounds=2) for s in (0, 128)]
        assert torch.equal(v, torch.cat([p[0] for p in parts]))
        assert torch.equal(i, torch.cat([p[1] for p in parts]))
        assert rounds == max(p[2] for p in parts)

    @pytest.mark.parametrize("n_valid, rows", [(2600, 2816), (3000, 3072)])
    def test_rounds_stream_only_chunks_with_a_valid_row(
        self, rng, monkeypatch, n_valid, rows
    ):
        """Every pass gets the ceil(n_valid / L) chunks that hold a valid
        row, padded with zero codes, scales and bias, and nothing past
        them."""
        N, k = 3000, 100
        seen = []
        for name in ("bin_max2_scaled_first_round", "bin_max2_scaled_round"):
            def record(q, codes, scales, bias, *args, _wrapper=getattr(qt, name)):
                seen.append((codes, scales, bias))
                return _wrapper(q, codes, scales, bias, *args)

            monkeypatch.setattr(qt, name, record)
        q = torch.tensor(_queries(rng, "integer", 8))
        codes = torch.tensor(rng.integers(-127, 128, size=(N, E)),
                             dtype=torch.int8)
        scales = torch.tensor(rng.random(N) * 0.05 + 1e-3, dtype=torch.float32)
        bias = torch.zeros(N)
        qt.quantized_topk(q, codes, scales, k, n_valid=n_valid, bias=bias,
                          L=L, max_rounds=3)
        assert len(seen) >= 2
        for c, s, b in seen:
            assert c.shape == (rows, E) and s.shape == b.shape == (rows,)
            m = min(N, rows)
            assert torch.equal(c[:m], codes[:m]) and not bool(c[m:].any())
            assert torch.equal(s[:m], scales[:m]) and not bool(s[m:].any())
            assert not bool(b.any())

    def test_default_arguments_match_jax(self, rng):
        """Both drivers' defaults: the rounds (max_rounds 8), bf16 operands
        and the rounds' bin count, default_bins(k) = 512 at k = 60."""
        N, k = 3000, 60
        q = _queries(rng, "integer", 12)
        codes = rng.integers(-127, 128, size=(N, E)).astype(np.int8)
        scales = (rng.random(N) * 0.05 + 1e-3).astype(np.float32)
        wv, wi, wr = pr.pallas_quantized_topk(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), k,
            interpret=True,
        )
        v, i, rounds = qt.quantized_topk(
            torch.tensor(q), torch.tensor(codes), torch.tensor(scales), k
        )
        assert rounds == int(wr) > 1
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))

    def test_validation(self):
        q = torch.zeros(4, 16)
        codes = torch.zeros(512, 16, dtype=torch.int8)
        scales = torch.ones(512)
        with pytest.raises(ValueError, match="fold"):
            qt.quantized_topk(q, codes, scales, 5, max_rounds=2, fold=2)
        with pytest.raises(ValueError, match="<= L"):
            qt.quantized_topk(q, codes, scales, 300, L=256, max_rounds=8)
        big = torch.zeros(3000, 16, dtype=torch.int8)
        with pytest.raises(ValueError, match="bin count"):
            qt.quantized_topk(q, big, torch.ones(3000), 2049, max_rounds=8)


class TestExactSingleKeep:
    """exact_topk(keep_per_bin=1) against pallas_exact_topk."""

    @pytest.mark.parametrize("N", [512, 1000, 4096])
    def test_random_matches_jax_and_oracle(self, rng, N):
        B, k = 8, 10
        q, c = _inputs(rng, "normal", B, N, 32)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            compute_dtype=jnp.float32, keep_per_bin=1,
        )
        v, i, rounds = bt.exact_topk(
            torch.tensor(q), torch.tensor(c), k, L=L,
            compute_dtype=torch.float32, keep_per_bin=1,
        )
        assert rounds == int(jr)
        scores = q.astype(np.float64) @ c.astype(np.float64).T
        _assert_same_ranking(v.numpy(), i.numpy(), jv, ji, scores, False)
        oracle = np.sort(scores, axis=1)[:, ::-1][:, :k]
        np.testing.assert_allclose(v.numpy(), oracle, rtol=TOL)

    @pytest.mark.parametrize("depth, k, exact", [(6, 5, True), (12, 10, False)])
    def test_single_bin_collision(self, rng, depth, k, exact):
        """Every winner lands in bin 7, stride 128 apart: one round per
        collision. At depth 12 the 8-pass cap comes first, and the port
        returns the JAX package's inexact leaderboard."""
        B, Lc = 2, 128
        c = rng.normal(size=(Lc * 16, E)).astype(np.float32) * 1e-3
        q = np.ones((B, E), np.float32)
        for j in range(depth):
            c[7 + j * Lc] = (20 - j) * np.ones(E) / E
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=Lc, interpret=True,
            compute_dtype=jnp.float32, keep_per_bin=1,
        )
        v, i, rounds = bt.exact_topk(
            torch.tensor(q), torch.tensor(c), k, L=Lc,
            compute_dtype=torch.float32, keep_per_bin=1,
        )
        assert rounds == int(jr) >= 5
        assert (rounds < bt.MAX_ROUNDS) == exact
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL)
        oracle = np.sort(q @ c.T, axis=1)[:, ::-1][:, :k]
        assert np.allclose(v.numpy(), oracle, rtol=TOL) == exact

    def test_integer_ties_bit_identical(self, rng):
        B, N, k = 6, 3000, 20
        q, c = _inputs(rng, "integer", B, N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            keep_per_bin=1,
        )
        v, i, rounds = bt.exact_topk(torch.tensor(q), torch.tensor(c), k,
                                     L=L, keep_per_bin=1)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert rounds == int(jr)

    def test_default_bins_bf16_blocks(self, rng):
        """The served dtype, the default L (default_bins(k, 1) = 384 at
        k = 90), a ragged last query block."""
        B, N, k = 130, 5000, 90
        q, c = _inputs(rng, "integer", B, N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, interpret=True, keep_per_bin=1
        )
        v, i, rounds = bt.exact_topk(torch.tensor(q), torch.tensor(c), k,
                                     keep_per_bin=1)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert rounds == int(jr)

    def test_keep_per_bin_validation(self):
        with pytest.raises(ValueError, match="keep_per_bin"):
            bt.exact_topk(torch.zeros(2, 8), torch.zeros(512, 8), 5,
                          keep_per_bin=3)
        with pytest.raises(ValueError, match="keep_per_bin"):
            pr.pallas_exact_topk(jnp.zeros((2, 8)), jnp.zeros((512, 8)), 5,
                                 interpret=True, keep_per_bin=3)


class TestDefaultBins:
    @pytest.mark.parametrize("keep", [1, 2])
    def test_default_bins_equal_pick_bins(self, keep):
        for B, E_, k in itertools.product(
            (1, 16, 128), (16, 128, 256),
            (1, 10, 32, 48, 64, 100, 128, 200, 256, 300, 1000, 2048),
        ):
            assert bt.default_bins(k, keep) == pr.pick_bins(B, E_, k, keep), (
                B, E_, k)

    def test_keep_one_at_the_served_k(self):
        assert (bt.default_bins(100, 1), bt.default_bins(100)) == (512, 1024)
        assert bt.default_bins(1000, 1) == bt.default_bins(1000) == 2048


class TestLockstep:
    def test_lockstep_matches_jax_and_per_block(self, rng):
        """As the JAX package's lockstep test, at L = 256: the lockstep
        driver equals the per-block one, and both the exact top-k."""
        B, N, k = 256, 3000, 50
        q, c = _inputs(rng, "normal", B, N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            compute_dtype=jnp.float32, q_block=128, lockstep=True,
        )
        bt.reset_launches()
        v1, i1, r1 = bt.exact_topk(torch.tensor(q), torch.tensor(c), k, L=L,
                                   compute_dtype=torch.float32, lockstep=True)
        v0, i0, r0 = bt.exact_topk(torch.tensor(q), torch.tensor(c), k, L=L,
                                   compute_dtype=torch.float32)
        assert set(bt.LAUNCHES.values()) == {0}
        assert r1 == int(jr) == r0
        scores = q.astype(np.float64) @ c.astype(np.float64).T
        _assert_same_ranking(v1.numpy(), i1.numpy(), jv, ji, scores, False)
        np.testing.assert_array_equal(i1.numpy(), i0.numpy())
        np.testing.assert_array_equal(v1.numpy(), v0.numpy())
        oracle = np.sort(scores, axis=1)[:, ::-1][:, :k]
        np.testing.assert_allclose(v1.numpy(), oracle, rtol=TOL)

    def test_lockstep_integer_ties_bit_identical(self, rng):
        B, N, k = 256, 2000, 30
        q, c = _inputs(rng, "integer", B, N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            lockstep=True,
        )
        v, i, rounds = bt.exact_topk(torch.tensor(q), torch.tensor(c), k,
                                     L=L, lockstep=True)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert rounds == int(jr)

    @pytest.mark.parametrize(
        "B, keep, raises", [(200, 2, True), (256, 1, True), (100, 1, False)]
    )
    def test_lockstep_validation(self, rng, B, keep, raises):
        """Refused where the JAX package refuses: B > 128 not a multiple of
        128, or keep 1 with more than one block; one block takes the
        per-block loop."""
        q, c = _inputs(rng, "normal", B, 1000, E)
        args = (jnp.asarray(q), jnp.asarray(c), 10)
        kw = dict(L=L, lockstep=True, keep_per_bin=keep)
        if raises:
            with pytest.raises(ValueError, match="divisible"):
                pr.pallas_exact_topk(*args, interpret=True, q_block=128, **kw)
            with pytest.raises(ValueError, match="divisible"):
                bt.exact_topk(torch.tensor(q), torch.tensor(c), 10, **kw)
            return
        jv, ji, jr = pr.pallas_exact_topk(*args, interpret=True, q_block=128,
                                          **kw)
        v, i, rounds = bt.exact_topk(torch.tensor(q), torch.tensor(c), 10,
                                     **kw)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert rounds == int(jr)
