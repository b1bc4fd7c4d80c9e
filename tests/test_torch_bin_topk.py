"""The port's streaming top-k (hm_retrieval_tpu_torch/ops/bin_topk.py) held
against the JAX package's Pallas functions run in interpret mode on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py.

Tolerances. Integer-valued inputs make every product and sum exact in fp32,
so the outputs must be bit-identical (and they tie heavily, which tests the
(score desc, index asc) order). For random normal inputs the two packages
sum in another order, so scores may differ in the last bits: values must
agree within TOL, and ids wherever the competing scores differ by more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.ops import pallas_retrieval as pr
from hm_retrieval_tpu.ops.topk import topk_pair as jax_topk_pair
from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.ops.topk import topk_dot, topk_pair

TOL = 1e-5  # relative to max(1, |score|), fp32 summation-order noise


def _inputs(rng, kind, B, N, E):
    if kind == "integer":
        q = rng.integers(-4, 5, size=(B, E)).astype(np.float32)
        c = rng.integers(-4, 5, size=(N, E)).astype(np.float32)
    else:
        q = rng.normal(size=(B, E)).astype(np.float32)
        c = rng.normal(size=(N, E)).astype(np.float32)
    return q, c


def _assert_same_ranking(got_v, got_i, want_v, want_i, scores, exact):
    """Values within TOL and ids equal except between near-equal scores;
    bit-identical when ``exact``. ``scores`` is the fp64 (B, N) matrix."""
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    if exact:
        np.testing.assert_array_equal(got_v, want_v)
        np.testing.assert_array_equal(got_i, want_i)
        return
    finite = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    tol = TOL * np.maximum(1.0, np.abs(want_v[finite]))
    assert np.all(np.abs(got_v[finite] - want_v[finite]) <= tol)
    diff = got_i != want_i
    assert not np.any(diff & ~finite), "unfilled slots must match"
    rows = np.nonzero(diff)[0]
    s_got = scores[rows, got_i[diff]]
    s_want = scores[rows, want_i[diff]]
    assert np.all(np.abs(s_got - s_want) <= 2 * TOL * np.maximum(1.0, np.abs(s_want)))


def _jax_round1(q, c_pad, L, n_valid):
    return pr.bin_max2_first_round(
        jnp.asarray(q), jnp.asarray(c_pad), L=L, n_valid=n_valid,
        interpret=True,
    )


def _padded(c, L):
    n_pad = -(-len(c) // L) * L
    out = np.zeros((n_pad, c.shape[1]), np.float32)
    out[: len(c)] = c
    return out


class TestBinMax2Passes:
    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize("n_valid", [1024, 1000, 77])
    def test_first_round_matches_jax(self, rng, kind, n_valid):
        B, E, L = 8, 16, 128
        q, c = _inputs(rng, kind, B, 1024, E)
        want = _jax_round1(q, c, L, n_valid)
        got = bt.bin_max2_first_round(
            torch.tensor(q), torch.tensor(c), L, n_valid
        )
        scores = q.astype(np.float64) @ c.astype(np.float64).T
        for (gv, gi), (wv, wi) in (((0, 1), (0, 1)), ((2, 3), (2, 3))):
            _assert_same_ranking(
                got[gv].numpy(), got[gi].numpy(), want[wv], want[wi],
                scores, exact=kind == "integer",
            )
        for a in (got[1].numpy(), got[3].numpy()):
            assert np.all((a < n_valid) | (a == bt.BIG_IDX))

    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize("n_valid", [1024, 900])
    def test_refinement_round_matches_jax(self, rng, kind, n_valid):
        """Thresholds from a real round 1; each chain refines with its
        own round-1 thresholds (for integer inputs they are identical)."""
        B, E, L = 8, 16, 128
        q, c = _inputs(rng, kind, B, 1024, E)
        _, _, jm2, ja2 = _jax_round1(q, c, L, n_valid)
        want = pr.bin_max2_round(
            jnp.asarray(q), jnp.asarray(c), jm2, ja2, L=L,
            n_valid=n_valid, interpret=True,
        )
        qt, ct = torch.tensor(q), torch.tensor(c)
        _, _, tm2, ta2 = bt.bin_max2_first_round(qt, ct, L, n_valid)
        if kind == "integer":
            np.testing.assert_array_equal(tm2.numpy(), np.asarray(jm2))
            np.testing.assert_array_equal(ta2.numpy(), np.asarray(ja2))
        got = bt.bin_max2_round(qt, ct, tm2, ta2, L, n_valid)
        scores = q.astype(np.float64) @ c.astype(np.float64).T
        for gv, gi in ((0, 1), (2, 3)):
            _assert_same_ranking(
                got[gv].numpy(), got[gi].numpy(), want[gv], want[gi],
                scores, exact=kind == "integer",
            )

    def test_exhausted_threshold_admits_nothing(self, rng):
        B, E, L = 2, 16, 64
        q, c = _inputs(rng, "normal", B, 256, E)
        thr_s = torch.full((B, L), float("-inf"))
        thr_i = torch.full((B, L), bt.BIG_IDX, dtype=torch.int32)
        m1, a1, m2, a2 = bt.bin_max2_round(
            torch.tensor(q), torch.tensor(c), thr_s, thr_i, L, 256
        )
        assert torch.isneginf(m1).all() and torch.isneginf(m2).all()
        assert (a1 == bt.BIG_IDX).all() and (a2 == bt.BIG_IDX).all()

    @pytest.mark.parametrize(
        "bad",
        ["width", "ragged_catalog", "threshold_shape", "threshold_dtype"],
    )
    def test_wrapper_validation(self, bad):
        q = torch.zeros(4, 16)
        c = torch.zeros(256, 16)
        thr_s = torch.zeros(4, 64)
        thr_i = torch.zeros(4, 64, dtype=torch.int32)
        if bad == "width":
            c = torch.zeros(256, 8)
        elif bad == "ragged_catalog":
            c = torch.zeros(250, 16)
        elif bad == "threshold_shape":
            thr_s = torch.zeros(4, 32)
        else:
            thr_i = torch.zeros(4, 64)
        with pytest.raises((ValueError, TypeError)):
            bt.bin_max2_round(q, c, thr_s, thr_i, 64, 256)

    def test_non_cpu_tensor_is_never_run_on_the_plain_path(self):
        q = torch.zeros(4, 16, device="meta")
        c = torch.zeros(256, 16, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            bt.bin_max2_first_round(q, c, 64, 256)


class TestExactTopk:
    @pytest.mark.parametrize("N", [512, 1000, 4096])
    def test_random_matches_jax_and_oracle(self, rng, N):
        B, E, k, L = 8, 32, 10, 256
        q, c = _inputs(rng, "normal", B, N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            compute_dtype=jnp.float32,
        )
        v, i, rounds = bt.exact_topk(
            torch.tensor(q), torch.tensor(c), k, L=L,
            compute_dtype=torch.float32,
        )
        assert rounds == int(jr)
        scores = q.astype(np.float64) @ c.astype(np.float64).T
        _assert_same_ranking(v.numpy(), i.numpy(), jv, ji, scores, False)
        oracle = np.sort(scores, axis=1)[:, ::-1][:, :k]
        np.testing.assert_allclose(v.numpy(), oracle, rtol=TOL)
        np.testing.assert_allclose(
            np.take_along_axis(scores, i.numpy().astype(np.int64), 1),
            v.numpy(),
            rtol=TOL,
        )

    def test_adversarial_single_bin_collision(self, rng):
        # every winner lands in bin 7, stride L apart
        B, E, k, L = 2, 16, 5, 128
        c = rng.normal(size=(L * 8, E)).astype(np.float32) * 1e-3
        q = np.ones((B, E), np.float32)
        for j in range(6):
            c[7 + j * L] = (10 - j) * np.ones(E) / E
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            compute_dtype=jnp.float32,
        )
        v, i, rounds = bt.exact_topk(
            torch.tensor(q), torch.tensor(c), k, L=L,
            compute_dtype=torch.float32,
        )
        assert rounds == int(jr) and 2 <= rounds <= 4
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL)
        np.testing.assert_array_equal(
            i.numpy()[0], [7 + j * L for j in range(k)]
        )

    def test_duplicate_score_ties_resolve_like_jax(self):
        B, E, k, L, N = 1, 8, 4, 64, 256
        c = np.zeros((N, E), np.float32)
        tied = [3, 67, 131, 150, 195, 200]
        for j in tied:
            c[j] = np.ones(E) / E
        q = np.ones((B, E), np.float32)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            compute_dtype=jnp.float32,
        )
        v, i, rounds = bt.exact_topk(
            torch.tensor(q), torch.tensor(c), k, L=L,
            compute_dtype=torch.float32,
        )
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        assert rounds == int(jr)
        assert set(i.numpy()[0].tolist()) <= set(tied)

    def test_integer_ties_bit_identical(self, rng):
        B, E, N, k, L = 6, 16, 3000, 20, 256
        q, c = _inputs(rng, "integer", B, N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            compute_dtype=jnp.float32,
        )
        v, i, rounds = bt.exact_topk(
            torch.tensor(q), torch.tensor(c), k, L=L,
            compute_dtype=torch.float32,
        )
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert rounds == int(jr)

    def test_n_smaller_than_bins(self, rng):
        B, E, k, L, N = 4, 16, 8, 256, 100
        q, c = _inputs(rng, "normal", B, N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, L=L, interpret=True,
            compute_dtype=jnp.float32,
        )
        v, i, rounds = bt.exact_topk(
            torch.tensor(q), torch.tensor(c), k, L=L,
            compute_dtype=torch.float32,
        )
        scores = q.astype(np.float64) @ c.astype(np.float64).T
        _assert_same_ranking(v.numpy(), i.numpy(), jv, ji, scores, False)
        assert rounds == int(jr)

    def test_k_exceeds_bins_rejected(self):
        with pytest.raises(ValueError, match="<= L"):
            bt.exact_topk(torch.zeros(2, 8), torch.zeros(512, 8), 300, L=256)

    def test_k_exceeds_catalog_rejected(self):
        with pytest.raises(ValueError, match="> N"):
            bt.exact_topk(torch.zeros(2, 8), torch.zeros(50, 8), 60, L=256)

    def test_large_k_sort_branch(self, rng):
        """k=300 > 256 takes the sort branch of the JAX topk_pair; the
        default L is 2048 in both packages."""
        B, E, N, k = 4, 16, 3000, 300
        q, c = _inputs(rng, "normal", B, N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, interpret=True,
            compute_dtype=jnp.float32,
        )
        v, i, rounds = bt.exact_topk(
            torch.tensor(q), torch.tensor(c), k, compute_dtype=torch.float32
        )
        scores = q.astype(np.float64) @ c.astype(np.float64).T
        _assert_same_ranking(v.numpy(), i.numpy(), jv, ji, scores, False)
        assert rounds == int(jr)

    def test_bf16_main_path_shape(self, rng):
        """The served configuration's dtype (bf16 operands, fp32 sums),
        N not a multiple of L, query blocks of 128 rows with a ragged
        last block."""
        B, E, N, k = 130, 16, 20_000, 10
        q, c = _inputs(rng, "normal", B, N, E)
        jv, ji, jr = pr.pallas_exact_topk(
            jnp.asarray(q), jnp.asarray(c), k, interpret=True
        )
        v, i, rounds = bt.exact_topk(torch.tensor(q), torch.tensor(c), k)
        qb = torch.tensor(q).bfloat16().double().numpy()
        cb = torch.tensor(c).bfloat16().double().numpy()
        _assert_same_ranking(
            v.numpy(), i.numpy(), jv, ji, qb @ cb.T, False
        )
        assert rounds == int(jr)


class TestBinsAndTopk:
    @pytest.mark.parametrize("k", [1, 10, 32, 64, 100, 200, 256, 300, 1000, 2048])
    @pytest.mark.parametrize("shape", [(128, 128), (4, 16), (128, 256)])
    def test_default_bins_equal_pick_bins(self, k, shape):
        B, E = shape
        assert bt.default_bins(k) == pr.pick_bins(B, E, k, keep_per_bin=2)

    def test_default_bins_rejects_k_above_2048(self):
        assert pr.pick_bins(128, 128, 2049, keep_per_bin=2) is None
        with pytest.raises(ValueError):
            bt.default_bins(2049)

    @pytest.mark.parametrize("k", [5, 40, 300])
    def test_topk_pair_tie_order_matches_jax(self, rng, k):
        vals = rng.integers(-3, 4, size=(6, 400)).astype(np.float32)
        vals[0, :] = 1.0  # one row of all ties
        ids = rng.permutation(400 * 6).reshape(6, 400).astype(np.int32)
        jv, ji = jax_topk_pair(jnp.asarray(vals), jnp.asarray(ids), k)
        v, i = topk_pair(torch.tensor(vals), torch.tensor(ids), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))

    def test_topk_pair_rejects_k_above_width(self):
        with pytest.raises(ValueError, match="exceeds"):
            topk_pair(torch.zeros(2, 5), torch.zeros(2, 5, dtype=torch.int32), 6)

    def test_topk_dot_matches_jax(self, rng):
        from hm_retrieval_tpu.ops.topk import topk_dot as jax_topk_dot

        q, c = _inputs(rng, "integer", 5, 700, 8)
        jv, ji = jax_topk_dot(jnp.asarray(q), jnp.asarray(c), 30)
        v, i = topk_dot(torch.tensor(q), torch.tensor(c), 30)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
