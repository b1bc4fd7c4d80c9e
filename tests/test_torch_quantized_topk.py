"""The port's single-pass int8 survivor selection
(hm_retrieval_tpu_torch/ops/quantized_topk.py) held against the JAX
package's Pallas functions run in interpret mode on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py.

Tolerances. With integer-valued queries in [-4, 4] (exact in bf16) every dot
product with the int8 codes is an exact integer, times one correctly rounded
scale, so the outputs must be bit-identical; they tie heavily, which tests
the (score desc, index asc) order. Normal queries run with fp32 operands on
both sides, which sum in another order: values must agree within 1e-5
relative (test_torch_bin_topk.TOL), and ids wherever the competing scores
differ by more.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.indices import quantized as jq
from hm_retrieval_tpu.ops import pallas_retrieval as pr
from hm_retrieval_tpu_torch.ops import quantized_topk as qt
from hm_retrieval_tpu_torch.ops.bin_topk import BIG_IDX
from test_torch_bin_topk import _assert_same_ranking

def _queries(rng, kind, B, E):
    if kind == "integer":
        return rng.integers(-4, 5, size=(B, E)).astype(np.float32)
    return rng.normal(size=(B, E)).astype(np.float32)


def _catalog(rng, N, E):
    codes = rng.integers(-127, 128, size=(N, E)).astype(np.int8)
    scales = (rng.random(N) * 0.05 + 1e-3).astype(np.float32)
    return codes, scales


def _dtypes(kind):
    """(JAX, torch) compute dtypes: bf16 for exact integer inputs, fp32
    for normal inputs."""
    if kind == "integer":
        return jnp.bfloat16, torch.bfloat16
    return jnp.float32, torch.float32


def _scaled_scores(q, codes, scales, bias):
    s = q.astype(np.float64) @ codes.astype(np.float64).T * scales + bias
    return np.where(np.isfinite(s), s, -np.inf)


class TestSinglePassKernels:
    """Kernels 3, 4 and 5 (plain versions) against the JAX wrappers."""

    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize("F", [1, 2, 4])
    def test_scaled_pass_matches_jax(self, rng, kind, F):
        B, E, L = 16, 32, 256
        N = 4 * F * L  # four chunks
        q = _queries(rng, kind, B, E)
        codes, scales = _catalog(rng, N, E)
        n_valid = N - L // 2 - 3  # cuts into the last chunk
        bias = np.zeros(N, np.float32)
        bias[n_valid:] = -np.inf
        masked_bins = np.arange(N) % L < 7  # these cells stay unfilled
        bias[masked_bins] = -np.inf
        scales[n_valid:] = 0.0  # as the drivers pad them
        jdt, tdt = _dtypes(kind)
        args = (jnp.asarray(q, jdt), jnp.asarray(codes),
                jnp.asarray(scales)[None], jnp.asarray(bias)[None])
        targs = (torch.tensor(q).to(tdt), torch.tensor(codes),
                 torch.tensor(scales), torch.tensor(bias))
        if F == 1:
            want = pr.bin_max2_scaled_single_pass(*args, L=L, interpret=True)
            got = qt.bin_max2_scaled_single_pass(*targs, L)
        else:
            want = pr.bin_max2_scaled_fold_pass(
                *args, L=L, F=F, interpret=True
            )
            got = qt.bin_max2_scaled_fold_pass(*targs, L, F)
        got = [g.numpy() for g in got]
        scores = _scaled_scores(q, codes, scales, bias)
        for vi, ii in ((0, 1), (2, 3)):
            _assert_same_ranking(got[vi], got[ii], want[vi], want[ii],
                                 scores, exact=kind == "integer")
        for a in (got[1], got[3]):
            assert np.all(a[:, :7] == BIG_IDX)
            assert np.all((a < n_valid) | (a == BIG_IDX))

    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize("F", [1, 2, 4])
    def test_raw_fold_pass_matches_jax(self, rng, kind, F):
        B, E, L = 24, 16, 256
        n_full = 3 * F * L
        q = _queries(rng, kind, B, E)
        codes, _ = _catalog(rng, n_full, E)
        jdt, tdt = _dtypes(kind)
        want = pr.bin_max2_raw_fold_pass(
            jnp.asarray(q, jdt), jnp.asarray(codes), L=L, F=F, interpret=True
        )
        got = [g.numpy() for g in qt.bin_max2_raw_fold_pass(
            torch.tensor(q).to(tdt), torch.tensor(codes), L, F
        )]
        scores = q.astype(np.float64) @ codes.astype(np.float64).T
        for vi, ii in ((0, 1), (2, 3)):
            _assert_same_ranking(got[vi], got[ii], want[vi], want[ii],
                                 scores, exact=kind == "integer")
        assert np.all(got[1] < n_full) and np.all(got[3] < n_full)

    def test_fold_ties_keep_the_lower_slot_and_row(self):
        """Every row scores the same: each cell keeps slot 0 of its first
        chunk, then slot 0 of its second chunk."""
        B, E, L, F = 2, 16, 32, 4
        codes = torch.ones((2 * F * L, E), dtype=torch.int8)
        q = torch.ones((B, E))
        m1, a1, m2, a2 = qt.bin_max2_raw_fold_pass(q, codes, L, F)
        bins = torch.arange(L, dtype=torch.int32)
        assert torch.equal(a1, bins.expand(B, L))
        assert torch.equal(a2, (bins + F * L).expand(B, L))
        assert torch.equal(m1, m2) and bool((m1 == E).all())

    @pytest.mark.parametrize(
        "bad", ["codes_dtype", "ragged", "scales_shape", "bias_dtype", "width"]
    )
    def test_wrapper_validation(self, bad):
        q = torch.zeros(4, 16)
        codes = torch.zeros(512, 16, dtype=torch.int8)
        scales = torch.ones(512)
        bias = torch.zeros(512)
        if bad == "codes_dtype":
            codes = codes.float()
        elif bad == "ragged":
            codes, scales, bias = codes[:500], scales[:500], bias[:500]
        elif bad == "scales_shape":
            scales = torch.ones(256)
        elif bad == "bias_dtype":
            bias = torch.zeros(512, dtype=torch.float64)
        else:
            codes = torch.zeros(512, 8, dtype=torch.int8)
        with pytest.raises((ValueError, TypeError)):
            qt.bin_max2_scaled_fold_pass(q, codes, scales, bias, 128, 2)

    def test_non_cpu_tensor_is_never_run_on_the_plain_path(self):
        q = torch.zeros(4, 16, device="meta")
        codes = torch.zeros(512, 16, dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            qt.bin_max2_raw_fold_pass(q, codes, 128, 2)


class TestDrivers:
    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize(
        "N, n_valid, k, L, fold",
        [
            (3000, 2500, 10, None, None),  # the plan: F 2, L 512
            (8192, 8192, 20, None, None),  # the plan: F 8, L 512
            (5000, 4321, 10, 256, 2),
            (5000, 4321, 10, 256, 4),
            (4096, 1000, 30, 256, 1),
        ],
    )
    def test_quantized_topk_matches_jax(self, rng, kind, N, n_valid, k, L,
                                        fold):
        B, E = 16, 16
        q = _queries(rng, kind, B, E)
        codes, scales = _catalog(rng, N, E)
        bias = np.where(rng.random(N) < 0.05, -np.inf, 0.0).astype(np.float32)
        jdt, tdt = _dtypes(kind)
        wv, wi, wr = pr.pallas_quantized_topk(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), k,
            n_valid=n_valid, bias=jnp.asarray(bias), L=L, max_rounds=1,
            interpret=True, compute_dtype=jdt, fold=fold,
        )
        v, i, rounds = qt.quantized_topk(
            torch.tensor(q), torch.tensor(codes), torch.tensor(scales), k,
            n_valid=n_valid, bias=torch.tensor(bias), L=L, max_rounds=1,
            compute_dtype=tdt, fold=fold,
        )
        assert rounds == int(wr) == 1
        full_bias = bias.copy()
        full_bias[n_valid:] = -np.inf
        scores = _scaled_scores(q, codes, scales, full_bias)
        _assert_same_ranking(v.numpy(), i.numpy(), wv, wi, scores,
                             exact=kind == "integer")
        assert i.numpy().max() < n_valid

    def test_plan_of_the_driver_is_the_jax_plan(self, rng):
        """The L the driver takes is single_pass_plan's: a catalog that
        admits the (256, 16) fold gives the same survivors as the JAX
        driver only at F = 16, L = 512."""
        B, E, N, k = 4, 16, 16384, 10
        assert qt.single_pass_plan(B, E, k, N) == (256, 16, 512)
        q = _queries(rng, "integer", B, E)
        codes, scales = _catalog(rng, N, E)
        wv, wi, _ = pr.pallas_quantized_topk(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), k,
            max_rounds=1, interpret=True,
        )
        v, i, _ = qt.quantized_topk(
            torch.tensor(q), torch.tensor(codes), torch.tensor(scales), k,
            max_rounds=1,
        )
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))

    @pytest.mark.parametrize("kind", ["integer", "normal"])
    @pytest.mark.parametrize(
        "F, n_valid",
        [
            (1, 1000),  # tail 1000 - 768 = 232
            (1, 512),   # no tail
            (2, 300),   # n_valid < F*L: tail only, no launch
            (2, 1500),  # fold plus tail
        ],
    )
    def test_quantized_topk_global_matches_jax(self, rng, kind, F, n_valid):
        E, B, k, L = 16, 8, 10, 256
        q = _queries(rng, kind, B, E)
        N = max(n_valid, 2048)
        emb = rng.normal(size=(N, E)).astype(np.float32)
        codes, g = jq.quantize_rows_global(emb)
        jdt, tdt = _dtypes(kind)
        wv, wi, wr = pr.pallas_quantized_topk_global(
            jnp.asarray(q), jnp.asarray(codes), g, k, n_valid=n_valid, L=L,
            fold=F, interpret=True, compute_dtype=jdt,
        )
        qt.reset_launches()
        v, i, rounds = qt.quantized_topk_global(
            torch.tensor(q), torch.tensor(codes), float(g), k,
            n_valid=n_valid, L=L, fold=F, compute_dtype=tdt,
        )
        assert rounds == int(wr) == 1
        assert set(qt.LAUNCHES.values()) == {0}  # the plain path counts none
        scores = (q.astype(np.float64) @ codes[:n_valid].astype(np.float64).T
                  * np.float64(g))
        _assert_same_ranking(v.numpy(), i.numpy(), wv, wi, scores,
                             exact=kind == "integer")
        assert i.numpy().max() < n_valid

    def test_global_without_full_chunks_launches_nothing(self, monkeypatch):
        def refuse(*args, **kwargs):
            raise AssertionError("the raw pass must not run")

        monkeypatch.setattr(qt, "bin_max2_raw_fold_pass", refuse)
        codes = torch.ones((300, 16), dtype=torch.int8)
        v, i, _ = qt.quantized_topk_global(
            torch.ones(2, 16), codes, 0.5, 4, L=256, fold=2
        )
        assert torch.equal(i, torch.arange(4, dtype=torch.int32).expand(2, 4))
        assert bool((v == 8.0).all())

    def test_driver_validation(self):
        codes = torch.zeros(1024, 16, dtype=torch.int8)
        with pytest.raises(ValueError, match="n_valid"):
            qt.quantized_topk(torch.zeros(2, 16), codes, torch.ones(1024), 5,
                              n_valid=2000)
        with pytest.raises(ValueError, match="n_valid"):
            qt.quantized_topk_global(torch.zeros(2, 16), codes, 1.0, 50,
                                     n_valid=40)
        with pytest.raises(ValueError, match="<= L"):
            qt.quantized_topk(torch.zeros(2, 16), codes, torch.ones(1024),
                              300, L=256)


class TestPlan:
    """single_pass_plan and the feasibility / shrink rules against the JAX
    package's functions at its off-TPU budget."""

    @pytest.mark.parametrize(
        "B, E", list(itertools.product((1, 16, 128, 256, 1024), (16, 128, 256)))
    )
    def test_plan_equals_jax_policy(self, B, E):
        for k, N in itertools.product(
            (10, 100, 600, 1000, 2000, 4000), (3000, 131072, 10**6)
        ):
            qb, f = pr._single_pass_policy(B, E, k, N)
            L = pr.pick_bins(min(B, qb), E, k, keep_per_bin=2,
                             target=max(k, 512), first_pass=True, fold=f)
            assert qt.single_pass_plan(B, E, k, N) == (qb, f, L), (k, N)

    @pytest.mark.parametrize("fold", [1, 2, 8, 16])
    def test_plan_with_a_fixed_fold_equals_jax(self, fold):
        for B, k, N in itertools.product((1, 128, 1024), (10, 1000),
                                         (3000, 131072)):
            qb, f = pr._single_pass_policy(B, 128, k, N, fold=fold)
            L = pr.pick_bins(min(B, qb), 128, k, keep_per_bin=2,
                             target=max(k, 512), first_pass=True, fold=f)
            assert qt.single_pass_plan(B, 128, k, N, fold=fold) == (qb, f, L)

    @pytest.mark.parametrize(
        "B, plan",
        [(1, (512, 8, 2048)), (16, (512, 8, 2048)), (128, (1024, 2, 2048)),
         (1024, (256, 1, 2048))],
    )
    def test_hm_served_plan(self, B, plan):
        """H&M at k = 1000: 4000 survivors shrink to 2000; the padded
        codes hold 131,072 rows."""
        from hm_retrieval_tpu_torch.indices.quantized import _auto_survivors

        assert _auto_survivors("auto", 1000, 4000, True, 128) == ("pallas",
                                                                  2000)
        assert qt.single_pass_plan(B, 128, 2000, 131072) == plan

    @pytest.mark.parametrize("E", [16, 128, 256])
    def test_feasibility_and_shrink_equal_jax(self, E):
        from hm_retrieval_tpu_torch.indices import quantized as pq

        for k in (10, 100, 600, 1000, 2000, 2048, 2049, 4000):
            assert qt.pallas_feasible(k, E) == jq._pallas_feasible(k, E), k
            for k_over in (k, 2 * k, 4 * k):
                assert pq.shrink_survivors(k, k_over, E) == (
                    jq.shrink_survivors(k, k_over, E)
                )
