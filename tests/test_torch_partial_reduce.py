"""The port's PartialReduce (hm_retrieval_tpu_torch/ops/partial_reduce.py),
the counterpart of ``lax.approx_max_k``, held against JAX and numpy.

On the CPU, XLA runs ``approx_max_k`` as an exact fallback, so only the
width it would reduce to (``aggregate_to_topk=False``, through
``jax.eval_shape``) and the no-reduction case can be held against JAX. The
bins themselves, which the port computes on every device as the TPU does,
are held bit for bit against a numpy reference. On the CPU the wrapper runs
its plain version; the CUDA kernel is held against the same plain version
on the card by chip_smoke.py (phase 20).

Tolerances: none. Every comparison is exact (a maximum and a sort move
values without arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from hm_retrieval_tpu_torch.ops import partial_reduce as pr

NS = (100, 128, 129, 3000, 4096, 20000, 105542, 106496, 1000000)
KS = (1, 10, 100, 1000, 2000)
RTS = (0.1, 0.5, 0.8, 0.95, 0.99, 1.0)


def _jax_width(n, k, rt):
    """approx_max_k's reduced width for a (2, n) operand, or None where JAX
    refuses the arguments (k > n)."""
    try:
        out = jax.eval_shape(
            lambda x: lax.approx_max_k(x, k, recall_target=rt,
                                       aggregate_to_topk=False),
            jax.ShapeDtypeStruct((2, n), jnp.float32),
        )
    except ValueError:
        return None
    return out[0].shape[1]


@pytest.mark.parametrize("rt", RTS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_reduction_size_equals_jax(n, k, rt):
    L, r = pr.reduction_size(n, k, rt)
    want = _jax_width(n, k, rt)
    x = torch.empty((2, n), device="meta")  # raises before any read
    if want is None:
        assert k > n
        with pytest.raises(ValueError, match=f"k={k}"):
            pr.approx_max_k(x, k, rt)
        return
    assert L == want
    assert (r == 0) == (L == n) and L << r >= n
    if L < k:
        with pytest.raises(ValueError, match="recall_target"):
            pr.approx_max_k(x, k, rt)


@pytest.mark.parametrize(
    "n, k, rt, L",
    [
        (105_542, 1000, 0.95, 26_496),
        (106_496, 1000, 0.95, 26_624),
        (105_542, 100, 0.95, 3_328),
        (105_542, 10, 0.95, 256),
        (20_000, 100, 0.95, 2_560),
        (3_000, 20, 0.95, 384),
        (105_542, 1000, 0.99, 105_542),
        (105_542, 1000, 0.1, 896),
    ],
)
def test_reduction_size_at_the_served_shapes(n, k, rt, L):
    assert pr.reduction_size(n, k, rt)[0] == L == _jax_width(n, k, rt)


def test_recall_target_out_of_range_raises():
    for rt in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="recall_target"):
            pr.reduction_size(3000, 10, rt)


def _numpy_bins(x, L, r):
    """Reference: pad with -inf to L * 2^r, bin j = columns j + t * L; the
    max and its lowest column (argmax takes the first, lowest t)."""
    B, n = x.shape
    T = 1 << r
    padded = np.full((B, L * T), -np.inf, np.float32)
    padded[:, :n] = x
    bins = padded.reshape(B, T, L)
    t = bins.argmax(axis=1)
    vals = np.take_along_axis(bins, t[:, None, :], axis=1)[:, 0]
    return vals, (t * L + np.arange(L)).astype(np.int32)


def _scores(rng, kind, B, n, L):
    if kind == "normal":
        return rng.normal(size=(B, n)).astype(np.float32)
    # integer-valued in a small range: ties in every bin, and -inf entries,
    # bin 0 all -inf
    x = rng.integers(-3, 4, size=(B, n)).astype(np.float32)
    x[rng.random((B, n)) < 0.1] = -np.inf
    x[:, ::L] = -np.inf
    return x


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize(
    "n, L, r",
    [
        (4096, 1024, 2),  # n a multiple of L * 2^r
        (3000, 384, 3),  # ragged: the last t of some bins is padding
        (1000, 128, 3),  # ragged, 8 columns a bin
        (100, 128, 1),  # bins 100..127 are padding alone
        (300, 512, 0),  # no reduction; bins 300..511 are padding alone
        (129, 128, 1),
    ],
)
def test_plain_bins_equal_numpy(rng, kind, n, L, r):
    x = _scores(rng, kind, 5, n, L)
    want_v, want_i = _numpy_bins(x, L, r)
    got_v, got_i = pr.partial_reduce_plain(torch.tensor(x), L, r)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert got_i.dtype == torch.int32
    # the wrapper takes the plain version on the CPU and counts no launch
    pr.reset_launches()
    wv, wi = pr.partial_reduce(torch.tensor(x), L, r)
    assert torch.equal(wv, got_v) and torch.equal(wi, got_i)
    assert pr.LAUNCHES == {"partial_reduce": 0}


def test_padding_bins_return_minus_inf_and_a_row_past_n():
    x = torch.arange(100, dtype=torch.float32)[None]
    v, i = pr.partial_reduce(x, 128, 1)
    assert torch.equal(v[0, :100], x[0])
    assert torch.isinf(v[0, 100:]).all() and (v[0, 100:] < 0).all()
    assert torch.equal(i[0, 100:], torch.arange(100, 128, dtype=torch.int32))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 300)
    with pytest.raises(ValueError, match="must cover"):
        pr.partial_reduce(x, 128, 1)
    with pytest.raises(TypeError, match="float32"):
        pr.partial_reduce(x.double(), 128, 2)
    with pytest.raises(ValueError, match="\\(B, n\\)"):
        pr.partial_reduce(x[0], 128, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        pr.partial_reduce(torch.zeros(2, 300, device="meta"), 128, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        pr.approx_max_k(torch.zeros(2, 300, device="meta"), 10, 1.0)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("n, k", [(100, 10), (128, 127), (3000, 20)])
def test_no_reduction_equals_jax(rng, kind, n, k):
    """rt = 1.0 (or n <= 128): XLA reduces nothing, and approx_max_k is the
    exact top-k, ties by column, on both sides; no launch. (At k = n, XLA's
    CPU fallback returns ties in another order; the port stays stable.)"""
    x = _scores(rng, kind, 4, n, n)
    assert pr.reduction_size(n, k, 1.0) == (n, 0)
    jv, ji = lax.approx_max_k(jnp.asarray(x), k, recall_target=1.0)
    pv, pi = pr.approx_max_k(torch.tensor(x), k, 1.0)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_approx_max_k_is_the_stable_topk_of_the_bins(rng, kind):
    n, k, rt = 3000, 20, 0.95
    L, r = pr.reduction_size(n, k, rt)
    assert (L, r) == (384, 3)
    x = _scores(rng, kind, 6, n, L)
    bv, bi = _numpy_bins(x, L, r)
    order = np.argsort(-bv, axis=1, kind="stable")[:, :k]
    v, i = pr.approx_max_k(torch.tensor(x), k, rt)
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(bv, order, 1))
    np.testing.assert_array_equal(i.numpy(), np.take_along_axis(bi, order, 1))
    # every (value, column) pair is real
    np.testing.assert_array_equal(
        np.take_along_axis(x, i.numpy().astype(np.int64), 1), v.numpy())
    bins_v, bins_i = pr.approx_max_k(torch.tensor(x), k, rt,
                                     aggregate_to_topk=False)
    np.testing.assert_array_equal(bins_v.numpy(), bv)
    np.testing.assert_array_equal(bins_i.numpy(), bi)


def test_ties_between_bins_go_by_bin_not_by_column():
    """The deliberate difference: equal values in two bins come back in
    bin order, where the exact top-k (JAX on the CPU) orders them by
    column."""
    n, k, rt = 3000, 20, 0.95
    L, _ = pr.reduction_size(n, k, rt)
    x = np.zeros((1, n), np.float32)
    x[0, 5] = 7.0  # bin 5
    x[0, L + 2] = 7.0  # bin 2
    v, i = pr.approx_max_k(torch.tensor(x), k, rt)
    assert v[0, :2].tolist() == [7.0, 7.0]
    assert i[0, :2].tolist() == [L + 2, 5]
    _, ji = lax.approx_max_k(jnp.asarray(x), k, recall_target=rt)
    assert np.asarray(ji)[0, :2].tolist() == [5, L + 2]


def test_recall_follows_the_model(rng):
    """At n = 20,000, k = 100 (L = 2,560), the mean recall of the bins'
    top-k against the exact top-k is at least XLA's model (1 - 1/L)^(k - 1)
    = 0.962, which counts every collision of two top-k elements as a loss,
    and about 1 - (k - 1) / (2L) = 0.981, which counts only the smaller
    one of each pair."""
    n, k = 20_000, 100
    L, _ = pr.reduction_size(n, k, 0.95)
    x = rng.normal(size=(64, n)).astype(np.float32)
    _, i = pr.approx_max_k(torch.tensor(x), k)
    exact = np.argsort(-x, axis=1)[:, :k]
    recall = np.mean([len(set(a) & set(b)) / k
                      for a, b in zip(i.numpy(), exact)])
    assert recall >= max(0.95, (1 - 1 / L) ** (k - 1))
    assert abs(recall - (1 - (k - 1) / (2 * L))) < 0.01


# ----------------------------------------------------------------------
# The kernel's split walk: its plain model and the host's plan
# ----------------------------------------------------------------------
# (n, L, r) the port gives the kernel: "approx" over the H&M catalog's real
# rows at k = 10, 100, 1000 and "partial_reduce" over its padded rows; the
# quantized scan's 65,536-row chunk at k_over 40 and 400; the sharded scan's
# 26,386-row shards at k_over 40 and 400; a 20,480-row scan chunk at k_over
# 400; the scan's 3,072-row chunk at k_over 40
KERNEL_SHAPES = (
    (105_542, 256, 9), (105_542, 3_328, 5), (105_542, 26_496, 2),
    (106_496, 26_624, 2), (65_536, 1_024, 6), (65_536, 8_192, 3),
    (26_386, 896, 5), (26_386, 13_312, 1), (20_480, 10_240, 1),
    (3_072, 768, 2),
)


def _hard_scores(rng, B, n):
    """Integer values in [-2, 2] with both signs of zero, -inf and NaN
    entries, a whole -inf row and a whole NaN row."""
    x = rng.integers(-2, 3, size=(B, n)).astype(np.float32)
    x[(x == 0) & (rng.random((B, n)) < 0.5)] = -0.0
    x[rng.random((B, n)) < 0.1] = -np.inf
    x[rng.random((B, n)) < 0.05] = np.nan
    x[1] = -np.inf
    x[2] = np.nan
    return x


def _bits(v):
    return v.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", ["normal", "hard"])
@pytest.mark.parametrize("n, L, r", KERNEL_SHAPES)
def test_split_model_equals_the_walk_bit_for_bit(rng, kind, n, L, r):
    """Every split S = 1, 2, 4, ..., 2^r of the walk gives the one walk's
    values (by their bits, so the sign of a zero shows) and columns."""
    x = torch.tensor(rng.normal(size=(4, n)).astype(np.float32)
                     if kind == "normal" else _hard_scores(rng, 4, n))
    want_v, want_i = pr.partial_reduce_plain(x, L, r)
    for split in (1 << e for e in range(r + 1)):
        got_v, got_i = pr.partial_reduce_split_plain(x, L, r, split)
        assert torch.equal(_bits(got_v), _bits(want_v)), split
        assert torch.equal(got_i, want_i), split


def test_split_merge_rules():
    """The merge's ties: the lower column among equal values, -0.0 against
    +0.0 included; a NaN never wins; a bin of -inf alone gives -inf and
    its first column."""
    L, r = 128, 3
    x = np.full((4, L * 8), -5.0, np.float32)
    x[0, 2 * L + 1] = -0.0  # segment 1 of 4 ...
    x[0, 6 * L + 1] = 0.0   # ... before segment 3: -0.0 wins
    x[0, 1 * L + 2] = 0.0   # segment 0 ...
    x[0, 7 * L + 2] = -0.0  # ... before segment 3: +0.0 wins
    x[1, 3 * L + 4::L] = 7.0  # equal maxima in segments 1-3 of bin 4
    x[2, :] = np.nan
    x[2, 5 * L + 6] = -1.0  # the only number of bin 6
    x[3, :] = -np.inf
    got = {split: pr.partial_reduce_split_plain(torch.tensor(x), L, r, split)
           for split in (1, 2, 4, 8)}
    v, i = got[1]
    assert _bits(v)[0, 1] == _bits(torch.tensor(-0.0)) and i[0, 1] == 2 * L + 1
    assert _bits(v)[0, 2] == _bits(torch.tensor(0.0)) and i[0, 2] == L + 2
    assert v[1, 4] == 7.0 and i[1, 4] == 3 * L + 4
    assert v[2, 6] == -1.0 and i[2, 6] == 5 * L + 6
    assert torch.isneginf(v[2, 7]) and i[2, 7] == 7
    assert torch.isneginf(v[3]).all()
    assert torch.equal(i[3], torch.arange(L, dtype=torch.int32))
    for split, (sv, si) in got.items():
        assert torch.equal(_bits(sv), _bits(v)) and torch.equal(si, i), split


H100_SMS = 132


@pytest.mark.parametrize("n, L, r", KERNEL_SHAPES)
def test_split_plan(n, L, r):
    """A power of two, no more than MAX_SPLIT nor than leaves MIN_STEPS
    loads a thread; 1 wherever B * L already fills the card's 132 SMs or
    2^r <= 8; otherwise the largest split whose threads the card holds at
    once."""
    T = 1 << r
    full = H100_SMS * pr.RESIDENT_THREADS
    last = None
    for B in (1, 2, 16, 37, 128, 1024, 4096):
        split = pr.split_plan(B, L, r, H100_SMS)
        assert split & (split - 1) == 0 and 1 <= split <= pr.MAX_SPLIT
        assert split == 1 or T // split >= pr.MIN_STEPS
        if B * L >= full or T <= pr.MIN_STEPS:
            assert split == 1
        assert split == 1 or B * L * split <= full
        if split < min(pr.MAX_SPLIT, max(1, T // pr.MIN_STEPS)):
            assert B * L * split * 2 > full
        assert last is None or split <= last  # more rows, no more segments
        last = split


def test_split_plan_at_the_served_shapes():
    plan = {(L, r): [pr.split_plan(B, L, r, H100_SMS)
                     for B in (1, 16, 128, 1024)]
            for _, L, r in KERNEL_SHAPES}
    assert plan[256, 9] == [32, 32, 8, 1]
    assert plan[3_328, 5] == [4, 4, 1, 1]
    assert plan[1_024, 6] == [8, 8, 2, 1]
    assert plan[896, 5] == [4, 4, 2, 1]
    assert plan[8_192, 3] == plan[26_496, 2] == plan[13_312, 1] == [1] * 4


def test_wrapper_checks_the_split(rng):
    x = torch.tensor(rng.normal(size=(2, 3000)).astype(np.float32))
    want = pr.partial_reduce_plain(x, 384, 3)
    for split in (1, 2, 4, 8):
        got = pr.partial_reduce(x, 384, 3, split=split)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for split in (0, 3, 16):  # not a power of two, or past 2^r
        with pytest.raises(ValueError, match="split"):
            pr.partial_reduce(x, 384, 3, split=split)
    with pytest.raises(ValueError, match="split"):
        pr.partial_reduce(torch.zeros(2, 20000), 128, 8, split=64)
    with pytest.raises(ValueError, match="split"):
        pr.partial_reduce_split_plain(x, 384, 3, 16)
