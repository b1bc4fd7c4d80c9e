"""The port's NaN checks against the JAX package's ``jax_debug_nans``.

The same computations, on the same numpy inputs, raise ``FloatingPointError``
in both packages while the checks are on: a NaN made in forward, and one
made only in backward. A kernel wrapper checks its own outputs (the card's
launches are invisible to the dispatch mode), here on its CPU path. After
``disable_debug_checks`` the NaN passes silently and nothing is checked; a
sparse training step with a purchase history and ``exact_topk`` run clean
under the checks and give the bits they give without them; ``disable_jit``
only logs.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.utils.debugging import (
    disable_debug_checks as jax_disable,
    enable_debug_checks as jax_enable,
)
from hm_retrieval_tpu_torch.models import (
    TwoTowerModel,
    make_single_device_trainer,
    train_state_to_numpy,
)
from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.ops import quantized_topk as qt
from hm_retrieval_tpu_torch.schema import Feature, TrainingConfig
from hm_retrieval_tpu_torch.utils import debugging
from hm_retrieval_tpu_torch.utils.debugging import (
    disable_debug_checks,
    enable_debug_checks,
)


def jax_raises(fn, *args):
    jax_enable(nans=True)
    try:
        fn(*args)
    except FloatingPointError:
        return True
    finally:
        jax_disable()
    return False


def test_forward_nan_raises_naming_the_op_and_clears():
    x = np.ones(3, np.float32)
    assert jax_raises(lambda a: jax.block_until_ready(
        jax.jit(lambda v: v / 0.0 * 0.0)(a)), x)
    enable_debug_checks()
    try:
        with pytest.raises(FloatingPointError, match=r"aten\.mul"):
            torch.from_numpy(x) / 0.0 * 0.0
        # inf is no NaN
        assert torch.isinf(torch.from_numpy(x) / 0.0).all()
    finally:
        disable_debug_checks()
    out = torch.from_numpy(x) / 0.0 * 0.0
    assert torch.isnan(out).all()


def masked_log(x, where, log):
    """``where(x > 0, log(x), 0)``: finite in forward, NaN in the gradient
    at x = 0 (0 * inf)."""
    return where(x > 0, log(x), 0.0).sum()


def test_backward_nan_raises():
    x = np.array([0.0, 1.0, 2.0], np.float32)
    assert not jax_raises(lambda a: jax.block_until_ready(
        masked_log(a, jnp.where, jnp.log)), x)
    assert jax_raises(lambda a: jax.block_until_ready(jax.grad(
        lambda v: masked_log(v, jnp.where, jnp.log))(a)), x)
    enable_debug_checks()
    try:
        t = torch.tensor(x, requires_grad=True)
        loss = masked_log(t, torch.where, torch.log)  # forward is clean
        with pytest.raises(FloatingPointError, match=r"aten\.div"):
            loss.backward()
    finally:
        disable_debug_checks()
    t = torch.tensor(x, requires_grad=True)
    masked_log(t, torch.where, torch.log).backward()
    assert torch.isnan(t.grad[0]) and not torch.isnan(t.grad[1:]).any()


def _nan_cells(B, L, keep=2):
    """Outputs made before the checks go on, so only the wrapper's own
    check can see their NaN."""
    cells = []
    for _ in range(keep):
        cells.append(torch.full((B, L), float("nan")))
        cells.append(torch.zeros((B, L), dtype=torch.int32))
    return tuple(cells)


@pytest.mark.parametrize("kernel", ["bin_max2_first_round",
                                    "bin_max2_scaled_single_pass"])
def test_a_kernel_wrapper_checks_its_outputs(monkeypatch, kernel):
    """The wrapper, not the dispatch mode, raises: its plain version is
    replaced by one that returns NaN cells without an aten op."""
    B, L, E = 3, 256, 16
    q = torch.randn(B, E)
    cells = _nan_cells(B, L)
    if kernel == "bin_max2_first_round":
        monkeypatch.setattr(bt, "bin_max2_plain",
                            lambda *a, **k: cells)

        def call():
            return bt.bin_max2_first_round(q, torch.randn(1024, E), L, 1000)
    else:
        monkeypatch.setattr(qt, "single_pass_plain",
                            lambda *a, **k: cells)
        codes = torch.randint(-127, 128, (1024, E), dtype=torch.int8)

        def call():
            return qt.bin_max2_scaled_single_pass(
                q, codes, torch.rand(1024), torch.zeros(1024), L)
    enable_debug_checks()
    try:
        with pytest.raises(FloatingPointError, match=f"kernel {kernel}"):
            call()
    finally:
        disable_debug_checks()
    assert torch.isnan(call()[0]).all()  # silent with the checks off


def test_disabled_checks_look_at_nothing(monkeypatch):
    looked = []
    monkeypatch.setattr(debugging, "_has_nan",
                        lambda t: looked.append(t) or False)
    enable_debug_checks()
    disable_debug_checks()
    assert debugging._mode is None
    torch.ones(4) / 0.0 * 0.0
    bt.exact_topk(torch.randn(2, 16), torch.randn(700, 16), 5, L=256)
    assert looked == []
    enable_debug_checks()
    try:
        torch.ones(2) + 1
    finally:
        disable_debug_checks()
    assert looked  # while on, every output is looked at


def test_disable_jit_only_logs(caplog):
    with caplog.at_level(logging.INFO,
                         logger="hm_retrieval_tpu_torch.utils.debugging"):
        enable_debug_checks(nans=False, disable_jit=True)
    assert debugging._mode is None
    assert "runs op by op" in caplog.text
    disable_debug_checks()  # a no-op when off


def _history_model():
    def vocab(prefix, n):
        return np.array([f"{prefix}{i}" for i in range(n)])

    arts = vocab("a", 25)
    return TwoTowerModel(
        [Feature("customer_id", "categorical", "query", embedding_size=8,
                 vocab=vocab("c", 40)),
         Feature("purchase_history", "sequence", "query", embedding_size=8,
                 max_len=4, vocab=arts, pooling="attention"),
         Feature("age", "numeric", "query")],
        [Feature("article_id", "categorical", "candidate", embedding_size=8,
                 vocab=arts)],
        "article_id", 8, [12], [12], logq=np.linspace(-3, 0, 26),
        device="cpu",
    )


def test_a_sparse_step_and_exact_topk_run_clean_with_the_same_bits():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 26, (16, 4)).astype(np.int32)
    hist[3] = 0  # an all-pad history: the attention pool's -inf scores
    batch = {"customer_id": torch.tensor(rng.integers(1, 41, 16),
                                         dtype=torch.int32),
             "purchase_history": torch.from_numpy(hist),
             "age": torch.tensor(rng.normal(size=16), dtype=torch.float32),
             "article_id": torch.tensor(rng.integers(1, 26, 16),
                                        dtype=torch.int32)}
    q = torch.tensor(rng.integers(-4, 5, (5, 16)), dtype=torch.float32)
    c = torch.tensor(rng.integers(-4, 5, (3000, 16)), dtype=torch.float32)

    def run():
        state, step = make_single_device_trainer(_history_model(),
                                                 TrainingConfig(seed=1))
        for _ in range(2):
            state, metrics = step(state, batch)
        return (train_state_to_numpy(state), float(metrics["loss"]),
                bt.exact_topk(q, c, 20, L=256))

    plain = run()
    enable_debug_checks()
    try:
        checked = run()
    finally:
        disable_debug_checks()
    assert checked[1] == plain[1]
    for a, b in zip(checked[2], plain[2]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [np.asarray(tree)]

    for a, b in zip(leaves(checked[0]), leaves(plain[0])):
        np.testing.assert_array_equal(a, b)
