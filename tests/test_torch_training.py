"""The port's training (hm_retrieval_tpu_torch/models) against the JAX
package's on the same state and batches.

State crosses with the bridge (``train_state_from_numpy`` /
``train_state_to_numpy``); batches are drawn with numpy. Both sides run fp32
on the CPU, in other summation orders. Tolerances: rtol 1e-5 / atol 1e-6 for
a loss, a gradient or one step (as ``test_torch_tower.py``); rtol 1e-4 /
atol 1e-5 after five steps, where the rounding of each step feeds the next.
The port's sparse step is held against its own dense Adagrad step at the
JAX package's tolerance for the same comparison (rtol 1e-5 / atol 1e-7,
``tests/test_sparse_optimizer.py``).

The model steps with Adam take eps = 1e-3 (ADAM_EPS). At optax's default
1e-8, Adam divides rounding noise by eps wherever a gradient is zero in
exact arithmetic: the candidate tower's last bias, which the in-batch
softmax cannot see (a constant added to every candidate shifts each row's
logits alike; ``test_last_candidate_bias_is_invisible_to_the_loss``). There
two summation orders give gradients of 1e-9 and 0, and updates that differ
by up to lr. The default eps is held against optax on well-posed gradients
(``test_optimizers_match_optax_on_a_tree``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hm_retrieval_tpu.models import OptimizerFactory as JaxOptimizerFactory
from hm_retrieval_tpu.models import TwoTowerModel as JaxTwoTower
from hm_retrieval_tpu.models import create_train_state as jax_create_state
from hm_retrieval_tpu.models import make_train_step as jax_make_step
from hm_retrieval_tpu.models.logq_correction import (
    apply_logq_correction as jax_logq,
)
from hm_retrieval_tpu.models.mixed_negatives import (
    CandidateCatalog as JaxCatalog,
)
from hm_retrieval_tpu.models.mixed_negatives import (
    mixed_negatives_loss as jax_mixed_loss,
)
from hm_retrieval_tpu.models.sparse_optimizer import (
    SparseAdagradState as JaxSparseAdagradState,
)
from hm_retrieval_tpu.models.sparse_optimizer import (
    SparseTrainState as JaxSparseTrainState,
)
from hm_retrieval_tpu.models.sparse_optimizer import (
    create_sparse_train_state as jax_create_sparse,
)
from hm_retrieval_tpu.models.sparse_optimizer import (
    make_sparse_train_step as jax_make_sparse_step,
)
from hm_retrieval_tpu.models.two_tower import TrainState as JaxTrainState
from hm_retrieval_tpu.schema import TrainingConfig as JaxTrainingConfig
from hm_retrieval_tpu.schema.features import Feature as JaxFeature
from hm_retrieval_tpu_torch.models import (
    OptimizerFactory,
    TwoTowerModel,
    apply_logq_correction,
    create_train_state,
    make_single_device_trainer,
    make_train_step,
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from hm_retrieval_tpu_torch.models.bridge import flat_to_tree
from hm_retrieval_tpu_torch.models.mixed_negatives import (
    CandidateCatalog,
    mixed_negatives_loss,
    step_seed,
)
from hm_retrieval_tpu_torch.models.optimizer_factory import (
    Adagrad,
    AdagradState,
    Adam,
    AdamState,
)
from hm_retrieval_tpu_torch.models.sparse_optimizer import (
    SparseTrainState,
    _segment_totals,
    _sparse_adagrad_update,
    create_sparse_train_state,
    make_sparse_train_step,
    merge_dense_params,
    split_dense_params,
)
from hm_retrieval_tpu_torch.models.train_path import uses_sparse_step
from hm_retrieval_tpu_torch.schema import TrainingConfig
from hm_retrieval_tpu_torch.schema.features import Feature

RTOL, ATOL = 1e-5, 1e-6  # a loss, a gradient, one step
RTOL5, ATOL5 = 1e-4, 1e-5  # five steps
SPARSE_RTOL, SPARSE_ATOL = 1e-5, 1e-7  # the port's sparse vs its dense
LR = 0.05
ADAM_EPS = 1e-3  # see the module docstring
N_CUST, N_ART, N_COL = 60, 40, 6


def _vocab(prefix, n):
    return np.array([f"{prefix}{i}" for i in range(n)])


def _specs(pooling, history=True):
    query = [
        dict(name="customer_id", kind="categorical", family="query",
             embedding_size=8, vocab=_vocab("c", N_CUST)),
        dict(name="age", kind="numeric", family="query", standardize=True,
             mean=30.0, std=5.0),
    ]
    if history:
        query.append(
            dict(name="purchase_history", kind="sequence", family="query",
                 embedding_size=8, vocab=_vocab("a", N_ART), max_len=5,
                 pooling=pooling))
    candidate = [
        dict(name="article_id", kind="categorical", family="candidate",
             embedding_size=8, vocab=_vocab("a", N_ART)),
        dict(name="colour", kind="categorical", family="candidate",
             embedding_size=4, vocab=_vocab("col", N_COL)),
    ]
    return query, candidate


def _logq():
    logq = np.zeros(N_ART + 1, np.float32)
    logq[1:] = np.log(np.linspace(0.3, 0.01, N_ART))
    return logq


def _models(pooling="mean", logq=True, history=True):
    qs, cs = _specs(pooling, history)
    lq = _logq() if logq else None
    units = dict(joint_embedding_size=16, query_tower_units=[32],
                 candidate_tower_units=[24])
    jm = JaxTwoTower([JaxFeature(**s) for s in qs],
                     [JaxFeature(**s) for s in cs], "article_id", logq=lq,
                     **units)
    pm = TwoTowerModel([Feature(**s) for s in qs], [Feature(**s) for s in cs],
                       "article_id", logq=lq, device="cpu", **units)
    return jm, pm


def _batch(rng, B=16, dup=False, history=True):
    if dup:  # every row hits a few ids, OOV id 0 among them
        cust = rng.choice([0, 3, 7], B).astype(np.int32)
        art = rng.choice([0, 5, 2], B).astype(np.int32)
        hist = rng.choice([0, 5, 9], (B, 5)).astype(np.int32)
    else:
        cust = rng.integers(0, N_CUST + 1, B).astype(np.int32)
        art = rng.integers(1, N_ART + 1, B).astype(np.int32)
        hist = rng.integers(0, N_ART + 1, (B, 5)).astype(np.int32)
    hist[0] = 0  # an all-pad history
    hist[1, 2:] = 0  # a short one
    batch = {
        "customer_id": cust,
        "age": rng.normal(size=B).astype(np.float32),
        "article_id": art,
        "colour": rng.integers(0, N_COL + 1, B).astype(np.int32),
    }
    if history:
        batch["purchase_history"] = hist
    return batch


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(jm, rng, seed=0):
    params = _np_tree(jm.init_params(seed))
    for tower in params.values():  # non-zero queries exercise attention
        for name, q in tower.get("attention", {}).items():
            tower["attention"][name] = rng.normal(size=q.shape).astype(
                np.float32)
    return params


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_trees_close(got, want, rtol, atol):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
            err_msg=jax.tree_util.keystr(path))


def _assert_trees_equal(got, want):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path))
        assert np.asarray(a).dtype == np.asarray(b).dtype


# --- JAX training state <-> the bridge's numpy tree ---------------------
def _opt_tree(opt_state):
    inner = opt_state[0]
    if isinstance(inner, optax.ScaleByRssState):
        return {"sum_of_squares": inner.sum_of_squares}
    return {"count": inner.count, "mu": inner.mu, "nu": inner.nu}


def _opt_state(tree):
    if "sum_of_squares" in tree:
        inner = optax.ScaleByRssState(sum_of_squares=tree["sum_of_squares"])
    else:
        inner = optax.ScaleByAdamState(count=tree["count"], mu=tree["mu"],
                                       nu=tree["nu"])
    return (jax.tree_util.tree_map(jnp.asarray, inner), optax.EmptyState())


def jax_state_tree(state):
    if isinstance(state, JaxSparseTrainState):
        tree = {"params": state.params,
                "dense_opt_state": _opt_tree(state.dense_opt_state),
                "accumulators": state.sparse_state.accumulators,
                "step": state.step}
    else:
        tree = {"params": state.params,
                "opt_state": _opt_tree(state.opt_state), "step": state.step}
    return _np_tree(tree)


def jax_state(tree):
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    step = jnp.asarray(tree["step"], jnp.int32)
    if "accumulators" in tree:
        return JaxSparseTrainState(
            params, _opt_state(tree["dense_opt_state"]),
            JaxSparseAdagradState(
                jax.tree_util.tree_map(jnp.asarray, tree["accumulators"])),
            step)
    return JaxTrainState(params, _opt_state(tree["opt_state"]), step)


# --- the two packages' states from one start -----------------------------
def _start(jm, pm, opt_name, sparse, rng):
    """Both packages' states from the JAX init (attention queries made
    non-zero), the optimizer state after two warm-up steps on the JAX side
    so the accumulators and moments are not at their initial values."""
    kwargs = {"learning_rate": LR}
    if opt_name == "adam":
        kwargs["eps"] = ADAM_EPS
    jopt = JaxOptimizerFactory.get_optimizer(opt_name, dict(kwargs))
    popt = OptimizerFactory.get_optimizer(opt_name, dict(kwargs))
    params = _jax_params(jm, rng)
    if sparse:
        js = jax_create_sparse(jm, jopt)
        js = js._replace(params=jax.tree_util.tree_map(jnp.asarray, params))
        jstep = jax_make_sparse_step(jm, jopt, LR)
        ps = create_sparse_train_state(pm, popt)
        pstep = make_sparse_train_step(pm, popt, LR)
    else:
        js = jax_create_state(jm, jopt)
        js = js._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                         opt_state=jopt.init(params))
        jstep = jax_make_step(jm, jopt)
        ps = create_train_state(pm, popt)
        pstep = make_train_step(pm, popt)
    return js, jstep, ps, pstep


def _warm(js, jstep, rng, history=True):
    for _ in range(2):
        js, _ = jstep(js, _jb(_batch(rng, history=history)))
    return js


# ---------------------------------------------------------------------------
def test_apply_logq_correction_matches_jax(rng):
    logits = rng.normal(size=(7, 11)).astype(np.float32)
    ids = rng.integers(0, N_ART + 1, 11).astype(np.int32)
    ids[3] = 0
    want = np.asarray(jax_logq(jnp.asarray(logits), jnp.asarray(ids),
                               jnp.asarray(_logq())))
    got = apply_logq_correction(torch.from_numpy(logits),
                                torch.from_numpy(ids),
                                torch.from_numpy(_logq()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[:, 3], logits[:, 3])  # OOV


@pytest.mark.parametrize("logq", [True, False])
@pytest.mark.parametrize("pooling", ["mean", "attention"])
def test_scores_and_loss_match_jax(rng, pooling, logq):
    jm, pm = _models(pooling, logq)
    params = _jax_params(jm, rng)
    params_from_numpy(pm, params)
    batch = _batch(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want_s = np.asarray(jm.scores(jparams, _jb(batch)))
    want_l = float(jm.loss(jparams, _jb(batch)))
    with torch.no_grad():
        got_s = pm.scores(_tb(batch))
        got_l = pm.loss(_tb(batch))
    assert got_s.dtype == torch.float32 and got_s.shape == (16, 16)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got_l), want_l, rtol=RTOL, atol=ATOL)
    assert (pm.logq is None) == (not logq)


def test_loss_without_logq_is_the_plain_softmax(rng):
    jm, pm = _models(logq=False)
    params_from_numpy(pm, _jax_params(jm, rng))
    batch = _tb(_batch(rng))
    with torch.no_grad():
        logits = pm.scores(batch)
        want = torch.nn.functional.cross_entropy(
            logits, torch.arange(16), reduction="sum")
        np.testing.assert_allclose(float(pm.loss(batch)), float(want),
                                   rtol=RTOL)


def test_create_from_schema_sets_logq_only_when_configured():
    from hm_retrieval_tpu_torch.schema import ModelConfig, Schema

    qs, cs = _specs("mean")
    features = [Feature(**s) for s in qs + cs]
    for use in (True, False):
        schema = Schema(features, ModelConfig(16, ks=[5]),
                        TrainingConfig(use_logq_correction=use),
                        logq=_logq())
        model = TwoTowerModel.create_from_schema(schema, device="cpu")
        assert (model.logq is not None) == use
        if use:
            np.testing.assert_array_equal(model.logq.numpy(), _logq())


@pytest.mark.parametrize("pooling", ["mean", "attention"])
def test_gradients_match_jax(rng, pooling):
    jm, pm = _models(pooling)
    params = _jax_params(jm, rng)
    params_from_numpy(pm, params)
    batch = _batch(rng, dup=True)
    want = _np_tree(jax.grad(jm.loss)(
        jax.tree_util.tree_map(jnp.asarray, params), _jb(batch)))
    named = dict(pm.named_parameters())
    grads = torch.autograd.grad(pm.loss(_tb(batch)), list(named.values()))
    got = flat_to_tree(dict(zip(named, grads)))
    _assert_trees_close(got, want, RTOL, ATOL)


def test_last_candidate_bias_is_invisible_to_the_loss(rng):
    """Why the Adam steps take a larger eps: the loss's gradient with
    respect to the candidate tower's last bias is rounding noise on both
    sides wherever a unit is active for every candidate."""
    jm, pm = _models("mean")
    params = _jax_params(jm, rng)
    params_from_numpy(pm, params)
    batch = _batch(rng)
    named = dict(pm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(pm.loss(_tb(batch)),
                                                list(named.values()))))
    with torch.no_grad():
        c = pm.candidate_forward(_tb(batch))
    active = (c > 0).all(dim=0)
    assert active.any()
    bias = grads["candidate_tower.dense.1.bias"][active]
    scale = grads["candidate_tower.dense.1.weight"].abs().max()
    assert float(bias.abs().max()) < 1e-6 * float(scale)
    jg = jax.grad(jm.loss)(jax.tree_util.tree_map(jnp.asarray, params),
                           _jb(batch))
    jbias = np.asarray(jg["candidate_tower"]["dense"][1]["b"])[active.numpy()]
    assert np.abs(jbias).max() < 1e-6 * float(scale)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
@pytest.mark.parametrize("pooling", ["mean", "attention"])
def test_dense_steps_match_jax(rng, pooling, opt_name, steps):
    jm, pm = _models(pooling)
    js, jstep, ps, pstep = _start(jm, pm, opt_name, False, rng)
    js = _warm(js, jstep, rng)
    ps = train_state_from_numpy(ps, jax_state_tree(js))
    for _ in range(steps):
        batch = _batch(rng, dup=bool(rng.integers(2)))
        js, jm_ = jstep(js, _jb(batch))
        ps, pm_ = pstep(ps, _tb(batch))
        np.testing.assert_allclose(float(pm_["loss"]), float(jm_["loss"]),
                                   rtol=RTOL, atol=ATOL)
    rtol, atol = (RTOL, ATOL) if steps == 1 else (RTOL5, ATOL5)
    _assert_trees_close(train_state_to_numpy(ps), jax_state_tree(js),
                        rtol, atol)
    assert ps.step == int(js.step) == 2 + steps


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("pooling", ["mean", "attention"])
def test_sparse_steps_match_jax(rng, pooling, dup, steps):
    jm, pm = _models(pooling)
    js, jstep, ps, pstep = _start(jm, pm, "adagrad", True, rng)
    js = _warm(js, jstep, rng)
    ps = train_state_from_numpy(ps, jax_state_tree(js))
    for _ in range(steps):
        batch = _batch(rng, dup=dup)
        js, jm_ = jstep(js, _jb(batch))
        ps, pm_ = pstep(ps, _tb(batch))
        np.testing.assert_allclose(float(pm_["loss"]), float(jm_["loss"]),
                                   rtol=RTOL, atol=ATOL)
    rtol, atol = (RTOL, ATOL) if steps == 1 else (RTOL5, ATOL5)
    _assert_trees_close(train_state_to_numpy(ps), jax_state_tree(js),
                        rtol, atol)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("pooling", ["mean", "attention"])
def test_sparse_step_matches_the_ports_dense_adagrad(rng, pooling, dup):
    jm, pm_dense = _models(pooling)
    _, pm_sparse = _models(pooling)
    params = _jax_params(jm, rng)
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": LR})
    dense = create_train_state(pm_dense, opt)
    sparse = create_sparse_train_state(pm_sparse, opt)
    params_from_numpy(pm_dense, params)
    params_from_numpy(pm_sparse, params)
    dstep = make_train_step(pm_dense, opt)
    sstep = make_sparse_train_step(pm_sparse, opt, LR)
    for _ in range(5):
        batch = _tb(_batch(rng, dup=dup))
        dense, md = dstep(dense, batch)
        sparse, ms = sstep(sparse, batch)
        np.testing.assert_allclose(float(ms["loss"]), float(md["loss"]),
                                   rtol=SPARSE_RTOL)
    for name, p in dense.params.items():
        np.testing.assert_allclose(
            sparse.params[name].detach().numpy(), p.detach().numpy(),
            rtol=SPARSE_RTOL, atol=SPARSE_ATOL, err_msg=name)
    for name, acc in sparse.sparse_state.accumulators.items():
        np.testing.assert_allclose(
            acc.numpy(), dense.opt_state.sum_of_squares[name].numpy(),
            rtol=SPARSE_RTOL, atol=SPARSE_ATOL, err_msg=name)


def test_sparse_step_leaves_untouched_rows_bit_unchanged(rng):
    _, pm = _models("attention")
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": LR})
    state = create_sparse_train_state(pm, opt, seed=3)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    acc_before = {n: a.clone()
                  for n, a in state.sparse_state.accumulators.items()}
    step = make_sparse_train_step(pm, opt, LR)
    touched = {n: set() for n in acc_before}
    tables = {"customer_id": "query_tower", "purchase_history": "query_tower",
              "article_id": "candidate_tower", "colour": "candidate_tower"}
    for _ in range(3):
        batch = _batch(rng)
        for f, tower in tables.items():  # ids from the lower half only
            name = f"{tower}.embeddings.{f}"
            batch[f] %= acc_before[name].shape[0] // 2
            touched[name] |= set(batch[f].reshape(-1).tolist())
        state, _ = step(state, _tb(batch))
    for name, acc in state.sparse_state.accumulators.items():
        rows = np.array(sorted(set(range(acc.shape[0])) - touched[name]))
        assert rows.size, name
        np.testing.assert_array_equal(
            state.params[name].detach().numpy()[rows],
            before[name].numpy()[rows], err_msg=name)
        np.testing.assert_array_equal(acc.numpy()[rows],
                                      acc_before[name].numpy()[rows])
        hit = sorted(touched[name] - {0})  # pad id 0 gets no gradient
        assert not np.array_equal(acc.numpy()[hit],
                                  acc_before[name].numpy()[hit]), name


@pytest.mark.parametrize("m", [1, 2, 7, 16, 33])
def test_segment_totals_sum_each_run(rng, m):
    ids = np.sort(rng.integers(0, 5, m))
    g = rng.normal(size=(m, 3)).astype(np.float32)
    got = _segment_totals(torch.from_numpy(ids), torch.from_numpy(g)).numpy()
    for i in range(m):
        np.testing.assert_allclose(got[i], g[ids == ids[i]].sum(0),
                                   rtol=1e-6, atol=1e-6)


def test_sparse_update_of_one_row_is_the_reference_formula():
    table = torch.full((4, 2), 0.5)
    acc = torch.full((4, 2), 0.1)
    ids = torch.tensor([2, 0, 2, 2])
    g = torch.tensor([[1.0, -2.0], [0.5, 0.5], [1.0, 0.0], [-0.5, 1.0]])
    _sparse_adagrad_update(table, acc, ids, g, 0.05, 1e-7)
    g2 = np.array([1.5, -1.0], np.float32)
    acc2 = np.float32(0.1) + g2 * g2
    np.testing.assert_allclose(acc[2].numpy(), acc2, rtol=1e-7)
    np.testing.assert_allclose(
        table[2].numpy(), 0.5 - 0.05 * g2 / np.sqrt(acc2 + 1e-7), rtol=1e-6)
    np.testing.assert_array_equal(table[[1, 3]].numpy(), 0.5)
    np.testing.assert_array_equal(acc[[1, 3]].numpy(), np.float32(0.1))


def test_split_and_merge_dense_params(rng):
    _, pm = _models("attention")
    params = dict(pm.named_parameters())
    dense = split_dense_params(params)
    assert not any(".embeddings." in n for n in dense)
    assert "query_tower.attention.purchase_history" in dense
    assert merge_dense_params(dense, params) == params


# --- the optimizers: optax's order, not torch.optim's (trap a) ------------
def test_adagrad_puts_eps_inside_the_root():
    p = {"w": torch.tensor([1.0, 1.0, 1.0])}
    g = torch.tensor([1e-4, 0.5, 0.0])
    opt = Adagrad(0.1, initial_accumulator_value=0.0, eps=1e-2)
    state = opt.init(p)
    opt.update_({"w": g}, state, p)
    acc = g * g
    want = 1.0 - 0.1 * g / torch.sqrt(acc + 1e-2)  # optax: inside
    torch_optim = 1.0 - 0.1 * g / (torch.sqrt(acc) + 1e-2)  # outside
    np.testing.assert_allclose(p["w"].numpy(), want.numpy(), rtol=1e-6)
    assert not np.allclose(p["w"].numpy(), torch_optim.numpy(), rtol=1e-4)
    assert float(p["w"][2]) == 1.0  # zero gradient, no move


@pytest.mark.parametrize("name", ["adagrad", "adam"])
def test_optimizers_match_optax_on_a_tree(rng, name):
    kwargs = {"learning_rate": 0.03}
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32)}
    jopt = JaxOptimizerFactory.get_optimizer(name, dict(kwargs))
    popt = OptimizerFactory.get_optimizer(name, dict(kwargs))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = popt.init(pp)
    for _ in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                              jp)
        jp = optax.apply_updates(jp, upd)
        popt.update_({k: torch.from_numpy(v) for k, v in grads.items()}, ps,
                     pp)
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL)
    if name == "adam":
        assert ps.count.dtype == torch.int32 and int(ps.count) == 4
        assert int(js[0].count) == 4


def test_factory_contract():
    with pytest.raises(ValueError, match="unknown optimizer"):
        OptimizerFactory.get_optimizer("sgd", {"learning_rate": 0.1})
    with pytest.raises(ValueError, match="learning_rate"):
        OptimizerFactory.get_optimizer("adagrad", {})
    opt = OptimizerFactory.get_optimizer("AdaGrad", {"learning_rate": 0.1})
    assert isinstance(opt, Adagrad)
    assert (opt.initial_accumulator_value, opt.eps) == (0.1, 1e-7)
    assert isinstance(
        OptimizerFactory.get_optimizer("adam", {"learning_rate": 0.1}), Adam)


# --- mixed negatives --------------------------------------------------------
N_CAT, M_NEG = 40, 12


def _catalogs(rng):
    cols = {"article_id": np.arange(1, N_CAT + 1, dtype=np.int32),
            "colour": rng.integers(0, N_COL + 1, N_CAT).astype(np.int32)}
    return JaxCatalog(cols), CandidateCatalog(cols, device="cpu")


@pytest.mark.parametrize("logq", [True, False])
def test_mixed_negatives_loss_matches_jax(rng, logq):
    jm, pm = _models("attention", logq)
    params = _jax_params(jm, rng)
    params_from_numpy(pm, params)
    jcat, pcat = _catalogs(rng)
    batch = _batch(rng)
    key = jax.random.PRNGKey(5)
    want = float(jax_mixed_loss(jm, jax.tree_util.tree_map(jnp.asarray,
                                                           params),
                                _jb(batch), jcat, key, M_NEG))
    negatives = _tb(_np_tree(jcat.sample(key, M_NEG)))
    with torch.no_grad():
        got = float(mixed_negatives_loss(pm, _tb(batch), pcat, None, M_NEG,
                                         negatives=negatives))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("logq", [True, False])
def test_mixed_negatives_steps_match_jax(rng, logq, steps):
    jm, pm = _models("mean", logq)
    jcat, pcat = _catalogs(rng)
    jopt = JaxOptimizerFactory.get_optimizer("adagrad", {"learning_rate": LR})
    popt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": LR})
    params = _jax_params(jm, rng)
    js = jax_create_state(jm, jopt)
    js = js._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                     opt_state=jopt.init(params))
    jstep = jax_make_step(jm, jopt, catalog=jcat,
                          num_uniform_negatives=M_NEG, base_seed=11)
    ps = train_state_from_numpy(create_train_state(pm, popt),
                                jax_state_tree(js))
    pstep = make_train_step(pm, popt, catalog=pcat,
                            num_uniform_negatives=M_NEG, base_seed=11)
    for i in range(steps):
        batch = _batch(rng)
        # the rows the JAX step draws at this step
        key = jax.random.fold_in(jax.random.PRNGKey(11), i)
        negatives = _tb(_np_tree(jcat.sample(key, M_NEG)))
        js, jm_ = jstep(js, _jb(batch))
        ps, pm_ = pstep(ps, _tb(batch), negatives=negatives)
        np.testing.assert_allclose(float(pm_["loss"]), float(jm_["loss"]),
                                   rtol=RTOL, atol=ATOL)
    rtol, atol = (RTOL, ATOL) if steps == 1 else (RTOL5, ATOL5)
    _assert_trees_close(train_state_to_numpy(ps), jax_state_tree(js),
                        rtol, atol)


def test_negatives_replay_from_base_seed_and_step(rng):
    """The port's own stream: a fixed function of (base_seed, step), so a
    resumed run draws what the first run drew."""
    _, pm = _models("mean")
    _, pcat = _catalogs(rng)
    gen = torch.Generator()
    draws = {}
    for base, step in [(0, 0), (0, 1), (1, 0), (0, 0)]:
        gen.manual_seed(step_seed(base, step))
        draws.setdefault((base, step), []).append(
            pcat.sample(gen, 64)["article_id"])
    torch.testing.assert_close(*draws[(0, 0)], rtol=0, atol=0)
    assert not torch.equal(draws[(0, 0)][0], draws[(0, 1)][0])
    assert not torch.equal(draws[(0, 0)][0], draws[(1, 0)][0])
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": LR})
    step = make_train_step(pm, opt, catalog=pcat, num_uniform_negatives=8,
                           base_seed=4)
    batch = _tb(_batch(rng))
    state = create_train_state(pm, opt, seed=1)
    saved = train_state_to_numpy(state)
    _, m1 = step(state, batch)
    state = train_state_from_numpy(state, saved)
    _, m2 = step(state, batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_negatives_draw_on_the_catalogs_device(rng, monkeypatch):
    """Unlike the initial weights (drawn on the CPU whatever the model's
    device), the uniform negatives' generator lives on the catalog's
    device: each step draws its rows where they are gathered, so one seed
    gives other negatives on the card than on the CPU."""
    _, pm = _models("mean")
    _, pcat = _catalogs(rng)
    made, real = [], torch.Generator

    def recording(device="cpu"):
        made.append(torch.device(device))
        return real(device=device)

    monkeypatch.setattr(torch, "Generator", recording)
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": LR})
    make_train_step(pm, opt, catalog=pcat, num_uniform_negatives=8)
    assert made == [pcat.device]


def test_uniform_negatives_require_a_catalog():
    _, pm = _models("mean")
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": LR})
    with pytest.raises(ValueError, match="CandidateCatalog"):
        make_train_step(pm, opt, num_uniform_negatives=4)
    step = make_train_step(pm, opt)
    state = create_train_state(pm, opt)
    with pytest.raises(ValueError, match="negatives"):
        step(state, _tb(_batch(np.random.default_rng(0))), negatives={})


# --- path selection ---------------------------------------------------------
@pytest.mark.parametrize("use_sparse", [True, False])
@pytest.mark.parametrize("optimizer_name", ["adagrad", "Adagrad", "adam"])
@pytest.mark.parametrize("num_uniform", [0, 8])
def test_path_selection_matches_the_jax_runner(use_sparse, optimizer_name,
                                               num_uniform, rng):
    kw = dict(use_sparse_embedding_optimizer=use_sparse,
              optimizer_name=optimizer_name,
              num_uniform_negatives=num_uniform)
    tc, jtc = TrainingConfig(**kw), JaxTrainingConfig(**kw)
    # runners/modelling.py's choice, as written there
    want = (jtc.use_sparse_embedding_optimizer
            and jtc.optimizer_name.lower() == "adagrad"
            and jtc.num_uniform_negatives == 0)
    assert uses_sparse_step(tc) == want
    _, pm = _models("mean")
    catalog = _catalogs(rng)[1] if num_uniform else None
    state, step = make_single_device_trainer(pm, tc, catalog)
    assert isinstance(state, SparseTrainState) == want
    opt_state = state.dense_opt_state if want else state.opt_state
    adam = optimizer_name.lower() == "adam"
    assert isinstance(opt_state, AdamState if adam else AdagradState)
    state, m = step(state, _tb(_batch(rng)))
    assert state.step == 1 and np.isfinite(float(m["loss"]))


# --- the bridge carries training states exactly -----------------------------
@pytest.mark.parametrize("kind", ["adagrad", "adam", "sparse"])
def test_train_state_round_trip_is_exact(rng, kind):
    jm, pm = _models("attention")
    js, jstep, ps, _ = _start(jm, pm, "adagrad" if kind == "sparse" else kind,
                              kind == "sparse", rng)
    js = _warm(js, jstep, rng)
    tree = jax_state_tree(js)
    ps = train_state_from_numpy(ps, tree)
    back = train_state_to_numpy(ps)
    _assert_trees_equal(back, tree)
    # and the JAX package steps from the port's tree as from its own
    batch = _jb(_batch(rng))
    _, m_own = jstep(jax_state(tree), batch)
    _, m_port = jstep(jax_state(back), batch)
    assert float(m_own["loss"]) == float(m_port["loss"])


def test_bridge_transposes_optimizer_state_of_weights(rng):
    jm, pm = _models("mean")
    js, jstep, ps, _ = _start(jm, pm, "adam", False, rng)
    js = _warm(js, jstep, rng)
    ps = train_state_from_numpy(ps, jax_state_tree(js))
    w = np.asarray(js.opt_state[0].mu["query_tower"]["dense"][0]["w"])
    got = ps.opt_state.mu["query_tower.dense.0.weight"].numpy()
    assert got.shape == w.T.shape
    np.testing.assert_array_equal(got, w.T)


def test_bridge_rejects_a_mismatched_state(rng):
    jm, pm = _models("mean")
    js, _, ps, _ = _start(jm, pm, "adagrad", False, rng)
    tree = jax_state_tree(js)
    del tree["opt_state"]["sum_of_squares"]["query_tower"]["embeddings"][
        "customer_id"]
    with pytest.raises(ValueError, match="sum_of_squares"):
        train_state_from_numpy(ps, tree)
