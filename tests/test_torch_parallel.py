"""The port's data-parallel training and sharded lookup over a one-process
mesh, against the JAX package's on the conftest's 8-device CPU mesh.

The port's mesh is ``make_mesh(D, S, devices=["cpu"] * 8)`` of the same
(data, model) shape: one device repeated, every shard run in turn, the
collectives in-process. Models, batches and the JAX <-> port state helpers
are ``tests/test_torch_training.py``'s (two towers, a customer table, a
mean- or attention-pooled purchase history, an article and a colour table,
logQ). Tolerances: rtol 1e-5 for a loss; rtol 1e-4 / atol 1e-6 for
gradients and after one step (``tests/test_parallel.py``); rtol 1e-4 /
atol 1e-5 after three steps; the sparse data-parallel step as
``tests/test_sparse_dp.py`` holds it, rtol 1e-5 / atol 1e-7, against the
JAX package's own.

Adam takes eps = 1e-2 here (MESH_ADAM_EPS), where the single-device tests
take 1e-3 (``tests/test_torch_training.py``, whose docstring says why): the
candidate tower's last bias has a gradient that is zero in exact arithmetic
and rounding noise on both sides, and the mesh's sums over 8 shards make
that noise a few times larger (about 5e-7 here), which Adam divides by eps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.models import OptimizerFactory as JaxOptimizerFactory
from hm_retrieval_tpu.models import create_train_state as jax_create_state
from hm_retrieval_tpu.models.sparse_optimizer import (
    create_sparse_train_state as jax_create_sparse,
)
from hm_retrieval_tpu.parallel import (
    make_dp_sparse_train_step as jax_dp_sparse_step,
    make_dp_train_step as jax_dp_step,
    make_global_negatives_loss as jax_global_loss,
    make_mesh as jax_make_mesh,
    make_sharded_lookup as jax_sharded_lookup,
    replicate_sparse_state as jax_replicate_sparse,
    replicate_state as jax_replicate,
    shard_batch as jax_shard_batch,
    shard_table as jax_shard_table,
)
from hm_retrieval_tpu_torch.models import (
    OptimizerFactory,
    create_train_state,
    make_train_step,
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from hm_retrieval_tpu_torch.models.bridge import flat_to_tree
from hm_retrieval_tpu_torch.models.sparse_optimizer import (
    create_sparse_train_state,
)
from hm_retrieval_tpu_torch.parallel import (
    make_dp_sparse_train_step,
    make_dp_train_step,
    make_global_negatives_loss,
    make_mesh,
    make_sharded_lookup,
    replicate_sparse_state,
    replicate_state,
    shard_batch,
    shard_table,
)
from hm_retrieval_tpu_torch.parallel.global_negatives import (
    shard_losses,
    tower_forward,
)
from hm_retrieval_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    place_global,
    replicate_pytree,
    replicated,
    row_sharded,
    training_device,
)
from tests.test_torch_training import (
    LR,
    M_NEG,
    _assert_trees_close,
    _batch,
    _catalogs,
    _jax_params,
    _models,
    _np_tree,
    _tb,
    jax_state_tree,
)

B = 32  # 4 rows a shard at D = 8
RTOL1, ATOL1 = 1e-4, 1e-6  # gradients, one step
RTOL3, ATOL3 = 1e-4, 1e-5  # three steps
DP_SPARSE_RTOL, DP_SPARSE_ATOL = 1e-5, 1e-7
MESH_ADAM_EPS = 1e-2  # see the module docstring


def meshes(data, model):
    return (jax_make_mesh(data=data, model=model),
            make_mesh(data, model, devices=["cpu"] * 8))


def _opts(name):
    kwargs = {"learning_rate": LR}
    if name == "adam":
        kwargs["eps"] = MESH_ADAM_EPS
    return (JaxOptimizerFactory.get_optimizer(name, dict(kwargs)),
            OptimizerFactory.get_optimizer(name, dict(kwargs)))


# --- global negatives -------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_global_negatives_loss_matches_jax_and_model_loss(rng, shape):
    jm, pm = _models("attention")
    params = _jax_params(jm, rng)
    params_from_numpy(pm, params)
    batch = _batch(rng, B=B)
    jmesh, pmesh = meshes(*shape)
    want = float(jax.jit(jax_global_loss(jm, jmesh))(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax_shard_batch(batch, jmesh)))
    loss_fn = make_global_negatives_loss(pm, pmesh)
    with torch.no_grad():
        got = float(loss_fn(dict(pm.named_parameters()), _tb(batch)))
        single = float(pm.loss(_tb(batch)))
        split = float(loss_fn(dict(pm.named_parameters()),
                              shard_batch(batch, pmesh)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, single, rtol=1e-5)
    assert split == got


def test_global_negatives_gradients_match_jax(rng):
    jm, pm = _models("attention")
    params = _jax_params(jm, rng)
    params_from_numpy(pm, params)
    batch = _batch(rng, B=B, dup=True)
    jmesh, pmesh = meshes(8, 1)
    want = _np_tree(jax.jit(jax.grad(jax_global_loss(jm, jmesh)))(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax_shard_batch(batch, jmesh)))
    named = dict(pm.named_parameters())
    loss = make_global_negatives_loss(pm, pmesh)(named, _tb(batch))
    grads = torch.autograd.grad(loss, list(named.values()))
    _assert_trees_close(flat_to_tree(dict(zip(named, grads))), want,
                        RTOL1, ATOL1)


def test_positives_sit_at_the_shard_offset(rng):
    """Row i of data shard d is positive at global column d*b + i.
    Each shard's loss equals the sum-CE of its rows of the global (B, B)
    logits with the diagonal as the labels; labels at column i would
    not."""
    _, pm = _models("mean")
    pm.init_params(0)
    batch = _tb(_batch(rng, B=B))
    named = dict(pm.named_parameters())
    D, b = 8, B // 8
    with torch.no_grad():
        q = pm.query_forward(batch)
        c = pm.candidate_forward(batch)
        shards = [{k: v[d * b:(d + 1) * b] for k, v in batch.items()}
                  for d in range(D)]
        qs = [tower_forward(pm, "query_tower", named, s) for s in shards]
        cs = [tower_forward(pm, "candidate_tower", named, s) for s in shards]
        losses = shard_losses(pm, qs, cs, [s["article_id"] for s in shards])
        logits = q @ c.T - pm.logq[batch["article_id"].long()][None, :]
        lp = torch.log_softmax(logits, dim=-1)
    for d in range(D):
        rows = torch.arange(d * b, (d + 1) * b)
        want = -lp[rows, rows].sum()
        wrong = -lp[rows, rows - d * b].sum()
        np.testing.assert_allclose(float(losses[d]), float(want), rtol=1e-5)
        if d:
            assert abs(float(losses[d]) - float(wrong)) > 1e-3


# --- data-parallel dense ------------------------------------------------------
def _dp_dense_pair(rng, opt_name, negatives=False):
    jm, pm = _models("mean")
    jopt, popt = _opts(opt_name)
    jmesh, pmesh = meshes(8, 1)
    params = _jax_params(jm, rng)
    js = jax_create_state(jm, jopt)
    js = js._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                     opt_state=jopt.init(params))
    kw, pkw, cats = {}, {}, None
    if negatives:
        cats = _catalogs(rng)
        kw = dict(catalog=cats[0], num_uniform_negatives=M_NEG, base_seed=11)
        pkw = dict(catalog=cats[1], num_uniform_negatives=M_NEG, base_seed=11)
    js = jax_replicate(js, jmesh)
    jstep = jax_dp_step(jm, jopt, jmesh, **kw)
    ps = replicate_state(create_train_state(pm, popt), pmesh)
    ps = train_state_from_numpy(ps, jax_state_tree(js))
    pstep = make_dp_train_step(pm, popt, pmesh, **pkw)
    return jm, pm, js, jstep, ps, pstep, jmesh, cats


@pytest.mark.parametrize("kind", ["adagrad", "adam", "uniform_negatives"])
def test_dp_dense_steps_match_jax(rng, kind):
    negatives = kind == "uniform_negatives"
    _, _, js, jstep, ps, pstep, jmesh, cats = _dp_dense_pair(
        rng, "adam" if kind == "adam" else "adagrad", negatives)
    for _ in range(3):
        batch = _batch(rng, B=B, dup=bool(rng.integers(2)))
        kw = {}
        if negatives:  # the rows the JAX step draws at this step
            key = jax.random.fold_in(jax.random.PRNGKey(11), int(js.step))
            kw = {"negatives": _tb(_np_tree(cats[0].sample(key, M_NEG)))}
        js, jm_ = jstep(js, jax_shard_batch(batch, jmesh))
        ps, pm_ = pstep(ps, _tb(batch), **kw)
        np.testing.assert_allclose(float(pm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    _assert_trees_close(train_state_to_numpy(ps), jax_state_tree(js),
                        RTOL3, ATOL3)
    assert ps.step == int(js.step) == 3


@pytest.mark.parametrize("negatives", [False, True])
def test_dp_dense_equals_the_single_device_step(rng, negatives):
    """Without ``negatives=`` the mesh step draws the rows the
    single-device step draws from (base_seed, step), once for all shards."""
    jm, pm_single = _models("mean")
    _, pm_mesh = _models("mean")
    params = _jax_params(jm, rng)
    _, popt = _opts("adagrad")
    pkw = {}
    if negatives:
        pkw = dict(catalog=_catalogs(rng)[1], num_uniform_negatives=M_NEG,
                   base_seed=3)
    single = create_train_state(pm_single, popt)
    mesh_state = replicate_state(create_train_state(pm_mesh, popt),
                                 make_mesh(8, 1, devices=["cpu"] * 8))
    params_from_numpy(pm_single, params)
    params_from_numpy(pm_mesh, params)
    s_step = make_train_step(pm_single, popt, **pkw)
    m_step = make_dp_train_step(pm_mesh, popt,
                                make_mesh(4, 2, devices=["cpu"] * 8), **pkw)
    for _ in range(3):
        batch = _tb(_batch(rng, B=B))
        single, ms = s_step(single, batch)
        mesh_state, mm = m_step(mesh_state, batch)
        np.testing.assert_allclose(float(mm["loss"]), float(ms["loss"]),
                                   rtol=1e-5)
    _assert_trees_close(train_state_to_numpy(mesh_state),
                        train_state_to_numpy(single), RTOL3, ATOL3)


@pytest.mark.parametrize("sparse", [False, True])
def test_one_backward_replays_bit_identical(rng, sparse):
    """The shards' losses are summed in shard order before one
    ``autograd.grad``, and the gradients are summed in shard order, so two
    replays from one state give the same bits."""
    _, pm = _models("attention")
    _, popt = _opts("adagrad")
    pmesh = make_mesh(8, 1, devices=["cpu"] * 8)
    if sparse:
        state = replicate_sparse_state(create_sparse_train_state(pm, popt),
                                       pmesh)
        step = make_dp_sparse_train_step(pm, popt, LR, pmesh)
    else:
        state = replicate_state(create_train_state(pm, popt), pmesh)
        step = make_dp_train_step(pm, popt, pmesh)
    saved = train_state_to_numpy(state)
    batches = [_tb(_batch(rng, B=B, dup=True)) for _ in range(3)]
    runs = []
    for _ in range(2):
        state = train_state_from_numpy(state, saved)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"])
        runs.append((train_state_to_numpy(state), torch.stack(losses)))
    assert torch.equal(runs[0][1], runs[1][1])
    jax.tree_util.tree_map(np.testing.assert_array_equal, runs[0][0],
                           runs[1][0])


# --- data-parallel sparse -----------------------------------------------------
@pytest.mark.parametrize("case", ["multi_step", "duplicates", "no_history"])
def test_dp_sparse_steps_match_jax(rng, case):
    """Ids that several shards touch get one update of their
    summed gradient; the (b, L) history ids flatten to b*L rows."""
    jm, pm = _models("attention", history=case != "no_history")
    jopt, popt = _opts("adagrad")
    jmesh, pmesh = meshes(8, 1)
    js = jax_create_sparse(jm, jopt)
    js = js._replace(params=jax.tree_util.tree_map(
        jnp.asarray, _jax_params(jm, rng)))
    js = jax_replicate_sparse(js, jmesh)
    jstep = jax_dp_sparse_step(jm, jopt, LR, jmesh)
    ps = replicate_sparse_state(create_sparse_train_state(pm, popt), pmesh)
    ps = train_state_from_numpy(ps, jax_state_tree(js))
    pstep = make_dp_sparse_train_step(pm, popt, LR, pmesh)
    steps = 1 if case == "duplicates" else 3
    for _ in range(steps):
        batch = _batch(rng, B=B, dup=case == "duplicates",
                       history=case != "no_history")
        js, jm_ = jstep(js, jax_shard_batch(batch, jmesh))
        ps, pm_ = pstep(ps, _tb(batch))
        np.testing.assert_allclose(float(pm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    rtol, atol = ((DP_SPARSE_RTOL, DP_SPARSE_ATOL) if steps == 1
                  else (RTOL3, ATOL3))
    _assert_trees_close(train_state_to_numpy(ps), jax_state_tree(js),
                        rtol, atol)


# --- the sharded lookup ---------------------------------------------------------
def _lookup_pair(strategy, shape, capacity=None):
    jmesh, pmesh = meshes(*shape)
    return (jax.jit(jax_sharded_lookup(jmesh, strategy, capacity)),
            make_sharded_lookup(pmesh, strategy, capacity), jmesh, pmesh)


@pytest.mark.parametrize("ids_kind", ["uniform", "zipf"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
@pytest.mark.parametrize("strategy", ["psum", "all_to_all"])
def test_lookup_equals_the_dense_gather(rng, strategy, shape, ids_kind):
    V, E, n = 100, 16, 64
    table = rng.normal(size=(V, E)).astype(np.float32)
    if ids_kind == "zipf":  # a heavy head: id 0 repeats about n/3 times
        ids = np.minimum(rng.zipf(1.3, n) - 1, V - 1).astype(np.int32)
    else:
        ids = rng.integers(0, V, n).astype(np.int32)
    jlookup, plookup, jmesh, pmesh = _lookup_pair(strategy, shape)
    from hm_retrieval_tpu.parallel.mesh import batch_sharding as jax_bs

    want = np.asarray(jlookup(jax_shard_table(table, jmesh),
                              jax.device_put(ids, jax_bs(jmesh))))
    got = plookup(shard_table(table, pmesh), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, table[ids])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ids_kind", ["uniform", "zipf"])
@pytest.mark.parametrize("strategy", ["psum", "all_to_all"])
def test_lookup_gradient_equals_the_dense_gathers(rng, strategy, ids_kind):
    """Duplicate ids sum their gradients into their row through either
    exchange, as through a dense gather, and as in JAX."""
    V, E, n = 80, 8, 64
    table = rng.normal(size=(V, E)).astype(np.float32)
    if ids_kind == "zipf":
        ids = np.minimum(rng.zipf(1.3, n) - 1, V - 1).astype(np.int32)
    else:
        ids = rng.integers(0, V, n).astype(np.int32)
    w = rng.normal(size=(n, E)).astype(np.float32)
    jlookup, plookup, jmesh, pmesh = _lookup_pair(strategy, (1, 8))
    g_jax = np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(jlookup(t, jnp.asarray(ids)) * w)))(
            jax_shard_table(table, jmesh)))[:V]
    dense = torch.from_numpy(table).requires_grad_()
    (g_ref,) = torch.autograd.grad(
        (dense[torch.from_numpy(ids).long()] * torch.from_numpy(w)).sum(),
        dense)
    sharded = shard_table(table, pmesh)
    leaves = [s.requires_grad_() for s in sharded.shards]
    out = plookup(sharded, torch.from_numpy(ids))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    got = torch.cat(grads)[:V].numpy()
    np.testing.assert_allclose(got, g_ref.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, g_jax, rtol=1e-5, atol=1e-6)
    assert not torch.cat(grads)[V:].any()  # pad rows get no gradient


def test_a_hot_id_needs_one_slot(rng):
    _, plookup, _, pmesh = _lookup_pair("all_to_all", (1, 8), capacity=1)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    ids = np.full((48,), 37, np.int32)
    got = plookup(shard_table(table, pmesh), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), table[ids])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capacity_overflow_poisons_with_nan(rng, dtype):
    """Three distinct ids of shard 0 (R = 8) at capacity 2 give NaN
    in the table's dtype, as JAX gives it, never a truncated lookup."""
    jlookup, plookup, jmesh, pmesh = _lookup_pair("all_to_all", (1, 8),
                                                  capacity=2)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    ids = np.array([0, 1, 2, 0, 1, 2, 0, 0], np.int32)
    assert np.isnan(np.asarray(jlookup(jax_shard_table(table, jmesh),
                                       jnp.asarray(ids)))).all()
    out = plookup(shard_table(torch.from_numpy(table).to(dtype), pmesh),
                  torch.from_numpy(ids))
    assert out.dtype == dtype and out.isnan().all()
    # capacity 3 holds them
    _, exact, _, _ = _lookup_pair("all_to_all", (1, 8), capacity=3)
    np.testing.assert_array_equal(
        exact(shard_table(table, pmesh), torch.from_numpy(ids)).numpy(),
        table[ids])


def test_default_capacity_is_exact_when_a_shard_has_fewer_rows(rng):
    """The default capacity min(b, R) never overflows (R = 5 < 64
    ids here: a shard cannot own more than R distinct ids)."""
    _, plookup, _, pmesh = _lookup_pair("all_to_all", (1, 8))
    table = rng.normal(size=(40, 4)).astype(np.float32)
    ids = rng.integers(0, 40, 64).astype(np.int32)
    got = plookup(shard_table(table, pmesh), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), table[ids])


def test_lookup_rejects_bad_arguments():
    pmesh = make_mesh(1, 8, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="unknown strategy"):
        make_sharded_lookup(pmesh, "gather")
    with pytest.raises(ValueError, match="capacity"):
        make_sharded_lookup(pmesh, "all_to_all", capacity=0)
    with pytest.raises(ValueError, match="table shards"):
        make_sharded_lookup(pmesh)(
            shard_table(np.zeros((16, 4), np.float32),
                        make_mesh(1, 4, devices=["cpu"] * 4)),
            torch.zeros(8, dtype=torch.long))


# --- the mesh's layout ----------------------------------------------------------
def test_shard_batch_and_placement():
    pmesh = make_mesh(4, 2, devices=["cpu"] * 8)
    batch = {"a": np.arange(8), "b": np.arange(16).reshape(8, 2)}
    shards = shard_batch(batch, pmesh)
    assert len(shards) == 4
    np.testing.assert_array_equal(shards[3]["b"].numpy(), batch["b"][6:])
    rows = place_global(np.arange(6), row_sharded(pmesh))
    assert [r.tolist() for r in rows] == [[0, 1, 2], [3, 4, 5]]
    assert place_global(np.arange(3), replicated(pmesh)).tolist() == [0, 1, 2]
    assert len(place_global(np.arange(8), batch_sharding(pmesh))) == 4
    with pytest.raises(ValueError, match="do not split"):
        shard_batch({"a": np.arange(6)}, pmesh)
    tree = replicate_pytree({"x": torch.ones(2), "y": [torch.zeros(1)]}, pmesh)
    assert tree["x"].device == torch.device("cpu")


def _two_devices():
    grid = np.empty((1, 2), dtype=object)
    grid[0, 0], grid[0, 1] = torch.device("cuda", 0), torch.device("cuda", 1)
    return Mesh(grid)


def test_several_devices_or_processes_raise_item_6_3(monkeypatch):
    """Item 6.3 (several processes) is ported: ``initialize_multihost()``
    without a group stays single-process, and a mesh built in one process
    keeps its one-process steps inside a 2-rank group
    (``tests/test_torch_multiprocess.py`` runs real groups). Item 6.4 is
    ported too: one process driving several distinct devices no longer
    raises ``NotImplementedError``; a grid naming a card raises
    ``RuntimeError`` naming CUDA before any step where there is none, and
    with CUDA reported present it is accepted, its first device returned.
    A rank of a group whose cells are several distinct devices still
    raises ``NotImplementedError``, naming item 6.4 over ranks."""
    _, pm = _models("mean")
    _, popt = _opts("adagrad")
    for build in (training_device,
                  lambda m: make_dp_train_step(pm, popt, m),
                  lambda m: make_dp_sparse_train_step(pm, popt, LR, m)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(_two_devices())
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        assert training_device(_two_devices()) == torch.device("cuda", 0)
        grid = np.empty((2, 1), dtype=object)
        grid[0, 0], grid[1, 0] = torch.device("cpu"), torch.device("cuda", 0)
        assert training_device(Mesh(grid)) == torch.device("cpu")
        # rank 0 of two holding cpu and cuda:0: several devices a rank
        group = np.empty((2, 2), dtype=object)
        group[0, 0], group[0, 1] = torch.device("cpu"), torch.device("cuda", 0)
        group[1, 0] = group[1, 1] = torch.device("cpu")
        with pytest.raises(NotImplementedError, match="item 6.4 over ranks"):
            training_device(Mesh(group, np.array([[0, 0], [1, 1]])))
    from hm_retrieval_tpu_torch.parallel.mesh import (
        TORCHRUN_ENV,
        data_axis_process_aligned,
        initialize_multihost,
    )

    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    assert initialize_multihost() is None
    pmesh = make_mesh(8, 1, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    assert pmesh.process_count == 1 and data_axis_process_aligned(pmesh)
    assert training_device(pmesh) == torch.device("cpu")
    make_dp_train_step(pm, popt, pmesh)


def test_a_batch_the_data_axis_does_not_divide_raises(rng):
    _, pm = _models("mean")
    _, popt = _opts("adagrad")
    pmesh = make_mesh(8, 1, devices=["cpu"] * 8)
    state = replicate_state(create_train_state(pm, popt), pmesh)
    step = make_dp_train_step(pm, popt, pmesh)
    with pytest.raises(ValueError, match="do not split"):
        step(state, _tb(_batch(rng, B=12)))
