"""The port's row-sharded training over a one-process mesh, its mesh states
through the bridge and the checkpoint, and the chunked step over a mesh,
against the JAX package on the conftest's 8-device CPU mesh.

Models, batches and the JAX <-> port state helpers are
``tests/test_torch_training.py``'s; the meshes, tolerances and Adam's eps are
``tests/test_torch_parallel.py``'s. Every table of those models has a row
count (61, 41, 7) that 4 and 8 do not divide, so each sharded table carries
pad rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.models.sparse_optimizer import (
    _sparse_adagrad_update as jax_sparse_update,
)
from hm_retrieval_tpu.parallel import (
    create_sharded_sparse_state as jax_create_sharded_sparse,
    create_sharded_train_state as jax_create_sharded,
    make_sharded_sparse_train_step as jax_sharded_sparse_step,
    make_sharded_train_step as jax_sharded_step,
    shard_batch as jax_shard_batch,
)
from hm_retrieval_tpu_torch.data import make_chunked_train_step
from hm_retrieval_tpu_torch.models import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from hm_retrieval_tpu_torch.models.sparse_optimizer import (
    _segment_totals,
    _sparse_adagrad_update,
)
from hm_retrieval_tpu_torch.parallel import (
    ShardedTable,
    create_sharded_sparse_state,
    create_sharded_train_state,
    make_dp_sparse_train_step,
    make_dp_train_step,
    make_mesh,
    make_sharded_sparse_train_step,
    make_sharded_train_step,
    param_shardings,
    replicate_sparse_state,
    replicate_state,
    sharded_sparse_specs,
    unpad_params,
)
from hm_retrieval_tpu_torch.parallel.mesh import ROWS
from hm_retrieval_tpu_torch.runners import CheckpointManager, export_model
from hm_retrieval_tpu_torch.utils.pytree_io import load_pytree_npz
from tests.test_torch_parallel import (
    DP_SPARSE_ATOL,
    DP_SPARSE_RTOL,
    RTOL3,
    ATOL3,
    _opts,
    meshes,
)
from tests.test_torch_training import (
    LR,
    _assert_trees_close,
    _assert_trees_equal,
    _batch,
    _jax_params,
    _models,
    _np_tree,
    _tb,
    jax_state,
    jax_state_tree,
)

B = 32
ALL = ["customer_id", "purchase_history", "article_id", "colour"]
ROW_COUNTS = {"customer_id": 61, "purchase_history": 41, "article_id": 41,
              "colour": 7}


def _tables(tree):
    """{feature: (rows, E)} of a params-shaped tree."""
    return {f: t for tower in tree.values()
            for f, t in tower["embeddings"].items()}


# --- row-sharded dense ----------------------------------------------------------
def _sharded_dense_pair(rng, shape, feats, opt_name="adagrad"):
    jm, pm = _models("mean")
    jopt, popt = _opts(opt_name)
    jmesh, pmesh = meshes(*shape)
    js = jax_create_sharded(jm, jopt, jmesh, feats, seed=0)
    jstep = jax_sharded_step(jm, jopt, jmesh)
    ps = create_sharded_train_state(pm, popt, pmesh, feats)
    ps = train_state_from_numpy(ps, jax_state_tree(js))
    pstep = make_sharded_train_step(pm, popt, pmesh)
    return pm, js, jstep, ps, pstep, jmesh


@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_row_sharded_dense_steps_match_jax(rng, opt_name):
    pm, js, jstep, ps, pstep, jmesh = _sharded_dense_pair(
        rng, (2, 4), ALL, opt_name)
    assert isinstance(ps.params["query_tower.embeddings.customer_id"],
                      ShardedTable)
    # the model's own copy of a sharded table is released
    assert pm.query_tower.embeddings["customer_id"].shape[0] == 0
    for _ in range(3):
        batch = _batch(rng, B=B, dup=bool(rng.integers(2)))
        js, jm_ = jstep(js, jax_shard_batch(batch, jmesh))
        ps, pm_ = pstep(ps, _tb(batch))
        np.testing.assert_allclose(float(pm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    _assert_trees_close(train_state_to_numpy(ps), jax_state_tree(js),
                        RTOL3, ATOL3)


def test_row_sharded_dense_equals_the_data_parallel_step(rng):
    """The same step from the same seed, with the customer table sharded or
    replicated."""
    _, pm_dp = _models("mean")
    _, pm_sh = _models("mean")
    _, popt = _opts("adagrad")
    dp_mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    dp = create_sharded_train_state(pm_dp, popt, dp_mesh, [])
    sh = create_sharded_train_state(pm_sh, popt, mesh, ["customer_id"])
    dp_step = make_dp_train_step(pm_dp, popt, dp_mesh)
    sh_step = make_sharded_train_step(pm_sh, popt, mesh)
    for _ in range(3):
        batch = _tb(_batch(rng, B=B))
        dp, md = dp_step(dp, batch)
        sh, ms = sh_step(sh, batch)
        np.testing.assert_allclose(float(ms["loss"]), float(md["loss"]),
                                   rtol=1e-5)
    got = unpad_params(sh.params, pm_sh)
    for name, p in dp.params.items():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   p.detach().numpy(), rtol=RTOL3,
                                   atol=ATOL3, err_msg=name)


def test_param_shardings_name_the_sharded_tables():
    _, pm = _models("mean")
    shardings = param_shardings(pm, make_mesh(2, 4, devices=["cpu"] * 8),
                                ["customer_id"])
    rows = [n for n, s in shardings.items() if s.spec == ROWS]
    assert rows == ["query_tower.embeddings.customer_id"]
    assert set(shardings) == {n for n, _ in pm.named_parameters()}


# --- row-sharded sparse --------------------------------------------------------
def _sharded_sparse_pair(rng, shape, feats, history=True):
    jm, pm = _models("attention", history=history)
    jopt, popt = _opts("adagrad")
    jmesh, pmesh = meshes(*shape)
    js = jax_create_sharded_sparse(jm, jopt, jmesh, feats, seed=0)
    params = _jax_params(jm, rng)
    padded = jax.tree_util.tree_map(
        lambda want, got: np.pad(want, [(0, got.shape[0] - want.shape[0])]
                                 + [(0, 0)] * (want.ndim - 1)),
        params, _np_tree(js.params))
    js = js._replace(params=jax.tree_util.tree_map(jnp.asarray, padded))
    jstep = jax_sharded_sparse_step(jm, jopt, LR, jmesh, feats)
    ps = create_sharded_sparse_state(pm, popt, pmesh, feats)
    ps = train_state_from_numpy(ps, jax_state_tree(js))
    pstep = make_sharded_sparse_train_step(pm, popt, LR, pmesh, feats)
    return pm, js, jstep, ps, pstep, jmesh


@pytest.mark.parametrize("case", [
    "2x4_all", "1x8_all", "2x4_mixed", "2x4_duplicates", "4x2_no_history"])
def test_row_sharded_sparse_steps_match_jax(rng, case):
    """(2, 4) and (1, 8) meshes; one table sharded and the rest replicated;
    ids several data shards touch; the (b, L) history flattened to b*L rows
    in the gather and the update."""
    shape = {"2x4": (2, 4), "1x8": (1, 8), "4x2": (4, 2)}[case[:3]]
    feats = ["customer_id"] if case.endswith("mixed") else ALL
    history = not case.endswith("no_history")
    if not history:
        feats = [f for f in feats if f != "purchase_history"]
    dup = case.endswith("duplicates")
    pm, js, jstep, ps, pstep, jmesh = _sharded_sparse_pair(rng, shape, feats,
                                                           history)
    steps = 1 if dup else 3
    for _ in range(steps):
        batch = _batch(rng, B=B, dup=dup, history=history)
        js, jm_ = jstep(js, jax_shard_batch(batch, jmesh))
        ps, pm_ = pstep(ps, _tb(batch))
        np.testing.assert_allclose(float(pm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    rtol, atol = ((DP_SPARSE_RTOL, DP_SPARSE_ATOL) if steps == 1
                  else (RTOL3, ATOL3))
    _assert_trees_close(train_state_to_numpy(ps), jax_state_tree(js),
                        rtol, atol)
    for f in ALL:
        name = [n for n in ps.params if n.endswith(f"embeddings.{f}")]
        if not name:
            continue
        t = ps.params[name[0]]
        assert isinstance(t, ShardedTable) == (f in feats)


def test_an_unknown_feature_is_rejected():
    _, pm = _models("mean")
    _, popt = _opts("adagrad")
    with pytest.raises(ValueError, match="embedding-table"):
        make_sharded_sparse_train_step(pm, popt, LR,
                                       make_mesh(2, 4, devices=["cpu"] * 8),
                                       ["nope"])


def test_sharded_sparse_specs():
    _, pm = _models("mean")
    _, popt = _opts("adagrad")
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    state = create_sharded_sparse_state(pm, popt, mesh, ["customer_id"])
    specs = sharded_sparse_specs(state, ["customer_id"])
    rows = {n for n, s in specs.params.items() if s == ROWS}
    assert rows == {"query_tower.embeddings.customer_id"}
    assert {n for n, s in specs.sparse_state.accumulators.items()
            if s == ROWS} == rows


# --- -1 ids ----------------------------------------------------------------------
def _update_without_mask(table, acc, ids, g_rows, lr, eps):
    """The update before the -1 mask, kept to hold the single-device bits."""
    sorted_ids, order = torch.sort(ids.long(), stable=True)
    g_sum = _segment_totals(sorted_ids, g_rows[order])
    new_acc_rows = acc[sorted_ids] + g_sum * g_sum
    update = lr * g_sum * torch.rsqrt(new_acc_rows + eps)
    new_rows = table[sorted_ids] - update
    acc.index_copy_(0, sorted_ids, new_acc_rows)
    table.index_copy_(0, sorted_ids, new_rows)


def test_minus_one_ids_change_no_row(rng):
    """Ids of -1 (another shard's rows) change nothing, where torch would
    read index -1 as the last row: the last row is touched for real in the
    same call and must take exactly its own update; valid ids alone give the
    same bits; the JAX update agrees."""
    V, E = 10, 4
    table = torch.from_numpy(rng.normal(size=(V, E)).astype(np.float32))
    acc = torch.full((V, E), 0.1)
    valid = torch.tensor([9, 3, 9, 0])  # the last row, twice, and row 0
    ids = torch.tensor([9, -1, 3, -1, 9, 0, -1])
    g = torch.from_numpy(rng.normal(size=(7, E)).astype(np.float32))
    g_valid = g[ids >= 0]
    t1, a1 = table.clone(), acc.clone()
    _sparse_adagrad_update(t1, a1, ids, g, LR, 1e-7)
    t2, a2 = table.clone(), acc.clone()
    _sparse_adagrad_update(t2, a2, valid, g_valid, LR, 1e-7)
    assert torch.equal(t1, t2) and torch.equal(a1, a2)
    untouched = [1, 2, 4, 5, 6, 7, 8]
    assert torch.equal(t1[untouched], table[untouched])
    jt, ja = jax_sparse_update(jnp.asarray(table.numpy()),
                               jnp.asarray(acc.numpy()),
                               jnp.asarray(ids.numpy(), jnp.int32),
                               jnp.asarray(g.numpy()), LR, 1e-7)
    np.testing.assert_allclose(t1.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(a1.numpy(), np.asarray(ja), rtol=1e-6)
    # only -1 ids: nothing changes, not even row 0 or the last
    t3, a3 = table.clone(), acc.clone()
    _sparse_adagrad_update(t3, a3, torch.full((5,), -1), g[:5], LR, 1e-7)
    assert torch.equal(t3, table) and torch.equal(a3, acc)


@pytest.mark.parametrize("dup", [False, True])
def test_the_mask_keeps_the_single_device_bits(rng, dup):
    V, E, M = 30, 8, 64
    table = torch.from_numpy(rng.normal(size=(V, E)).astype(np.float32))
    acc = torch.from_numpy(rng.uniform(0.1, 1, (V, E)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 4 if dup else V, M))
    g = torch.from_numpy(rng.normal(size=(M, E)).astype(np.float32))
    t1, a1 = table.clone(), acc.clone()
    _sparse_adagrad_update(t1, a1, ids, g, LR, 1e-7)
    t2, a2 = table.clone(), acc.clone()
    _update_without_mask(t2, a2, ids, g, LR, 1e-7)
    assert torch.equal(t1, t2) and torch.equal(a1, a2)


def test_a_shard_that_owns_no_touched_id_is_bit_unchanged(rng):
    """-1 ids in the step: at (1, 8) the customer table's 61 rows are 8
    shards of 8; a batch of customers 1-15 touches shards 0-1 only, and
    shards 2-7 (shard 7's last row, a real id, among them) stay bit for bit,
    while the step still matches JAX."""
    pm, js, jstep, ps, pstep, jmesh = _sharded_sparse_pair(rng, (1, 8), ALL)
    name = "query_tower.embeddings.customer_id"
    before = [(t.clone(), a.clone()) for t, a in zip(
        ps.params[name].shards, ps.sparse_state.accumulators[name].shards)]
    batch = _batch(rng, B=B)
    batch["customer_id"] = rng.integers(1, 16, B).astype(np.int32)
    js, jm_ = jstep(js, jax_shard_batch(batch, jmesh))
    ps, pm_ = pstep(ps, _tb(batch))
    after = list(zip(ps.params[name].shards,
                     ps.sparse_state.accumulators[name].shards))
    for s in range(2, 8):
        assert torch.equal(after[s][0], before[s][0]), s
        assert torch.equal(after[s][1], before[s][1]), s
    assert not torch.equal(after[1][1], before[1][1])
    _assert_trees_close(train_state_to_numpy(ps), jax_state_tree(js),
                        DP_SPARSE_RTOL, DP_SPARSE_ATOL)


# --- pad rows ----------------------------------------------------------------------
@pytest.mark.parametrize("sparse", [False, True])
def test_pad_rows_start_as_in_jax_and_never_change(rng, sparse):
    """The dense path pads the tables with zeros before ``optimizer.init``,
    so Adagrad's pad accumulators are 0.1; the sparse path pads tables and
    accumulators with zeros. Both as JAX makes them, bit for bit, and
    unchanged after three steps."""
    feats = ALL
    if sparse:
        pm, js, jstep, ps, pstep, jmesh = _sharded_sparse_pair(rng, (2, 4),
                                                               feats)
        accs = lambda tree: {f: a for tower in tree["accumulators"].values()
                             for f, a in tower.items()}  # noqa: E731
    else:
        pm, js, jstep, ps, pstep, jmesh = _sharded_dense_pair(rng, (2, 4),
                                                              feats)
        accs = lambda tree: _tables(  # noqa: E731
            tree["opt_state"]["sum_of_squares"])
    _, fresh_model = _models("mean")
    create = create_sharded_sparse_state if sparse else (
        create_sharded_train_state)
    fresh_port = create(fresh_model, _opts("adagrad")[1],
                        make_mesh(2, 4, devices=["cpu"] * 8), feats)
    want_acc = 0.0 if sparse else 0.1
    for tree in (jax_state_tree(js), train_state_to_numpy(fresh_port)):
        for f, rows in ROW_COUNTS.items():
            assert not _tables(tree["params"])[f][rows:].any()
            pad = accs(tree)[f][rows:]
            assert pad.shape[0] == (-rows) % 4
            np.testing.assert_array_equal(pad, np.float32(want_acc))
    for _ in range(3):
        batch = _batch(rng, B=B)
        js, _ = jstep(js, jax_shard_batch(batch, jmesh))
        ps, _ = pstep(ps, _tb(batch))
    for tree in (jax_state_tree(js), train_state_to_numpy(ps)):
        for f, rows in ROW_COUNTS.items():
            assert not _tables(tree["params"])[f][rows:].any()
            np.testing.assert_array_equal(accs(tree)[f][rows:],
                                          np.float32(want_acc))


# --- the bridge and the checkpoint ------------------------------------------------
@pytest.mark.parametrize("kind", ["sharded_adagrad", "sharded_adam",
                                  "sharded_sparse"])
def test_mesh_states_cross_the_bridge_exactly(rng, kind):
    """A JAX mesh state's tree into the port and back, bit for bit, and the
    JAX step runs from the port's tree as from its own."""
    if kind == "sharded_sparse":
        _, js, jstep, ps, _, jmesh = _sharded_sparse_pair(rng, (2, 4), ALL)
    else:
        _, js, jstep, ps, _, jmesh = _sharded_dense_pair(
            rng, (2, 4), ALL, kind.split("_")[1])
    batch = _batch(rng, B=B)
    js, _ = jstep(js, jax_shard_batch(batch, jmesh))  # moments not initial
    tree = jax_state_tree(js)
    back = train_state_to_numpy(train_state_from_numpy(ps, tree))
    _assert_trees_equal(back, tree)
    _, m_own = jstep(js, jax_shard_batch(batch, jmesh))
    _, m_port = jstep(jax_state(back), jax_shard_batch(batch, jmesh))
    assert float(m_own["loss"]) == float(m_port["loss"])


def test_checkpoint_restores_into_a_mesh_of_another_shape(rng, tmp_path):
    """Save a row-sharded sparse state at (2, 4) and restore it at (1, 8):
    the customer table's 61 rows pad to 64 on both, so the arrays match;
    the restored state equals the saved one and trains on as it does."""
    feats = ["customer_id"]
    _, popt = _opts("adagrad")
    _, pm_a = _models("mean")
    mesh_a = make_mesh(2, 4, devices=["cpu"] * 8)
    state = create_sharded_sparse_state(pm_a, popt, mesh_a, feats)
    step_a = make_sharded_sparse_train_step(pm_a, popt, LR, mesh_a, feats)
    state, _ = step_a(state, _tb(_batch(rng, B=B)))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), device="cpu")
    mgr.save(state.step, state)
    mgr.close()
    saved = train_state_to_numpy(state)
    _, pm_b = _models("mean")
    mesh_b = make_mesh(1, 8, devices=["cpu"] * 8)
    fresh = create_sharded_sparse_state(pm_b, popt, mesh_b, feats, seed=3)
    restored = CheckpointManager(str(tmp_path / "ckpt"),
                                 device="cpu").restore(fresh)
    assert restored.step == 1
    assert len(restored.params["query_tower.embeddings.customer_id"].shards
               ) == 8
    _assert_trees_equal(train_state_to_numpy(restored), saved)
    step_b = make_sharded_sparse_train_step(pm_b, popt, LR, mesh_b, feats)
    batch = _tb(_batch(rng, B=B))
    state, m_a = step_a(state, batch)
    restored, m_b = step_b(restored, batch)
    np.testing.assert_allclose(float(m_b["loss"]), float(m_a["loss"]),
                               rtol=1e-6)
    _assert_trees_close(train_state_to_numpy(restored),
                        train_state_to_numpy(state), 1e-6, 1e-7)


def test_export_of_a_sharded_state_is_unpadded(rng, tmp_path):
    _, pm = _models("mean")
    _, popt = _opts("adagrad")
    state = create_sharded_sparse_state(
        pm, popt, make_mesh(2, 4, devices=["cpu"] * 8), ALL)
    export_model(pm, str(tmp_path / "model"), params=state.params)
    tree = load_pytree_npz(str(tmp_path / "model" / "two_tower" /
                               "params.npz"))
    for f, rows in ROW_COUNTS.items():
        assert _tables(tree)[f].shape[0] == rows
    np.testing.assert_array_equal(
        tree["query_tower"]["embeddings"]["customer_id"],
        train_state_to_numpy(state)["params"]["query_tower"]["embeddings"][
            "customer_id"][:61])


# --- the chunked step over a mesh ---------------------------------------------------
@pytest.mark.parametrize("path", ["dp_dense", "dp_sparse", "sharded_dense",
                                  "sharded_sparse"])
def test_the_chunked_step_over_a_mesh_equals_k_steps(rng, path):
    _, popt = _opts("adagrad")
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    runs = []
    batches = [_batch(rng, B=B) for _ in range(3)]
    for chunked in (False, True):
        _, pm = _models("mean")
        if path == "dp_dense":
            state = replicate_state(create_sharded_train_state(
                pm, popt, mesh, []), mesh)
            step = make_dp_train_step(pm, popt, mesh)
        elif path == "dp_sparse":
            state = replicate_sparse_state(create_sharded_sparse_state(
                pm, popt, mesh, []), mesh)
            step = make_dp_sparse_train_step(pm, popt, LR, mesh)
        elif path == "sharded_dense":
            state = create_sharded_train_state(pm, popt, mesh, ALL)
            step = make_sharded_train_step(pm, popt, mesh)
        else:
            state = create_sharded_sparse_state(pm, popt, mesh, ALL)
            step = make_sharded_sparse_train_step(pm, popt, LR, mesh, ALL)
        if chunked:
            stacked = _tb({k: np.stack([b[k] for b in batches])
                           for k in batches[0]})
            state, m = make_chunked_train_step(step)(state, stacked)
            losses = m["losses"]
        else:
            losses = []
            for b in batches:
                state, m = step(state, _tb(b))
                losses.append(m["loss"])
            losses = torch.stack(losses)
        runs.append((train_state_to_numpy(state), losses))
    assert torch.equal(runs[0][1], runs[1][1])
    _assert_trees_equal(runs[1][0], runs[0][0])
