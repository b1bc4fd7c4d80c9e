"""One process training over a mesh of several distinct devices.

Each data shard's rows, replica, towers and gradients run on its cell's
device (``Mesh.data_device``), each table shard and its optimizer state
live on its column's (``Mesh.model_device``), and the replicated state and
the gradients' psum on the first device (``parallel/mesh.py``). These
tests run without a card, so they hold:

- the per-cell device map over grids of ``torch.device("cuda", i)``, which
  touches no CUDA, at (4, 1), (2, 2) and (1, 4);
- the placement code itself against a second device that exists without a
  card: ``meta``, whose tensors carry a shape and a device and no data, so
  a copy to it and every step of placement run while nothing is computed;
- the several-device code over the repeated ``cpu``, where every copy is a
  no-op: each of ``tests/test_torch_runners.py``'s ``MESH_LAYOUTS`` steps
  (sparse and dense Adagrad) gives the bits the port gave before devices
  were told apart (``REPEATED_CPU_DIGESTS``, recorded from that code on
  the CPU with 1 and with the default number of threads), and
  stays within rtol 1e-4 / atol 1e-5 of the JAX package's step over the
  conftest's 8 host devices after 3 steps (weights carried by
  ``models/bridge.py``);
- a row-sharded checkpoint restored into each shard where it lives, and -1
  ids through the cross-device lookup and update.

``chip_smoke.py`` phase 17 runs the same paths on a card and the host CPU
as two distinct devices, and over several cards where there are some.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.models import create_train_state as jax_create_state
from hm_retrieval_tpu.models.sparse_optimizer import (
    create_sparse_train_state as jax_create_sparse,
)
from hm_retrieval_tpu.parallel import (
    make_dp_sparse_train_step as jax_dp_sparse_step,
    make_dp_train_step as jax_dp_step,
    replicate_sparse_state as jax_replicate_sparse,
    replicate_state as jax_replicate,
    shard_batch as jax_shard_batch,
)
from hm_retrieval_tpu_torch.data import (
    device_feed,
    device_feed_chunked,
    make_chunked_train_step,
)
from hm_retrieval_tpu_torch.models import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from hm_retrieval_tpu_torch.models.sparse_optimizer import (
    create_sparse_train_state,
)
from hm_retrieval_tpu_torch.models.two_tower import create_train_state
from hm_retrieval_tpu_torch.parallel import (
    ShardedTable,
    create_sharded_sparse_state,
    create_sharded_train_state,
    make_dp_sparse_train_step,
    make_dp_train_step,
    make_mesh,
    make_sharded_sparse_train_step,
    make_sharded_train_step,
    replicate_sparse_state,
    replicate_state,
    shard_batch,
    shard_table,
)
from hm_retrieval_tpu_torch.parallel.collectives import (
    _Broadcast,
    all_gather,
    broadcast,
    psum,
)
from hm_retrieval_tpu_torch.parallel.data_parallel import replica
from hm_retrieval_tpu_torch.parallel.mesh import (
    Mesh,
    replicate_pytree,
    split_batch,
    training_device,
)
from hm_retrieval_tpu_torch.parallel.sharded_embedding import (
    all_to_all_rows,
    psum_rows,
)
from hm_retrieval_tpu_torch.parallel.sparse_data_parallel import _update_table
from hm_retrieval_tpu_torch.runners import CheckpointManager
from tests.test_torch_parallel import ATOL3, RTOL3, _opts, meshes
from tests.test_torch_sharded_training import (
    _sharded_dense_pair,
    _sharded_sparse_pair,
)
from tests.test_torch_training import (
    LR,
    _assert_trees_close,
    _assert_trees_equal,
    _batch,
    _jax_params,
    _models,
    jax_state_tree,
)

B = 32
META = torch.device("meta")
# tests/test_torch_runners.py's MESH_LAYOUTS: (data, model), row-sharded
LAYOUTS = {
    "dp_8x1": ((8, 1), []),
    "dp_2x4_distributed_index": ((2, 4), []),
    "row_sharded_2x4": ((2, 4), ["customer_id", "article_id"]),
}
# sha256 (first 32 hex digits) of 3 steps' losses and the final state of
# each layout over the repeated cpu, fed by device_feed(mesh=...) from
# _batch(default_rng(11), B=32), from the port before distinct devices
REPEATED_CPU_DIGESTS = {
    ("dp_8x1", "sparse"): "99fc6a27af937d7473ac0e25d4b97007",
    ("dp_8x1", "dense"): "45ba01da40ac86a6e759031a89d3c516",
    ("dp_2x4_distributed_index", "sparse"):
        "767d70809260e6f82ba8aa276bb6ba0f",
    ("dp_2x4_distributed_index", "dense"):
        "e5d171337c9c4241c78f8414c129bcfd",
    ("row_sharded_2x4", "sparse"): "cd22475f3212fb0821d36c545b599f7a",
    ("row_sharded_2x4", "dense"): "bb8f8022ddca8d7eb12b0479085864d7",
}


def _grid(shape, devices):
    grid = np.empty(shape, dtype=object)
    for i, dev in enumerate(devices):
        grid[i // shape[1], i % shape[1]] = torch.device(dev)
    return Mesh(grid)


def _cards(shape):
    return _grid(shape, [torch.device("cuda", i)
                         for i in range(shape[0] * shape[1])])


# --- the per-cell device map -----------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_the_cell_device_map_over_four_cards(shape, monkeypatch):
    """Data shard d (its rows, replica, towers and gradient) on the first
    card of row d; table shard s and its accumulator on the first card of
    column s; the replicated state and the psum on cuda:0. No CUDA is
    touched; with CUDA reported present the mesh trains, without it it
    raises naming CUDA."""
    D, S = shape
    mesh = _cards(shape)
    assert [mesh.data_device(d) for d in range(D)] == [
        torch.device("cuda", d * S) for d in range(D)]
    assert [mesh.model_device(s) for s in range(S)] == [
        torch.device("cuda", s) for s in range(S)]
    assert mesh.first_device == torch.device("cuda", 0)
    # a column's distinct cards, as the sharded index copies its shard
    assert mesh.column(0) == [torch.device("cuda", d * S) for d in range(D)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training_device(mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert training_device(mesh) == torch.device("cuda", 0)


def test_the_card_and_the_host_as_two_cells():
    """``["cuda:0", "cpu"]`` as chip_smoke.py's phase 17 lays it out: over
    (2, 1) the second data shard runs on the host; over (1, 2) the second
    table shard lives there; the replicated state stays on the card."""
    dp, rows = _grid((2, 1), ["cuda:0", "cpu"]), _grid((1, 2),
                                                       ["cuda:0", "cpu"])
    assert dp.data_device(1) == torch.device("cpu")
    assert dp.model_device(0) == torch.device("cuda", 0)
    assert rows.data_device(0) == torch.device("cuda", 0)
    assert rows.model_device(1) == torch.device("cpu")
    assert dp.first_device == rows.first_device == torch.device("cuda", 0)


# --- placement against a second device: meta --------------------------------------
def test_rows_and_replicas_go_to_their_data_shards_device():
    mesh = _grid((2, 1), ["cpu", "meta"])
    batch = {"a": torch.arange(8), "b": torch.ones(8, 3)}
    for shards in (split_batch(batch, mesh), shard_batch(batch, mesh)):
        assert [s["a"].device for s in shards] == [torch.device("cpu"), META]
        assert shards[1]["b"].shape == (4, 3)
    params = {"w": torch.ones(3, 2), "t": ShardedTable([torch.zeros(4, 2)])}
    rep = replica(params, mesh.data_device(1))
    assert rep["w"].device == META and rep["w"].requires_grad
    # a table shard stays where it lives
    assert rep["t"].shards[0].device == torch.device("cpu")
    assert replicate_pytree({"x": torch.ones(2)}, mesh)["x"].device == (
        torch.device("cpu"))


def test_table_shards_and_their_state_go_to_their_columns_device():
    _, pm = _models("mean")
    _, popt = _opts("adagrad")
    mesh = _grid((1, 2), ["cpu", "meta"])
    table = shard_table(np.ones((5, 2), np.float32), mesh)
    assert [t.device for t in table.shards] == [torch.device("cpu"), META]
    state = create_sharded_sparse_state(pm, popt, mesh, ["customer_id"])
    name = "query_tower.embeddings.customer_id"
    for value in (state.params[name],
                  state.sparse_state.accumulators[name]):
        assert [t.device for t in value.shards] == [torch.device("cpu"),
                                                    META]
    dense = create_sharded_train_state(pm, popt, mesh, ["customer_id"])
    acc = dense.opt_state.sum_of_squares[name]
    assert [t.device for t in acc.shards] == [torch.device("cpu"), META]


def test_psum_and_all_gather_land_where_they_say():
    """psum sums on the first value's device (the first data shard's: the
    mesh's first device), a dict's each tensor on its own; all_gather puts
    the gathered tensor on the consumer's device."""
    on_meta = psum([torch.ones(3, device=META), torch.ones(3)])
    assert on_meta.device == META
    got = psum([{"a": torch.ones(2, device=META), "b": torch.ones(2)},
                {"a": torch.ones(2), "b": torch.full((2,), 2.0)}])
    assert got["a"].device == META and got["b"].tolist() == [3.0, 3.0]
    cat = all_gather([torch.ones(2, 3), torch.zeros(2, 3)], device=META)
    assert cat.device == META and cat.shape == (4, 3)
    assert all_gather([torch.ones(2), torch.zeros(2)]).tolist() == [1, 1, 0, 0]


def test_broadcast_sums_the_copies_gradients_as_one_device_does(rng):
    """A value several devices consume (the gathered candidates) is copied
    by one node whose backward adds the copies' gradients in a fixed order,
    not in the order the devices' backward threads finish: the order in
    which the engine adds the gradients of four consumers of one tensor on
    one device, bit for bit. Alone on its own device it is the value
    itself; ``cpu`` and ``cpu:0`` name one memory as two devices, so two
    copies run here too."""
    x = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    assert broadcast(x, [torch.device("cpu")])[0] is x
    leaf = x.clone().requires_grad_()
    qs = [torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
          for _ in range(4)]
    losses = [(q @ leaf.T).square().sum() * (1 + 0.37 * i)
              for i, q in enumerate(qs)]
    (one_device,) = torch.autograd.grad(sum(losses[1:], losses[0]), leaf,
                                        retain_graph=True)
    grads = [torch.autograd.grad(l, leaf)[0] for l in losses]
    ctx = type("Ctx", (), {"device": torch.device("cpu")})()
    (summed, *_) = _Broadcast.backward(ctx, *grads)
    assert torch.equal(summed, one_device)
    a, b = broadcast(leaf, [torch.device("cpu"), torch.device("cpu", 0)])
    assert a is not leaf and torch.equal(a, x) and torch.equal(b, x)
    (got,) = torch.autograd.grad([a, b], leaf, grads[:2])
    assert torch.equal(got, grads[0] + grads[1])
    on_meta = broadcast(x, [META])
    assert on_meta[0].device == META and on_meta[0].shape == x.shape


def test_the_feed_puts_each_shards_rows_on_its_device(rng):
    """``device_feed(mesh=...)`` yields one dict a data shard, in order,
    each on its shard's device (the CPU here; pinned, non-blocking copies
    to a card); the chunked feed splits each shard's rows along axis 1."""
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    batches = [_batch(rng, B=B) for _ in range(4)]
    fed = list(device_feed(iter(batches[:2]), mesh=mesh))
    assert len(fed) == 2 and len(fed[0]) == 4
    np.testing.assert_array_equal(fed[1][3]["customer_id"].numpy(),
                                  batches[1]["customer_id"][24:])
    chunks = list(device_feed_chunked(iter(batches), 2, mesh=mesh))
    assert [tuple(c[1]["purchase_history"].shape) for c in chunks] == [
        (2, 8, 5)] * 2
    np.testing.assert_array_equal(chunks[1][2]["article_id"][1].numpy(),
                                  batches[3]["article_id"][16:24])


# --- the repeated cpu: the bits before, and JAX's step ---------------------------
def _port_pair(layout, sparse):
    shape, feats = LAYOUTS[layout]
    _, pm = _models("mean")
    _, opt = _opts("adagrad")
    mesh = make_mesh(*shape, devices=["cpu"] * 8)
    if sparse and feats:
        return (create_sharded_sparse_state(pm, opt, mesh, feats),
                make_sharded_sparse_train_step(pm, opt, LR, mesh, feats),
                mesh)
    if sparse:
        return (replicate_sparse_state(create_sparse_train_state(pm, opt),
                                       mesh),
                make_dp_sparse_train_step(pm, opt, LR, mesh), mesh)
    if feats:
        return (create_sharded_train_state(pm, opt, mesh, feats),
                make_sharded_train_step(pm, opt, mesh), mesh)
    return (replicate_state(create_train_state(pm, opt), mesh),
            make_dp_train_step(pm, opt, mesh), mesh)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_repeated_cpu_keeps_the_bits(layout, kind):
    state, step, mesh = _port_pair(layout, kind == "sparse")
    rng = np.random.default_rng(11)
    h = hashlib.sha256()
    for b in device_feed(iter([_batch(rng, B=B) for _ in range(3)]),
                         mesh=mesh):
        state, m = step(state, b)
        h.update(m["loss"].numpy().tobytes())
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            train_state_to_numpy(state)):
        a = np.asarray(leaf)
        h.update(jax.tree_util.keystr(path).encode() + str(a.dtype).encode()
                 + a.tobytes())
    assert h.hexdigest()[:32] == REPEATED_CPU_DIGESTS[(layout, kind)]


def _jax_pair(rng, layout, sparse):
    """The JAX package's state and step over its 8 host devices and the
    port's over the repeated cpu, from the same weights (the bridge)."""
    shape, feats = LAYOUTS[layout]
    if feats:
        pair = (_sharded_sparse_pair(rng, shape, feats, history=True)
                if sparse else _sharded_dense_pair(rng, shape, feats))
        _, js, jstep, ps, pstep, jmesh = pair
        return js, jstep, ps, pstep, jmesh
    jm, pm = _models("mean")
    jopt, popt = _opts("adagrad")
    jmesh, pmesh = meshes(*shape)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(jm, rng))
    if sparse:
        js = jax_replicate_sparse(jax_create_sparse(jm, jopt)._replace(
            params=params), jmesh)
        jstep = jax_dp_sparse_step(jm, jopt, LR, jmesh)
        ps = replicate_sparse_state(create_sparse_train_state(pm, popt),
                                    pmesh)
        pstep = make_dp_sparse_train_step(pm, popt, LR, pmesh)
    else:
        js = jax_replicate(jax_create_state(jm, jopt)._replace(
            params=params, opt_state=jopt.init(params)), jmesh)
        jstep = jax_dp_step(jm, jopt, jmesh)
        ps = replicate_state(create_train_state(pm, popt), pmesh)
        pstep = make_dp_train_step(pm, popt, pmesh)
    ps = train_state_from_numpy(ps, jax_state_tree(js))
    return js, jstep, ps, pstep, jmesh


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_repeated_cpu_matches_jax_over_8_host_devices(rng, layout, kind):
    js, jstep, ps, pstep, jmesh = _jax_pair(rng, layout, kind == "sparse")
    pmesh = make_mesh(*LAYOUTS[layout][0], devices=["cpu"] * 8)
    for _ in range(3):
        batch = _batch(rng, B=B)
        js, jm_ = jstep(js, jax_shard_batch(batch, jmesh))
        (shards,) = device_feed(iter([batch]), mesh=pmesh)
        ps, pm_ = pstep(ps, shards)
        np.testing.assert_allclose(float(pm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    _assert_trees_close(train_state_to_numpy(ps), jax_state_tree(js),
                        RTOL3, ATOL3)


# --- checkpoints -----------------------------------------------------------------
def test_a_row_sharded_checkpoint_restores_each_shard_where_it_lives(
        rng, tmp_path):
    """Over (2, 4) of the repeated cpu the state round-trips bit for bit
    into the same shard tensors; over (1, 4) of cpu and meta in turn the
    device check takes a state whose odd shards live on meta and restores
    into each shard where it lives, and refuses a replicated tensor off the
    manager's device."""
    feats = ["customer_id", "article_id"]
    _, popt = _opts("adagrad")
    _, pm = _models("mean")
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    state = create_sharded_sparse_state(pm, popt, mesh, feats)
    step = make_sharded_sparse_train_step(pm, popt, LR, mesh, feats)
    state, _ = step(state, shard_batch(_batch(rng, B=B), mesh))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), device="cpu")
    mgr.save(state.step, state)
    mgr.close()
    _, pm2 = _models("mean")
    fresh = create_sharded_sparse_state(pm2, popt, mesh, feats, seed=5)
    name = "query_tower.embeddings.customer_id"
    before = list(fresh.params[name].shards)
    restored = CheckpointManager(str(tmp_path / "ckpt"),
                                 device="cpu").restore(fresh)
    assert all(a is b for a, b in zip(restored.params[name].shards, before))
    assert [t.device for t in restored.params[name].shards] == [
        mesh.model_device(s) for s in range(4)]
    _assert_trees_equal(train_state_to_numpy(restored),
                        train_state_to_numpy(state))

    # every other column on another device (4 shards: the same pad rows)
    _, pm3 = _models("mean")
    other = create_sharded_sparse_state(
        pm3, popt, _grid((1, 4), ["cpu", "meta"] * 2), feats)
    got = CheckpointManager(str(tmp_path / "ckpt"),
                            device="cpu").restore(other)
    assert got.step == 1
    assert [t.device for t in got.params[name].shards] == [
        torch.device("cpu"), META] * 2
    np.testing.assert_array_equal(
        got.params[name].shards[0].numpy(),
        train_state_to_numpy(state)["params"]["query_tower"]["embeddings"][
            "customer_id"][:got.params[name].rows_per_shard])
    off = dict(got.params)
    off["query_tower.dense.0.weight"] = off[
        "query_tower.dense.0.weight"].detach().to(META)
    with pytest.raises(ValueError, match="restores onto cpu"):
        CheckpointManager(str(tmp_path / "ckpt"), device="cpu").restore(
            got._replace(params=off))


# --- -1 ids ----------------------------------------------------------------------
@pytest.mark.parametrize("strategy", ["psum", "all_to_all"])
def test_minus_one_ids_change_no_row_through_the_lookup(rng, strategy):
    """A -1 id looks up a zero row through the shards (each shard's ids
    moved to its device) and its gradient changes no row of any shard in
    the update, where torch would read -1 as the last row."""
    mesh = make_mesh(1, 4, devices=["cpu"] * 4)
    table = shard_table(rng.normal(size=(10, 3)).astype(np.float32), mesh)
    acc = shard_table(np.full((10, 3), 0.1, np.float32), mesh)
    ids = torch.tensor([8, -1, 4, -1, 0])
    rows = (psum_rows(table, ids) if strategy == "psum"
            else all_to_all_rows(table, ids))
    full = torch.cat(table.shards)
    assert torch.equal(rows[ids >= 0], full[ids[ids >= 0]])
    assert not rows[ids < 0].any()
    before = [t.clone() for t in table.shards + acc.shards]
    g = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    _update_table(table, acc, ids, g, LR, 1e-7)
    after = torch.cat(table.shards)
    changed = sorted(set(torch.nonzero((after != torch.cat(before[:4]))
                                       .any(1)).reshape(-1).tolist()))
    assert changed == [0, 4, 8]
    # only -1 ids: nothing changes, not even the last row of a shard
    table_only = [t.clone() for t in table.shards]
    _update_table(table, acc, torch.full((4,), -1), g[:4], LR, 1e-7)
    assert all(torch.equal(a, b) for a, b in zip(table.shards, table_only))


def test_the_chunked_step_takes_the_mesh_feeds_shards(rng):
    """A chunk of the mesh feed (one (k, b, ...) dict a shard) runs as k
    steps of the same shards."""
    _, popt = _opts("adagrad")
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    batches = [_batch(rng, B=B) for _ in range(2)]
    runs = []
    for chunked in (False, True):
        _, pm = _models("mean")
        state = replicate_sparse_state(create_sparse_train_state(pm, popt),
                                       mesh)
        step = make_dp_sparse_train_step(pm, popt, LR, mesh)
        if chunked:
            (chunk,) = device_feed_chunked(iter(batches), 2, mesh=mesh)
            state, _ = make_chunked_train_step(step)(state, chunk)
        else:
            for b in device_feed(iter(batches), mesh=mesh):
                state, _ = step(state, b)
        runs.append(train_state_to_numpy(state))
    _assert_trees_equal(runs[1], runs[0])
