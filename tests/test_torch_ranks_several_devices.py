"""A rank of a process group over several distinct devices, on the CPU.

A rank's cells may be several distinct devices (several cards, or a card
and the host CPU), each shard on its cell's device as in one process
(``Mesh.data_device``, ``Mesh.model_device``, ``first_device``), and the
group's exchanges send each cell's value from its own device and deliver
each missing entry to the device that consumes it. Without a card these
tests hold:

- the rank's block of cards (``rank_devices``, ``initialize_multihost``,
  ``make_mesh()``'s default grid) with ``torch.cuda`` patched: 2 ranks on 4
  cards take two cards each, as ``jax.local_devices()`` gives them, over
  NCCL; 4 ranks one each; 3 ranks raise before the group forms;
- each exchanged entry's wire device and destination, named over grids of
  ``torch.device("cuda", i)`` (no CUDA touched), and the order in which
  the group adds the shards' gradients of the gathered candidates;
- placement against ``meta`` in a two-rank group faked in one process,
  rank 0's cells ``["cpu", "meta"]``;
- a real two-rank ``gloo`` group with two cells a rank (``["cpu",
  "cpu"]``) at (4, 1), (2, 2) and (1, 4): the data-parallel and
  row-sharded, dense and sparse steps bit for bit against the one-process
  mesh over ``["cpu"] * 4``, and within rtol 1e-4 / atol 1e-5 of the JAX
  package's steps over 4 host devices (the ranks-times-devices layout of
  the JAX package's multi-host tests, ``tests/test_multihost.py``).

This module imports nothing of JAX at its top: the spawned ranks import
only the port. ``chip_smoke.py`` phase 18 runs two ranks each over the
card and the host CPU.
"""

import pickle
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hm_retrieval_tpu_torch.parallel import collectives as co
from hm_retrieval_tpu_torch.parallel import mesh as mesh_mod
from hm_retrieval_tpu_torch.parallel.mesh import (
    TORCHRUN_ENV,
    Mesh,
    choose_backend,
    initialize_multihost,
    local_devices,
    make_mesh,
    rank_card,
    rank_devices,
    split_batch,
    training_device,
)

META = torch.device("meta")
CPU = torch.device("cpu")
SPAWN_TIMEOUT = 240  # seconds for the group to run every path
STEPS = 3
B = 32
SHAPES = [(4, 1), (2, 2), (1, 4)]
PATHS = ["dp_dense", "dp_sparse", "row_sharded_dense", "row_sharded_sparse"]
SHARDED = ["customer_id", "article_id"]
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
LR = 0.05  # tests/test_torch_training.py's


def _cuda(monkeypatch, cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)


def _grid(shape, devices, ranks, me):
    grid = np.empty(shape, dtype=object)
    for i, dev in enumerate(devices):
        grid[i // shape[1], i % shape[1]] = torch.device(dev)
    return Mesh(grid, np.asarray(ranks).reshape(shape), me)


def _two_ranks(shape, devices, me):
    """``shape`` over 2 ranks of 2 cells each, in rank order."""
    return _grid(shape, devices, [0, 0, 1, 1], me)


CARDS = [f"cuda:{i}" for i in range(4)]


# --- the rank's devices -----------------------------------------------------
@pytest.mark.parametrize("ranks, want", [
    (2, [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]),
    (4, [["cuda:0"], ["cuda:1"], ["cuda:2"], ["cuda:3"]]),
    (1, [["cuda:0", "cuda:1", "cuda:2", "cuda:3"]]),
    (8, [[f"cuda:{r % 4}"] for r in range(8)]),
])
def test_a_rank_takes_its_block_of_cards(monkeypatch, ranks, want):
    """Fewer ranks than cards: each rank its block, as
    ``jax.local_devices()`` gives each process its chips, over NCCL; at
    least as many ranks: one card each (sharing past 4, over gloo)."""
    _cuda(monkeypatch, 4)
    got = [[str(d) for d in rank_devices(r, ranks)] for r in range(ranks)]
    assert got == want
    assert choose_backend("cuda", ranks, 4) == ("nccl" if ranks <= 4
                                               else "gloo")
    assert rank_devices(1, ranks, "cpu") == [CPU]
    assert rank_devices(1, ranks, "cuda:3") == [torch.device("cuda", 3)]


def _recorded(monkeypatch):
    calls = {"init": [], "set_device": []}
    monkeypatch.setattr(mesh_mod, "_rank_devices", [])
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls["init"].append(backend))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls["set_device"].append(d))
    return calls


def _torchrun(monkeypatch, rank, world):
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": "29500",
           "RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("ranks, cards", [(3, 4), (3, 8), (6, 8)])
def test_an_uneven_split_raises_before_the_group_forms(monkeypatch, ranks,
                                                       cards):
    _cuda(monkeypatch, cards)
    with pytest.raises(ValueError, match="divide"):
        rank_devices(0, ranks)
    calls = _recorded(monkeypatch)
    _torchrun(monkeypatch, 1, ranks)
    with pytest.raises(ValueError, match="divide"):
        initialize_multihost()
    assert calls == {"init": [], "set_device": []}
    assert local_devices() == []


def test_initialize_multihost_sets_the_first_card_and_make_mesh_takes_the_block(
        monkeypatch):
    """Rank 1 of 2 on a four-card host: its cards are cuda:2 and cuda:3,
    cuda:2 becomes its ``torch.cuda`` device and its NCCL card, and the
    group's ``make_mesh()`` lays every rank's block out in rank order; an
    explicit ``devices=`` still wins."""
    _cuda(monkeypatch, 4)
    calls = _recorded(monkeypatch)
    _torchrun(monkeypatch, 1, 2)
    assert initialize_multihost() == torch.device("cuda", 2)
    assert calls == {"init": ["nccl"], "set_device": [torch.device("cuda", 2)]}
    assert local_devices() == [torch.device("cuda", 2),
                               torch.device("cuda", 3)]
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert rank_card() == torch.device("cuda", 2)

    sent = []

    def gathered(local):
        sent.append(local)
        return [["cuda:0", "cuda:1"], local]

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 1)
    monkeypatch.setattr(mesh_mod, "_gather_devices", gathered)
    dev = torch.device
    mesh = make_mesh(2, 2)
    assert sent[-1] == ["cuda:2", "cuda:3"]
    assert mesh.devices.tolist() == [[dev("cuda", 0), dev("cuda", 1)],
                                     [dev("cuda", 2), dev("cuda", 3)]]
    assert mesh.ranks.tolist() == [[0, 0], [1, 1]]
    assert mesh.first_device == mesh.data_device(1) == dev("cuda", 2)
    assert [mesh.model_device(s) for s in range(2)] == [dev("cuda", 2),
                                                        dev("cuda", 3)]
    assert training_device(mesh) == dev("cuda", 2)
    dp = make_mesh(4, 1)
    assert dp.local_rows() == [2, 3]
    assert [dp.data_device(d) for d in (2, 3)] == [dev("cuda", 2),
                                                   dev("cuda", 3)]
    row = make_mesh(1, 4)
    assert row.local_cols() == [2, 3] and row.data_device(0) == dev("cuda", 2)
    host = make_mesh(1, 4, devices=["cuda:2", "cpu"])
    assert sent[-1] == ["cuda:2", "cpu"]
    assert host.model_device(3) == CPU


# --- each exchanged entry's wire device and destination ---------------------
class _On:
    """A stand-in for a tensor on a device: the exchange's plan needs only
    its device."""

    def __init__(self, device, tag):
        self.device = torch.device(device)
        self.tag = tag

    def detach(self):
        return self


def _plan(monkeypatch, me):
    """``exchange_bytes`` recording each sent entry's device and the
    destination asked for it, and answering with stand-ins there."""
    seen = []

    def exchange(tensors, devices=None):
        dests = devices or [t.device for t in tensors]
        seen.append(([t.device for t in tensors], list(dests)))
        other = [_On(d, ("from", 1 - me, p)) for p, d in enumerate(dests)]
        return [list(tensors), other] if me == 0 else [other, list(tensors)]

    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: me)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(co, "exchange_bytes", exchange)
    return seen


@pytest.mark.parametrize("shape", SHAPES)
def test_each_entry_is_sent_from_its_cell_and_lands_where_it_is_consumed(
        monkeypatch, shape):
    """Rank 1 of 2 ranks x 2 cards (cuda:2, cuda:3 here): a data-axis
    value goes out from each local data shard's card; missing rows land on
    the first local value's card (a psum's sum device: this rank's first
    device) or on the device the gather names; a model-axis value (the
    lookup's partial rows or buckets) lands on the requesting data shard's
    card; the wire is the rank's NCCL card, cuda:2, whatever card a leaf
    is on."""
    mesh = _two_ranks(shape, CARDS, 1)
    seen = _plan(monkeypatch, 1)
    D, S = shape
    rows = mesh.local_rows()
    values = [_On(mesh.data_device(d), d) if d in rows else None
              for d in range(D)]
    if len(rows) < D:
        full = co._data_fill(values, mesh)
        assert seen[-1][0] == [mesh.data_device(d) for d in rows]
        assert all(full[d].device == mesh.first_device
                   for d in range(D) if d not in rows)
        full = co._data_fill(values, mesh, torch.device("cuda", 3))
        assert all(full[d].device == torch.device("cuda", 3)
                   for d in range(D) if d not in rows)
    cols = mesh.local_cols()
    if len(cols) < S:
        ids_dev = mesh.data_device(rows[0])
        parts = [_On(mesh.model_device(s), s) if s in cols else None
                 for s in range(S)]
        got = co.fill(parts, mesh.cols_of,
                      lambda s: int(mesh.ranks[rows[0], s]), ids_dev)
        assert seen[-1] == ([mesh.model_device(s) for s in cols],
                            [ids_dev] * len(cols))
        assert all(got[s].device == ids_dev for s in range(S)
                   if s not in cols)
    # a leaf on the rank's second card travels through its first
    monkeypatch.setattr(mesh_mod, "_rank_devices",
                        [torch.device("cuda", 2), torch.device("cuda", 3)])
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "nccl")
    assert co._wire_device() == torch.device("cuda", 2)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    assert co._wire_device() == CPU


@pytest.mark.parametrize("devices, shape, want", [
    (CARDS, (4, 1), [[3], [2], [1], [0]]),
    (CARDS, (2, 2), [[1], [0]]),
    (CARDS, (1, 4), [[0]]),
    (["cuda:0", "cpu"] * 2, (4, 1), [[3, 1], [2, 0]]),
    (["cuda:0", "cpu"] * 2, (2, 2), [[1, 0]]),
    (["cpu"] * 4, (4, 1), [[3, 2, 1, 0]]),
])
def test_the_order_of_the_candidates_gradients(devices, shape, want):
    """The data shards' gradients of the gathered candidates are added as
    one process over the same grid adds them: the devices the rows start
    on last first (``broadcast``), on each device its shards last first
    (the autograd engine)."""
    assert co.one_process_order(_two_ranks(shape, devices, 0)) == want


# --- placement against meta in a faked two-rank group -----------------------
def _fake_group(monkeypatch, me=0):
    """Two ranks in one process: an exchange that answers each of the other
    rank's entries with zeros of its shape on the destination asked for,
    and a broadcast that answers zeros where this rank lacks the value."""

    def exchange(tensors, devices=None):
        tensors = [t.detach() for t in tensors]
        dests = devices or [t.device for t in tensors]
        other = [torch.zeros(t.shape, dtype=t.dtype, device=d)
                 for t, d in zip(tensors, dests)]
        return [tensors, other] if me == 0 else [other, tensors]

    def broadcast_from(t, shape, dtype, device, src):
        return (t.detach().to(device) if t is not None
                else torch.zeros(tuple(shape), dtype=dtype, device=device))

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: me)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(co, "exchange_bytes", exchange)
    monkeypatch.setattr(co, "broadcast_from", broadcast_from)


def _pair():
    from tests.test_torch_parallel import _opts
    from tests.test_torch_training import _models

    _, pm = _models("mean")
    _, popt = _opts("adagrad")
    return pm, popt


HOST_META = ["cpu", "meta"] * 2


def test_rows_and_replicas_land_on_their_data_shards_cell(monkeypatch):
    from hm_retrieval_tpu_torch.parallel.data_parallel import replica
    from hm_retrieval_tpu_torch.parallel.mesh import shard_batch

    _fake_group(monkeypatch)
    mesh = _two_ranks((4, 1), HOST_META, 0)
    assert mesh.local_rows() == [0, 1] and mesh.first_device == CPU
    batch = {"a": torch.arange(8), "b": torch.ones(8, 3)}
    for shards in (split_batch(batch, mesh), shard_batch(batch, mesh)):
        assert [None if s is None else s["a"].device for s in shards] == [CPU, META, None,
                                                         None]
        assert shards[1]["b"].shape == (4, 3)
    rep = replica({"w": torch.ones(3, 2)}, mesh.data_device(1))
    assert rep["w"].device == META and rep["w"].requires_grad
    assert training_device(mesh) == CPU


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_table_shards_and_their_state_live_on_their_cells(monkeypatch,
                                                          shape):
    """(2, 2): rank 0 holds data row 0 and both columns, cpu and meta;
    (1, 4): columns 0 and 1 of the one row, the others ``None``."""
    from hm_retrieval_tpu_torch.parallel import (
        create_sharded_sparse_state,
        create_sharded_train_state,
    )

    _fake_group(monkeypatch)
    pm, popt = _pair()
    mesh = _two_ranks(shape, HOST_META, 0)
    S = shape[1]
    want = [CPU, META] if S == 2 else [CPU, META, None, None]
    name = "query_tower.embeddings.customer_id"
    sparse = create_sharded_sparse_state(pm, popt, mesh, SHARDED)
    for value in (sparse.params[name],
                  sparse.sparse_state.accumulators[name]):
        assert [None if t is None else t.device for t in value.shards] == want
    pm, popt = _pair()
    dense = create_sharded_train_state(pm, popt, mesh, SHARDED)
    for value in (dense.params[name], dense.opt_state.sum_of_squares[name]):
        assert [None if t is None else t.device for t in value.shards] == want
    assert dense.params["query_tower.dense.0.weight"].device == CPU


def test_the_gathers_gradient_slices_go_back_to_each_shards_cell(
        monkeypatch):
    """``_GroupAllGather``: the gathered tensor on the device asked for
    (meta here), and its backward hands each local shard its slice on the
    shard's own cell, cpu and meta: the autograd engine refuses a gradient
    on another device than its input."""
    _fake_group(monkeypatch)
    mesh = _two_ranks((4, 1), HOST_META, 0)
    local = [torch.ones(2, 3, requires_grad=True),
             torch.ones(2, 3, device=META, requires_grad=True)]
    gathered = co.all_gather(local + [None, None], mesh=mesh, device=META)
    assert gathered.device == META and gathered.shape == (8, 3)
    ctx = SimpleNamespace(mesh=mesh, dim=0, device=CPU, present=[0, 1],
                          consumers=None, homes=[CPU, META], sizes=[2] * 4)
    grad = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    out = co._GroupAllGather.backward(ctx, grad)
    assert out[:5] == (None,) * 5
    assert [g.device for g in out[5:]] == [CPU, META]
    assert torch.equal(out[5], grad[:2])  # the other rank's rows: zeros
    assert out[6].shape == (2, 3)


def test_a_checkpoint_restores_each_held_shard_on_its_cell(monkeypatch,
                                                          tmp_path):
    """A one-process (1, 4) checkpoint restored by rank 0 of a group over
    (1, 4) with cells cpu and meta: shards 0 and 1 restored where they
    live, 2 and 3 left to rank 1, the replicated state on the manager's
    device."""
    from hm_retrieval_tpu_torch.parallel import create_sharded_sparse_state
    from hm_retrieval_tpu_torch.runners import CheckpointManager

    pm, popt = _pair()
    one = create_sharded_sparse_state(
        pm, popt, make_mesh(1, 4, devices=["cpu"] * 4), SHARDED, seed=3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), device="cpu")
    mgr.save(7, one._replace(step=7))
    mgr.close()
    _fake_group(monkeypatch)
    pm, popt = _pair()
    mesh = _two_ranks((1, 4), HOST_META, 0)
    fresh = create_sharded_sparse_state(pm, popt, mesh, SHARDED, seed=0)
    got = CheckpointManager(str(tmp_path / "ckpt"),
                            device="cpu").restore(fresh)
    name = "query_tower.embeddings.customer_id"
    assert got.step == 7
    assert [None if t is None else t.device for t in got.params[name].shards] == [
        CPU, META, None, None]
    assert torch.equal(got.params[name].shards[0],
                       one.params[name].shards[0])
    assert got.params["query_tower.dense.0.weight"].device == CPU


# --- a real two-rank gloo group, two cells a rank ---------------------------
def _model(spec):
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.schema.features import Feature

    qs, cs, logq, units = spec
    return TwoTowerModel([Feature(**s) for s in qs],
                         [Feature(**s) for s in cs], "article_id",
                         logq=logq, device="cpu", **units)


def _state_and_step(path, spec, mesh, tree):
    """The port's state for ``path`` over ``mesh``, loaded from ``tree``,
    and its step."""
    from hm_retrieval_tpu_torch.models import (
        OptimizerFactory,
        create_train_state,
        train_state_from_numpy,
    )
    from hm_retrieval_tpu_torch.models.sparse_optimizer import (
        create_sparse_train_state,
    )
    from hm_retrieval_tpu_torch.parallel import (
        create_sharded_sparse_state,
        create_sharded_train_state,
        make_dp_sparse_train_step,
        make_dp_train_step,
        make_sharded_sparse_train_step,
        make_sharded_train_step,
        replicate_sparse_state,
        replicate_state,
    )

    model = _model(spec)
    opt = OptimizerFactory.get_optimizer("adagrad", {"learning_rate": LR})
    if path == "dp_dense":
        state = replicate_state(create_train_state(model, opt), mesh)
        step = make_dp_train_step(model, opt, mesh)
    elif path == "dp_sparse":
        state = replicate_sparse_state(create_sparse_train_state(model, opt),
                                       mesh)
        step = make_dp_sparse_train_step(model, opt, LR, mesh)
    elif path == "row_sharded_dense":
        state = create_sharded_train_state(model, opt, mesh, SHARDED)
        step = make_sharded_train_step(model, opt, mesh)
    else:
        state = create_sharded_sparse_state(model, opt, mesh, SHARDED)
        step = make_sharded_sparse_train_step(model, opt, LR, mesh, SHARDED)
    return train_state_from_numpy(state, tree), step


def _run(path, spec, mesh, tree, batches):
    """``STEPS`` steps over ``mesh`` from ``tree`` on ``batches`` (each
    this process's rows): the losses' bytes and the final state's tree
    (collective in a group)."""
    from hm_retrieval_tpu_torch.models import train_state_to_numpy

    state, step = _state_and_step(path, spec, mesh, tree)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(np.array(v))
                                for k, v in b.items()})
        losses.append(m["loss"].numpy().tobytes())
    return losses, train_state_to_numpy(state)


def _local_rows(batch, shape, rank):
    """Rank ``rank``'s rows of a global batch: its data rows' (the whole
    batch where the model axis spans the ranks)."""
    D = shape[0]
    if D < 2:
        return batch
    b = B // 2
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def _rank_main(rank, rdzv, job, outdir):
    torch.set_num_threads(1)
    with open(job, "rb") as f:
        specs, cases = pickle.load(f)
    initialize_multihost(rdzv, 2, rank, device="cpu")
    out = {}
    for (path, shape), (pooling, tree, batches) in cases.items():
        mesh = make_mesh(*shape, devices=["cpu", "cpu"])
        out[(path, shape)] = _run(
            path, specs[pooling], mesh, tree,
            [_local_rows(b, shape, rank) for b in batches])
        out[(path, shape, "layout")] = (mesh.ranks.tolist(),
                                        mesh.local_rows(), mesh.local_cols())
    torch.distributed.destroy_process_group()
    with open(Path(outdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _spawn(*args):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=args, nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                pytest.fail(f"the group ran past {SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(5)


def _jax_start(path, shape, rng):
    """The JAX package's state and step over ``shape`` of 4 host devices,
    from its own init (attention queries made non-zero for the sparse
    paths, as ``tests/test_torch_sharded_training.py`` does)."""
    import jax
    import jax.numpy as jnp

    from hm_retrieval_tpu.models import create_train_state as jax_create
    from hm_retrieval_tpu.models.sparse_optimizer import (
        create_sparse_train_state as jax_create_sparse,
    )
    from hm_retrieval_tpu.parallel import (
        create_sharded_sparse_state as jax_create_sharded_sparse,
        create_sharded_train_state as jax_create_sharded,
        make_dp_sparse_train_step as jax_dp_sparse_step,
        make_dp_train_step as jax_dp_step,
        make_mesh as jax_make_mesh,
        make_sharded_sparse_train_step as jax_sharded_sparse_step,
        make_sharded_train_step as jax_sharded_step,
        replicate_sparse_state as jax_replicate_sparse,
        replicate_state as jax_replicate,
    )
    from tests.test_torch_parallel import _opts
    from tests.test_torch_training import LR, _jax_params, _models, _np_tree

    pooling = "attention" if path.endswith("sparse") else "mean"
    jm, _ = _models(pooling)
    jopt, _ = _opts("adagrad")
    jmesh = jax_make_mesh(*shape, devices=jax.devices()[:4])
    params = _jax_params(jm, rng)
    if path == "dp_dense":
        p = jax.tree_util.tree_map(jnp.asarray, params)
        js = jax_replicate(jax_create(jm, jopt)._replace(
            params=p, opt_state=jopt.init(p)), jmesh)
        return js, jax_dp_step(jm, jopt, jmesh), jmesh, pooling
    if path == "dp_sparse":
        js = jax_replicate_sparse(jax_create_sparse(jm, jopt)._replace(
            params=jax.tree_util.tree_map(jnp.asarray, params)), jmesh)
        return js, jax_dp_sparse_step(jm, jopt, LR, jmesh), jmesh, pooling
    if path == "row_sharded_dense":
        js = jax_create_sharded(jm, jopt, jmesh, SHARDED, seed=0)
        return js, jax_sharded_step(jm, jopt, jmesh), jmesh, pooling
    js = jax_create_sharded_sparse(jm, jopt, jmesh, SHARDED, seed=0)
    padded = jax.tree_util.tree_map(
        lambda want, got: np.pad(want, [(0, got.shape[0] - want.shape[0])]
                                 + [(0, 0)] * (want.ndim - 1)),
        params, _np_tree(js.params))
    js = js._replace(params=jax.tree_util.tree_map(jnp.asarray, padded))
    return (js, jax_sharded_sparse_step(jm, jopt, LR, jmesh, SHARDED), jmesh,
            pooling)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every (path, shape): the JAX package's start and 3 steps over 4 host
    devices, the port's one-process mesh over ``["cpu"] * 4`` from the same
    start, and one spawn of 2 gloo ranks, two cpu cells each, running every
    case."""
    from hm_retrieval_tpu.parallel import shard_batch as jax_shard_batch
    from tests.test_torch_training import (
        _batch,
        _logq,
        _specs,
        jax_state_tree,
    )

    d = tmp_path_factory.mktemp("ranks_several_devices")
    rng = np.random.default_rng(17)
    units = dict(joint_embedding_size=16, query_tower_units=[32],
                 candidate_tower_units=[24])
    specs = {p: (*_specs(p), _logq(), units) for p in ("mean", "attention")}
    cases, jax_out, one = {}, {}, {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' count
    try:
        for path in PATHS:
            for shape in SHAPES:
                js, jstep, jmesh, pooling = _jax_start(path, shape, rng)
                tree = jax_state_tree(js)
                batches = [_batch(rng, B=B) for _ in range(STEPS)]
                cases[(path, shape)] = (pooling, tree, batches)
                losses = []
                for b in batches:
                    js, m = jstep(js, jax_shard_batch(b, jmesh))
                    losses.append(float(m["loss"]))
                jax_out[(path, shape)] = (losses, jax_state_tree(js))
                one[(path, shape)] = _run(
                    path, specs[pooling],
                    make_mesh(*shape, devices=["cpu"] * 4), tree, batches)
    finally:
        torch.set_num_threads(threads)
    job = d / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump((specs, cases), f)
    _spawn(f"file://{d / 'rdzv'}", str(job), str(d))
    ranks = []
    for r in range(2):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "one": one, "jax": jax_out}


def _leaves(tree):
    import jax

    return [(jax.tree_util.keystr(p), np.asarray(a))
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("path", PATHS)
def test_the_group_gives_the_one_process_meshs_bits(group, path, shape):
    """Both ranks' losses and every tensor of the state after 3 steps equal
    the one-process mesh's over ``["cpu"] * 4`` bit for bit: the psum in
    global shard order and the candidates' gradients added in the one
    process's order."""
    key = (path, shape)
    want_losses, want_tree = group["one"][key]
    want = _leaves(want_tree)
    for r, res in enumerate(group["ranks"]):
        losses, tree = res[key]
        assert losses == want_losses, (r, key)
        got = _leaves(tree)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (r, p)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("path", PATHS)
def test_the_group_matches_jax_over_4_host_devices(group, path, shape):
    """Rank 0's steps against the JAX package's over 4 host devices from
    the same start: losses rtol 1e-5, the state rtol 1e-4 / atol 1e-5;
    each rank holds two cells of its data rows or of its columns."""
    from tests.test_torch_training import _assert_trees_close

    key = (path, shape)
    jax_losses, jax_tree = group["jax"][key]
    losses, tree = group["ranks"][0][key]
    got = [float(np.frombuffer(x, np.float32)[0]) for x in losses]
    np.testing.assert_allclose(got, jax_losses, rtol=1e-5)
    _assert_trees_close(tree, jax_tree, STEP_RTOL, STEP_ATOL)
    ranks, rows, cols = group["ranks"][0][(path, shape, "layout")]
    assert np.asarray(ranks).reshape(-1).tolist() == [0, 0, 1, 1]
    assert len(rows) * len(cols) == 2
