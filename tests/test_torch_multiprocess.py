"""The port over a ``torch.distributed`` process group, on the CPU.

The counterpart of ``tests/test_multihost.py::TestProcessGroupBringup`` and
``tests/multihost_driver.py``: a real group of 2 and then of 4 ranks over
``gloo``, 8 CPU devices in all (``8 // P`` a rank), spawned with
``torch.multiprocessing`` and a ``file://`` rendezvous (no port to race
for). The rank function, ``_rank_main``, lives here and imports only the
port: this module imports nothing of JAX or the JAX package at its top, and
each rank reports the JAX modules it holds, which must be none. Each spawn
runs every scenario of ``tests/multihost_driver.py``, chunked dispatch
included, and the runners over the group, on the tiny pipeline of
``tests/test_torch_runners.py`` (the JAX package's ETL and shard stages,
then the port's ``modelling_runner``), under its own timeout: on timeout
every rank is killed and the test fails.

Each rank is held against the port's one-process runs on the same data
(``evaluation_runner``'s recall, exact; the one-process sharded indices,
bit for bit; the one-process mesh steps of the same (D, S), rtol 1e-4 /
atol 1e-5) and, for the row-sharded sparse step whose model axis spans the
ranks, against the JAX package's single-process sparse Adagrad
(``_tp_oracle`` of ``tests/test_multihost.py`` from the port's initial
weights, carried across with ``models/bridge.py``: losses rtol 1e-5, the
parameter digest 1e-6). Across ranks everything is bit for bit.
"""

import dataclasses
import hashlib
import itertools
import logging
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hm_retrieval_tpu_torch.parallel.mesh import (
    TORCHRUN_ENV,
    Mesh,
    choose_backend,
    data_axis_process_aligned,
    initialize_multihost,
    rank_devices,
)

SPAWN_TIMEOUT = 300  # seconds for one group to run every scenario
TP_FEATS = ["customer_id", "article_id"]
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
QUERY_B = 16  # queries of the sharded indices' bitwise check
# values whose sum in shard order differs from a sum of per-rank partials
PSUM_VALUES = [1.0, 1e8, 1.0, 1.0, -1e8, 1.0, 1.0, 1.0]


# --- the rank ----------------------------------------------------------------
def _foreign_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "hm_retrieval_tpu"))


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    if hasattr(tree, "host"):
        return tree.host().numpy()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _state_arrays(state) -> dict:
    """Every tensor of a training state by name, row-sharded ones gathered
    (collective in a group)."""
    out = {f"params/{n}": p for n, p in state.params.items()}
    opt = getattr(state, "opt_state", None) or state.dense_opt_state
    for field, value in opt._asdict().items():
        if isinstance(value, dict):
            out.update({f"opt/{field}/{n}": t for n, t in value.items()})
        elif isinstance(value, torch.Tensor):
            out[f"opt/{field}"] = value
    if hasattr(state, "sparse_state"):
        out.update({f"acc/{n}": t for n, t in
                    state.sparse_state.accumulators.items()})
    return _numpy(out)


def _queries(dim: int) -> torch.Tensor:
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.standard_normal((QUERY_B, dim)).astype(
        np.float32))


def _index_answers(index, q) -> dict:
    v, i = index.topk_from_embeddings(q)
    return {"scores": v.numpy(), "ids": i.numpy()}


def _grad_check(schema, settings, mesh_g, nprocs):
    """A global-negatives loss over (4, 1): each local shard's gradient of
    its candidate tower against the same shard's on a one-process mesh of
    the same shape, computed here from the global batch."""
    from hm_retrieval_tpu_torch.data import ShardDataset
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.parallel.collectives import psum
    from hm_retrieval_tpu_torch.parallel.data_parallel import replica
    from hm_retrieval_tpu_torch.parallel.global_negatives import step_losses
    from hm_retrieval_tpu_torch.parallel.mesh import split_batch

    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    model.init_params(3)
    params = dict(model.named_parameters())
    full = next(ShardDataset(settings.train_shards_dirpath).iter_batches(32))
    glob = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in full.items()}
    D = mesh_g.shape["data"]
    b = 32 // D
    rows = mesh_g.local_rows()
    mine = {k: v[rows[0] * b:(rows[-1] + 1) * b] for k, v in glob.items()}
    one = Mesh(np.array([[torch.device("cpu")]] * D, dtype=object))
    names = [n for n in params if n.startswith("candidate_tower.")]
    out = {}
    for label, mesh, batch in (("group", mesh_g, mine), ("one", one, glob)):
        shards = split_batch(batch, mesh)
        reps = [None if s is None else replica(params) for s in shards]
        loss = psum(step_losses(model, reps, shards, mesh=mesh), mesh)
        local = [d for d, s in enumerate(shards) if s is not None]
        grads = torch.autograd.grad(
            loss, [reps[d][n] for d in local for n in names],
            allow_unused=True, materialize_grads=True)
        out[label] = {(d, n): g for (d, n), g in zip(
            [(d, n) for d in local for n in names], grads)}
        out[label + "_loss"] = float(loss)
    worst = 0.0
    for key, g in out["group"].items():
        want = out["one"][key]
        rel = float((g - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        worst = max(worst, rel)
    return {"worst_rel": worst, "shards": len(out["group"]) // len(names),
            "loss": out["group_loss"], "one_loss": out["one_loss"]}


def _rank_main(rank, nprocs, rdzv, settings_path, outdir):
    """One rank of the group: every scenario, results pickled to
    ``outdir/rank{rank}.pkl``."""
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.WARNING)
    import torch.distributed as dist

    from hm_retrieval_tpu_torch.data import (
        ShardDataset,
        device_feed,
        device_feed_chunked,
        make_chunked_train_step,
    )
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex,
        DistributedQuantizedIndex,
        load_index,
    )
    from hm_retrieval_tpu_torch.metrics import IndexRecall
    from hm_retrieval_tpu_torch.models import (
        OptimizerFactory,
        TwoTowerModel,
        create_train_state,
    )
    from hm_retrieval_tpu_torch.models.bridge import params_from_numpy
    from hm_retrieval_tpu_torch.models.sparse_optimizer import (
        create_sparse_train_state,
    )
    from hm_retrieval_tpu_torch.parallel import (
        create_sharded_sparse_state,
        make_dp_sparse_train_step,
        make_dp_train_step,
        make_mesh,
        make_sharded_lookup,
        make_sharded_sparse_train_step,
        replicate_sparse_state,
        replicate_state,
        unpad_params,
    )
    from hm_retrieval_tpu_torch.parallel.collectives import psum
    from hm_retrieval_tpu_torch.runners import (
        evaluation_runner,
        modelling_runner,
    )
    from hm_retrieval_tpu_torch.schema.schema import Schema
    from hm_retrieval_tpu_torch.utils.pytree_io import load_pytree_npz
    from hm_retrieval_tpu_torch.utils.settings import Settings

    dev = initialize_multihost(rdzv, nprocs, rank, device="cpu")
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "world": dist.get_world_size()}
    settings = Settings.from_json(settings_path)
    schema = Schema.load(settings.schema_dirpath)
    tc = schema.training_config
    local = ["cpu"] * (8 // nprocs)

    # --- lockstep eval over an (8, 1) mesh spanning the group --------------
    mesh = make_mesh(devices=local)
    out["mesh_ranks"] = mesh.ranks.tolist()
    out["recalls"] = evaluation_runner(settings, mesh=mesh, device="cpu")
    test_ds = ShardDataset(settings.test_shards_dirpath, process_index=rank,
                           process_count=nprocs)
    out["local_test_rows"] = test_ds.local_num_rows
    out["local_batches"] = -(-test_ds.local_num_rows
                             // (tc.test_batch_size // nprocs))

    # --- the catalog row-sharded over (P, 8 / P) ---------------------------
    mesh_dm = make_mesh(data=nprocs, model=8 // nprocs, devices=local)
    dist_dir = settings.index_dirpath + "_dist"
    out["dist_recalls"] = evaluation_runner(
        dataclasses.replace(settings, index_dirpath=dist_dir), mesh=mesh_dm,
        distributed_index=True, device="cpu")
    index = DistributedBruteForceIndex.load(dist_dir, mesh=mesh_dm,
                                            method="pallas")
    out["collective_save"] = index.collective_save
    flat = index.to_local(device="cpu")
    n = flat.num_candidates
    out["local_export_digest"] = float(
        flat.embeddings[:n].double().sum() + flat.identifiers[:n].double().sum())
    q = _queries(flat.embeddings.shape[1])
    ids_host = flat.identifiers[:n].numpy()
    emb_host = flat.embeddings[:n].numpy()
    out["answers"] = {
        "exact_pallas": _index_answers(index, q),
        "exact_xla": _index_answers(DistributedBruteForceIndex(
            index.k, ids_host, emb_host, mesh=mesh_dm, method="xla"), q),
        "quantized_pallas": _index_answers(DistributedQuantizedIndex(
            index.k, ids_host, emb_host, mesh=mesh_dm, method="pallas"), q),
    }

    # --- per-process eval, no mesh: IndexRecall(cross_process) ------------
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    params_from_numpy(model, load_pytree_npz(
        f"{settings.model_dirpath}/two_tower/params.npz"))
    single = load_index(settings.index_dirpath, device="cpu")
    metric = IndexRecall([k for k in schema.model_config.ks
                          if k <= single.num_candidates], cross_process=True)
    with torch.no_grad():
        for batch in test_ds.iter_batches(64):
            tb = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in batch.items()}
            _, got = single.topk_from_embeddings(model.query_forward(tb))
            metric.update(got, tb[model.candidate_id_col])
    out["local_recalls"] = metric.results()

    # --- data-parallel steps over the group, then chunked ones -------------
    opt = OptimizerFactory.get_optimizer(tc.optimizer_name,
                                         tc.optimizer_kwargs)
    lr = tc.optimizer_kwargs.get("learning_rate", 0.05)
    train_ds = ShardDataset(settings.train_shards_dirpath,
                            process_index=rank, process_count=nprocs)
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    state = replicate_state(create_train_state(model, opt, seed=0), mesh)
    step = make_dp_train_step(model, opt, mesh)
    losses = []
    for b in device_feed(itertools.islice(
            train_ds.iter_batches(32, drop_remainder=True), 3), mesh=mesh):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    out["train_losses"] = losses
    chunked = []
    for chunk in device_feed_chunked(itertools.islice(
            train_ds.iter_batches(32, drop_remainder=True), 3, 7), 2,
            mesh=mesh):
        state, m = make_chunked_train_step(step)(state, chunk)
        chunked.extend(float(x) for x in m["losses"])
    out["chunked_losses"] = chunked
    out["dp_state"] = _state_arrays(state)

    # --- data-parallel sparse Adagrad over the group -----------------------
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    sp = replicate_sparse_state(create_sparse_train_state(model, opt, seed=0),
                                mesh)
    sp_step = make_dp_sparse_train_step(model, opt, lr, mesh)
    sp_losses = []
    for b in device_feed(itertools.islice(
            train_ds.iter_batches(32, drop_remainder=True), 3), mesh=mesh):
        sp, m = sp_step(sp, b)
        sp_losses.append(float(m["loss"]))
    out["dp_sparse_losses"] = sp_losses
    out["dp_sparse_state"] = _state_arrays(sp)

    # --- row-sharded sparse steps over (P, 8 / P): data rows on ranks ------
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    rs = create_sharded_sparse_state(model, opt, mesh_dm, TP_FEATS, seed=0)
    rs_step = make_sharded_sparse_train_step(model, opt, lr, mesh_dm,
                                             TP_FEATS)
    rs_losses = []
    for b in device_feed(itertools.islice(
            train_ds.iter_batches(32, drop_remainder=True), 3), mesh=mesh_dm):
        rs, m = rs_step(rs, b)
        rs_losses.append(float(m["loss"]))
    out["rows_sharded_losses"] = rs_losses
    out["rows_sharded_state"] = _state_arrays(rs)

    # --- row-sharded sparse steps, the model axis spanning ranks -----------
    n_groups = max(1, nprocs // 2)
    mesh_tp = make_mesh(data=n_groups, model=8 // n_groups, devices=local)
    out["tp_mesh"] = [int(x) for x in mesh_tp.ranks.shape]
    out["tp_row_ranks"] = [sorted(set(r)) for r in mesh_tp.ranks.tolist()]
    group = min(rank // 2, n_groups - 1)
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    tp = create_sharded_sparse_state(model, opt, mesh_tp, TP_FEATS, seed=0)
    tp_step = make_sharded_sparse_train_step(model, opt, lr, mesh_tp,
                                             TP_FEATS)
    tp_ds = ShardDataset(settings.train_shards_dirpath, process_index=group,
                         process_count=n_groups)
    tp_losses = []
    for b in device_feed(itertools.islice(
            tp_ds.iter_batches(16, drop_remainder=True), 3), mesh=mesh_tp):
        tp, m = tp_step(tp, b)
        tp_losses.append(float(m["loss"]))
    out["tp_losses"] = tp_losses
    name = "query_tower.embeddings.customer_id"
    table = tp.params[name]
    out["tp_held"] = [s for s, t in enumerate(table.shards) if t is not None]
    last = table.shards[-1]
    if last is not None:  # this rank holds the last shard: its pad rows
        vocab = model.query_tower.features[0].num_embeddings
        pad = table.shape[0] - vocab
        acc = tp.sparse_state.accumulators[name].shards[-1]
        out["tp_pad_rows"] = pad
        out["tp_pad_zero"] = bool((last[last.shape[0] - pad:] == 0).all()
                                  and (acc[acc.shape[0] - pad:] == 0).all())
    full = table.host()  # collective: every shard from its owner
    ids = next(tp_ds.iter_batches(16))["customer_id"]
    mine = slice(group * 16, (group + 1) * 16)
    out["tp_lookups"] = {}
    for strategy in ("psum", "all_to_all"):
        got = make_sharded_lookup(mesh_tp, strategy)(
            table, torch.from_numpy(ids))
        out["tp_lookups"][strategy] = (
            got.shape[0] == 16 * n_groups
            and torch.equal(got[mine], full[torch.from_numpy(ids).long()]))
    unpadded = unpad_params(tp.params, model)
    out["tp_param_digest"] = float(sum(
        np.float64(t.detach().double().sum()) for t in unpadded.values()))
    out["tp_state"] = _state_arrays(tp)

    # --- the runners over the group, the id tables row-sharded ------------
    sh = Settings.from_json(str(Path(outdir) / "settings_sharded.json"))
    out["reverse_recall"] = evaluation_runner(
        dataclasses.replace(sh, index_dirpath=str(Path(outdir) / "rev")),
        mesh=mesh_dm, distributed_index=True, device="cpu")
    out["runner"] = modelling_runner(_group_settings(sh, outdir),
                                     mesh=mesh_dm, distributed_index=True,
                                     device="cpu")

    # --- the collectives' bits and autograd --------------------------------
    vals = [torch.tensor([v], dtype=torch.float32) for v in PSUM_VALUES]
    mine = [vals[d] if d in mesh.local_rows() else None for d in range(8)]
    group_sum = psum(mine, mesh)
    one_sum = psum(vals)
    partial = vals[mesh.local_rows()[0]].clone()
    for d in mesh.local_rows()[1:]:
        partial = partial + vals[d]
    dist.all_reduce(partial)
    out["psum"] = {"group": group_sum.numpy().tobytes(),
                   "one": one_sum.numpy().tobytes(),
                   "partials": partial.numpy().tobytes()}
    mesh_g = make_mesh(4, 1, devices=["cpu"] * (4 // nprocs))
    out["grad_check"] = _grad_check(schema, settings, mesh_g, nprocs)
    out["state_sha"] = _sha([torch.from_numpy(np.ascontiguousarray(v))
                             for key in ("dp_state", "dp_sparse_state",
                                         "rows_sharded_state", "tp_state")
                             for v in out[key].values()])
    out["foreign_modules"] = _foreign_modules()
    dist.destroy_process_group()
    with open(Path(outdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _group_settings(sh, outdir):
    """Where the group's runner writes its checkpoints, towers and index."""
    d = Path(outdir)
    return dataclasses.replace(
        sh, checkpoint_dirpath=str(d / "group_ckpt"),
        model_dirpath=str(d / "group_model"),
        index_dirpath=str(d / "group_index"))


def _spawn(nprocs, *args, timeout=SPAWN_TIMEOUT):
    """Run ``_rank_main`` on ``nprocs`` spawned ranks; a rank that fails
    fails the test, and so does the group running past ``timeout``, every
    rank killed first."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=args, nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"a group of {nprocs} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(5)


# --- the parent: pipeline, group runs and one-process oracles ---------------
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``tests/test_torch_runners.py``'s pipeline: the JAX package's ETL
    and shard stages, then the port's ``modelling_runner`` on the CPU."""
    from tests.test_torch_runners import run_jax_stages

    from hm_retrieval_tpu_torch.runners import modelling_runner

    settings = run_jax_stages(str(tmp_path_factory.mktemp("mp_pipeline")))
    modelling_runner(settings, device="cpu")
    return settings


@pytest.fixture(scope="module")
def oracle_recall(trained, tmp_path_factory):
    from hm_retrieval_tpu_torch.runners import evaluation_runner

    d = tmp_path_factory.mktemp("mp_oracle")
    return evaluation_runner(
        dataclasses.replace(trained, index_dirpath=str(d / "index")),
        device="cpu")


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def group(request, trained, tmp_path_factory):
    """One spawn of ``P`` ranks running every scenario; the ranks' results
    in rank order."""
    from hm_retrieval_tpu_torch.runners import modelling_runner
    from hm_retrieval_tpu_torch.schema.schema import Schema

    nprocs = request.param
    d = tmp_path_factory.mktemp(f"mp_group{nprocs}")
    settings = dataclasses.replace(trained, index_dirpath=str(d / "index"))
    settings.to_json(str(d / "settings.json"))
    # the runners' scenario: both id tables row-sharded, one epoch, and a
    # one-process run over a mesh of the group's shape, whose checkpoint the
    # group restores
    schema = Schema.load(trained.schema_dirpath)
    schema.training_config = dataclasses.replace(
        schema.training_config, sharded_embedding_features=TP_FEATS, epochs=1)
    schema.save(str(d / "schema_sharded"))
    sh = dataclasses.replace(
        trained, schema_dirpath=str(d / "schema_sharded"),
        checkpoint_dirpath=str(d / "one_ckpt"),
        model_dirpath=str(d / "one_model"),
        index_dirpath=str(d / "one_index"))
    sh.to_json(str(d / "settings_sharded.json"))
    one = modelling_runner(sh, mesh=_one_process_mesh(nprocs, 8 // nprocs),
                           distributed_index=True, device="cpu")
    _spawn(nprocs, nprocs, f"file://{d / 'rdzv'}", str(d / "settings.json"),
           str(d))
    results = []
    for r in range(nprocs):
        with open(d / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return {"P": nprocs, "settings": settings, "results": results,
            "sharded": sh, "one_runner": one, "dir": d}


def _global_batches(settings, nprocs, per_rank, start, stop, parts=None):
    """The global batches of steps ``start .. stop - 1``: each part's
    (rank's, or data group's) local batch of ``per_rank`` rows, in order."""
    from hm_retrieval_tpu_torch.data import ShardDataset

    parts = nprocs if parts is None else parts
    its = [itertools.islice(ShardDataset(
        settings.train_shards_dirpath, process_index=r,
        process_count=parts).iter_batches(per_rank, drop_remainder=True),
        start, stop) for r in range(parts)]
    out = []
    for locals_ in zip(*its):
        out.append({k: torch.from_numpy(np.concatenate([b[k] for b in locals_]))
                    for k in locals_[0]})
    return out


def _one_process_mesh(data, model):
    from hm_retrieval_tpu_torch.parallel import make_mesh

    return make_mesh(data, model, devices=["cpu"] * (data * model))


def _assert_state_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=k)


def _schema_opt(settings):
    from hm_retrieval_tpu_torch.models import OptimizerFactory
    from hm_retrieval_tpu_torch.schema.schema import Schema

    schema = Schema.load(settings.schema_dirpath)
    tc = schema.training_config
    return schema, tc, OptimizerFactory.get_optimizer(tc.optimizer_name,
                                                      tc.optimizer_kwargs)


# --- units: backend, device, arguments, mesh layout ------------------------
@pytest.mark.parametrize("device_type, on_host, cards, want", [
    ("cuda", 2, 2, "nccl"),
    ("cuda", 1, 8, "nccl"),
    ("cuda", 2, 1, "gloo"),  # two ranks sharing one card
    ("cpu", 4, 0, "gloo"),
    ("cpu", 2, 8, "gloo"),
])
def test_backend_choice(device_type, on_host, cards, want):
    assert choose_backend(device_type, on_host, cards) == want


def test_rank_device(monkeypatch):
    """A rank's devices (``rank_devices``): one card a rank where the ranks
    are at least as many as the cards (or their count is not given)."""
    assert rank_devices(3, device="cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rank_devices(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert rank_devices(3) == [torch.device("cuda", 1)]
    assert rank_devices(2, 4) == [torch.device("cuda", 0)]
    assert rank_devices(0, device="cuda:1") == [torch.device("cuda", 1)]


def _recorded_init(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    return calls


def test_initialize_multihost_arguments(monkeypatch):
    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    calls = _recorded_init(monkeypatch)
    for partial in ({"coordinator_address": "localhost:1"},
                    {"num_processes": 2, "process_id": 0}):
        with pytest.raises(ValueError, match="together"):
            initialize_multihost(**partial)
    assert initialize_multihost(device="cpu") is None and not calls
    dev = initialize_multihost("localhost:1234", 2, 1, device="cpu")
    assert dev == torch.device("cpu")
    backend, kw = calls[-1]
    assert backend == "gloo" and kw == {
        "init_method": "tcp://localhost:1234", "rank": 1, "world_size": 2}
    initialize_multihost("file:///tmp/rdzv", 4, 3, device="cpu")
    assert calls[-1][1]["init_method"] == "file:///tmp/rdzv"


def test_initialize_multihost_reads_torchrun(monkeypatch):
    calls = _recorded_init(monkeypatch)
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": "29500", "RANK": "5",
           "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert initialize_multihost(device="cpu") == torch.device("cpu")
    assert calls == [("gloo", {"init_method": "env://", "rank": 5,
                               "world_size": 8})]
    # a card a rank on this host: nccl, the rank's card by LOCAL_RANK
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    assert initialize_multihost() == torch.device("cuda", 1)
    assert calls[-1][0] == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert initialize_multihost() == torch.device("cuda", 0)
    assert calls[-1][0] == "gloo"  # four ranks share one card


def test_a_second_call_is_tolerated(monkeypatch, caplog):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 0)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with caplog.at_level(logging.INFO):
        initialize_multihost("localhost:1", 2, 0, device="cpu")
    assert "already initialized" in caplog.text


def _grid(ranks, me):
    ranks = np.asarray(ranks)
    devs = np.empty(ranks.shape, dtype=object)
    devs[...] = torch.device("cpu")
    return Mesh(devs, ranks, me)


def test_mesh_grid_and_owners():
    # (1, 8) over 2 ranks: the model axis spans them
    tp = _grid([[0, 0, 0, 0, 1, 1, 1, 1]], 1)
    assert tp.process_count == 2 and tp.local_rows() == [0]
    assert tp.local_cols() == [4, 5, 6, 7] and tp.row_owner(0) == 0
    assert tp.column(3) == [] and tp.column(4) == [torch.device("cpu")]
    assert tp.is_local(0, 5) and not tp.is_local(0, 1)
    assert tp.col_owner(6) == 1
    from hm_retrieval_tpu_torch.parallel.collectives import axis_index

    assert axis_index(tp, "model") == [4, 5, 6, 7]
    assert axis_index(tp, "data") == [0]
    # (4, 2) over 2 ranks: whole rows
    dp = _grid([[0, 0], [0, 0], [1, 1], [1, 1]], 1)
    assert dp.local_rows() == [2, 3] and dp.local_cols() == [0, 1]
    assert dp.rows_of(0) == [0, 1] and dp.row_owner(3) == 1
    assert dp.first_device == torch.device("cpu")


def test_layouts_that_are_neither_rows_nor_one_row_raise():
    from hm_retrieval_tpu_torch.parallel.mesh import _check_layout

    _check_layout(np.array([[0, 0], [1, 1]]))
    _check_layout(np.array([[0, 0, 1, 1], [2, 2, 3, 3]]))
    with pytest.raises(ValueError, match="neither whole data rows"):
        _check_layout(np.array([[0, 0], [0, 1], [1, 1]]))


def test_data_axis_process_aligned():
    assert data_axis_process_aligned(_grid([[0, 0], [1, 1]], 0))
    assert data_axis_process_aligned(_grid([[0], [0], [1], [1]], 0))
    assert not data_axis_process_aligned(_grid([[0, 1]], 0))
    assert not data_axis_process_aligned(_grid([[0, 0, 1, 1],
                                                [2, 2, 3, 3]], 0))


def test_a_one_process_mesh_splits_the_whole_batch():
    from hm_retrieval_tpu_torch.parallel.mesh import split_batch

    mesh = _grid([[0], [0], [0], [0]], 0)
    parts = split_batch({"a": torch.arange(8)}, mesh)
    assert [p["a"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5],
                                                [6, 7]]
    rank1 = _grid([[0], [0], [1], [1]], 1)
    parts = split_batch({"a": torch.arange(4)}, rank1)
    assert parts[:2] == [None, None]
    assert [p["a"].tolist() for p in parts[2:]] == [[0, 1], [2, 3]]


# --- the group runs ---------------------------------------------------------
def test_ranks_import_only_the_port(group):
    for r in group["results"]:
        assert r["foreign_modules"] == [], r["foreign_modules"]
        assert r["backend"] == "gloo" and r["world"] == group["P"]
        assert r["device"] == "cpu"


def test_the_mesh_spans_the_group(group):
    P = group["P"]
    for r in group["results"]:
        assert r["mesh_ranks"] == [[i * P // 8] for i in range(8)]


def test_lockstep_recall_equals_one_process(group, oracle_recall):
    """Every rank reports the one-process ``evaluation_runner``'s recall;
    the ranks fed disjoint shards that cover the test set, and at least one
    group has ranks with unequal batch counts (one drains first)."""
    from hm_retrieval_tpu_torch.data import ShardDataset

    res = group["results"]
    for r in res:
        assert r["recalls"] == oracle_recall
    full = ShardDataset(group["settings"].test_shards_dirpath).num_rows
    assert sum(r["local_test_rows"] for r in res) == full
    assert all(r["local_test_rows"] < full for r in res)


def test_a_rank_drains_first(group):
    """The test shards do not split evenly (6 shards of up to 200 rows):
    the ranks' rows differ, and over 4 ranks (7, 6, 4, 4 batches of 64) so
    do their batch counts, so the lockstep loop feeds padding on the
    drained ranks, which the recall above shows to count nothing."""
    rows = [r["local_test_rows"] for r in group["results"]]
    counts = [r["local_batches"] for r in group["results"]]
    assert len(set(rows)) > 1, rows
    if group["P"] == 4:
        assert len(set(counts)) > 1, counts


def test_row_sharded_index_recall_equals_one_process(group, tmp_path):
    """The catalog row-sharded over (P, 8 / P) across the ranks: the recall
    of the one-process ``evaluation_runner`` over a one-process mesh of that
    shape (its "auto" engine is the bf16 "pallas" one at this k and width,
    where the single-device index at 120 rows takes the fp32 "full")."""
    from hm_retrieval_tpu_torch.runners import evaluation_runner

    P = group["P"]
    want = evaluation_runner(
        dataclasses.replace(group["settings"],
                            index_dirpath=str(tmp_path / "index")),
        mesh=_one_process_mesh(P, 8 // P), distributed_index=True,
        device="cpu")
    for r in group["results"]:
        assert r["dist_recalls"] == want
        assert r["collective_save"] is True


def test_cross_process_recall_equals_one_process(group, oracle_recall):
    for r in group["results"]:
        assert r["local_recalls"] == oracle_recall


def test_the_collective_save_loads_in_one_process(group):
    """Each rank wrote the shards of its columns in data row 0, rank 0 the
    meta; one process loads the artifact onto the same mesh shape and
    answers the ranks' queries bit for bit, as every rank does."""
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex,
        DistributedQuantizedIndex,
        load_distributed_index,
    )

    P = group["P"]
    dist_dir = group["settings"].index_dirpath + "_dist"
    files = sorted(p.name for p in Path(dist_dir).glob("index_shard_*.npz"))
    assert files == [f"index_shard_{s:05d}.npz" for s in range(8 // P)]
    mesh = _one_process_mesh(P, 8 // P)
    index = load_distributed_index(dist_dir, mesh, method="pallas")
    assert isinstance(index, DistributedBruteForceIndex)
    flat = index.to_local(device="cpu")
    n = flat.num_candidates
    ids, emb = flat.identifiers[:n].numpy(), flat.embeddings[:n].numpy()
    q = _queries(emb.shape[1])
    one = {
        "exact_pallas": _index_answers(index, q),
        "exact_xla": _index_answers(DistributedBruteForceIndex(
            index.k, ids, emb, mesh=mesh, method="xla"), q),
        "quantized_pallas": _index_answers(DistributedQuantizedIndex(
            index.k, ids, emb, mesh=mesh, method="pallas"), q),
    }
    digest = float(flat.embeddings[:n].double().sum()
                   + flat.identifiers[:n].double().sum())
    for r in group["results"]:
        assert r["local_export_digest"] == digest
        for name, want in one.items():
            for key in ("scores", "ids"):
                assert r["answers"][name][key].tobytes() == \
                    want[key].tobytes(), (name, key)


def test_ranks_agree_bit_for_bit(group):
    r0 = group["results"][0]
    for r in group["results"][1:]:
        for key in ("recalls", "dist_recalls", "local_recalls",
                    "train_losses", "chunked_losses", "dp_sparse_losses",
                    "rows_sharded_losses", "tp_losses", "tp_param_digest", "local_export_digest",
                    "state_sha"):
            assert r[key] == r0[key], key


def test_data_parallel_steps_equal_the_one_process_mesh(group):
    """3 steps then 2 chunked calls of 2 over the (8, 1) mesh of the
    group, against the same steps over a one-process (8, 1) mesh on the
    global batches (each rank's rows in rank order)."""
    from hm_retrieval_tpu_torch.data import make_chunked_train_step
    from hm_retrieval_tpu_torch.models import TwoTowerModel, create_train_state
    from hm_retrieval_tpu_torch.parallel import make_dp_train_step, \
        replicate_state

    P, settings = group["P"], group["settings"]
    schema, tc, opt = _schema_opt(settings)
    mesh = _one_process_mesh(8, 1)
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    state = replicate_state(create_train_state(model, opt, seed=0), mesh)
    step = make_dp_train_step(model, opt, mesh)
    losses = []
    for b in _global_batches(settings, P, 32, 0, 3):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    batches = _global_batches(settings, P, 32, 3, 7)
    for i in (0, 2):
        chunk = {k: torch.stack([batches[i][k], batches[i + 1][k]])
                 for k in batches[0]}
        state, m = make_chunked_train_step(step)(state, chunk)
        losses.extend(float(x) for x in m["losses"])
    r0 = group["results"][0]
    got = r0["train_losses"] + r0["chunked_losses"]
    assert len(got) == 7 and all(np.isfinite(got))
    np.testing.assert_allclose(got, losses, rtol=STEP_RTOL, atol=STEP_ATOL)
    _assert_state_close(r0["dp_state"], _state_arrays(state))


def test_data_parallel_sparse_steps_equal_the_one_process_mesh(group):
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.models.sparse_optimizer import (
        create_sparse_train_state,
    )
    from hm_retrieval_tpu_torch.parallel import (
        make_dp_sparse_train_step,
        replicate_sparse_state,
    )

    P, settings = group["P"], group["settings"]
    schema, tc, opt = _schema_opt(settings)
    lr = tc.optimizer_kwargs.get("learning_rate", 0.05)
    mesh = _one_process_mesh(8, 1)
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    sp = replicate_sparse_state(create_sparse_train_state(model, opt, seed=0),
                                mesh)
    step = make_dp_sparse_train_step(model, opt, lr, mesh)
    losses = []
    for b in _global_batches(settings, P, 32, 0, 3):
        sp, m = step(sp, b)
        losses.append(float(m["loss"]))
    r0 = group["results"][0]
    np.testing.assert_allclose(r0["dp_sparse_losses"], losses,
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    _assert_state_close(r0["dp_sparse_state"], _state_arrays(sp))


def test_row_sharded_sparse_over_rank_rows_equals_the_one_process_mesh(
        group):
    """Both id tables row-sharded over (P, 8 / P), each rank a data row and
    every column: 3 steps against a one-process mesh of that shape on the
    global batches."""
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.parallel import (
        create_sharded_sparse_state,
        make_sharded_sparse_train_step,
    )

    P, settings = group["P"], group["settings"]
    schema, tc, opt = _schema_opt(settings)
    lr = tc.optimizer_kwargs.get("learning_rate", 0.05)
    mesh = _one_process_mesh(P, 8 // P)
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    rs = create_sharded_sparse_state(model, opt, mesh, TP_FEATS, seed=0)
    step = make_sharded_sparse_train_step(model, opt, lr, mesh, TP_FEATS)
    losses = []
    for b in _global_batches(settings, P, 32, 0, 3):
        rs, m = step(rs, b)
        losses.append(float(m["loss"]))
    r0 = group["results"][0]
    np.testing.assert_allclose(r0["rows_sharded_losses"], losses,
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    _assert_state_close(r0["rows_sharded_state"], _state_arrays(rs))


def _tp_batches(settings, n_groups):
    return _global_batches(settings, n_groups, 16, 0, 3, parts=n_groups)


def test_row_sharded_sparse_across_ranks_equals_the_one_process_mesh(group):
    """The model axis spans the ranks (each data row over 2 ranks, both
    feeding the row's rows): against a one-process mesh of the same (D, S)
    on the global batches; each rank holds only its columns' shards, the
    last shard's pad rows stay zero, and both lookups across the ranks
    give ``table[ids]`` bit for bit."""
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.parallel import (
        create_sharded_sparse_state,
        make_sharded_sparse_train_step,
    )

    P, settings = group["P"], group["settings"]
    n_groups = max(1, P // 2)
    res = group["results"]
    for r in res:
        assert r["tp_mesh"] == [n_groups, 8 // n_groups]
        assert all(len(ranks) == 2 for ranks in r["tp_row_ranks"])
        assert len(r["tp_held"]) == 8 // P
    assert all(r["tp_lookups"] == {"psum": True, "all_to_all": True}
               for r in res)
    pads = [r for r in res if "tp_pad_rows" in r]
    assert pads and all(r["tp_pad_rows"] > 0 and r["tp_pad_zero"]
                        for r in pads)
    schema, tc, opt = _schema_opt(settings)
    lr = tc.optimizer_kwargs.get("learning_rate", 0.05)
    mesh = _one_process_mesh(n_groups, 8 // n_groups)
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    tp = create_sharded_sparse_state(model, opt, mesh, TP_FEATS, seed=0)
    step = make_sharded_sparse_train_step(model, opt, lr, mesh, TP_FEATS)
    losses = []
    for b in _tp_batches(settings, n_groups):
        tp, m = step(tp, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(res[0]["tp_losses"], losses, rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    _assert_state_close(res[0]["tp_state"], _state_arrays(tp))


def test_row_sharded_sparse_across_ranks_matches_jax(group):
    """``tests/test_multihost.py::_tp_oracle``'s single-process JAX sparse
    Adagrad over the same global batches, from the port's initial weights:
    losses rtol 1e-5, parameter digest 1e-6."""
    import jax
    import jax.numpy as jnp

    from hm_retrieval_tpu.models import OptimizerFactory as JaxOpt
    from hm_retrieval_tpu.models.sparse_optimizer import (
        make_sparse_train_step as jax_sparse_step,
    )
    from hm_retrieval_tpu.models.two_tower import TwoTowerModel as JaxModel
    from hm_retrieval_tpu.schema.schema import Schema as JaxSchema
    from tests.test_torch_training import jax_state

    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.models.bridge import train_state_to_numpy
    from hm_retrieval_tpu_torch.models.sparse_optimizer import (
        create_sparse_train_state,
    )

    P, settings = group["P"], group["settings"]
    schema, tc, opt = _schema_opt(settings)
    lr = tc.optimizer_kwargs.get("learning_rate", 0.05)
    start = train_state_to_numpy(create_sparse_train_state(
        TwoTowerModel.create_from_schema(schema, device="cpu"), opt, seed=0))
    jschema = JaxSchema.load(settings.schema_dirpath)
    jmodel = JaxModel.create_from_schema(jschema)
    jopt = JaxOpt.get_optimizer(tc.optimizer_name, tc.optimizer_kwargs)
    jstep = jax_sparse_step(jmodel, jopt, lr)
    state = jax_state(start)
    losses = []
    for b in _tp_batches(settings, max(1, P // 2)):
        state, m = jstep(state, {k: jnp.asarray(v.numpy())
                                 for k, v in b.items()})
        losses.append(float(m["loss"]))
    digest = float(sum(np.float64(np.asarray(leaf, np.float64).sum())
                       for leaf in jax.tree.leaves(state.params)))
    r0 = group["results"][0]
    np.testing.assert_allclose(r0["tp_losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(r0["tp_param_digest"], digest, rtol=1e-6)


def test_group_psum_keeps_the_one_process_bits(group):
    """The group's psum of per-shard values equals the one-process psum bit
    for bit; an all-reduce of each rank's partial sum does not, on values
    whose association shows."""
    for r in group["results"]:
        ps = r["psum"]
        assert ps["group"] == ps["one"]
        assert ps["partials"] != ps["one"]


def test_autograd_across_ranks_gives_the_one_process_gradients(group):
    """Each local shard's candidate-tower gradient of a global-negatives
    loss over (4, 1) (2 ranks x 2 shards, or 4 x 1) is the one-process
    mesh's within 1e-6 relative; the loss is the same on every rank."""
    for r in group["results"]:
        gc = r["grad_check"]
        assert gc["shards"] == 4 // group["P"]
        assert gc["worst_rel"] <= 1e-6, gc
        np.testing.assert_allclose(gc["loss"], gc["one_loss"], rtol=1e-6)
    assert len({r["grad_check"]["loss"] for r in group["results"]}) == 1


def test_the_runner_over_the_group(group):
    """``modelling_runner`` over (P, 8 / P), the id tables row-sharded and
    the sharded index: every rank the same results; the first evaluation,
    before any step, the one-process runner's; recall rises."""
    one = group["one_runner"]
    r0 = group["results"][0]["runner"]
    for r in group["results"]:
        assert r["runner"] == r0
    assert r0["initial"] == one["initial"]
    assert r0["final"][50] > r0["initial"][50], r0


def test_the_groups_checkpoint_restores_in_one_process(group, tmp_path):
    """One process restores the checkpoint the group wrote (rank 0 writing
    the tables gathered from their owners) into a mesh of the same shape:
    its ``evaluation_runner`` equals the group's final recall; the group's
    index loads in one process; the towers are exported unpadded."""
    from hm_retrieval_tpu_torch.indices import load_distributed_index
    from hm_retrieval_tpu_torch.runners import evaluation_runner
    from hm_retrieval_tpu_torch.runners.checkpoint import CheckpointManager
    from hm_retrieval_tpu_torch.utils.pytree_io import load_pytree_npz

    P = group["P"]
    g = _group_settings(group["sharded"], group["dir"])
    steps = CheckpointManager(g.checkpoint_dirpath, device="cpu").all_steps()
    assert len(steps) == 1
    mesh = _one_process_mesh(P, 8 // P)
    got = evaluation_runner(
        dataclasses.replace(g, index_dirpath=str(tmp_path / "index")),
        mesh=mesh, distributed_index=True, device="cpu")
    assert got == group["results"][0]["runner"]["final"]
    index = load_distributed_index(g.index_dirpath, mesh)
    ref = load_distributed_index(group["sharded"].index_dirpath, mesh)
    assert index.num_candidates == ref.num_candidates
    assert np.array_equal(index._host_identifiers(), ref._host_identifiers())
    for tower in ("query_tower", "candidate_tower"):
        mine = load_pytree_npz(f"{g.model_dirpath}/{tower}/params.npz")
        one = load_pytree_npz(
            f"{group['sharded'].model_dirpath}/{tower}/params.npz")
        assert {k: np.shape(v) for k, v in mine["embeddings"].items()} == {
            k: np.shape(v) for k, v in one["embeddings"].items()}


def test_a_one_process_checkpoint_restores_in_the_group(group):
    """The group restores the one-process run's row-sharded checkpoint, each
    rank its own shards: its recall is the one-process run's final."""
    for r in group["results"]:
        assert r["reverse_recall"] == group["one_runner"]["final"]


def test_a_tcp_rendezvous_through_initialize_multihost(tmp_path):
    """Two ranks join through ``initialize_multihost("localhost:<port>",
    ...)``: the group forms over gloo on the CPU and a psum across it
    equals the one-process one."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_tcp_rank, args=(f"localhost:{port}",
                                              str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                pytest.fail("the tcp group ran past 120 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    got = [(tmp_path / f"tcp{r}.txt").read_text() for r in range(2)]
    assert got == ["gloo 2 1 3.0"] * 2, got


def _tcp_rank(rank, address, outdir):
    import torch.distributed as dist

    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.parallel.collectives import psum

    initialize_multihost(address, 2, rank, device="cpu")
    mesh = make_mesh(2, 1, devices=["cpu"])
    vals = [torch.tensor([1.0]), torch.tensor([2.0])]
    got = psum([v if d == rank else None for d, v in enumerate(vals)], mesh)
    Path(outdir, f"tcp{rank}.txt").write_text(
        f"{dist.get_backend()} {dist.get_world_size()} "
        f"{mesh.process_count - 1} {float(got)}")
    dist.destroy_process_group()
