"""Train + eval orchestration: the main pipeline stage.

Counterpart of the JAX package's ``runners/modelling.py`` (ref:
pkg/modelling/runner.py:18-107):

- schema + shard datasets in, ``make_single_device_trainer``'s step, or
  over a mesh ``make_mesh_trainer``'s (``models/train_path.py``)
- per epoch: build the index from the candidate tower, evaluate Recall@K at
  the epoch's start (ref: runner.py:85-105), then train one epoch
- after the final epoch the index is rebuilt and evaluated again (the JAX
  package's fix of the reference, which never computed post-training
  recall)
- a checkpoint per epoch (``runners/checkpoint.py``) + npz tower export +
  the index artifact
- TensorBoard scalars (``utils/summary.py``) + a profiler trace window
  (``utils/profiling.py``)

Every entry point takes ``device=None``, which means the card, and raises
without CUDA unless given ``device="cpu"``. Each takes a mesh
(``parallel/mesh.py``) and ``distributed`` / ``distributed_index``, which
shards the catalog over the mesh's model axis (``indices/distributed.py``);
the eval batches and the replicated weights stay on this process's first
device of the mesh, which must be ``device``, where the JAX package shards
the batches over the data axis and replicates the weights.
``modelling_runner`` trains over a mesh of one device repeated
(``["cuda:0"] * 4``) or of several distinct devices (every card, or a card
and the host CPU, ``["cuda:0", "cpu"]``), each data shard and each table
shard on its cell's device (``parallel/mesh.py``), with the tables of
``sharded_embedding_features`` row-sharded when the mesh has a model axis;
``build_index`` and ``evaluate`` take the training state's ``params`` and
gather a row-sharded table's rows through its shards, wherever they live,
so the full table is never assembled on the device.

Over a process group of P ranks (``initialize_multihost``), as in the JAX
package: each rank reads its own test shards (``ShardDataset``'s
``process_index``), ``test_batch_size // P`` rows a batch, and every rank
runs the group's largest count of batches (``_allgather_max``), a drained
rank feeding padding that the validity mask drops; ``IndexRecall`` sums
``{hits, seen}`` over the group, so every rank reports the global recall. A
sharded index over the group answers the whole batch (every rank's query
rows, gathered) and each rank counts its own rows. ``modelling_runner``
feeds each rank ``train_batch_size // P`` rows of its own train shards a
step (its shuffle seeded by epoch and rank, as JAX's), for the group's
smallest step count (``_allgather_min``). Host writes go through rank 0
(``_is_coordinator``): the index artifact unless it saves collectively, the
tower exports and event files; checkpoints are collective (a row-sharded
table gathered from its owners, rank 0 writing); a barrier follows each
before any rank reads it back.

With ``settings.savedmodel_dirpath`` the runner validates the schema for the
SavedModel export before any step, as the JAX package does, and also checks
there that TensorFlow can be imported (a deliberate difference: the JAX
package finds out at the export, after the last epoch); after the final
evaluation every rank collapses a sharded index with ``to_local()`` and
rank 0 writes the SavedModel from the unpadded query tower
(``serving/savedmodel_export.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from hm_retrieval_tpu_torch.data.dataset import ShardDataset
from hm_retrieval_tpu_torch.data.device_feed import (
    device_feed,
    device_feed_chunked,
    make_chunked_train_step,
)
from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.metrics.index_recall import IndexRecall
from hm_retrieval_tpu_torch.models.bridge import flat_to_tree
from hm_retrieval_tpu_torch.models.train_path import (
    active_sharded_features,
    create_mesh_state,
    create_single_device_state,
    make_mesh_trainer,
    make_single_device_trainer,
)
from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.parallel.collectives import (
    barrier,
    gather_processes,
    reduce_int,
)
from hm_retrieval_tpu_torch.parallel.mesh import (
    canonical,
    data_axis_process_aligned,
    process_count,
    process_index,
    training_device,
)
from hm_retrieval_tpu_torch.parallel.data_parallel import sharded_rows
from hm_retrieval_tpu_torch.parallel.sharded_sparse_training import (
    unpad_params,
)
from hm_retrieval_tpu_torch.runners.checkpoint import (
    CheckpointManager,
    export_model,
)
from hm_retrieval_tpu_torch.schema.schema import Schema
from hm_retrieval_tpu_torch.serving.savedmodel_export import (
    export_index_savedmodel,
    require_tensorflow,
    validate_exportable_schema,
)
from hm_retrieval_tpu_torch.utils.profiling import StepProfiler
from hm_retrieval_tpu_torch.utils.settings import Settings
from hm_retrieval_tpu_torch.utils.summary import MetricWriter

logger = logging.getLogger(__name__)


def _on_mesh(mesh, dev: torch.device) -> None:
    """A mesh's batches and weights stay on this process's first device:
    ``dev``."""
    if mesh is None:
        return
    if mesh.first_device != canonical(dev):
        raise ValueError(
            f"the mesh's first device {mesh.first_device} is not the "
            f"model's device {dev}"
        )


def _allgather_max(n: int) -> int:
    """The largest ``n`` over the process group: every rank runs that many
    eval batches, a drained one feeding padding."""
    return reduce_int(n, "max")


def _allgather_min(n: int) -> int:
    """The smallest ``n`` over the process group (train step counts)."""
    return reduce_int(n, "min")


def _is_coordinator() -> bool:
    """True on the process that writes host-side artifacts (index files
    that do not save collectively, exports, event files): several ranks
    writing one path would race."""
    return process_index() == 0


def _check_group(mesh, *batch_sizes: int) -> int:
    """The process count P; over a group of P > 1 ranks, a mesh whose data
    rows each live on one rank and batch sizes that divide by P, as the JAX
    runner requires (``ValueError`` otherwise)."""
    P = process_count()
    if P == 1:
        return P
    if mesh is None:
        raise ValueError("a run over a process group requires a mesh")
    if mesh.process_count != P:
        raise ValueError(
            f"the mesh spans {mesh.process_count} process(es), the group "
            f"{P}: build it with make_mesh after initialize_multihost"
        )
    if not data_axis_process_aligned(mesh):
        raise ValueError(
            "a run over a process group needs a mesh whose data rows each "
            "live on ONE process (each rank feeds its own shards); use "
            "make_mesh(data=P*k, ...) in rank order"
        )
    for b in batch_sizes:
        if b % P:
            raise ValueError(f"batch size {b} must divide by the process "
                             f"count {P}")
    return P


def _pad_batch(batch: Dict[str, np.ndarray], size: int):
    """Pad a tail batch to the static batch size along axis 0 only
    (2-D sequence features keep their width); returns (batch, n)."""
    n = len(next(iter(batch.values())))
    if n == size:
        return batch, n

    def pad(v):
        v = np.asarray(v)
        return np.pad(v, [(0, size - n)] + [(0, 0)] * (v.ndim - 1))

    return {k: pad(v) for k, v in batch.items()}, n


def _to(batch: Dict[str, np.ndarray], dev: torch.device):
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for k, v in batch.items()
    }


def _tower(model: TwoTowerModel, tower: str, params=None):
    """``batch -> embeddings`` of ``model``'s tower ``tower``; the rows of
    the row-sharded tables of ``params`` (a training state's) gathered
    through their shards."""
    module = getattr(model, tower)
    if params is None:
        return module

    def forward(batch):
        return module(batch,
                      rows=sharded_rows(model, params, batch, (tower,))[tower])

    return forward


def build_index(
    model: TwoTowerModel,
    candidate_ds: ShardDataset,
    candidate_batch_size: int,
    k: int,
    index_type: str = "brute_force",
    mesh=None,
    distributed: bool = False,
    device: DeviceLike = None,
    params=None,
):
    """Embed the full catalog with ``model``'s candidate tower in batches of
    ``candidate_batch_size`` (ref: runner.py:88-93 + brute_force.py:31-52)
    and index it on ``device``. ``index_type`` picks the family
    (``ModelConfig.index_type``). A family that advertises
    ``supports_device_build`` (both do) builds from the catalog where the
    tower put it, so the (N, E) catalog never reaches the host; any other
    is built from ``collect_catalog``'s host arrays, as the JAX package
    builds it. ``distributed=True`` streams the catalog into shards over
    ``mesh``'s model axis instead (``collect_catalog_sharded``), each shard
    finished on its device. ``params``: a training state's, whose row-sharded
    tables the tower reads through their shards."""
    dev = resolve_device(device)
    from hm_retrieval_tpu_torch.indices import (
        DISTRIBUTED_INDEX_TYPES,
        INDEX_TYPES,
    )
    from hm_retrieval_tpu_torch.indices.builder import collect_catalog

    tower = _tower(model, "candidate_tower", params)

    def embed(batch):
        return tower(_to(batch, model.device))

    args = (
        model.candidate_id_col,
        embed,
        candidate_ds.iter_batches(candidate_batch_size),
        candidate_batch_size,
    )
    if distributed:
        if mesh is None:
            raise ValueError(
                "distributed index requires a mesh (make_mesh with a model "
                "axis)"
            )
        # the manifest's row count and the tower's width let the sharded
        # build stream without materializing anything catalog-sized
        return DISTRIBUTED_INDEX_TYPES[index_type].build_from_batches(
            k, *args, mesh=mesh, num_candidates=candidate_ds.num_rows,
            dim=model.joint_embedding_size,
        )
    family = INDEX_TYPES[index_type]
    if getattr(family, "supports_device_build", False):
        return family.build_from_batches(k, *args, device=dev)
    identifiers, embeddings = collect_catalog(*args)
    return family(k, identifiers, embeddings, device=dev)


@torch.no_grad()
def evaluate(
    model: TwoTowerModel,
    index,
    test_ds: ShardDataset,
    test_batch_size: int,
    ks,
    epoch: Optional[int] = None,
    writer: Optional[MetricWriter] = None,
    mesh=None,
    params=None,
) -> Dict[int, float]:
    """Streaming Recall@K over the test set (ref: runner.py:95-101), on
    ``model``'s device. Tail batches are padded to the static batch size and
    the padded rows are masked out of the metric. Each batch: the query
    tower, ``index.topk_from_embeddings``, then the metric, which pulls one
    small vector to the host. Ks larger than the catalog are dropped with a
    warning. With a ``mesh`` the batches stay on this process's first
    device, the model's. ``params``: a training state's, whose row-sharded
    tables the tower reads through their shards.

    Over a process group of P ranks ``test_ds`` is this rank's part (its
    ``process_index``) and each batch takes ``test_batch_size // P`` of its
    rows; every rank runs the group's largest batch count, a drained rank
    feeding all-padding batches, and the recall is the global one on every
    rank (module docstring)."""
    _on_mesh(mesh, model.device)
    P = _check_group(mesh, test_batch_size)
    usable_ks = [k for k in ks if k <= index.num_candidates]
    dropped = [k for k in ks if k > index.num_candidates]
    if dropped:
        logger.warning(
            "Dropping ks %s > catalog size %d", dropped, index.num_candidates
        )
    metric = IndexRecall(usable_ks, cross_process=P > 1)
    query = _tower(model, "query_tower", params)
    cid = model.candidate_id_col
    dev = model.device
    local_bs = test_batch_size // P
    n_batches = _allgather_max(-(-test_ds.local_num_rows // local_bs))
    # a sharded index over the group answers every rank's rows at once
    index_mesh = getattr(index, "mesh", None)
    gathered = index_mesh is not None and index_mesh.process_count > 1
    me = process_index()

    batches = test_ds.iter_batches(local_bs)
    last = None
    for _ in range(n_batches):
        batch = next(batches, None)
        if batch is not None:
            batch, n = _pad_batch(batch, local_bs)
            last = batch
        elif P > 1 and last is not None:
            # drained: an all-padding batch keeps the group in lockstep
            batch, n = {k: np.zeros_like(v) for k, v in last.items()}, 0
        elif P > 1:
            raise RuntimeError(
                "process has no local eval batches; write more shards or "
                "use fewer processes"
            )
        else:
            # the manifest counts more rows than the shards hold; the JAX
            # package feeds all-padding batches here, which count nothing
            break
        tbatch = _to(batch, dev)
        mask = torch.arange(local_bs, device=dev) < n
        q = query(tbatch)
        if gathered:
            # every rank's rows in rank order: the global batch
            _, ids = index.topk_from_embeddings(gather_processes(q))
            ids = ids[me * local_bs:(me + 1) * local_bs]
        else:
            _, ids = index.topk_from_embeddings(q)
        metric.update(ids, tbatch[cid], valid_mask=mask)
    if P == 1 and next(batches, None) is not None:
        # n_batches comes from the manifest's row count; a stale, low count
        # would silently drop eval rows and skew recall
        raise RuntimeError(
            "eval dataset yielded more batches than its manifest row "
            "count implies — the shard manifest is stale; rewrite the "
            "shards (data/shard_writer.py) or fix num_rows"
        )
    return metric.log_metric(epoch, writer)


def evaluation_runner(
    settings: Settings,
    mesh=None,
    distributed_index: bool = False,
    device: DeviceLike = None,
) -> Dict[int, float]:
    """Eval-only stage: restore the latest checkpoint into the state the
    trainer would create, rebuild the index from the candidate tower,
    evaluate Recall@K and refresh the index artifact. No training.
    ``distributed_index`` shards the catalog over ``mesh``'s model axis
    (``indices/distributed.py``), whose first device (this process's) must
    be ``device``. With row-sharded tables active over ``mesh`` the template
    is the mesh trainer's state (``create_mesh_state``), as the JAX package
    restores a row-sharded checkpoint; a checkpoint of any other layout
    restores into the single-device state, which the data-parallel states
    equal. Over a process group every rank evaluates its own test shards
    and reports the global recall; the artifact is written by rank 0, or
    collectively by a sharded index, and every rank returns only once it is
    complete."""
    dev = resolve_device(device)
    if distributed_index and mesh is None:
        raise ValueError("distributed_index=True requires a mesh (make_mesh)")
    _on_mesh(mesh, dev)
    schema = Schema.load(settings.schema_dirpath)
    tc, mc = schema.training_config, schema.model_config
    P = _check_group(mesh, tc.test_batch_size)
    test_ds = ShardDataset(settings.test_shards_dirpath,
                           process_index=process_index(), process_count=P)
    cand_ds = ShardDataset(settings.candidate_shards_dirpath)

    model = TwoTowerModel.create_from_schema(schema, device=dev)
    if active_sharded_features(tc, mesh):
        state = create_mesh_state(model, tc, mesh)
    else:
        state = create_single_device_state(model, tc)
    ckpt = CheckpointManager(settings.checkpoint_dirpath, device=dev)
    try:
        state = ckpt.restore(state)
    finally:
        ckpt.close()

    index = build_index(
        model,
        cand_ds,
        tc.candidate_batch_size,
        min(max(mc.ks), cand_ds.num_rows),
        index_type=mc.index_type,
        mesh=mesh,
        distributed=distributed_index,
        device=dev,
        params=state.params,
    )
    res = evaluate(model, index, test_ds, tc.test_batch_size, mc.ks,
                   mesh=mesh, params=state.params)
    _save_index(index, settings.index_dirpath)
    return res


def _save_index(index, dirpath: str) -> None:
    """Rank 0 writes the artifact, or every rank when the index saves
    collectively; no rank goes on before it is complete."""
    if getattr(index, "collective_save", False) or _is_coordinator():
        index.save(dirpath)
    barrier()


def _apply_overrides(schema: Schema, overrides) -> None:
    tc = schema.training_config
    for key, value in overrides.items():
        if not any(f.name == key for f in dataclasses.fields(tc)):
            raise ValueError(f"unknown TrainingConfig field {key!r}")
        if getattr(tc, key) != value:
            logger.warning(
                "Overriding schema TrainingConfig.%s: %r -> %r",
                key,
                getattr(tc, key),
                value,
            )
    schema.training_config = dataclasses.replace(tc, **overrides)


def modelling_runner(
    settings: Settings,
    mesh=None,
    resume: bool = False,
    distributed_index: bool = False,
    training_overrides: Optional[Dict[str, object]] = None,
    device: DeviceLike = None,
) -> Dict[str, Dict[int, float]]:
    """Full train + eval stage (ref: modelling_runner,
    pkg/modelling/runner.py:18-107). Returns {"initial": recalls, "final":
    recalls}. With a ``mesh`` (whose first device here is ``device``) it
    trains over the mesh (``make_mesh_trainer``), each data and table shard
    on its cell's device; ``distributed_index``
    serves every eval and the saved artifact from a catalog sharded over
    the mesh's model axis. Over a process group every rank calls it with
    the same arguments and gets the same results (module docstring).

    ``training_overrides``: TrainingConfig field values that replace the ones
    snapshotted into the schema artifact, logged loudly; an unknown field
    raises ``ValueError``. ``resume`` continues from the latest checkpoint
    and its step count."""
    dev = resolve_device(device)
    schema = Schema.load(settings.schema_dirpath)
    if training_overrides:
        _apply_overrides(schema, training_overrides)
    tc, mc = schema.training_config, schema.model_config
    if distributed_index and mesh is None:
        raise ValueError("distributed_index=True requires a mesh (make_mesh)")
    P = _check_group(mesh, tc.train_batch_size, tc.test_batch_size)
    pi = process_index()
    if mesh is not None:
        # a CUDA cell without CUDA raises before any step
        training_device(mesh)
        _on_mesh(mesh, dev)
    if settings.savedmodel_dirpath:
        # fail before training: an unexportable schema, or a machine without
        # TensorFlow, must not surface after the last epoch
        validate_exportable_schema(schema)
        require_tensorflow()

    # each rank feeds its own train and test shards; the candidate catalog
    # is read whole on every rank
    train_ds = ShardDataset(settings.train_shards_dirpath, process_index=pi,
                            process_count=P)
    test_ds = ShardDataset(settings.test_shards_dirpath, process_index=pi,
                           process_count=P)
    cand_ds = ShardDataset(settings.candidate_shards_dirpath)

    model = TwoTowerModel.create_from_schema(schema, device=dev)
    catalog = None
    if tc.num_uniform_negatives > 0:
        from hm_retrieval_tpu_torch.models.mixed_negatives import (
            CandidateCatalog,
        )

        catalog = CandidateCatalog(cand_ds.load_all(), device=dev)
    if mesh is None:
        active_sharded_features(tc)
        state, step_fn = make_single_device_trainer(model, tc, catalog)
    else:
        state, step_fn = make_mesh_trainer(model, tc, mesh, catalog)
    index_k = min(max(mc.ks), cand_ds.num_rows)

    def build_and_evaluate(epoch):
        index = build_index(
            model,
            cand_ds,
            tc.candidate_batch_size,
            index_k,
            index_type=mc.index_type,
            mesh=mesh,
            distributed=distributed_index,
            device=dev,
            params=state.params,
        )
        res = evaluate(
            model,
            index,
            test_ds,
            tc.test_batch_size,
            mc.ks,
            epoch=epoch,
            writer=writer,
            mesh=mesh,
            params=state.params,
        )
        return index, res

    ckpt = CheckpointManager(settings.checkpoint_dirpath, device=dev)
    coordinator = _is_coordinator()
    writer = MetricWriter(settings.tensorboard_logs_dir if coordinator
                          else None)
    profiler = StepProfiler(
        settings.tensorboard_logs_dir if coordinator else None,
        settings.profile_steps if coordinator else None,
    )
    try:
        if resume and ckpt.latest_step() is not None:
            state = ckpt.restore(state)

        results: Dict[str, Dict[int, float]] = {}
        global_step = state.step
        t_train, examples = 0.0, 0
        spd = tc.steps_per_dispatch
        chunk_fn = make_chunked_train_step(step_fn) if spd > 1 else None
        for epoch in range(tc.epochs):
            # --- eval at the epoch's start (ref: runner.py:85-101) ---
            _, res = build_and_evaluate(epoch)
            if epoch == 0:
                results["initial"] = res

            # --- train one epoch (ref: runner.py:103) ---
            t0 = time.time()
            # over a group each rank feeds B / P rows a step; seeds
            # epoch * P + rank never repeat across (epoch, rank) pairs
            local_bs = tc.train_batch_size // P
            batches = train_ds.iter_batches(
                local_bs,
                shuffle_buffer_size=tc.shuffle_buffer_size,
                seed=tc.seed + epoch * P + pi,
                drop_remainder=True,
            )
            if P > 1:
                batches = itertools.islice(batches, _allgather_min(
                    train_ds.local_num_rows // local_bs))
            if spd > 1:
                # K steps a call; a tail of fewer than K batches is dropped
                # with a warning (device_feed.chunk_batches)
                for dev_chunk in device_feed_chunked(batches, spd, device=dev,
                                                     mesh=mesh):
                    state, metrics = chunk_fn(state, dev_chunk)
                    global_step += spd
                    profiler.on_step(global_step)
                    if global_step % 100 < spd:
                        _log_loss(writer, metrics, global_step)
                    examples += tc.train_batch_size * spd
            else:
                for dev_batch in device_feed(batches, device=dev, mesh=mesh):
                    state, metrics = step_fn(state, dev_batch)
                    global_step += 1
                    profiler.on_step(global_step)
                    if global_step % 100 == 0:
                        _log_loss(writer, metrics, global_step)
                    examples += tc.train_batch_size
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_train += time.time() - t0

            ckpt.save(global_step, state)
            # exports keep the unsharded contract: row-sharded tables are
            # written at their true vocabulary rows (gathered from their
            # owners on every rank; rank 0 writes)
            unpadded = unpad_params(state.params, model)
            if coordinator:
                export_model(model, settings.model_dirpath, params=unpadded)
            # weight histograms per epoch (ref: histogram_freq=1)
            writer.add_params_histograms(model, epoch + 1, params=unpadded)

        profiler.close()
        if t_train > 0:
            logger.info(
                "Training throughput: %.0f examples/s", examples / t_train
            )

        # --- final eval after training (fixes ref: runner.py:107) ---
        index, results["final"] = build_and_evaluate(tc.epochs)
        _save_index(index, settings.index_dirpath)
        if settings.savedmodel_dirpath:
            _export_savedmodel(settings.savedmodel_dirpath, schema, model,
                               state.params, index, distributed_index)
        return results
    finally:
        # close on every exit path so a mid-run failure cannot lose
        # buffered metrics or a checkpoint write in flight
        profiler.close()
        ckpt.close()
        writer.close()


def _export_savedmodel(out_dir, schema, model, params, index,
                       distributed_index):
    """The SavedModel of the final query tower and index. Collective over a
    process group: every rank unpads the row-sharded tables and collapses a
    sharded index (``to_local()``); rank 0 writes."""
    tree = flat_to_tree(unpad_params(params, model))["query_tower"]
    if distributed_index:
        # TF-Serving's artifact is single-device by contract
        index = index.to_local()
    if _is_coordinator():
        export_index_savedmodel(schema, tree, index, out_dir)
    barrier()


def _log_loss(writer: MetricWriter, metrics, step: int) -> None:
    loss = float(metrics["loss"])  # one host sync every 100 steps
    writer.add_scalar("train/loss", loss, step)
    logger.info("step %d | loss %.4f", step, loss)
