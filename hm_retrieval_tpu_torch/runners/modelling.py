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
without CUDA unless given ``device="cpu"``. Each takes a one-process mesh
(``parallel/mesh.py``) and ``distributed`` / ``distributed_index``, which
shards the catalog over the mesh's model axis (``indices/distributed.py``);
the eval batches and the replicated weights stay on the mesh's first
device, which must be ``device``, where the JAX package shards the batches
over the data axis and replicates the weights. ``modelling_runner`` trains
over a mesh whose devices are all one device (``["cuda:0"] * 4``), with the
tables of ``sharded_embedding_features`` row-sharded when the mesh has a
model axis; ``build_index`` and ``evaluate`` take the training state's
``params`` and gather a row-sharded table's rows through its shards, so the
full table is never assembled on the device. A mesh over several devices or
processes raises ``NotImplementedError`` (ROADMAP.md Queue 1 item 6.3), and
so does the SavedModel export (item 7), each before any step.
"""

from __future__ import annotations

import dataclasses
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
from hm_retrieval_tpu_torch.models.train_path import (
    active_sharded_features,
    create_mesh_state,
    create_single_device_state,
    make_mesh_trainer,
    make_single_device_trainer,
)
from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.parallel.mesh import (
    canonical,
    require_single_process,
    training_device,
)
from hm_retrieval_tpu_torch.parallel.data_parallel import sharded_rows
from hm_retrieval_tpu_torch.runners.checkpoint import (
    CheckpointManager,
    export_model,
)
from hm_retrieval_tpu_torch.schema.schema import Schema
from hm_retrieval_tpu_torch.utils.profiling import StepProfiler
from hm_retrieval_tpu_torch.utils.settings import Settings
from hm_retrieval_tpu_torch.utils.summary import MetricWriter

logger = logging.getLogger(__name__)


def _on_mesh(mesh, dev: torch.device) -> None:
    """A mesh's batches and weights stay on its first device: ``dev``."""
    if mesh is None:
        return
    require_single_process("a mesh")
    if mesh.first_device != canonical(dev):
        raise ValueError(
            f"the mesh's first device {mesh.first_device} is not the "
            f"model's device {dev}"
        )


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
    warning. With a ``mesh`` the batches stay on its first device, the
    model's. ``params``: a training state's, whose row-sharded tables the
    tower reads through their shards."""
    _on_mesh(mesh, model.device)
    usable_ks = [k for k in ks if k <= index.num_candidates]
    dropped = [k for k in ks if k > index.num_candidates]
    if dropped:
        logger.warning(
            "Dropping ks %s > catalog size %d", dropped, index.num_candidates
        )
    metric = IndexRecall(usable_ks)
    query = _tower(model, "query_tower", params)
    cid = model.candidate_id_col
    dev = model.device
    n_batches = -(-test_ds.local_num_rows // test_batch_size)

    batches = test_ds.iter_batches(test_batch_size)
    for _ in range(n_batches):
        batch = next(batches, None)
        if batch is None:
            # the manifest counts more rows than the shards hold; the JAX
            # package feeds all-padding batches here, which count nothing
            break
        batch, n = _pad_batch(batch, test_batch_size)
        tbatch = _to(batch, dev)
        mask = torch.arange(test_batch_size, device=dev) < n
        q = query(tbatch)
        _, ids = index.topk_from_embeddings(q)
        metric.update(ids, tbatch[cid], valid_mask=mask)
    if next(batches, None) is not None:
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
    (``indices/distributed.py``), whose first device must be ``device``.
    With row-sharded tables active over ``mesh`` the template is the mesh
    trainer's state (``create_mesh_state``), as the JAX package restores a
    row-sharded checkpoint; a checkpoint of any other layout restores into
    the single-device state, which the data-parallel states equal."""
    dev = resolve_device(device)
    require_single_process("evaluation_runner")
    if distributed_index and mesh is None:
        raise ValueError("distributed_index=True requires a mesh (make_mesh)")
    _on_mesh(mesh, dev)
    schema = Schema.load(settings.schema_dirpath)
    tc, mc = schema.training_config, schema.model_config
    test_ds = ShardDataset(settings.test_shards_dirpath)
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
    index.save(settings.index_dirpath)
    return res


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
    recalls}. With a ``mesh`` (its devices all ``device``) it trains over
    the mesh (``make_mesh_trainer``); ``distributed_index`` serves every
    eval and the saved artifact from a catalog sharded over the mesh's
    model axis.

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
    require_single_process("modelling_runner")
    if mesh is not None:
        training_device(mesh)  # one device, one process: else item 6.3
        _on_mesh(mesh, dev)
    if settings.savedmodel_dirpath:
        # fail before training, as the JAX package's schema check does
        raise NotImplementedError(
            "the SavedModel export is not ported yet: ROADMAP.md Queue 1 "
            "item 7 (SavedModel export)"
        )

    train_ds = ShardDataset(settings.train_shards_dirpath)
    test_ds = ShardDataset(settings.test_shards_dirpath)
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
    writer = MetricWriter(settings.tensorboard_logs_dir)
    profiler = StepProfiler(
        settings.tensorboard_logs_dir, settings.profile_steps
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
            batches = train_ds.iter_batches(
                tc.train_batch_size,
                shuffle_buffer_size=tc.shuffle_buffer_size,
                seed=tc.seed + epoch,
                drop_remainder=True,
            )
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
            # written at their true vocabulary rows
            export_model(model, settings.model_dirpath, params=state.params)
            # weight histograms per epoch (ref: histogram_freq=1)
            writer.add_params_histograms(model, epoch + 1, params=state.params)

        profiler.close()
        if t_train > 0:
            logger.info(
                "Training throughput: %.0f examples/s", examples / t_train
            )

        # --- final eval after training (fixes ref: runner.py:107) ---
        index, results["final"] = build_and_evaluate(tc.epochs)
        index.save(settings.index_dirpath)
        return results
    finally:
        # close on every exit path so a mid-run failure cannot lose
        # buffered metrics or a checkpoint write in flight
        profiler.close()
        ckpt.close()
        writer.close()


def _log_loss(writer: MetricWriter, metrics, step: int) -> None:
    loss = float(metrics["loss"])  # one host sync every 100 steps
    writer.add_scalar("train/loss", loss, step)
    logger.info("step %d | loss %.4f", step, loss)
