"""Data-parallel sparse-embedding training over a mesh.

Counterpart of ``hm_retrieval_tpu/parallel/sparse_data_parallel.py``: the
data-parallel step with the sparse Adagrad of ``models/sparse_optimizer.py``
for every embedding table. Per data shard d (local batch b = B/D):

    rows_d   = tables[batch_d]                    # leaves of their own,
                                                  # on shard d's device
    loss_d   = global-negative sum-CE of shard d  # (parallel/global_negatives)
    loss     = psum(loss_d)
    g_rows_d = d loss / d rows_d    # the all_gather's transpose: already the
                                    # sum of every shard's contribution
    g_dense  = psum(d loss / d dense_d)           # one autograd.grad for all
    G, I     = all_gather(g_rows_d), all_gather(ids_d)        # (B, E), (B,)
    sparse Adagrad(tables, G, I)                  # once, on the one copy

The update runs once over the global id vector, so an id that several
shards touch gets one update from its summed gradient, as the single-device
step on the global batch gives it. Shard d's dense replica, rows, towers
and gradients are on its device (``Mesh.data_device``); a table stays
where it is, on the first device or, row-sharded, each shard on its
column's, and only the gathered rows and their (G, I) cross: the ids go to
the table, the rows come back. ``parallel/sharded_sparse_training.py``
runs the same step with row-sharded tables (``sharded``): their rows come
through ``psum_rows``, and each shard applies the global (G, I) to the rows
it owns, the others' ids marked -1.

In a process group each rank runs its own data rows (``split_batch``); the
all-gathers of (G, I) and the psums bring in the others', so every rank
applies the same global update to its copy of the replicated tables and to
the table shards it holds.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from hm_retrieval_tpu_torch.models.sparse_optimizer import (
    SparseTrainState,
    _sparse_adagrad_update,
    _table_features,
    _table_name,
    split_dense_params,
)
from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.parallel.collectives import all_gather, psum
from hm_retrieval_tpu_torch.parallel.global_negatives import step_losses
from hm_retrieval_tpu_torch.parallel.mesh import (
    replicate_pytree,
    split_batch,
    training_device,
)
from hm_retrieval_tpu_torch.parallel.sharded_embedding import (
    ShardedTable,
    psum_rows,
)


@torch.no_grad()
def _gather_rows(params, model: TwoTowerModel, batch) -> Dict:
    """{tower: {feature: rows}}, (b, E) or (b, L, E) on the batch's device,
    each a leaf that autograd differentiates: gathered where the table is,
    a ``ShardedTable``'s through ``psum_rows``."""
    out = {}
    for tower, feats in _table_features(model).items():
        out[tower] = {}
        for f in feats:
            table = params[_table_name(tower, f)]
            ids = batch[f.name]
            rows = (psum_rows(table, ids) if isinstance(table, ShardedTable)
                    else F.embedding(ids.long().to(table.device),
                                     table).to(ids.device))
            out[tower][f.name] = rows.requires_grad_()
    return out


def _update_table(table, acc, ids, g, lr, eps) -> None:
    """Sparse Adagrad of the global (G, I) on a table, on its device; a
    ``ShardedTable`` shard by shard on each shard's device, each keeping the
    ids it owns (local rows) and marking the rest -1, which the update
    drops."""
    if not isinstance(table, ShardedTable):
        _sparse_adagrad_update(table, acc, ids, g, lr, eps)
        return
    R = table.rows_per_shard
    ids = ids.long()
    for s, (t, a) in enumerate(zip(table.shards, acc.shards)):
        if t is None:  # another rank's shard
            continue
        local = ids - s * R
        owned = (local >= 0) & (local < R)
        _sparse_adagrad_update(t, a, torch.where(owned, local, -1), g, lr,
                               eps)


def make_dp_sparse_train_step(
    model: TwoTowerModel,
    dense_optimizer,
    learning_rate: float,
    mesh,
    eps: float = 1e-7,
):
    """``step(state, batch) -> (state, {"loss": loss})`` over ``mesh``
    (module docstring): sparse Adagrad for every embedding table, replicated
    or row-sharded, ``dense_optimizer`` for the rest, global-batch in-batch
    negatives; the state updated in place, ``batch`` this process's rows
    (the global batch in one process) or ``shard_batch``'s list."""
    training_device(mesh)
    tables = _table_features(model)

    def step(state: SparseTrainState, batch):
        shards = split_batch(batch, mesh)
        local = [d for d, b in enumerate(shards) if b is not None]
        params = state.params
        dense = split_dense_params(params)
        names = list(dense)
        replicas = [None if b is None else
                    {n: p.detach().to(mesh.data_device(d)).requires_grad_()
                     for n, p in dense.items()}
                    for d, b in enumerate(shards)]
        rows = [None if b is None else _gather_rows(params, model, b)
                for b in shards]
        loss = psum(step_losses(model, replicas, shards,
                                rows=lambda d, b: rows[d], mesh=mesh), mesh)
        row_leaves = {d: [r for feats in rows[d].values()
                          for r in feats.values()] for d in local}
        grads = torch.autograd.grad(
            loss,
            [replicas[d][n] for d in local for n in names]
            + [x for d in local for x in row_leaves[d]],
            allow_unused=True,
            materialize_grads=True,
        )
        n = len(names)
        per_shard = [None] * len(shards)
        for j, d in enumerate(local):
            per_shard[d] = dict(zip(names, grads[j * n:(j + 1) * n]))
        g_dense = psum(per_shard, mesh)
        dense_optimizer.update_(g_dense, state.dense_opt_state, dense)
        g_rows = grads[len(local) * n:]
        per_row = len(row_leaves[local[0]])
        i = 0
        for tower, feats in tables.items():
            for f in feats:
                name = _table_name(tower, f)
                ids = all_gather([b and b[f.name].reshape(-1) for b in shards],
                                 mesh=mesh)
                g = all_gather([
                    None if shards[d] is None else
                    g_rows[local.index(d) * per_row + i].reshape(
                        shards[d][f.name].numel(), -1)
                    for d in range(len(shards))
                ], mesh=mesh)
                _update_table(params[name],
                              state.sparse_state.accumulators[name], ids, g,
                              learning_rate, eps)
                i += 1
        return state._replace(step=state.step + 1), {"loss": loss.detach()}

    return step


def replicate_sparse_state(state: SparseTrainState, mesh) -> SparseTrainState:
    """The state held once a process, on its first device."""
    return replicate_pytree(state, mesh)
