"""Data-parallel sparse-embedding training over a one-process mesh.

Counterpart of ``hm_retrieval_tpu/parallel/sparse_data_parallel.py``: the
data-parallel step with the sparse Adagrad of ``models/sparse_optimizer.py``
for every embedding table. Per data shard d (local batch b = B/D):

    rows_d   = tables[batch_d]                    # leaves of their own
    loss_d   = global-negative sum-CE of shard d  # (parallel/global_negatives)
    loss     = psum(loss_d)
    g_rows_d = d loss / d rows_d    # the all_gather's transpose: already the
                                    # sum of every shard's contribution
    g_dense  = psum(d loss / d dense_d)           # one autograd.grad for all
    G, I     = all_gather(g_rows_d), all_gather(ids_d)        # (B, E), (B,)
    sparse Adagrad(tables, G, I)                  # once, on the one copy

The update runs once over the global id vector, so an id that several
shards touch gets one update from its summed gradient, as the single-device
step on the global batch gives it. ``parallel/sharded_sparse_training.py``
runs the same step with row-sharded tables (``sharded``): their rows come
through ``psum_rows``, and each shard applies the global (G, I) to the rows
it owns, the others' ids marked -1.
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
    DATA_AXIS,
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
    """{tower: {feature: rows}}, (b, E) or (b, L, E), each a leaf that
    autograd differentiates; a ``ShardedTable``'s rows through
    ``psum_rows``."""
    out = {}
    for tower, feats in _table_features(model).items():
        out[tower] = {}
        for f in feats:
            table = params[_table_name(tower, f)]
            ids = batch[f.name]
            rows = (psum_rows(table, ids) if isinstance(table, ShardedTable)
                    else F.embedding(ids.long(), table))
            out[tower][f.name] = rows.requires_grad_()
    return out


def _update_table(table, acc, ids, g, lr, eps) -> None:
    """Sparse Adagrad of the global (G, I) on a table; a ``ShardedTable``
    shard by shard, each keeping the ids it owns (local rows) and marking
    the rest -1, which the update drops."""
    if not isinstance(table, ShardedTable):
        _sparse_adagrad_update(table, acc, ids, g, lr, eps)
        return
    R = table.rows_per_shard
    ids = ids.long()
    for s, (t, a) in enumerate(zip(table.shards, acc.shards)):
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
    negatives; the state updated in place, ``batch`` the global batch or
    ``shard_batch``'s list."""
    training_device(mesh)
    D = mesh.shape[DATA_AXIS]
    tables = _table_features(model)

    def step(state: SparseTrainState, batch):
        shards = split_batch(batch, D)
        params = state.params
        dense = split_dense_params(params)
        names = list(dense)
        replicas = [{n: p.detach().requires_grad_() for n, p in dense.items()}
                    for _ in range(D)]
        rows = [_gather_rows(params, model, s) for s in shards]
        loss = psum(step_losses(model, replicas, shards,
                                rows=lambda d, b: rows[d]))
        row_leaves = [[r for feats in rows[d].values() for r in feats.values()]
                      for d in range(D)]
        grads = torch.autograd.grad(
            loss,
            [r[n] for r in replicas for n in names]
            + [x for leaves in row_leaves for x in leaves],
            allow_unused=True,
            materialize_grads=True,
        )
        n = len(names)
        g_dense = psum([dict(zip(names, grads[d * n:(d + 1) * n]))
                        for d in range(D)])
        dense_optimizer.update_(g_dense, state.dense_opt_state, dense)
        g_rows = grads[D * n:]
        per_shard = len(row_leaves[0])
        i = 0
        for tower, feats in tables.items():
            for f in feats:
                name = _table_name(tower, f)
                ids = all_gather([s[f.name].reshape(-1) for s in shards])
                g = all_gather([
                    g_rows[d * per_shard + i].reshape(
                        shards[d][f.name].numel(), -1)
                    for d in range(D)
                ])
                _update_table(params[name],
                              state.sparse_state.accumulators[name], ids, g,
                              learning_rate, eps)
                i += 1
        return state._replace(step=state.step + 1), {"loss": loss.detach()}

    return step


def replicate_sparse_state(state: SparseTrainState, mesh) -> SparseTrainState:
    """The state held once on the training mesh's device."""
    return replicate_pytree(state, mesh)
