"""Sparse Adagrad training over row-sharded embedding tables.

Counterpart of ``hm_retrieval_tpu/parallel/sharded_sparse_training.py``: the
listed tables row-sharded over the model axis (table and accumulator alike),
the rest replicated, and the update touching only the rows a batch touches.
On a (data=D, model=S) mesh, with local batch b = B/D and shards of R rows:

    forward   rows_d = psum over s of shard_s[ids_d - s*R], masked to the
              rows s owns                        # (b, E), a leaf of its own
              towers and global-negative loss as parallel/sparse_data_parallel
    backward  g_rows_d = d loss / d rows_d
    update    G, I = all_gather(g_rows_d), all_gather(ids_d)    # global
              shard s: local = I - s*R, kept where in [0, R), else -1;
              sparse Adagrad on the shard's rows (models/sparse_optimizer
              drops the -1 ids)

The step is ``parallel/sparse_data_parallel.py``'s, run with
``ShardedTable`` tables. JAX computes each shard's update on every device of
the data axis; one process holds each shard once and updates it once. The
JAX step chains its collectives with ``optimization_barrier`` (``seq``)
because XLA:CPU's in-process rendezvous can deadlock on collectives started
in different orders; one process runs the shards in program order, so that
chain has no counterpart here.

Pad rows, of tables and accumulators alike, are zero: no id reaches them,
and the update never changes them.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from hm_retrieval_tpu_torch.models.sparse_optimizer import (
    SparseAdagradState,
    SparseTrainState,
    _table_features,
    _table_name,
    create_sparse_train_state,
)
from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.parallel.mesh import (
    REPLICATED,
    ROWS,
    training_device,
)
from hm_retrieval_tpu_torch.parallel.sharded_embedding import (
    ShardedTable,
    shard_table,
)
from hm_retrieval_tpu_torch.parallel.sharded_training import (
    release_table,
    table_names,
)
from hm_retrieval_tpu_torch.parallel.sparse_data_parallel import (
    make_dp_sparse_train_step,
)


def sharded_sparse_specs(
    state: SparseTrainState, sharded_features: Iterable[str]
) -> SparseTrainState:
    """The spec of each tensor of ``state``, shaped as it: the listed
    feature tables and their accumulators ``ROWS`` (row-sharded over the
    model axis), everything else ``REPLICATED``."""
    sharded = set(sharded_features)

    def spec(name: str, x) -> tuple:
        feature = name.split(".")[-1]
        return ROWS if feature in sharded and len(x.shape) == 2 and (
            name.split(".")[1] == "embeddings") else REPLICATED

    return SparseTrainState(
        params={n: spec(n, p) for n, p in state.params.items()},
        dense_opt_state=REPLICATED,
        sparse_state=SparseAdagradState(
            {n: spec(n, a) for n, a in state.sparse_state.accumulators.items()}
        ),
        step=REPLICATED,
    )


def _check_features(model: TwoTowerModel, sharded) -> None:
    tables = {f.name for feats in _table_features(model).values()
              for f in feats}
    unknown = set(sharded) - tables
    if unknown:
        raise ValueError(
            f"sharded_features {sorted(unknown)} are not embedding-table "
            f"features of this model (have {sorted(tables)})"
        )


def create_sharded_sparse_state(
    model: TwoTowerModel,
    dense_optimizer,
    mesh,
    sharded_features: Iterable[str],
    seed: int = 0,
) -> SparseTrainState:
    """The sparse train state of ``seed`` with the listed feature tables row
    sharded: tables and accumulators zero-padded to S*ceil(V/S) rows (the
    pad accumulators 0, not 0.1: no id reaches them)."""
    training_device(mesh)
    sharded = set(sharded_features)
    state = create_sparse_train_state(model, dense_optimizer, seed)
    specs = sharded_sparse_specs(state, sharded)
    params = dict(state.params)
    accs = dict(state.sparse_state.accumulators)
    for name in table_names(model, sharded):
        if specs.params[name] != ROWS:
            continue
        params[name] = shard_table(params[name].detach(), mesh)
        accs[name] = shard_table(accs[name], mesh)
        release_table(model, name)
    return state._replace(params=params,
                          sparse_state=SparseAdagradState(accs))


def unpad_params(params: Dict, model: TwoTowerModel) -> Dict:
    """``params`` with every row-sharded table assembled on the host and
    sliced back to its true vocabulary rows (the unsharded layout of exports
    and serving); the other tensors as they are."""
    out = dict(params)
    for tower, feats in _table_features(model).items():
        for f in feats:
            name = _table_name(tower, f)
            t = out[name]
            if isinstance(t, ShardedTable):
                t = torch.cat([s.detach().cpu() for s in t.shards])
            if t.shape[0] != f.num_embeddings:
                t = t[: f.num_embeddings]
            out[name] = t
    return out


def make_sharded_sparse_train_step(
    model: TwoTowerModel,
    dense_optimizer,
    learning_rate: float,
    mesh,
    sharded_features: Iterable[str],
    eps: float = 1e-7,
):
    """``step(state, batch) -> (state, {"loss": loss})``: sparse Adagrad
    everywhere, the listed tables row-sharded, global-batch in-batch
    negatives; ``state`` placed by ``create_sharded_sparse_state``, ``batch``
    the global batch or ``shard_batch``'s list. An unknown feature name
    raises ``ValueError``."""
    _check_features(model, sharded_features)
    return make_dp_sparse_train_step(model, dense_optimizer, learning_rate,
                                     mesh, eps)
