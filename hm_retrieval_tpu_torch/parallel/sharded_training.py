"""Dense training with row-sharded embedding tables (BASELINE config[2]).

Counterpart of ``hm_retrieval_tpu/parallel/sharded_training.py``. The
listed feature tables are row-sharded over the model axis (``ShardedTable``,
``parallel/sharded_embedding.py``), the MLP and the other tables stay
replicated, and the dense optimizer's state of a sharded table is sharded
like the table. JAX partitions the global-shape step with GSPMD; here the
step is ``parallel/data_parallel.py``'s: each data shard gathers its rows
through the shards (``psum_rows``, differentiable), so the backward reaches
every shard, and the optimizer updates each shard as a parameter of its own.

The model's own parameter of a sharded table is released (0 rows): the
shards hold the table, and a forward that does not route its rows through
them fails loudly instead of reading stale weights.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from hm_retrieval_tpu_torch.models.two_tower import TrainState, TwoTowerModel
from hm_retrieval_tpu_torch.parallel.data_parallel import (
    expand,
    fold,
    make_dp_train_step,
    map_opt_state,
)
from hm_retrieval_tpu_torch.parallel.mesh import (
    replicated,
    row_sharded,
    training_device,
)
from hm_retrieval_tpu_torch.parallel.sharded_embedding import shard_table


def table_names(model: TwoTowerModel, features: Iterable[str]) -> List[str]:
    """Parameter names of the embedding tables of ``features``."""
    features = set(features)
    return [
        f"{tower}.embeddings.{f.name}"
        for tower in ("query_tower", "candidate_tower")
        for f in getattr(model, tower).features
        if f.name in features and f.name in getattr(model, tower).embeddings
    ]


def param_shardings(
    model: TwoTowerModel, mesh, sharded_features: Iterable[str]
) -> Dict:
    """``{parameter name: Sharding}``: the listed feature tables row-sharded
    over the model axis, everything else replicated."""
    rows = set(table_names(model, sharded_features))
    return {
        n: row_sharded(mesh) if n in rows else replicated(mesh)
        for n, _ in model.named_parameters()
    }


def release_table(model: TwoTowerModel, name: str) -> None:
    """Free the model's own copy of table ``name`` (0 rows left); the
    tower's ``reset_parameters`` gives it back its rows."""
    p = model.get_parameter(name)
    p.data = p.data.new_empty((0, p.shape[1]))


def shard_params(model: TwoTowerModel, mesh, sharded: Iterable[str]):
    """The model's parameters by name, the tables of ``sharded`` features
    as ``ShardedTable``s zero-padded to S*ceil(V/S) rows (their own copies
    released from the model)."""
    params = dict(model.named_parameters())
    for name in table_names(model, sharded):
        params[name] = shard_table(params[name].detach(), mesh)
        release_table(model, name)
    return params


def create_sharded_train_state(
    model: TwoTowerModel,
    optimizer,
    mesh,
    sharded_features: Iterable[str],
    seed: int = 0,
) -> TrainState:
    """Init from ``seed``, shard the listed tables (zero pad rows), then
    ``optimizer.init`` over every shard as a parameter of its own: the
    state of a sharded table is sharded like it, and Adagrad's pad
    accumulators start at its initial value, as JAX's ``optimizer.init``
    over the padded table gives them."""
    training_device(mesh)
    model.init_params(seed)
    params = shard_params(model, mesh, sharded_features)
    opt_state = map_opt_state(optimizer.init(expand(params)),
                              lambda flat: fold(flat, params))
    return TrainState(params, opt_state, 0)


def make_sharded_train_step(
    model: TwoTowerModel,
    optimizer,
    mesh,
    catalog=None,
    num_uniform_negatives: int = 0,
    base_seed: int = 0,
):
    """``step(state, batch, negatives=None) -> (state, {"loss": loss})``
    over a state placed by ``create_sharded_train_state``, ``batch`` the
    global batch or ``shard_batch``'s list."""
    return make_dp_train_step(model, optimizer, mesh, catalog,
                              num_uniform_negatives, base_seed)
