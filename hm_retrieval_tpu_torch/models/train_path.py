"""Which train step a training config gets, on one device or over a mesh.

The choice of the JAX package's ``runners/modelling.py::modelling_runner``:
the sparse embedding Adagrad step when ``use_sparse_embedding_optimizer`` is
set, the optimizer is Adagrad and no uniform negatives are mixed in; the
dense step otherwise. Over a mesh (``parallel/``), each with the tables of
``sharded_embedding_features`` row-sharded when the mesh has a model axis
(``parallel/sharded_sparse_training.py``, ``parallel/sharded_training.py``)
and data-parallel with replicated tables when it has none
(``parallel/sparse_data_parallel.py``, ``parallel/data_parallel.py``).
"""

from __future__ import annotations

import functools
import logging

from hm_retrieval_tpu_torch.models.optimizer_factory import OptimizerFactory
from hm_retrieval_tpu_torch.models.sparse_optimizer import (
    create_sparse_train_state,
    make_sparse_train_step,
)
from hm_retrieval_tpu_torch.models.two_tower import (
    TwoTowerModel,
    create_train_state,
    make_train_step,
)
from hm_retrieval_tpu_torch.schema.training_config import TrainingConfig

logger = logging.getLogger(__name__)


def uses_sparse_step(tc: TrainingConfig) -> bool:
    return (
        tc.use_sparse_embedding_optimizer
        and tc.optimizer_name.lower() == "adagrad"
        and tc.num_uniform_negatives == 0
    )


def create_single_device_state(
    model: TwoTowerModel, training_config: TrainingConfig
):
    """The training state ``make_single_device_trainer`` starts from: the
    model's parameters initialised from ``training_config.seed`` and the
    chosen step's optimizer state over them (a template to restore a
    checkpoint into)."""
    tc = training_config
    optimizer = OptimizerFactory.get_optimizer(
        tc.optimizer_name, tc.optimizer_kwargs
    )
    if uses_sparse_step(tc):
        return create_sparse_train_state(model, optimizer, seed=tc.seed)
    return create_train_state(model, optimizer, seed=tc.seed)


def make_single_device_trainer(
    model: TwoTowerModel, training_config: TrainingConfig, catalog=None
):
    """``(state, step_fn)`` for ``model`` on its device, its parameters
    initialised from ``training_config.seed``. ``catalog`` (a
    ``CandidateCatalog``) is required when uniform negatives are on."""
    tc = training_config
    optimizer = OptimizerFactory.get_optimizer(
        tc.optimizer_name, tc.optimizer_kwargs
    )
    if uses_sparse_step(tc):
        step_fn = make_sparse_train_step(
            model, optimizer, tc.optimizer_kwargs["learning_rate"]
        )
    else:
        step_fn = make_train_step(
            model,
            optimizer,
            catalog=catalog,
            num_uniform_negatives=tc.num_uniform_negatives,
            base_seed=tc.seed,
        )
    return create_single_device_state(model, tc), step_fn


def active_sharded_features(tc: TrainingConfig, mesh=None) -> list:
    """Feature names to row-shard: none when the config asks for none, or
    when there is no mesh with a model axis (> 1) to shard over, which is
    warned and not fatal: the replicated layout is always correct, only
    bigger."""
    feats = list(tc.sharded_embedding_features)
    if not feats:
        return []
    if mesh is None or mesh.shape.get("model", 1) <= 1:
        logger.warning(
            "sharded_embedding_features %s requested but the mesh has no "
            "model axis (> 1); training with replicated tables",
            feats,
        )
        return []
    return feats


def _mesh_path(model, tc, mesh, catalog):
    """The mesh path's initial state, and the partial that builds its
    step."""
    from hm_retrieval_tpu_torch import parallel

    optimizer = OptimizerFactory.get_optimizer(
        tc.optimizer_name, tc.optimizer_kwargs
    )
    sharded = active_sharded_features(tc, mesh)
    lr = tc.optimizer_kwargs["learning_rate"]
    if uses_sparse_step(tc):
        if sharded:
            logger.info("Using row-sharded sparse Adagrad train step "
                        "(sharded tables: %s)", sharded)
            state = parallel.create_sharded_sparse_state(
                model, optimizer, mesh, sharded, seed=tc.seed)
            make = functools.partial(parallel.make_sharded_sparse_train_step,
                                     model, optimizer, lr, mesh, sharded)
        else:
            logger.info("Using data-parallel sparse embedding Adagrad train "
                        "step over the mesh")
            state = parallel.replicate_sparse_state(
                create_sparse_train_state(model, optimizer, seed=tc.seed),
                mesh)
            make = functools.partial(parallel.make_dp_sparse_train_step,
                                     model, optimizer, lr, mesh)
    else:
        kw = dict(catalog=catalog,
                  num_uniform_negatives=tc.num_uniform_negatives,
                  base_seed=tc.seed)
        if sharded:
            logger.info("Using row-sharded dense train step (sharded "
                        "tables: %s)", sharded)
            state = parallel.create_sharded_train_state(
                model, optimizer, mesh, sharded, seed=tc.seed)
            make = functools.partial(parallel.make_sharded_train_step,
                                     model, optimizer, mesh, **kw)
        else:
            state = parallel.replicate_state(
                create_train_state(model, optimizer, tc.seed), mesh)
            make = functools.partial(parallel.make_dp_train_step,
                                     model, optimizer, mesh, **kw)
    return state, make


def create_mesh_state(model: TwoTowerModel, training_config: TrainingConfig,
                      mesh):
    """The state ``make_mesh_trainer`` starts from (a template to restore a
    checkpoint of any of its four layouts into)."""
    return _mesh_path(model, training_config, mesh, None)[0]


def make_mesh_trainer(model: TwoTowerModel, training_config: TrainingConfig,
                      mesh, catalog=None):
    """``(state, step_fn)`` over a training ``mesh`` (one device repeated,
    or several distinct devices, each shard on its cell's device:
    ``parallel/mesh.py``), the parameters initialised from
    ``training_config.seed``: row-sharded sparse, data-parallel sparse,
    row-sharded dense or data-parallel dense, as the JAX runner chooses."""
    state, make = _mesh_path(model, training_config, mesh, catalog)
    return state, make()
