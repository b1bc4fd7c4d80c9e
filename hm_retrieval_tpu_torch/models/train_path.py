"""Which single-device train step a training config gets.

The choice of the JAX package's ``runners/modelling.py::modelling_runner``
without a mesh: the sparse embedding Adagrad step when
``use_sparse_embedding_optimizer`` is set, the optimizer is Adagrad and no
uniform negatives are mixed in; the dense step otherwise.
"""

from __future__ import annotations

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
