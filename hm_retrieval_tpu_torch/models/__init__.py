from hm_retrieval_tpu_torch.models.bridge import (
    params_from_numpy,
    params_to_numpy,
    tower_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from hm_retrieval_tpu_torch.models.embedding import (
    apply_embeddings,
    embedding_output_dim,
    pool_sequence,
)
from hm_retrieval_tpu_torch.models.logq_correction import apply_logq_correction
from hm_retrieval_tpu_torch.models.optimizer_factory import OptimizerFactory
from hm_retrieval_tpu_torch.models.tower import Tower
from hm_retrieval_tpu_torch.models.train_path import make_single_device_trainer
from hm_retrieval_tpu_torch.models.two_tower import (
    TrainState,
    TwoTowerModel,
    create_train_state,
    make_train_step,
)

__all__ = [
    "apply_embeddings",
    "apply_logq_correction",
    "embedding_output_dim",
    "pool_sequence",
    "params_from_numpy",
    "params_to_numpy",
    "tower_from_numpy",
    "train_state_from_numpy",
    "train_state_to_numpy",
    "OptimizerFactory",
    "Tower",
    "TrainState",
    "TwoTowerModel",
    "create_train_state",
    "make_single_device_trainer",
    "make_train_step",
]
