from hm_retrieval_tpu_torch.models.bridge import (
    params_from_numpy,
    params_to_numpy,
    tower_from_numpy,
)
from hm_retrieval_tpu_torch.models.embedding import (
    apply_embeddings,
    embedding_output_dim,
    pool_sequence,
)
from hm_retrieval_tpu_torch.models.tower import Tower
from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel

__all__ = [
    "apply_embeddings",
    "embedding_output_dim",
    "pool_sequence",
    "params_from_numpy",
    "params_to_numpy",
    "tower_from_numpy",
    "Tower",
    "TwoTowerModel",
]
