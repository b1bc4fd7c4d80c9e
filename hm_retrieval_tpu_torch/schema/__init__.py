from hm_retrieval_tpu_torch.schema.features import (
    Feature,
    FeatureFamily,
    FeatureKind,
)
from hm_retrieval_tpu_torch.schema.model_config import ModelConfig
from hm_retrieval_tpu_torch.schema.schema import Schema
from hm_retrieval_tpu_torch.schema.training_config import TrainingConfig

__all__ = [
    "Feature",
    "FeatureFamily",
    "FeatureKind",
    "ModelConfig",
    "Schema",
    "TrainingConfig",
]
