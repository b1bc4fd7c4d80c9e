from hm_retrieval_tpu_torch.serving.savedmodel_export import (
    OOV_TOKEN,
    export_index_savedmodel,
    require_tensorflow,
    validate_exportable_schema,
)
from hm_retrieval_tpu_torch.serving.service import RetrievalService

__all__ = [
    "OOV_TOKEN",
    "RetrievalService",
    "export_index_savedmodel",
    "require_tensorflow",
    "validate_exportable_schema",
]
