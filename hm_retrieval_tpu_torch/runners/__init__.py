"""Pipeline stages. Ported: the modelling stage (``modelling_runner``,
``evaluation_runner`` and their ``build_index`` / ``evaluate``), the
train-state ``CheckpointManager`` and ``export_model``. The JAX package's
ETL, schema and shard stages wait for ROADMAP.md Queue 1 item 8, its
baseline stage for item 5."""

from hm_retrieval_tpu_torch.runners.checkpoint import (
    CheckpointManager,
    export_model,
)
from hm_retrieval_tpu_torch.runners.modelling import (
    build_index,
    evaluate,
    evaluation_runner,
    modelling_runner,
)

__all__ = [
    "CheckpointManager",
    "build_index",
    "evaluate",
    "evaluation_runner",
    "export_model",
    "modelling_runner",
]
